"""The port's count of key switches by kind
(backend/executor_torch.KEY_SWITCHES: "hoisted_rotation",
"single_rotation", "relin"), on the CPU, over one replay of the
benchmark's Sobel 90x90 and Harris 64x64 programs (benchmark/programs,
at their configurations' own sizes and scales, N = 16384).

A CUDA graph needs the card, so the capture here is an eager stand-in
that does what TorchProgram._capture_graph does with the counters: the
program runs between two `_take_counts` calls, whose difference is the
entry's `launches`, and the counters read what they read before; each
replay of the entry adds what it counted. On the card,
tests/test_torch_cuda.py holds the CryptoNets program's real graph to
the same counts. tests/test_torch_cryptonets.py counts the small
CryptoNets network through `replay_counts` too."""

import os
import sys

import numpy as np
import pytest
import torch

from eva_tpu_torch.backend import executor_torch as et
from eva_tpu_torch.ckks import CKKSCompiler
from eva_tpu_torch.ir import Op
from eva_tpu_torch.passes import rotation_hoist_sources
from eva_tpu_torch.runtime import generate_keys

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def benchmark():
    """The benchmark's loader (benchmark/harness), with its folder on the
    import path."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness.loader import Benchmark
    return Benchmark(ROOT)


def implied(compiled) -> dict:
    """The key switches the compiled program implies: a rotation whose
    source is rotated more than once is hoisted
    (passes.rotation_hoist_sources, the executor's own rule), any other
    rotation is single, and every Relinearize term is one relin."""
    order = compiled.topological_order()
    hoisted = rotation_hoist_sources(order)
    rots = [t for t in order
            if t.op in (Op.RotateLeftConst, Op.RotateRightConst)]
    n_hoisted = sum(t.operands[0].index in hoisted for t in rots)
    return {"hoisted_rotation": n_hoisted,
            "single_rotation": len(rots) - n_hoisted,
            "relin": sum(t.op == Op.Relinearize for t in order)}


def replay_counts(pub, compiled, enc):
    """(key switches one replay adds, the decrypted-ready outputs) for
    `enc` through the eager capture stand-in (module docstring); checks
    that the capture itself left the counter as it was."""
    tp = pub._executor_for(compiled)._get_torch_program()
    hv = pub._executor_for(compiled)._host_phase(enc)[0]
    before = dict(et.KEY_SWITCHES)
    saved = et._take_counts()
    out = tp._traced(*tp._inputs(hv))
    entry = et._Captured({}, {}, {})
    entry.launches = et._take_counts(saved)
    assert et.KEY_SWITCHES == before
    entry.graph = type("Graph", (), {"replay": lambda self: None})()
    entry.replay()
    added = {k: et.KEY_SWITCHES[k] - before[k] for k in before}
    assert {k: v for k, v in added.items() if v} == \
        entry.launches["key_switches"]
    return added, tp._result({k: list(v) for k, v in out.items()})


# What each program implies, by hand:
# sobel90: Sobel's two 3x3 stencils share the 8 rotations of the image
#   (offsets i*90 + j, all but (0, 0)): one source, all hoisted. Three
#   relinearizations: the squared gradient Ix*Ix + Iy*Iy (relinearized
#   once, lazily, after the sum), its square and its cube.
# harris64: the two Sobel stencils rotate the image 8 times, then the
#   three box sums rotate Ix*Ix, Iy*Iy and Ix*Iy 8 times each: 32
#   rotations of 4 sources, all hoisted. Four relinearizations: each of
#   the three products before its rotations, and the response det -
#   k*trace^2, a sum of three products relinearized once.
@pytest.mark.parametrize("name, want", [
    ("sobel90", {"hoisted_rotation": 8, "single_rotation": 0, "relin": 3}),
    ("harris64", {"hoisted_rotation": 32, "single_rotation": 0, "relin": 4}),
])
def test_one_replay_adds_the_key_switches_the_program_implies(name, want):
    bench = benchmark()
    cfg = bench.config(name)
    prog = bench.module("programs", cfg["program"]).build(cfg)
    compiled, params, sig = CKKSCompiler(
        cfg["compiler_options"]).compile(prog)
    assert implied(compiled) == want
    pub, _ = generate_keys(params, device="cpu")
    rng = np.random.default_rng(3)
    enc = pub.encrypt({cfg["input"]: rng.uniform(0, 1, cfg["slots"]).tolist()},
                      sig)
    added, _ = replay_counts(pub, compiled, enc)
    assert added == want


def test_the_counter_is_one_of_the_captured_counters():
    """A capture's `launches` carry the key switches, and `_take_counts`
    zeroes and restores them with the launch counters."""
    assert et._counters()["key_switches"] is et.KEY_SWITCHES
    et.KEY_SWITCHES["relin"] += 2
    saved = et._take_counts()
    assert et.KEY_SWITCHES == {"hoisted_rotation": 0, "single_rotation": 0,
                               "relin": 0}
    et.KEY_SWITCHES["single_rotation"] += 1
    counted = et._take_counts(saved)
    assert counted["key_switches"] == {"single_rotation": 1}
    assert et.KEY_SWITCHES["relin"] == saved["key_switches"]["relin"]
