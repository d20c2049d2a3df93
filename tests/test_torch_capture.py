"""What the port's CUDA-graph capture relies on, checked on the CPU.

TorchProgram captures `_traced` in a CUDA graph after one eager warm-up
run (backend/executor_torch.py). That is sound only if, once warm, a
`_traced` run uploads nothing (every table, constant, key layout and
permutation already cached) and reads no device value on the host. Both
are checked here on the plain PyTorch path, for small Sobel-shaped
programs at N = 4096 (3x3 stencils of hoisted rotations summed, squared
and relinearized), with one shard (vec_size 64) and two (vec_size 4096),
on both key switches; and the capture cache's key and input staging.
The CUDA graph itself needs the card: tests/test_torch_cuda.py."""

from collections import Counter

import numpy as np
import pytest
import torch

from eva_tpu_torch import EvaProgram, Input, Output
from eva_tpu_torch.backend import executor_torch as et
from eva_tpu_torch.backend import ks_cuda, ntt_cuda, tables
from eva_tpu_torch.ckks import CKKSCompiler
from eva_tpu_torch.crypto.ciphertext import Plaintext
from eva_tpu_torch.runtime import EVAPublic, generate_keys

torch.set_num_threads(1)

# Tensor methods that read a device value on the host (or branch on it).
HOST_READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


def _mini_sobel(vec_size: int, w: int = 8):
    """Sobel's stencil with +-1 taps (the +-2 taps and the cubic would
    push the ring to N = 8192), plus a constant."""
    prog = EvaProgram("mini_sobel", vec_size=vec_size)
    filt = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
    with prog:
        image = Input("image")
        ix = iy = None
        for i in range(3):
            for j in range(3):
                rot = image << (i * w + j)
                for f, acc in ((filt[i][j], "x"), (filt[j][i], "y")):
                    if not f:
                        continue
                    term = rot if f > 0 else -rot
                    if acc == "x":
                        ix = term if ix is None else ix + term
                    else:
                        iy = term if iy is None else iy + term
        Output("image", ix * ix + iy * iy + 1)
    prog.set_input_scales(20)
    prog.set_output_ranges(10)
    return prog


@pytest.fixture(scope="module", params=[64, 4096], ids=["k1", "k2"])
def served(request):
    """(public context, compiled program, three host valuations as the
    device program sees them, their numpy backend outputs)."""
    vec = request.param
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(_mini_sobel(vec))
    assert params.poly_modulus_degree == 4096
    pub, _ = generate_keys(params, device="cpu")
    rng = np.random.default_rng(vec)
    encs = [pub.encrypt({"image": rng.uniform(0, 1, vec).tolist()}, sig)
            for _ in range(3)]
    host = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")
    refs = [host.execute(compiled, e) for e in encs]
    ex = pub._executor_for(compiled)
    hvs = [ex._host_phase(e)[0] for e in encs]
    return pub, compiled, hvs, refs


def _cache_sizes(tp):
    ops = list(tables._LEVEL_OPS_CACHE.values())
    return {"program consts": len(tp._consts),
            "level ops": len(ops),
            "level-op consts": sum(len(o._consts) for o in ops),
            "kernel tables": sum(o._kernel_tables is not None for o in ops),
            "key layouts": len(tp.dkeys._cache),
            "galois perms": len(et._DEV_PERM_CACHE),
            "upload cache": len(tp._upload_cache)}


def _refuse(name):
    def read(self, *args, **kwargs):
        raise AssertionError(f"Tensor.{name} read a value on the host")
    return read


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "structured"])
def test_warm_trace_uploads_and_reads_nothing(served, fused, monkeypatch):
    """After one warm `_traced`, a second on fresh inputs adds no entry to
    any cache of device tables and reads no tensor on the host, and its
    output is the numpy backend's."""
    if not fused:
        monkeypatch.setenv("EVA_TPU_NO_FUSED_KS", "1")
    pub, compiled, hvs, refs = served
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    tp._traced(*tp._inputs(hvs[0]))
    cipher_in, plain_in = tp._inputs(hvs[1])
    before = _cache_sizes(tp)
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, _refuse(name))
        with pytest.raises(AssertionError, match="__bool__"):
            bool(torch.ones(1))
        out = tp._traced(cipher_in, plain_in)
    assert _cache_sizes(tp) == before
    got = tp._result({k: list(v) for k, v in out.items()})
    for a, b in zip(refs[1]["image"].polys, got["image"].polys):
        np.testing.assert_array_equal(a, b)


def test_capture_key(served, monkeypatch):
    """Same shapes give one key; a batch of 4 another; a changed
    constant's host object another, and so does the other key switch.
    Inputs are staged, constants held apart."""
    pub, compiled, hvs, _ = served
    tp = pub._executor_for(compiled)._get_torch_program()
    cipher, plain, consts = tp._split([hvs[0]], False)
    assert consts and set(consts) == {f"t{i}" for i in tp._const_terms}
    assert not plain and len(cipher) == 1
    key = tp._capture_key(cipher, plain, consts)
    assert tp._capture_key(*tp._split([hvs[1]], False)) == key
    batch4 = tp._split(hvs[:2] * 2, True)
    assert next(iter(batch4[0].values()))[0].shape[0] == 4
    assert tp._capture_key(*batch4) != key
    idx = int(next(iter(consts))[1:])
    pt = hvs[0][idx]
    changed = dict(hvs[0])
    changed[idx] = Plaintext(pt.poly.copy(), pt.level, pt.scale)
    assert tp._capture_key(*tp._split([changed], False)) != key
    monkeypatch.setenv("EVA_TPU_NO_FUSED_KS", "1")
    assert tp._capture_key(cipher, plain, consts) != key


def test_captured_inputs_refuse_other_shapes_and_names():
    entry = et._Captured({"t1": [torch.empty(2, 3, dtype=torch.int32)]},
                         {"t2": torch.empty(3, dtype=torch.int32)}, {})
    with pytest.raises(ValueError, match="input shape"):
        entry.fill({"t1": [np.zeros((2, 4), np.uint64)]},
                   {"t2": np.zeros(3, np.uint64)})
    with pytest.raises(ValueError, match="differ"):
        entry.fill({"t1": [np.zeros((2, 3), np.uint64)]}, {})
    with pytest.raises(ValueError, match="differ"):
        entry.fill({"t1": [np.zeros((2, 3), np.uint64)] * 2},
                   {"t2": np.zeros(3, np.uint64)})


def test_capture_counts_one_replay_and_restores_the_counters(monkeypatch):
    """What a capture counted is what each replay adds; the counters
    then read what they read before the capture."""
    monkeypatch.setattr(ntt_cuda, "LAUNCHES", {"ntt_fwd": 7, "ntt_inv": 1})
    monkeypatch.setattr(ntt_cuda, "ROWS", {"ntt_fwd": Counter({2: 1}),
                                           "ntt_inv": Counter()})
    monkeypatch.setattr(ks_cuda, "MAX_BATCH", {"ks_mac": 4,
                                               "ks_epilogue": 0})
    monkeypatch.setattr(ks_cuda, "EPILOGUE_CLUSTER", Counter({1: 3}))
    saved = et._take_counts()
    assert saved["ntt_launches"] == {"ntt_fwd": 7, "ntt_inv": 1}
    ntt_cuda.LAUNCHES["ntt_fwd"] += 2
    ntt_cuda.ROWS["ntt_fwd"][11] += 2
    ks_cuda.MAX_BATCH["ks_mac"] = 1
    ks_cuda.EPILOGUE_CLUSTER[8] += 2
    counted = et._take_counts(saved)
    assert counted["ntt_launches"] == {"ntt_fwd": 2}
    assert counted["ntt_fwd_rows"] == {11: 2}
    assert counted["ks_epilogue_cluster"] == {8: 2}
    assert ntt_cuda.LAUNCHES == {"ntt_fwd": 7, "ntt_inv": 1}
    assert ks_cuda.EPILOGUE_CLUSTER == {1: 3}
    assert ks_cuda.MAX_BATCH["ks_mac"] == 4
    entry = et._Captured({}, {}, {})
    entry.launches = counted
    entry.graph = type("Graph", (), {"replay": lambda self: None})()
    entry.replay()
    assert ntt_cuda.LAUNCHES == {"ntt_fwd": 9, "ntt_inv": 1}
    assert ks_cuda.MAX_BATCH["ks_mac"] == 4
    assert ntt_cuda.ROWS["ntt_fwd"] == {2: 1, 11: 2}
    assert ks_cuda.EPILOGUE_CLUSTER == {1: 3, 8: 2}


def test_host_phase_skips_constants_of_cached_encodes():
    """Once the constant-only encodes are cached, the host planner
    expands no constant behind them again; the Raw output and the encode
    of a raw input are still computed, and every output is the numpy
    backend's."""
    from eva_tpu_torch.ir import Op

    prog = EvaProgram("raw_mix", vec_size=16)
    with prog:
        x = Input("x")
        w = Input("w", False)
        Output("y", x * w + (x << 1) * 0.5 + 1)
        Output("r", w * 2 + 3)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    pub, _ = generate_keys(params, device="cpu")
    host = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")
    ex = pub._executor_for(compiled)
    rng = np.random.default_rng(3)
    for _ in range(2):
        enc = pub.encrypt({n: rng.uniform(-1, 1, 16).tolist()
                           for n in ("x", "w")}, sig)
        want, got = host.execute(compiled, enc), pub.execute(compiled, enc)
        for a, b in zip(want["y"].polys, got["y"].polys):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(want["r"], got["r"])
    needed = ex._raw_terms_needed()
    order = {t.index: t for t in ex.order}
    cached_only = {o.index for i in ex._encode_cache
                   for o in order[i].operands}
    assert cached_only and not cached_only & needed
    assert any(order[i].op == Op.Constant for i in needed)  # the 2 and 3
