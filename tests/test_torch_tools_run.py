"""The port's tools as a user runs them, on the CPU: the rotation that
tools/sweep_alpha_torch.py and bench_two_entry_torch.py time against
eva_tpu's JaxProgram._rotate (JAX on the CPU, jitted: ~6 s of XLA
compile a case, so one case here, the two-entry key at alpha 4 and level
1; tests/test_torch_tools.py holds every alpha and level to eva_tpu's host
rotation, and tests/test_torch_bench.py level 0 at the default alpha to
JaxProgram._rotate), bit for bit; tools/bench_scaling_torch.py as a
subprocess on two gloo ranks, with bench_scaling.py's keys and its own
identity check (its ranks report that they imported neither jax nor
eva_tpu)."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from test_torch_executor import ROOT

sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_torch  # noqa: E402
import sweep_alpha_torch as S  # noqa: E402

torch.set_num_threads(1)

N, BATCH = 2048, 2


@pytest.mark.parametrize("route", S.ROUTES)
def test_two_entry_rotation_equals_jax_rotate(route):
    """Three data entries and two key entries of 60 bits at N=2048,
    alpha 4, level 1 (the A/B's rotation at a level above 0), on each
    route, against bench.py's JaxProgram shim on the same keys."""
    from eva_tpu.backend.executor_jax import (JaxProgram, device_keys,
                                              level_ops)
    from eva_tpu.crypto import keys as KJ
    from eva_tpu.crypto.context import get_context
    from eva_tpu_torch.backend.modmath import to_host

    bits, key_terms, alpha, level = [60] * 5, 2, 4, 1
    ctx = get_context(tuple(bits), (1,), N, key_terms)
    keys = _KEYS.get("two_entry")
    if keys is None:
        keys = _KEYS["two_entry"] = KJ.generate_keys(ctx, alpha=alpha)
    params = SimpleNamespace(prime_bits=bits, rotations=[1],
                             poly_modulus_degree=N, key_terms=key_terms)
    ctx_t, keys_t = R.port_keys(R.keys_payload(params, keys))
    step, x = S.routed_step(ctx_t, keys_t, level, "cpu", route, BATCH)

    primes = ctx.primes_at_level(level)
    want = _WANT.get("two_entry")
    if want is None:
        shim = JaxProgram.__new__(JaxProgram)
        shim.ctx, shim.keys, shim.k = ctx, keys, 1
        shim.dkeys = device_keys(ctx, keys)
        dev = level_ops(primes, N)

        @jax.jit
        def rot(p):
            out = shim._rotate([p, p], 1, level, dev, None, None)
            return dev.add(out[0], out[1])

        want = _WANT["two_entry"] = np.asarray(rot(jnp.asarray(
            bench_torch.host_planes(primes, N, BATCH, 7))))
    np.testing.assert_array_equal(to_host(step(x)), want)


_KEYS, _WANT = {}, {}


def test_scaling_rehearsal_on_two_gloo_ranks():
    proc = subprocess.run(
        [sys.executable, "tools/bench_scaling_torch.py", "--cpu", "--hosts",
         "2", "--n", "1024", "--limbs", "2", "--batch", "4", "--reps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    # tools/bench_scaling.py:260-281's keys.
    assert {"metric", "hosts", "devices", "local_devices", "backend",
            "t1_ct_per_s", "tH_ct_per_s", "efficiency",
            "t1_reduce_ct_per_s", "tH_reduce_ct_per_s",
            "efficiency_with_reduce", "t1_sum_ct_per_s",
            "tH_flat_modreduce_ct_per_s", "efficiency_with_flat_modreduce",
            "tH_hier_modreduce_ct_per_s",
            "efficiency_with_hierarchical_reduce",
            "hier_vs_flat"} <= set(line)
    assert line["metric"] == "scaling_efficiency"
    assert (line["hosts"], line["devices"], line["clock"]) == (2, 2, "wall")
    assert line["identity"] == {"local": True, "red": True, "flat": True,
                                "hier": True}
    assert line["modules"] == [] and line["launches"]["plain_calls"] > 0
    assert min(v for k, v in line.items() if k.endswith("_ct_per_s")) > 0
