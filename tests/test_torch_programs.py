"""The port's executor on the rest of the JAX package's backend-test
programs (TestFusedRescaleRelin, TestRotationSumFusion, TestTwoEntryKSJax),
each bit-identical to eva_tpu's numpy backend on the same keys and
ciphertexts: on the fused key switch (the default), under every
rotation-sum fusion switch, and on the structured key switch
(EVA_TPU_NO_FUSED_KS=1) for three programs with rotations and
relinearizations. The helpers and the program table are those of
test_torch_executor.py."""

import pytest
import torch

from eva_tpu_torch.backend import ks
from eva_tpu_torch.ir import Op
from test_torch_executor import _run

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", [
    "fused", "fusedE", "giants", "rot_of_sum", "mixed_sub", "babystep",
    "conv_square", "babystep_sub", "neg_defer", "deep2p"])
def test_bit_identical_to_numpy_backend(name):
    calls = ks.PLAIN_CALLS["ks_epilogue"]
    ex_t, out_t, (ctx_t, keys_t, ct, *_rest) = _run(name, "numpy")
    assert ks.PLAIN_CALLS["ks_epilogue"] > calls  # the fused key switch ran
    if name == "fused":
        assert any(t.op == Op.Relinearize and t.operands[0].op == Op.Rescale
                   for t in ct.topological_order())
    if name == "deep2p":
        assert keys_t.relin.alpha == 4 and len(ctx_t.key_primes) == 4


@pytest.mark.parametrize("env", [{}, {"EVA_TPU_NO_ROTSUM_FUSION": "1"},
                                 {"EVA_TPU_NO_ROTMUL_FUSION": "1"}])
def test_rotsum_fusion_switches_match_numpy(monkeypatch, env):
    """The host planner and the torch executor read the same switches as
    the JAX package, so every fusion setting stays bit-identical."""
    ex_t, *_ = _run("bs_opt" if "EVA_TPU_NO_ROTMUL_FUSION" in env
                    else "lone", "numpy", monkeypatch, env)
    if env:
        assert not ex_t._ext_encodes


@pytest.mark.parametrize("name", ["fused", "babystep", "rot_of_sum"])
def test_structured_key_switch_matches_numpy(monkeypatch, name):
    """EVA_TPU_NO_FUSED_KS=1 selects the structured key switch (digits,
    structured-layout MAC, iNTT + P-division + NTT): still bit-identical,
    and the fused MAC and epilogue are not called."""
    calls = dict(ks.PLAIN_CALLS)
    _run(name, "numpy", monkeypatch, {"EVA_TPU_NO_FUSED_KS": "1"})
    assert ks.PLAIN_CALLS == calls
