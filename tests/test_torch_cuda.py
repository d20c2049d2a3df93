"""The CUDA kernels (eva_tpu_torch/csrc/ntt.cu: the NTT; csrc/ks.cu: the
fused key switch's MAC and epilogue) against their plain PyTorch
versions, and their wrappers' refusals, on a CUDA GPU; every test skips
without one.

This file imports neither JAX nor eva_tpu, so it runs on a machine that
has only PyTorch with CUDA (conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from eva_tpu_torch.backend import ks, ks_cuda, ntt_cuda
from eva_tpu_torch.backend.executor_torch import _ks_dev_tables, _ks_maps
from eva_tpu_torch.backend.tables import DeviceLevelOps, level_ops
from eva_tpu_torch.crypto.context import get_context
from eva_tpu_torch.crypto.primes import build_chain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _planes(seed, primes, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, shape) for q in primes], axis=-2))


@pytest.mark.parametrize("n", [1024, 2048, 16384, 32768])
def test_cuda_ntt_matches_plain(cuda, n):
    primes = [q for e in build_chain([60, 20, 60, 60], n) for q in e.primes]
    dev = DeviceLevelOps(primes, n, cuda)
    x = _planes(n, primes, (4, n)).to(cuda)
    launches = dict(ntt_cuda.LAUNCHES)
    f = dev.ntt(x)
    back = dev.intt(f)
    assert ntt_cuda.LAUNCHES["ntt_fwd"] == launches["ntt_fwd"] + 1
    assert ntt_cuda.LAUNCHES["ntt_inv"] == launches["ntt_inv"] + 1
    assert torch.equal(f, dev._fwd_merged(x))
    assert torch.equal(back, dev._inv_merged(f))
    assert torch.equal(back, x)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n = 1024
    primes = [q for e in build_chain([60, 40], n) for q in e.primes]
    dev = DeviceLevelOps(primes, n, cuda)
    x = _planes(1, primes, (2, n)).to(cuda)
    with pytest.raises(ValueError, match="does not end in"):
        ntt_cuda.ntt_fwd(x[..., : n // 2].contiguous(), dev)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_fwd(x.transpose(0, 1), dev)
    with pytest.raises(ValueError, match="int64"):
        ntt_cuda.ntt_inv(x.to(torch.int32), dev)
    small = DeviceLevelOps(primes, 512, cuda)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda.ntt_fwd(x[..., :512].contiguous(), small)


def _ks_inputs(dev, n, batch, seed=3):
    """Random inputs of the fused key switch at Sobel's level-0 shapes
    (11 data primes, 2 key primes, alpha 2): (y, k0, k1, conv, owner,
    x_ntt, acc0, acc1, ext_ops, n_key)."""
    ctx = get_context((60, 20, 60, 60, 60, 60, 60), (), n, 1)
    primes = ctx.primes_at_level(0)
    basis = primes + ctx.key_primes
    n_groups, _, conv_mont = _ks_dev_tables(ctx, 0, 2)
    _, owner, _ = _ks_maps(ctx, 0, 2)
    rng = np.random.default_rng(seed)
    y = np.zeros((batch, n_groups * 2, n), dtype=np.int64)
    for t, q in enumerate(primes):
        y[:, t] = rng.integers(0, q, (batch, n))

    def planes(lead, qs):
        return torch.from_numpy(np.stack(
            [rng.integers(0, q, lead + (n,)) for q in qs], axis=len(lead)))

    k0, k1 = (torch.stack([planes((), basis) for _ in range(n_groups)])
              for _ in range(2))
    tensors = (torch.from_numpy(y).reshape(batch, n_groups, 2, n), k0, k1,
               torch.from_numpy(conv_mont[..., 0].astype(np.int64)),
               torch.from_numpy(np.concatenate(
                   [owner, [-1] * len(ctx.key_primes)]).astype(np.int64)),
               planes((batch,), primes), planes((batch,), basis),
               planes((batch,), basis))
    return (*(t.to(dev) for t in tensors), level_ops(basis, n, dev),
            len(ctx.key_primes))


@pytest.mark.parametrize("n,batch", [(1024, 4), (16384, 1), (16384, 4)])
def test_cuda_key_switch_matches_plain(cuda, n, batch):
    y, k0, k1, conv, owner, x_ntt, acc0, acc1, ext, n_key = _ks_inputs(
        cuda, n, batch)
    for xn in (x_ntt, None):
        launches = ks_cuda.LAUNCHES["ks_mac"]
        got = ks.ks_mac(y, k0, k1, conv, owner, ext, xn)
        assert ks_cuda.LAUNCHES["ks_mac"] == launches + 1
        want = ks.ks_mac_plain(y, k0, k1, conv, owner, ext, xn)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for out_ntt in (True, False):
        launches = ks_cuda.LAUNCHES["ks_epilogue"]
        got = ks.ks_epilogue(acc0, acc1, ext, n_key, out_ntt)
        assert ks_cuda.LAUNCHES["ks_epilogue"] == launches + 1
        want = ks.ks_epilogue_plain(acc0, acc1, ext, n_key, out_ntt)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cuda_key_switch_wrappers_reject_what_the_kernels_do_not_take(cuda):
    y, k0, k1, conv, owner, x_ntt, acc0, acc1, ext, n_key = _ks_inputs(
        cuda, 1024, 2)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ks_cuda.ks_mac(y.cpu(), k0, k1, conv, owner, ext)
    with pytest.raises(ValueError, match="int64"):
        ks_cuda.ks_mac(y, k0.to(torch.int32), k1, conv, owner, ext)
    with pytest.raises(ValueError, match="contiguous"):
        ks_cuda.ks_mac(y, k0, k1, conv, owner, ext, x_ntt.transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        ks_cuda.ks_mac(y, k0[:-1].contiguous(), k1, conv, owner, ext)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ks_cuda.ks_epilogue(acc0, acc1.cpu(), ext, n_key, True)
    with pytest.raises(ValueError, match="contiguous"):
        ks_cuda.ks_epilogue(acc0, acc1.transpose(0, 1), ext, n_key, True)
    with pytest.raises(ValueError, match="shape"):
        ks_cuda.ks_epilogue(acc0, acc1[:, :-1].contiguous(), ext, n_key,
                            True)
    with pytest.raises(ValueError, match="n_key"):
        ks_cuda.ks_epilogue(acc0, acc1, ext, 0, True)
