"""The CUDA kernels (eva_tpu_torch/csrc/ntt.cu: the NTT; csrc/ks.cu: the
fused key switch's MAC and epilogue; csrc/modmath.cu: the elementwise
modular ops E1 in their single, several-planes and MAC forms, the tensor
product E2, the divide-last E3, the bench's rate probe E4, the Galois
automorphism galois_perm; csrc/ntt_shard.cu: the sharded NTT's local
phases K6, K7) against their plain PyTorch
versions, and their wrappers' refusals, on a CUDA GPU;
whole programs of tools/fuzz_cuda.py (random and from the reference's
matrices) against the numpy backend and the plain versions; every test
skips without one. Residues are int32 tensors of uint32 bits.

This file imports neither JAX nor eva_tpu, so it runs on a machine that
has only PyTorch with CUDA (conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from eva_tpu_torch.backend import ks, ks_cuda, modmath_cuda, ntt_cuda
from eva_tpu_torch.backend import modmath as M
from eva_tpu_torch.backend.executor_torch import _ks_dev_tables, _ks_maps
from eva_tpu_torch.backend.modmath import upload
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
    """Random reduced residues [..., len(primes), N] (shape = [..., N]),
    as an int32 tensor of their uint32 bits on the CPU."""
    rng = np.random.default_rng(seed)
    return upload(np.stack(
        [rng.integers(0, q, shape, dtype=np.uint64) for q in primes],
        axis=-2), "cpu")


# (N, rows, forced cluster size): the main path's row counts (1 to 13 at
# batch 1, 52 at batch 4) at every ring size, each at the cluster size the
# kernel library picks (0) and at every size it can be forced to (a
# segment of N / C >= 1024 words).
_NTT_CASES = [(n, rows, c) for n in (1024, 2048, 16384, 32768)
              for rows in (1, 2, 11, 13, 52) for c in (0, 1, 2, 4, 8)
              if n // max(c, 1) >= 1024]


@pytest.mark.parametrize("n,rows,cluster", _NTT_CASES)
def test_cuda_ntt_matches_plain(cuda, n, rows, cluster):
    """Each row split over a cluster, bit for bit: rows > 13 are batches
    of 13 primes; forward, inverse and the round trip."""
    primes = [q for e in build_chain([60, 20, 60, 60, 60, 60, 60], n)
              for q in e.primes]
    n_sub = min(rows, len(primes))
    dev = DeviceLevelOps(primes[:n_sub], n, cuda)
    x = _planes(n + rows, dev.primes, (rows // n_sub, n)).to(cuda)
    launches = dict(ntt_cuda.LAUNCHES)
    if cluster:
        f = ntt_cuda.ntt_fwd(x, dev, _cluster=cluster)
        back = ntt_cuda.ntt_inv(f, dev, _cluster=cluster)
    else:
        f = dev.ntt(x)
        back = dev.intt(f)
    assert ntt_cuda.LAUNCHES["ntt_fwd"] == launches["ntt_fwd"] + 1
    assert ntt_cuda.LAUNCHES["ntt_inv"] == launches["ntt_inv"] + 1
    assert torch.equal(f, dev._fwd_merged(x))
    assert torch.equal(back, dev._inv_merged(f))
    assert torch.equal(back, x)


def test_cuda_ntt_kernels_fit_the_card(cuda):
    """No spills at any ring size; at the main path's ring the chooser
    takes clusters of 8, with 8 words a thread, and the card holds them."""
    for logn in range(10, 16):
        info = ntt_cuda.kernel_info(logn, cuda)
        for name in ("ntt_fwd_kernel", "ntt_inv_kernel"):
            assert info[name]["local_bytes"] == 0, (name, info[name])
        for name, held in (("ntt_fwd_kernel", "held_fwd"),
                           ("ntt_inv_kernel", "held_inv")):
            c = info[name]["cluster"]
            assert c == min(8, (1 << logn) // 1024)
            assert info["clusters"][c][held] > 0
            assert info["clusters"][c]["threads"] == min(
                1024, (1 << logn) // c // 8)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n = 1024
    primes = [q for e in build_chain([60, 40], n) for q in e.primes]
    dev = DeviceLevelOps(primes, n, cuda)
    x = _planes(1, primes, (2, n)).to(cuda)
    with pytest.raises(ValueError, match="does not end in"):
        ntt_cuda.ntt_fwd(x[..., : n // 2].contiguous(), dev)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_fwd(x.transpose(0, 1), dev)
    with pytest.raises(ValueError, match="int32"):
        ntt_cuda.ntt_inv(x.to(torch.int64), dev)
    small = DeviceLevelOps(primes, 512, cuda)
    with pytest.raises(ValueError, match="power of two"):
        ntt_cuda.ntt_fwd(x[..., :512].contiguous(), small)
    with pytest.raises(ValueError, match="aligned"):
        ntt_cuda.ntt_inv(x.view(-1)[1:1 + len(primes) * n].view(
            1, len(primes), n), dev)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ntt_cuda.ntt_fwd(x, dev, _cluster=2)  # N / 2 < 1024 words


# Contexts by key-prime count: (prime bits, key terms). Level 0 has six
# data primes with one or three key primes, eleven with two (Sobel's).
_KEY_CONTEXTS = {1: ((60, 40, 60, 30), 1),
                 2: ((60, 20, 60, 60, 60, 60, 60), 1),
                 3: ((60, 40, 60, 60, 30), 2)}


def _ks_inputs(dev, n, batch, alpha=2, n_key=2, seed=3):
    """Random inputs of the fused key switch at level 0 of the context
    with n_key key primes (n_key 2: Sobel's 11 data primes): (y, k0, k1,
    conv, owner, x_ntt, acc0, acc1, ext_ops, n_key)."""
    bits, key_terms = _KEY_CONTEXTS[n_key]
    ctx = get_context(bits, (), n, key_terms)
    primes = ctx.primes_at_level(0)
    basis = primes + ctx.key_primes
    assert len(ctx.key_primes) == n_key
    n_groups, _, conv_mont = _ks_dev_tables(ctx, 0, alpha)
    _, owner, _ = _ks_maps(ctx, 0, alpha)
    rng = np.random.default_rng(seed)
    y = np.zeros((batch, n_groups * alpha, n), dtype=np.uint64)
    for t, q in enumerate(primes):
        y[:, t] = rng.integers(0, q, (batch, n), dtype=np.uint64)

    def planes(lead, qs):
        return upload(np.stack(
            [rng.integers(0, q, lead + (n,), dtype=np.uint64) for q in qs],
            axis=len(lead)), "cpu")

    k0, k1 = (torch.stack([planes((), basis) for _ in range(n_groups)])
              for _ in range(2))
    tensors = (upload(y, "cpu").reshape(batch, n_groups, alpha, n), k0,
               k1, upload(conv_mont[..., 0], "cpu"),
               torch.from_numpy(np.concatenate(
                   [owner, [-1] * n_key]).astype(np.int64)),
               planes((batch,), primes), planes((batch,), basis),
               planes((batch,), basis))
    return (*(t.to(dev) for t in tensors), level_ops(basis, n, dev), n_key)


@pytest.mark.parametrize("n_key", [1, 2, 3])
@pytest.mark.parametrize("alpha", [1, 2])
@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("n", [1024, 16384, 32768])
def test_cuda_key_switch_matches_plain(cuda, n, batch, alpha, n_key):
    """The cluster MAC (3 to 11 digit groups, so up to two digits per
    cluster rank, more where the card holds too few clusters) and the
    overlapped epilogue, bit for bit."""
    y, k0, k1, conv, owner, x_ntt, acc0, acc1, ext, n_key = _ks_inputs(
        cuda, n, batch, alpha, n_key, seed=n + 10 * batch + 100 * alpha)
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


def test_cuda_key_switch_kernels_fit_the_card(cuda):
    """Every ring size holds a cluster of 8 MAC blocks (the init raises
    otherwise), and the MAC kernel of the main path's ring does not spill
    more than a few words."""
    for logn in range(10, 16):
        info = ks_cuda.kernel_info(logn, cuda)
        assert min(info["mac_max_active_clusters"].values()) > 0
        assert info["threads"] == min(1024, (1 << logn) // 8)
    assert ks_cuda.kernel_info(14, cuda)["ks_mac_cluster_kernel"][
        "local_bytes"] <= 64


def test_cuda_key_switch_cluster_size_reported_as_launched(cuda):
    """ks_cuda.mac_cluster reports ks.cu's choice: at Sobel's level 0 (six
    digit groups, 13 ext rows) clusters of 6 at B=1 and of 2 at B=4, never
    more than the groups or 8; a ring the kernels do not take raises."""
    assert ks_cuda.mac_cluster(14, 6, 13, cuda) == 6
    assert ks_cuda.mac_cluster(14, 6, 52, cuda) == 2
    for groups in (1, 3, 12):
        assert 1 <= ks_cuda.mac_cluster(14, groups, 14 * 8, cuda) <= min(
            groups, 8)
    with pytest.raises(RuntimeError):
        ks_cuda.mac_cluster(9, 6, 13, cuda)


def _epilogue_inputs(cuda, n, n_key, batch, n_out=6):
    """Random accumulators [B, n_out + n_key, N] over ~30-bit primes (the
    last n_key the key primes) and their tables on the card."""
    primes = [q for e in build_chain([60] * ((n_out + n_key + 1) // 2), n)
              for q in e.primes][:n_out + n_key]
    ext = level_ops(primes, n, cuda)
    acc0, acc1 = (_planes(n + 7 * n_key + batch + s, primes, (batch, n))
                  .to(cuda) for s in (0, 1))
    return acc0, acc1, ext


# (N, n_key, B): every ring the cluster chooser splits differently (C = 1
# at N = 1024, up to 4 at 4096, 8 from 16384 up at B = 1), every division
# width up to the kernels' eight key primes, and batches of one to eight.
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("n_key", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1024, 4096, 16384, 32768])
def test_cuda_epilogue_matches_plain(cuda, n, n_key, batch):
    """K5 with each row's inverse and forward NTT split over a cluster:
    bit for bit the plain version's, out_ntt both ways, one call two
    launches, counted under the cluster size it launched with."""
    acc0, acc1, ext = _epilogue_inputs(cuda, n, n_key, batch)
    for out_ntt in (True, False):
        launches = ks_cuda.LAUNCHES["ks_epilogue"]
        calls = sum(ks_cuda.EPILOGUE_CLUSTER.values())
        got = ks.ks_epilogue(acc0, acc1, ext, n_key, out_ntt)
        assert ks_cuda.LAUNCHES["ks_epilogue"] == launches + 1
        assert sum(ks_cuda.EPILOGUE_CLUSTER.values()) == calls + 1
        want = ks.ks_epilogue_plain(acc0, acc1, ext, n_key, out_ntt)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1024, 4096, 16384, 32768])
def test_cuda_epilogue_reports_the_cluster_it_launched(cuda, n):
    """At batch 1 the epilogue takes the largest cluster the ring splits
    into (segments of >= 1024 words), kernel_info reports that size and
    its threads per block for both kernels, and the counter records the
    call under it."""
    acc0, acc1, ext = _epilogue_inputs(cuda, n, 2, 1, n_out=11)
    before = dict(ks_cuda.EPILOGUE_CLUSTER)
    ks.ks_epilogue(acc0, acc1, ext, 2, True)
    grew = {c: k - before.get(c, 0)
            for c, k in ks_cuda.EPILOGUE_CLUSTER.items()
            if k != before.get(c, 0)}
    c = min(8, n // 1024)
    assert grew == {c: 1}
    info = ks_cuda.kernel_info(ext.logn, cuda, 2, 13)
    for name in ("ks_epilogue_key_kernel", "ks_epilogue_row_kernel"):
        assert info[name]["cluster"] == c
        assert info[name]["threads"] == min(1024, n // c // 8)
    assert info["epilogue_max_active_clusters"][c] > 0


def test_cuda_epilogue_kernels_do_not_spill(cuda):
    """Neither epilogue kernel spills at the rings the cells run, with up
    to four key primes."""
    for logn in (14, 15):
        for n_key in (1, 2, 3, 4):
            info = ks_cuda.kernel_info(logn, cuda, n_key, n_key + 11)
            for name in ("ks_epilogue_key_kernel", "ks_epilogue_row_kernel"):
                assert info[name]["local_bytes"] == 0, (logn, n_key, info)


def test_cuda_key_switch_wrappers_reject_what_the_kernels_do_not_take(cuda):
    y, k0, k1, conv, owner, x_ntt, acc0, acc1, ext, n_key = _ks_inputs(
        cuda, 1024, 2)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ks_cuda.ks_mac(y.cpu(), k0, k1, conv, owner, ext)
    with pytest.raises(ValueError, match="int32"):
        ks_cuda.ks_mac(y, k0.to(torch.int64), k1, conv, owner, ext)
    with pytest.raises(ValueError, match="int64"):  # owner is an index
        ks_cuda.ks_mac(y, k0, k1, conv, owner.to(torch.int32), ext)
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
    shifted = torch.cat([acc0.view(-1)[:1], acc0.view(-1)])[1:]
    with pytest.raises(ValueError, match="aligned"):  # 16-byte row loads
        ks_cuda.ks_epilogue(shifted.view(acc0.shape), acc1, ext, n_key, True)


# -- the elementwise kernels E1-E3 (csrc/modmath.cu) --------------------------

# (N, leading dims, primes): Sobel's and Harris's level 0 (11 data primes
# plus the special prime at rescale: 12; the extended basis: 13; Harris
# 10), at batch 1 and 4, and N = 4096 and 32768.
_EW_SHAPES = [(16384, (), 12), (16384, (4,), 13), (16384, (), 10),
              (16384, (4,), 10), (4096, (2,), 12), (32768, (), 12)]
_EW_OPS = ("add", "sub", "neg", "mul_mont", "mul", "shoup")


def _ew_ops(n, n_sub, device):
    primes = [q for e in build_chain([60, 20, 60, 60, 60, 60, 60], n)
              for q in e.primes][:n_sub]
    return DeviceLevelOps(primes, n, device)


def _unreduced(seed, lead, n_sub, n):
    """Values below 2^32, half of them at or above 2^31 (negative as
    int32): the first operand of a Montgomery or Shoup multiply."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, lead + (n_sub, n), dtype=np.uint64)
    a[..., ::2] |= np.uint64(1 << 31)
    return upload(a, "cpu")


def _plain_ew(op, dev, *xs):
    """The plain version of E1 op `op` on the same (CUDA) tensors."""
    q, rinv, r2 = dev.q, dev.rinv, dev.r2
    return {"add": lambda a, b: M.add_mod(a, b, q),
            "sub": lambda a, b: M.sub_mod(a, b, q),
            "neg": lambda a: M.neg_mod(a, q),
            "mul_mont": lambda a, b: M.mont_mul(a, b, q, rinv),
            "mul": lambda a, b, c: M.mul(a, b, q, rinv, c),
            "shoup": lambda a, w, wp: M.shoup_mul(a, w, wp, q)}[op](*xs)


@pytest.mark.parametrize("n,lead,n_sub", _EW_SHAPES)
@pytest.mark.parametrize("op", _EW_OPS)
def test_cuda_mod_ew_matches_plain(cuda, op, n, lead, n_sub):
    """E1, bit for bit, with the second operand full, broadcast over the
    batch (a plaintext) and a per-row constant [n_sub, 1]; the first
    operand also unreduced (up to 2^32) for the multiplies, and rows
    broadcast over the primes [.., 1, N] for add and sub."""
    dev = _ew_ops(n, n_sub, cuda)
    a = _planes(n + 1, dev.primes, lead + (n,)).to(cuda)
    full = _planes(n + 2, dev.primes, lead + (n,)).to(cuda)
    shared = _planes(n + 3, dev.primes, (n,)).to(cuda)
    row = _planes(n + 4, dev.primes, (1,)).to(cuda)
    firsts = [a]
    if op in ("mul_mont", "mul", "shoup"):
        firsts.append(_unreduced(n + 5, lead, n_sub, n).to(cuda))
    seconds = [full, shared, row]
    if op in ("add", "sub"):  # a row below the smallest prime, [.., 1, N]
        seconds.append((_planes(n + 6, [min(dev.primes)], lead + (n,))
                        .to(cuda)))
    for x in firsts:
        for b in seconds:
            if op == "neg":
                args = (x,)
            elif op == "mul":
                args = (x, b, dev.r2)
            elif op == "shoup":
                wp = upload(np.stack([
                    M.shoup_pair(M.to_host(b[..., i, :]), q)[1]
                    for i, q in enumerate(dev.primes)], axis=-2), cuda)
                args = (x, b, wp)
            else:
                args = (x, b)
            launches = modmath_cuda.LAUNCHES["mod_ew"]
            got = modmath_cuda.mod_ew(op, dev, *args)
            assert modmath_cuda.LAUNCHES["mod_ew"] == launches + 1
            want = _plain_ew(op, dev, *args)
            assert got.dtype == torch.int32 and got.shape == want.shape
            assert torch.equal(got, want), (op, tuple(b.shape))


@pytest.mark.parametrize("n,lead,n_sub", _EW_SHAPES)
def test_cuda_tensor_product_matches_plain(cuda, n, lead, n_sub):
    """E2, bit for bit, also with the b-side broadcast over the batch."""
    dev = _ew_ops(n, n_sub, cuda)
    a0, a1, b0, b1 = (_planes(n + k, dev.primes, lead + (n,)).to(cuda)
                      for k in range(4))
    for bb in ((b0, b1), (b0[..., :, :].reshape(-1, n_sub, n)[0],
                          b1.reshape(-1, n_sub, n)[0])):
        launches = modmath_cuda.LAUNCHES["tensor_product"]
        got = modmath_cuda.tensor_product(dev, a0, a1, *bb)
        assert modmath_cuda.LAUNCHES["tensor_product"] == launches + 1
        want = M.tensor_product(a0, a1, *bb, dev.q, dev.rinv, dev.r2)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,lead,n_sub", _EW_SHAPES)
def test_cuda_divide_last_matches_plain(cuda, n, lead, n_sub):
    """E3 (the rescale's divide-and-round), bit for bit: [.., n, N] ->
    [.., n - 1, N]."""
    full = _ew_ops(n, n_sub, cuda)
    rest = _ew_ops(n, n_sub - 1, cuda)
    x = _planes(n + 7, full.primes, lead + (n,)).to(cuda)
    launches = modmath_cuda.LAUNCHES["divide_last"]
    got = ks.divide_last_planes(x, full.primes, rest)
    assert modmath_cuda.LAUNCHES["divide_last"] == launches + 1
    want, = ks.divide_last_plain([x], full.primes, 1, rest)
    assert got.shape == lead + (n_sub - 1, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("addend", [False, True])
@pytest.mark.parametrize("polys", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("n,lead", [(16384, ()), (16384, (4,)),
                                    (1024, (2, 3))])
def test_cuda_divide_last_every_prime_and_polynomial(cuda, n, lead, k,
                                                     polys, addend):
    """E3 over k primes (1 and 2: a rescale's entry; 2 and 3: the
    P-division's key primes; 8: the limit) and 1-3 polynomials in one
    launch, with and without the addend, against the plain version's
    loop of one prime at a time."""
    full = _ew_ops(n, 13, cuda)
    rest = _ew_ops(n, 12, cuda)
    xs = [_planes(n + j, full.primes, lead + (n,)).to(cuda)
          for j in range(polys)]
    adds = ([_planes(n + 9 + j, full.primes, lead + (n,)).to(cuda)
             for j in range(polys)] if addend else None)
    launches = modmath_cuda.LAUNCHES["divide_last"]
    got = ks.divide_last(xs, full.primes, k, rest, adds)
    assert modmath_cuda.LAUNCHES["divide_last"] == launches + 1
    want = ks.divide_last_plain(xs, full.primes, k, rest, adds)
    assert [g.shape for g in got] == [lead + (13 - k, n)] * polys
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _rotsum_planes(n, lead, n_sub, cuda):
    """A rotation sum's components: c0, c1 on n_sub data primes, acc0,
    acc1 on the extended basis (two primes more), a plaintext with
    extended rows shared by the batch, and the extended basis's ops."""
    ext = _ew_ops(n, n_sub + 2, cuda)
    c0, c1 = (_planes(n + j, ext.primes[:n_sub], lead + (n,)).to(cuda)
              for j in range(2))
    acc0, acc1 = (_planes(n + j, ext.primes, lead + (n,)).to(cuda)
                  for j in range(2, 4))
    pt = _planes(n + 4, ext.primes, (n,)).to(cuda)
    return ext, c0, c1, acc0, acc1, pt


@pytest.mark.parametrize("n,lead,n_sub", _EW_SHAPES)
@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul_mont", "mul"])
def test_cuda_mod_ew_multi_matches_plain(cuda, op, n, lead, n_sub):
    """E1's several-planes form: one launch over 2-4 planes of different
    row counts (data primes, extended basis), with a plaintext broadcast
    over the batch (its data rows a view), a strided plane (the data rows
    of an accumulator) and a zero operand, against the plain version."""
    ext, c0, c1, acc0, acc1, pt = _rotsum_planes(n, lead, n_sub, cuda)
    zero = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    if op == "neg":
        planes = [(c0,), (acc0,), (acc1[..., :n_sub, :],)]
    elif op in ("mul", "mul_mont"):
        planes = [(c0, pt[:n_sub]), (c1, pt[:n_sub]), (acc0, pt),
                  (acc1, pt)]
    else:
        planes = [(c0, c1), (zero, c1), (acc0, acc1),
                  (acc1[..., :n_sub, :], c0)]
    for count in range(1, len(planes) + 1):
        launches = dict(modmath_cuda.LAUNCHES)
        got = ext.ew_planes(op, planes[:count])
        form = "mod_ew" if count == 1 else "mod_ew_multi"
        assert modmath_cuda.LAUNCHES[form] == launches[form] + 1
        rows = [max(t.shape[-2] for t in p) for p in planes[:count]]
        want = M.ew_planes(op, [
            (p + ((ext.r2[:r],) if op == "mul" else ()), ext.q[:r],
             ext.rinv[:r]) for p, r in zip(planes[:count], rows)])
        assert all(g.dtype == torch.int32 and torch.equal(g, w)
                   for g, w in zip(got, want)), (op, count)


def _mac_inputs(n, bits, level, alpha, lead, cuda, shards=None):
    """Structured digits (own, a, b: a the middle shard of `shards` when
    given) and both key halves at a context's level, and its extended
    basis's ops."""
    from eva_tpu_torch.crypto.context import get_context
    ctx = get_context(tuple(bits), (), n, 1)
    primes, keyp = ctx.primes_at_level(level), list(ctx.key_primes)
    groups, _, _ = _ks_maps(ctx, level, alpha)
    ext = DeviceLevelOps(primes + keyp, n, cuda)
    dl = lead + ((shards,) if shards else ())
    seed = iter(range(n + 100 * level + alpha, 10 ** 9))

    def pl(qs, shape):
        return _planes(next(seed), qs, shape).to(cuda)

    own, b = pl(primes, dl + (n,)), pl(keyp, dl + (groups, n))
    a = pl(primes, dl + (groups - 1, n)) if groups > 1 else None
    if shards:
        own, b = own[..., 1, :, :], b[..., 1, :, :, :]
        a = None if a is None else a[..., 1, :, :, :]
    keys = [(pl(primes, (n,)),
             pl(primes, (groups - 1, n)) if groups > 1 else None,
             pl(keyp, (groups, n))) for _ in range(2)]
    return ext, own, a, b, keys


_SOBEL_BITS = [60, 20, 60, 60, 60, 60, 60]
_HARRIS_BITS = [60, 60, 60, 60, 60]


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("bits,level,alpha", [
    (_SOBEL_BITS, 0, 2), (_HARRIS_BITS, 0, 2), (_SOBEL_BITS, 0, 1),
    (_SOBEL_BITS, 5, 2)])
@pytest.mark.parametrize("n", [1024, 16384])
def test_cuda_mod_ew_mac_matches_plain(cuda, n, bits, level, alpha, lead,
                                       shards):
    """E1's MAC form at the hoisted rotations' shapes (Sobel's and
    Harris's level 0, alpha 1: 11 groups, Sobel's deepest level: one
    group and no foreign rows), at batch 1 and 4, with digits that are a
    strided shard window, against modmath.mont_mac."""
    ext, own, a, b, (keys0, keys1) = _mac_inputs(n, bits, level, alpha,
                                                 lead, cuda, shards)
    launches = modmath_cuda.LAUNCHES["mod_ew_mac"]
    got = ext.mac(own, a, b, keys0, keys1)
    assert modmath_cuda.LAUNCHES["mod_ew_mac"] == launches + 1
    want = M.mont_mac(own, a, b, keys0, keys1, ext.q, ext.rinv)
    assert all(g.shape == own.shape[:-2] + (len(ext.primes), n)
               and torch.equal(g, w) for g, w in zip(got, want))


def test_cuda_mod_ew_reads_strided_operands_in_place(cuda):
    """A row slice of a batched plane goes into E1 as it is: one device
    operation (the kernel, no copy), the same residues as its copy, with
    4 words a thread and with one (a misaligned column offset)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _ew_ops(16384, 11, cuda)
    wide = _planes(1, _ew_ops(16384, 13, cuda).primes,
                   (4, 16384)).to(cuda)
    view, other = wide[:, :11, :], _planes(2, dev.primes, (4, 16384)).to(cuda)
    dev.add(view, other)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = dev.add(view, other)
        torch.cuda.synchronize()
    ran = [e.key for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ran) == 1 and "mod_ew_kernel" in ran[0], ran
    assert torch.equal(got, M.add_mod(view.contiguous(), other, dev.q))
    cols = torch.cat([wide, wide], -1)[:, :11, 3:3 + 16384]
    assert torch.equal(dev.add(cols, other),
                       M.add_mod(cols.contiguous(), other, dev.q))


@pytest.mark.parametrize("lead,n_sub,n", [((8,), 12, 16384),
                                           ((32,), 6, 16384),
                                           ((2,), 13, 1024), ((), 1, 32768)])
def test_cuda_modmul_burn_matches_plain(cuda, lead, n_sub, n):
    """E4 (bench_torch.py's modular-multiply rate probe) against its plain
    version on reduced and unreduced words: one launch each, counted in
    PROBE_LAUNCHES and not in LAUNCHES; a plane of the wrong prime count
    raises."""
    primes = [q for e in build_chain([60] * 7, n) for q in e.primes][:n_sub]
    dev, host = level_ops(primes, n, cuda), level_ops(primes, n, "cpu")
    rng = np.random.default_rng(n_sub)
    unreduced = upload(rng.integers(0, 2 ** 32, lead + (n_sub, n),
                                    dtype=np.uint64), "cpu")
    for x in (_planes(n + n_sub, primes, lead + (n,)), unreduced):
        launches = dict(modmath_cuda.LAUNCHES)
        probe = modmath_cuda.PROBE_LAUNCHES["modmul_burn"]
        got = modmath_cuda.modmul_burn(dev, x.to(cuda))
        assert modmath_cuda.PROBE_LAUNCHES["modmul_burn"] == probe + 1
        assert modmath_cuda.LAUNCHES == launches
        want = M.modmul_burn(x, host.q, host.rinv)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="primes"):
        modmath_cuda.modmul_burn(dev, x.to(cuda)[..., :0, :])


def test_cuda_modmath_kernels_fit_the_card(cuda):
    """Every form's kernel at 4 words a thread spills nothing, and an SM
    holds at least two of its blocks of 256 threads in registers (E3
    carries 4 lifts a prime: 128 registers at its limit of 8 primes); the
    forms the main path launches (E1, E2, E3 at one or two primes) at
    least four."""
    info = modmath_cuda.kernel_info(cuda)
    assert set(info) == set(modmath_cuda.INFO_NAMES)
    for name, res in info.items():
        assert res["local_bytes"] == 0, (name, res)
        assert res["registers"] * 256 * 2 <= 65536, (name, res)
        if not name.startswith("divide_last_k") or name[-1] in "12":
            assert res["registers"] * 256 * 4 <= 65536, (name, res)


def test_cuda_modmath_wrappers_reject_what_the_kernels_do_not_take(cuda):
    dev = _ew_ops(1024, 3, cuda)
    x = _planes(1, dev.primes, (2, 1024)).to(cuda)
    with pytest.raises(ValueError, match="int32"):
        modmath_cuda.mod_ew("add", dev, x.to(torch.int64), x)
    with pytest.raises(ValueError, match="stride 1"):
        modmath_cuda.mod_ew("add", dev, x, torch.cat([x, x], -1)[..., ::2])
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.mod_ew("mul_mont", dev, x, x.cpu())
    with pytest.raises(ValueError, match="broadcast"):
        modmath_cuda.mod_ew("add", dev, x[:, :2].contiguous(),
                            x[:, :2].contiguous())
    with pytest.raises(ValueError, match="operands"):
        modmath_cuda.mod_ew("mul", dev, x, x)
    with pytest.raises(ValueError, match="int32"):
        modmath_cuda.tensor_product(dev, x, x, x, x.to(torch.int64))
    with pytest.raises(ValueError, match="a-side"):
        modmath_cuda.tensor_product(dev, x, x[0], x, x)
    rest = _ew_ops(1024, 2, cuda)
    with pytest.raises(ValueError, match="does not end in"):
        ks.divide_last_planes(x[:, :2].contiguous(), dev.primes, rest)
    with pytest.raises(ValueError, match="int32"):
        modmath_cuda.divide_last([x.to(torch.int64)],
                                 dev.q[:2].contiguous(), dev.primes[-1:],
                                 rest)
    with pytest.raises(ValueError, match="polynomials"):
        ks.divide_last([x] * 4, dev.primes, 1, rest)
    with pytest.raises(ValueError, match="primes to divide"):
        ks.divide_last([x], dev.primes, 3, rest)
    with pytest.raises(ValueError, match="differ"):
        ks.divide_last([x, x[:1]], dev.primes, 1, rest)
    with pytest.raises(ValueError, match="planes"):
        modmath_cuda.mod_ew_multi("add", dev, [(x, x)] * 5)
    with pytest.raises(ValueError, match="rows"):
        _ew_ops(1024, 2, cuda).ew_planes("add", [(x, x), (x, x)])
    ext, own, a, b, (k0, k1) = _mac_inputs(1024, _SOBEL_BITS, 0, 2, (),
                                           cuda)
    with pytest.raises(ValueError, match="digit groups"):
        ext.mac(own, a[:-1], b, k0, k1)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ext.mac(own, a, b, k0, (k1[0].cpu(),) + k1[1:])
    with pytest.raises(ValueError, match="stride 1"):
        ext.mac(own[..., ::2], a, b, k0, k1)
    # DeviceLevelOps on the card: a launch or a refusal, no plain call.
    plain = dict(M.PLAIN_CALLS)
    with pytest.raises(ValueError, match="int32"):
        dev.add(x.to(torch.int64), x)
    dev.add(x, x)
    assert M.PLAIN_CALLS == plain


# -- the Galois automorphism (galois_perm: csrc/modmath.cu) -----------------

# The cells' contexts at N = 16384: (prime bits, image width) of Sobel
# 90x90 and Harris 64x64, each rotating by i * w + j for 0 <= i, j < 3.
_PERM_CONFIGS = {"sobel90": ((60, 20, 60, 60, 60, 60, 60), 90),
                 "harris64": ((60, 60, 60, 60, 60), 64)}


def _perm_ctx(config):
    bits, w = _PERM_CONFIGS[config]
    steps = tuple(i * w + j for i in range(3) for j in range(3) if i or j)
    return get_context(bits, steps, 16384, 1), steps


def _index_select(x, table):
    return torch.index_select(x, -1, table.to(torch.int64))


@pytest.mark.parametrize("config", sorted(_PERM_CONFIGS))
def test_cuda_galois_perm_matches_index_select(cuda, config):
    """Every Galois element of the configuration's key set at every
    level's row counts: c0 (the level's data primes) and the two
    extended-basis accumulators in one launch, bit for bit index_select;
    the table is the context's permutation."""
    from eva_tpu_torch.backend.executor_torch import dev_perm
    ctx, steps = _perm_ctx(config)
    for level in range(len(ctx.data_entries)):
        primes = ctx.primes_at_level(level)
        c0 = _planes(level, primes, (ctx.n,)).to(cuda)
        acc0, acc1 = (_planes(level + k, primes + ctx.key_primes,
                              (ctx.n,)).to(cuda) for k in (10, 20))
        for step in steps:
            g = ctx.galois_elt(step)
            perm = dev_perm(ctx, g, cuda)
            assert perm.table.dtype == torch.int32
            assert np.array_equal(perm.table.cpu().numpy(),
                                  ctx.perm_for_elt(g))
            launches = modmath_cuda.LAUNCHES["galois_perm"]
            got = perm.planes(c0, acc0, acc1)
            assert modmath_cuda.LAUNCHES["galois_perm"] == launches + 1
            for x, y in zip((c0, acc0, acc1), got):
                assert y.dtype == torch.int32 and y.is_contiguous()
                assert torch.equal(y, _index_select(x, perm.table))


@pytest.mark.parametrize("n", [1024, 16384, 32768])
def test_cuda_galois_perm_batches_mixed_planes_and_strided_rows(cuda, n):
    """Leading batch dims fold into rows; the planes of one launch may
    differ in rows and leading dims; rows strided in place (a row slice
    of a batched plane, a narrowed shard axis, swapped leading dims);
    an empty plane; every plane bit for bit index_select."""
    from eva_tpu_torch.backend.executor_torch import DevPerm
    rng = np.random.default_rng(n)
    perm = DevPerm(rng.permutation(n), cuda)
    primes = [q for e in build_chain([60] * 7, n) for q in e.primes]
    wide = _planes(n, primes, (4, n)).to(cuda)           # [4, 14, n]
    shards = _planes(n + 1, primes[:11], (2, 3, n)).to(cuda)
    cases = [
        [wide],
        [wide[:, :11, :], wide[1, 3:9, :], shards.narrow(1, 1, 2),
         shards.transpose(0, 1)],
        [wide[..., :0, :], wide[0]],
        [wide[:, None, :11, :].expand(4, 2, 11, n)],
    ]
    for planes in cases:
        launches = modmath_cuda.LAUNCHES["galois_perm"]
        got = perm.planes(*planes)
        assert modmath_cuda.LAUNCHES["galois_perm"] == launches + 1
        assert len(got) == len(planes)
        for x, y in zip(planes, got):
            assert y.shape == x.shape and y.is_contiguous()
            assert torch.equal(y, _index_select(x, perm.table))
    assert torch.equal(perm(wide), _index_select(wide, perm.table))


def test_cuda_galois_perm_rejects_what_the_kernel_does_not_take(cuda):
    n = 1024
    table = torch.from_numpy(
        np.random.default_rng(1).permutation(n).astype(np.int32)).to(cuda)
    x = _planes(1, [q for e in build_chain([60, 60], n) for q in e.primes],
                (n,)).to(cuda)
    launches = modmath_cuda.LAUNCHES["galois_perm"]
    with pytest.raises(ValueError, match="planes"):
        modmath_cuda.galois_perm([x] * 5, table)
    with pytest.raises(ValueError, match="planes"):
        modmath_cuda.galois_perm([], table)
    with pytest.raises(ValueError, match="int32"):
        modmath_cuda.galois_perm([x.to(torch.int64)], table)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.galois_perm([x, x.cpu()], table)
    with pytest.raises(ValueError, match="stride 1"):
        modmath_cuda.galois_perm([torch.cat([x, x], -1)[..., ::2]], table)
    with pytest.raises(ValueError, match="against a table"):
        modmath_cuda.galois_perm([x[..., :n // 2]], table)
    with pytest.raises(ValueError, match="int32"):
        modmath_cuda.galois_perm([x], table.to(torch.int64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        modmath_cuda.galois_perm([x], table.cpu())
    with pytest.raises(ValueError, match=r"not \[N\]"):
        modmath_cuda.galois_perm([x], table.reshape(2, n // 2))
    with pytest.raises(ValueError, match="power of two"):
        modmath_cuda.galois_perm([x[..., :1000]], table[:1000])
    assert modmath_cuda.LAUNCHES["galois_perm"] == launches


@pytest.mark.parametrize("config,rotations,gathers", [
    ("sobel90", 8, 1), ("harris64", 32, 4)])
def test_cuda_program_permutes_once_per_rotation(cuda, config, rotations,
                                                 gathers):
    """The cells' programs (Sobel 90x90, Harris 64x64) on the card: a
    captured replay launches galois_perm once per rotation (c0 and the
    two accumulators together), and the profiler sees PyTorch's gather
    kernel only for the digit rows of each hoisted source
    (take_digit_axis); the eager execute counts the same; outputs
    bit-identical to the numpy backend."""
    import bench_torch
    from torch.profiler import ProfilerActivity, profile

    from eva_tpu_torch.backend.executor_torch import TorchProgram
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import EVAPublic, generate_keys

    build = {"sobel90": lambda: bench_torch.build_sobel(90, 90),
             "harris64": lambda: bench_torch.build_harris(64, 64)}[config]
    prog = build()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    pub, _ = generate_keys(params)
    rng = np.random.default_rng(7)
    enc = pub.encrypt({"image": rng.uniform(0, 1, prog.vec_size).tolist()},
                      sig)
    want = EVAPublic(pub.ctx, pub._keys, params,
                     backend="numpy").execute(compiled, enc)
    _same(want, pub.execute(compiled, enc))
    tp = pub._executor_for(compiled)._get_torch_program()
    (entry,) = tp._captured.values()
    assert entry.launches["modmath_launches"]["galois_perm"] == rotations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launches = modmath_cuda.LAUNCHES["galois_perm"]
        got = pub.execute(compiled, enc)
        torch.cuda.synchronize()
    assert modmath_cuda.LAUNCHES["galois_perm"] == launches + rotations
    _same(want, got)
    # The profiler may miss a few events of a replay: at most these.
    ran = [e.key for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < sum("galois_perm_kernel" in k for k in ran) <= rotations, ran
    assert sum("scatter_gather" in k for k in ran) <= gathers, ran
    TorchProgram._capture = False
    try:
        launches = modmath_cuda.LAUNCHES["galois_perm"]
        _same(want, pub.execute(compiled, enc))
        assert modmath_cuda.LAUNCHES["galois_perm"] == launches + rotations
    finally:
        TorchProgram._capture = True


def test_cuda_cryptonets_replay_counts_its_key_switches(cuda, monkeypatch):
    """CryptoNets' MNIST network (examples/cryptonets_torch.py) at its
    published widths, N=32768: its graph's capture counts 24 hoisted
    rotations (the 25 kernel offsets less (0, 0), all of the image),
    1,100 single ones (a rotate-and-sum of 10 rotations over the 1,024
    slots for each of the 110 dense outputs) and 6 relinearizations (the
    5 maps' squares and the hidden layer's); each replay adds them and
    uploads nothing: the graph holds its 752 constants, more than the
    upload cache keeps; the decrypted logits are within 1e-4 of the
    plain reference (the CKKS noise at scale 2^40 reads up to ~5e-5 at
    the widest slot)."""
    import importlib.util
    import os

    from eva_tpu_torch.backend import executor_torch as et
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    def load(name):
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    example, ref = load("cryptonets_torch"), load("cryptonets_reference")
    prog = example.build()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    assert params.poly_modulus_degree == 32768
    pub, secret = generate_keys(params)
    img = np.zeros(prog.vec_size)
    img[:784] = np.random.default_rng(11).uniform(0, 1, 784)
    enc = pub.encrypt({"image": img.tolist()}, sig)
    pub.execute(compiled, enc)
    tp = pub._executor_for(compiled)._get_torch_program()
    (entry,) = tp._captured.values()
    want = {"hoisted_rotation": 24, "single_rotation": 1100, "relin": 6}
    assert entry.launches["key_switches"] == want
    assert len(entry.consts) == 752 > tp._upload_cache_cap
    before = dict(et.KEY_SWITCHES)
    uploads = []
    to_dev = et._to_dev
    monkeypatch.setattr(et, "_to_dev", lambda arr, device: uploads.append(
        np.shape(arr)) or to_dev(arr, device))
    out = secret.decrypt(pub.execute(compiled, enc), sig)
    assert uploads == []
    assert {k: et.KEY_SWITCHES[k] - before[k] for k in before} == want
    np.testing.assert_allclose(out["logits"], ref.reference(img)["logits"],
                               rtol=0, atol=1e-4)


# -- the sharded NTT's local phases (K6, K7: csrc/ntt_shard.cu) -------------

# (N, shards D, leading shape, primes): the CPU test's rings and shard
# counts (test_torch_ntt_shard.py), Sobel's seq batch [4, 11, 16384] at
# one shard, and N = 32768 (n1 = 256).
_SHARD_CASES = ([(n, d, (2,), 3) for n in (1024, 4096, 16384)
                 for d in (1, 2, 4)]
                + [(16384, 1, (4,), 11), (16384, 2, (4,), 11),
                   (32768, 2, (1,), 13)])
_SHARD_KERNEL = {"fwd_cols": "ntt_shard_fwd", "fwd_rows": "ntt_shard_fwd",
                 "inv_rows": "ntt_shard_inv", "inv_cols": "ntt_shard_inv"}


def _shard_inputs(n, d, lead, n_sub, rank, cuda):
    """ShardPhases of rank `rank` of d on the card and a random input of
    each phase's shape."""
    from eva_tpu_torch.parallel.ntt_shard import ShardPhases
    primes = [q for e in build_chain(_SOBEL_BITS, n) for q in e.primes]
    ph = ShardPhases(primes[:n_sub], n, d, rank, cuda)
    n1, n2 = ph.n1, ph.n2
    shapes = {"fwd_cols": (n1, n2 // d), "fwd_rows": (n1 // d, n2),
              "inv_rows": (n1 // d, n2), "inv_cols": (n2 // d, n1)}
    return ph, {name: _planes(n + d + rank + i, ph.primes,
                              lead + (a * b,)).reshape(
                                  lead + (n_sub, a, b)).to(cuda)
                for i, (name, (a, b)) in enumerate(shapes.items())}


@pytest.mark.parametrize("n,d,lead,n_sub", _SHARD_CASES)
def test_cuda_ntt_shard_phases_match_plain(cuda, n, d, lead, n_sub):
    """Each phase on the first and the last rank, bit for bit against its
    plain version on the same card tensors, one launch of its kernel."""
    from eva_tpu_torch.backend import ntt_shard_cuda
    from eva_tpu_torch.parallel import ntt_shard
    for rank in sorted({0, d - 1}):
        ph, inputs = _shard_inputs(n, d, lead, n_sub, rank, cuda)
        for name, x in inputs.items():
            before = dict(ntt_shard_cuda.LAUNCHES)
            got = getattr(ph, name)(x)
            after = dict(ntt_shard_cuda.LAUNCHES)
            plain = dict(ntt_shard.PLAIN_CALLS)
            want = getattr(ph, "plain_" + name)(x)
            torch.cuda.synchronize()
            assert got.dtype == torch.int32 and got.is_contiguous()
            assert torch.equal(got, want), (name, rank)
            assert {k: after[k] - before[k] for k in after} == {
                k: int(k == _SHARD_KERNEL[name]) for k in after}
            assert ntt_shard.PLAIN_CALLS[_SHARD_KERNEL[name]] == \
                plain[_SHARD_KERNEL[name]] + 1


def test_cuda_ntt_shard_kernels_fit_the_card(cuda):
    """No form of K6/K7 spills, and an SM holds eight blocks of 256
    threads of each in registers."""
    from eva_tpu_torch.backend import ntt_shard_cuda
    info = ntt_shard_cuda.kernel_info(cuda)
    assert set(info) == set(ntt_shard_cuda.FORMS)
    for form, res in info.items():
        assert res["local_bytes"] == 0, (form, res)
        assert res["registers"] * 256 * 8 <= 65536, (form, res)


def test_cuda_ntt_shard_refuses_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor goes through K6/K7 or raises: wrong shape, type,
    layout or device, and no plain call."""
    from eva_tpu_torch.parallel import ntt_shard
    ph, inputs = _shard_inputs(1024, 2, (2,), 3, 0, cuda)
    x = inputs["fwd_cols"]
    plain = dict(ntt_shard.PLAIN_CALLS)
    with pytest.raises(ValueError, match="does not end in"):
        ph.fwd_rows(x)
    with pytest.raises(ValueError, match="int32"):
        ph.fwd_cols(x.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ph.inv_cols(inputs["fwd_cols"].transpose(-1, -2))
    cpu_ph = ntt_shard.ShardPhases(ph.primes, 1024, 2, 0)
    with pytest.raises(ValueError, match="tables on"):
        cpu_ph.fwd_cols(x)
    assert ntt_shard.PLAIN_CALLS == plain


# -- whole programs through captured CUDA graphs ------------------------------


@pytest.fixture(scope="module", params=[64, 4096], ids=["k1", "k2"])
def card_program(request):
    """A small Sobel-shaped program at N = 4096 (test_torch_capture's: one
    shard at vec_size 64, two at 4096), keys generated for the card, four
    encrypted valuations and their numpy backend outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import EVAPublic, generate_keys
    from test_torch_capture import _mini_sobel

    vec = request.param
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(_mini_sobel(vec))
    pub, _ = generate_keys(params)
    rng = np.random.default_rng(vec + 1)
    encs = [pub.encrypt({"image": rng.uniform(0, 1, vec).tolist()}, sig)
            for _ in range(4)]
    host = EVAPublic(pub.ctx, pub._keys, params, backend="numpy")
    return pub, compiled, encs, [host.execute(compiled, e) for e in encs]


def _same(want, got):
    assert set(want) == set(got)
    for k in want:
        assert len(want[k].polys) == len(got[k].polys)
        for a, b in zip(want[k].polys, got[k].polys):
            np.testing.assert_array_equal(a, b)


def test_cuda_captured_execute_equals_eager(card_program, monkeypatch):
    """One graph per key, replayed; its output bit-identical to eager
    execution and to the numpy backend; each replay adds the launches
    counted at capture, K1/K2/K4/K5 among them."""
    from eva_tpu_torch.backend.executor_torch import TorchProgram

    pub, compiled, encs, refs = card_program
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    captured = pub.execute(compiled, encs[0])
    entry = tp._captured[tp._capture_key(
        *tp._split([ex._host_phase(encs[0])[0]], False))]
    n_graphs = len(tp._captured)
    assert entry.capture_s > 0 and entry.pool_bytes > 0
    assert min(entry.launches["ntt_launches"].values()) > 0
    assert min(entry.launches["ks_launches"].values()) > 0
    before = dict(ntt_cuda.LAUNCHES)
    again = pub.execute(compiled, encs[0])
    assert {k: ntt_cuda.LAUNCHES[k] - before[k] for k in before} == \
        entry.launches["ntt_launches"]
    monkeypatch.setattr(TorchProgram, "_capture", False)
    eager = pub.execute(compiled, encs[0])
    _same(refs[0], captured)
    _same(eager, captured)
    _same(captured, again)
    assert len(tp._captured) == n_graphs


def test_cuda_replay_takes_new_inputs(card_program):
    pub, compiled, encs, refs = card_program
    for enc, ref in zip(encs, refs):
        _same(ref, pub.execute(compiled, enc))


def test_cuda_pipelined_and_batched_equal_execute(card_program):
    """execute_pipelined over 4 requests and execute_batch of 4 (its own
    graph) against 4 executes."""
    pub, compiled, encs, refs = card_program
    tp = pub._executor_for(compiled)._get_torch_program()
    seq = [pub.execute(compiled, e) for e in encs]
    piped = list(pub.execute_pipelined(compiled, iter(encs), depth=2))
    batched = pub.execute_batch(compiled, encs)
    assert len(piped) == len(batched) == 4
    for s, p, b, r in zip(seq, piped, batched, refs):
        _same(r, s)
        _same(s, p)
        _same(s, b)
    assert len(tp._captured) >= 2  # batch 1 and batch 4


def test_cuda_captured_graph_refuses_a_wrong_input_shape(card_program):
    pub, compiled, encs, _ = card_program
    ex = pub._executor_for(compiled)
    tp = ex._get_torch_program()
    pub.execute(compiled, encs[0])
    cipher, plain, consts = tp._split([ex._host_phase(encs[0])[0]], False)
    entry = tp._captured[tp._capture_key(cipher, plain, consts)]
    name, planes = next(iter(cipher.items()))
    with pytest.raises(ValueError, match="input shape"):
        entry.fill({**cipher, name: [p[..., :-1, :] for p in planes]},
                   plain)


def test_cuda_replayed_execute_shows_each_host_span_once(card_program):
    """Under torch.profiler a replayed execute shows each host step of
    the card's path once (eva_tpu_torch/tracing.py), and no capture; a
    batch size no graph was captured for shows one eva.capture."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from eva_tpu_torch.tracing import SPANS

    pub, compiled, encs, refs = card_program
    pub.execute(compiled, encs[0])

    def spans(call):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = call()
        return out, Counter(e.name for e in prof.events()
                            if e.is_user_annotation
                            and e.name.startswith("eva."))

    out, seen = spans(lambda: pub.execute(compiled, encs[1]))
    _same(refs[1], out)
    assert seen == Counter(["eva.execute", "eva.host_phase", "eva.stage",
                            "eva.launch", "eva.copy_out", "eva.wait",
                            "eva.result"])
    out, seen = spans(lambda: pub.execute_batch(compiled, encs[:3]))
    for r, o in zip(refs, out):
        _same(r, o)
    assert set(seen) <= set(SPANS)
    assert seen["eva.capture"] == 1 and seen["eva.stage"] == 1
    assert seen["eva.host_phase"] == seen["eva.result"] == 3


# -- key generation on the card -----------------------------------------------


@pytest.mark.parametrize("alpha", [1, 2])
def test_cuda_device_keygen_matches_host(cuda, alpha):
    """DeviceKeygen on the card (one K1 launch over every digit group and
    the full basis) against the host loop on the same randomness, byte
    for byte, at tests/test_crypto.py's context at N = 8192."""
    from eva_tpu_torch.backend.keygen import DeviceKeygen
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.crypto.context import CKKSContext

    ctx = CKKSContext([60, 30, 60, 60], [1, -2, 4], 8192)
    rng = np.random.default_rng(alpha)
    s = K.SecretKey(ctx, rng.integers(-1, 2, ctx.n, dtype=np.int64))
    basis = ctx.all_primes
    groups = ctx.ks_groups(alpha)
    As = [K.expand_uniform(ctx, basis, rng.bytes(32)) for _ in groups]
    Es = [np.rint(rng.normal(0.0, 3.2, ctx.n)).astype(np.int64)
          for _ in groups]
    facs = rng.integers(0, np.array(basis, dtype=np.uint64),
                        (len(groups), len(basis)), dtype=np.uint64)
    args = (s.s, (s.s * s.s) % ctx.qvec(basis), As, Es, facs)
    before = dict(ntt_cuda.LAUNCHES)
    got = K._ksk_compute(ctx, *args, DeviceKeygen(ctx, cuda))
    assert ntt_cuda.LAUNCHES["ntt_fwd"] == before["ntt_fwd"] + 1
    assert ntt_cuda.ROWS["ntt_fwd"][len(groups) * len(basis)] > 0
    for want_list, got_list in zip(K._ksk_compute(ctx, *args, None), got):
        for a, b in zip(want_list, got_list):
            assert b.dtype == np.uint64
            np.testing.assert_array_equal(a, b)


def test_cuda_generate_keys_runs_the_engine_without_fallback(cuda,
                                                             monkeypatch):
    """generate_keys on the card makes every key-switching key through
    DeviceKeygen (one K1 launch a key), and raises when the engine
    fails instead of falling back to the host loop."""
    from eva_tpu_torch.backend.keygen import DeviceKeygen
    from eva_tpu_torch.ckks.params import CKKSParameters
    from eva_tpu_torch.runtime import generate_keys

    params = CKKSParameters([60, 40, 60], [1, 2], 2048)
    before = ntt_cuda.LAUNCHES["ntt_fwd"]
    pub, _ = generate_keys(params)
    assert ntt_cuda.LAUNCHES["ntt_fwd"] - before == 1 + len(pub._keys.galois)

    def broken(self, *args):
        raise RuntimeError("engine failed")

    monkeypatch.setattr(DeviceKeygen, "_compute", broken)
    with pytest.raises(RuntimeError, match="engine failed"):
        generate_keys(params)


# -- whole programs of tools/fuzz_cuda.py --------------------------------------


def _fuzz_tool():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if os.path.join(root, "tools") not in sys.path:
        sys.path.insert(0, os.path.join(root, "tools"))
    import fuzz_cuda
    return fuzz_cuda


@pytest.mark.parametrize("ring", [8192, 16384, 32768])
def test_cuda_random_programs_match_their_references(cuda, ring):
    """Two random programs of random_case_wide at N = ring through
    generate_keys, encrypt, execute and decrypt on the card: bit-identical
    to the numpy backend and to the plain versions, MSE below 0.01."""
    fuzz_cuda = _fuzz_tool()
    records, failures = fuzz_cuda.check_all(
        fuzz_cuda.random_cases(2, 0x6A0 + ring, rings=(ring,)),
        log=lambda line: None)
    assert not failures, failures
    assert [r["N"] for r in records] == [ring, ring]


@pytest.mark.parametrize("name", ["rot_left_1", "hsum_enc", "minimum_rescaler",
                                  "security_256_false", "mixed_11"])
def test_cuda_matrix_program_matches_its_references(cuda, name):
    """A program of the reference's HE matrix (N = 4096 to 16384) on the
    card, held as the random programs are."""
    fuzz_cuda = _fuzz_tool()
    cases = [c for c in fuzz_cuda.matrix_cases() if c[0] == f"matrix {name}"]
    records, failures = fuzz_cuda.check_all(cases, log=lambda line: None)
    assert not failures and len(records) == 1, failures


# -- multi-device execution at world size 1 over NCCL ------------------------
# The machine with the card has one card: a world of one rank, NCCL.


@pytest.fixture(scope="module")
def nccl_world():
    """A one-rank NCCL world on the current card (the default process
    group), destroyed after the module's tests."""
    import torch.distributed as dist
    from eva_tpu_torch.profiling import _free_port
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (NCCL has no CPU mode)")
    device = torch.device("cuda", torch.cuda.current_device())
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0, device_id=device)
    yield device
    if own:
        dist.destroy_process_group()


def test_cuda_execute_batch_on_a_one_rank_mesh_equals_no_mesh(nccl_world):
    """execute_batch on a (batch 1, limb 1) NCCL mesh runs the captured
    single-device program on the whole batch (K1, K2, K4, K5; no plain
    version) and returns what the same call without a mesh returns."""
    from eva_tpu_torch import EvaProgram, Input, Output
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.parallel import make_device_mesh
    from eva_tpu_torch.runtime import generate_keys
    from eva_tpu_torch.backend import tables

    prog = EvaProgram("dp", vec_size=16)
    with prog:
        x = Input("x")
        Output("y", 3 * x ** 2 + (x << 1) + (x << 3) - 2)
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    pub, _ = generate_keys(params)
    rng = np.random.default_rng(7)
    encs = [pub.encrypt({"x": rng.uniform(-1, 1, 16).tolist()}, sig)
            for _ in range(3)]
    want = pub.execute_batch(compiled, encs)
    mesh = make_device_mesh(1)
    assert tuple(mesh.shape) == (1, 1)
    plain = {**tables.PLAIN_CALLS, **ks.PLAIN_CALLS}
    launches = {**ntt_cuda.LAUNCHES, **ks_cuda.LAUNCHES}
    got = pub.execute_batch(compiled, encs, mesh=mesh)
    assert {**tables.PLAIN_CALLS, **ks.PLAIN_CALLS} == plain
    after = {**ntt_cuda.LAUNCHES, **ks_cuda.LAUNCHES}
    assert all(after[k] > v for k, v in launches.items()), (launches, after)
    tp = pub._executor_for(compiled)._get_torch_program()
    assert [v[1] for v in tp._sharded_cache.values()] == ["batch"]
    for a, b in zip(want, got):
        for name in a:
            for pa, pb in zip(a[name].polys, b[name].polys):
                np.testing.assert_array_equal(pa, pb)


def test_cuda_sharded_key_switch_one_shard_equals_host(nccl_world):
    """ShardedKeySwitch on a one-rank "digit" axis (its all-reduce over
    NCCL) equals the host key switch crypto/ops._key_switch."""
    from torch.distributed.device_mesh import init_device_mesh
    from eva_tpu_torch.crypto import keys as K, ops as O
    from eva_tpu_torch.parallel import ShardedKeySwitch

    ctx = get_context((60, 20, 60, 60, 60, 60, 60), (1,), 16384)
    keys = K.generate_keys(ctx, alpha=2)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("digit",))
    for level in (0, 2):
        primes = ctx.primes_at_level(level)
        poly = _planes(level, primes, (ctx.n,)).numpy().view(
            np.uint32).astype(np.uint64)
        want = O._key_switch(ctx, poly, level, keys.relin)
        got = ShardedKeySwitch(ctx, keys.relin, level, mesh)(poly)
        for w, g in zip(want, got):
            assert g.is_cuda
            np.testing.assert_array_equal(w, g.cpu().numpy())


def test_cuda_sharded_ntt_one_shard_equals_ntt(nccl_world):
    """ShardedNTT on a one-rank group (its all-to-alls over NCCL) at
    [11, 16384] equals K1 and round-trips through its inverse."""
    import torch.distributed as dist
    from eva_tpu_torch.parallel import get_sharded_ntt

    n = 16384
    primes = [q for e in build_chain([60, 20, 60, 60, 60, 60, 60], n)
              for q in e.primes][:11]
    x = _planes(11, primes, (n,)).to(nccl_world)
    sntt = get_sharded_ntt(tuple(primes), n, dist.group.WORLD, nccl_world)
    from eva_tpu_torch.backend import ntt_shard_cuda
    before = dict(ntt_shard_cuda.LAUNCHES)
    got = sntt.ntt(x.reshape(11, sntt.n1, sntt.n2)).reshape(11, n)
    assert torch.equal(got, DeviceLevelOps(primes, n, nccl_world).ntt(x))
    back = sntt.intt(got.reshape(11, sntt.n1, sntt.n2)).reshape(11, n)
    assert torch.equal(back, x)
    # Two launches a transform: K6 twice forward, K7 twice inverse.
    assert {k: v - before[k] for k, v in ntt_shard_cuda.LAUNCHES.items()} \
        == {"ntt_shard_fwd": 2, "ntt_shard_inv": 2}
