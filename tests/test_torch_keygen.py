"""eva_tpu_torch.backend.keygen.DeviceKeygen against the JAX package.

The same pre-sampled randomness (As, Es, facs) goes through the port's
engine on the CPU device (the plain PyTorch NTT), the JAX package's
DeviceKeygen on CPU XLA and the host loop `_ksk_compute(engine=None)`
of both packages: the key material must be byte-identical (exact
modular arithmetic: no tolerance). Then engine-made keys run a full
round trip, and `generate_keys(device="cpu")` is held to host keygen."""

import secrets

import numpy as np
import pytest
import torch

from eva_tpu.backend.keygen import DeviceKeygen as DeviceKeygenJ
from eva_tpu.crypto import keys as KJ
from eva_tpu.crypto.context import CKKSContext as ContextJ
from eva_tpu_torch.backend.keygen import DeviceKeygen
from eva_tpu_torch.backend.modmath import upload
from eva_tpu_torch.crypto import keys as K
from eva_tpu_torch.crypto.context import CKKSContext

torch.set_num_threads(1)

# tests/test_crypto.py's context at N = 8192: 4 data sub-primes (one 30-bit
# entry), 2 key sub-primes.
BITS, ROTATIONS, N = [60, 30, 60, 60], [1, -2, 4], 8192


@pytest.fixture(scope="module")
def contexts():
    return CKKSContext(BITS, ROTATIONS, N), ContextJ(BITS, ROTATIONS, N)


def _randomness(ctx, alpha, seed):
    """(s_rows, target, As, Es, facs) drawn as _make_kswitch_key draws
    them: the s^2 target of a relinearization key, one uniform a, one
    error and one factor row per digit group."""
    rng = np.random.default_rng(seed)
    s = K.SecretKey(ctx, rng.integers(-1, 2, ctx.n, dtype=np.int64))
    basis = ctx.all_primes
    target = (s.s * s.s) % ctx.qvec(basis)
    groups = ctx.ks_groups(alpha)
    As = [K.expand_uniform(ctx, basis, secrets.token_bytes(32))
          for _ in groups]
    Es = [np.rint(rng.normal(0.0, 3.2, ctx.n)).astype(np.int64)
          for _ in groups]
    facs = rng.integers(0, np.array(basis, dtype=np.uint64),
                        (len(groups), len(basis)), dtype=np.uint64)
    return s.s, target, As, Es, facs


@pytest.mark.parametrize("alpha", [1, 2])
def test_ksk_compute_byte_identical(contexts, alpha):
    """Port engine == JAX engine == host loop of both packages."""
    ctx, ctx_j = contexts
    assert ctx.all_primes == ctx_j.all_primes
    s_rows, target, As, Es, facs = _randomness(ctx, alpha, 77 + alpha)
    assert min(e.min() for e in Es) < 0  # the lift of negative errors runs
    host = K._ksk_compute(ctx, s_rows, target, As, Es, facs, None)
    host_j = KJ._ksk_compute(ctx_j, s_rows, target, As, Es, facs, None)
    port = K._ksk_compute(ctx, s_rows, target, As, Es, facs,
                          DeviceKeygen(ctx, device="cpu"))
    jax_ = KJ._ksk_compute(ctx_j, s_rows, target, As, Es, facs,
                           DeviceKeygenJ(ctx_j))
    for got in (host_j, port, jax_):
        for want_list, got_list in zip(host, got):
            assert len(got_list) == len(want_list) == len(As)
            for a, b in zip(want_list, got_list):
                assert b.dtype == np.uint64 and b.shape == (len(
                    ctx.all_primes), N)
                np.testing.assert_array_equal(a, b)


def test_engine_broadcast_shapes(contexts):
    """fac [G, n_all, 1] against target [n_all, N], and E [G, 1, N] lifted
    over the n_all rows: the engine's planes are [G, n_all, N]."""
    ctx, _ = contexts
    s_rows, target, As, Es, facs = _randomness(ctx, 2, 5)
    eng = DeviceKeygen(ctx, device="cpu")
    up = lambda a: upload(a, "cpu")
    E = np.stack(Es)[:, None, :]
    e_pos, e_neg = up(np.maximum(E, 0)), up(np.maximum(-E, 0))
    lifted = eng.dev.sub(e_pos, e_neg)
    assert lifted.shape == (len(As), len(ctx.all_primes), N)
    q = np.array(ctx.all_primes, dtype=np.int64)[:, None]
    np.testing.assert_array_equal(lifted.numpy(), E % q)
    b = eng._compute(up(np.stack(As)), e_pos, e_neg, up(facs)[:, :, None],
                     up(target), up(s_rows))
    assert b.shape == (len(As), len(ctx.all_primes), N)
    assert b.dtype == torch.int32


def test_engine_keys_round_trip(monkeypatch):
    """Keys made through the port's engine decrypt a full HE round trip
    (relinearization and a rotation), executed by the port."""
    from eva_tpu_torch import EvaProgram, Input, Output, evaluate
    from eva_tpu_torch import runtime
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.metric import valuation_mse

    prog = EvaProgram("kg", vec_size=8)
    with prog:
        x = Input("x")
        Output("y", x * x + (x << 1))
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    made = []
    real = K.generate_keys

    def with_engine(ctx, alpha=None, engine=None):
        assert engine is None  # generate_keys(device="cpu") passes none
        engine = DeviceKeygen(ctx, device="cpu")
        made.append(engine)
        return real(ctx, alpha, engine)

    monkeypatch.setattr(runtime._keys, "generate_keys", with_engine)
    pub, sec = runtime.generate_keys(params, device="cpu")
    assert made and pub._keys.relin is not None and pub._keys.galois
    inputs = {"x": [0.1 * i for i in range(8)]}
    enc = pub.encrypt(inputs, sig)
    out = sec.decrypt(pub.execute(compiled, enc), sig)
    assert valuation_mse(out, evaluate(prog, inputs)) < 0.01


@pytest.mark.parametrize("backend,device", [("torch", "cpu"),
                                            ("numpy", None)])
def test_generate_keys_cpu_passes_no_engine(monkeypatch, backend, device):
    """On the CPU device and on the numpy backend keygen is host numpy:
    the host generate_keys gets engine=None."""
    from eva_tpu_torch import runtime
    from eva_tpu_torch.ckks.params import CKKSParameters

    seen = []

    def spy(ctx, alpha=None, engine=None):
        seen.append(engine)
        return real(ctx, alpha, engine)

    real = K.generate_keys
    monkeypatch.setattr(runtime._keys, "generate_keys", spy)
    runtime.generate_keys(CKKSParameters([60, 40, 60], [1], 2048),
                          backend=backend, device=device)
    assert seen == [None]


def test_engine_requires_a_device(contexts, monkeypatch):
    """device=None means the CUDA device: without one the engine raises
    instead of running anywhere else."""
    ctx, _ = contexts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceKeygen(ctx)
