"""The benchmark's own decryption against the port's transforms and
decryptor (the port is imported here, in the test, as a witness only)."""

import numpy as np
import pytest

from harness import decrypt as D


def test_is_prime():
    assert D.is_prime(2 ** 31 - 1) and not D.is_prime(2 ** 31 - 3 * 7)
    assert not D.is_prime(1) and D.is_prime(2)
    with pytest.raises(ValueError):
        D.check_prime(97, 1024)  # not 1 mod 2N


def test_transform_matches_the_ports_ntt():
    from eva_tpu_torch.crypto.context import get_context
    ctx = get_context((60, 20, 60), (1,), 4096, 1)
    rng = np.random.default_rng(0)
    s = rng.integers(-1, 2, 4096)
    primes = ctx.data_primes
    mine = np.stack([D.to_eval(s, q) for q in primes])
    theirs = ctx.ntt(np.stack([(s % q).astype(np.uint64) for q in primes]),
                     primes)
    assert np.array_equal(mine, theirs)
    for i, q in enumerate(primes):
        assert np.array_equal(D.to_coeffs(mine[i], q), s % q)


def test_decryption_matches_the_ports_decryptor():
    from eva_tpu_torch import EvaProgram, Input, Output
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys
    prog = EvaProgram("p", vec_size=1024)
    with prog:
        x = Input("x")
        Output("y", x * x + (x << 3))
    prog.set_input_scales(40)
    prog.set_output_ranges(10)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    pub, sec = generate_keys(params, backend="numpy")
    vals = np.random.default_rng(1).uniform(-1, 1, 1024)
    out = pub.execute(compiled, pub.encrypt({"x": vals}, sig))
    theirs = np.asarray(sec.decrypt(out, sig)["y"])
    ct = out["y"]
    dec = D.Decryptor(sec._keys.secret.coeffs)
    mine = dec.decrypt(ct.polys, pub.ctx.primes_at_level(ct.level), ct.scale,
                       1024)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-9)
    want = vals * vals + np.roll(vals, -3)
    assert np.abs(mine - want).max() < 1e-3
