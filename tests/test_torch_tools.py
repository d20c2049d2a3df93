"""The port's tools (tools/sweep_alpha_torch.py, bench_two_entry_torch.py,
reproduce_torch.py) on the CPU, against the JAX package.

The alpha sweep's digit groups and its skip of duplicate groupings equal
what eva_tpu's ks_groups gives under tools/sweep_alpha.py's rule, and an
alpha whose groups are not runs of alpha primes is refused. The rotation
the sweep and the two-entry A/B time (bench_torch.rotation_step at a
level, under each key-switch route) equals eva_tpu's host rotation
(crypto.ops.rotate) on the same keys, carried over, and inputs made from
a seed with numpy, at N=2048: alpha 1 and 2 with one key entry and alpha
4 with two, at levels 0 and 1, bit for bit (tolerance zero: exact
modular arithmetic); one plain rotation serves both routes as the
card's reference, and its check finds a changed residue. The noise
leg's check holds a small program's output to the port's numpy backend
and finds a changed residue or an extra polynomial;
reproduce_torch.py's e2e runs small. Each tool run without --cpu and
without a card exits 2 with a message, in a process that reports it
imported neither jax nor eva_tpu. tests/test_torch_tools_run.py holds
the rotation to eva_tpu's JaxProgram._rotate and runs the scaling
rehearsal as processes."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from test_torch_executor import ROOT

sys.path.insert(0, os.path.join(ROOT, "tools"))
import bench_two_entry_torch as TE  # noqa: E402
import reproduce_torch  # noqa: E402
import sweep_alpha_torch as S  # noqa: E402

torch.set_num_threads(1)

N, BATCH = 2048, 2
TOOLS = ("sweep_alpha_torch", "bench_two_entry_torch",
         "bench_scaling_torch", "reproduce_torch")
# (data entries, key entries, alpha): the sweep's one key entry at alpha
# 1 and 2, the two-entry A/B's two at alpha 4.
KEYS = {"alpha1": (2, 1, 1), "alpha2": (2, 1, 2), "two_entry": (3, 2, 4)}


def jax_skip_rule(ctx_j, alphas=S.ALPHAS):
    """tools/sweep_alpha.py:143-158 on eva_tpu's ks_groups: the group
    sizes of each alpha and the earlier alpha it duplicates."""
    seen, out = {}, []
    for alpha in alphas:
        shape = tuple(len(g) for g in ctx_j.ks_groups(alpha))
        entry = {"alpha": alpha, "group_sizes": list(shape)}
        if shape in seen:
            entry["same_groups_as_alpha"] = seen[shape]
        else:
            seen[shape] = alpha
        out.append(entry)
    return out


def test_sweep_groups_and_duplicates_equal_jax():
    # The sweep's N=8192 chain at N (the groups depend on the prime bits,
    # not on the ring; each 60-bit entry costs ~0.4 s of prime search in
    # each package, so the 6-entry chain is left to the card run).
    entries = 2
    from eva_tpu.crypto.context import get_context
    ctx_j = get_context(tuple([60] * entries + [60]), (1,), N, 1)
    got = S.sweep_entries(S.sweep_context(N, entries))
    assert [{k: e[k] for k in e if k not in ("n", "entries")}
            for e in got] == jax_skip_rule(ctx_j)
    assert [e["alpha"] for e in got if "same_groups_as_alpha" in e] == [3, 4]
    assert S.sweep_levels(entries) == sorted({0, entries // 2, entries - 1})


def test_two_entry_groups_equal_jax():
    # Three data entries under the two key entries (the A/B's five cost
    # ~4 s of prime search here): a short last group at level 0.
    from eva_tpu.crypto.context import get_context
    entries, key_terms, alpha = KEYS["two_entry"]
    ctx_j = get_context(tuple([60] * (entries + key_terms)), (1,), N,
                        key_terms)
    ctx_t = TE.two_entry_context(key_terms, N, entries)
    assert alpha == len(ctx_t.key_primes) == len(ctx_j.key_primes) == 4
    S.check_runs(ctx_t, alpha)
    assert [len(g) for g in ctx_t.ks_groups(alpha)] == [4, 2]
    for level in range(entries):
        assert ctx_t.ks_tables(level, alpha)[0] == \
            ctx_j.ks_tables(level, alpha)[0]


def test_alpha_whose_groups_are_not_runs_is_refused():
    # One 60-bit key entry: alpha 3 packs pairs (the 2P cap).
    ctx = S.sweep_context(N, 2)
    assert [len(g) for g in ctx.ks_groups(3)] == [2, 2]
    with pytest.raises(ValueError, match="not runs of 3"):
        S.check_runs(ctx, 3)
    # One 30-bit key prime: alpha 2 leaves single primes, and is not a
    # duplicate of an earlier alpha here.
    from eva_tpu_torch.crypto.context import get_context
    one_key = get_context((60, 30, 30), (1,), N)
    with pytest.raises(ValueError, match="not runs of 2"):
        S.sweep_entries(one_key, alphas=(2,))
    keys = SimpleNamespace(ks_alpha=2)
    with pytest.raises(ValueError, match="not runs of 2"):
        S.routed_step(one_key, keys, 0, "cpu", "fused")


_KEYS = {}


def carried_keys(name):
    """eva_tpu's context and keys of KEYS[name] at N, and the port's
    holding the same key material (built once per module)."""
    if name not in _KEYS:
        from eva_tpu.crypto import keys as KJ
        from eva_tpu.crypto.context import get_context
        entries, key_terms, alpha = KEYS[name]
        bits = [60] * (entries + key_terms)
        ctx_j = get_context(tuple(bits), (1,), N, key_terms)
        keys_j = KJ.generate_keys(ctx_j, alpha=alpha)
        params = SimpleNamespace(prime_bits=bits, rotations=[1],
                                 poly_modulus_degree=N, key_terms=key_terms)
        _KEYS[name] = (ctx_j, keys_j) + R.port_keys(
            R.keys_payload(params, keys_j))
    return _KEYS[name]


def numpy_rotation_sum(ctx_j, keys_j, planes, level):
    """eva_tpu's host rotation of [p, p] by 1, its two outputs added mod
    q: the step the tools time, for each ciphertext of `planes`."""
    from eva_tpu.crypto import ops as OJ
    from eva_tpu.crypto.ciphertext import Ciphertext
    q = np.array(ctx_j.primes_at_level(level), dtype=np.uint64)[:, None]
    out = []
    for p in planes.astype(np.uint64):
        r = OJ.rotate(ctx_j, keys_j, Ciphertext([p, p.copy()], level, 2.0 ** 40),
                      1)
        out.append((r.polys[0] + r.polys[1]) % q)
    return np.stack(out)


@pytest.mark.parametrize("route", S.ROUTES)
@pytest.mark.parametrize("level", (0, 1))
@pytest.mark.parametrize("name", KEYS)
def test_rotation_equals_jax_package_host_rotation(name, level, route):
    import bench_torch
    from eva_tpu_torch.backend import ks
    from eva_tpu_torch.backend.modmath import to_host
    ctx_j, keys_j, ctx_t, keys_t = carried_keys(name)
    assert keys_t.ks_alpha == KEYS[name][2]
    step, x = S.routed_step(ctx_t, keys_t, level, "cpu", route, BATCH)
    calls = dict(ks.PLAIN_CALLS)
    got = to_host(step(x))
    assert (ks.PLAIN_CALLS["ks_mac"] > calls["ks_mac"]) == (route == "fused")
    want = numpy_rotation_sum(
        ctx_j, keys_j,
        bench_torch.host_planes(ctx_j.primes_at_level(level), N, BATCH, 7),
        level)
    np.testing.assert_array_equal(got, want)


def test_rotation_us_checks_its_route_on_the_cpu():
    _, _, ctx_t, keys_t = carried_keys("alpha2")
    for route in S.ROUTES:
        med, samples = S.rotation_us(ctx_t, keys_t, 1, "cpu", route, BATCH)
        assert len(samples) == S.PASSES and med > 0
    counts = {"plain_calls": {"ntt_fwd": 0, "ntt_inv": 1},
              "ks_plain_calls": {"ks_mac": 1, "ks_epilogue": 1},
              "modmath_plain_calls": {"mac": 0}}
    S.check_route(counts, "fused", on_card=False)
    with pytest.raises(AssertionError, match="structured"):
        S.check_route(counts, "structured", on_card=False)


def test_plain_rotation_serves_both_routes_and_a_change_is_found():
    # The card's rotation at each timed point is held to plain_rotation
    # (the fused route's plain versions) on both routes: the structured
    # route's plain step gives the same residues. check_plain finds a
    # changed residue, with where it is, and a changed shape.
    _, _, ctx_t, keys_t = carried_keys("alpha1")
    want = S.plain_rotation(ctx_t, keys_t, 1, BATCH)
    step, x = S.routed_step(ctx_t, keys_t, 1, "cpu", "structured", BATCH)
    assert torch.equal(step(x), want)
    S.check_plain(want.clone(), want, "same")
    got = want.clone()
    got[1, 0, 7] ^= 1
    with pytest.raises(AssertionError, match=r"differs .* at \[1, 0, 7\]"):
        S.check_plain(got, want, "flipped")
    with pytest.raises(AssertionError, match="shape"):
        S.check_plain(want[:1], want, "short")


def small_noise_program():
    """A rotation-bearing program small enough for the CPU (N=4096)."""
    from eva_tpu_torch import EvaProgram, Input, Output
    prog = EvaProgram("small_noise", vec_size=16)
    with prog:
        x = Input("x")
        acc = (x << 1) * 0.5 + (x << 3) * -0.25
        Output("y", acc * acc)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    return prog


def test_noise_leg_holds_the_output_to_the_numpy_backend():
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys
    prog = small_noise_program()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    for alpha in (1, 2):
        res = S.run_noise(compiled, params, sig, prog, "cpu", alpha)
        assert res["alpha"] == alpha and res["equal"], res
        assert res["noise_mse"] < 1e-6
    # A changed residue is found, with where it is.
    pub, _ = generate_keys(params, device="cpu")
    enc = pub.encrypt(S.noise_inputs(prog), sig)
    out = pub.execute(compiled, enc)
    np.asarray(out["y"].polys[1])[0, 5] ^= 1
    res = S.same_as_numpy(pub, compiled, enc, out)
    assert not res["equal"] and res["first_diff"][:4] == ["y", 1, 0, 5]
    # So is an extra polynomial (a missed relinearisation).
    out["y"].polys.append(out["y"].polys[1])
    res = S.same_as_numpy(pub, compiled, enc, out)
    assert not res["equal"] and res["first_diff"] == ["y", "polys", 2, 3]


def test_centred_digits_keep_each_group_and_the_switch():
    """tools/ks_digit_bias.py's centred digits differ from the port's by a
    multiple of each group's product: the rows of the group's own primes
    are equal, the others changed; a rescale-relinearize with either form
    decrypts to the product within the noise (N=2048, two key entries,
    alpha 4), and the port's digit function is back after the block."""
    import ks_digit_bias as B
    from eva_tpu_torch.crypto import keys as K
    from eva_tpu_torch.crypto import ops
    from eva_tpu_torch.crypto.context import get_context
    ctx = get_context((60,) * 5, (), N, 2)
    keys = K.generate_keys(ctx, alpha=4)
    rng = np.random.default_rng(5)
    primes = ctx.primes_at_level(0)
    coeffs = np.stack([rng.integers(0, q, N, dtype=np.uint64)
                       for q in primes])
    port_fn = ops._ks_digits_from_coeffs
    port = port_fn(ctx, coeffs, 0, 4)
    with B.centred_digits():
        centred = ops._ks_digits_from_coeffs(ctx, coeffs, 0, 4)
    assert ops._ks_digits_from_coeffs is port_fn
    groups, _, _ = ctx.ks_tables(0, 4)
    assert max(map(len, groups)) > 1
    for group, p, c in zip(groups, port, centred):
        np.testing.assert_array_equal(p[group], c[group])
        assert not np.array_equal(p, c)
    values = rng.uniform(-1, 1, N // 2)
    for form in (B.contextlib.nullcontext, B.centred_digits):
        with form():
            err = B.switch_error(ctx, keys, 0, values, 2.0 ** 50)
        assert all(np.isfinite(v) for v in err.values()), err
        assert abs(err["slot0"]) < 1e-6 and err["other_slots_std"] < 1e-6


def test_reproduce_e2e_on_the_cpu():
    res = reproduce_torch.e2e("cpu", vec_size=256, reps=2)
    assert res["mse"] < 0.01 and res["first_execute_s"] > 0
    assert res["steady_ms_per_eval"] > 0 and res["launches"]["plain_calls"]


@pytest.fixture(scope="module")
def refusals():
    """Each tool's main() without a card and without --cpu, in one
    process that imports the four tools and reports what it imported."""
    code = (
        "import contextlib, io, json, sys\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'tools')!r}]\n"
        "out = {}\n"
        f"for name in {TOOLS!r}:\n"
        "    mod = __import__(name)\n"
        "    err = io.StringIO()\n"
        "    with contextlib.redirect_stderr(err):\n"
        "        rc = mod.main([] if name != 'bench_scaling_torch'\n"
        "                      else ['--hosts', '1'])\n"
        "    out[name] = [rc, err.getvalue()]\n"
        "out['modules'] = sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'eva_tpu'))\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_refuses_without_a_card_and_imports_no_jax(refusals, tool):
    rc, err = refusals[tool]
    assert rc == 2 and "--cpu" in err and "cuda" in err.lower()
    assert refusals["modules"] == []
