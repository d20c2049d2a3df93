"""eva_tpu_torch.profiling against the JAX package's eva_tpu.profiling.

`estimate_program` is the same model over the same plan: its per-class
counts and resource decomposition must equal the JAX package's, and
with the residue width set to the JAX package's 4 bytes and the same
calibration passed, its times too. `profile()` is timed on the card;
here it runs once at a tiny size on the CPU device, to check that every
case runs and chains."""

import pytest
import torch

import eva_tpu
import eva_tpu_torch
from eva_tpu import profiling as PJ
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu_torch import profiling as P
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT

torch.set_num_threads(1)

# A calibration passed to both packages (arbitrary, shared).
CALIB = {"ntt_row_us": 1.0, "perm_row_us": 0.5, "hbm_gbs": 1000.0,
         "hbm_eff": 0.5}


def _poly(pkg):
    prog = pkg.EvaProgram("poly", vec_size=4096)
    with prog:
        x = pkg.Input("x")
        pkg.Output("y", 3 * x ** 2 + 5 * x - 2)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    return prog


def _sobel(pkg):
    if pkg is eva_tpu_torch:
        return P.build_sobel()
    import bench
    return bench.build_sobel()


@pytest.fixture(scope="module", params=["sobel", "poly"])
def compiled(request):
    build = {"sobel": _sobel, "poly": _poly}[request.param]
    out = {}
    for pkg, compiler in ((eva_tpu_torch, CompilerT), (eva_tpu, CompilerJ)):
        out[pkg.__name__] = compiler({"warn_vec_size": "false"}).compile(
            build(pkg))[:2]
    return out


def test_port_sobel_matches_the_reference():
    """The port's Sobel program is the one bench.py builds."""
    from eva_tpu_torch import serialization as ST
    from eva_tpu import serialization as SJ
    assert ST.save_to_string(_sobel(eva_tpu_torch)) == \
        SJ.save_to_string(_sobel(eva_tpu))


def test_estimate_counts_equal(compiled):
    got, _, res = P.estimate_program(*compiled["eva_tpu_torch"],
                                     return_resources=True)
    want, _, res_j = PJ.estimate_program(*compiled["eva_tpu"],
                                         return_resources=True)
    assert {c: n for c, (n, _) in got.items()} == \
        {c: n for c, (n, _) in want.items()}
    assert got and "rescale" in got
    keys = ("ntt_rows_digit", "ntt_rows_other", "perm_rows", "ew_rows",
            "ks_sites", "ks_reduce_rows", "transforms", "n")
    assert {k: res[k] for k in keys} == {k: res_j[k] for k in keys}


def test_estimate_times_equal_at_the_same_width(compiled, monkeypatch):
    monkeypatch.setattr(P, "RESIDUE_BYTES", 4)
    got, total = P.estimate_program(*compiled["eva_tpu_torch"], **CALIB)
    want, total_j = PJ.estimate_program(*compiled["eva_tpu"], **CALIB)
    assert got == want
    assert total == total_j > 0


def test_estimate_elementwise_bytes_scale_with_residue_width(compiled,
                                                           monkeypatch):
    """At 4 bytes a residue (the port's int32 planes, as the JAX
    package's uint32) the purely elementwise classes cost what they cost
    in the JAX package; at 8 bytes twice that."""
    want, _ = PJ.estimate_program(*compiled["eva_tpu"], **CALIB)
    assert P.RESIDUE_BYTES == 4
    for width, factor in ((4, 1), (8, 2)):
        monkeypatch.setattr(P, "RESIDUE_BYTES", width)
        got, _ = P.estimate_program(*compiled["eva_tpu_torch"], **CALIB)
        for cls in ("add/sub", "mul ct-ct", "mul plain", "modswitch"):
            if cls in want:
                assert got[cls][1] == pytest.approx(factor * want[cls][1],
                                                    rel=1e-12)


def test_estimate_defaults_are_a_calibration():
    """The defaults are a full calibration: every constant positive."""
    import inspect
    params = inspect.signature(P.estimate_program).parameters
    assert all(params[k].default > 0 for k in CALIB)


def test_profile_runs_on_the_cpu_device():
    results, hbm, n_sub = P.profile(1024, 2, "cpu", batch=2,
                                    roofline_bytes=1 << 20)
    names = [r[0] for r in results]
    assert names == ["dyadic add", "dyadic mul (2x mont)", "ntt fwd",
                     "intt", "automorphism gather",
                     "rescale (divide+round)", "rotation (full KS)"]
    assert hbm > 0 and n_sub == 4
    assert all(us > 0 and achieved > 0 for _, us, achieved, _ in results)
    calib = P.calibration(results, hbm, n_sub)
    assert set(calib) == set(CALIB) and min(calib.values()) > 0


def test_card_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["profiling"], ["profiling", "estimate", "sobel"],
                 ["profiling", "mesh", "sobel", "8"]):
        monkeypatch.setattr("sys.argv", argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.measure_hbm_roofline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.measure_collective_overhead_us()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        P.measure_collective_overhead_us("cpu")


@pytest.mark.parametrize("throughput", [False, True])
def test_recommend_mesh_equals_the_jax_model(compiled, monkeypatch,
                                             throughput):
    """The same model: with the same calibration, residue width and
    link constants, the same candidate table in the same order."""
    import functools
    monkeypatch.setattr(P, "RESIDUE_BYTES", 4)
    for mod in (P, PJ):
        monkeypatch.setattr(mod, "estimate_program", functools.partial(
            mod.estimate_program, **CALIB))
    best, table = P.recommend_mesh(*compiled["eva_tpu_torch"], 8,
                                   nvlink_gbs=45.0, coll_lat_us=3.0,
                                   throughput=throughput)
    best_j, table_j = PJ.recommend_mesh(*compiled["eva_tpu"], 8,
                                        ici_gbs=45.0, coll_lat_us=3.0,
                                        throughput=throughput)
    assert best == best_j
    assert [(s, pytest.approx(t, rel=1e-12)) for s, t, _ in table] == \
        [(s, t) for s, t, _ in table_j]


def test_collective_constants_are_the_h100s():
    """Provenance: NVLink 4 of the H100 data sheet, a stated default for
    the launch latency; no TPU figure."""
    assert P.COLLECTIVE_CONSTANTS["nvlink_gbs"][:2] == (450.0, "vendor")
    assert "H100" in P.COLLECTIVE_CONSTANTS["nvlink_gbs"][2]
    assert P.COLLECTIVE_CONSTANTS["coll_lat_us"][1] == "default"
    assert not any("TPU" in why or "ICI" in why
                   for _, _, why in P.COLLECTIVE_CONSTANTS.values())


def test_estimate_main_prints_the_table(capsys):
    totals, total = P.estimate_main("poly")
    out = capsys.readouterr().out
    assert "program=poly" in out and "TOTAL" in out
    assert all(cls in out for cls in totals) and total > 0
