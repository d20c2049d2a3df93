"""eva_tpu_torch.serialization against the JAX package's wire format.

The port's serialization is a copy of eva_tpu's with package-relative
protoc imports. Both packages register the same descriptors in
protobuf's default pool, so bytes saved by either load in the other:
the frozen fixtures (tests/fixtures/, made by eva_tpu) load in the port
and the port saves the same payload; the public context, secret context
and an encrypted valuation saved by either package load in both, and
both re-save them to the same bytes: the original's, up to the order of
the public context's map of Galois keys (a parse and re-save reorders
it in the JAX package too)."""

import os
import subprocess
import sys

import pytest
import torch

import eva_tpu
import eva_tpu_torch
from eva_tpu import serialization as SJ
from eva_tpu.ckks import CKKSCompiler as CompilerJ
from eva_tpu.runtime import generate_keys as keygen_j
from eva_tpu_torch import serialization as ST
from eva_tpu_torch.ckks import CKKSCompiler as CompilerT
from eva_tpu_torch.metric import valuation_mse
from eva_tpu_torch.runtime import generate_keys as keygen_t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")


def readme_poly(pkg):
    """tools/make_golden_fixtures.py's readme_poly, built with `pkg`."""
    poly = pkg.EvaProgram("Polynomial", vec_size=1024)
    with poly:
        x = pkg.Input("x")
        pkg.Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)
    return poly


def rotating(pkg):
    """tools/make_golden_fixtures.py's rotating, built with `pkg`."""
    prog = pkg.EvaProgram("Rotating", vec_size=1024)
    with prog:
        x = pkg.Input("x")
        y = (x << 1) + (x << 2) * 3 + x ** 2
        pkg.Output("y", y + (y << 4))
    prog.set_output_ranges(20)
    prog.set_input_scales(30)
    return prog


def _payload(blob: bytes):
    """(type_url, value) of the envelope, creator tag excluded (as
    tests/test_serialization.py compares the fixtures)."""
    env = ST.known_type_pb2.KnownType()
    env.ParseFromString(blob)
    return env.contents.type_url, env.contents.value


def _compile(compiler, prog):
    return compiler({"warn_vec_size": "false"}).compile(prog)


@pytest.mark.parametrize("build", [readme_poly, rotating])
def test_frozen_fixtures_load_and_match(build):
    prog = build(eva_tpu_torch)
    compiled, params, sig = _compile(CompilerT, prog)
    stem = prog.name.lower()
    path = lambda ext: os.path.join(FIXDIR, f"{stem}.{ext}")
    loaded_prog = eva_tpu_torch.load(path("eva"))
    assert isinstance(loaded_prog, eva_tpu_torch.Program)
    inputs = {"x": [i * 0.001 for i in range(prog.vec_size)]}
    assert valuation_mse(eva_tpu_torch.evaluate(loaded_prog, inputs),
                         eva_tpu_torch.evaluate(compiled, inputs)) < 1e-20
    assert eva_tpu_torch.load(path("evaparams")) == params
    loaded_sig = eva_tpu_torch.load(path("evasignature"))
    assert loaded_sig.vec_size == sig.vec_size
    for name, info in sig.inputs.items():
        assert loaded_sig.inputs[name].scale == info.scale
        assert loaded_sig.inputs[name].level == info.level
    for obj, ext in ((compiled, "eva"), (params, "evaparams"),
                     (sig, "evasignature")):
        with open(path(ext), "rb") as f:
            frozen = f.read()
        assert _payload(ST.save_to_string(obj)) == _payload(frozen), ext


@pytest.fixture(scope="module")
def protocol():
    """One program compiled by both packages, a key set and an encrypted
    valuation made by each, all saved to bytes."""
    prog_j, prog_t = rotating(eva_tpu), rotating(eva_tpu_torch)
    compiled_j, params_j, sig_j = _compile(CompilerJ, prog_j)
    compiled_t, params_t, sig_t = _compile(CompilerT, prog_t)
    assert SJ.save_to_string(params_j) == ST.save_to_string(params_t)
    inputs = {"x": [0.01 * i for i in range(prog_t.vec_size)]}
    pub_j, sec_j = keygen_j(params_j)
    pub_t, sec_t = keygen_t(params_t, device="cpu")
    return {
        "jax": {"pub": SJ.save_to_string(pub_j),
                "sec": SJ.save_to_string(sec_j),
                "enc": SJ.save_to_string(pub_j.encrypt(inputs, sig_j))},
        "torch": {"pub": ST.save_to_string(pub_t),
                  "sec": ST.save_to_string(sec_t),
                  "enc": ST.save_to_string(pub_t.encrypt(inputs, sig_t))},
        "program": (compiled_t, sig_t, prog_t, inputs)}


def _resave_j(blob):
    return SJ.save_to_string(SJ.load_from_string(blob))


def _resave_t(blob):
    return ST.save_to_string(ST.load_from_string(blob, device="cpu"))


def _canonical(blob):
    """(type_url, contents serialized with map entries in key order).
    A parse and re-save of a public context may reorder its map of
    Galois keys (in the JAX package too): the canonical form is what
    every save of the same object shares."""
    env = ST.known_type_pb2.KnownType()
    env.ParseFromString(blob)
    for msg_type, _ in ST._DESERIALIZERS:
        if env.contents.Is(msg_type.DESCRIPTOR):
            msg = msg_type()
            env.contents.Unpack(msg)
            return (env.contents.type_url,
                    msg.SerializeToString(deterministic=True))
    raise AssertionError(env.contents.type_url)


@pytest.mark.parametrize("made_by", ["jax", "torch"])
@pytest.mark.parametrize("what", ["pub", "sec", "enc"])
def test_bytes_load_in_both_and_resave_identical(protocol, made_by, what):
    """Bytes saved by either package load in both; both re-save the
    same bytes, which equal the original up to map order."""
    blob = protocol[made_by][what]
    port, jax_ = _resave_t(blob), _resave_j(blob)
    assert port == jax_
    assert _canonical(port) == _canonical(blob)
    if what != "pub":  # no map of Galois keys: the bytes themselves
        assert port == blob


def test_loaded_jax_contexts_run_in_port(protocol):
    """The JAX package's public context, secret context and ciphertexts,
    loaded by the port, execute and decrypt there."""
    from eva_tpu_torch.runtime import EVAPublic, EVASecret, EVAValuation
    compiled, sig, prog, inputs = protocol["program"]
    pub = ST.load_from_string(protocol["jax"]["pub"], device="cpu")
    sec = ST.load_from_string(protocol["jax"]["sec"])
    enc = ST.load_from_string(protocol["jax"]["enc"])
    assert isinstance(pub, EVAPublic) and pub.device.type == "cpu"
    assert isinstance(sec, EVASecret) and isinstance(enc, EVAValuation)
    out = sec.decrypt(pub.execute(compiled, enc), sig)
    assert valuation_mse(out, eva_tpu_torch.evaluate(prog, inputs)) < 1e-6


def test_public_load_needs_a_device(protocol, monkeypatch):
    """A public context loads onto the CUDA device by default, and
    raises without one, as generate_keys does; backend="numpy" loads on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ST.load_from_string(protocol["jax"]["pub"])
    pub = ST.load_from_string(protocol["jax"]["pub"], backend="numpy")
    assert pub.backend == "numpy" and pub.device is None


def test_save_load_files(protocol, tmp_path):
    """eva_tpu_torch.save / load at the package root, as eva_tpu's: the
    files load in both packages."""
    compiled, sig, prog, inputs = protocol["program"]
    eva_tpu_torch.save(compiled, str(tmp_path / "p.eva"))
    eva_tpu_torch.save(sig, str(tmp_path / "p.evasignature"))
    for pkg in (eva_tpu_torch, eva_tpu):
        loaded = pkg.load(str(tmp_path / "p.eva"))
        assert valuation_mse(pkg.evaluate(loaded, inputs),
                             eva_tpu_torch.evaluate(compiled, inputs)) < 1e-20
        loaded_sig = pkg.load(str(tmp_path / "p.evasignature"))
        assert loaded_sig.vec_size == sig.vec_size
        assert {k: (v.scale, v.level) for k, v in loaded_sig.inputs.items()} \
            == {k: (v.scale, v.level) for k, v in sig.inputs.items()}
    with open(tmp_path / "p.evasignature", "rb") as f:
        assert f.read() == ST.save_to_string(sig)


def test_generated_modules_are_the_ports_own():
    """evatpu_pb2 imports the port's ckks_pb2 package-relatively, even
    in a process that imported the JAX package first."""
    assert ST.evatpu_pb2.ckks__pb2 is ST.ckks_pb2
    assert ST.ckks_pb2.__name__ == "eva_tpu_torch.serialization.ckks_pb2"
    assert SJ.evatpu_pb2.ckks__pb2 is not ST.ckks_pb2
    assert ST.ckks_pb2.DESCRIPTOR is SJ.ckks_pb2.DESCRIPTOR


def test_port_serialization_alone():
    """Imported alone, the port's serialization leaves sys.path as it was
    and imports no top-level *_pb2 module, no JAX and no eva_tpu."""
    code = ("import sys; before = list(sys.path); "
            "import eva_tpu_torch.serialization as S; "
            "bad = [m for m in sys.modules if m.endswith('_pb2') and "
            "'.' not in m or m == 'jax' or m.startswith('jax.') or "
            "m == 'eva_tpu' or m.startswith('eva_tpu.')]; "
            "bad += ['sys.path'] if sys.path != before else []; "
            "print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
