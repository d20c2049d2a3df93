"""chip_smoke.py's protocol phase on the CPU: its three roles with the
plain PyTorch versions (device "cpu"), Sobel 90x90 at N=16384 through
files saved by the port's wire codec, against the JAX package.

The server's output, loaded by the client, is bit-identical to an
execute of the same ciphertexts with the original public context, and
to eva_tpu's numpy backend on the files the roles wrote (eva_tpu loads
them); protocol_check refuses an output with one residue changed; the
server role alone (`chip_smoke.py --serve`) exits non-zero without a
card. No protobuf is imported by the roles: that is checked in
test_torch_serialization.py's blocked run and on the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as C
import eva_tpu
from eva_tpu_torch import load, save

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def roles(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("protocol"))
    objects, save_s, load_s = C.protocol_client(tmp, device="cpu")
    server = C.protocol_server(tmp, device="cpu", reps=1)
    return tmp, objects, server, save_s, load_s


def _path(tmp, what):
    return os.path.join(tmp, C.PROTOCOL_FILES[what])


def test_protocol_roles_on_the_cpu(roles):
    tmp, objects, server, save_s, load_s = roles
    line = C.protocol_check(tmp, objects, server, dict(save_s),
                            dict(load_s))
    assert line["bit_identical"] and line["mse"] < C.MSE_LIMIT["sobel"]
    for key in ("mb", "save_s", "load_s"):
        assert set(line[key]) == set(C.PROTOCOL_FILES), key
    assert server["device"] == "cpu" and server["cuda_start_s"] is None
    assert line["launches_per_execute"]["plain_calls"] > 0


def test_server_output_matches_eva_tpu(roles):
    """eva_tpu loads the files the roles wrote; its numpy backend's
    execute of the loaded program and inputs equals the server's
    output, residue for residue."""
    tmp = roles[0]
    pub = eva_tpu.load(_path(tmp, "public"))
    want = pub.execute(eva_tpu.load(_path(tmp, "program")),
                       eva_tpu.load(_path(tmp, "inputs")))
    got = load(_path(tmp, "outputs"))
    assert set(got) == set(want)
    for k in want:
        assert (got[k].level, got[k].scale) == (want[k].level,
                                                want[k].scale)
        assert len(got[k].polys) == len(want[k].polys)
        for a, b in zip(got[k].polys, want[k].polys):
            assert np.array_equal(a, b)


def test_check_refuses_a_changed_output(roles, tmp_path):
    tmp, objects, server, save_s, load_s = roles
    for what in C.PROTOCOL_FILES:  # a copy of the files, one output changed
        with open(_path(tmp, what), "rb") as src, \
                open(_path(str(tmp_path), what), "wb") as dst:
            dst.write(src.read())
    out = load(_path(str(tmp_path), "outputs"))
    k = next(iter(out))
    out[k].polys[0][0, 0] ^= 1
    save(out, _path(str(tmp_path), "outputs"))
    with pytest.raises(AssertionError, match="differs"):
        C.protocol_check(str(tmp_path), objects, server, dict(save_s),
                         dict(load_s))


def test_serve_needs_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--serve",
         str(tmp_path)], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "serve " not in proc.stdout
