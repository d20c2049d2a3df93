"""The host layers the port copied from eva_tpu stay copies.

Each copied source of eva_tpu_torch, read against its eva_tpu source with
"eva_tpu" replaced by "eva_tpu_torch", differs only in the lines frozen
in ALLOWED (by line number: the eva_tpu line and the port's). The rest
of runtime/ and serialization/ differ by design (the torch backend and
`device`; the port's own wire codec) and are not held here."""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED_DIRS = ("ckks", "crypto", "native", "std")
COPIED_FILES = ("ir.py", "passes.py", "traversal.py", "metric.py",
                "reference.py", "logging_util.py", "runtime/noise.py")
SOURCE_SUFFIXES = (".py", ".cpp")

ALLOWED = {
    "ir.py": {8: (
        "ciphertext math runs in JAX/Pallas (see eva_tpu_torch.crypto / "
        "eva_tpu_torch.backend).",
        "ciphertext math runs in PyTorch/CUDA (see eva_tpu_torch.crypto / "
        "eva_tpu_torch.backend).")},
    "crypto/keys.py": {266: (
        "    material, ~4x faster wall time for rotation-heavy key sets.\"\"\"",
        "    material.\"\"\"")},
    "runtime/noise.py": {92: ("    planner._jax_program = None",
                              "    planner._torch_program = None")},
}


def sources(package: str, directory: str):
    """The source files under package/directory, relative to package."""
    found = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(ROOT, package, directory)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        found += [os.path.relpath(os.path.join(dirpath, f),
                                  os.path.join(ROOT, package))
                  for f in filenames if f.endswith(SOURCE_SUFFIXES)]
    return sorted(found)


COPIES = sorted(COPIED_FILES + tuple(
    path for d in COPIED_DIRS for path in sources("eva_tpu", d)))


@pytest.mark.parametrize("directory", COPIED_DIRS)
def test_copied_directory_holds_the_same_sources(directory):
    assert sources("eva_tpu_torch", directory) == \
        sources("eva_tpu", directory)


@pytest.mark.parametrize("path", COPIES)
def test_copy_differs_only_where_allowed(path):
    with open(os.path.join(ROOT, "eva_tpu", path)) as f:
        original = f.read().replace("eva_tpu", "eva_tpu_torch").splitlines()
    with open(os.path.join(ROOT, "eva_tpu_torch", path)) as f:
        port = f.read().splitlines()
    assert len(port) == len(original), (
        f"{path}: {len(port)} lines, eva_tpu's has {len(original)}")
    differing = {i + 1: (a, b) for i, (a, b) in enumerate(zip(original, port))
                 if a != b}
    assert differing == ALLOWED.get(path, {})
