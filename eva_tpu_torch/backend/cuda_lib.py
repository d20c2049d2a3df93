"""Build and load the port's CUDA kernel libraries (csrc/*.cu).

Each source file is compiled with nvcc for sm_90a into its own shared
library with a plain C interface, at first use, into
`build/eva_tpu_torch/` beside the package, and loaded with ctypes. A
library is rebuilt when it is older than its source or any shared
header (csrc/*.cuh). Builds of different sources are independent, so a
caller may run them in parallel (`build_all`, which chip_smoke.py
calls)."""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "eva_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

MIN_LOGN, MAX_LOGN = 10, 15  # N = 1024 .. 32768 (ckks/params.py)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME)")
    return found


def build(source: str, lib_path: str, verbose: bool = False) -> str:
    """Compile `source` into `lib_path` unless it is up to date; returns
    the library path. With verbose, nvcc prints per-kernel resource use
    (-Xptxas -v)."""
    deps = [source] + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (os.path.exists(lib_path) and not verbose
            and os.path.getmtime(lib_path)
            >= max(os.path.getmtime(d) for d in deps)):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, source]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                           f"{os.path.basename(source)}:\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib_path)
    return lib_path


def build_all(verbose: bool = False) -> list:
    """Build every kernel library of the port (ntt.cu, ks.cu, modmath.cu,
    ntt_shard.cu), one nvcc per source, all started together; returns the
    sources."""
    from concurrent.futures import ThreadPoolExecutor

    from . import ks_cuda, modmath_cuda, ntt_cuda, ntt_shard_cuda
    libs = (ntt_cuda, ks_cuda, modmath_cuda, ntt_shard_cuda)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(verbose), libs))
    return [lib.SOURCE for lib in libs]


def check_ring(n: int, name: str) -> None:
    """Raise unless N is a power of two the kernels take."""
    if n & (n - 1) or not (1 << MIN_LOGN) <= n <= (1 << MAX_LOGN):
        raise ValueError(f"{name}: N={n} not a power of two in "
                         f"[{1 << MIN_LOGN}, {1 << MAX_LOGN}]")


def check_tensor(x: torch.Tensor, device: torch.device, name: str,
                 dtype: torch.dtype = torch.int32) -> None:
    """Raise unless x is a contiguous tensor of `dtype` on the CUDA
    `device`: int32 for residues (their uint32 bit patterns), int64 for
    index tables."""
    if not x.is_cuda:
        raise ValueError(f"{name}: tensor is not on a CUDA device")
    if x.dtype != dtype:
        what = "int32 residues" if dtype == torch.int32 else f"{dtype}"
        raise ValueError(f"{name}: expected {what}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if x.device != device:
        raise ValueError(f"{name}: tensor on {x.device}, tables on {device}")


def raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: failed with cudaError_t {err}")
