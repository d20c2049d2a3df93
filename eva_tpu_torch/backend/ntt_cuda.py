"""Build, load and launch the CUDA NTT kernels (csrc/ntt.cu).

The kernels are compiled with nvcc for sm_90a into a shared library with
a plain C interface, at first use, into `build/eva_tpu_torch/` beside the
package (cuda_lib.build); they are loaded with ctypes. Each launch goes
on the current CUDA stream, and the C entry point returns the launch's
cudaError_t,
which the wrapper turns into an exception. There is no fallback: a CUDA
tensor either goes through the kernel or raises.

`LAUNCHES` counts kernel launches by name; it is incremented only where
a kernel is launched."""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "ntt.cu")
LIB_PATH = os.path.join(cuda_lib.BUILD_DIR, "libeva_ntt.so")

LAUNCHES = {"ntt_fwd": 0, "ntt_inv": 0}

_lib = None
_ready_devices = set()  # devices whose kernels got the shared-memory opt-in
_lock = threading.Lock()


def build(verbose: bool = False) -> str:
    """Compile csrc/ntt.cu into LIB_PATH unless it is up to date; returns
    the library path (see cuda_lib.build)."""
    return cuda_lib.build(SOURCE, LIB_PATH, verbose)


def _load(device: torch.device):
    """The kernel library, built and loaded once, with the kernels
    opted in to 128 KB of dynamic shared memory on `device`."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.eva_ntt_init.argtypes = []
            lib.eva_ntt_init.restype = i
            lib.eva_ntt_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.eva_ntt_fwd.restype = i
            lib.eva_ntt_inv.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
            lib.eva_ntt_inv.restype = i
            _lib = lib
        if device.index not in _ready_devices:
            with torch.cuda.device(device):
                _raise("init", _lib.eva_ntt_init())
            _ready_devices.add(device.index)
    return _lib


def _check(x: torch.Tensor, ops) -> int:
    """Validate a launch's input; returns the row count."""
    cuda_lib.check_tensor(x, ops.device, "CUDA NTT")
    n = ops.n
    cuda_lib.check_ring(n, "CUDA NTT")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != len(ops.primes):
        raise ValueError(f"CUDA NTT: shape {tuple(x.shape)} does not end in "
                         f"[{len(ops.primes)}, {n}]")
    return x.numel() // n


def _raise(name: str, err: int) -> None:
    cuda_lib.raise_on(f"CUDA NTT {name}", err)


def ntt_fwd(x: torch.Tensor, ops) -> torch.Tensor:
    """Forward negacyclic NTT of reduced [..., n_sub, N] int64 planes
    (natural in, bit-reversed out) with the tables of `ops`
    (a DeviceLevelOps)."""
    rows = _check(x, ops)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib, tab = _load(x.device), ops.kernel_tables()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.eva_ntt_fwd(x.data_ptr(), out.data_ptr(), tab["wf"].data_ptr(),
                          tab["wpf"].data_ptr(), tab["q"].data_ptr(), rows,
                          len(ops.primes), ops.logn, stream)
    _raise("forward", err)
    LAUNCHES["ntt_fwd"] += 1
    return out


def ntt_inv(x: torch.Tensor, ops) -> torch.Tensor:
    """Inverse negacyclic NTT (bit-reversed in, natural out, N^-1
    folded) of [..., n_sub, N] int64 planes."""
    rows = _check(x, ops)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib, tab = _load(x.device), ops.kernel_tables()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.eva_ntt_inv(x.data_ptr(), out.data_ptr(), tab["wi"].data_ptr(),
                          tab["wpi"].data_ptr(), tab["q"].data_ptr(),
                          tab["ninv"].data_ptr(), tab["ninvp"].data_ptr(),
                          rows, len(ops.primes), ops.logn, stream)
    _raise("inverse", err)
    LAUNCHES["ntt_inv"] += 1
    return out
