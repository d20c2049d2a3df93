"""Build, load and launch the sharded NTT's local-phase kernels
(csrc/ntt_shard.cu): K6 (the forward phases) and K7 (the inverse ones).

Same route as the other kernels (ntt_cuda, ks_cuda, modmath_cuda): nvcc
for sm_90a into a plain C library at first use (cuda_lib.build), loaded
with ctypes; each launch goes on the current CUDA stream and its
cudaError_t becomes an exception. There is no fallback: a CUDA tensor
either goes through a kernel or raises. The plain versions are the
`plain_*` methods of parallel/ntt_shard.ShardPhases, whose phase methods
dispatch by device.

  phase(name, x, ph): one local phase of ShardPhases `ph` in one launch:
    "fwd_cols"  [..., n_sub, n1, n2/D] -> the same shape (twist, n1-point
                sub-DIF down each column, correction twiddle)
    "fwd_rows"  [..., n_sub, n1/D, n2] -> the same shape (n2-point sub-DIF
                along each row)
    "inv_rows"  [..., n_sub, n1/D, n2] -> [..., n_sub, n2, n1/D] (sub-DIT
                along each row, correction twiddle, stored transposed)
    "inv_cols"  [..., n_sub, n2/D, n1] -> [..., n_sub, n1, n2/D] (sub-DIT
                along each row of n1, untwist, stored transposed)

Inputs are contiguous int32 tensors of reduced uint32 residues on the
device of `ph`'s tables; outputs are new contiguous int32 tensors. The
kernels read the tables in place and allocate nothing, so they run
inside a captured CUDA graph as they run outside it.

`LAUNCHES` counts launches by kernel ("ntt_shard_fwd": K6, both forward
phases; "ntt_shard_inv": K7); it is incremented only where a kernel is
launched."""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "ntt_shard.cu")
LIB_PATH = os.path.join(cuda_lib.BUILD_DIR, "libeva_ntt_shard.so")

LAUNCHES = {"ntt_shard_fwd": 0, "ntt_shard_inv": 0}
# The kernel forms of csrc/ntt_shard.cu, in eva_ntt_shard_info's order.
FORMS = ("fwd_cols", "fwd_rows", "inv")

_lib = None
_lock = threading.Lock()


def build(verbose: bool = False) -> str:
    """Compile csrc/ntt_shard.cu into LIB_PATH unless it is up to date;
    returns the library path (see cuda_lib.build)."""
    return cuda_lib.build(SOURCE, LIB_PATH, verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.eva_ntt_shard.argtypes = ([i] + [p] * 9
                                          + [ctypes.c_longlong, i, i, i, p])
            lib.eva_ntt_shard.restype = i
            lib.eva_ntt_shard_info.argtypes = [ctypes.POINTER(i)]
            lib.eva_ntt_shard_info.restype = i
            _lib = lib
    return _lib


def kernel_info(device: torch.device) -> dict:
    """Registers and local (spill) bytes per thread of each kernel form
    on `device`."""
    lib = _load()
    out = (ctypes.c_int * (2 * len(FORMS)))()
    with torch.cuda.device(device):
        cuda_lib.raise_on("CUDA sharded NTT info",
                          lib.eva_ntt_shard_info(out))
    return {f: {"registers": out[2 * j], "local_bytes": out[2 * j + 1]}
            for j, f in enumerate(FORMS)}


def _ptr(t):
    return None if t is None else t.data_ptr()


def phase(name: str, x: torch.Tensor, ph) -> torch.Tensor:
    """One local phase (see the module docstring) of ShardPhases `ph` on
    x, in one launch of K6 (fwd_*) or K7 (inv_*)."""
    cuda_lib.check_tensor(x, ph.device, f"CUDA sharded NTT {name}")
    n_sub, n1, n2, d = len(ph.primes), ph.n1, ph.n2, ph.n_dev
    nl, nr = n2 // d, n1 // d
    # (form, transform size, vectors a plane, input's last two dims,
    # output's, pre pair, post pair, stage pair)
    form, size, count, shape_in, shape_out, pre, post, st = {
        "fwd_cols": (0, n1, nl, (n1, nl), (n1, nl), ph.tw_fwd, ph.corr_fwd,
                     ph.st1_f),
        "fwd_rows": (1, n2, nr, (nr, n2), (nr, n2), None, None, ph.st2_f),
        "inv_rows": (2, n2, nr, (nr, n2), (n2, nr), None, ph.corr_inv,
                     ph.st2_i),
        "inv_cols": (2, n1, nl, (nl, n1), (n1, nl), None, ph.tw_inv,
                     ph.st1_i)}[name]
    if (x.dim() < 3 or x.shape[-3] != n_sub
            or tuple(x.shape[-2:]) != shape_in):
        raise ValueError(f"CUDA sharded NTT {name}: shape {tuple(x.shape)} "
                         f"does not end in [{n_sub}, {shape_in[0]}, "
                         f"{shape_in[1]}]")
    out = x.new_empty(x.shape[:-2] + shape_out)
    planes = x.numel() // (size * count)
    if planes == 0:
        return out
    lib = _load()
    pre = pre or (None, None)
    post = post or (None, None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.eva_ntt_shard(
        form, x.data_ptr(), out.data_ptr(), ph.q.data_ptr(),
        st[0].data_ptr(), st[1].data_ptr(), _ptr(pre[0]), _ptr(pre[1]),
        _ptr(post[0]), _ptr(post[1]), planes, n_sub,
        size.bit_length() - 1, count.bit_length() - 1, stream)
    cuda_lib.raise_on(f"CUDA sharded NTT {name}", err)
    LAUNCHES["ntt_shard_" + name[:3]] += 1
    return out
