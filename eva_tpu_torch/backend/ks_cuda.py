"""Build, load and launch the fused key-switch kernels (csrc/ks.cu).

Same route as the NTT kernels (ntt_cuda): nvcc for sm_90a into a plain C
library at first use (cuda_lib.build), loaded with ctypes; each launch
goes on the current CUDA stream and its cudaError_t becomes an
exception. There is no fallback: CUDA tensors either go through the
kernels or raise. The plain PyTorch versions are ks.ks_mac_plain and
ks.ks_epilogue_plain.

`LAUNCHES` counts wrapper calls that launched: "ks_mac" one kernel (a
grid of thread-block clusters), "ks_epilogue" its two (the key-row
inverse NTTs, and the row pass launched as their programmatic
dependent; both grids of thread-block clusters, one a row).
`EPILOGUE_CLUSTER` counts the epilogue calls by the cluster size C they
launched with (ks.cu's epilogue_cluster: from the ring size and the rows
by waves, 1 at N = 1024, 8 at batch 1 from N = 8192 up).
`MAX_BATCH` keeps the largest batch each wrapper launched with."""

from __future__ import annotations

import ctypes
import os
import threading
from collections import Counter

import numpy as np
import torch

from . import cuda_lib
from .ks import MAX_KEY_PRIMES

SOURCE = os.path.join(cuda_lib.CSRC, "ks.cu")
LIB_PATH = os.path.join(cuda_lib.BUILD_DIR, "libeva_ks.so")

LAUNCHES = {"ks_mac": 0, "ks_epilogue": 0}
MAX_BATCH = {"ks_mac": 0, "ks_epilogue": 0}
EPILOGUE_CLUSTER = Counter()

_lib = None
_ready_devices = set()  # devices whose kernels got the shared-memory opt-in
_lock = threading.Lock()


def build(verbose: bool = False) -> str:
    """Compile csrc/ks.cu into LIB_PATH unless it is up to date; returns
    the library path (see cuda_lib.build)."""
    return cuda_lib.build(SOURCE, LIB_PATH, verbose)


def _load(device: torch.device):
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.eva_ks_init.argtypes = []
            lib.eva_ks_init.restype = i
            lib.eva_ks_mac.argtypes = [p] * 12 + [i] * 6 + [p]
            lib.eva_ks_mac.restype = i
            lib.eva_ks_epilogue.argtypes = ([p] * 13 + [i] * 5
                                            + [ctypes.POINTER(i), p])
            lib.eva_ks_epilogue.restype = i
            lib.eva_ks_info.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.eva_ks_info.restype = i
            lib.eva_ks_mac_cluster.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.eva_ks_mac_cluster.restype = i
            _lib = lib
        if device.index not in _ready_devices:
            with torch.cuda.device(device):
                cuda_lib.raise_on("CUDA key switch init", _lib.eva_ks_init())
            _ready_devices.add(device.index)
    return _lib


def kernel_info(logn: int, device: torch.device, n_key: int = 2,
                n_ext: int = 13) -> dict:
    """Resource use of the kernels at a ring of 2^logn on `device`:
    registers and local (spill) bytes per thread of each kernel (the row
    kernel for `n_key` key primes); threads per MAC block and how many
    clusters of c MAC blocks the device holds at once (c = 1 .. 8); for
    each epilogue kernel, the cluster size an epilogue over an extended
    basis of `n_ext` rows (13: Sobel's level 0) takes at batch 1 and its
    threads per block; how many clusters of C row-kernel blocks the device
    holds at once (C = 1, 2, 4, 8; 0 where the ring does not split into C
    segments of >= 1024 words)."""
    lib = _load(device)
    out = (ctypes.c_int * 21)()
    with torch.cuda.device(device):
        cuda_lib.raise_on("CUDA key switch info",
                          lib.eva_ks_info(logn, n_key, n_ext, out))
    names = ("ks_mac_cluster_kernel", "ks_epilogue_key_kernel",
             "ks_epilogue_row_kernel")
    info = {"threads": out[6],
            **{k: {"registers": out[2 * j], "local_bytes": out[2 * j + 1]}
               for j, k in enumerate(names)},
            "mac_max_active_clusters": {c: out[6 + c] for c in range(1, 9)},
            "epilogue_max_active_clusters": {1 << c: out[17 + c]
                                             for c in range(4)}}
    for k in names[1:]:
        info[k].update(cluster=out[15], threads=out[16])
    return info


def mac_cluster(logn: int, n_groups: int, clusters: int,
                device: torch.device) -> int:
    """The cluster size a MAC launch takes at a ring of 2^logn on
    `device`: `clusters` (n_ext x batch) clusters over n_groups digit
    groups (ks.cu's mac_cluster_size)."""
    lib = _load(device)
    c = ctypes.c_int(0)
    with torch.cuda.device(device):
        cuda_lib.raise_on("CUDA key switch cluster size",
                          lib.eva_ks_mac_cluster(logn, n_groups, clusters,
                                                 ctypes.byref(c)))
    return c.value


def _shape(x: torch.Tensor, want, name: str) -> None:
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(want)}")


def ks_mac(y, k0, k1, conv, owner, ext_ops, x_ntt=None):
    """The MAC kernel (see ks.ks_mac_plain for the arguments): acc0, acc1
    [B, n_ext, N] int32."""
    name = "CUDA ks_mac"
    n = ext_ops.n
    n_ext = len(ext_ops.primes)
    cuda_lib.check_ring(n, name)
    args = [y, k0, k1, conv] + ([] if x_ntt is None else [x_ntt])
    for t in args:
        cuda_lib.check_tensor(t, ext_ops.device, name)
    cuda_lib.check_tensor(owner, ext_ops.device, name, torch.int64)
    if y.dim() != 4 or y.shape[-1] != n:
        raise ValueError(f"{name}: y shape {tuple(y.shape)} is not "
                         f"[B, n_groups, alpha, {n}]")
    batch, n_groups, alpha = y.shape[:3]
    _shape(k0, (n_groups, n_ext, n), name)
    _shape(k1, (n_groups, n_ext, n), name)
    _shape(conv, (n_groups * alpha, n_ext), name)
    _shape(owner, (n_ext,), name)
    n_cur = 0
    if x_ntt is not None:
        n_cur = x_ntt.shape[1] if x_ntt.dim() == 3 else -1
        if not 0 < n_cur < n_ext:
            raise ValueError(f"{name}: x_ntt shape {tuple(x_ntt.shape)} is "
                             f"not [B, n_cur < {n_ext}, {n}]")
        _shape(x_ntt, (batch, n_cur, n), name)
    acc0 = torch.empty((batch, n_ext, n), dtype=torch.int32, device=y.device)
    acc1 = torch.empty_like(acc0)
    if batch == 0:
        return acc0, acc1
    lib, tab = _load(y.device), ext_ops.kernel_tables()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.eva_ks_mac(
        y.data_ptr(), None if x_ntt is None else x_ntt.data_ptr(),
        k0.data_ptr(), k1.data_ptr(), conv.data_ptr(), owner.data_ptr(),
        tab["q"].data_ptr(), tab["nqinv"].data_ptr(), tab["wf"].data_ptr(),
        tab["wpf"].data_ptr(), acc0.data_ptr(), acc1.data_ptr(), batch,
        n_groups, alpha, n_ext, n_cur, ext_ops.logn, stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["ks_mac"] += 1
    MAX_BATCH["ks_mac"] = max(MAX_BATCH["ks_mac"], batch)
    return acc0, acc1


def _pdiv(ext_ops, n_key: int) -> np.ndarray:
    """Division constants [n_key, 2 n_ext + 2] of ks.cu's epilogue: step
    d drops ext prime n_ext-1-d = p; row r holds p^-1 mod q_r and its
    Shoup quotient, then p and p // 2 (pallas_ks.PallasEpilogue.pdiv);
    every value is below 2^32 (uint32)."""
    primes = ext_ops.primes
    n_ext = len(primes)
    pdiv = np.zeros((n_key, 2 * n_ext + 2), dtype=np.uint32)
    for d in range(n_key):
        p = primes[n_ext - 1 - d]
        for r, q in enumerate(primes[:n_ext - 1 - d]):
            inv = pow(p % q, q - 2, q)
            pdiv[d, r] = inv
            pdiv[d, n_ext + r] = (inv << 32) // q
        pdiv[d, 2 * n_ext] = p
        pdiv[d, 2 * n_ext + 1] = p // 2
    return pdiv


def ks_epilogue(acc0, acc1, ext_ops, n_key: int, out_ntt: bool):
    """The epilogue kernels (see ks.ks_epilogue_plain): d0, d1
    [B, n_ext - n_key, N] int32."""
    name = "CUDA ks_epilogue"
    n = ext_ops.n
    n_ext = len(ext_ops.primes)
    cuda_lib.check_ring(n, name)
    for t in (acc0, acc1):
        cuda_lib.check_tensor(t, ext_ops.device, name)
        if t.dim() != 3:
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                             f"[B, {n_ext}, {n}]")
        _shape(t, (acc0.shape[0], n_ext, n), name)
    if not 1 <= n_key <= min(MAX_KEY_PRIMES, n_ext - 1):
        raise ValueError(f"{name}: n_key={n_key} not in [1, "
                         f"{min(MAX_KEY_PRIMES, n_ext - 1)}]")
    if acc0.data_ptr() % 16 or acc1.data_ptr() % 16:
        raise ValueError(f"{name}: tensor data not 16-byte aligned")
    batch = acc0.shape[0]
    n_out = n_ext - n_key
    out0 = torch.empty((batch, n_out, n), dtype=torch.int32,
                       device=acc0.device)
    out1 = torch.empty_like(out0)
    if batch == 0:
        return out0, out1
    scratch = torch.empty((2, batch, n_key, n), dtype=torch.int32,
                          device=acc0.device)
    lib, tab = _load(acc0.device), ext_ops.kernel_tables()
    pdiv = ext_ops.const(("ks_pdiv", n_key), lambda: _pdiv(ext_ops, n_key))
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    cluster = ctypes.c_int(0)
    err = lib.eva_ks_epilogue(
        acc0.data_ptr(), acc1.data_ptr(), scratch.data_ptr(),
        out0.data_ptr(), out1.data_ptr(), tab["q"].data_ptr(),
        tab["wi"].data_ptr(), tab["wpi"].data_ptr(), tab["ninv"].data_ptr(),
        tab["ninvp"].data_ptr(), tab["wf"].data_ptr(), tab["wpf"].data_ptr(),
        pdiv.data_ptr(), batch, n_ext, n_key, int(out_ntt), ext_ops.logn,
        ctypes.byref(cluster), stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["ks_epilogue"] += 1
    EPILOGUE_CLUSTER[cluster.value] += 1
    MAX_BATCH["ks_epilogue"] = max(MAX_BATCH["ks_epilogue"], batch)
    return out0, out1
