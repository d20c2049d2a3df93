"""Build, load and launch the elementwise modular kernels (csrc/modmath.cu).

Same route as the NTT and key-switch kernels (ntt_cuda, ks_cuda): nvcc
for sm_90a into a plain C library at first use (cuda_lib.build), loaded
with ctypes; each launch goes on the current CUDA stream and its
cudaError_t becomes an exception. There is no fallback: a CUDA tensor
either goes through a kernel or raises. The plain versions are
modmath.add_mod / sub_mod / neg_mod / mont_mul / mul / shoup_mul /
tensor_product and ks.divide_last_planes on a CPU tensor;
tables.DeviceLevelOps dispatches by device.

  E1 mod_ew(op, ops, *operands): one of "add", "sub", "neg", "mul_mont",
     "mul" (standard x standard: a second Montgomery step by R^2 mod q,
     the third operand) and "shoup" (a * w by the Shoup pair (w, wp), the
     second and third operands), over the broadcast of the operands'
     shapes with [n_sub, 1];
  E2 tensor_product(ops, a0, a1, b0, b1) -> [d0, d1, d2];
  E3 divide_last(x, pinv, p, ops) -> x divided by its last prime p.

Operands are int32 tensors of uint32 residue bits, contiguous, on the
CUDA device of `ops` (a DeviceLevelOps: its kernel tables give q and
-q^-1 mod 2^32 per prime); each broadcasts against the output by shape
(size-1 dims). The primes run along the output's second-last dim (E1:
along `prime_dim`). Outputs are new contiguous int32 tensors.

`LAUNCHES` counts launches by kernel ("mod_ew", "tensor_product",
"divide_last"), and `OPS` counts E1's by op; both are incremented only
where a kernel is launched."""

from __future__ import annotations

import ctypes
import math
import os
import threading
from collections import Counter

import torch

from . import cuda_lib

SOURCE = os.path.join(cuda_lib.CSRC, "modmath.cu")
LIB_PATH = os.path.join(cuda_lib.BUILD_DIR, "libeva_modmath.so")

LAUNCHES = {"mod_ew": 0, "tensor_product": 0, "divide_last": 0}
OPS = Counter()

# E1's ops, by their csrc/modmath.cu enum value, and the operands each
# reads.
OP_CODES = {"add": 0, "sub": 1, "neg": 2, "mul_mont": 3, "mul": 4,
            "shoup": 5}
OP_ARITY = {"add": 2, "sub": 2, "neg": 1, "mul_mont": 2, "mul": 3,
            "shoup": 3}
MAX_DIMS = 8  # kMaxDims: the output's leading dims, coalesced

_lib = None
_lock = threading.Lock()
# Launch plans by call signature (see _plan), worked out once each: the
# Python around a launch is most of an eager call's cost.
_PLANS: dict = {}


def build(verbose: bool = False) -> str:
    """Compile csrc/modmath.cu into LIB_PATH unless it is up to date;
    returns the library path (see cuda_lib.build)."""
    return cuda_lib.build(SOURCE, LIB_PATH, verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            dims = ctypes.POINTER(ctypes.c_longlong)
            lib.eva_mod_ew.argtypes = [i] + [p] * 6 + [i] * 4 + [dims, p]
            lib.eva_mod_ew.restype = i
            lib.eva_tensor_product.argtypes = [p] * 10 + [i] * 3 + [dims, p]
            lib.eva_tensor_product.restype = i
            lib.eva_divide_last.argtypes = ([p] * 5 + [ctypes.c_uint]
                                            + [i] * 3 + [p])
            lib.eva_divide_last.restype = i
            lib.eva_modmath_info.argtypes = [ctypes.POINTER(i)]
            lib.eva_modmath_info.restype = i
            _lib = lib
    return _lib


def kernel_info(device: torch.device) -> dict:
    """Registers and local (spill) bytes per thread of each kernel (E1
    by op) on `device`."""
    lib = _load()
    names = [f"mod_ew_{op}" for op in OP_CODES] + ["tensor_product",
                                                   "divide_last"]
    out = (ctypes.c_int * (2 * len(names)))()
    with torch.cuda.device(device):
        cuda_lib.raise_on("CUDA modmath info", lib.eva_modmath_info(out))
    return {k: {"registers": out[2 * j], "local_bytes": out[2 * j + 1]}
            for j, k in enumerate(names)}


def _shape_spec(shape, operands):
    """(ndim, dims) for the C entry points: the output's leading dims
    (all but the last), with size-1 dims dropped and neighbours merged
    where every operand steps through them as one, then for each of
    three operand slots its strides in words along them (0 where it
    broadcasts; unused slots 0), then each slot's stride along the last
    dim."""
    lead = list(shape[:-1])
    strides = [list(t.expand(shape).stride()) for t in operands]
    strides += [[0] * len(shape)] * (3 - len(strides))
    dims = []  # [size, [stride per slot]] innermost last
    for d, size in enumerate(lead):
        if size == 1:
            continue
        st = [s[d] for s in strides]
        if dims and all(prev == cur * size for prev, cur in
                        zip(dims[-1][1], st)):
            dims[-1] = [dims[-1][0] * size, st]
        else:
            dims.append([size, st])
    if len(dims) > MAX_DIMS:
        raise ValueError(f"CUDA modmath: {len(dims)} leading dims after "
                         f"merging, the kernels take {MAX_DIMS}")
    flat = [size for size, _ in dims]
    for k in range(3):
        flat += [st[k] for _, st in dims]
    flat += [s[-1] for s in strides]
    return len(dims), (ctypes.c_longlong * len(flat))(*flat)


def _check(name, ops, operands, prime_dim: int = -2):
    """Validate the operands against `ops` (primes along `prime_dim` of
    the output, a negative dim before the last); returns the output
    shape."""
    for t in operands:
        cuda_lib.check_tensor(t, ops.device, name)
    n_sub = len(ops.primes)
    table = (n_sub,) + (1,) * (-prime_dim - 1)
    shapes = [tuple(t.shape) for t in operands]
    try:
        return tuple(torch.broadcast_shapes(*shapes, table))
    except RuntimeError as err:
        raise ValueError(f"{name}: shapes {shapes} do not broadcast with "
                         f"the {n_sub} primes' {list(table)}") from err


def _plan(name, ops, operands, slots, prime_dim: int = -2):
    """(output shape, ndim, dims, inner) of a launch on `operands`
    (_check, _shape_spec of the operands in `slots`; inner: the rows each
    prime's index repeats for), validated and worked out once per call
    signature: every operand's shape, strides, dtype and device, the
    primes' count, device and dim."""
    key = (name, len(ops.primes), ops.device, prime_dim,
           tuple((t.shape, t.stride(), t.dtype, t.device) for t in operands))
    plan = _PLANS.get(key)
    if plan is None:
        shape = _check(name, ops, operands, prime_dim)
        plan = _PLANS[key] = (shape, *_shape_spec(shape, slots),
                              math.prod(shape[prime_dim + 1:-1]))
    return plan


def mod_ew(op: str, ops, *operands: torch.Tensor,
           prime_dim: int = -2) -> torch.Tensor:
    """E1: the elementwise op `op` (see OP_CODES) of `operands` with the
    primes of `ops` along the output's dim `prime_dim` (negative, before
    the last)."""
    name = f"CUDA mod_ew {op}"
    if op not in OP_CODES:
        raise ValueError(f"CUDA mod_ew: unknown op {op!r}")
    if len(operands) != OP_ARITY[op]:
        raise ValueError(f"{name}: {len(operands)} operands, expected "
                         f"{OP_ARITY[op]}")
    if not prime_dim <= -2:
        raise ValueError(f"{name}: prime_dim {prime_dim} is not before the "
                         f"last dim")
    shape, ndim, dims, inner = _plan(name, ops, operands, operands,
                                     prime_dim)
    out = torch.empty(shape, dtype=torch.int32, device=operands[0].device)
    if out.numel() == 0:
        return out
    lib, tab = _load(), ops.kernel_tables()
    ptrs = [t.data_ptr() for t in operands] + [None] * (3 - len(operands))
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.eva_mod_ew(OP_CODES[op], *ptrs, out.data_ptr(),
                         tab["q"].data_ptr(), tab["nqinv"].data_ptr(), ndim,
                         shape[-1], shape[prime_dim], inner, dims, stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["mod_ew"] += 1
    OPS[op] += 1
    return out


def tensor_product(ops, a0, a1, b0, b1):
    """E2: [d0, d1, d2] of the ciphertext tensor product (a0, a1) x
    (b0, b1); a0 and a1 of one shape, b0 and b1 of one shape."""
    name = "CUDA tensor_product"
    if a0.shape != a1.shape or b0.shape != b1.shape:
        raise ValueError(f"{name}: a-side shapes {tuple(a0.shape)}, "
                         f"{tuple(a1.shape)}, b-side {tuple(b0.shape)}, "
                         f"{tuple(b1.shape)}")
    shape, ndim, dims, _ = _plan(name, ops, (a0, a1, b0, b1), (a0, b0))
    outs = [torch.empty(shape, dtype=torch.int32, device=a0.device)
            for _ in range(3)]
    if outs[0].numel() == 0:
        return outs
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(a0.device).cuda_stream
    err = lib.eva_tensor_product(
        a0.data_ptr(), a1.data_ptr(), b0.data_ptr(), b1.data_ptr(),
        *(o.data_ptr() for o in outs), tab["q"].data_ptr(),
        tab["nqinv"].data_ptr(), tab["r2"].data_ptr(), ndim, shape[-1],
        shape[-2], dims, stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["tensor_product"] += 1
    return outs


def divide_last(x: torch.Tensor, pinv: torch.Tensor, p: int, ops):
    """E3: [..., n, N] coefficient planes divided and rounded by their
    last prime p -> [..., n - 1, N]. `ops` holds the other n - 1 primes,
    `pinv` ([n - 1, 1] int32) p^-1 R mod each of them."""
    name = "CUDA divide_last"
    n_out = len(ops.primes)
    for t in (x, pinv):
        cuda_lib.check_tensor(t, ops.device, name)
    if x.dim() < 2 or x.shape[-2] != n_out + 1:
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not end in "
                         f"[{n_out + 1}, N]")
    if pinv.numel() != n_out:
        raise ValueError(f"{name}: {pinv.numel()} inverses for {n_out} "
                         f"primes")
    if not 0 < p < 1 << 31:
        raise ValueError(f"{name}: prime {p} out of range")
    n = x.shape[-1]
    out = torch.empty(x.shape[:-2] + (n_out, n), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    lead = x.numel() // ((n_out + 1) * n)
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.eva_divide_last(x.data_ptr(), out.data_ptr(),
                              tab["q"].data_ptr(), tab["nqinv"].data_ptr(),
                              pinv.data_ptr(), p, lead, n_out + 1, n, stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["divide_last"] += 1
    return out
