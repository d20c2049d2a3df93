"""Build, load and launch the elementwise modular kernels (csrc/modmath.cu).

Same route as the NTT and key-switch kernels (ntt_cuda, ks_cuda): nvcc
for sm_90a into a plain C library at first use (cuda_lib.build), loaded
with ctypes; each launch goes on the current CUDA stream and its
cudaError_t becomes an exception. There is no fallback: a CUDA tensor
either goes through a kernel or raises. The plain versions are
modmath.add_mod / sub_mod / neg_mod / mont_mul / mul / shoup_mul /
ew_planes / mont_mac / tensor_product and ks.divide_last_plain on a CPU
tensor; tables.DeviceLevelOps and ks.divide_last dispatch by device.

  E1 mod_ew(op, ops, *operands): one of "add", "sub", "neg", "mul_mont",
     "mul" (standard x standard: a second Montgomery step by R^2 mod q,
     the third operand) and "shoup" (a * w by the Shoup pair (w, wp), the
     second and third operands), over the broadcast of the operands'
     shapes with [n_sub, 1];
     mod_ew_multi(op, ops, planes): the same op on 2-4 independent
     operand sets in one launch, plane k's rows using a prefix of the
     primes of `ops`;
     mod_ew_mac(ops, own, a, b, keys0, keys1): the structured key-switch
     MAC, both key halves, in one launch;
  E2 tensor_product(ops, a0, a1, b0, b1) -> [d0, d1, d2];
  E3 divide_last(xs, pinv, ps, ops, addends) -> each of 1-3 polynomials
     divided by its last k primes.
  galois_perm(planes, perm): the Galois automorphism of 1-4 NTT-domain
     planes, out[..., j] = x[..., perm[j]], in one launch
     (executor_torch.DevPerm; its plain version is torch.index_select on
     a CPU tensor).
  E4 modmul_burn(ops, x): modmath.BURN_K dependent Montgomery
     multiplies of each word of x by 3 and 5 in turn (bench_torch.py's
     modular-multiply rate probe; on no program's path). It dispatches
     by device itself: a CPU tensor goes to modmath.modmul_burn.

Operands are int32 tensors of uint32 residue bits on the CUDA device of
`ops` (a DeviceLevelOps: its kernel tables give q and -q^-1 mod 2^32 per
prime). E1's operands may be strided views as long as their last dim has
stride 1 (or size 1: a per-row constant); each broadcasts against the
output by shape (size-1 dims). E2's and E3's are contiguous. Outputs are
new contiguous int32 tensors.

`LAUNCHES` counts launches by kernel and form ("mod_ew", "mod_ew_multi",
"mod_ew_mac", "tensor_product", "divide_last", "galois_perm"), and `OPS`
counts the single and multi forms of E1 by op; both are incremented only
where a kernel is launched. E4's launches are counted apart, in
`PROBE_LAUNCHES`: every kernel in `LAUNCHES` runs on every program
path, and E4 on none."""

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

LAUNCHES = {"mod_ew": 0, "mod_ew_multi": 0, "mod_ew_mac": 0,
            "tensor_product": 0, "divide_last": 0, "galois_perm": 0}
OPS = Counter()
PROBE_LAUNCHES = {"modmul_burn": 0}

# E1's ops, by their csrc/modmath.cu enum value, and the operands each
# reads.
OP_CODES = {"add": 0, "sub": 1, "neg": 2, "mul_mont": 3, "mul": 4,
            "shoup": 5}
OP_ARITY = {"add": 2, "sub": 2, "neg": 1, "mul_mont": 2, "mul": 3,
            "shoup": 3}
MAX_DIMS = 8    # kMaxDims: an output's leading dims, coalesced
MAX_PLANES = 4  # kMaxPlanes: planes of one multi launch
MAX_POLYS = 3   # kMaxPolys: polynomials of one E3 launch
MAX_DIV = 8     # kMaxDiv: primes one E3 launch divides by
VEC = 4         # kVec: words a thread handles where operands allow
# The kernels eva_modmath_info reports, in its order.
INFO_NAMES = ([f"mod_ew_{op}" for op in OP_CODES]
              + [f"mod_ew_multi_{op}" for op in OP_CODES]
              + ["mod_ew_mac", "tensor_product"]
              + [f"divide_last_k{k}" for k in range(1, MAX_DIV + 1)]
              + ["modmul_burn", "galois_perm"])

_lib = None
_lock = threading.Lock()
# Launch plans by call signature (see _launch_ew), worked out once each:
# the Python around a launch is most of an eager call's cost.
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
            pp = ctypes.POINTER(ctypes.c_void_p)
            dims = ctypes.POINTER(ctypes.c_longlong)
            lib.eva_mod_ew.argtypes = [i, i, pp, pp, p, p, i,
                                       ctypes.POINTER(i), dims, i, p]
            lib.eva_mod_ew.restype = i
            lib.eva_mod_ew_mac.argtypes = ([p, p, p, pp, p, p, p, p]
                                           + [i] * 5 + [dims, i, p])
            lib.eva_mod_ew_mac.restype = i
            lib.eva_tensor_product.argtypes = [p] * 10 + [i] * 3 + [dims, p]
            lib.eva_tensor_product.restype = i
            lib.eva_divide_last.argtypes = (
                [i, pp, pp, pp, p, p, p, ctypes.POINTER(ctypes.c_uint), i,
                 ctypes.c_longlong, i, i, i, p])
            lib.eva_divide_last.restype = i
            lib.eva_modmul_burn.argtypes = [p, p, p, p, i, i,
                                            ctypes.c_longlong, p]
            lib.eva_modmul_burn.restype = i
            lib.eva_galois_perm.argtypes = [i, pp, pp, p, i,
                                             ctypes.POINTER(i), dims, p]
            lib.eva_galois_perm.restype = i
            lib.eva_modmath_info.argtypes = [ctypes.POINTER(i)]
            lib.eva_modmath_info.restype = i
            _lib = lib
    return _lib


def kernel_info(device: torch.device) -> dict:
    """Registers and local (spill) bytes per thread of each kernel (E1
    by form and op, E3 by the count of primes) on `device`."""
    lib = _load()
    out = (ctypes.c_int * (2 * len(INFO_NAMES)))()
    with torch.cuda.device(device):
        count = lib.eva_modmath_info(out)
    cuda_lib.raise_on("CUDA modmath info", -count if count < 0 else 0)
    if count != len(INFO_NAMES):
        raise RuntimeError(f"CUDA modmath info: {count} kernels, expected "
                           f"{len(INFO_NAMES)}")
    return {k: {"registers": out[2 * j], "local_bytes": out[2 * j + 1]}
            for j, k in enumerate(INFO_NAMES)}


def _ptrs(values):
    return (ctypes.c_void_p * len(values))(*values)


def _lead_spec(lead, strides):
    """Coalesced leading dims: [(size, [stride of each operand])] for the
    dims of `lead` (sizes) whose size is not 1, neighbours merged where
    every operand steps through them as one; `strides` holds each
    operand's strides along `lead`."""
    dims = []  # innermost last
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
    return dims


def _shape_spec(shape, operands):
    """(ndim, [values]) for the C entry points: the output's leading dims
    (all but the last, see _lead_spec), then for each of three operand
    slots its strides in words along them (0 where it broadcasts; unused
    slots 0), then each slot's stride along the last dim."""
    strides = [list(t.expand(shape).stride()) for t in operands]
    strides += [[0] * len(shape)] * (3 - len(strides))
    dims = _lead_spec(shape[:-1], strides)
    flat = [size for size, _ in dims]
    for k in range(3):
        flat += [st[k] for _, st in dims]
    flat += [s[-1] for s in strides]
    return len(dims), flat


def _check_operand(t, device, name) -> None:
    """An E1 operand: int32 on the CUDA `device`, its last dim of stride
    1 (or of size 1: a per-row constant). Other strides are free."""
    if not t.is_cuda:
        raise ValueError(f"{name}: tensor is not on a CUDA device")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32 residues, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, tables on {device}")
    if t.dim() and t.shape[-1] != 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must have stride 1, not "
                         f"{t.stride(-1)}")


def _check(name, ops, operands, n_sub: int = None):
    """Validate E1 operands against `ops` (n_sub of its primes, all by
    default, along the output's second-last dim); returns the output
    shape."""
    for t in operands:
        _check_operand(t, ops.device, name)
    n_sub = len(ops.primes) if n_sub is None else n_sub
    table = (n_sub, 1)
    shapes = [tuple(t.shape) for t in operands]
    try:
        return tuple(torch.broadcast_shapes(*shapes, table))
    except RuntimeError as err:
        raise ValueError(f"{name}: shapes {shapes} do not broadcast with "
                         f"the {n_sub} primes' {list(table)}") from err


def _aligned(tensors) -> bool:
    """Every base address 16-byte aligned (VEC words)."""
    return all(t.data_ptr() % (4 * VEC) == 0 for t in tensors)


def _ew_plan(name, op, ops, planes, multi: bool):
    """The launch of E1 `op` over `planes` (operand tuples), validated
    and worked out once per call signature (see _launch_ew): (output
    shapes, n, the non-empty planes, meta and dims for eva_mod_ew as
    ctypes arrays, whether every stride allows 4 words a thread, and
    (plane, operand) of each operand read along the last dim, whose
    address must be 16-byte aligned too). A plane of the multi form uses
    as many primes as it has rows; the single form all of them."""
    shapes, meta, dims, live, full, vec = [], [], [], [], [], True
    for k, operands in enumerate(planes):
        _check_op(name, op, operands)
        n_sub = None
        if multi:
            n_sub = max(t.shape[-2] if t.dim() > 1 else 1 for t in operands)
            if n_sub > len(ops.primes):
                raise ValueError(f"{name}: a plane of {n_sub} rows, the "
                                 f"table has {len(ops.primes)} primes")
        shape = _check(name, ops, operands, n_sub)
        shapes.append(shape)
        if math.prod(shape) == 0:
            continue
        live.append(k)
        ndim, flat = _shape_spec(shape, operands)
        meta += [ndim, shape[-2]]
        dims += flat
        for j, t in enumerate(operands):
            if t.shape[-1] != 1:  # not a per-row constant
                full.append((k, j))
                vec = vec and all(flat[ndim * (1 + j) + d] % VEC == 0
                                  for d in range(ndim))
    n = shapes[0][-1]
    if any(shape[-1] != n for shape in shapes):
        raise ValueError(f"{name}: planes of different widths "
                         f"{[shape[-1] for shape in shapes]}")
    return (shapes, n, live, (ctypes.c_int * len(meta))(*meta),
            (ctypes.c_longlong * len(dims))(*dims), vec and n % VEC == 0,
            full)


def _launch_ew(name, op, ops, planes, multi: bool = False):
    """One E1 launch of `op` over `planes` (operand tuples), all of one
    last dim; returns the outputs. The plan is cached by the call
    signature: every operand's shape, strides, dtype and device, the
    primes' count and device (the Python around a launch is most of an
    eager call's cost)."""
    key = (name, len(ops.primes), ops.device, multi, tuple(
        tuple((t.shape, t.stride(), t.dtype, t.device) for t in operands)
        for operands in planes))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _ew_plan(name, op, ops, planes, multi)
    shapes, n, live, meta, dims, vec, full = plan
    device = ops.device
    outs = [torch.empty(shape, dtype=torch.int32, device=device)
            for shape in shapes]
    if not live:
        return outs
    vec = vec and _aligned([planes[k][j] for k, j in full])
    src = []
    for k in live:
        src += ([t.data_ptr() for t in planes[k]]
                + [None] * (3 - len(planes[k])))
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.eva_mod_ew(
        OP_CODES[op], len(live), _ptrs(src),
        _ptrs([outs[k].data_ptr() for k in live]), tab["q"].data_ptr(),
        tab["nqinv"].data_ptr(), n, meta, dims, int(vec), stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["mod_ew" if len(live) == 1 else "mod_ew_multi"] += 1
    OPS[op] += 1
    return outs


def _check_op(name, op, operands) -> None:
    if op not in OP_CODES:
        raise ValueError(f"CUDA mod_ew: unknown op {op!r}")
    if len(operands) != OP_ARITY[op]:
        raise ValueError(f"{name}: {len(operands)} operands, expected "
                         f"{OP_ARITY[op]}")


def mod_ew(op: str, ops, *operands: torch.Tensor) -> torch.Tensor:
    """E1: the elementwise op `op` (see OP_CODES) of `operands` with the
    primes of `ops` along the output's second-last dim."""
    return _launch_ew(f"CUDA mod_ew {op}", op, ops, [operands])[0]


def mod_ew_multi(op: str, ops, planes) -> list:
    """E1, the several-planes form: `op` on each of 2-4 operand sets
    `planes` in one launch (one set: the single form). Plane k's output
    is the broadcast of its operands, whose second-last dim (its rows)
    uses the first rows of the primes of `ops`: a rotation sum's c0 (the
    level's data primes) and acc (the extended basis) share the extended
    basis's table."""
    name = f"CUDA mod_ew_multi {op}"
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{name}: {len(planes)} planes, the kernel takes "
                         f"1 to {MAX_PLANES}")
    return _launch_ew(name, op, ops, planes, multi=True)


def _mac_check(name, ops, own, a, b, keys0, keys1):
    """Shapes of the MAC's operands: (lead, n_cur, n_key, groups, n)."""
    tensors = [own, b, *keys0[::2], *keys1[::2]]
    if a is not None:
        tensors += [a, keys0[1], keys1[1]]
    elif keys0[1] is not None or keys1[1] is not None:
        raise ValueError(f"{name}: foreign key rows without foreign digits")
    for t in tensors:
        _check_operand(t, ops.device, name)
        if t.dim() < 2 or t.stride(-1) != 1:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             f"and strides {t.stride()}")
    lead, (n_cur, n) = tuple(own.shape[:-2]), own.shape[-2:]
    groups, n_key = b.shape[-3], b.shape[-2]
    n_ext = len(ops.primes)
    want = {"b": (b, lead + (groups, n_key, n))}
    if a is not None:
        want["a"] = (a, lead + (groups - 1, n_cur, n))
    for h, keys in enumerate((keys0, keys1)):
        want[f"k{h}_own"] = (keys[0], (n_cur, n))
        want[f"k{h}_b"] = (keys[2], (groups, n_key, n))
        if a is not None:
            want[f"k{h}_a"] = (keys[1], (groups - 1, n_cur, n))
    bad = {k: tuple(t.shape) for k, (t, s) in want.items()
           if tuple(t.shape) != s}
    if bad or n_cur + n_key != n_ext or (groups > 1) != (a is not None):
        raise ValueError(f"{name}: own {tuple(own.shape)}, {bad or ''} "
                         f"against {n_ext} primes and {groups} digit "
                         f"groups")
    if keys0[0].stride() != keys1[0].stride() or keys0[2].stride() != \
            keys1[2].stride() or (a is not None and keys0[1].stride()
                                  != keys1[1].stride()):
        raise ValueError(f"{name}: the two key halves differ in strides")
    return lead, n_cur, n_key, groups, n


def mod_ew_mac(ops, own, a, b, keys0, keys1):
    """E1, the MAC form: the structured key switch's inner product
    (executor_torch.TorchProgram._ks_mac) of the digits own [..., n_cur,
    N], a [..., groups - 1, n_cur, N] (None for one group) and b [...,
    groups, n_key, N] with the key halves keys0, keys1 = (k_own, k_a,
    k_b) in the matching layout (no leading dims), in one launch; `ops`
    holds the extended basis (n_cur data primes, then n_key key primes).
    Returns acc0, acc1 [..., n_cur + n_key, N]."""
    name = "CUDA mod_ew_mac"
    key = ("mac", len(ops.primes), ops.device) + tuple(
        None if t is None else (t.shape, t.stride(), t.dtype, t.device)
        for t in (own, a, b, *keys0, *keys1))
    plan = _PLANS.get(key)
    if plan is None:
        lead, n_cur, n_key, groups, n = _mac_check(name, ops, own, a, b,
                                                   keys0, keys1)
        digits = [own, own if a is None else a, b]
        dims = _lead_spec(lead, [t.stride()[:len(lead)] for t in digits])
        flat = [size for size, _ in dims]
        for k in range(3):
            flat += [st[k] for _, st in dims]
        k_a = keys0[0] if a is None else keys0[1]
        flat += [own.stride(-2), digits[1].stride(-2), b.stride(-2),
                 digits[1].stride(-3) if a is not None else 0, b.stride(-3),
                 keys0[0].stride(-2), k_a.stride(-2), keys0[2].stride(-2),
                 k_a.stride(-3) if a is not None else 0, keys0[2].stride(-3)]
        plan = _PLANS[key] = (lead + (n_cur + n_key, n), n_cur, n_key,
                              groups, n, len(dims),
                              (ctypes.c_longlong * len(flat))(*flat),
                              all(s % VEC == 0 for s in flat[len(dims):]))
    shape, n_cur, n_key, groups, n, ndim, flat, vec_strides = plan
    device = ops.device
    out0, out1 = (torch.empty(shape, dtype=torch.int32, device=device)
                  for _ in range(2))
    if out0.numel() == 0:
        return out0, out1
    tensors = [t for t in (own, a, b, *keys0, *keys1) if t is not None]
    vec = n % VEC == 0 and vec_strides and _aligned(tensors)
    keys = [keys0[0], keys1[0], keys0[1], keys1[1], keys0[2], keys1[2]]
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.eva_mod_ew_mac(
        own.data_ptr(), None if a is None else a.data_ptr(), b.data_ptr(),
        _ptrs([None if k is None else k.data_ptr() for k in keys]),
        out0.data_ptr(), out1.data_ptr(), tab["q"].data_ptr(),
        tab["nqinv"].data_ptr(), n, n_cur, n_key, groups, ndim, flat,
        int(vec), stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["mod_ew_mac"] += 1
    return out0, out1


def tensor_product(ops, a0, a1, b0, b1):
    """E2: [d0, d1, d2] of the ciphertext tensor product (a0, a1) x
    (b0, b1); a0 and a1 of one shape, b0 and b1 of one shape, each
    contiguous."""
    name = "CUDA tensor_product"
    for t in (a0, a1, b0, b1):
        cuda_lib.check_tensor(t, ops.device, name)
    if a0.shape != a1.shape or b0.shape != b1.shape:
        raise ValueError(f"{name}: a-side shapes {tuple(a0.shape)}, "
                         f"{tuple(a1.shape)}, b-side {tuple(b0.shape)}, "
                         f"{tuple(b1.shape)}")
    key = (name, len(ops.primes), ops.device,
           tuple((t.shape, t.stride()) for t in (a0, b0)))
    plan = _PLANS.get(key)
    if plan is None:
        shape = _check(name, ops, (a0, a1, b0, b1))
        ndim, flat = _shape_spec(shape, (a0, b0))
        plan = _PLANS[key] = (shape, ndim,
                              (ctypes.c_longlong * len(flat))(*flat))
    shape, ndim, dims = plan
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


def divide_last(xs, pinv: torch.Tensor, ps, ops, addends=None) -> list:
    """E3: each of the 1-3 polynomials xs, [..., n, N] coefficient planes
    of one shape (plus its addend, added mod q first, where `addends`
    gives one), divided and rounded by its last k primes ps (the last row's
    first) -> [..., n - k, N], in one launch. `ops` holds the first n - 1
    primes, `pinv` ([k, n - 1] int32) p_s^-1 R mod each of them (row s,
    first n - 1 - s entries)."""
    name = "CUDA divide_last"
    xs, ps = list(xs), [int(p) for p in ps]
    addends = list(addends) if addends is not None else [None] * len(xs)
    k, n_rows = len(ps), len(ops.primes) + 1
    if not 1 <= len(xs) <= MAX_POLYS or len(addends) != len(xs):
        raise ValueError(f"{name}: {len(xs)} polynomials and "
                         f"{len(addends)} addends, the kernel takes 1 to "
                         f"{MAX_POLYS}")
    if not 1 <= k <= MAX_DIV or k >= n_rows:
        raise ValueError(f"{name}: {k} primes to divide {n_rows} rows by")
    tensors = xs + [a for a in addends if a is not None] + [pinv]
    for t in tensors:
        cuda_lib.check_tensor(t, ops.device, name)
    shape = tuple(xs[0].shape)
    if len(shape) < 2 or shape[-2] != n_rows or any(
            tuple(t.shape) != shape for t in tensors[:-1]):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}"
                         f" differ, or one does not end in [{n_rows}, N]")
    if pinv.numel() != k * (n_rows - 1):
        raise ValueError(f"{name}: {pinv.numel()} inverses for {k} x "
                         f"{n_rows - 1} primes")
    if not all(0 < p < 1 << 31 for p in ps):
        raise ValueError(f"{name}: primes {ps} out of range")
    n = shape[-1]
    outs = [torch.empty(shape[:-2] + (n_rows - k, n), dtype=torch.int32,
                        device=xs[0].device) for _ in xs]
    if outs[0].numel() == 0:
        return outs
    lead = xs[0].numel() // (n_rows * n)
    vec = n % VEC == 0 and _aligned(tensors[:-1])
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    err = lib.eva_divide_last(
        len(xs), _ptrs([t.data_ptr() for t in xs]),
        _ptrs([None if a is None else a.data_ptr() for a in addends]),
        _ptrs([o.data_ptr() for o in outs]), tab["q"].data_ptr(),
        tab["nqinv"].data_ptr(), pinv.data_ptr(),
        (ctypes.c_uint * k)(*ps), k, lead, n_rows, n, int(vec), stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["divide_last"] += 1
    return outs


def galois_perm(planes, perm: torch.Tensor) -> list:
    """The Galois automorphism of each of the 1-4 `planes` in one launch:
    out[..., j] = x[..., perm[j]], a new contiguous tensor of x's shape.
    Each plane: int32 [..., N] on perm's CUDA device, its last dim of
    stride 1, its other strides free (leading dims fold into rows).
    perm: a contiguous int32 [N] permutation of range(N), N a ring size
    the kernels take (executor_torch.DevPerm builds it and checks that it
    is a permutation)."""
    name = "CUDA galois_perm"
    planes = list(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{name}: {len(planes)} planes, the kernel takes "
                         f"1 to {MAX_PLANES}")
    key = (name, perm.shape, perm.stride(), perm.dtype, perm.device, tuple(
        (t.shape, t.stride(), t.dtype, t.device) for t in planes))
    plan = _PLANS.get(key)
    if plan is None:
        cuda_lib.check_tensor(perm, perm.device, name)
        if perm.dim() != 1:
            raise ValueError(f"{name}: a table of shape "
                             f"{tuple(perm.shape)}, not [N]")
        n = perm.shape[0]
        cuda_lib.check_ring(n, name)
        meta, dims, live = [], [], []
        for k, t in enumerate(planes):
            _check_operand(t, perm.device, name)
            if t.dim() == 0 or t.shape[-1] != n:
                raise ValueError(f"{name}: a plane of shape "
                                 f"{tuple(t.shape)} against a table of {n}")
            if t.numel() == 0:
                continue
            lead = _lead_spec(t.shape[:-1], [t.stride()[:-1]])
            meta.append(len(lead))
            dims += [size for size, _ in lead] + [st[0] for _, st in lead]
            live.append(k)
        plan = _PLANS[key] = (n, live, (ctypes.c_int * len(meta))(*meta),
                              (ctypes.c_longlong * len(dims))(*dims))
    n, live, meta, dims = plan
    device = perm.device
    outs = [torch.empty(t.shape, dtype=torch.int32, device=device)
            for t in planes]
    if not live:
        return outs
    lib = _load()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.eva_galois_perm(
        len(live), _ptrs([planes[k].data_ptr() for k in live]),
        _ptrs([outs[k].data_ptr() for k in live]), perm.data_ptr(), n, meta,
        dims, stream)
    cuda_lib.raise_on(name, err)
    LAUNCHES["galois_perm"] += 1
    return outs


def modmul_burn(ops, x: torch.Tensor) -> torch.Tensor:
    """E4: x [..., n_sub, N] (int32 residue bits, any value below 2^32)
    after modmath.BURN_K dependent Montgomery multiplies of each word by
    3, 5, 3, ..., row by row on the primes of `ops`: one launch on a CUDA
    tensor, the plain version modmath.modmul_burn on a CPU tensor."""
    from . import modmath as M
    name = "CUDA modmul_burn"
    if x.dim() < 2 or x.shape[-2] != len(ops.primes):
        raise ValueError(f"{name}: shape {tuple(x.shape)} against "
                         f"{len(ops.primes)} primes")
    if not x.is_cuda:
        if x.device.type != "cpu" or x.dtype != torch.int32:
            raise ValueError(f"{name}: expected int32 residues on the CPU "
                             f"or a CUDA device, got {x.dtype} on "
                             f"{x.device}")
        return M.modmul_burn(x, ops.q, ops.rinv)
    cuda_lib.check_tensor(x, ops.device, name)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    n = x.shape[-1]
    cuda_lib.check_ring(n, name)
    lib, tab = _load(), ops.kernel_tables()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.eva_modmul_burn(
        x.data_ptr(), out.data_ptr(), tab["q"].data_ptr(),
        tab["nqinv"].data_ptr(), n.bit_length() - 1, len(ops.primes),
        x.numel(), stream)
    cuda_lib.raise_on(name, err)
    PROBE_LAUNCHES["modmul_burn"] += 1
    return out
