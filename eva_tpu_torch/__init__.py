"""EVA on PyTorch/CUDA: a compiler and GPU runtime for CKKS homomorphic
encryption, ported from the JAX package `eva_tpu`.

The public DSL mirrors the reference PyEVA API (reference:
python/eva/__init__.py): build an `EvaProgram` with `Input`/`Output` and
operator overloads, compile with `eva_tpu_torch.ckks.CKKSCompiler`, generate keys
with `eva_tpu_torch.runtime.generate_keys`, then encrypt/execute/decrypt. The
compute path runs on PyTorch (hand-written CUDA NTT kernels on the GPU).
`save`/`load` write and read the protocol objects in the JAX package's
wire format (eva_tpu_torch.serialization, through its own proto3 codec:
no protobuf)."""

from __future__ import annotations

import numbers
import threading
from typing import Optional

from .ir import Op, Program, Term, Type
from .reference import evaluate

__all__ = [
    "Op", "Type", "Term", "Program", "Expr", "EvaProgram", "Input", "Output",
    "py_to_eva", "evaluate", "set_num_threads", "version", "save", "load",
]

__version__ = "0.2.0"


def version() -> str:
    """Package version string (reference: eva/version.h/.cpp)."""
    return __version__

_state = threading.local()


def _curr() -> "EvaProgram":
    program = getattr(_state, "current_program", None)
    if program is None:
        raise RuntimeError("No Program in context")
    return program


def _py_to_term(x, program: Program) -> Term:
    if isinstance(x, Expr):
        return x.term
    if isinstance(x, list):
        return program.make_dense_constant(x)
    if isinstance(x, numbers.Number):
        return program.make_uniform_constant(x)
    if isinstance(x, Term):
        return x
    raise TypeError(f"No conversion to Term available for {x!r}")


def py_to_eva(x, program: Optional[Program] = None) -> "Expr":
    """Coerce numbers/lists/terms into an Expr in the given (or current)
    program."""
    if isinstance(x, Expr):
        return x
    if program is None:
        program = _curr()
    return Expr(_py_to_term(x, program), program)


class Expr:
    """Wraps a Term with operator overloads creating new terms."""

    __slots__ = ("term", "program")

    def __init__(self, term: Term, program: Program):
        self.term = term
        self.program = program

    def _make(self, op: Op, operands) -> "Expr":
        return Expr(self.program.make_term(op, operands), self.program)

    def __add__(self, other):
        return self._make(Op.Add, [self.term, _py_to_term(other, self.program)])

    def __radd__(self, other):
        return self._make(Op.Add, [_py_to_term(other, self.program), self.term])

    def __sub__(self, other):
        return self._make(Op.Sub, [self.term, _py_to_term(other, self.program)])

    def __rsub__(self, other):
        return self._make(Op.Sub, [_py_to_term(other, self.program), self.term])

    def __mul__(self, other):
        return self._make(Op.Mul, [self.term, _py_to_term(other, self.program)])

    def __rmul__(self, other):
        return self._make(Op.Mul, [_py_to_term(other, self.program), self.term])

    def __pow__(self, exponent):
        if not isinstance(exponent, int) or exponent < 1:
            raise ValueError(f"exponent must be a positive integer, got {exponent}")
        result = self.term
        for _ in range(exponent - 1):
            result = self.program.make_term(Op.Mul, [result, self.term])
        return Expr(result, self.program)

    def __lshift__(self, rotation):
        return Expr(self.program.make_left_rotation(self.term, rotation), self.program)

    def __rshift__(self, rotation):
        return Expr(self.program.make_right_rotation(self.term, rotation), self.program)

    def __neg__(self):
        return self._make(Op.Negate, [self.term])


class EvaProgram(Program):
    """Program + context manager setting the ambient current program."""

    def __init__(self, name: str, vec_size: int):
        super().__init__(name, vec_size)

    def __enter__(self):
        if getattr(_state, "current_program", None) is not None:
            raise RuntimeError("There is already an EVA Program in context")
        _state.current_program = self
        return self

    def __exit__(self, exc_type, exc_value, exc_traceback):
        if getattr(_state, "current_program", None) is not self:
            raise RuntimeError("This program is not currently in context")
        _state.current_program = None


def Input(name: str, is_encrypted: bool = True) -> Expr:
    """Create a named input term in the current EvaProgram."""
    program = _curr()
    type_ = Type.Cipher if is_encrypted else Type.Raw
    return Expr(program.make_input(name, type_), program)


def Output(name: str, expr) -> None:
    """Create a named output term in the current EvaProgram."""
    program = _curr()
    program.make_output(name, _py_to_term(expr, program))


def set_num_threads(num_threads: int) -> None:
    """Cap the host-side thread pool used for parallel input encryption
    (runtime/EVAPublic.encrypt; the native NTT releases the GIL).
    Device-side parallelism is managed by the GPU runtime and is not
    affected. Reference: wrapper.cpp:128-137 (Galois thread count)."""
    from . import runtime
    runtime.HOST_THREADS = max(1, int(num_threads))


def save(obj, path: str) -> None:
    from .serialization import save as _save
    _save(obj, path)


def load(path: str, backend: str = "torch", device=None):
    """The object saved at `path`. A public context (EVAPublic) is built
    on `backend`/`device`, as generate_keys builds it: device=None means
    the CUDA device and raises without one."""
    from .serialization import load as _load
    return _load(path, backend=backend, device=device)
