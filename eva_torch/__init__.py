"""Drop-in compatibility package for the PyTorch/CUDA port: `import
eva_torch as eva` works like the reference PyEVA API
(python/eva/__init__.py), re-exporting eva_tpu_torch, as the `eva`
package re-exports eva_tpu. Programs run on the CUDA device by default
(`eva_torch.seal.generate_keys(params)` raises without one; pass
device="cpu" for the plain PyTorch versions)."""

from eva_tpu_torch import (EvaProgram, Expr, Input, Op, Output, Program,
                           Term, Type, evaluate, load, py_to_eva, save,
                           set_num_threads, version)
from eva_tpu_torch import __version__

__all__ = [
    "EvaProgram", "Expr", "Input", "Op", "Output", "Program", "Term",
    "Type", "evaluate", "load", "py_to_eva", "save", "set_num_threads",
    "version",
]
