"""PyTorch execution backend: the GPU compute path.

Ciphertext polynomials are [n_sub, N] limb planes held as int32 torch
tensors carrying the JAX package's uint32 residues (residues < q < 2^31;
modmath.py). The elementwise modular arithmetic (E1-E3,
csrc/modmath.cu), the negacyclic NTT (csrc/ntt.cu) and the fused key
switch (csrc/ks.cu) are hand-written CUDA kernels on the GPU and their
plain PyTorch versions on the CPU. Precomputed operands (key switch keys,
inverse factors) are stored in Montgomery form as in the JAX package, so
the device results are bit-identical to it."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device a program runs on. None means the current CUDA
    device, and raises when there is none: execution never moves to the
    CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "eva_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch version explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
