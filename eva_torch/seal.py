"""Compatibility: eva_torch.seal mirrors the reference submodule's surface
(generate_keys and the public/secret/valuation types), backed by the
PyTorch/CUDA runtime instead of SEAL. generate_keys(params) builds the
public context on the CUDA device (backend="torch") and raises without
one."""

from eva_tpu_torch.runtime import (EVAPublic as SEALPublic,
                                   EVASecret as SEALSecret,
                                   EVAValuation as SEALValuation,
                                   generate_keys)

__all__ = ["generate_keys", "SEALPublic", "SEALSecret", "SEALValuation"]
