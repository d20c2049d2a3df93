"""Compatibility: eva_torch.ckks mirrors the reference submodule."""

from eva_tpu_torch.ckks import (CKKSCompiler, CKKSConfig, CKKSEncodingInfo,
                                CKKSParameters, CKKSSignature)

__all__ = ["CKKSCompiler", "CKKSConfig", "CKKSEncodingInfo",
           "CKKSParameters", "CKKSSignature"]
