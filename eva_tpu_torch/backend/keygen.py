"""Device-batched key-switching-key generation.

Port of eva_tpu/backend/keygen.py. The host keygen loop
(crypto/keys.py:_make_kswitch_key) pays, per digit, an NTT of the error
polynomial over every basis prime and three dyadic passes over
[n_all, N] planes (reference analog: seal::KeyGenerator::
create_galois_keys, one key-switch key per rotation step; reference
eva/seal/seal.cpp:186-196). This engine keeps ALL randomness
host-sampled (CSPRNG seeds and the numpy error stream, drawn in exactly
the host order) and batches only the deterministic arithmetic

    b_j = fac_j * target - a_j * s + NTT(e_j)   over the full basis

across the digits of one key: one forward NTT of [G, n_all, N] planes
(the CUDA kernel ntt_fwd on the card) and the elementwise passes (the
error's lift into every prime, the two products, the sum: the CUDA
kernel E1 on the card). Planes are int32 tensors of uint32 residues
(backend/modmath.py). The arithmetic is exact, so the key material is
byte-identical to the host path given the same randomness. On a CPU
device it runs the plain PyTorch versions."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .tables import level_ops


class DeviceKeygen:
    """`ksk_compute` engine consumed by crypto/keys._make_kswitch_key.
    `device=None` means the CUDA device, and raises when there is none
    (backend.resolve_device)."""

    def __init__(self, ctx, device=None):
        self.ctx = ctx
        self.dev = level_ops(ctx.all_primes, ctx.n, device)
        self.device = self.dev.device

    def _compute(self, A, e_pos, e_neg, fac, target, s_rows):
        """A [G, n_all, N]; the signed errors as e_pos = max(E, 0) and
        e_neg = max(-E, 0), [G, 1, N]; fac [G, n_all, 1]; target and
        s_rows [n_all, N]: b [G, n_all, N]."""
        dev = self.dev
        # Lift each signed error into every basis prime's residues,
        # e_pos - e_neg mod q: the [n_all, 1] moduli broadcast the
        # [G, 1, N] halves to [G, n_all, N].
        e_ntt = dev.ntt(dev.sub(e_pos, e_neg))
        ft = dev.mul(fac, target)    # fac_j * target, [G, n_all, N]
        a_s = dev.mul(A, s_rows)     # a_j * s
        return dev.add(dev.sub(ft, a_s), e_ntt)

    def ksk_compute(self, s_rows: np.ndarray, target_ntt: np.ndarray,
                    As: List[np.ndarray], Es: List[np.ndarray],
                    facs: np.ndarray):
        """Batched b_j for all digits; returns (k0, k1) lists of
        [n_all, N] uint64 planes matching the host layout (k1 is As)."""
        pinned = self.device.type == "cuda"

        def up(parts):
            """The arrays `parts` (one shape, values below 2^32) stacked
            as int32 uint32 bits on the device: cast once into a host
            buffer, page-locked on a CUDA device so that the upload runs
            at the link's rate."""
            host = torch.empty((len(parts),) + parts[0].shape,
                               dtype=torch.int32, pin_memory=pinned)
            for dst, src in zip(host.numpy().view(np.uint32), parts):
                np.copyto(dst, src, casting="unsafe")
            return host.to(self.device, non_blocking=True)

        e_pos = [np.maximum(e, 0) for e in Es]
        e_neg = [np.maximum(-e, 0) for e in Es]
        b = self._compute(up(As), up(e_pos)[:, None, :],
                          up(e_neg)[:, None, :], up(facs)[:, :, None],
                          up([target_ntt])[0], up([s_rows])[0])
        host = b
        if pinned:
            host = torch.empty(b.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(b)  # waits for the device
        b_host = host.numpy().view(np.uint32)
        return ([b_host[j].astype(np.uint64) for j in range(len(As))],
                list(As))
