"""Everything a run draws at random comes from --seed.

The pool of images is drawn here. The port samples its key and
encryption randomness from the OS (`secrets` in `crypto/keys.py`); a run
hands it a stream drawn from the seed in its place, so that one seed
gives the same keys, ciphertexts and outputs in every run. The server's
work does not depend on these values, only the noise in the outputs
does."""

from __future__ import annotations

import random

import numpy as np

POOL_STREAM = 1
KEY_STREAM = 2


class SeededSecrets:
    """The two calls of the `secrets` module that the port's key code
    makes, drawn from a seeded stream."""

    def __init__(self, seed: int):
        self._r = random.Random(f"{KEY_STREAM}:{seed}")

    def randbits(self, k: int) -> int:
        return self._r.getrandbits(k)

    def token_bytes(self, n: int) -> bytes:
        return self._r.randbytes(n)


def seed_port_randomness(seed: int) -> None:
    from eva_tpu_torch.crypto import keys
    keys.secrets = SeededSecrets(seed)


def image_pool(seed: int, count: int, rows: int, cols: int,
               slots: int) -> np.ndarray:
    """[count, slots] float64: uniform pixels in [0, 1) in the first
    rows*cols slots of each vector, zeros after them."""
    rng = np.random.default_rng([POOL_STREAM, seed % 2 ** 64])
    pool = np.zeros((count, slots))
    pool[:, :rows * cols] = rng.uniform(0.0, 1.0, (count, rows * cols))
    return pool
