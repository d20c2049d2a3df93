"""Plain NumPy Sobel filter: what the sobel90 program computes, on the
plaintext image.

Rotation semantics, as EVA defines them: `x << k` is a left rotation of
the whole slots-slot vector, out[i] = x[(i + k) mod slots], so a
window that runs past the last slot wraps to the first. The image fills
the first rows*cols slots, zeros the rest."""

import numpy as np

from harness.precision import arith

FILTER = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
A1, A2, A3 = 2.2137874823876622, -1.0984324107372518, 0.17254603006834726


def rotate_left(x: np.ndarray, k: int) -> np.ndarray:
    return np.concatenate([x[k:], x[:k]])


def reference(image: np.ndarray, cfg: dict, precision: str = "float64") -> dict:
    """{output name: [slots] float64} for one image vector."""
    dt, r = arith(precision)
    w = cfg["cols"]
    x = r(np.asarray(image, dtype=np.float64).astype(dt))
    Ix = Iy = None
    for i in range(3):
        for j in range(3):
            rot = rotate_left(x, i * w + j)
            h = r(rot * dt(FILTER[i][j]))
            v = r(rot * dt(FILTER[j][i]))
            Ix = h if Ix is None else r(Ix + h)
            Iy = v if Iy is None else r(Iy + v)
    d = r(r(Ix * Ix) + r(Iy * Iy))
    d2 = r(d * d)
    out = r(r(r(d * dt(A1)) + r(d2 * dt(A2))) + r(r(d2 * d) * dt(A3)))
    return {cfg["output"]: out.astype(np.float64)}
