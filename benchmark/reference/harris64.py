"""Plain NumPy Harris corner response: what the harris64 program
computes, on the plaintext image.

Rotation semantics, as EVA defines them: `x << k` is a left rotation of
the whole slots-slot vector, out[i] = x[(i + k) mod slots], so a
window that runs past the last slot wraps to the first. The image fills
the first rows*cols slots, zeros the rest."""

import numpy as np

from harness.precision import arith

SOBEL = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
BOX = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]
K = 0.04


def rotate_left(x: np.ndarray, k: int) -> np.ndarray:
    return np.concatenate([x[k:], x[:k]])


def reference(image: np.ndarray, cfg: dict, precision: str = "float64") -> dict:
    """{output name: [slots] float64} for one image vector."""
    dt, r = arith(precision)
    w = cfg["cols"]

    def conv(x, filt, transposed=False):
        out = None
        for i in range(3):
            for j in range(3):
                c = filt[j][i] if transposed else filt[i][j]
                t = r(rotate_left(x, i * w + j) * dt(c))
                out = t if out is None else r(out + t)
        return out

    x = r(np.asarray(image, dtype=np.float64).astype(dt))
    Ix, Iy = conv(x, SOBEL), conv(x, SOBEL, transposed=True)
    Sxx = conv(r(Ix * Ix), BOX)
    Syy = conv(r(Iy * Iy), BOX)
    Sxy = conv(r(Ix * Iy), BOX)
    det = r(r(Sxx * Syy) - r(Sxy * Sxy))
    trace = r(Sxx + Syy)
    out = r(det - r(r(dt(K) * trace) * trace))
    return {cfg["output"]: out.astype(np.float64)}
