"""Plain NumPy CryptoNets MNIST network (Gilad-Bachrach et al., ICML
2016, section 4.1): what the cryptonets_mnist program computes, on the
plaintext image, by the network's own equations and none of the
program's rotations or masks.

  pad one row on top and one column on the left, 5x5 convolution of
  `maps` maps at stride 2 plus bias, square, dense to `hidden` plus
  bias, square, dense to `classes` plus bias;

then the program's output layout: logit p mod classes in slot p. The
weights are the program's draw (programs/cryptonets_mnist.py's
docstring). Every operation's result, and each weight, is rounded at
the stated precision (harness.precision.arith), so that the lower
precisions act as the check's control."""

import numpy as np

from harness.precision import arith

KERNEL = 5
STRIDE = 2


def weights(cfg: dict) -> dict:
    oh = (cfg["rows"] + 1 - KERNEL) // STRIDE + 1
    ow = (cfg["cols"] + 1 - KERNEL) // STRIDE + 1
    maps, hidden = cfg["maps"], cfg["hidden"]
    rng = np.random.default_rng(cfg["weights_seed"])
    return {
        "conv": rng.normal(0.0, 1.0 / KERNEL, (maps, KERNEL, KERNEL)),
        "conv_b": rng.normal(0.0, 0.1, maps),
        "w1": rng.normal(0.0, 1.0 / np.sqrt(maps * oh * ow),
                         (hidden, maps, oh, ow)),
        "b1": rng.normal(0.0, 0.1, hidden),
        "w2": rng.normal(0.0, 1.0 / np.sqrt(hidden), (cfg["classes"], hidden)),
        "b2": rng.normal(0.0, 0.1, cfg["classes"]),
    }


def reference(image: np.ndarray, cfg: dict, precision: str = "float64") -> dict:
    """{output name: [slots] float64} for one image vector."""
    dt, r = arith(precision)
    w = {k: r(v.astype(dt)) for k, v in weights(cfg).items()}
    rows, cols = cfg["rows"], cfg["cols"]
    oh = (rows + 1 - KERNEL) // STRIDE + 1
    ow = (cols + 1 - KERNEL) // STRIDE + 1
    img = r(np.asarray(image, dtype=np.float64)[:rows * cols].astype(dt))
    padded = np.zeros((rows + 1, cols + 1), dtype=dt)
    padded[1:, 1:] = img.reshape(rows, cols)

    conv = np.zeros((cfg["maps"], oh, ow), dtype=dt)
    for a in range(KERNEL):
        for b in range(KERNEL):
            patch = padded[a:a + STRIDE * oh:STRIDE, b:b + STRIDE * ow:STRIDE]
            conv = r(conv + r(w["conv"][:, a, b, None, None] * patch))
    conv = r(conv + w["conv_b"][:, None, None])
    x = r(conv * conv).reshape(-1)

    w1 = w["w1"].reshape(cfg["hidden"], -1)
    h = w["b1"]
    for f in range(x.size):
        h = r(h + r(w1[:, f] * x[f]))
    h = r(h * h)

    logits = w["b2"]
    for f in range(h.size):
        logits = r(logits + r(w["w2"][:, f] * h[f]))
    out = logits.astype(np.float64)[np.arange(cfg["slots"]) % cfg["classes"]]
    return {cfg["output"]: out}
