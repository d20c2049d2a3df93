"""CryptoNets' MNIST network (Gilad-Bachrach et al., ICML 2016, section
4.1) as an EVA program on one encrypted image: a 5x5 stride-2
convolution of `maps` maps over the image padded with one row on top
and one column on the left, square, dense to `hidden`, square, dense
to `classes` logits.

A frozen copy of examples/cryptonets_torch.py's `build`, with the sizes,
scales, names and weight seed read from the configuration file.
Layout: the image in the first rows*cols slots, row-major; output (i, j)
of a map in slot 2i*cols + 2j; one rotation of the input per kernel
offset (a-1)*cols + (b-1), times a vector holding K[m, a, b] at the
output slots whose source pixel lies inside the image (the padding);
each dense output a masked product summed over every slot by a
rotate-and-sum; hidden unit o packed into slot o, logit c into every
slot p with p mod classes = c.

Weights: np.random.default_rng(weights_seed) draws conv kernels [maps,
5, 5], conv biases [maps], W1 [hidden, maps, oh, ow], b1 [hidden], W2
[classes, hidden], b2 [classes], in that order; kernels and matrices
normal with std 1/sqrt(fan-in), biases with std 0.1."""

import numpy as np

from eva_tpu_torch import EvaProgram, Input, Output

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


def build(cfg: dict) -> EvaProgram:
    rows, cols, vec_size = cfg["rows"], cfg["cols"], cfg["slots"]
    maps, hidden, classes = cfg["maps"], cfg["hidden"], cfg["classes"]
    w = weights(cfg)
    oh = (rows + 1 - KERNEL) // STRIDE + 1
    ow = (cols + 1 - KERNEL) // STRIDE + 1
    out_slot = (STRIDE * np.arange(oh)[:, None] * cols
                + STRIDE * np.arange(ow)[None, :])

    def vec(slots, values) -> list:
        v = np.zeros(vec_size)
        v[slots] = values
        return v.tolist()

    def rotate_and_sum(x):
        k = vec_size // 2
        while k:
            x = x + (x << k)
            k //= 2
        return x

    prog = EvaProgram(cfg["name"], vec_size=vec_size)
    with prog:
        image = Input(cfg["input"])
        conv = [None] * maps
        for a in range(KERNEL):
            for b in range(KERNEL):
                src_r = STRIDE * np.arange(oh) + a - 1
                src_c = STRIDE * np.arange(ow) + b - 1
                inside = (((src_r >= 0) & (src_r < rows))[:, None]
                          & ((src_c >= 0) & (src_c < cols))[None, :])
                offset = (a - 1) * cols + (b - 1)
                rot = image if offset == 0 else image << (offset % vec_size)
                for m in range(maps):
                    term = rot * vec(out_slot[inside], w["conv"][m, a, b])
                    conv[m] = term if conv[m] is None else conv[m] + term
        conv = [c + float(w["conv_b"][m]) for m, c in enumerate(conv)]
        squared = [c * c for c in conv]
        h = None
        for o in range(hidden):
            s = None
            for m in range(maps):
                term = squared[m] * vec(out_slot.ravel(),
                                        w["w1"][o, m].ravel())
                s = term if s is None else s + term
            unit = rotate_and_sum(s) * vec([o], 1.0)
            h = unit if h is None else h + unit
        h = h + vec(np.arange(hidden), w["b1"])
        h = h * h
        cls = np.arange(vec_size) % classes
        logits = None
        for c in range(classes):
            s = rotate_and_sum(h * vec(np.arange(hidden), w["w2"][c]))
            term = s * vec(np.flatnonzero(cls == c), 1.0)
            logits = term if logits is None else logits + term
        Output(cfg["output"], logits + w["b2"][cls].tolist())
    prog.set_input_scales(cfg["input_scale"])
    prog.set_output_ranges(cfg["output_range"])
    return prog
