"""Encrypted CNN inference on the CUDA card: CryptoNets' MNIST network
(Gilad-Bachrach et al., ICML 2016, section 4.1) as an EVA program,
one image per ciphertext, through `eva_tpu_torch`.

The network, as CryptoNets runs it on encrypted data:

  1. convolution: the 28x28 image padded with one row on top and one
     column on the left (29x29), 5 maps of 5x5 kernels at stride 2,
     giving 5 x 13 x 13 = 845 values;
  2. square;
  3. dense 845 -> 100 (CryptoNets' pooling and second convolution
     collapsed into one linear layer);
  4. square;
  5. dense 100 -> 10: the logits (the sigmoid is dropped at inference).

The program's layout: the image fills slots 0..rows*cols-1 of a vector
of vec_size slots, row-major. Output (i, j) of a map lives in slot
2i*cols + 2j. The convolution takes one rotation of the input per
kernel offset (a-1)*cols + (b-1) and multiplies it by a vector that
holds K[m, a, b] at the output slots whose source pixel lies inside the
image, 0 elsewhere (that mask is the padding). Each dense output is a
masked product summed over all slots by a rotate-and-sum; hidden unit o
is packed into slot o by a one-hot vector, and logit c is written to
every slot p with p mod classes = c.

The weights are random, drawn by `weights` from
np.random.default_rng(weights_seed) in this order: conv kernels
[maps, 5, 5], conv biases [maps], W1 [hidden, maps, out, out], b1
[hidden], W2 [classes, hidden], b2 [classes]. Kernels and matrices are
normal with std 1/sqrt(fan-in), biases normal with std 0.1.
examples/cryptonets_reference.py is the network in plain PyTorch, with
the same draw.

Run:  python examples/cryptonets_torch.py [--cpu]

On the card by default (a full execute on the host's plain versions
takes minutes); without a CUDA device it exits non-zero, unless run with
--cpu.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eva_tpu_torch import EvaProgram, Input, Output  # noqa: E402

KERNEL = 5
STRIDE = 2
WEIGHTS_SEED = 2016
INPUT_SCALE = 40
OUTPUT_RANGE = 20


def conv_size(rows: int) -> int:
    """Outputs a side of the stride-2 5x5 convolution over the image
    padded with one row (column) before it."""
    return (rows + 1 - KERNEL) // STRIDE + 1


def weights(rows: int = 28, cols: int = 28, maps: int = 5,
            hidden: int = 100, classes: int = 10,
            weights_seed: int = WEIGHTS_SEED) -> dict:
    """The network's random weights, in the draw order the module's
    docstring gives."""
    oh, ow = conv_size(rows), conv_size(cols)
    fan_w1 = maps * oh * ow
    rng = np.random.default_rng(weights_seed)
    return {
        "conv": rng.normal(0.0, 1.0 / KERNEL, (maps, KERNEL, KERNEL)),
        "conv_b": rng.normal(0.0, 0.1, maps),
        "w1": rng.normal(0.0, 1.0 / np.sqrt(fan_w1), (hidden, maps, oh, ow)),
        "b1": rng.normal(0.0, 0.1, hidden),
        "w2": rng.normal(0.0, 1.0 / np.sqrt(hidden), (classes, hidden)),
        "b2": rng.normal(0.0, 0.1, classes),
    }


def _rotate_and_sum(x, vec_size: int):
    """Every slot of the result holds the sum of x's slots."""
    k = vec_size // 2
    while k:
        x = x + (x << k)
        k //= 2
    return x


def build(rows: int = 28, cols: int = 28, maps: int = 5, hidden: int = 100,
          classes: int = 10, vec_size: int = 1024,
          weights_seed: int = WEIGHTS_SEED, input_scale: int = INPUT_SCALE,
          output_range: int = OUTPUT_RANGE) -> EvaProgram:
    """CryptoNets' MNIST network on one encrypted image (the module's
    docstring gives the layout)."""
    if rows * cols > vec_size or hidden > vec_size:
        raise ValueError("the image and the hidden layer must fit in "
                         f"{vec_size} slots")
    w = weights(rows, cols, maps, hidden, classes, weights_seed)
    oh, ow = conv_size(rows), conv_size(cols)
    out_slot = (STRIDE * np.arange(oh)[:, None] * cols
                + STRIDE * np.arange(ow)[None, :])  # [oh, ow]

    def vec(slots, values) -> list:
        v = np.zeros(vec_size)
        v[slots] = values
        return v.tolist()

    prog = EvaProgram("cryptonets_mnist", vec_size=vec_size)
    with prog:
        image = Input("image")
        # Convolution: one rotation per kernel offset, shared by the maps.
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
                    term = rot * vec(out_slot[inside],
                                     w["conv"][m, a, b])
                    conv[m] = term if conv[m] is None else conv[m] + term
        conv = [c + float(w["conv_b"][m]) for m, c in enumerate(conv)]
        squared = [c * c for c in conv]
        # Dense maps*oh*ow -> hidden: unit o into slot o.
        h = None
        for o in range(hidden):
            s = None
            for m in range(maps):
                term = squared[m] * vec(out_slot.ravel(),
                                        w["w1"][o, m].ravel())
                s = term if s is None else s + term
            unit = _rotate_and_sum(s, vec_size) * vec([o], 1.0)
            h = unit if h is None else h + unit
        h = h + vec(np.arange(hidden), w["b1"])
        h = h * h
        # Dense hidden -> classes: logit c into every slot p = c mod classes.
        cls = np.arange(vec_size) % classes
        logits = None
        for c in range(classes):
            s = _rotate_and_sum(h * vec(np.arange(hidden), w["w2"][c]),
                                vec_size)
            term = s * vec(np.flatnonzero(cls == c), 1.0)
            logits = term if logits is None else logits + term
        Output("logits", logits + w["b2"][cls].tolist())
    prog.set_input_scales(input_scale)
    prog.set_output_ranges(output_range)
    return prog


def main(argv=None, device=None):
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the host")
    if parser.parse_args(argv).cpu:
        device = "cpu"
    if device is None:
        import torch
        if not torch.cuda.is_available():
            sys.exit("cryptonets_torch: no CUDA device is available; pass "
                     "--cpu to run the plain PyTorch versions on the host")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cryptonets_reference import reference

    prog = build()
    t0 = time.time()
    compiled, params, signature = CKKSCompiler(
        config={"warn_vec_size": "false"}).compile(prog)
    t_compile = time.time() - t0
    public_ctx, secret_ctx = generate_keys(params, device=device)
    image = np.zeros(prog.vec_size)
    image[:28 * 28] = np.random.default_rng(0).uniform(0.0, 1.0, 28 * 28)
    t0 = time.time()
    enc = public_ctx.encrypt({"image": image.tolist()}, signature)
    out = secret_ctx.decrypt(public_ctx.execute(compiled, enc), signature)
    t_run = time.time() - t0
    want = reference(image)["logits"]
    gap = np.abs(np.asarray(out["logits"]) - want)
    print(f"{prog.name}: N={params.poly_modulus_degree} "
          f"Q={list(params.prime_bits)} compile={t_compile:.2f}s "
          f"enc+exec+dec={t_run:.2f}s logits={np.round(want[:10], 4)} "
          f"max gap={gap.max():.3e}")
    assert gap.max() < 1e-3


if __name__ == "__main__":
    main()
