"""CryptoNets' MNIST network (Gilad-Bachrach et al., ICML 2016, section
4.1) in plain PyTorch, float64: the reference that
examples/cryptonets_torch.py's encrypted program is held to.

  F.pad (one row on top, one column on the left), conv2d with 5x5
  kernels at stride 2, square, linear, square, linear.

It shares nothing with the program but the weights' draw: no rotation,
no mask. It computes the network, then lays the logits out as the
program does: logit p mod classes in slot p of a vector of vec_size
slots. Imports torch and numpy only.
"""

import numpy as np
import torch
import torch.nn.functional as F

KERNEL = 5
STRIDE = 2
WEIGHTS_SEED = 2016


def weights(rows: int = 28, cols: int = 28, maps: int = 5,
            hidden: int = 100, classes: int = 10,
            weights_seed: int = WEIGHTS_SEED) -> dict:
    """The weights as float64 tensors, drawn from
    np.random.default_rng(weights_seed) in this order: conv kernels
    [maps, 5, 5], conv biases [maps], W1 [hidden, maps, oh, ow], b1
    [hidden], W2 [classes, hidden], b2 [classes]; kernels and matrices
    normal with std 1/sqrt(fan-in), biases normal with std 0.1."""
    oh = (rows + 1 - KERNEL) // STRIDE + 1
    ow = (cols + 1 - KERNEL) // STRIDE + 1
    fan_w1 = maps * oh * ow
    rng = np.random.default_rng(weights_seed)
    draws = {
        "conv": rng.normal(0.0, 1.0 / KERNEL, (maps, KERNEL, KERNEL)),
        "conv_b": rng.normal(0.0, 0.1, maps),
        "w1": rng.normal(0.0, 1.0 / np.sqrt(fan_w1), (hidden, maps, oh, ow)),
        "b1": rng.normal(0.0, 0.1, hidden),
        "w2": rng.normal(0.0, 1.0 / np.sqrt(hidden), (classes, hidden)),
        "b2": rng.normal(0.0, 0.1, classes),
    }
    return {k: torch.from_numpy(v) for k, v in draws.items()}


def network(image: torch.Tensor, w: dict) -> torch.Tensor:
    """Logits [classes] of one [rows, cols] image."""
    x = F.pad(image[None, None], (1, 0, 1, 0))  # left 1, right 0, top 1
    x = F.conv2d(x, w["conv"][:, None], w["conv_b"], stride=STRIDE)
    x = x * x
    x = F.linear(x.reshape(-1), w["w1"].reshape(w["w1"].shape[0], -1),
                 w["b1"])
    x = x * x
    return F.linear(x, w["w2"], w["b2"])


def reference(image, rows: int = 28, cols: int = 28, maps: int = 5,
              hidden: int = 100, classes: int = 10, vec_size: int = 1024,
              weights_seed: int = WEIGHTS_SEED) -> dict:
    """{"logits": [vec_size] float64 numpy}: the network on the image
    in the first rows*cols of `image`'s slots, logit p mod classes in
    slot p."""
    px = torch.as_tensor(np.asarray(image, dtype=np.float64)[:rows * cols])
    w = weights(rows, cols, maps, hidden, classes, weights_seed)
    logits = network(px.reshape(rows, cols), w)
    return {"logits": logits[torch.arange(vec_size) % classes].numpy()}
