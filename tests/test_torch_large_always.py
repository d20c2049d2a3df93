"""tests/test_large.py's Sobel 90x90 under its second default config
("always", "false": a rescale after every multiply; vec_size 8192,
N=16384) through the port, in a file of its own to keep each file under
40 s. test_torch_large.check_case holds the port's output on the CPU to
eva_tpu's numpy backend bit for bit and its decryption to the plaintext
reference."""

import torch

from test_torch_large import check_case

torch.set_num_threads(1)


def test_sobel_always_matches_eva_tpu():
    check_case("sobel_always")
