"""The rest of the JAX package's HE matrix (tests/test_he.py:80-150)
through the port: a high inner-term scale, a transparent ciphertext,
several outputs, horizontal_sum of a cipher, a plain and a constant
vector, the security levels 128, 192 (quantum-safe) and 256, and the
minimum rescaler (whose parameters must hold the pre-multiply 30-bit
rescale). TestNoiseEstimator is test_torch_noise.py's. Each case is one
program of torch_random_programs.MATRIX, checked as in test_torch_he.py."""

import pytest
import torch

from test_torch_he import check_case
from torch_random_programs import MATRIX

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "name", [n for n, c in MATRIX.items() if c.group == "he_rest"])
def test_he_programs_match_eva_tpu(name):
    check_case(name)
