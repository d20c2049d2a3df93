"""The JAX package's batched regressions (tests/test_large.py:57) through
the port: the linear, polynomial and multivariate regressions at
vec_size 512 with the reference's inputs. Sobel 90x90 under the two
default configs of tests/test_large.py:40 is in test_torch_large_sobel.py
and test_torch_large_always.py, one file each: they take ~13 and ~18 s on
one CPU thread, and each file stays under 40 s. Programs and inputs are
torch_random_programs.MATRIX's (group "large");
test_torch_executor.check_against_eva_tpu holds the port's output on the
CPU to eva_tpu's numpy backend bit for bit and its decryption to the
plaintext reference."""

import pytest
import torch

import eva_tpu
import eva_tpu_torch
from test_torch_executor import check_against_eva_tpu
from torch_random_programs import MATRIX

# Small tensors: one intra-op thread per test worker avoids
# oversubscribing the cores when the suite runs workers in parallel.
torch.set_num_threads(1)


def check_case(name):
    case = MATRIX[name]
    prog_j, prog_t = case.build(eva_tpu), case.build(eva_tpu_torch)
    check_against_eva_tpu(prog_j, prog_t, case.inputs(prog_t), case.config)


@pytest.mark.parametrize("name", ["linear_regression", "polynomial_regression",
                                  "multivariate_regression"])
def test_regression_matches_eva_tpu(name):
    check_case(name)
