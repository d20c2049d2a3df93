"""The JAX package's HE matrix (tests/test_he.py:14-77) through the port:
binary ops over every plain/cipher pair of operands, unary ops (identity,
negation, cube, a constant) on plain and cipher inputs, rotations left
and right by -2..1, and mixed plain/cipher inputs. The rest of
test_he.py is in test_torch_he_rest.py (each file stays under 40 s).

Each case is one program of torch_random_programs.MATRIX. eva_tpu
generates the keys and encrypts, the port executes on the CPU (the plain
versions of every kernel); test_torch_executor.check_against_eva_tpu
holds its output to eva_tpu's numpy backend bit for bit and its
decryption to the plaintext reference."""

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
    _, params = check_against_eva_tpu(prog_j, prog_t, case.inputs(prog_t),
                                      case.config)
    if name == "minimum_rescaler":  # the pre-multiply operand rescale
        assert 30 in params.prime_bits, params.prime_bits


@pytest.mark.parametrize(
    "name", [n for n, c in MATRIX.items() if c.group == "he_ops"])
def test_he_ops_match_eva_tpu(name):
    check_case(name)
