"""Programs of torch_random_programs.random_case_wide through the port on
the CPU: the wider draws that test_fuzz.py never makes (vector sizes up
to 8192, sharded where wider than N/2; every rescaler; the security
levels; the fused and the structured key switch; alpha 1 and the
default), at N = 8192 and 16384 (N = 32768 takes ~8-18 s a program on
one CPU thread; tools/fuzz_cuda.py runs it on the card). The seed was
chosen so the six programs cover both key-switch routes, both alphas,
all four rescalers, a sharded vector and four programs with rotations.
eva_tpu's keys and ciphertexts, the port on the CPU, bit-identical to
eva_tpu's numpy backend (test_torch_executor.check_against_eva_tpu).
A file of its own to keep each file under 40 s."""

import functools
import random

import pytest
import torch

import eva_tpu
import eva_tpu_torch
import torch_random_programs as R
from test_torch_executor import check_against_eva_tpu

torch.set_num_threads(1)

WIDE_SEED = 0x5FA0
WIDE_N = (8192, 16384, 8192, 16384, 8192, 16384)


@functools.lru_cache(maxsize=None)
def _wide_draws():
    """Programs of random_case_wide at the ring sizes WIDE_N, in order:
    (eva_tpu program, port program, inputs, config, env)."""
    rng = random.Random(WIDE_SEED)
    draws = []
    for i, ring in enumerate(WIDE_N):
        other = random.Random()
        other.setstate(rng.getstate())
        prog_j, config, env, _ = R.random_case_wide(eva_tpu, rng, i, ring)
        prog_t, *same = R.random_case_wide(eva_tpu_torch, other, i, ring)
        assert same[:2] == [config, env]
        assert rng.getstate() == other.getstate()
        inputs = {name: [rng.uniform(-1, 1) for _ in range(prog_t.vec_size)]
                  for name in prog_t.inputs}
        draws.append((prog_j, prog_t, inputs, config, env))
    return draws


@pytest.mark.parametrize("index", range(len(WIDE_N)))
def test_he_roundtrip_wide(index):
    prog_j, prog_t, inputs, config, env = _wide_draws()[index]
    check_against_eva_tpu(prog_j, prog_t, inputs, config, env)


