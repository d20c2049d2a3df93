"""The image example's programs (examples/image_processing_torch.py,
through eva_torch) against the JAX package's example
(examples/image_processing.py, through eva): Sobel and Harris on the
example's 64x64 synthetic image (N=16384), each built by both examples'
builders and held by test_torch_executor.check_against_eva_tpu (residues
and level equal to eva_tpu's numpy backend on its keys and ciphertexts,
carried over; decryption within MSE 0.01). Apart from
test_torch_examples.py for time: each file stays under 40 s."""

import pytest
import torch

from test_torch_examples import CONFIG, load_example
from test_torch_executor import check_against_eva_tpu

torch.set_num_threads(1)


@pytest.mark.parametrize("build", ["build_sobel", "build_harris"])
def test_image_processing_programs(build):
    jax_ex, port_ex = load_example("image_processing"), load_example(
        "image_processing_torch")
    assert (jax_ex.h, jax_ex.w) == (port_ex.h, port_ex.w) == (64, 64)
    image = port_ex.load_image()
    assert (image == jax_ex.load_image()).all()
    check_against_eva_tpu(getattr(jax_ex, build)(), getattr(port_ex, build)(),
                          {"image": list(image)}, CONFIG)
