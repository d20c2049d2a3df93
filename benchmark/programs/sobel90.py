"""The Sobel filter as an EVA program: two 3x3 convolutions by rotations
and plaintext multiplies, then a cubic approximation of the gradient's
magnitude on its square.

A frozen copy of bench_torch.py's `build_sobel` (itself microsoft/EVA's
examples/image_processing.py Sobel, the program of
tests/large_programs.py's Sobel 90x90), with the sizes and scales read
from the configuration file."""

from eva_tpu_torch import EvaProgram, Input, Output

FILTER = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
# sqrt approximated by a degree-3 polynomial on the squared magnitude.
A1, A2, A3 = 2.2137874823876622, -1.0984324107372518, 0.17254603006834726


def build(cfg: dict) -> EvaProgram:
    w = cfg["cols"]
    prog = EvaProgram(cfg["name"], vec_size=cfg["slots"])
    with prog:
        image = Input(cfg["input"])
        Ix = Iy = None
        for i in range(3):
            for j in range(3):
                rotated = image << (i * w + j)
                horizontal = rotated * FILTER[i][j]
                vertical = rotated * FILTER[j][i]
                if Ix is None:
                    Ix, Iy = horizontal, vertical
                else:
                    Ix, Iy = Ix + horizontal, Iy + vertical
        x = Ix ** 2 + Iy ** 2
        Output(cfg["output"], x * A1 + x ** 2 * A2 + x ** 3 * A3)
    prog.set_input_scales(cfg["input_scale"])
    prog.set_output_ranges(cfg["output_range"])
    return prog
