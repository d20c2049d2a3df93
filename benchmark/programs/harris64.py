"""Harris corner detection as an EVA program: Sobel gradients, three 3x3
box sums over their products, and the determinant/trace corner
response det - k * trace^2.

A frozen copy of bench_torch.py's `build_harris` (itself microsoft/EVA's
examples/image_processing.py Harris), with the sizes and scales read
from the configuration file."""

from eva_tpu_torch import EvaProgram, Input, Output

SOBEL = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
BOX = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]
K = 0.04


def build(cfg: dict) -> EvaProgram:
    w = cfg["cols"]
    prog = EvaProgram(cfg["name"], vec_size=cfg["slots"])
    with prog:
        image = Input(cfg["input"])

        def conv(img, filt, also_transposed=False):
            a = b = None
            for i in range(3):
                for j in range(3):
                    rot = img << (i * w + j)
                    hor = rot * filt[i][j]
                    a = hor if a is None else a + hor
                    if also_transposed:
                        ver = rot * filt[j][i]
                        b = ver if b is None else b + ver
            return (a, b) if also_transposed else a

        Ix, Iy = conv(image, SOBEL, also_transposed=True)
        Sxx = conv(Ix * Ix, BOX)
        Syy = conv(Iy * Iy, BOX)
        Sxy = conv(Ix * Iy, BOX)
        det = Sxx * Syy - Sxy * Sxy
        trace = Sxx + Syy
        Output(cfg["output"], det - K * trace * trace)
    prog.set_input_scales(cfg["input_scale"])
    prog.set_output_ranges(cfg["output_range"])
    return prog
