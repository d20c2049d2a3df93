"""Homomorphic image processing on the CUDA card: Sobel edge detection and
Harris corner detection on an encrypted image, through `eva_torch` (the
PyTorch/CUDA port's `import eva` drop-in).

The same programs, synthetic 64x64 image, sizes and printed lines as
examples/image_processing.py; keys are generated and programs executed
on the CUDA device (the NTT, key-switch and elementwise CUDA kernels).
Without a CUDA device it exits non-zero, unless run with --cpu (the
plain PyTorch versions on the host).

Run:  python examples/image_processing_torch.py [--cpu] [image.png]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eva_torch import EvaProgram, Input, Output, evaluate
from eva_torch.ckks import CKKSCompiler
from eva_torch.seal import generate_keys
from eva_torch.metric import valuation_mse

h = w = 64


def load_image(path=None):
    if path:
        from PIL import Image
        img = Image.open(path).convert("L").resize((w, h))
        return (np.asarray(img, dtype=np.float64) / 255.0).reshape(-1)
    # Synthetic test card: gradient + circle + checkerboard corner.
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.5 + 0.5 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    img[(yy - 20) ** 2 + (xx - 40) ** 2 < 100] = 1.0
    img[(yy // 4 + xx // 4) % 2 == 0] *= 0.6
    return img.reshape(-1)


def convolution(image, width, filt):
    out = None
    for i in range(len(filt)):
        for j in range(len(filt[0])):
            rotated = image << (i * width + j)
            partial = rotated * filt[i][j]
            out = partial if out is None else out + partial
    return out


def convolutionXY(image, width, filt):
    Ix = Iy = None
    for i in range(len(filt)):
        for j in range(len(filt[0])):
            rotated = image << (i * width + j)
            horizontal = rotated * filt[i][j]
            vertical = rotated * filt[j][i]
            if Ix is None:
                Ix, Iy = horizontal, vertical
            else:
                Ix, Iy = Ix + horizontal, Iy + vertical
    return Ix, Iy


def build_sobel():
    prog = EvaProgram("sobel", vec_size=h * w)
    with prog:
        image = Input("image")
        sobel_filter = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
        # sqrt approximated by a degree-3 polynomial on the magnitude².
        a1 = 2.2137874823876622
        a2 = -1.0984324107372518
        a3 = 0.17254603006834726
        Ix, Iy = convolutionXY(image, w, sobel_filter)
        d = Ix ** 2 + Iy ** 2
        Output("image", d * a1 + d ** 2 * a2 + d ** 3 * a3)
    prog.set_input_scales(45)
    prog.set_output_ranges(20)
    return prog


def build_harris():
    prog = EvaProgram("harris", vec_size=h * w)
    with prog:
        image = Input("image")
        sobel_filter = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
        box = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]
        k = 0.04
        Ix, Iy = convolutionXY(image, w, sobel_filter)
        Sxx = convolution(Ix * Ix, w, box)
        Syy = convolution(Iy * Iy, w, box)
        Sxy = convolution(Ix * Iy, w, box)
        det = Sxx * Syy - Sxy * Sxy
        trace = Sxx + Syy
        Output("image", det - k * trace * trace)
    prog.set_input_scales(30)
    prog.set_output_ranges(20)
    return prog


def run(prog, inputs, device=None):
    reference = evaluate(prog, inputs)
    t0 = time.time()
    compiled, params, signature = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    t1 = time.time()
    public_ctx, secret_ctx = generate_keys(params, device=device)
    t2 = time.time()
    enc_inputs = public_ctx.encrypt(inputs, signature)
    enc_outputs = public_ctx.execute(compiled, enc_inputs)
    outputs = secret_ctx.decrypt(enc_outputs, signature)
    t3 = time.time()
    mse = valuation_mse(outputs, reference)
    print(f"{prog.name}: N={params.poly_modulus_degree} "
          f"Q={params.prime_bits} compile={t1-t0:.2f}s keygen={t2-t1:.2f}s "
          f"enc+exec+dec={t3-t2:.2f}s MSE={mse:.3e}")
    return outputs


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("image", nargs="?", help="a grayscale image")
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the host")
    args = parser.parse_args(argv)
    if args.cpu:
        device = "cpu"
    if device is None:
        import torch
        if not torch.cuda.is_available():
            sys.exit("image_processing_torch: no CUDA device is available; "
                     "pass --cpu to run the plain PyTorch versions on the "
                     "host")
    image = load_image(args.image)
    inputs = {"image": list(image)}
    run(build_sobel(), inputs, device)
    run(build_harris(), inputs, device)


if __name__ == "__main__":
    main()
