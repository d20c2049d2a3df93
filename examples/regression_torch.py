"""Encrypted regression inference on the CUDA card, through `eva_torch`
(the PyTorch/CUDA port's `import eva` drop-in): the PLDI 2020 paper's
statistical workloads, the same three models, sizes and printed lines
as examples/regression.py:

  linear        y = b0 + sum_i b_i x_i           (p = 63 features)
  polynomial    y = b0 + sum_d b_d x^d           (degree 4)
  multivariate  y_j = b0_j + sum_i b_ij x_i      (p = 63, k = 4 outputs)

Each is compiled once, then run through the full HE pipeline
(keygen -> encrypt -> execute -> decrypt) on the CUDA device and checked
against the plaintext reference (MSE < 0.01). Without a CUDA device it
exits non-zero, unless run with --cpu (the plain PyTorch versions on
the host).

Run:  python examples/regression_torch.py [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eva_torch import EvaProgram, Input, Output, evaluate
from eva_torch.ckks import CKKSCompiler
from eva_torch.metric import valuation_mse
from eva_torch.seal import generate_keys

VEC = 2048
P_FEATURES = 63


def linear(p=P_FEATURES):
    prog = EvaProgram("linear_regression", vec_size=VEC)
    with prog:
        x = [Input(f"x{i}") for i in range(p)]
        e = Input("e")
        y = e + 6.56
        for i in range(p):
            y += x[i] * (i * 0.732)
        Output("y", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    inputs = {"e": [(VEC - i) * 0.001 for i in range(VEC)]}
    for i in range(p):
        inputs[f"x{i}"] = [i * j * 1e-5 for j in range(VEC)]
    return prog, inputs


def polynomial(degree=4):
    prog = EvaProgram("polynomial_regression", vec_size=VEC)
    with prog:
        x = Input("x")
        e = Input("e")
        y = e + 6.56
        for d in range(degree):
            y += x ** (d + 1) * (d * 0.732)
        Output("y", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    inputs = {"x": [i * 0.001 for i in range(VEC)],
              "e": [(VEC - i) * 0.001 for i in range(VEC)]}
    return prog, inputs


def multivariate(p=P_FEATURES, k=4):
    prog = EvaProgram("multivariate_regression", vec_size=VEC)
    with prog:
        x = [Input(f"x{i}") for i in range(p)]
        for j in range(k):
            y = Input(f"e{j}") + j * 0.56
            for i in range(p):
                y += x[i] * (k * i * 0.732)
            Output(f"y{j}", y)
    prog.set_input_scales(40)
    prog.set_output_ranges(30)
    inputs = {}
    for i in range(p):
        inputs[f"x{i}"] = [i * j * 1e-5 for j in range(VEC)]
    for j in range(k):
        inputs[f"e{j}"] = [(VEC - i) * j * 0.001 for i in range(VEC)]
    return prog, inputs


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the host")
    if parser.parse_args(argv).cpu:
        device = "cpu"
    if device is None:
        import torch
        if not torch.cuda.is_available():
            sys.exit("regression_torch: no CUDA device is available; pass "
                     "--cpu to run the plain PyTorch versions on the host")
    compiler = CKKSCompiler(config={"warn_vec_size": "false"})
    for build in (linear, polynomial, multivariate):
        prog, inputs = build()
        t0 = time.time()
        compiled, params, signature = compiler.compile(prog)
        t_compile = time.time() - t0
        public_ctx, secret_ctx = generate_keys(params, device=device)
        t0 = time.time()
        enc = public_ctx.encrypt(inputs, signature)
        out = secret_ctx.decrypt(public_ctx.execute(compiled, enc), signature)
        t_run = time.time() - t0
        mse = valuation_mse(out, evaluate(prog, inputs))
        print(f"{prog.name}: N={params.poly_modulus_degree} "
              f"Q={list(params.prime_bits)} compile={t_compile:.2f}s "
              f"enc+exec+dec={t_run:.2f}s MSE={mse:.3e}")
        assert mse < 0.01


if __name__ == "__main__":
    main()
