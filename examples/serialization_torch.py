"""The 4-role protocol end to end through serialized files, through
`eva_torch` (the PyTorch/CUDA port's `import eva` drop-in):
compile-time -> key-generation time -> client encrypt -> server execute
-> client decrypt, with every hand-off crossing a (simulated) machine
boundary. The same program, files and printed lines as
examples/serialization.py, in the JAX package's wire format.

Keys and the public context are built on the CUDA device. Without one
it exits non-zero, unless run with --cpu (the plain PyTorch versions on
the host). save/load go through the port's own wire codec and need no
protobuf.

Run:  python examples/serialization_torch.py [--cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from eva_torch import EvaProgram, Input, Output, evaluate, save, load
from eva_torch.ckks import CKKSCompiler
from eva_torch.seal import generate_keys
from eva_torch.metric import valuation_mse


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the plain PyTorch versions on the host")
    if parser.parse_args(argv).cpu:
        device = "cpu"
    if device is None:
        import torch
        if not torch.cuda.is_available():
            sys.exit("serialization_torch: no CUDA device is available; "
                     "pass --cpu to run the plain PyTorch versions on the "
                     "host")
    # -- Compile time --------------------------------------------------------
    poly = EvaProgram("Polynomial", vec_size=4096)
    with poly:
        x = Input("x")
        Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)

    compiler = CKKSCompiler(config={"warn_vec_size": "false"})
    compiled_poly, params, signature = compiler.compile(poly)

    tmp_dir = tempfile.mkdtemp()
    path = lambda name: os.path.join(tmp_dir, name)

    save(compiled_poly, path("poly.eva"))
    save(params, path("poly.evaparams"))
    save(signature, path("poly.evasignature"))

    # -- Key generation time -------------------------------------------------
    params = load(path("poly.evaparams"))
    public_ctx, secret_ctx = generate_keys(params, device=device)
    save(public_ctx, path("poly.evapublic"))
    save(secret_ctx, path("poly.evasecret"))

    # -- Runtime on client ---------------------------------------------------
    signature = load(path("poly.evasignature"))
    public_ctx = load(path("poly.evapublic"), device=device)
    inputs = {"x": [i / 4096 for i in range(signature.vec_size)]}
    enc_inputs = public_ctx.encrypt(inputs, signature)
    save(enc_inputs, path("poly_inputs.evavals"))

    # -- Runtime on server ---------------------------------------------------
    compiled_poly = load(path("poly.eva"))
    public_ctx = load(path("poly.evapublic"), device=device)
    enc_inputs = load(path("poly_inputs.evavals"))
    enc_outputs = public_ctx.execute(compiled_poly, enc_inputs)
    save(enc_outputs, path("poly_outputs.evavals"))

    # -- Back on client ------------------------------------------------------
    secret_ctx = load(path("poly.evasecret"))
    enc_outputs = load(path("poly_outputs.evavals"))
    outputs = secret_ctx.decrypt(enc_outputs, signature)

    reference = evaluate(compiled_poly, inputs)
    print("MSE", valuation_mse(outputs, reference))
    for f in os.listdir(tmp_dir):
        print(f"  {f}: {os.path.getsize(path(f))} bytes")


if __name__ == "__main__":
    main()
