"""Spread of a chip_smoke.py program's decrypted MSE over fresh keys.

Keys and encryption noise come from the OS CSPRNG, so the MSE against the
plaintext reference differs from run to run; this script draws it many
times to set bench_torch.MSE_LIMIT, which chip_smoke.py and the bench
hold. It runs the port's host numpy backend,
whose output ciphertexts chip_smoke.py holds bit-identical to the card's.

    python3 mse_draws.py harris 48
    python3 mse_draws.py sobel128 8
"""

import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_torch  # noqa: E402
from eva_tpu_torch import evaluate  # noqa: E402
from eva_tpu_torch.ckks import CKKSCompiler  # noqa: E402
from eva_tpu_torch.metric import valuation_mse  # noqa: E402
from eva_tpu_torch.runtime import generate_keys  # noqa: E402


def main(name: str, draws: int) -> None:
    build, seed = {"sobel": (bench_torch.build_sobel, 11),
                   "harris": (bench_torch.build_harris, 13),
                   "sobel128": (lambda: bench_torch.build_sobel(128, 128),
                                19)}[name]
    prog = build()
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(prog)
    rng = np.random.default_rng(seed)  # the image chip_smoke.py encrypts
    inputs = {"image": rng.uniform(0, 1, prog.vec_size).tolist()}
    ref = evaluate(prog, inputs)
    mses = []
    for _ in range(draws):
        pub, sec = generate_keys(params, backend="numpy")
        out = pub.execute(compiled, pub.encrypt(inputs, sig))
        mses.append(valuation_mse(sec.decrypt(out, sig), ref))
    print(f"{name} draws {draws} min {min(mses)!r} median "
          f"{statistics.median(mses)!r} max {max(mses)!r}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
