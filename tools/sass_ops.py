#!/usr/bin/env python3
"""The machine code of one kernel of the port, counted by opcode: builds
`eva_tpu_torch/csrc/<source>.cu` with nvcc for sm_90a (cuda_lib.build,
into a fresh directory under its build directory) and reads the
kernel's SASS with cuobjdump. Run on a machine with the CUDA toolkit,
from the root of a checkout:

    python3 tools/sass_ops.py modmath modmul_burn_kernel

Prints the kernel's SASS on stderr and one JSON line on stdout:
{"kernel", "instructions", "by_opcode"}; the counts are static (each
instruction once, as compiled), so an unrolled loop's body counts once
per unrolled step."""

import collections
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from eva_tpu_torch.backend import cuda_lib  # noqa: E402

INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def kernel_sass(lib: str, kernel: str) -> list:
    """The SASS lines of the one function of `lib` whose name holds
    `kernel`."""
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    functions = re.split(r"\n\s*Function : ", dump)[1:]
    found = [f for f in functions if kernel in f.split("\n", 1)[0]]
    if len(found) != 1:
        raise SystemExit(f"sass_ops: {len(found)} functions match {kernel}")
    return found[0].splitlines()


def main(source: str, kernel: str) -> int:
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        lib = cuda_lib.build(os.path.join(cuda_lib.CSRC, f"{source}.cu"),
                             os.path.join(tmp, f"{source}.so"))
        lines = kernel_sass(lib, kernel)
    ops = [m.group(1) for m in map(INSTRUCTION.search, lines) if m]
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps({"kernel": lines[0].strip(), "instructions": len(ops),
                      "by_opcode": dict(collections.Counter(ops)
                                        .most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
