"""Nothing a run loads may be JAX, the JAX package or the repository's
older bench scripts, by whole top-level name; the references load
nothing of the port."""

import subprocess
import sys

from harness import imports

from conftest import BENCH, ROOT


def test_whole_top_level_names():
    assert imports.top_level("eva_tpu_torch.backend.ks") == "eva_tpu_torch"
    assert imports.forbidden_loaded(["eva_tpu_torch", "eva_torch",
                                     "eva_tpu_torch.runtime", "benchmark"]) \
        == []
    assert imports.forbidden_loaded(["jax.numpy", "eva_tpu.ir", "eva",
                                     "bench_torch", "chip_smoke", "bench",
                                     "flax.linen", "jaxlib"]) == sorted(
        imports.FORBIDDEN)


def _loaded_after(code: str) -> set:
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
              "print(' '.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_run_loads_nothing_forbidden():
    mods = _loaded_after(
        "import run, harness.cell, harness.traffic, harness.trace\n"
        "from harness.loader import Benchmark\n"
        f"b = Benchmark({ROOT!r})\n"
        "for n in ('sobel90', 'harris64'):\n"
        "    b.module('programs', n); b.module('reference', n)\n"
        "for t in ('latency', 'stream'): b.loop(b.traffic(t))\n"
        "for g in ('end_to_end', 'per_layer'):\n"
        "    for m in b.spec[g]: b.reader(m['name'])\n"
        "import eva_tpu_torch.runtime, eva_tpu_torch.ckks, "
        "eva_tpu_torch.backend.executor_torch")
    assert "eva_tpu_torch" in mods
    assert imports.forbidden_loaded(mods) == []


def test_the_references_load_nothing_of_the_port():
    mods = _loaded_after(
        "from harness.loader import Benchmark\n"
        f"b = Benchmark({ROOT!r})\n"
        "import harness.decrypt, harness.seeding\n"
        "for n in ('sobel90', 'harris64'): b.module('reference', n)")
    tops = {imports.top_level(m) for m in mods}
    assert not tops & ({"eva_tpu_torch", "eva_torch", "torch"}
                       | imports.FORBIDDEN)
