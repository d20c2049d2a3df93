"""One run of one cell: set-up, the measured window, the check, and the
result line.

Set-up (counted in setup_s, from the process's start to the first timed
request, less the kernel libraries' build, which is reported apart):
build or reuse the port's kernel libraries, compile the
configuration's program, generate keys on the device, encrypt the pool
of requests, run the entry once (the first call captures the CUDA
graph), and warm up with the mix itself. Then the window: the mix for
--seconds (or, traced, for the mix's trace_units under torch.profiler).
After it: the device's memory peak, the check of the loaded modules,
and the check of the outputs the window produced."""

from __future__ import annotations

import random
import sys
import time
from typing import Optional

import numpy as np

from . import imports, seeding, traffic
from .decrypt import Decryptor
from .loader import Benchmark
from .trace import WINDOW, TraceReading, profiler_events

LAUNCH_COUNTERS = (("ntt_cuda", "LAUNCHES"), ("ks_cuda", "LAUNCHES"),
                   ("modmath_cuda", "LAUNCHES"), ("ntt_shard_cuda", "LAUNCHES"))


def launches() -> int:
    """The port's own count of its CUDA kernel launches so far (each
    wrapper's LAUNCHES, which a graph replay adds its captured launches
    to)."""
    import importlib
    total = 0
    for mod, attr in LAUNCH_COUNTERS:
        m = importlib.import_module(f"eva_tpu_torch.backend.{mod}")
        total += sum(getattr(m, attr).values())
    return total


class Reading:
    """Everything a metric reader may read (metrics/<name>.py's
    read(reading) returns a number, or None where it finds nothing):

    completed, attempted, failed: requests of the window; window_s: its
    length on the host clock; latencies_s: each completed request's;
    setup_s, keygen_s, first_execute_s: set-up timers; launches: the
    port's kernel launches in the window; trace: a TraceReading of a
    traced window, else None."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _power_limit_w() -> Optional[float]:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def lines(err: np.ndarray, rows: int, cols: int) -> list:
    """The lines of an output's slots: each of the image's rows, each of
    its columns, and the slots after the image, if any, as one more."""
    img = err[:rows * cols].reshape(rows, cols)
    out = list(img) + list(img.T)
    if len(err) > rows * cols:
        out.append(err[rows * cols:])
    return out


def summarize(errors: list, rows: int, cols: int) -> dict:
    """The check's numbers from the gaps |got - reference| of each
    compared output (one array of slots each):

    line_p90_err: the largest, over the outputs and over each output's
      lines (the image's rows and columns, and the slots after it), of
      the 90th percentile of the line's gaps (compared against the
      limit: steady from seed to seed, and an output that is wrong in a
      tenth of any row or column moves it);
    p90_err: the largest, over the outputs, of the 90th percentile of an
      output's gaps over all its slots (reported: it misses a fault
      confined to under a tenth of an output);
    rms_err, max_err: the root mean square and the largest gap over every
      slot (reported only: they follow the few slots whose noise the
      polynomials amplify, swing from seed to seed, and the widest gap
      of the control is no larger than the program's);
    outputs_checked: how many outputs were compared."""
    if not errors:
        inf = float("inf")
        return {"line_p90_err": inf, "p90_err": inf, "rms_err": inf,
                "max_err": inf, "outputs_checked": 0}
    errs = [np.where(np.isfinite(e), np.abs(e), np.inf) for e in errors]
    allv = np.concatenate(errs)
    line = max(float(np.percentile(x, 90))
               for e in errs for x in lines(e, rows, cols))
    return {"line_p90_err": line,
            "p90_err": max(float(np.percentile(e, 90)) for e in errs),
            "rms_err": float(np.sqrt(np.mean(allv * allv))),
            "max_err": float(allv.max()), "outputs_checked": len(errs)}


def check_outputs(cfg: dict, reference, images: np.ndarray, sample: list,
                  secret_coeffs, primes_at_level) -> dict:
    """Decrypt the sampled outputs with the benchmark's own decryptor and
    compare them with the plain reference on the same images
    (summarize)."""
    dec = Decryptor(secret_coeffs)
    errors = []
    for i, val in enumerate(sample):
        if val is None:
            continue
        for name, expected in reference(images[i], cfg).items():
            ct = val[name]
            polys = getattr(ct, "polys", None)
            if polys is None:
                raise TypeError(f"output {name} is not a ciphertext")
            got = dec.decrypt(polys, primes_at_level(ct.level), ct.scale,
                              cfg["slots"])
            errors.append(got - np.asarray(expected, dtype=np.float64))
    return summarize(errors, cfg["rows"], cfg["cols"])


def control_outputs(cfg: dict, reference, images: np.ndarray,
                    precision: str) -> dict:
    """The check's numbers for the control: the reference computed at
    `precision` put in the program's place, on the same images."""
    errors = []
    for img in images:
        want = reference(img, cfg)
        for name, got in reference(img, cfg, precision).items():
            errors.append(got - want[name])
    return summarize(errors, cfg["rows"], cfg["cols"])


def _host() -> dict:
    """The host's CPUs this process may use and its load averages."""
    import os
    try:
        with open("/proc/loadavg") as f:
            load = [float(x) for x in f.read().split()[:3]]
    except (OSError, ValueError):
        load = None
    return {"cpus": len(os.sched_getaffinity(0)), "loadavg": load}


def _finite(x):
    """x, or None where it is not a finite number (JSON has no inf)."""
    return x if np.isfinite(x) else None


def run_cell(bench: Benchmark, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_origin: float, log=sys.stderr) -> dict:
    """One run; returns the result line as a dict (checks last)."""
    import torch

    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    clock = time.perf_counter
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    traffic.check_mix(mix)
    loop = bench.loop(mix)
    reference = bench.module("reference", cfg["reference"]).reference
    on_cuda = device.type == "cuda"

    parts = {"start_s": clock() - t_origin}
    t0 = clock()
    if on_cuda:
        from eva_tpu_torch.backend import cuda_lib
        cuda_lib.build_all()
    parts["build_s"] = clock() - t0
    seeding.seed_port_randomness(seed)
    t0 = clock()
    program = bench.module("programs", cfg["program"]).build(cfg)
    compiled, params, signature = CKKSCompiler(
        cfg.get("compiler_options", {})).compile(program)
    parts["compile_s"] = clock() - t0
    t0 = clock()
    server, secret = generate_keys(params, device=device)
    if on_cuda:
        torch.cuda.synchronize(device)
    keygen_s = parts["keygen_s"] = clock() - t0
    t0 = clock()
    images = seeding.image_pool(seed, mix["pool"], cfg["rows"],
                                cfg["cols"], cfg["slots"])
    requests = [server.encrypt({cfg["input"]: img}, signature)
                for img in images]
    parts["encrypt_s"] = clock() - t0

    first = traffic.Window(mix["pool"])
    t0 = clock()
    nxt = traffic.drive(loop, mix, server, compiled, requests, first,
                        traffic.until_units(1))
    first_execute_s = parts["first_execute_s"] = clock() - t0
    t0 = clock()
    warm = traffic.Window(mix["pool"])
    nxt = traffic.drive(loop, mix, server, compiled, requests, warm,
                        traffic.until_units(mix["warmup_units"]), nxt)
    parts["warmup_s"] = clock() - t0
    for stage in (first, warm):
        if stage.failed:
            raise RuntimeError(f"set-up: the server failed: {stage.errors}")

    window = traffic.Window(mix["pool"], random.Random(f"sample:{seed}"))
    if on_cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = launches()
    setup_s = clock() - t_origin - parts["build_s"]
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                traffic.drive(loop, mix, server, compiled, requests, window,
                              traffic.until_units(mix["trace_units"],
                                                  seconds), nxt)
        tr = TraceReading(*profiler_events(prof))
    else:
        traffic.drive(loop, mix, server, compiled, requests, window,
                      traffic.until_time(clock() + seconds), nxt)
    count = launches() - before
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    bad = imports.forbidden_loaded()
    if bad:
        raise ImportError(f"forbidden modules loaded: {bad}")

    reading = Reading(completed=window.completed, attempted=window.attempted,
                      failed=window.failed, window_s=window.seconds,
                      latencies_s=window.latencies, setup_s=setup_s,
                      keygen_s=keygen_s, first_execute_s=first_execute_s,
                      launches=count, trace=tr)
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"])(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ctx = server.ctx
    secret_coeffs = secret._keys.secret.coeffs
    sample, errors = window.sample, window.errors
    by_second = window.by_second()
    del server, requests, window
    t0 = clock()
    found = check_outputs(cfg, reference, images, sample, secret_coeffs,
                          ctx.primes_at_level)
    check_s = clock() - t0
    checks = {name: {"value": _finite(found[name]), "limit": limit}
              for name, limit in cfg["checks"].items()}
    checks["outputs_checked"] = {"value": found["outputs_checked"],
                                 "limit": mix["pool"]}
    correct = (reading.failed == 0
               and found["outputs_checked"] >= mix["pool"]
               and all(found[name] <= limit
                       for name, limit in cfg["checks"].items()))

    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    if on_cuda:
        dev["power_limit_w"] = _power_limit_w()
    out = {"correct": bool(correct), "attempted": reading.attempted,
           "failed": reading.failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = tr.breakdown()
    out["setup_parts"] = parts
    out["host"] = _host()
    out["requests_by_second"] = by_second
    out["errors"] = {k: _finite(v) for k, v in found.items()
                     if k != "outputs_checked"}
    out["check_s"] = check_s
    out["checks"] = checks
    if reading.failed:
        print(f"failed requests: {reading.failed}: {errors}", file=log)
    return out
