"""Find the benchmark's pieces by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix; each lives in files of
its own under the benchmark's folder, found by name:

  configs/<config>.json     sizes, scales, the program and reference to run
  programs/<module>.py      the EVA program (`build(cfg)`)
  reference/<module>.py     the plain NumPy filter (`reference(...)`)
  traffic/<mix>.json        a mix: the loop it runs and its parameters
  traffic/<loop>.py         a traffic loop (`drive(...)`, harness/traffic.py)
  metrics/<metric>.py       one reader per metric (`read(reading)`)

so that a later change adds a configuration, a mix or a metric as new
files and a new BENCHMARK.json entry, and edits nothing that is here."""

from __future__ import annotations

import importlib.util
import json
import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BenchmarkError(RuntimeError):
    """A name or file the benchmark needs is missing or malformed."""


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise BenchmarkError(f"{kind} name {name!r} is not a valid name")
    return name


def _read_json(path: str, what: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchmarkError(f"{what}: no file {path}") from None
    except json.JSONDecodeError as e:
        raise BenchmarkError(f"{what}: {path} is not JSON ({e})") from None


class Benchmark:
    """BENCHMARK.json at `root` (the checkout's root), with the folder of
    the benchmark's own files at `folder` (by default this one)."""

    def __init__(self, root: str, folder: str = HERE):
        self.root = root
        self.folder = folder
        self.spec = _read_json(os.path.join(root, "BENCHMARK.json"),
                               "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        _check_name("workload", name)
        for w in self.spec.get("workloads", []):
            if w["name"] == name:
                return w
        raise BenchmarkError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's entry in BENCHMARK.json merged under the
        contents of its file (the file's keys win)."""
        _check_name("config", name)
        for c in self.spec.get("configs", []):
            if c["name"] == name:
                cfg = _read_json(os.path.join(self.root, c["file"]),
                                 f"config {name}")
                cfg.setdefault("name", name)
                return cfg
        raise BenchmarkError(f"no config named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        _check_name("traffic", name)
        mix = _read_json(os.path.join(self.folder, "traffic", name + ".json"),
                         f"traffic {name}")
        mix.setdefault("name", name)
        return mix

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of `cell` reports: the end-to-end ones without
        a trace, the per-layer ones with it; each applies where it lists
        the cell, or everywhere when it lists no cells."""
        group = self.spec.get("per_layer" if trace else "end_to_end", [])
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def module(self, kind: str, name: str):
        """Import `<folder>/<kind>/<name>.py` by its path, under a module
        name of its own."""
        _check_name(kind, name)
        path = os.path.join(self.folder, kind, name + ".py")
        if not os.path.isfile(path):
            raise BenchmarkError(f"{kind}: no file {path}")
        spec = importlib.util.spec_from_file_location(
            f"_benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def loop(self, mix: dict):
        """The traffic loop that `mix` names (its "loop" key)."""
        name = mix.get("loop")
        if not isinstance(name, str):
            raise BenchmarkError(f"traffic {mix.get('name')}: no loop named")
        mod = self.module("traffic", name)
        if not callable(getattr(mod, "drive", None)):
            raise BenchmarkError(f"traffic/{name}.py has no drive()")
        return mod

    def reader(self, metric: str):
        mod = self.module("metrics", metric)
        if not callable(getattr(mod, "read", None)):
            raise BenchmarkError(f"metrics/{metric}.py has no read()")
        return mod.read
