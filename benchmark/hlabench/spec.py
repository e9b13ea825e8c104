"""``BENCHMARK.json`` and the files it names, found by name:

- a cell's configuration in ``benchmark/configs/<config>.json``;
- its traffic mix in ``benchmark/traffic/<traffic>.json``;
- its comparison limits in ``benchmark/limits/<cell>.json``;
- each per-layer metric's reader in ``benchmark/metrics/<metric>.py``
  (a ``read(record)`` that returns a number, or None where it finds
  nothing to read);
- each kernel's roofline arithmetic in ``benchmark/roofline/<kernel>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The manifest of `checkout`; the cells' files under `bench_dir`."""

    def __init__(self, checkout: str, bench_dir: str = HERE):
        self.checkout = checkout
        self.dir = bench_dir
        self.manifest = _json(os.path.join(checkout, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> tuple[dict, str]:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                path = os.path.join(self.checkout, c["file"])
                return _json(path), path
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.dir, "limits", f"{cell}.json"))

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", f"{metric}.py"),
                           f"hlabench_metric_{metric.replace('.', '_')}")


def roofline(kernel: str):
    return load_module(os.path.join(HERE, "roofline", f"{kernel}.py"),
                       f"hlabench_roofline_{kernel}")
