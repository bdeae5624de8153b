"""Finding a cell's parts by name.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix and every metric. Each part is a file of its
own, found by its name:

  configuration  the `file` its `configs` entry gives (benchmark/configs/)
  engine         benchmark/engines/<the configuration's "engine">.py
  traffic mix    benchmark/traffic/<traffic>.json
  metric         benchmark/metrics/<metric name>.py, a reader with
                 `read(ctx) -> float | None` and, where it reads a range of
                 the program, `HOOKS`

so a cell or a metric is added by adding files and entries, not by editing
a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise SystemExit(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def engine(cfg: dict):
    return importlib.import_module(f"benchmark.engines.{cfg['engine']}")


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports: those
    without a `workloads` list, and those whose list names the cell."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The metric's reader module, loaded from benchmark/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
