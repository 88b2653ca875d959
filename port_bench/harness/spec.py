"""The cell's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its loop
(``loops/<loop>.py``); every metric is a reader of its own
(``metrics/<name>.py``).  A new cell, mix, configuration or metric is new
files and entries, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path):
    name = "port_bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    loop and metric entries."""

    def __init__(self, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.name, self.entry, self.bench_dir = name, cells[name], bench_dir
        self.chips = int(self.entry["chips"])
        self.config = json.loads((bench_dir / "configs" / f"{self.entry['config']}.json")
                                 .read_text())
        self.traffic = json.loads((bench_dir / "traffic" / f"{self.entry['traffic']}.json")
                                  .read_text())

    def loop(self):
        return load_module(self.bench_dir / "loops" / f"{self.traffic['loop']}.py")

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if _applies(m, self.name)]

    def per_layer(self) -> list:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def reader(self, metric: dict):
        return load_module(self.bench_dir / "metrics" / f"{metric['name']}.py").read
