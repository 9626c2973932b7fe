"""Finds a cell's pieces by name, so that a new configuration, traffic mix,
metric, roofline formula or limit is a new file and no existing file
changes:

  BENCHMARK.json                the cells, configurations and metrics
  benchmark/configs/<c>.json    a configuration (its `file` in BENCHMARK.json)
  benchmark/traffic/<t>.json    a traffic mix; its "kind" names the driver
  benchmark/drivers/<kind>.py   the generator and window of that kind
  benchmark/metrics/<m>.py      the reader of metric <m>
  benchmark/roofline/<k>.py     kernel <k>'s operations and bytes
  benchmark/limits/<cell>.json  the cell's correctness limits
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Path, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.dir = Path(bench_dir) if bench_dir is not None else BENCH_DIR
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[Path, ModuleType] = {}

    # ---- BENCHMARK.json ----
    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, per_layer: bool) -> List[dict]:
        """The metrics a cell reports: end-to-end ones that list it or list
        no cells; per-layer ones that list it, or that list no cells and
        move an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not per_layer:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    # ---- files found by name ----
    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def driver(self, kind: str) -> ModuleType:
        return self._module("drivers", kind)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def roofline(self, kernel: str) -> ModuleType:
        return self._module("roofline", kernel)

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.dir / folder / f"{name}.json").read_text())

    def _module(self, folder: str, name: str) -> ModuleType:
        path = self.dir / folder / f"{name}.py"
        if path not in self._modules:
            if not path.is_file():
                raise FileNotFoundError(f"{folder} file for {name!r}: {path} is missing")
            spec = importlib.util.spec_from_file_location(
                f"benchmark._{folder}.{name.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]
