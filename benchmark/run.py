"""One run of one cell of the port's benchmark.

  python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its weights and inputs on the
card from the seed, warms up the cell's shapes, measures for `--seconds`
(with `--trace 1`, a profiled segment follows the window), checks what the
window produced against the plain reference in benchmark/reference, and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` the `breakdown`, and last
`compared`, each compared number beside its limit (also the last lines on
standard error).  It refuses a host without the CUDA devices the cell asks
for, and it fails, printing no result, if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# build and kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run builds (the port builds its kernels into
# fsvid2vid_tpu_torch/build/ itself)
CACHES = {"TRITON_CACHE_DIR": BENCH_DIR / ".cache" / "triton",
          "TORCH_EXTENSIONS_DIR": BENCH_DIR / ".cache" / "torch_extensions"}
FORBIDDEN = ("jax", "jaxlib", "flax", "fsvid2vid_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc), or
    now where that cannot be read."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        for line in Path("/proc/stat").read_text().splitlines():
            if line.startswith("btime "):
                return int(line.split()[1]) + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: fsvid2vid_tpu_torch is not fsvid2vid_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


@dataclass
class Run:
    """What a driver gets: the cell's files, the seed, the device."""
    torch: object
    device: object
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    started: float                      # wall clock at process start
    log: Callable[[str], None] = field(default=lambda msg: print(msg, file=sys.stderr))

    def setup_s(self, window_start_perf: float) -> float:
        """Process start to the window's start."""
        return time.time() - (time.perf_counter() - window_start_perf) - self.started

    def synchronize(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0

    def empty_cache(self):
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def run_cell(registry, name: str, seed: int, seconds: float, trace: bool, device,
             started: Optional[float] = None, limits: Optional[dict] = None) -> dict:
    """The result of one run of cell `name` on `device` (the harness's look
    for a chip is the caller's)."""
    import torch
    cell = registry.cell(name)
    traffic = registry.traffic(cell["traffic"])
    run = Run(torch=torch, device=torch.device(device), cell=cell,
              config=registry.config(cell["config"]), traffic=traffic, seed=seed,
              seconds=seconds, trace=trace,
              started=process_start() if started is None else started)
    out = registry.driver(traffic["kind"]).execute(run)
    readings = out["readings"]
    lat = sorted(readings.latencies_ms())
    run.log(f"window: {len(lat)} steps in {readings.window_s:.3f} s, step ms median "
            f"{lat[len(lat) // 2]:.2f} max {lat[-1]:.2f}, steps' share of the window "
            f"{sum(lat) / 1e3 / readings.window_s:.4f}")
    readings.peaks = json.loads((BENCH_DIR / "peaks.json").read_text())
    readings.roofline = registry.roofline
    metrics = {}
    for m in registry.metrics(name, per_layer=trace):
        value = registry.metric(m["name"]).read(readings)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = registry.limits(name) if limits is None else limits
    compared = {k: {"value": out["compared"][k], "limit": v} for k, v in limits.items()}
    run.log("readings beside the compared ones: " + json.dumps(
        {k: v for k, v in out["compared"].items() if k not in limits}))
    correct = (out["failed"] == 0 and out["checked"] > 0 and
               all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for c in compared.values()))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info(torch, run, out, readings)}
    if trace and readings.trace is not None:
        result["breakdown"] = readings.trace.breakdown()
    result["checked_frames"] = out["checked"]
    result["compared"] = compared
    return result


def device_info(torch, run: Run, out: dict, readings) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": run.cell["chips"]}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = out["memory_peak_bytes"]
    if run.trace and readings.trace is not None:
        info.update(busy_s=readings.trace.busy_s, window_s=readings.trace.window_s)
    return info


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHES.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    from benchmark.registry import Registry
    registry = Registry(ROOT)
    cell = registry.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this host has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(registry, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; nothing it runs may import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for key, c in result["compared"].items():
        print(f"compared {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
