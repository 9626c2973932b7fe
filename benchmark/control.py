"""Readings that the correctness limits are set from, at a cell's own size:
for each seed, the program's compared numbers and the control's (the
reference in the next precision below the configuration's), each against
the f32 reference.

  python -m benchmark.control --workload <cell> --seeds <n> [<n> ...] [--fault NAME]

Serving checks as many clips as a window of BENCHMARK.json's run_seconds
starts, training the first three steps.  With `--fault` (benchmark/faults.py)
the fault is planted in the program and only the program's numbers are
read, as with `--no-control`.  One JSON line a seed; the benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.run import ROOT, Run, process_start


def readings(registry, name: str, seed: int, device: str, fault: str = None,
             control: bool = True, seconds: float = None) -> dict:
    import torch
    from benchmark.faults import planted
    cell = registry.cell(name)
    traffic = registry.traffic(cell["traffic"])
    run = Run(torch=torch, device=torch.device(device), cell=cell,
              config=registry.config(cell["config"]), traffic=traffic, seed=seed,
              seconds=registry.spec["run_seconds"] if seconds is None else seconds,
              trace=False, started=process_start())
    driver = registry.driver(traffic["kind"])
    if fault is None:
        return driver.control(run, fp8=control)
    with planted(traffic["kind"], fault):
        return driver.control(run, fp8=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--no-control", action="store_true",
                   help="read the program's numbers alone")
    args = p.parse_args(argv)
    from benchmark.registry import Registry
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(registry, args.workload, seed, "cuda", args.fault,
                       control=not args.no_control)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
