#!/usr/bin/env python3
"""What the port's spans (fsvid2vid_tpu_torch/utils/profiling.py) cost and
show in the benchmark's cells, on one card.

    python3 scripts/torch_span_turns.py [cell ...] [--seed N] [--turns N]

For each cell (default: all four of BENCHMARK.json), built, weighted and
warmed up as `python -m benchmark.run` builds it (benchmark/drivers/), the
benchmark's own traced segment (16 serving steps from a reset, or one
training sequence) runs in the turns off, on, on, off, ...: "off" with the
spans forced off under the profiler, "on" as the benchmark runs it.  It
prints per cell one JSON line with

  turns        each turn's host seconds (the segment's window_s) and busy s
  on_cost      median on / median off - 1
  serving      device ms per step under fsv.serve.step, under each
               fsv.gen.* span and under fsv::flash_ref_attention; the
               share the three stages cover; fsv. names among the busiest
               device operations
  training     from the recorder: median ms of a step, its forward phases
               (generate, d_losses, g_losses) and updates, the teacher, the
               sequence; the shares the predictions name
  cuda_only    a training sequence under a CUDA-only profiler (the training
               traffic's "host_ops": false): the fsv. events it holds, by
               device type
  clock        under a CPU + CUDA profiler, the largest gap between a span's
               recorded start and its profiler event's start on the trace's
               clock (kineto_results.trace_start_ns)
  off_ns       ns per call of a span with nothing recording
  on_ns        ns per call of a span under a CPU + CUDA profiler

Needs a CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import resource
import statistics
import sys
import time
import types
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.registry import Registry  # noqa: E402
from benchmark.run import Run  # noqa: E402
from fsvid2vid_tpu_torch.utils import profiling  # noqa: E402


@contextlib.contextmanager
def spans_forced_off():
    """Spans off although a profiler runs: `span` sees no profiler."""
    with mock.patch.object(profiling, "_autograd_profiler",
                           types.SimpleNamespace(_is_profiler_enabled=False)):
        yield


def turns(segment, n: int):
    """n traced segments in the turns off, on, on, off, ...: each turn's
    (kind, window_s, busy_s), and the first "on" turn's summary and span
    records."""
    rows, first_on = [], None
    for i in range(n):
        kind = "on" if i % 4 in (1, 2) else "off"
        profiling.clear()
        with spans_forced_off() if kind == "off" else contextlib.nullcontext():
            summary = segment()
        rows.append((kind, summary.window_s, summary.busy_s))
        if kind == "on" and first_on is None:
            first_on = (summary, profiling.spans())
        del summary
        gc.collect()
    return rows, first_on


def on_cost(rows) -> dict:
    med = lambda kind: statistics.median(w for k, w, _ in rows if k == kind)
    return {"off_s": med("off"), "on_s": med("on"), "on_cost": med("on") / med("off") - 1}


def fsv_device_ops(summary) -> list:
    return [n for n, _ in summary.breakdown()["device_ops"] if n.startswith("fsv.")]


def serving_view(summary) -> dict:
    steps = summary.ops("fsv.serve.step")
    inside = lambda name: [op for op in summary.ops(name) if any(
        s.start_us <= op.start_us and op.end_us <= s.end_us for s in steps)]
    per_step = lambda ops: sum(op.device_us for op in ops) / 1e3 / max(len(steps), 1)
    out = {"steps": len(steps), "step_device_ms": per_step(steps)}
    for name in ("fsv.gen.weights", "fsv.gen.flow", "fsv.gen.main",
                 "fsv::flash_ref_attention"):
        out[name] = per_step(inside(name))
    gen = sum(out[n] for n in ("fsv.gen.weights", "fsv.gen.flow", "fsv.gen.main"))
    out["gen_share_of_step"] = gen / out["step_device_ms"] if out["step_device_ms"] else None
    out["fsv_in_device_ops"] = fsv_device_ops(summary)
    return out


def training_view(summary, records) -> dict:
    from benchmark.program_spans import median_step_ms, step_phases
    ms = lambda r: (r.end_ns - r.start_ns) / 1e6
    by = lambda name: [ms(r) for r in records if r.name == name and r.end_ns]
    sequence = max(by("fsv.train.sequence"), default=None)
    teacher = sum(by("fsv.train.teacher"))
    step = median_step_ms(records, ["fsv.train.step"])
    forward = median_step_ms(records, ["fsv.train.generate", "fsv.train.d_losses",
                                       "fsv.train.g_losses"])
    update = median_step_ms(records, ["fsv.train.update_D", "fsv.train.update_G"])
    steps = step_phases(records)
    out = {"steps": len(steps), "step_ms": step, "forward_ms": forward, "update_ms": update,
           "teacher_ms": teacher, "sequence_ms": sequence,
           "phases_ms": {k: statistics.median(s.get(k, 0.0) for s in steps)
                         for k in sorted({k for s in steps for k in s})},
           "fsv_in_device_ops": fsv_device_ops(summary), "window_s": summary.window_s}
    if step and sequence:
        out["forward_update_share_of_step"] = (forward + update) / step
        out["steps_teacher_over_sequence"] = (len(steps) * step + teacher) / sequence
    return out


def cuda_only_events(call) -> dict:
    """The fsv. events of a CUDA-only profile of `call()`, by device type."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.name.startswith("fsv."):
            key = f"{e.name}@{str(e.device_type).split('.')[-1]}"
            names[key] = names.get(key, 0) + 1
    return names


def clock_gap(call) -> dict:
    """Recorder start against the profiler event's start, on the trace's
    clock, for every fsv. span of `call()` under a CPU + CUDA profiler."""
    from torch.profiler import ProfilerActivity, profile
    profiling.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events()
              if e.name.startswith("fsv.") and str(e.device_type).endswith("CPU")]
    records = profiling.spans()
    gaps = [abs((r.start_ns - origin) / 1e3 - e.time_range.start)
            for r, e in zip(records, sorted(events, key=lambda e: e.time_range.start))
            if r.name == e.name]
    return {"spans": len(records), "events": len(events), "matched": len(gaps),
            "max_gap_us": max(gaps, default=None),
            "origin_minus_time_ns_s": (origin - time.time_ns()) / 1e9}


def off_ns(n: int = 1_000_000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("fsv.x"):
            pass
    return (time.perf_counter_ns() - t0) / n


def on_ns(n: int = 20_000) -> float:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("fsv.x"):
                pass
        ns = (time.perf_counter_ns() - t0) / n
    profiling.clear()
    return ns


def run_of(registry, cell: str, seed: int) -> Run:
    c = registry.cell(cell)
    return Run(torch=torch, device=torch.device("cuda"), cell=c,
               config=registry.config(c["config"]), traffic=registry.traffic(c["traffic"]),
               seed=seed, seconds=30.0, trace=True, started=time.time())


def serving_cell(registry, run, n_turns: int) -> dict:
    from fsvid2vid_tpu_torch.inference.pipeline import InferencePipeline
    from fsvid2vid_tpu_torch.models.generator import FewShotGenerator
    drv = registry.driver("serve")
    cfg, _ = drv.configs(run)
    g = drv.build_generator(torch, cfg, run.traffic, run.seed, run.device, FewShotGenerator)
    pipe = InferencePipeline(cfg, g, compute_dtype=cfg.compute_dtype)
    clips = drv.Clips(torch, cfg, run.traffic, run.seed, run.device)
    drv.warm_up(run, pipe, clips)
    rows, (summary, _) = turns(lambda: drv.traced_segment(run, pipe, clips), n_turns)
    clip = clips.make(-3)

    def two_steps():
        pipe.reset(clip["ref_labels"], clip["ref_images"], clip["labels"][0])
        for t in range(2):
            pipe.step(clip["labels"][t])["fake_image"].cpu()
    out = {"serving": serving_view(summary), "clock": clock_gap(two_steps)}
    del pipe, g
    return out, rows


def training_cell(registry, run, n_turns: int) -> dict:
    drv = registry.driver("train")
    cfg, _, trainer, teacher, _ = drv.program(run)
    seqs = drv.Sequences(torch, cfg, run.traffic, run.seed, run.device)
    epoch = drv.epoch_of(cfg)
    index = iter(range(run.traffic["warmup_sequences"], 10 ** 6))
    with drv.no_epoch_checkpoint():
        trainer.train_epoch(epoch, [seqs.make(i) for i in range(run.traffic["warmup_sequences"])],
                            teacher)
        torch.cuda.synchronize()
        rows, (summary, records) = turns(
            lambda: drv.traced_segment(run, trainer, teacher, seqs, epoch, next(index)), n_turns)
        out = {"training": training_view(summary, records),
               "cuda_only": cuda_only_events(
                   lambda: trainer.train_epoch(epoch, [seqs.make(next(index))], teacher))}
    del trainer, teacher
    return out, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("cells", nargs="*")
    p.add_argument("--seed", type=int, default=8_100_000_017)
    p.add_argument("--turns", type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_turns: needs a CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT)
    cells = args.cells or [w["name"] for w in registry.spec["workloads"]]
    print(json.dumps({"name": torch.cuda.get_device_name(0), "off_ns": off_ns(),
                      "on_ns": on_ns()}), flush=True)
    for cell in cells:
        run = run_of(registry, cell, args.seed)
        kind = run.traffic["kind"]
        out, rows = (serving_cell if kind == "serve" else training_cell)(
            registry, run, args.turns)
        line = {"cell": cell, "turns": rows, **on_cost(rows), **out,
                "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
