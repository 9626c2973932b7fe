"""What the readers of the port's own spans share
(fsvid2vid_tpu_torch/utils/profiling.py `span`).

Serving: the device time of the kernels launched under a span in the
traced segment (host operations on), summed over the span's outermost
occurrences inside `fsv.serve.step`, per `fsv.serve.step`.

Training: the program's recorder (`profiling.spans()`), which is live
exactly while the traced segment's profiler runs, so it holds the one
traced sequence: per `fsv.train.step`, the host-clock ms of the step or of
some of its phases, their median over the steps.

Both read nothing (None) from a program without the spans."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

SERVE_STEP = "fsv.serve.step"
TRAIN_STEP = "fsv.train.step"


def device_ms_per_serve_step(r, name: str) -> Optional[float]:
    """Device ms under `name` inside the traced segment's serving steps, per
    step."""
    if r.trace is None:
        return None
    steps = r.trace.ops(SERVE_STEP)
    inside = [op for op in r.trace.ops(name)
              if any(s.start_us <= op.start_us and op.end_us <= s.end_us for s in steps)]
    device_us = sum(op.device_us for op in inside)
    if not steps or device_us <= 0:
        return None
    return device_us / 1e3 / len(steps)


def program_records() -> list:
    """The port's span records, or none where the port has no recorder."""
    try:
        from fsvid2vid_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def step_phases(records) -> List[Dict[str, float]]:
    """Per ended train step, ms by span name: the step's own under
    TRAIN_STEP, and its child spans' summed under their names."""
    steps: Dict[int, Dict[str, float]] = {}
    for i, rec in enumerate(records):
        if rec.name == TRAIN_STEP and rec.end_ns:
            steps[i] = {TRAIN_STEP: (rec.end_ns - rec.start_ns) / 1e6}
    for rec in records:
        if rec.parent in steps and rec.end_ns:
            phases = steps[rec.parent]
            phases[rec.name] = phases.get(rec.name, 0.0) + (rec.end_ns - rec.start_ns) / 1e6
    return list(steps.values())


def median_step_ms(records, names: Sequence[str]) -> Optional[float]:
    """Median over the train steps of the summed ms of `names` in each."""
    steps = step_phases(records)
    if not steps:
        return None
    return statistics.median(sum(s.get(n, 0.0) for n in names) for s in steps)
