"""Host-clock ms a train step spends under one of the port's spans that
nest below the step's phases (fsv.train.refine_face below generate,
fsv.train.face_d below d_losses and g_losses, fsv.train.recompute below the
updates' backward), from the program's recorder
(benchmark/program_spans.py `program_records`), which holds the traced
sequence.

A record belongs to the train step (fsv.train.step) that its parents lead
to.  A backward that runs on autograd's own thread (a CUDA device's) opens
its spans with no parent: such a root record belongs to the step whose
host-clock interval holds its start.  Only a name's outermost records
count.  Per step the ms are summed; the reading is their median over the
steps, a step without the span counting 0, and None where no step has it
(a program without the span)."""
from __future__ import annotations

import statistics
from typing import Dict, Optional

from benchmark.program_spans import TRAIN_STEP, program_records


def step_of(records, i: int, steps: Dict[int, object]) -> Optional[int]:
    """The index of the train step record i belongs to, or None."""
    rec, j = records[i], records[i].parent
    while j >= 0:
        if j in steps:
            return j
        j = records[j].parent
    for s, step in steps.items():
        if step.start_ns <= rec.start_ns < step.end_ns:
            return s
    return None


def median_step_ms(name: str, records=None) -> Optional[float]:
    records = program_records() if records is None else records
    steps = {i: r for i, r in enumerate(records) if r.name == TRAIN_STEP and r.end_ns}
    per_step = dict.fromkeys(steps, 0.0)
    found = False
    for i, rec in enumerate(records):
        if rec.name != name or not rec.end_ns or _inside_same(records, i):
            continue
        s = step_of(records, i, steps)
        if s is not None:
            per_step[s] += (rec.end_ns - rec.start_ns) / 1e6
            found = True
    return statistics.median(per_step.values()) if found else None


def _inside_same(records, i: int) -> bool:
    j = records[i].parent
    while j >= 0:
        if records[j].name == records[i].name:
            return True
        j = records[j].parent
    return False
