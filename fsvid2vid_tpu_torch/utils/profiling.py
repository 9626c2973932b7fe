"""Tracing and profiling hooks (port of fsvid2vid_tpu/utils/profiling.py).

`span(name)` marks a phase of the program.  It is off unless a torch
profiler is active or `record(True)` was called; off, it returns one shared
no-op context after one check.  On, it opens `torch.profiler.record_function`
(so a profiler's trace places every kernel and idle gap under the phase)
and appends a `SpanRecord` to an in-memory recorder (`spans()`, `clear()`,
`self_ms(name)`).  Records carry the clock that the profiler's events
carry: Kineto converts its timestamps to wall-clock nanoseconds
(`time.time_ns()`), so a record minus the trace's
`kineto_results.trace_start_ns()` lands on the trace's own timeline.  Spans
never enter a `torch.export` program: they are off while one is traced.

`trace` writes a torch.profiler trace that TensorBoard's profiler plugin
and Perfetto / chrome://tracing read, `compiled_cost` counts a call's
floating-point operations, and `device_memory_stats` reads the allocator's
live, peak and limit bytes.

The spans, by layer:
  inference  fsv.serve.reset; fsv.serve.step > fsv.serve.handoff, its last
             child (the frame to the host)          (inference/pipeline.py)
  models     fsv.gen.weights, fsv.gen.flow, fsv.gen.main  (models/generator.py)
  training   fsv.train.sequence > fsv.train.wait, .to_device, .teacher,
             .step, .losses_to_host, .checkpoint    (training/trainer.py);
             fsv.train.step > fsv.train.generate, .d_losses, .update_D,
             .g_losses, .update_G, .finish          (training/step.py);
             below them fsv.train.refine_face (netGf, in generate),
             fsv.train.face_d (netDf, in d_losses and g_losses;
             losses/collector.py), fsv.train.recompute (each re-run of a
             remat region in a backward; models/remat.py) and, in a
             process group, fsv.train.all_reduce (in both updates;
             parallel/mesh.py)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_recording = False          # record(True): spans on without a profiler
_NOOP = contextlib.nullcontext()
_records: List["SpanRecord"] = []
_lock = threading.Lock()
_open = threading.local()   # per thread: the indices of its open spans


@dataclasses.dataclass
class SpanRecord:
    name: str
    parent: int       # index of the span open on the same thread when it began, or -1
    start_ns: int     # wall clock, the profiler's (time.time_ns)
    end_ns: int = 0   # 0 while the span is open


class _Span:
    __slots__ = ("name", "_rf", "_record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._record = SpanRecord(self.name, stack[-1] if stack else -1, time.time_ns())
        with _lock:
            stack.append(len(_records))
            _records.append(self._record)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._record.end_ns = time.time_ns()
        _open.stack.pop()
        return False


def span(name: str):
    """A context that marks `name` while a profiler runs or recording is on,
    else the shared no-op context."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NOOP
    return _Span(name)


def record(on: bool) -> bool:
    """Record spans (and open their profiler ranges) even with no profiler
    active, or stop doing so; returns the setting it replaces."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


def spans() -> List[SpanRecord]:
    """The records so far, in the order the spans began; a record's index in
    this list is what its children hold as `parent`."""
    return list(_records)


def clear() -> None:
    """Forget the records; call it with no span open."""
    with _lock:
        _records.clear()


def self_ms(name: str) -> List[float]:
    """Each ended span called `name`: its duration less the part of its
    interval that its child spans cover, in ms."""
    records = spans()
    children: Dict[int, List[SpanRecord]] = {}
    for r in records:
        if r.parent >= 0 and r.end_ns:
            children.setdefault(r.parent, []).append(r)
    out = []
    for i, r in enumerate(records):
        if r.name != name or not r.end_ns:
            continue
        covered, reach = 0, r.start_ns
        for c in sorted(children.get(i, []), key=lambda c: c.start_ns):
            start, end = max(c.start_ns, reach), min(c.end_ns, r.end_ns)
            if end > start:
                covered += end - start
                reach = end
        out.append((r.end_ns - r.start_ns - covered) / 1e6)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the host and, where there is one, the CUDA device while the
    block runs, into a `*.pt.trace.json` file under `log_dir`; no-op when
    log_dir is None.  The block's spans appear in it."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Floating-point operations of one call of `fn(*args, **kwargs)`, for
    speed-of-light comparisons: torch.utils.flop_counter.FlopCounterMode's
    count, which covers the matrix products and convolutions (2 per
    multiply-add) and nothing else.  Like XLA's cost analysis of the JAX
    function, which gives the Pallas call no estimate, it counts nothing
    for kernel B1.  The call runs once."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Live and peak bytes of the caching allocator and the device's bytes,
    per CUDA device (the replacement for nvidia-smi polling); empty without
    one."""
    stats = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return stats
