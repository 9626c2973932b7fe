"""Tracing and profiling hooks (port of fsvid2vid_tpu/utils/profiling.py).

`trace` writes a torch.profiler trace that TensorBoard's profiler plugin
and Perfetto / chrome://tracing read, `StepTimer` keeps per-step
host-clock times, `compiled_cost` counts a call's floating-point
operations, and `device_memory_stats` reads the allocator's live, peak and
limit bytes.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the host and, where there is one, the CUDA device while the
    block runs, into a `*.pt.trace.json` file under `log_dir`; no-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Rolling per-step timing (reference trainer.py:43-44,58-61)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


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
