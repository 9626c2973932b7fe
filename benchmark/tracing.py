"""The traced segment of a `--trace 1` run: torch.profiler over a few steps
after the measured window, reduced to what the per-layer readers take.

Device time is the union of the intervals in which any kernel, copy or
memset ran (summed durations would count overlapping streams twice); the
idle share is one minus that union over the segment's host-clock length.
The breakdown names the device operations that took most time and the
longest gaps in the union, each by the innermost host operation open when
the gap began.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# CUPTI's own records are not work, nor are the device-side copies of host
# ranges (record_function's annotations: the benchmark's "bench.*", the
# optimizer's "Optimizer.*")
_NOT_WORK = ("Activity Buffer Request", "Buffer Flush", "Command Buffer Full")
_ANNOTATIONS = ("bench.", "Optimizer.", "ProfilerStep")
TOP = 10


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    return sum(end - start for start, end in merged(intervals))


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle stretches between the union's pieces."""
    m = merged(intervals)
    return [(a[1], b[0]) for a, b in zip(m, m[1:]) if b[0] > a[1]]


@dataclass
class HostOp:
    name: str
    start_us: float
    end_us: float
    nested: bool                    # inside another operation of the same name
    device_us: float = 0.0          # device time of the kernels launched under it
    shapes: Optional[list] = None   # input shapes, as the profiler records them


@dataclass
class TraceSummary:
    window_s: float
    device: List[Tuple[float, float, str]]     # (start_us, end_us, name)
    host: List[HostOp]
    busy_s: float = 0.0
    counters: Dict[str, list] = field(default_factory=dict)

    def device_seconds(self, names) -> float:
        """Summed device time of the operations whose name holds any of `names`."""
        return sum(e - s for s, e, n in self.device if any(k in n for k in names)) / 1e6

    def ops(self, name: str) -> List[HostOp]:
        """The outermost host operations called `name`."""
        return [op for op in self.host if op.name == name and not op.nested]

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(gaps([(s, e) for s, e, _ in self.device]),
                         key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n[:120], s] for n, s in top_ops],
                "idle_gaps": [[self.host_op_at(a), (b - a) / 1e6] for a, b in longest]}

    def host_op_at(self, t_us: float) -> str:
        best = None
        for op in self.host:
            if op.start_us <= t_us < op.end_us and (best is None or op.start_us >= best.start_us):
                best = op
        return "python (no operator open)" if best is None else best.name[:120]


class Tracer:
    """`with Tracer(torch) as tr: ...` profiles the block; `tr.summary` holds
    the result once the block has ended with the device synchronised.
    `shapes` records the operators' input shapes (a roofline that reads a
    registered operator's shapes needs them; they cost host time).  Without
    `host_ops` only the device and the CUDA runtime's calls are traced: a
    step of many small operators then runs nearly as fast as untraced, and
    idle gaps are named by the runtime call the host was in."""

    def __init__(self, torch, shapes: bool = False, host_ops: bool = True):
        self.torch, self.shapes, self.host_ops = torch, shapes, host_ops
        self.summary: Optional[TraceSummary] = None
        self.counters: Dict[str, list] = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host_ops else [])
        self.prof = profile(activities=activities, record_shapes=self.shapes)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self.prof.events(), window_s)
            self.summary.counters = self.counters
        return False


def summarize(events, window_s: float) -> TraceSummary:
    from torch.autograd import DeviceType
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (e.name in _NOT_WORK or e.name.startswith(_ANNOTATIONS)
                    or getattr(e, "is_user_annotation", False)):
                device.append((start, end, e.name))
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None and not nested:
            nested = parent.name == e.name
            parent = parent.cpu_parent
        device_us = getattr(e, "device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "cuda_time_total", 0.0)
        host.append(HostOp(e.name, start, end, nested, float(device_us),
                           list(e.input_shapes) if e.input_shapes else None))
    summary = TraceSummary(window_s=window_s, device=device, host=host)
    summary.busy_s = union_length([(s, e) for s, e, _ in device]) / 1e6
    return summary
