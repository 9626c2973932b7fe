"""What one run hands the metric readers, and the arithmetic of the window.

A metric file in benchmark/metrics/ defines `read(r: Readings)` and returns
a number, or None where the run has nothing for it to read (the harness
then leaves the metric out of the result line)."""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from benchmark.tracing import TraceSummary


@dataclass
class Step:
    start: float      # host clock, seconds
    end: float
    frames: int       # frames the step completed (serving: streams; training: batch)
    kind: str = "step"   # serving: "reset" for a clip's first step


@dataclass
class Readings:
    setup_s: float
    steps: List[Step]
    window_start: float
    window_end: float
    spans: Dict[str, List[float]] = field(default_factory=dict)    # host-clock ms
    flops: Dict[str, float] = field(default_factory=dict)          # per kind of step
    trace: Optional[TraceSummary] = None
    peaks: Dict[str, float] = field(default_factory=dict)            # benchmark/peaks.json
    roofline: Optional[Callable] = None    # kernel name -> its benchmark/roofline module

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def frames(self) -> int:
        return sum(s.frames for s in self.steps)

    def rate(self) -> float:
        """Frames completed in the window over the window's seconds."""
        return self.frames() / self.window_s

    def latencies_ms(self) -> List[float]:
        return [1e3 * (s.end - s.start) for s in self.steps]


def p95(values: List[float]) -> float:
    """The 95th percentile of all values (statistics.quantiles, 'inclusive':
    linear between order statistics, the sample's own range)."""
    if len(values) < 2:
        raise ValueError("a percentile needs two or more values")
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def spread(values: List[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (statistics.quantiles' default 'exclusive' method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
