"""Per-stage wall-clock profiling with the reference's stage taxonomy.

Re-design of ``util/accumulator.h`` (``AccumulatorData``: tick/tock into
boost accumulators with last/mean/var/min/max, accumulator.h:15-52) and
the console dashboard ``OdomNode::debug`` (odom.cc:1317-1461). Stage
names match the reference so profiles line up:

  total, odometry, dynamic                       (odom.cc:189-192)
  projectScan, projectResiduals, groundRemoval,
  cloudSegmentation, computeAllObjects, trackDetections
                                                 (detection.cpp:64-69)

Device work is asynchronous under JAX; ``tock`` therefore optionally
blocks on a result (``jax.block_until_ready``) so the measured interval
covers the device computation, and :func:`trace` hooks into
``jax.profiler`` TraceAnnotations for on-device timelines.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Dict, Optional

import jax

STAGES = (
    "total",
    "odometry",
    "dynamic",
    "projectScan",
    "projectResiduals",
    "groundRemoval",
    "cloudSegmentation",
    "computeAllObjects",
    "trackDetections",
)


class Accumulator:
    """last/mean/var/min/max of tick-tock intervals (accumulator.h:15-52)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self.last = 0.0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self, block_on: Any = None) -> float:
        if block_on is not None:
            jax.block_until_ready(block_on)
        assert self._t0 is not None, f"tock({self.name}) without tick"
        dt = (time.perf_counter() - self._t0) * 1e3  # ms
        self._t0 = None
        self.add(dt)
        return dt

    def add(self, value_ms: float) -> None:
        self.n += 1
        self.last = value_ms
        d = value_ms - self._mean
        self._mean += d / self.n
        self._m2 += d * (value_ms - self._mean)
        self.min = min(self.min, value_ms)
        self.max = max(self.max, value_ms)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def var(self) -> float:
        return self._m2 / self.n if self.n > 1 else 0.0

    def row(self) -> str:
        if self.n == 0:
            return f"{self.name:>20}:   (no samples)"
        return (
            f"{self.name:>20}: last {self.last:8.3f}  mean {self.mean:8.3f}"
            f"  var {self.var:8.3f}  min {self.min:8.3f}  max {self.max:8.3f}"
        )


class Profiler:
    """Named stage accumulators + dashboard (odom.cc:1387-1458)."""

    def __init__(self, stages=STAGES):
        self.acc: Dict[str, Accumulator] = {s: Accumulator(s) for s in stages}

    def __getitem__(self, name: str) -> Accumulator:
        if name not in self.acc:
            self.acc[name] = Accumulator(name)
        return self.acc[name]

    @contextlib.contextmanager
    def stage(self, name: str, block_on_result: bool = True):
        """``with prof.stage("odometry"): out = step(...)`` — also emits a
        jax.profiler TraceAnnotation so device traces carry the stage."""
        a = self[name]
        with jax.profiler.TraceAnnotation(name):
            a.tick()
            holder = _Holder()
            try:
                yield holder
            finally:
                a.tock(holder.value if block_on_result else None)

    def dashboard(self) -> str:
        lines = ["DDLO timing [ms]"]
        lines += [a.row() for a in self.acc.values() if a.n > 0]
        return "\n".join(lines)


def jax_annotation(name: str):
    """A bare jax.profiler TraceAnnotation (stage label on the device
    timeline) without the wall-clock accumulator — for pipelined loops
    that time dispatch-to-dispatch instead of blocking per scan."""
    return jax.profiler.TraceAnnotation(name)


class _Holder:
    """`with prof.stage(..) as h: h.value = out` to block on device work."""

    value: Any = None


@contextlib.contextmanager
def trace(dirname: str):
    """Capture a jax.profiler device trace around a block (the device
    equivalent of the reference's per-stage CPU accounting)."""
    jax.profiler.start_trace(dirname)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
