"""Structured per-phase timing spans.

Copy of `reflectionflow_tpu/utils/timing.py`: a span recorder that can be
summarized (p50/p90) and dumped as JSON. With `trace=True` each span is a
`torch.profiler.record_function` range, so it shows in a profiler trace.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    spans: dict[str, list[float]] = field(default_factory=lambda: defaultdict(list))
    # work counters (e.g. candidate images generated) — `rate(count, span)`
    # turns them into throughput for the SURVEY §5 candidates/sec metric
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    trace: bool = False
    # live=True prints each span as it closes (stderr)
    live: bool = False
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.trace:
            import torch

            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        dt = time.perf_counter() - t0
        with self._lock:
            self.spans[name].append(dt)
        if self.live:
            import sys

            print(f"[phase {name} #{len(self.spans[name])}] {dt:.2f}s",
                  file=sys.stderr, flush=True)

    def add_count(self, name: str, n: int) -> None:
        # a timer may be shared across threads: guard the read-modify-write
        with self._lock:
            self.counts[name] += int(n)

    def rate(self, count_name: str, span_name: str) -> float:
        """counts[count_name] per second of spans[span_name] (nan if empty)."""
        total = sum(self.spans.get(span_name, []))
        if not total or count_name not in self.counts:
            return float("nan")
        return self.counts[count_name] / total

    def percentile(self, name: str, q: float) -> float:
        xs = sorted(self.spans.get(name, []))
        if not xs:
            return float("nan")
        idx = min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def summary(self) -> dict:
        return {
            name: {
                "count": len(xs),
                "total_s": sum(xs),
                "p50_s": self.percentile(name, 50),
                "p90_s": self.percentile(name, 90),
            }
            for name, xs in self.spans.items()
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
