"""In-process serving metrics with Prometheus text exposition (port of
``legalrag_tpu/utils/metrics.py``).

Thread-safe counters, gauges and fixed-bucket latency histograms, rendered
in the Prometheus text format by ``render()`` for ``GET /metrics``, with
the JAX package's metric names. No external dependency.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Tuple

_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hist: Dict[Tuple[str, Tuple], List] = {}

    # ------------------------------------------------------------- counters
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] += value

    # --------------------------------------------------------------- gauges
    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Last-write-wins point-in-time value (pool occupancy, queue
        depth) — rendered without the counter ``_total`` suffix."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value

    # ------------------------------------------------------------ histogram
    def observe(self, name: str, seconds: float, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            entry = self._hist.get(key)
            if entry is None:
                entry = [[0] * (len(_BUCKETS) + 1), 0.0, 0]  # buckets, sum, n
                self._hist[key] = entry
            buckets, _, _ = entry
            for i, ub in enumerate(_BUCKETS):
                if seconds <= ub:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            entry[1] += seconds
            entry[2] += 1

    def timed(self, name: str, **labels):
        metrics = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metrics.observe(name, time.perf_counter() - self.t0, **labels)

        return _Timer()

    # -------------------------------------------------------------- render
    def render(self) -> str:
        def fmt_labels(labels, extra=()):
            items = list(labels) + list(extra)
            if not items:
                return ""
            return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"

        lines: List[str] = []
        with self._lock:
            for (name, labels), value in sorted(self._counters.items()):
                lines.append(f"{name}_total{fmt_labels(labels)} {value:g}")
            for (name, labels), value in sorted(self._gauges.items()):
                lines.append(f"{name}{fmt_labels(labels)} {value:g}")
            for (name, labels), (buckets, total, count) in sorted(
                    self._hist.items()):
                cum = 0
                for ub, n in zip(_BUCKETS, buckets):
                    cum += n
                    lines.append(f"{name}_bucket"
                                 f"{fmt_labels(labels, (('le', ub),))} {cum}")
                cum += buckets[-1]
                lines.append(f'{name}_bucket{fmt_labels(labels, (("le", "+Inf"),))} {cum}')
                lines.append(f"{name}_sum{fmt_labels(labels)} {total:.6f}")
                lines.append(f"{name}_count{fmt_labels(labels)} {count}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()
