"""Serving observability: latency histograms + counters (PyTorch port of
``utils/metrics.py``, a copy).

SURVEY.md §5 (metrics row): the reference's only latency signal is segment
timestamps; here the serving loops record structured per-chunk metrics —
wall latency percentiles, queue depths, underrun/overrun counts — the
BASELINE.json serving metrics.
"""

from __future__ import annotations

import json
import threading

import numpy as np


class LatencyHistogram:
    """Thread-safe fixed-capacity latency recorder (milliseconds)."""

    def __init__(self, capacity: int = 65536):
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            if self._n < len(self._buf):
                self._buf[self._n] = ms
            else:                      # reservoir-free: overwrite cyclically
                self._buf[self._n % len(self._buf)] = ms
            self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def percentiles(self, qs=(50, 99)) -> dict[str, float]:
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return {f"p{q}": float("nan") for q in qs}
            a = self._buf[:n]
            return {f"p{q}": float(np.percentile(a, q)) for q in qs}

    def summary(self) -> dict[str, float]:
        out = self.percentiles((50, 90, 99))
        with self._lock:
            n = min(self._n, len(self._buf))
            if n:
                out["max"] = float(self._buf[:n].max())
                out["mean"] = float(self._buf[:n].mean())
            out["count"] = self._n
        return out


class ServingMetrics:
    """Aggregate serving-side metrics, JSON-printable."""

    def __init__(self):
        self.chunk_latency = LatencyHistogram()
        self.dispatch_latency = LatencyHistogram()
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def to_dict(self) -> dict:
        return {
            "chunk_latency_ms": self.chunk_latency.summary(),
            "dispatch_latency_ms": self.dispatch_latency.summary(),
            "counters": dict(self.counters),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
