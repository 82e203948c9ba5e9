"""Process-wide metrics registry: counters, gauges and histograms with
labels (the port's copy of ``chainermn_tpu/monitor/registry.py``, limited
to what the serving engine and its metrics write).

Instruments are get-or-create, keyed by ``name`` + sorted labels.
Histograms keep a bounded reservoir of raw samples; reports turn them
into ``mean/p50/p99`` through :func:`latency_report`'s convention.
"""

from __future__ import annotations

import re
import threading
from collections import deque
from typing import Mapping, Optional

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_MAX_SAMPLES = 4096


def latency_report(samples, prefix: str) -> dict[str, float]:
    """``{prefix}_mean_s`` / ``{prefix}_p50_s`` / ``{prefix}_p99_s`` from a
    list of second-valued samples; empty input returns ``{}`` (no samples
    is not 0 latency)."""
    if not len(samples):
        return {}
    t = np.asarray(samples, dtype=np.float64)
    return {
        f"{prefix}_mean_s": float(t.mean()),
        f"{prefix}_p50_s": float(np.percentile(t, 50)),
        f"{prefix}_p99_s": float(np.percentile(t, 99)),
    }


def _labels_key(labels: Optional[Mapping[str, str]]) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, labels_key: tuple) -> None:
        self.name = name
        self.labels_key = labels_key
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonic counter (requests served, steps run)."""

    kind = "counter"

    def __init__(self, name: str, labels_key: tuple) -> None:
        super().__init__(name, labels_key)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge(_Instrument):
    """Point-in-time value (queue depth now, blocks in use)."""

    kind = "gauge"

    def __init__(self, name: str, labels_key: tuple) -> None:
        super().__init__(name, labels_key)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram(_Instrument):
    """Distribution with a bounded raw-sample reservoir (the newest
    ``_MAX_SAMPLES`` observations)."""

    kind = "histogram"

    def __init__(self, name: str, labels_key: tuple) -> None:
        super().__init__(name, labels_key)
        self._samples: deque = deque(maxlen=_MAX_SAMPLES)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)

    @property
    def samples(self) -> list:
        with self._lock:
            return list(self._samples)


class MetricsRegistry:
    """Get-or-create instrument registry. The same ``(name, labels)``
    always returns the same instrument; the same name with a different
    kind raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[tuple, _Instrument] = {}

    def _get(self, cls, name: str, labels):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1])
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst

    def counter(self, name: str, labels: Optional[Mapping] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Mapping] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  labels: Optional[Mapping] = None) -> Histogram:
        return self._get(Histogram, name, labels)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "latency_report"]
