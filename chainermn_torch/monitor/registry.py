"""Process-wide metrics registry: counters, gauges and histograms with
labels (the port's copy of ``chainermn_tpu/monitor/registry.py``).

Instruments are get-or-create, keyed by ``name`` + sorted labels.
Histograms keep a bounded reservoir of timestamped raw samples
(:meth:`Histogram.recent` reads a trailing window, as the time-series
collector and the SLO engine do); reports turn them into
``mean/p50/p99`` through :func:`latency_report`'s convention
(``_s``-suffixed for a ``unit='s'`` series). :meth:`MetricsRegistry.
instruments` lists every instrument, :meth:`MetricsRegistry.
snapshot` renders every instrument under its ``name{label="v"}`` key,
:meth:`MetricsRegistry.exposition` as Prometheus text, and
:func:`merge_rank_payloads` pools per-rank or per-replica payloads
(counters sum, gauges mean, reservoirs concatenate), as
:meth:`MetricsRegistry.aggregate` and the fleet report do.
"""

from __future__ import annotations

import re
import threading
import time
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


def _render_labels(lk: tuple) -> str:
    if not lk:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in lk) + "}"


def _sample_stats(samples, unit: str) -> dict:
    """``mean/p50/p99`` of a reservoir (``mean_s/p50_s/p99_s`` for a
    seconds-valued one); ``{}`` when it is empty."""
    if not len(samples):
        return {}
    if unit == "s":
        rep = latency_report(samples, "h")
        return {k[len("h_"):]: v for k, v in rep.items()}
    t = np.asarray(samples, np.float64)
    return {"mean": float(t.mean()), "p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99))}


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, labels_key: tuple) -> None:
        self.name = name
        self.labels_key = labels_key
        self._lock = threading.Lock()

    @property
    def key(self) -> str:
        return self.name + _render_labels(self.labels_key)


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
    ``_MAX_SAMPLES`` observations), each sample stamped with its
    ``time.monotonic()`` observation time for :meth:`recent`."""

    kind = "histogram"

    def __init__(self, name: str, labels_key: tuple, unit: str = "") -> None:
        super().__init__(name, labels_key)
        self.unit = unit
        self._samples: deque = deque(maxlen=_MAX_SAMPLES)
        # same maxlen, so the two rings stay aligned
        self._times: deque = deque(maxlen=_MAX_SAMPLES)
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float, t: Optional[float] = None) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._times.append(time.monotonic() if t is None else float(t))
            self._count += 1
            self._sum += v

    def recent(self, window_s: float, now: Optional[float] = None) -> list:
        """Retained samples observed within the last ``window_s`` seconds
        (``now`` defaults to ``time.monotonic()``): the collector's and
        the SLO engine's windowed input. A window wider than the
        reservoir's history returns what is retained."""
        cutoff = (time.monotonic() if now is None else now) - float(window_s)
        with self._lock:
            return [v for v, t in zip(self._samples, self._times)
                    if t >= cutoff]

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def samples(self) -> list:
        with self._lock:
            return list(self._samples)

    def stats(self) -> dict:
        return dict({"count": self._count, "sum": self._sum},
                    **_sample_stats(self.samples, self.unit))

    def percentile(self, q: float) -> float:
        samples = self.samples
        return float(np.percentile(samples, q)) if samples else 0.0


class MetricsRegistry:
    """Get-or-create instrument registry. The same ``(name, labels)``
    always returns the same instrument; the same name with a different
    kind raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[tuple, _Instrument] = {}

    def _get(self, cls, name: str, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], **kwargs)
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

    def histogram(self, name: str, labels: Optional[Mapping] = None, *,
                  unit: str = "") -> Histogram:
        return self._get(Histogram, name, labels, unit=unit)

    def instruments(self) -> list:
        """Every registered instrument, copied out under the registry's
        lock (the time-series collector and the SLO engine walk it)."""
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> dict:
        """Every instrument's state: ``{"counters": {key: int}, "gauges":
        {key: float}, "histograms": {key: {count, sum, mean, p50, p99}}}``
        with ``key`` the ``name{label="v",...}`` rendering."""
        insts = self.instruments()
        return {
            "counters": {i.key: int(i.value) for i in insts
                         if isinstance(i, Counter)},
            "gauges": {i.key: float(i.value) for i in insts
                       if isinstance(i, Gauge)},
            "histograms": {i.key: i.stats() for i in insts
                           if isinstance(i, Histogram)},
        }

    def _by_kind(self) -> tuple:
        insts = self.instruments()
        return ([i for i in insts if isinstance(i, Counter)],
                [i for i in insts if isinstance(i, Gauge)],
                [i for i in insts if isinstance(i, Histogram)])

    def exposition(self) -> str:
        """Prometheus text exposition: counters and gauges verbatim,
        histograms as summaries (``quantile`` series, then ``_sum`` and
        ``_count``), each name's ``# TYPE`` line before its first
        series."""
        counters, gauges, hists = self._by_kind()
        lines: list[str] = []
        seen_type: set[str] = set()

        def type_line(name: str, kind: str) -> None:
            if name not in seen_type:
                seen_type.add(name)
                lines.append(f"# TYPE {name} {kind}")

        for c in sorted(counters, key=lambda i: i.key):
            type_line(c.name, "counter")
            lines.append(f"{c.key} {int(c.value)}")
        for g in sorted(gauges, key=lambda i: i.key):
            type_line(g.name, "gauge")
            lines.append(f"{g.key} {float(g.value):g}")
        for h in sorted(hists, key=lambda i: i.key):
            type_line(h.name, "summary")
            for q in (0.5, 0.99):
                ql = self._with_label(h, "quantile", str(q))
                lines.append(f"{h.name}{ql} {h.percentile(q * 100):g}")
            suffix = _render_labels(h.labels_key)
            lines.append(f"{h.name}_sum{suffix} {h.sum:g}")
            lines.append(f"{h.name}_count{suffix} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def _with_label(inst: _Instrument, k: str, v: str) -> str:
        return _render_labels(tuple(sorted(inst.labels_key + ((k, v),))))

    def _rank_payload(self) -> dict:
        counters, gauges, hists = self._by_kind()
        return {
            "counters": {c.key: int(c.value) for c in counters},
            "gauges": {g.key: float(g.value) for g in gauges},
            "hist": {h.key: {"unit": h.unit, "count": h.count, "sum": h.sum,
                             "samples": h.samples} for h in hists},
        }

    def aggregate(self, comm) -> dict:
        """Fleet-wide snapshot over a communicator: one
        ``comm.allgather_obj`` of every rank's instruments, merged by
        :func:`merge_rank_payloads` (counters sum, gauges mean, histogram
        reservoirs pool). Every rank returns the same dict."""
        return merge_rank_payloads(comm.allgather_obj(self._rank_payload()))


def merge_rank_payloads(payloads: list) -> dict:
    """Pool per-rank (or per-replica) payloads ``{"counters", "gauges",
    "hist": {key: {unit, count, sum, samples}}}`` into one snapshot:
    counters sum, gauges mean, histogram reservoirs concatenate, so the
    pooled p50/p99 are over every payload's samples."""
    counters: dict[str, int] = {}
    gauge_vals: dict[str, list] = {}
    hist: dict[str, dict] = {}
    for p in payloads:
        for k, v in p.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + int(v)
        for k, v in p.get("gauges", {}).items():
            gauge_vals.setdefault(k, []).append(float(v))
        for k, h in p.get("hist", {}).items():
            ent = hist.setdefault(k, {"unit": h.get("unit", ""), "count": 0,
                                      "sum": 0.0, "samples": []})
            ent["count"] += int(h.get("count", 0))
            ent["sum"] += float(h.get("sum", 0.0))
            ent["samples"].extend(h.get("samples", ()))
    return {
        "ranks": len(payloads),
        "counters": counters,
        "gauges": {k: float(np.mean(v)) for k, v in gauge_vals.items()},
        "histograms": {
            k: dict({"count": e["count"], "sum": e["sum"]},
                    **_sample_stats(e["samples"], e["unit"]))
            for k, e in hist.items()},
    }


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "latency_report", "merge_rank_payloads"]
