"""Profiler annotations (the port's copy of
``chainermn_tpu/monitor/annotations.py``).

``annotate(name)`` names a host region for ``torch.profiler``: inside a
profile it enters :func:`torch.profiler.record_function`, so the region
shows on the host timeline with the device work it launched beneath it.
Entering a ``record_function`` costs about 10 µs even with no profiler
running, so the annotation first asks whether one is (a ~0.1 µs probe)
and does nothing else when none is: the annotations stay on for good in
the hot paths (the train steps, the serving engine's calls, the
communicator's collectives).

Put one around a host call that replays a captured step program, never
inside the body a program captures: there it would run only at capture.
"""

from __future__ import annotations


class _Annotation:
    """Single-use context manager; enters a ``record_function`` only
    while a profiler runs."""

    __slots__ = ("_name", "_rf")

    def __init__(self, name: str) -> None:
        self._name = name
        self._rf = None

    def __enter__(self) -> "_Annotation":
        # lazy: monitor stays importable without touching torch's
        # profiler until a region is entered
        import torch

        if torch._C._autograd._profiler_enabled():
            rf = torch.profiler.record_function(self._name)
            rf.__enter__()
            self._rf = rf
        return self

    def __exit__(self, *exc) -> None:
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)


def annotate(name: str) -> _Annotation:
    """Name a region for profiling::

        with monitor.annotate("chainermn.decode"):
            ...   # a host call that launches device work

    A no-op unless a ``torch.profiler`` profile is running.
    """
    return _Annotation(str(name))


__all__ = ["annotate"]
