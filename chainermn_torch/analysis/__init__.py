"""graftlint for the port — AST-based repo-invariant analysis of
``chainermn_torch/`` (the port of ``chainermn_tpu/analysis``), and the
runtime concurrency sanitizer the fleet's and the scheduler's locks are
built through (:mod:`.sanitizer`).

The port's threaded subsystems (scheduler, fleet replica supervisors,
prefetcher, async checkpoint writer, watchdogs, the HTTP server) keep
invariants — lock coverage, no host syncs in hot loops, no hazards in
CUDA-graph capture bodies, lazy-import hygiene, cut-point and metric
naming — that runtime tests catch only when they happen to exercise the
bad interleaving. This package proves them *by construction*: a
stdlib-``ast`` pass over the whole tree that imports none of the code it
analyzes (no ``torch``, no ``numpy``; pinned by
``tests/test_torch_import_hygiene.py``).

The checkers ride one shared visitor framework (:mod:`.core`, copied from
the reference):

``lock-discipline`` / ``lock-order``
    Guarded-attribute discipline for classes owning a lock (the port's
    ``sanitizer.make_lock``/``make_rlock`` count as locks), and the
    cross-class lock-acquisition graph whose cycles are ABBA deadlocks.
``blocking-under-lock``
    Sleeps, file/socket I/O, thread joins, blocking queue ops and the
    port's device syncs (``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``torch.cuda.synchronize``, ``.synchronize()``) inside
    lock-held regions.
``thread-lifecycle``
    Every ``threading.Thread(...)`` is a daemon or joined on a
    stop/close-named path.
``host-sync``
    Syncs on step-program and model results inside the hot loops
    (decode, admission, replica drive, resilient fit, paged attend)
    unless routed through ``dataflow.device_fetch``.
``recompile-hazard``
    ``torch.compile`` in loops or hot bodies, compile-then-call, and
    host syncs or tensor branches inside CUDA-graph capture bodies.
``import-hygiene`` / ``consistency``
    The lazy-import rules (monitor/fleet/deploy never reach extensions;
    fleet/deploy never reach torch or serving at module level) and the
    cut-point/metric/event catalogs against their call sites, the port's
    tests and the README's port section.

Run it: ``python -m chainermn_torch.analysis chainermn_torch/`` (human or
``--json`` output, exit-code gating, fingerprint ``--baseline`` file,
``--runtime-report`` over a sanitizer artifact), or in-process via
:func:`run_analysis`. ``tests/test_torch_analysis.py`` runs the whole
suite over the port's tree as a tier-1 test.
"""

from chainermn_torch.analysis.core import (
    AnalysisResult,
    Checker,
    Finding,
    Module,
    Project,
    analyze_source,
    load_baseline,
    run_analysis,
)

from chainermn_torch.analysis import sanitizer

__all__ = [
    "AnalysisResult",
    "Checker",
    "Finding",
    "Module",
    "Project",
    "analyze_source",
    "load_baseline",
    "run_analysis",
]
