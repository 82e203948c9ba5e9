"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its
configuration, its traffic mix and the driver the mix runs under (see
``harness/common.py``). With ``--trace 0`` the line carries the cell's
end-to-end metrics as ``BENCHMARK.json`` assigns them; with ``--trace 1``
the last part of the window is traced with ``torch.profiler`` and the
line carries the cell's per-layer metrics, each read by its own
``metrics/<name>.py``, and a breakdown of the traced stretch.

The run needs as many CUDA cards as the cell asks for and fails without
them. The last line on standard output is the result (one JSON object);
the numbers that decided ``correct`` close standard error and the line.
A run in which ``jax``, ``jaxlib``, ``flax`` or ``chainermn_tpu`` is
loaded fails without a result.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SECONDS = 5.0      # the traced stretch at the end of a --trace 1 window


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    trace_seconds: float
    device: object


class RunView:
    """What a per-layer metric's reader sees of a run: the cell, its
    configuration and traffic, the device, the driver's host readings
    (``host``) and the reduced trace (``trace``, or ``None``)."""

    def __init__(self, ctx: Context, out: dict, kind: str) -> None:
        self.cell, self.config, self.traffic = ctx.cell, ctx.config, \
            ctx.traffic
        self.device_kind = kind
        self.host = out.get("host", {})
        self.trace = out.get("trace")


def _paths(root: Path) -> None:
    """The program under test (at the checkout's root) and the harness
    (beside this file) importable."""
    for p in (str(ROOT), str(root), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device=None, with_info: bool = False):
    """Run the cell and return the result line as a dict (and, with
    ``with_info``, the driver's numeric host readings). ``device`` is the
    card the CLI checked for; tests pass ``"cpu"`` to drive the rest of a
    run without one."""
    _paths(root)
    import torch

    from harness.common import (
        PEAKS,
        cell_files,
        cell_metrics,
        driver,
        manifest,
        metric_reader,
    )

    cell, config, traffic = cell_files(root, workload)
    dev = torch.device(device if device is not None else "cuda:0")
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace),
                  trace_seconds=TRACE_SECONDS, device=dev)
    out = driver(root, traffic["driver"]).run(ctx)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    man = manifest(root)
    metrics = {}
    if trace:
        view = RunView(ctx, out, kind)
        for m in cell_metrics(man, workload, "per_layer"):
            value = metric_reader(root, m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_end"] - _T_START)
        for m in cell_metrics(man, workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
               "kind": kind, "count": int(cell["chips"]),
               "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": dev_rec}
    summary = out.get("trace")
    if trace and summary is not None:
        dev_rec["busy_s"] = summary.busy_s
        dev_rec["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checks"] = out["checks"]
    info = {k: v for k, v in out.get("host", {}).items()
            if isinstance(v, (int, float))}
    print("run: " + json.dumps(info), file=sys.stderr)
    if kind not in PEAKS and dev.type == "cuda":
        print(f"no published peaks for {kind!r}: roofline shares left out",
              file=sys.stderr)
    return (line, info) if with_info else line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths(ROOT)
    import torch

    from harness.common import cell_files, forbidden_loaded

    cell, _, _ = cell_files(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the card and has no "
              "CPU result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"modules that must not load were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
