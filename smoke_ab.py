#!/usr/bin/env python3
"""Times the whole chip_smoke.py of several checkouts, in turns, on one card.

    python3 smoke_ab.py [--out DIR] LABEL=ROOT [LABEL=ROOT ...]

Each ROOT is a checkout (a ``git archive`` unpacked under ``build/``,
which git ignores, serves). After a short warm-up (CUDA, cuDNN, cuBLAS,
SDPA and ``nvcc`` touched once), it runs ``python3 chip_smoke.py`` from
each ROOT in the order given, one after another, writes each run's
output to ``DIR/smoke_ab_LABEL.log`` (DIR defaults to ``build/smoke_ab``)
and prints one JSON line a run: its exit code, its command seconds (the
process's wall time) and the total of the phase seconds the script
printed, followed by the script's last two lines (the card's name and
power limit, and its ``{"ok": true, ...}`` line). A ROOT run twice
reuses the kernel libraries and native loaders its first run built under
``ROOT/build``; give each run its own ROOT to time the builds every
time. Two checkouts are only compared inside one such call.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
WARM = """
import torch, torch.nn.functional as F
x = torch.randn(8, 3, 64, 64, device="cuda")
F.conv2d(x, torch.randn(4, 3, 3, 3, device="cuda")).sum().item()
q = torch.randn(2, 4, 128, 64, device="cuda", dtype=torch.bfloat16)
F.scaled_dot_product_attention(q, q, q, is_causal=True).sum().item()
(q.flatten(0, 1) @ q.flatten(0, 1).transpose(1, 2)).sum().item()
import chainermn_torch
"""


def _warm_up(scratch: Path) -> dict:
    t0 = time.time()
    warm = subprocess.run([sys.executable, "-c", WARM], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    src = scratch / "smoke_ab_warm.cu"
    src.write_text("__global__ void k(float* x) { x[threadIdx.x] += 1.f; }\n")
    nvcc = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    try:
        nvcc_rc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o",
             str(scratch / "smoke_ab_warm.so"), str(src)],
            capture_output=True, text=True, timeout=600).returncode
    except FileNotFoundError:
        nvcc_rc = None
    return {"warmup_s": time.time() - t0, "warm_rc": warm.returncode,
            "nvcc_rc": nvcc_rc, "warm_err": warm.stderr[-500:]}


def main() -> int:
    args = sys.argv[1:]
    out = HERE / "build" / "smoke_ab"
    if args[:1] == ["--out"] and len(args) > 1:
        out, args = Path(args[1]).resolve(), args[2:]
    runs = [a.split("=", 1) for a in args]
    if not runs or any(len(r) != 2 for r in runs):
        print(__doc__, file=sys.stderr)
        return 2
    for _, root in runs:
        if not (Path(root) / "chip_smoke.py").is_file():
            print(f"smoke_ab: no chip_smoke.py in {root}", file=sys.stderr)
            return 2
    out.mkdir(parents=True, exist_ok=True)
    scratch = HERE / "build"
    scratch.mkdir(exist_ok=True)
    print(json.dumps(_warm_up(scratch)), flush=True)
    for label, root in runs:
        log = out / f"smoke_ab_{label}.log"
        t0 = time.time()
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"],
                                cwd=Path(root).resolve(), stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=1300).returncode
        took = time.time() - t0
        lines = log.read_text(errors="replace").splitlines()
        phases = next((json.loads(ln) for ln in lines
                       if ln.startswith('{"phase_seconds"')), {})
        print(json.dumps({"run": label, "root": root, "rc": rc,
                          "command_s": took,
                          "phases_total_s": phases.get("total_s")}),
              flush=True)
        for ln in lines[-2:]:
            print(ln, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
