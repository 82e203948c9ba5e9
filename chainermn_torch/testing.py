"""Run a script on several local gloo ranks — the port's counterpart of
ChainerMN's ``mpiexec -n N`` test launches.

:func:`run_ranks` starts one Python process per rank with ``RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and a free
``MASTER_PORT`` set, so ``create_communicator(..., device="cpu")`` in the
script joins one gloo group. The script runs after a preamble that puts
the checkout on ``sys.path`` and defines ``RANK`` and ``save(obj)``;
``save`` hands one object back to the caller (``torch.save`` format).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

ROOT = Path(__file__).resolve().parents[1]

_PREAMBLE = """\
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
ARGS = sys.argv[3:]


def save(obj):
    torch.save(obj, os.path.join(sys.argv[2], f"rank{RANK}.pt"))


"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, world_size: int, *,
              local_world_size: Optional[int] = None,
              args: Sequence[str] = (), timeout: float = 300.0) -> list:
    """Run ``code`` on ``world_size`` gloo ranks and return what each
    rank passed to ``save`` (``None`` for a rank that saved nothing).
    Raises with the rank's standard error when a rank fails; every
    process is ended before it returns."""
    env = dict(os.environ, WORLD_SIZE=str(world_size),
               LOCAL_WORLD_SIZE=str(local_world_size or world_size),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as out:
        logs = [open(Path(out) / f"rank{r}.log", "w+")
                for r in range(world_size)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _PREAMBLE + code, str(ROOT), out,
             *map(str, args)],
            env=dict(env, RANK=str(r)), stdout=log, stderr=log)
            for r, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop at the first failure instead of at the time limit
            while (any(p.poll() is None for p in procs)
                   and not any(p.returncode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        # the rank that failed first, before the ranks killed after it
        bad = sorted((r for r, p in enumerate(procs) if p.returncode),
                     key=lambda r: procs[r].returncode < 0)
        if bad:
            r = bad[0]
            raise RuntimeError(f"rank {r} exited {procs[r].returncode}:\n"
                               f"{texts[r]}")
        paths = [Path(out) / f"rank{r}.pt" for r in range(world_size)]
        return [torch.load(p, weights_only=False) if p.exists() else None
                for p in paths]


__all__ = ["free_port", "run_ranks"]
