"""What every part of the benchmark shares: finding a cell's files by
name, seeds, the chip's published peaks and the result line.

A cell (``workloads/<name>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``);
the traffic names its driver (``drivers/<driver>.py``). A per-layer metric
is ``metrics/<name>.py``. Each is found by its name alone, so a new cell,
configuration, traffic mix, driver or metric is a new file.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

# Published dense peaks of one card (NVIDIA's data sheet, SXM part, no
# sparsity), keyed by the name torch.cuda.get_device_name() gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_per_s": 989e12,
                              "f32_flop_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}

# top-level module names that must not be loaded in a benchmark process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "chainermn_tpu")


def bench_dir(root: Path) -> Path:
    return Path(root) / "benchmark"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell_files(root: Path, workload: str) -> tuple[dict, dict, dict]:
    """The cell, its configuration and its traffic mix, by name."""
    b = bench_dir(root)
    cell = load_json(b / "workloads" / f"{workload}.json")
    config = load_json(b / "configs" / f"{cell['config']}.json")
    traffic = load_json(b / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def load_module(path: Path, name: str):
    """Import a file by path (names may hold dots and dashes)."""
    safe = "bench_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(safe, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(root: Path, name: str):
    return load_module(bench_dir(root) / "drivers" / f"{name}.py",
                       f"driver_{name}")


def metric_reader(root: Path, name: str):
    return load_module(bench_dir(root) / "metrics" / f"{name}.py",
                       f"metric_{name}")


def cell_metrics(man: dict, workload: str, section: str) -> list[dict]:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those listing it under ``workloads``, and the
    end-to-end ones without the key (every cell reports them)."""
    return [m for m in man[section]
            if "workloads" not in m or workload in m["workloads"]]


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and ``tags``."""
    h = hashlib.sha256(":".join(map(str, (int(seed),) + tags)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_MODULES`."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))

