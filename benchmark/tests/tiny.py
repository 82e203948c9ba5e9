"""Tiny presets of both configurations and cells over them, written into
a temporary root beside the benchmark's own files, for CPU tests of the
harness (not of speed)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY_CONFIG = {"name": "tiny", "model_type": "gpt2", "vocab_size": 97,
               "n_embd": 32, "n_layer": 2, "n_head": 4, "n_inner": 128,
               "n_positions": 64, "layer_norm_epsilon": 1e-06,
               "compute_dtype": "bfloat16", "reduced": [], "assumed": []}

TINY_TRAFFIC = {
    "tiny_serve": {"driver": "serve_closed", "clients": 3,
                   "context_tokens": 48, "pool": 16,
                   "prompt_tokens": {"median": 12, "sigma": 0.5, "min": 6,
                                     "max": 20},
                   "output_tokens": {"median": 14, "sigma": 0.5, "min": 8,
                                     "max": 24}},
    "tiny_train": {"driver": "train", "batch": 2, "seq_len": 16},
}

TINY_CELLS = {
    "tiny.serve": {
        "config": "tiny", "traffic": "tiny_serve", "chips": 1, "why": "t",
        "engine": {"n_slots": 3, "kv_block_size": 4, "cache_len": 48,
                   "prefill_buckets": [8, 16, 24], "prefill_batch": 1,
                   "paged": True, "paged_kernel": True, "capture": True},
        "scheduler": {"chunk_tokens_per_step": 8},
        # sound runs on the CPU read 0 to 6.6e-4
        "check": {"sample_requests": 5,
                  "limits": {"max_logit_gap": 0.002}}},
    "tiny.train": {
        "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "t",
        "attention": "flash",
        "optimizer": {"name": "AdamW", "lr": 0.001, "betas": [0.9, 0.95],
                      "eps": 1e-08, "weight_decay": 0.1},
        # set as the cells' limits are, from tiny readings on the CPU:
        # sound runs read loss 2e-5 to 5e-5, grad 1.3e-3 to 2.7e-3,
        # change 1.5e-3 to 1.9e-2; float8 loss 1.5e-4 to 4.9e-4; half the
        # batch grad 0.43 to 1.09, change 0.22 to 0.26
        "check": {"limits": {"loss_gap": 1e-4, "grad_norm_gap": 0.2,
                             "change_norm_gap": 0.1}}},
}


def make_root(tmp: Path, extra_metrics: dict | None = None) -> Path:
    """A root holding a copy of the benchmark's code and files, the tiny
    configuration, traffic and cells, and a manifest that lists the tiny
    cells under the real per-layer metrics (plus ``extra_metrics``:
    ``{name: source code}``, each added as a new file and entry)."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, t in TINY_TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, c in TINY_CELLS.items():
        (b / "workloads" / f"{name}.json").write_text(json.dumps(c))
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "t",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "t"})
    for name, c in TINY_CELLS.items():
        man["workloads"].append({"name": name, "config": c["config"],
                                 "traffic": c["traffic"], "chips": 1,
                                 "why": "t"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            kind = ".serve" if any(".serve" in w for w in m["workloads"]) \
                else ".train"
            m["workloads"].append("tiny" + kind)
    for name, src in (extra_metrics or {}).items():
        (b / "metrics" / f"{name}.py").write_text(src)
        man["per_layer"].append({"name": name, "unit": "%",
                                 "better": "higher", "source": "host_clock",
                                 "layer": "test", "moves": "setup_s",
                                 "workloads": list(TINY_CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
