"""Readings that set the limits of ``correct``; run on the card, not by
the benchmark's own runs.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--control-seeds 3] [--out FILE]

For each seed: one run of the cell (a short window at the cell's load,
its requests or steps checked as every run checks them), whose
readings are the program's. On the first ``--control-seeds`` seeds also
the control, the reference put in the program's place in float8 (e4m3)
matrix products, and the cell's planted faults, each read by the same
comparison against the float32 reference:

- serving: the control's reading is the widest gap of the token the
  float8 forward puts first; a token altered where it is produced is
  read by each served token replaced by the next id;
- training: the control trains in float8; half of the batch left out
  (the mean over the rest) is the reference on the first half of each
  batch; a state left unchanged reads 1 on ``change_norm_gap`` and
  needs no run.

One JSON line a seed goes to standard output (and ``--out``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import torch  # noqa: E402

import run  # noqa: E402
from harness import checks  # noqa: E402
from reference import gpt2  # noqa: E402

SERVED_LOGITS, TRAIN_REFERENCE = gpt2.served_logits, gpt2.train_reference


def _serve_hook(record: dict, control: bool):
    orig = SERVED_LOGITS

    def hooked(cfg, seed, seqs, starts, **kw):
        if not control:
            return orig(cfg, seed, seqs, starts, **kw)
        out = orig(cfg, seed, seqs, starts, precisions=("f32", "fp8"),
                   **{k: v for k, v in kw.items() if k != "precisions"})
        ref, low = out["f32"], out["fp8"]
        record["control_max_logit_gap"] = checks.widest_logit_gap(
            ref, [lg.argmax(dim=-1) for lg in low])
        vocab = ref[0].shape[-1]
        # the served tokens but the last are in the fed sequence
        altered = [(s[st + 1:].to(lg.device) + 1) % vocab
                   for s, st, lg in zip(seqs, starts, ref)]
        record["altered_token_max_logit_gap"] = checks.widest_logit_gap(
            [lg[:len(a)] for lg, a in zip(ref, altered)], altered)
        return {"f32": ref}

    return hooked


def _train_hook(record: dict, control: bool):
    orig = TRAIN_REFERENCE

    def readings(got, ref):
        keep = checks.moved_leaves(ref["grad_norms"])
        return {"loss_gap": checks.loss_gap(got["losses"], ref["losses"]),
                "grad_norm_gap": checks.leaf_gap(got["grad_norms"],
                                                 ref["grad_norms"])[0],
                "change_norm_gap": checks.leaf_gap(got["change_norms"],
                                                   ref["change_norms"],
                                                   keep)[0]}

    def hooked(cfg, seed, batches, opt, **kw):
        ref = orig(cfg, seed, batches, opt, **kw)
        if control:
            low = orig(cfg, seed, batches, opt, precision="fp8", **kw)
            record["control"] = readings(low, ref)
            b = batches[0][0].shape[0]
            half = orig(cfg, seed, batches, opt, rows=slice(0, b // 2), **kw)
            record["half_batch"] = readings(half, ref)
            record["state_unchanged"] = {"change_norm_gap": 1.0}
        return ref

    return hooked


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration reads the card; none present", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        record = {"workload": args.workload, "seed": seed}
        control = i < args.control_seeds
        gpt2.served_logits = _serve_hook(record, control)
        gpt2.train_reference = _train_hook(record, control)
        t0 = time.perf_counter()
        line, info = run.run_cell(args.workload, seed, args.seconds, False,
                                  with_info=True)
        record.update(wall_s=time.perf_counter() - t0,
                      correct=line["correct"], checks=line["checks"],
                      readings=info,
                      metrics=line["metrics"], attempted=line["attempted"],
                      failed=line["failed"],
                      memory_peak_bytes=line["device"]["memory_peak_bytes"],
                      card=torch.cuda.get_device_name(0))
        print(json.dumps(record), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(record) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
