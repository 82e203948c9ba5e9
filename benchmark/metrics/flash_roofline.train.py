"""The flash kernels' share of their roofline in training: the
operations the traced steps' causal attention needed, at the bf16
tensor-core peak, over the device time of the kernels named
``flash_fwd*``, ``flash_dq*`` and ``flash_dkv*``.

Counted from shapes, whatever implements the kernels: a causal row
``i`` sees ``i + 1`` keys, so a call covers ``B H T (T + 1) / 2`` visible
pairs; the forward does 4 D operations a pair (QK, PV), dq 6 D (S again,
dP, dQ) and dk/dv 8 D (S, dP, dV, dK). Each runs once a layer a step.
At D = 128 and T = 2048 they are compute-bound."""

from harness.common import PEAKS

LAYER = "kernels (ops/flash_attention.py, csrc/flash_*)"
MOVES = "train_step_ms"
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def pairs(b: int, h: int, t: int) -> int:
    return b * h * t * (t + 1) // 2


def fwd_flops(b, h, t, d) -> int:
    return 4 * d * pairs(b, h, t)


def dq_flops(b, h, t, d) -> int:
    return 6 * d * pairs(b, h, t)


def dkv_flops(b, h, t, d) -> int:
    return 8 * d * pairs(b, h, t)


def read(run):
    t, peaks = run.trace, PEAKS.get(run.device_kind)
    if t is None or peaks is None:
        return None
    steps = t.steps.get("train_steps", 0)
    secs = t.op_seconds(KERNELS)
    if not steps or secs <= 0:
        return None
    cfg = run.config
    h, d = int(cfg["n_head"]), int(cfg["n_embd"]) // int(cfg["n_head"])
    b, seq = int(run.traffic["batch"]), int(run.traffic["seq_len"])
    per_layer = (fwd_flops(b, h, seq, d) + dq_flops(b, h, seq, d)
                 + dkv_flops(b, h, seq, d))
    total = per_layer * int(cfg["n_layer"]) * steps
    return 100.0 * total / peaks["bf16_flop_per_s"] / secs
