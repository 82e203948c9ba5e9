"""Model FLOP utilisation of a training step: the model's operations a
step over the step's time at the bf16 tensor-core peak, the step's time
being the window's wall seconds over its steps.

The operations, as the port's smoke test counts them: ``6 N T_tok`` for
the matrix products forward and backward, with ``N`` every parameter but
the two embedding tables (the head counted), plus ``12 B H T^2 dh / 2``
a layer for causal attention forward and backward; recomputation is not
counted."""

from harness.common import PEAKS

LAYER = "train step (training.py lm_train_step, optimizers.py)"
MOVES = "train_step_ms"


def n_params(cfg: dict) -> int:
    d = int(cfg["n_embd"])
    ff = int(cfg.get("n_inner") or 4 * d)
    v, p = int(cfg["vocab_size"]), int(cfg["n_positions"])
    block = 4 * d + (3 * d * d + 3 * d) + (d * d + d) \
        + (d * ff + ff) + (ff * d + d)
    return (v + p) * d + int(cfg["n_layer"]) * block + 2 * d + v * d + v


def step_flops(cfg: dict, b: int, t: int) -> float:
    d, h = int(cfg["n_embd"]), int(cfg["n_head"])
    nonembed = n_params(cfg) - (int(cfg["vocab_size"])
                                + int(cfg["n_positions"])) * d
    return (6.0 * nonembed * b * t
            + 12.0 * b * h * t * t * (d // h) / 2 * int(cfg["n_layer"]))


def read(run):
    peaks = PEAKS.get(run.device_kind)
    n = run.host.get("train_steps")
    if peaks is None or not n:
        return None
    flops = step_flops(run.config, int(run.traffic["batch"]),
                       int(run.traffic["seq_len"]))
    step_s = run.host["window_s"] / n
    return 100.0 * flops / step_s / peaks["bf16_flop_per_s"]
