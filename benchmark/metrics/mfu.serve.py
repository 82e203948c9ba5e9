"""The whole serving step's share of the card's peak: the least time
the card could take for the work the traced scheduler steps needed, over
the traced stretch's length. Each decode round is bound by the larger of
its operations at the bf16 tensor-core peak and its bytes at the memory
rate; each prefill span (a chunk, or a whole prompt) likewise. Decode
rounds are memory-bound: every weight is read once a round for a few
dozen rows.

Counted from shapes: a matrix weight does 2 operations a row it meets
and is read once a call (2 bytes, bf16); attention does 4 d operations a
key a query row (QK and PV over every head) in each layer and reads each
key's K and V rows once (2 d bytes each, every layer). The head runs on
the decode rows and on the last position of a finished prompt only."""

from harness.common import PEAKS

LAYER = "model step (models/transformer.py in the step programs)"
MOVES = "serve_tokens_per_s"


def widths(cfg: dict) -> dict:
    d = int(cfg["n_embd"])
    ff = int(cfg.get("n_inner") or 4 * d)
    layers = int(cfg["n_layer"])
    v = int(cfg["vocab_size"])
    return {"d": d, "layers": layers, "vocab": v,
            "block_weights": layers * (4 * d * d + 2 * d * ff),
            "head_weights": v * d}


def decode_round(rows, w: dict) -> tuple:
    """(operations, bytes) of one decode round over slots holding
    ``rows`` live rows each."""
    n = len(rows)
    mats = w["block_weights"] + w["head_weights"]
    ops = 2 * mats * n + 4 * w["d"] * w["layers"] * sum(rows)
    nbytes = 2 * mats + 2 * 2 * w["d"] * w["layers"] * sum(rows)
    return ops, nbytes


def prefill_span(p0: int, p1: int, last: bool, w: dict) -> tuple:
    """(operations, bytes) of prefilling prompt rows ``[p0, p1)``; the
    head once if the span ends the prompt."""
    c = p1 - p0
    keys = sum(range(p0 + 1, p1 + 1))          # causal: row i sees i + 1
    ops = 2 * w["block_weights"] * c + 4 * w["d"] * w["layers"] * keys
    nbytes = 2 * w["block_weights"] + 2 * 2 * w["d"] * w["layers"] * p1
    if last:
        ops += 2 * w["head_weights"]
        nbytes += 2 * w["head_weights"]
    return ops, nbytes


def read(run):
    t, peaks = run.trace, PEAKS.get(run.device_kind)
    steps = run.host.get("traced_steps")
    if t is None or peaks is None or not steps or t.window_s <= 0:
        return None
    w = widths(run.config)
    f, b = peaks["bf16_flop_per_s"], peaks["hbm_bytes_per_s"]
    bound = 0.0
    for s in steps:
        if s["decode_rows"]:
            ops, nbytes = decode_round(s["decode_rows"], w)
            bound += max(ops / f, nbytes / b)
        for p0, p1, last in s["prefill_spans"]:
            ops, nbytes = prefill_span(p0, p1, last, w)
            bound += max(ops / f, nbytes / b)
    return 100.0 * bound / t.window_s
