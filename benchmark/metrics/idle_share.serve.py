"""Share of the traced stretch in which no operation ran on the card
(profiler: the union of kernel, copy and set intervals)."""

LAYER = "device"
MOVES = "serve_tokens_per_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
