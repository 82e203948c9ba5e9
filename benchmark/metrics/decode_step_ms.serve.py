"""Milliseconds a decode round: the window's wall seconds over the rise
of the engine's registry counter ``serving_decode_steps_total`` in it.
A step's prefill chunk and the scheduler's host work are inside it."""

LAYER = "engine and step programs (serving/engine.py, serving/_programs.py)"
MOVES = "serve_tokens_per_s"


def read(run):
    n = run.host.get("decode_steps")
    if not n:
        return None
    return run.host["window_s"] / n * 1e3
