"""Slot occupancy: the mean, over the window's ``sched.step()`` calls,
of the engine's decoding slots over its slots, read by the harness
after each call. Free slots and slots still in a chunked prefill lower
it; it bounds the decode batch and so the tokens a second."""

LAYER = "scheduler (serving/scheduler.py)"
MOVES = "serve_tokens_per_s"


def read(run):
    occ = run.host.get("occupancy")
    if not occ:
        return None
    return 100.0 * sum(occ) / len(occ) / run.host["n_slots"]
