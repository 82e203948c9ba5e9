"""Time to first token, 95th percentile over every request that arrived
in the window, in milliseconds: first token less arrival, requests run
to their end after the window. In a closed loop with every slot busy a
request waits for a slot's prefill chunks, so this reads the
scheduler's admission and chunking; it swings with the order of the
lengths, so it stands beside the tokens a second, not as an end-to-end
metric."""

LAYER = "scheduler (serving/scheduler.py)"
MOVES = "serve_tokens_per_s"


def read(run):
    return run.host.get("ttft_p95_ms")
