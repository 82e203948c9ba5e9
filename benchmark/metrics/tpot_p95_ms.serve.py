"""Time per output token, 95th percentile over every request that
arrived in the window, in milliseconds: a request's last token less its
first, over its tokens less one. It reads the decode round and the
prefill chunks that share its steps."""

LAYER = "engine and step programs (serving/engine.py, serving/_programs.py)"
MOVES = "serve_tokens_per_s"


def read(run):
    return run.host.get("tpot_p95_ms")
