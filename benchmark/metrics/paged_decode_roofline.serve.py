"""The paged decode kernel's share of its roofline: the least time the
card could take to move the bytes the traced decode rounds needed, over
the device time of the kernels named ``paged_decode*`` (the split-K pass
and its combine) in the trace.

The bytes of one call (one layer of one round), counted from shapes and
whatever implements the kernel: each active slot's live K and V rows
read once, its query read and its output written once (the compute
dtype), its block-table entries and its length read (int32). A round
calls the kernel once a layer. Decode attention does 4 D operations a
row and head against 2 D elements moved, far below the card's ridge, so
bytes bound it."""

from harness.common import PEAKS

LAYER = "kernels (parallel/paged_kernel.py, csrc/paged_decode.cu)"
MOVES = "serve_tokens_per_s"
KERNELS = ("paged_decode",)


def call_bytes(rows, heads: int, head_dim: int, block: int,
               elt: int = 2) -> int:
    """Bytes one paged-decode call needs over slots holding ``rows`` live
    rows each (the new token's row included)."""
    n = len(rows)
    kv = sum(rows) * heads * head_dim * elt * 2
    q_out = n * heads * head_dim * elt * 2
    tables = sum(-(-r // block) for r in rows) * 4 + n * 4
    return kv + q_out + tables


def read(run):
    t, peaks = run.trace, PEAKS.get(run.device_kind)
    steps = run.host.get("traced_steps")
    if t is None or peaks is None or not steps:
        return None
    secs = t.op_seconds(KERNELS)
    if secs <= 0:
        return None
    cfg = run.config
    d, h, layers = int(cfg["n_embd"]), int(cfg["n_head"]), int(cfg["n_layer"])
    block = int(run.cell["engine"]["kv_block_size"])
    total = sum(call_bytes(s["decode_rows"], h, d // h, block)
                for s in steps if s["decode_rows"]) * layers
    return 100.0 * total / peaks["hbm_bytes_per_s"] / secs
