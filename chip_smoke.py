#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chainermn_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, times it, serves the
220M-parameter TransformerLM (vocab 32768, d_model 1024, 12 layers, 16
heads; random weights from a seed) through ``ServingEngine(paged=True,
paged_kernel=True)`` and ``FCFSScheduler``, checks that every decode-step
attention went through the kernel, and checks the kernel-read engine's
greedy tokens against the plain-read engine's on a small f32 model. Each
phase prints one JSON line; the last two lines are the kernel summary and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0

# the served model: scripts/onchip_lm.py's full-width LM
LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
          d_ff=4096, max_len=2048)
ENGINE = dict(n_slots=16, kv_block_size=16, cache_len=2048,
              prefill_buckets=(128, 512), prefill_batch=4)
N_REQUESTS = 32
PROMPT_LEN = (64, 512)
MAX_NEW = (64, 128)
TOL = {"bf16": (2e-2, 2e-2), "f32": (1e-5, 1e-5), "int8": (1e-4, 1e-4)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 50, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``; ``flush()`` runs
    before each timed call, outside the timed region."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_paged_inputs(lengths, *, s_len, h, d, bs, dtype, q_dtype, gen,
                      device, n_blocks=None):
    """A random store whose rows own disjoint random blocks (unused table
    entries and the store's spare blocks hold junk, so a read past a
    row's length would show), int8 scales when ``dtype`` is int8."""
    import torch

    b = len(lengths)
    need = [-(-int(n) // bs) for n in lengths]
    n_max = max(need)
    if n_blocks is None:
        n_blocks = sum(need) + 1 + 8
    perm = torch.randperm(n_blocks - 1, generator=gen)[:sum(need)] + 1
    table = torch.zeros((b, n_max), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].int()
        at += n
    shape = (n_blocks, bs, h, d)
    out = {"table": table.to(device),
           "lengths": torch.as_tensor(lengths, dtype=torch.int32,
                                      device=device),
           "q": torch.randn((b, s_len, h, d), generator=gen).to(
               device=device, dtype=q_dtype)}
    if dtype == torch.int8:
        for kk in ("k", "v"):
            out[kk] = torch.randint(-127, 128, shape, generator=gen,
                                    dtype=torch.int8).to(device)
            out[kk + "_scale"] = (torch.rand((n_blocks, bs, h), generator=gen)
                                  * 0.05 + 1e-3).to(device)
    else:
        for kk in ("k", "v"):
            out[kk] = torch.randn(shape, generator=gen).to(device=device,
                                                           dtype=dtype)
        out["k_scale"] = out["v_scale"] = None
    return out


def attend_args(x):
    return ((x["q"], x["k"], x["v"], x["table"], x["lengths"]),
            dict(k_scale=x["k_scale"], v_scale=x["v_scale"]))


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return line


def phase_build():
    from chainermn_torch.parallel import paged_kernel

    t0 = time.perf_counter()
    paged_kernel.build_library()
    log = sorted({ln.split(":", 1)[-1].strip()
                  for ln in paged_kernel.build_library.log.splitlines()
                  if "registers" in ln or "spill" in ln})
    emit({"phase": "build", "kernel": "paged_decode",
          "seconds": time.perf_counter() - t0, "ptxas": log[:24]})


def phase_parity(device):
    """paged_attend vs paged_attend_reference on the card: B=16, H=16,
    D=64, bs=16, ragged lengths 1..2048 (one at a block edge, one below
    bs), S in {1, 4}, bf16 / f32 / int8 stores."""
    import torch

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
    )

    gen = torch.Generator().manual_seed(SEED)
    base = [1, 5, 16, 17, 31, 64, 100, 255, 256, 511, 777, 1024, 1500,
            1999, 2047, 2048]
    cases = {"bf16": (torch.bfloat16, torch.bfloat16),
             "f32": (torch.float32, torch.float32),
             "int8": (torch.int8, torch.float32)}
    results = []
    for s_len in (1, 4):
        lengths = [max(n, s_len) for n in base]
        for name, (dtype, q_dtype) in cases.items():
            x = make_paged_inputs(lengths, s_len=s_len, h=16, d=64, bs=16,
                                  dtype=dtype, q_dtype=q_dtype, gen=gen,
                                  device=device)
            args, kw = attend_args(x)
            got = paged_attend(*args, **kw).float()
            want = paged_attend_reference(*args, **kw).float()
            torch.cuda.synchronize()
            rtol, atol = TOL[name]
            err = (got - want).abs()
            ok = bool((err <= atol + rtol * want.abs()).all())
            results.append({"store": name, "S": s_len,
                            "max_abs_err": float(err.max()), "rtol": rtol,
                            "atol": atol, "ok": ok})
    emit({"phase": "parity", "kernel": "paged_decode", "cases": results})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"paged_decode disagrees with its plain "
                             f"version: {bad}")
    return max(r["max_abs_err"] for r in results)


def phase_serve(device):
    """The main path: the 220M LM served through the paged engine with
    the kernel on the decode read side."""
    import numpy as np
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import FCFSScheduler, ServingEngine

    t0 = time.perf_counter()
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, paged=True, paged_kernel=True,
                           device=device, **ENGINE)
    engine.warmup()
    t_setup = time.perf_counter() - t0
    steps_ctr = get_registry().counter(
        "serving_decode_steps_total",
        {"engine": "serving", "paged_kernel": "on"})
    sched = FCFSScheduler(engine)
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(N_REQUESTS):
        plen = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        prompt = rng.integers(1, LM["vocab_size"], size=plen)
        reqs.append(sched.submit(
            prompt, int(rng.integers(MAX_NEW[0], MAX_NEW[1] + 1))))
    snapshot, most = None, 0
    paged_attend.launches = 0
    steps0 = steps_ctr.value
    t0 = time.perf_counter()
    while sched.has_work:
        if engine.active_slots > most:    # decode lengths, pool fullest
            most = engine.active_slots
            snapshot = engine._pos[engine._active].astype(np.int64) + 1
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attend.launches
    steps = steps_ctr.value - steps0
    rep = sched.metrics.report()
    for r in reqs:
        toks = np.asarray(r.tokens)
        if not (r.finished and r.error is None
                and len(toks) == r.max_new_tokens
                and ((toks >= 0) & (toks < LM["vocab_size"])).all()):
            raise AssertionError(f"request {r.id} did not serve cleanly: "
                                 f"{r.state} {len(toks)} tokens")
    if launches != steps * LM["n_layers"]:
        raise AssertionError(f"kernel launches {launches} != decode steps "
                             f"{steps} x {LM['n_layers']} layers")
    pool = engine._pool
    if (engine.active_slots or pool.free_blocks
            + engine.prefix_cache.evictable_blocks() != pool.capacity
            or int(engine._slot_reserved.sum())):
        raise AssertionError(f"block pool not whole after retirement: "
                             f"{engine.kv_stats()}")
    emit({"phase": "serve", "model": dict(LM, params=n_params,
                                          compute_dtype="bf16"),
          "engine": dict(ENGINE, paged_kernel=True,
                         kv_blocks=engine.kv_blocks),
          "requests": N_REQUESTS, "setup_s": t_setup, "wall_s": wall,
          "decode_steps": steps, "kernel_launches": launches,
          "tokens_generated": rep["tokens_generated"],
          "tokens_per_sec": rep["tokens_per_sec"],
          "ttft_p50_s": rep["ttft_p50_s"], "ttft_p99_s": rep["ttft_p99_s"],
          "tpot_p50_s": rep["tpot_p50_s"],
          "slot_occupancy_mean": rep["slot_occupancy_mean"],
          "pool": engine.kv_stats()})
    profile = phase_profile(engine, sched, rng)
    del engine, model, sched
    torch.cuda.empty_cache()
    return launches, [int(n) for n in snapshot], profile


def phase_profile(engine, sched, rng, n_steps: int = 20):
    """Where a decode step's time goes: refill every slot, let admissions
    finish, then trace ``n_steps`` pure decode steps with
    ``torch.profiler``. Device busy time is the sum of CUDA activity
    (kernels, copies) in the window; idle share is what is left of the
    host wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(engine.n_slots):
        plen = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        sched.submit(rng.integers(1, LM["vocab_size"], size=plen),
                     MAX_NEW[1])
    while sched.queue_depth or engine.free_slots:
        sched.step()
    for _ in range(3):
        sched.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    kern_us = sum(e.self_device_time_total for e in dev
                  if "paged_decode_kernel" in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"phase": "profile", "decode_steps": n_steps,
           "active_slots": engine.active_slots,
           "step_wall_ms": wall / n_steps * 1e3,
           "step_device_busy_ms": busy_us / n_steps / 1e3 if busy_us
           else "not measured",
           "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us
           else "not measured",
           "paged_decode_ms_per_step": kern_us / n_steps / 1e3,
           "paged_decode_share_of_busy": kern_us / busy_us if busy_us
           else "not measured",
           "top_device": [{"name": e.key[:70], "ms_per_step":
                           e.self_device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps}
                          for e in top]}
    emit(rec)
    return rec


def phase_timing(device, lengths):
    """Kernel, plain version and library yardstick at the serve phase's
    decode shape (the active slots at the lengths they held when the most
    were decoding; bf16 store of the engine's size; S = 1), L2 flushed
    before each timed call."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
    )

    h, d, bs = LM["n_heads"], LM["d_model"] // LM["n_heads"], 16
    n_blocks = ENGINE["n_slots"] * (ENGINE["cache_len"] // bs) + 1
    gen = torch.Generator().manual_seed(SEED + 1)
    x = make_paged_inputs(lengths, s_len=1, h=h, d=d, bs=bs,
                          dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                          gen=gen, device=device, n_blocks=n_blocks)
    args, kw = attend_args(x)
    span = x["table"].shape[1]
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    flush = scratch.zero_
    launches0 = paged_attend.launches
    got = paged_attend(*args, **kw).float()
    want = paged_attend_reference(*args, **kw).float()
    err = float((got - want).abs().max())
    kernel_ms = cuda_ms(lambda: paged_attend(*args, **kw), flush=flush)
    plain_ms = cuda_ms(lambda: paged_attend_reference(*args, **kw),
                       flush=flush)
    paged_attend.launches = launches0

    b = len(lengths)
    q = x["q"]
    flat = x["table"].reshape(-1).long()
    k_pos = torch.arange(span * bs, device=device)
    mask = (k_pos[None, :] <= (x["lengths"].long() - 1)[:, None])
    mask = mask[:, None, None, :]                       # [B,1,S=1,T]

    def library():
        kk = x["k"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        vv = x["v"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kk, vv,
                                              attn_mask=mask)

    lib_err = float((library().transpose(1, 2).float() - want).abs().max())
    library_ms = cuda_ms(library, flush=flush)
    # least work: q read, each row's live KV rows read once, its table
    # entries and length read, the output written
    kv_rows = sum(lengths)
    n_bytes = (q.numel() * 2 * 2 + kv_rows * h * d * 2 * 2
               + sum(-(-n // bs) for n in lengths) * 4 + b * 4)
    n_ops = 4 * kv_rows * h * d                         # QK and PV, S = 1
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    rec = {"phase": "timing", "kernel": "paged_decode", "B": b, "S": 1,
           "H": h, "D": d, "bs": bs, "store": "bf16", "lengths": lengths,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes": n_bytes, "ops": n_ops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    return rec


def phase_engine_parity(device):
    """Same f32 model, same requests: the kernel-read engine and the
    plain-read engine must give identical greedy token streams."""
    import numpy as np
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import FCFSScheduler, ServingEngine

    model = TransformerLM(vocab_size=1000, d_model=256, n_heads=4,
                          n_layers=2, max_len=512,
                          compute_dtype=torch.float32, device=device,
                          seed=SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    work = [(rng.integers(1, 1000, size=int(rng.integers(5, 100))),
             int(rng.integers(16, 48))) for _ in range(8)]
    streams = {}
    for kernel in (True, False):
        engine = ServingEngine(model, n_slots=4, kv_block_size=16,
                               cache_len=256, prefill_buckets=(32, 128),
                               prefill_batch=2, paged_kernel=kernel,
                               device=device)
        engine.warmup()
        sched = FCFSScheduler(engine)
        reqs = [sched.submit(p, n) for p, n in work]
        sched.run_until_idle()
        streams[kernel] = [list(map(int, r.output)) for r in reqs]
    same = streams[True] == streams[False]
    emit({"phase": "engine_parity", "model": "2 layers, d_model 256, f32",
          "requests": len(work), "identical": same,
          "tokens": sum(n for _, n in work)})
    if not same:
        raise AssertionError("kernel-read and plain-read engines disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "chainermn_torch" / "csrc").is_dir():
        print(f"chip_smoke: no chainermn_torch checkout beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    parity_err = phase_parity(device)
    launches, lengths, _ = phase_serve(device)
    timing = phase_timing(device, lengths)
    phase_engine_parity(device)
    emit({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "chainermn_torch/csrc/paged_decode.cu",
        "replaces": "chainermn_tpu/parallel/paged_kernel.py:91",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "parity_max_abs_err": parity_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
