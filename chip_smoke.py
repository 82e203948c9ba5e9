#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chainermn_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, started together), holds each against its plain
PyTorch version on the card (at the kernels' own head dims and at those
the wrappers pad or mask, in f32, bf16 and f16, with more than 65535
(row, head) pairs), times it, and drives the port's four paths with the
220M-parameter TransformerLM (vocab 32768, d_model 1024, 12 layers, 16
heads) and ResNet-50 (random weights from a seed):

- serving: ``ServingEngine(paged=True, paged_kernel=True)`` and
  ``FCFSScheduler`` answer 32 requests; every decode-step attention must
  go through the paged-decode kernel, and the kernel-read engine's greedy
  tokens must equal the plain-read engine's on a small f32 model;
- training: ``TransformerLM(attention='flash')``,
  ``create_communicator('pure_nccl')``, ``create_multi_node_optimizer``
  over ``AdamW`` and ``lm_train_step`` take 12 steps on a [8, 2048] batch;
  every attention forward and backward must go through the flash kernels,
  the loss must fall, and a small f32 LM trained on the kernels must match
  the same LM trained on plain attention;
- data-parallel training (no kernel of its own): ResNet-50 at
  ``bench.py``'s headline configuration (batch 256, 224x224, bf16) through
  ``create_communicator('pure_nccl', allreduce_grad_dtype=bf16)``,
  ``create_multi_node_optimizer(SGD)`` and ``train_step`` for 23 steps,
  profiled, and a small f32 ResNet trained by every strategy, double
  buffering and ZeRO-1 on the card must match the same training on the
  CPU, with the ln 10 known answer on zero images;
- the ImageNet trainer: the twin of ``examples/imagenet/train_imagenet.py``
  (``chainermn_torch.examples.imagenet.train_imagenet.main``) runs in
  process at full width (ResNet-50, 224x224, 1000 classes, batch 256,
  one NCCL rank) with the recipe on the native C++ loader and the device
  prefetcher, with the numpy collate, with FSDP and with multi-node
  BatchNorm and double buffering; every loss must be finite and the
  native loader must run where it was asked for;
- the MNIST and seq2seq twins (no kernel of their own), each at its JAX
  script's defaults: data-parallel MNIST in process on one NCCL rank
  (finite, falling losses, val accuracy at least 0.9); the checkpoint
  twin crashed and resumed in three runs (the resumed run's last snapshot
  must equal an uninterrupted run's, leaf for leaf); the model-parallel
  MNIST and seq2seq twins as two processes on the card over a gloo group
  (stage parameters on the card, boundary tensors staged through the
  host; MNIST's first losses must match the two stages in one process to
  1e-5, with one transfer each way a step);
- context and tensor parallelism, the ranks as processes on the card over
  a gloo group (every transfer staged through the host, so nothing here
  prices NCCL between cards): the six sequence-parallel kinds on 2 ranks
  at the LM's attention shape against one process's flash attention
  (``sp_parity``); the 220M LM trained with ``ring_flash``,
  ``zigzag_flash`` and ``ulysses_flash`` over 2 ranks
  (``lm_train_step(shard_sequence=True)``, ``sp_train``) and with
  ``tensor_axis`` over tp = 2 and the vocab-parallel head (``tp_train``),
  each first loss against the one-process LM on the same weights and
  every attention call on the flash kernels; the dry run's dp x sp x tp
  = 2 x 2 x 2 LM on 8 ranks (``hybrid``). The flash kernels are also held
  to their plain versions as the ring calls them (``flash_ring_blocks``:
  f32 out from bf16, block gradients on the final lse, a fully masked
  block).

Each launch count is set to 0 just before its path runs and read just
after. Each phase prints one JSON line; the line before the last two is
the kernel summary, then the card's name and power limit, then ``{"ok":
true, "device": {...}}``. Without a CUDA device, or outside a checkout, it
exits non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0
SPIN_CYCLES = 4_000_000            # ~2 ms of device spin at H100 clocks

# the served model: scripts/onchip_lm.py's full-width LM
LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
          d_ff=4096, max_len=2048)
ENGINE = dict(n_slots=16, kv_block_size=16, cache_len=2048,
              prefill_buckets=(128, 512), prefill_batch=4)
N_REQUESTS = 32
PROMPT_LEN = (64, 512)
MAX_NEW = (64, 128)
TOL = {"bf16": (2e-2, 2e-2), "f32": (1e-5, 1e-5), "int8": (1e-4, 1e-4)}
TOL["f16"] = TOL["bf16"]           # the 16-bit tolerance, for float16
# the trained model: scripts/onchip_lm.py's headline cell
TRAIN = dict(batch=8, seq_len=2048, lr=3e-4, weight_decay=1e-4,
             warmup_steps=2, timed_steps=10, profile_steps=3)
# the data-parallel cell: bench.py's headline train configuration
DP = dict(batch=256, image_size=224, num_classes=1000, lr=0.1, momentum=0.9,
          warmup_steps=3, timed_steps=20, profile_steps=3)
RESNET50_PARAMS = 25_557_032       # the flax ResNet50(num_classes=1000)
DP_PARITY = dict(model=dict(stage_sizes=[1, 1, 1, 1], width=8,
                            num_classes=10),
                 image_size=32, batch=8, steps=3, clip=0.05, tol=1e-4)
# name: (wrapper, kernel name in traces, TPU kernel it replaces, source of
# the bf16 kernel the training path runs)
FLASH_KERNELS = {
    "flash_fwd": ("flash_fwd_with_lse", "flash_fwd_kernel",
                  "chainermn_tpu/ops/flash_attention.py:195",
                  "chainermn_torch/csrc/flash_fwd_sm90.cuh"),
    "flash_dq": ("flash_dq", "flash_dq_kernel",
                 "chainermn_tpu/ops/flash_attention.py:355",
                 "chainermn_torch/csrc/flash_bwd_sm90.cuh"),
    "flash_dkv": ("flash_dkv", "flash_dkv_kernel",
                  "chainermn_tpu/ops/flash_attention.py:412",
                  "chainermn_torch/csrc/flash_bwd_sm90.cuh"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 50, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``; ``flush()`` runs
    before each timed call, outside the timed region. A device spin of
    about 2 ms sits between the two, so the card is still busy while the
    host enqueues ``fn``'s kernels: the events then time the device's
    work, not the host's launch overhead."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
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


def _ptxas(log: str) -> list:
    """Registers and spills of each kernel entry in ``nvcc -Xptxas -v``
    output (names demangled where ``c++filt`` exists)."""
    entries, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"entry": m.group(1)}
            entries.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if cur is not None and m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if cur is not None and m:
            cur["registers"] = int(m.group(1))
    if entries and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(
            e["entry"] for e in entries), capture_output=True, text=True,
            timeout=60)
        for e, name in zip(entries, res.stdout.splitlines()):
            name = re.sub(r"\(anonymous namespace\)::", "", name)
            e["entry"] = name.split("(")[0]
    return entries


def phase_build():
    """Both kernel libraries, one ``nvcc`` each, started together. Fails
    if a bf16 flash instance (``*_sm90``) or a paged-decode instance
    spills registers."""
    from chainermn_torch.ops import flash_attention
    from chainermn_torch.parallel import paged_kernel

    libs = {"paged_decode": paged_kernel, "flash_attention": flash_attention}

    def build(mod):
        t0 = time.perf_counter()
        mod.build_library()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(libs)) as pool:
        seconds = dict(zip(libs, pool.map(build, libs.values())))
    ptxas = {name: _ptxas(mod.build_library.log) for name, mod in libs.items()}
    for name in libs:
        emit({"phase": "build", "kernel": name, "seconds": seconds[name],
              "ptxas": ptxas[name]})
    # the bf16 flash kernels and the paged kernel keep their accumulators
    # in registers: a spill would put them in local memory
    spilled = [e for e in ptxas["flash_attention"] + ptxas["paged_decode"]
               if ("_sm90" in e["entry"] or "paged_decode" in e["entry"])
               and e.get("spill_stores", 0)]
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")


# paged parity: "split" spans the cache's 2048 keys, so the kernel splits
# each row across CTAs (lengths at and across the 512-key split edges, at
# block edges, below bs, at 2048); "single" spans 128 keys, one CTA a row
PAGED_LENGTHS = {
    "split": [1, 5, 16, 17, 31, 64, 100, 255, 511, 513, 777, 1024, 1500,
              1999, 2047, 2048],
    "single": [1, 5, 8, 15, 16, 17, 31, 33, 47, 64, 65, 100, 111, 126, 127,
               128],
}


# (D, S) of the paged parity cases: the kernel's own widths with up to
# the 8 queries one launch holds, then head dims it masks inside (8, 32,
# 96) and windows of 12 queries (two launches, chunk_queries)
PAGED_SHAPES = ((64, 1), (64, 4), (64, 8), (128, 1), (128, 8),
                (8, 1), (8, 12), (32, 4), (32, 12), (96, 8), (96, 12),
                (64, 12))
# more (row, head) pairs than one grid axis of 65535 holds, for each kernel
GRID_BH = 70_000


def phase_parity(device):
    """paged_attend vs paged_attend_reference on the card: B=16, H=16,
    bs=16, the PAGED_LENGTHS sets (split-K and one-CTA paths), the
    PAGED_SHAPES (D, S) pairs, bf16 / f32 / int8 stores; then one case
    with B * H = 70000 rows and heads (B = 70000, H = 1, a bf16 store)."""
    import torch

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
        split_plan,
    )

    gen = torch.Generator().manual_seed(SEED)
    cases = {"bf16": (torch.bfloat16, torch.bfloat16),
             "f32": (torch.float32, torch.float32),
             "int8": (torch.int8, torch.float32)}
    results = []
    for d, s_len in PAGED_SHAPES:
        for path, base in PAGED_LENGTHS.items():
            lengths = [max(n, s_len) for n in base]
            for name, (dtype, q_dtype) in cases.items():
                x = make_paged_inputs(lengths, s_len=s_len, h=16, d=d,
                                      bs=16, dtype=dtype, q_dtype=q_dtype,
                                      gen=gen, device=device)
                args, kw = attend_args(x)
                got = paged_attend(*args, **kw).float()
                want = paged_attend_reference(*args, **kw).float()
                torch.cuda.synchronize()
                rtol, atol = TOL[name]
                err = (got - want).abs()
                ok = bool((err <= atol + rtol * want.abs()).all())
                plan = split_plan(len(lengths), 16, x["table"].shape[1], 16)
                results.append({"store": name, "D": d, "S": s_len,
                                "path": path, "n_split": plan[0],
                                "split_keys": plan[1],
                                "max_abs_err": float(err.max()),
                                "rtol": rtol, "atol": atol, "ok": ok})
    # the grid: B * H past 65535 (B = GRID_BH rows of one head)
    lengths = torch.randint(1, 40, (GRID_BH,), generator=gen).tolist()
    x = make_paged_inputs(lengths, s_len=1, h=1, d=64, bs=16,
                          dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                          gen=gen, device=device)
    args, kw = attend_args(x)
    got = paged_attend(*args, **kw).float()
    want = paged_attend_reference(*args, **kw).float()
    rtol, atol = TOL["bf16"]
    err = (got - want).abs()
    results.append({"store": "bf16", "D": 64, "S": 1, "path": "grid",
                    "B": GRID_BH, "H": 1, "max_abs_err": float(err.max()),
                    "rtol": rtol, "atol": atol,
                    "ok": bool((err <= atol + rtol * want.abs()).all())})
    del x, args, got, want, err
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
    # the split-K pass and its combine pass
    kern_us = sum(e.self_device_time_total for e in dev
                  if "paged_decode" in e.key)
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
        split_plan,
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
    # the same rows at a head dim the kernel masks inside (D = 8, the
    # repo's small LM configurations) and with a 12-query window (two
    # launches of chunk_queries)
    wider = {}
    for tag, s_len, dd in (("D8", 1, 8), ("S12", 12, d)):
        y = make_paged_inputs([max(n, s_len) for n in lengths], s_len=s_len,
                              h=h, d=dd, bs=bs, dtype=torch.bfloat16,
                              q_dtype=torch.bfloat16, gen=gen, device=device,
                              n_blocks=n_blocks)
        y_args, y_kw = attend_args(y)
        wider[f"ms_{tag}"] = cuda_ms(lambda: paged_attend(*y_args, **y_kw),
                                     flush=flush)
        del y, y_args, y_kw
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
    n_split, split_keys = split_plan(b, h, span, bs)
    rec = {"phase": "timing", "kernel": "paged_decode", "B": b, "S": 1,
           "H": h, "D": d, "bs": bs, "store": "bf16", "lengths": lengths,
           "n_split": n_split, "split_keys": split_keys,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "ms": kernel_ms, **wider, "plain_ms": plain_ms,
           "library_ms": library_ms,
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


# name, Tq, Tk, causal, q_offset, k_offset
FLASH_CASES = [
    ("square_causal", 1024, 1024, True, 0, 0),
    ("square_full", 1024, 1024, False, 0, 0),
    ("ragged_causal", 1000, 1000, True, 0, 0),
    ("ragged_full", 1000, 1000, False, 0, 0),
    ("rect_full", 512, 1024, False, 0, 0),
    ("rect_causal", 512, 1024, True, 512, 0),
    ("offset_q256", 1024, 1024, True, 256, 0),
    ("offset_k300", 1024, 1024, True, 0, 300),   # rows 0..299 see no key
    ("tiny_causal", 100, 100, True, 0, 0),       # below one 128-row tile
    ("ragged_offset_q64", 1000, 1000, True, 64, 0),
    ("future_block", 1024, 1024, True, 0, 1024),  # no row sees a key
]


def _flash_inputs(b, tq, tk, h, d, dtype, gen, device, fused=False):
    """q, k, v and do drawn from a seeded CPU generator. ``fused``: q, k
    and v are slices of one [B, T, 3, H, D] tensor, as the model's qkv
    projection hands them to attention."""
    import torch

    def draw(shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    if fused:
        qkv = draw((b, tq, 3, h, d))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = draw((b, tq, h, d)), draw((b, tk, h, d)), draw((b, tk, h, d))
    return q, k, v, draw((b, tq, h, d))


def _compare(got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    return float(err.max()), bool((err <= atol + rtol * want.float().abs())
                                  .all())


# the FLASH_CASES run at head dims the wrapper pads (8, 32, 96)
FLASH_PAD_CASES = ("square_causal", "ragged_full", "rect_causal",
                   "offset_k300")


def phase_flash_parity(device):
    """Each flash kernel against its plain version on the card: B=2,
    H=16, D in {64, 128} with the FLASH_CASES shapes (ragged tails,
    Tq != Tk, offsets, a sequence below one tile) and D in {8, 32, 96}
    with the FLASH_PAD_CASES, bf16, f32 and f16 each; then one case with
    B * H past 65535 (B = 4375, H = 16, T = 8, bf16, causal). The backward
    kernels take the plain forward's lse and delta, so each kernel sees
    its plain version's inputs; gradients come back in the input dtype, as
    in training. Rows that see no key must hold out == 0 and lse == -1e30,
    and their dq and the unseen keys' dk and dv must be 0, exactly."""
    import torch

    from chainermn_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(SEED + 4)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32,
              "f16": torch.float16}
    grid_case = ("grid_bh", 8, 8, True, 0, 0)
    results = []
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    padded = [c for c in FLASH_CASES if c[0] in FLASH_PAD_CASES]
    # (B, D, dtypes, cases)
    groups = ([(2, d, dtypes, FLASH_CASES) for d in (64, 128)]
              + [(2, d, dtypes, padded) for d in (8, 32, 96)]
              + [(-(-GRID_BH // 16), 64, {"bf16": torch.bfloat16},
                  [grid_case])])
    for b, d, group_dtypes, cases in groups:
        for dname, dtype in group_dtypes.items():
            rtol, atol = TOL[dname]
            for name, tq, tk, causal, qo, ko in cases:
                q, k, v, do = _flash_inputs(b, tq, tk, 16, d, dtype, gen,
                                            device)
                kw = dict(causal=causal, q_offset=qo, k_offset=ko)
                gkw = dict(kw, grad_dtype=dtype)
                out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
                r_out, r_lse = fa.flash_fwd_reference(q, k, v, **kw)
                delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2)
                delta = delta.contiguous()
                dq = fa.flash_dq(q, k, v, do, r_lse, delta, **gkw)
                dk, dv = fa.flash_dkv(q, k, v, do, r_lse, delta, **gkw)
                r_dq = fa.flash_dq_reference(q, k, v, do, r_lse, delta, **gkw)
                r_dk, r_dv = fa.flash_dkv_reference(q, k, v, do, r_lse,
                                                    delta, **gkw)
                torch.cuda.synchronize()
                checks = {"out": _compare(out, r_out, rtol, atol),
                          "lse": _compare(lse, r_lse, rtol, atol),
                          "dq": _compare(dq, r_dq, rtol, atol),
                          "dk": _compare(dk, r_dk, rtol, atol),
                          "dv": _compare(dv, r_dv, rtol, atol)}
                blind_q = blind_k = 0
                sentinel_ok = True
                if causal:
                    rows = qo + torch.arange(tq, device=device) < ko
                    keys = ko + torch.arange(tk, device=device) > qo + tq - 1
                    blind_q, blind_k = int(rows.sum()), int(keys.sum())
                    sentinel_ok = bool(
                        (out[:, rows] == 0).all()
                        and (lse[:, :, rows] == -1e30).all()
                        and (dq[:, rows] == 0).all()
                        and (dk[:, keys] == 0).all()
                        and (dv[:, keys] == 0).all())
                ok = sentinel_ok and all(c[1] for c in checks.values())
                results.append({
                    "B": b, "D": d, "dtype": dname, "case": name,
                    "err": {n: float(f"{c[0]:.3g}")
                            for n, c in checks.items()},
                    "blind_rows": blind_q, "blind_keys": blind_k,
                    "sentinels_exact": sentinel_ok, "ok": ok})
                worst["flash_fwd"] = max(worst["flash_fwd"],
                                         checks["out"][0], checks["lse"][0])
                worst["flash_dq"] = max(worst["flash_dq"], checks["dq"][0])
                worst["flash_dkv"] = max(worst["flash_dkv"], checks["dk"][0],
                                         checks["dv"][0])
    emit({"phase": "flash_parity", "H": 16, "tol": TOL,
          "shapes": {c[0]: c[1:] for c in FLASH_CASES + [grid_case]},
          "shape_fields": ["Tq", "Tk", "causal", "q_offset", "k_offset"],
          "cases": results})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {bad}")
    return worst


# flash_ring_blocks holds f32 outputs of bf16 inputs: absolute
# tolerances a few times the largest sound readings (2.88e-3 on dq,
# 1.54e-3 on out, 9.5e-7 on lse; PERF.md section 6) and below what a
# planted fault (one 64-key tile left out) reads on every output
RING_BLOCK_TOL = {"out": 5e-3, "lse": 1e-4, "dq": 5e-3, "dk": 5e-3,
                  "dv": 5e-3}
RING_BLOCK_TILE = 64


def phase_flash_ring_blocks(device):
    """The flash kernels as the sequence-parallel kinds call them (bf16
    inputs, float32 out and gradients, global offsets), each against its
    plain version: the ring's blocks at the LM's shape (B=8, T_local=1024,
    H=16, D=64; two ranks' queries against both K/V blocks, the earlier
    rank's later block fully masked), with the dq and dk/dv kernels given
    the *final* lse and delta of the whole sequence, and the blocks'
    lse-weighted merge against the whole sequence's output; zigzag's c x c
    blocks (causal at equal offsets, and full); Ulysses' local call (T =
    2048, H = 8). A fully masked block must give out 0, lse -1e30 and
    exactly zero gradients. Held to RING_BLOCK_TOL, which a planted fault
    must fail on every output: the kernels on zigzag's full block with
    one K tile left out (its dk and dv rows zero), against the whole
    block's plain version."""
    import torch

    from chainermn_torch.ops import flash_attention as fa
    from chainermn_torch.parallel.sequence import _zz_merge

    gen = torch.Generator().manual_seed(SEED + 7)
    tol = RING_BLOCK_TOL
    f32 = dict(out_dtype=torch.float32)
    g32 = dict(grad_dtype=torch.float32)
    b, tl, h, d = 8, 1024, 16, 64
    results = []

    def check(name, q, k, v, do, lse, delta, kw, masked=False):
        out, lse_b = fa.flash_fwd_with_lse(q, k, v, **kw, **f32)
        r_out, r_lse = fa.flash_fwd_reference(q, k, v, **kw, **f32)
        grads = fa.flash_block_grads(q, k, v, do, lse, delta, **kw, **g32)
        r_dq = fa.flash_dq_reference(q, k, v, do, lse, delta, **kw, **g32)
        r_dk, r_dv = fa.flash_dkv_reference(q, k, v, do, lse, delta, **kw,
                                            **g32)
        checks = {n: _compare(g, w, 0.0, tol[n]) for n, g, w in zip(
            ("out", "lse", "dq", "dk", "dv"), (out, lse_b) + grads,
            (r_out, r_lse, r_dq, r_dk, r_dv))}
        exact = True
        if masked:
            exact = bool((out == 0).all() and (lse_b == -1e30).all()
                         and all((g == 0).all() for g in grads))
        results.append({"case": name, "shape": list(q.shape) + [k.shape[1]],
                        "kw": kw, "fully_masked": masked,
                        "err": {n: c[0] for n, c in checks.items()},
                        "sentinels_exact": exact,
                        "ok": exact and all(c[1] for c in checks.values())})
        return out, lse_b

    q, kk, vv, do = _flash_inputs(b, 2 * tl, 2 * tl, h, d, torch.bfloat16,
                                  gen, device)
    for r in range(2):
        qr, dor = q[:, r * tl:(r + 1) * tl], do[:, r * tl:(r + 1) * tl]
        # the whole sequence's output and lse for these queries: the final
        # statistics the ring's backward hands every block
        full, lse = fa.flash_fwd_reference(qr, kk, vv, causal=True,
                                           q_offset=r * tl, **f32)
        delta = (dor.float() * full).sum(-1).transpose(1, 2).contiguous()
        merged = None
        for src in range(2):
            kw = dict(causal=True, q_offset=r * tl, k_offset=src * tl)
            part = check(f"ring_q{r}_kv{src}", qr,
                         kk[:, src * tl:(src + 1) * tl],
                         vv[:, src * tl:(src + 1) * tl], dor, lse, delta, kw,
                         masked=src > r)
            merged = part if merged is None else _zz_merge(*merged, *part)
        err_o = _compare(merged[0], full, 0.0, tol["out"])
        err_l = _compare(merged[1], lse, 0.0, tol["lse"])
        results.append({"case": f"ring_merge_q{r}", "err": {
            "out": err_o[0], "lse": err_l[0]}, "ok": err_o[1] and err_l[1]})
    c = tl // 2
    for name, causal, off in (("zigzag_diag", True, c), ("zigzag_full",
                                                          False, 0)):
        qc, kc, vc, dc = (x[:, :c] for x in (q, kk, vv, do))
        kw = dict(causal=causal, q_offset=off, k_offset=off)
        o, lse = fa.flash_fwd_reference(qc, kc, vc, **kw, **f32)
        delta = (dc.float() * o).sum(-1).transpose(1, 2).contiguous()
        check(name, qc, kc, vc, dc, lse, delta, kw)
    # the planted fault, on the last (full) block: keys of tile 3 left out
    r_dq = fa.flash_dq_reference(qc, kc, vc, dc, lse, delta, **kw, **g32)
    r_dk, r_dv = fa.flash_dkv_reference(qc, kc, vc, dc, lse, delta, **kw,
                                        **g32)
    cut = RING_BLOCK_TILE
    keep = torch.cat([torch.arange(3 * cut), torch.arange(4 * cut, c)]).to(
        device)
    f_out, f_lse = fa.flash_fwd_with_lse(qc, kc[:, keep], vc[:, keep],
                                         **kw, **f32)
    f_dq, dk_k, dv_k = fa.flash_block_grads(qc, kc[:, keep], vc[:, keep],
                                            dc, lse, delta, **kw, **g32)
    f_dk, f_dv = torch.zeros_like(r_dk), torch.zeros_like(r_dv)
    f_dk[:, keep], f_dv[:, keep] = dk_k, dv_k
    fault = {n: _compare(g, w, 0.0, tol[n]) for n, g, w in zip(
        ("out", "lse", "dq", "dk", "dv"), (f_out, f_lse, f_dq, f_dk, f_dv),
        (o, lse, r_dq, r_dk, r_dv))}
    q, kk, vv, do = _flash_inputs(b, 2 * tl, 2 * tl, h // 2, d,
                                  torch.bfloat16, gen, device)
    kw = dict(causal=True, q_offset=0, k_offset=0)
    o, lse = fa.flash_fwd_reference(q, kk, vv, **kw, **f32)
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    check("ulysses_local", q, kk, vv, do, lse, delta, kw)
    emit({"phase": "flash_ring_blocks", "atol": tol,
          "dtypes": "bf16 in, f32 out and gradients", "cases": results,
          "planted_fault": {"case": "zigzag_full without keys "
                                    f"[{3 * cut}, {4 * cut})",
                            "err": {n: x[0] for n, x in fault.items()}}})
    bad = [x for x in results if not x["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree on the ring's "
                             f"blocks: {bad}")
    passed = [n for n, x in fault.items() if x[1]]
    if passed:
        raise AssertionError(f"flash_ring_blocks: the planted fault passes "
                             f"the tolerance on {passed}: {fault}")


def phase_train(device):
    """The training path: the 220M LM with ``attention='flash'`` (bf16
    compute, f32 parameters, seed 0), ``create_communicator('pure_nccl')``
    (a one-rank NCCL group), ``create_multi_node_optimizer`` over
    ``AdamW(3e-4, weight_decay=1e-4)`` (optax ``adamw``'s decay) and
    ``lm_train_step``, on one seeded [8, 2048] batch with targets = tokens
    rolled by one, reused every step. 2 warm-up steps, then 10 timed
    steps closed by a device->host fetch of the loss."""
    import torch

    from chainermn_torch import (
        create_communicator,
        create_multi_node_optimizer,
    )
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.ops import flash_attention as fa
    from chainermn_torch.training import lm_train_step

    t0 = time.perf_counter()
    model = TransformerLM(**LM, attention="flash",
                          compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    comm = create_communicator("pure_nccl", device=device)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(torch.optim.AdamW(
        model.parameters(), lr=TRAIN["lr"],
        weight_decay=TRAIN["weight_decay"]), comm)
    step = lm_train_step(model, opt, comm)
    b, t = TRAIN["batch"], TRAIN["seq_len"]
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, LM["vocab_size"], (b, t), generator=gen)
    tokens = tokens.to(device)
    targets = torch.roll(tokens, -1, dims=1)
    t_setup = time.perf_counter() - t0

    counted = {name: getattr(fa, fn) for name, (fn, *_)
               in FLASH_KERNELS.items()}
    for fn in counted.values():
        fn.launches = 0
    losses = [step(tokens, targets)[0] for _ in range(TRAIN["warmup_steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(TRAIN["timed_steps"]):
        loss, stats = step(tokens, targets)
        losses.append(loss)
    last = float(loss)              # the device->host fetch closes the window
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(x) for x in losses]

    n_steps = TRAIN["warmup_steps"] + TRAIN["timed_steps"]
    n_params = sum(p.numel() for p in model.parameters())
    n_nonembed = n_params - (LM["vocab_size"] + LM["max_len"]) * LM["d_model"]
    h, dh = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    # analytic FLOPs of a step: the matmul tower fwd+bwd, plus causal
    # attention fwd+bwd in every layer
    flops = (6.0 * n_nonembed * b * t
             + 12.0 * b * h * t * t * dh / 2 * LM["n_layers"])
    step_s = wall / TRAIN["timed_steps"]
    rec = {"phase": "train", "model": dict(LM, params=n_params,
                                           nonembed_params=n_nonembed,
                                           attention="flash",
                                           compute_dtype="bf16"),
           "train": TRAIN, "communicator": repr(comm), "setup_s": t_setup,
           "step_ms": step_s * 1e3, "tokens_per_sec": b * t / step_s,
           "analytic_flop_per_step": flops,
           "analytic_tflops": flops / step_s / 1e12,
           "mfu_vs_989_tflops": flops / step_s / BF16_OPS_PER_S,
           "peak_memory_allocated_gb": peak / 1e9,
           "first_loss": losses[0], "last_loss": last, "losses": losses,
           "steps": n_steps, "launches": launches, "stats": stats}
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = n_steps * LM["n_layers"]
    if any(n != want for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {n_steps} steps "
                             f"x {LM['n_layers']} layers")
    phase_train_profile(step, tokens, targets, TRAIN["profile_steps"])
    del model, opt, step
    torch.cuda.empty_cache()
    return launches, comm


def phase_train_profile(step, tokens, targets, n_steps):
    """Where a train step's time goes: ``torch.profiler`` over
    ``n_steps`` steps. Device busy time is the sum of CUDA activity in the
    window, without user annotations (the optimizer's
    ``Optimizer.step#AdamW.step`` range spans kernels already counted);
    idle share is what is left of the host wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss, _ = step(tokens, targets)
        float(loss)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev)
    flash_us = {name: sum(e.self_device_time_total for e in dev
                          if kern in e.key)
                for name, (_, kern, *_) in FLASH_KERNELS.items()}
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    measured = busy_us > 0
    rec = {"phase": "train_profile", "steps": n_steps,
           "step_wall_ms": wall / n_steps * 1e3,
           "step_device_busy_ms": busy_us / n_steps / 1e3 if measured
           else "not measured",
           "device_idle_share": 1 - busy_us / 1e6 / wall if measured
           else "not measured",
           "flash_ms_per_step": {n: us / n_steps / 1e3
                                 for n, us in flash_us.items()},
           "flash_share_of_busy": (sum(flash_us.values()) / busy_us
                                   if measured else "not measured"),
           "top_device": [{"name": e.key[:70], "ms_per_step":
                           e.self_device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps}
                          for e in top]}
    emit(rec)
    return rec


def phase_flash_timing(device):
    """Each flash kernel, its plain version and a library yardstick at the
    training shape (B=8, T=2048, H=16, D=64, bf16, causal; q, k and v
    sliced from one fused qkv tensor as the model passes them), L2
    flushed before each timed call. Each kernel's outputs must agree with
    its plain version's within the bf16 tolerance, so the strided reads
    of the training path are held to a limit. The yardstick, which the port never
    calls, is ``F.scaled_dot_product_attention(is_causal=True)`` forward,
    and its backward as one number for dq, dk and dv together. The bound
    is the larger of the causal FLOPs this run needs (visible (q, k)
    pairs x 4 D for fwd, 6 D for dq, 8 D for dk/dv) at 989 TFLOP/s and
    each input read once plus each output written once at 3.35 TB/s.
    Each kernel runs twice on the same inputs and must give bitwise-equal
    outputs: no atomics, so the results are deterministic."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.ops import flash_attention as fa

    b, t = TRAIN["batch"], TRAIN["seq_len"]
    h, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    gen = torch.Generator().manual_seed(SEED + 5)
    q, k, v, do = _flash_inputs(b, t, t, h, d, torch.bfloat16, gen, device,
                                fused=True)
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    flush = scratch.zero_
    saved = {fn: getattr(fa, fn).launches for fn, *_
             in FLASH_KERNELS.values()}
    kw = dict(causal=True)
    gkw = dict(kw, grad_dtype=torch.bfloat16)
    out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd_with_lse(q, k, v, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, **kw)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, **gkw),
                     lambda: fa.flash_dq_reference(q, k, v, do, lse, delta,
                                                   **gkw)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, **gkw),
                      lambda: fa.flash_dkv_reference(q, k, v, do, lse,
                                                     delta, **gkw)),
    }
    pairs = b * h * t * (t + 1) // 2
    elem, rows = b * t * h * d, b * h * t
    work = {"flash_fwd": (4 * elem * 2 + rows * 4, 4 * d * pairs),
            "flash_dq": (5 * elem * 2 + 2 * rows * 4, 6 * d * pairs),
            "flash_dkv": (6 * elem * 2 + 2 * rows * 4, 8 * d * pairs)}

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def lib_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_do = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                   retain_graph=True)

    lib_err = float((lib_out.detach().transpose(1, 2).float()
                     - out.float()).abs().max())
    library = {"flash_fwd": cuda_ms(lib_fwd, flush=flush)}
    library["flash_dq"] = library["flash_dkv"] = cuda_ms(lib_bwd,
                                                         flush=flush)
    rtol, atol = TOL["bf16"]
    recs = {}
    for name, (kern, plain) in calls.items():
        got, again, want = kern(), kern(), plain()
        got, again, want = (x if isinstance(x, tuple) else (x,)
                            for x in (got, again, want))
        checks = [_compare(g, w, rtol, atol) for g, w in zip(got, want)]
        same = all(torch.equal(g, x) for g, x in zip(got, again))
        del got, again, want
        kernel_ms = cuda_ms(kern, flush=flush)
        plain_ms = cuda_ms(plain, reps=5, flush=flush)
        n_bytes, n_ops = work[name]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / BF16_OPS_PER_S * 1e3
        recs[name] = {"max_abs_err": max(c[0] for c in checks),
                      "within_tol": all(c[1] for c in checks),
                      "deterministic": same, "ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library[name],
                      "bytes": n_bytes, "ops": n_ops,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "tflops": n_ops / kernel_ms / 1e9}
        torch.cuda.empty_cache()
    # the same shape at D = 8 (the repo's small LM configurations), which
    # the wrapper runs padded to 64
    q, k, v, do = _flash_inputs(b, t, t, h, 8, torch.bfloat16, gen, device,
                                fused=True)
    out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for name, (kern, _) in calls.items():
        recs[name]["ms_D8"] = cuda_ms(kern, flush=flush)
    for fn, n in saved.items():
        getattr(fa, fn).launches = n
    emit({"phase": "flash_timing", "B": b, "T": t, "H": h, "D": d,
          "dtype": "bf16", "causal": True, "tol": TOL["bf16"],
          "library_call": "F.scaled_dot_product_attention(is_causal=True); "
                          "dq and dkv rows share its backward (dq, dk, dv)",
          "library_max_abs_err": lib_err, "kernels": recs})
    bad = [n for n, r in recs.items() if not r["within_tol"]]
    if bad:
        raise AssertionError(f"flash kernels {bad} disagree with their plain "
                             f"versions at the training shape")
    bad = [n for n, r in recs.items() if not r["deterministic"]]
    if bad:
        raise AssertionError(f"flash kernels {bad} gave different outputs "
                             f"for the same inputs")
    return recs


def phase_train_parity(device):
    """A small f32 LM (2 layers, d_model 256, 4 heads, T=256, B=4) built
    twice from one seed takes 3 steps with ``attention='flash'`` (the f32
    kernels) and 3 with ``'full'`` (plain attention): losses and
    parameters must agree to 1e-4. Adam's eps is 1e-5 on both: the key
    bias's gradient is zero in exact arithmetic, so each path computes it
    as rounding noise, which eps 1e-8 would turn into updates of up to
    ``lr`` of either sign."""
    import torch

    from chainermn_torch import (
        create_communicator,
        create_multi_node_optimizer,
    )
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.training import lm_train_step

    cfg = dict(vocab_size=1000, d_model=256, n_heads=4, n_layers=2,
               max_len=256)
    b, t, n_steps, tol = 4, 256, 3, 1e-4
    gen = torch.Generator().manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg["vocab_size"], (b, t), generator=gen)
    tokens = tokens.to(device)
    targets = torch.roll(tokens, -1, dims=1)
    comm = create_communicator("pure_nccl", device=device)
    runs = {}
    for attention in ("flash", "full"):
        model = TransformerLM(**cfg, attention=attention,
                              compute_dtype=torch.float32, device=device,
                              seed=SEED + 3)
        opt = create_multi_node_optimizer(torch.optim.AdamW(
            model.parameters(), lr=TRAIN["lr"], eps=1e-5,
            weight_decay=TRAIN["weight_decay"]), comm)
        step = lm_train_step(model, opt, comm)
        losses = [float(step(tokens, targets)[0]) for _ in range(n_steps)]
        runs[attention] = (losses, {n: w.detach() for n, w
                                    in model.named_parameters()})
    (l_f, p_f), (l_p, p_p) = runs["flash"], runs["full"]
    loss_err = max(abs(a - c) for a, c in zip(l_f, l_p))
    param_err = {n: float((p_f[n] - p_p[n]).abs().max()) for n in p_f}
    worst = max(param_err, key=param_err.get)
    ok = loss_err <= tol and param_err[worst] <= tol
    emit({"phase": "train_parity", "model": dict(cfg, compute_dtype="f32"),
          "B": b, "T": t, "steps": n_steps, "losses_flash": l_f,
          "losses_full": l_p, "loss_max_abs_err": loss_err,
          "param_max_abs_err": param_err[worst], "worst_param": worst,
          "tol": tol, "ok": ok})
    if not ok:
        raise AssertionError("flash-kernel training diverged from plain "
                             "attention training")


def _resnet_flops(model, images) -> float:
    """Analytic FLOPs of one forward from the model's own shapes: every
    convolution's ``2·K²·Cin·Cout·Hout·Wout`` and the head's
    ``2·in·out``, per image, times the batch (recorded by hooks over one
    forward without gradients)."""
    import torch

    from chainermn_torch.models.resnet import Conv

    total = [0.0]

    def conv_hook(mod, _, out):
        k2cc = mod.weight.shape[1] * mod.weight.shape[0] * mod.kernel ** 2
        total[0] += 2.0 * k2cc * out.shape[0] * out.shape[2] * out.shape[3]

    def head_hook(mod, _, out):
        total[0] += 2.0 * mod.in_features * mod.out_features * out.shape[0]

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv)]
    hooks.append(model.head.register_forward_hook(head_hook))
    with torch.no_grad():
        model(images, train=False)
    for h in hooks:
        h.remove()
    return total[0]


def phase_dp_train(device):
    """The data-parallel path at ``bench.py``'s headline configuration
    (``bench.py:156-244, 367-393``): ResNet-50 (conv7 stem, 1000 classes,
    f32 parameters, bf16 compute), a [256, 224, 224, 3] bf16 batch of
    seeded normal images with zero labels, ``create_communicator(
    'pure_nccl', allreduce_grad_dtype=bf16)`` on one NCCL rank,
    ``create_multi_node_optimizer(SGD(0.1, momentum=0.9))`` and
    ``train_step``. 3 warm-up steps, then 20 timed steps closed by a
    device->host fetch of the loss. MFU counts 3x the forward's analytic
    FLOPs against 989 TFLOP/s."""
    import torch

    from chainermn_torch import (
        create_communicator,
        create_multi_node_optimizer,
    )
    from chainermn_torch.interop import images_from_nhwc
    from chainermn_torch.models import ResNet50
    from chainermn_torch.training import train_step

    torch.backends.cudnn.benchmark = True
    t0 = time.perf_counter()
    model = ResNet50(num_classes=DP["num_classes"], device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    comm = create_communicator("pure_nccl", device=device,
                               allreduce_grad_dtype=torch.bfloat16)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(torch.optim.SGD(
        model.parameters(), lr=DP["lr"], momentum=DP["momentum"]), comm)
    step = train_step(model, opt, comm)
    b, s = DP["batch"], DP["image_size"]
    gen = torch.Generator(device=device).manual_seed(SEED)
    images = images_from_nhwc(torch.randn(
        (b, s, s, 3), generator=gen, device=device, dtype=torch.bfloat16))
    labels = torch.zeros(b, dtype=torch.long, device=device)
    fwd_flops = _resnet_flops(model, images)
    t_setup = time.perf_counter() - t0

    losses = [step(images, labels) for _ in range(DP["warmup_steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(DP["timed_steps"]):
        loss = step(images, labels)
        losses.append(loss)
    last = float(loss)              # the device->host fetch closes the window
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    losses = [float(x) for x in losses]
    step_s = wall / DP["timed_steps"]
    flops = 3.0 * fwd_flops
    rec = {"phase": "dp_train",
           "model": {"name": "ResNet50", "stem": "conv7", "params": n_params,
                     "compute_dtype": "bf16", "param_dtype": "f32"},
           "dp": DP, "communicator": repr(comm),
           "allreduce_grad_dtype": "bf16", "setup_s": t_setup,
           "step_ms": step_s * 1e3, "images_per_sec": b / step_s,
           "analytic_flop_per_step": flops,
           "analytic_tflops": flops / step_s / 1e12,
           "mfu_vs_989_tflops": flops / step_s / BF16_OPS_PER_S,
           "peak_memory_allocated_gb": peak / 1e9,
           "first_loss": losses[0], "last_loss": last, "losses": losses,
           "steps": len(losses)}
    emit(rec)
    if n_params != RESNET50_PARAMS:
        raise AssertionError(f"ResNet-50 has {n_params} parameters, the flax "
                             f"model {RESNET50_PARAMS}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    phase_dp_profile(step, images, labels, DP["profile_steps"])
    comm.finalize()
    del model, opt, step, images
    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    return rec


# device kernels of the data-parallel step by kind, matched on the
# lower-cased kernel name in this order
DP_KINDS = (
    ("all-reduce", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("sgd (foreach)", ("multi_tensor_apply",)),
    ("convolution", ("conv", "xmma", "cudnn", "cutlass", "implicit",
                     "fprop", "dgrad", "wgrad", "nvjet", "gemm")),
    ("max pool", ("max_pool",)),
    ("copy (casts, pads)", ("copy", "memcpy")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def _dp_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in DP_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_dp_profile(step, images, labels, n_steps):
    """Where a data-parallel step's time goes: ``torch.profiler`` over
    ``n_steps`` ResNet-50 steps; device busy and idle share as in
    ``train_profile``, device time by kind of kernel (``DP_KINDS``) and
    the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss = step(images, labels)
        float(loss)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev)
    measured = busy_us > 0
    # every kind, so one with no kernel (the one-rank all-reduce) shows 0
    kinds = {k: [0.0, 0] for k, _ in DP_KINDS + (("other", ()),)}
    for e in dev:
        kind = kinds[_dp_kind(e.key)]
        kind[0] += e.self_device_time_total
        kind[1] += e.count
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:15]
    rec = {"phase": "dp_profile", "steps": n_steps,
           "step_wall_ms": wall / n_steps * 1e3,
           "step_device_busy_ms": busy_us / n_steps / 1e3 if measured
           else "not measured",
           "device_idle_share": 1 - busy_us / 1e6 / wall if measured
           else "not measured",
           "by_kind": {k: {"ms_per_step": us / n_steps / 1e3,
                           "calls_per_step": n / n_steps,
                           "share_of_busy": us / busy_us if measured
                           else "not measured"}
                       for k, (us, n) in sorted(kinds.items(),
                                                key=lambda kv: -kv[1][0])},
           "top_device": [{"name": e.key[:90], "kind": _dp_kind(e.key),
                           "ms_per_step":
                           e.self_device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps}
                          for e in top]}
    emit(rec)
    return rec


# dp_parity: name -> (strategy, optimizer kind, wire dtype)
DP_CASES = {
    "naive": ("naive", "plain", None),
    "flat": ("flat", "plain", None),
    "pure_nccl": ("pure_nccl", "plain", None),
    "tpu": ("tpu", "plain", None),
    "pure_ici": ("pure_ici", "plain", None),
    "hierarchical": ("hierarchical", "plain", None),
    "non_cuda_aware": ("non_cuda_aware", "plain", None),
    "two_dimensional": ("two_dimensional", "plain", None),
    "single_node": ("single_node", "plain", None),
    "pure_nccl_bf16_wire": ("pure_nccl", "plain", "bf16"),
    "double_buffering": ("pure_nccl", "double_buffering", None),
    "zero1": ("pure_nccl", "zero", None),
    "zero1_clip": ("pure_nccl", "zero_clip", None),
}


def _dp_run(case, state, images, labels, device, n_steps):
    """``n_steps`` ``train_step``s of the small ResNet from ``state`` on
    one batch: losses and the final ``state_dict`` (on the CPU)."""
    import warnings

    import torch

    from chainermn_torch import (
        clip_by_global_norm_sharded,
        create_communicator,
        create_multi_node_optimizer,
        create_zero_optimizer,
    )
    from chainermn_torch.models import ResNet
    from chainermn_torch.training import train_step

    strategy, kind, wire = case
    model = ResNet(**DP_PARITY["model"], compute_dtype=torch.float32,
                   device=device)
    model.load_state_dict(state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # non_cuda_aware warns
        comm = create_communicator(
            strategy, device=device,
            allreduce_grad_dtype=torch.bfloat16 if wire else None)
    sgd = torch.optim.SGD(model.parameters(), lr=DP["lr"],
                          momentum=DP["momentum"])
    if kind.startswith("zero"):
        clip = (clip_by_global_norm_sharded(DP_PARITY["clip"], comm)
                if kind == "zero_clip" else None)
        opt = create_zero_optimizer(sgd, comm, grad_transform=clip)
    else:
        opt = create_multi_node_optimizer(
            sgd, comm, double_buffering=kind == "double_buffering")
    step = train_step(model, opt, comm)
    losses = [step(images.to(device), labels.to(device))
              for _ in range(n_steps)]
    losses = [float(x) for x in losses]
    out = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    comm.finalize()
    return losses, out, type(comm).__name__


def phase_dp_parity(device):
    """Every strategy name, a bf16 wire, double buffering and ZeRO-1
    (with and without the sharded clip) train a small f32 ResNet
    (``stage_sizes=[1, 1, 1, 1]``, width 8, 10 classes, 32x32) for 3
    steps on one seeded batch, from one seeded ``state_dict``, on the
    card (one NCCL rank) and on the CPU (one gloo rank): losses,
    parameters and running statistics must agree within
    ``DP_PARITY['tol']``. On the card, each strategy's first step on
    zero images from a fresh model must give ln 10 (uniform logits from
    the zero head bias) within 1e-3, and all within 1e-5 of each other
    (``__graft_entry__.py:147-158``)."""
    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.models import ResNet

    cfg, s, b = DP_PARITY["model"], DP_PARITY["image_size"], DP_PARITY["batch"]
    gen = torch.Generator().manual_seed(SEED + 6)
    state = ResNet(**cfg, compute_dtype=torch.float32, device="cpu",
                   seed=SEED + 6).state_dict()
    images = torch.randn((b, s, s, 3), generator=gen).permute(0, 3, 1, 2)
    labels = torch.randint(0, cfg["num_classes"], (b,), generator=gen)
    zeros = torch.zeros((b, 3, s, s)).to(memory_format=torch.channels_last)
    zero_labels = torch.zeros(b, dtype=torch.long)
    torch.backends.cudnn.deterministic = True
    runs, known = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        world = create_communicator("naive", device=dev)   # owns the group
        for name, case in DP_CASES.items():
            runs[(name, where)] = _dp_run(case, state, images, labels, dev,
                                          DP_PARITY["steps"])
            if where == "card":
                known[name] = _dp_run(case, state, zeros, zero_labels, dev,
                                      1)[0][0]
        world.finalize()
    torch.backends.cudnn.deterministic = False
    tol = DP_PARITY["tol"]
    results = []
    for name in DP_CASES:
        (l_gpu, s_gpu, cls), (l_cpu, s_cpu, _) = (runs[(name, "card")],
                                                  runs[(name, "cpu")])
        errs = {k: float((s_gpu[k].float() - s_cpu[k].float()).abs().max())
                for k in s_gpu if s_gpu[k].is_floating_point()}
        worst = max(errs, key=errs.get)
        loss_err = max(abs(a - c) for a, c in zip(l_gpu, l_cpu))
        results.append({
            "case": name, "class": cls, "losses_card": l_gpu,
            "losses_cpu": l_cpu, "loss_max_abs_err": loss_err,
            "state_max_abs_err": errs[worst], "worst": worst,
            "known_answer_loss": known[name],
            "ok": (loss_err <= tol and errs[worst] <= tol
                   and all(math.isfinite(x) for x in l_gpu))})
    ln10 = math.log(10.0)
    known_err = max(abs(v - ln10) for v in known.values())
    known_spread = max(known.values()) - min(known.values())
    emit({"phase": "dp_parity", "model": dict(cfg, compute_dtype="f32"),
          "image_size": s, "batch": b, "steps": DP_PARITY["steps"],
          "tol": tol, "known_answer_err": known_err,
          "known_answer_spread": known_spread, "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"data-parallel training on the card diverged "
                             f"from the CPU: {bad}")
    if known_err > 1e-3 or known_spread > 1e-5:
        raise AssertionError(f"known answer: losses {known} against ln 10")


# the ImageNet trainer twin at full width (ResNet-50, 224x224, 1000
# classes, batch 256 a rank, one NCCL rank, a bf16 wire) in each mode:
# name -> (flags, native loader asked for)
IMAGENET = ["--arch", "resnet50", "--classes", "1000", "--image-size", "224",
            "--communicator", "pure_nccl", "--dtype", "bfloat16",
            "--n-synthetic", "16384"]
IMAGENET_MODES = {
    # the recipe (warmup-cosine LR over 90 epochs, label smoothing,
    # held-out top-1) on the native C++ loader and the device prefetcher
    "a_recipe_native_prefetch": (
        ["--batchsize", "256", "--recipe", "--epoch", "90", "--val-frac",
         "0.02", "--native-loader", "--device-prefetch", "2",
         "--iterations", "30"], True),
    # the numpy collate on the loop's thread
    "b_numpy_collate": (["--batchsize", "256", "--no-native-loader",
                         "--iterations", "8"], False),
    # the two other layouts run on NCCL
    "c_fsdp": (["--batchsize", "64", "--fsdp", "--iterations", "5"], False),
    "c_mnbn_double_buffering": (["--batchsize", "64", "--mnbn",
                                 "--double-buffering", "--iterations", "5"],
                                False),
}
IMAGENET_PROFILE = dict(wait=2, active=3)   # loop iterations


def _twin(argv, step_callback=None):
    """The twin's ``main(argv)`` with its printed lines captured."""
    import contextlib
    import io

    from chainermn_torch.examples.imagenet.train_imagenet import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = main(argv, step_callback=step_callback)
    return summary, buf.getvalue().splitlines()


def _profiled_twin(argv, wait, active):
    """The twin for ``wait + active`` iterations with ``torch.profiler``
    over the last ``active`` loop iterations (input pipeline included),
    the card synchronized at both ends of the window: device kernel time,
    device copy time and the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def callback(iteration, loss):
        if iteration in (wait, wait + active):
            torch.cuda.synchronize()
            window[iteration] = time.perf_counter()
            (prof.start if iteration == wait else prof.stop)()

    _twin(argv + ["--iterations", str(wait + active)], callback)
    wall = window[wait + active] - window[wait]
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    copies = sum(e.self_device_time_total for e in dev
                 if e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(e.self_device_time_total for e in dev) - copies
    return kernels / 1e6, copies / 1e6, wall


def phase_imagenet(device, step_images_per_sec):
    """The ImageNet trainer twin (``chainermn_torch.examples.imagenet.
    train_imagenet.main``) in process at full width, in each of
    IMAGENET_MODES: a timed run (the loop's images/s excludes the first
    iteration, as the reference's does), then a profiled run of
    IMAGENET_PROFILE's iterations for the device idle share (kernel time
    over the window's wall time; the copies are reported beside it). One
    JSON line per mode, beside dp_train's step-only images/s. Fails if a
    loss is not finite, a mode prints no ``done:`` line, or the native
    loader was asked for and did not run."""
    import torch

    torch.backends.cudnn.benchmark = True
    records = []
    for mode, (flags, native) in IMAGENET_MODES.items():
        argv = IMAGENET + flags
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        summary, printed = _twin(argv)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        cut = argv.index("--iterations")
        kernel_s, copy_s, wall = _profiled_twin(
            argv[:cut] + argv[cut + 2:], **IMAGENET_PROFILE)
        done = [ln for ln in printed if ln.startswith("done: ")]
        rec = {"phase": "imagenet", "mode": mode, "argv": argv,
               "printed": printed, "run_s": run_s,
               "iterations": summary["iterations"],
               "loop_images_per_sec": summary["images_per_sec"],
               "dp_train_step_images_per_sec": step_images_per_sec,
               "loop_over_step": (summary["images_per_sec"]
                                  / step_images_per_sec
                                  if summary["images_per_sec"] else None),
               "native_loader": summary["native_loader"],
               "h2d_seconds_per_batch": summary["h2d_seconds_per_batch"],
               "profiled_iterations": IMAGENET_PROFILE["active"],
               "profiled_wall_ms_per_iter":
                   wall / IMAGENET_PROFILE["active"] * 1e3,
               "device_kernel_ms_per_iter":
                   kernel_s / IMAGENET_PROFILE["active"] * 1e3,
               "device_copy_ms_per_iter":
                   copy_s / IMAGENET_PROFILE["active"] * 1e3,
               "device_idle_share": (1 - kernel_s / wall) if kernel_s > 0
               else "not measured",
               "peak_memory_allocated_gb": peak / 1e9,
               "top1": summary["top1"], "params": summary["params"],
               "losses": summary["losses"],
               "losses_finite": summary["losses_finite"]}
        emit(rec)
        records.append(rec)
        if not summary["losses_finite"]:
            raise AssertionError(f"imagenet {mode}: a loss is not finite")
        if not done:
            raise AssertionError(f"imagenet {mode}: no 'done:' line")
        if native and not summary["native_loader"]:
            raise AssertionError(f"imagenet {mode}: the native loader was "
                                 "asked for and did not run")
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    return records


# the example twins' phases (their JAX scripts' defaults, nothing cut).
# The JAX examples' own figures at the same arguments on the CPU
# (examples/mnist/train_mnist.py on one device, examples/mnist/
# train_mnist_model_parallel.py and examples/seq2seq/seq2seq.py on two,
# JAX_PLATFORMS=cpu): final validation accuracy, token accuracy
JAX_CPU = {"mnist_val_accuracy": 1.0, "mnist_mp_val_accuracy": 1.0,
           "seq2seq_token_accuracy": 0.8955}
MNIST_GATE = 0.9                   # the JAX figure clears it
CKPT_STOP_AT = 123                 # crash after 123 of 200 iterations
MP_PARITY_STEPS = 3


def _lines(run):
    """``run()``'s result and the lines it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run()
    return out, buf.getvalue().splitlines()


def phase_mnist(device, card):
    """The data-parallel MNIST twin (``chainermn_torch.examples.mnist.
    train_mnist.main``) in process on one NCCL rank at its defaults
    (batch 100, unit 1000, 20 epochs, 10,000/2,000 synthetic images).
    Fails unless every loss is finite, the last epoch's loss is below the
    first step's and the final validation accuracy is at least
    MNIST_GATE."""
    import torch

    from chainermn_torch.examples.mnist.train_mnist import main as twin

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    summary, printed = _lines(lambda: twin(["--communicator", "pure_nccl"]))
    run_s = time.perf_counter() - t0
    epochs = summary["epochs"]
    losses = [summary["first_loss"]] + [e["loss"] for e in epochs]
    acc = epochs[-1]["validation/main/accuracy"]
    rec = {"phase": "mnist", "card": card, "printed": printed,
           "run_s": run_s, "steps": summary["steps"],
           "images_per_sec": summary["steps"] * summary["global_batch"]
           / summary["train_seconds"],
           "step_ms": summary["train_seconds"] / summary["steps"] * 1e3,
           "first_loss": summary["first_loss"],
           "epoch_losses": [e["loss"] for e in epochs],
           "val_accuracy": [e["validation/main/accuracy"] for e in epochs],
           "jax_cpu_val_accuracy": JAX_CPU["mnist_val_accuracy"],
           "peak_memory_allocated_gb":
               torch.cuda.max_memory_allocated(device) / 1e9}
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mnist: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mnist: the loss did not fall: {losses}")
    if acc < MNIST_GATE:
        raise AssertionError(f"mnist: val accuracy {acc} < {MNIST_GATE}")


def _snapshot_leaves(path):
    """The leaves of one snapshot file, by path in its tree."""
    import pickle

    from chainermn_torch.extensions.checkpoint import _strip_footer

    payload, verified = _strip_footer(Path(path).read_bytes())
    if not verified:
        raise AssertionError(f"{path}: the checksum does not match")
    out = {}

    def walk(tree, at):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{at}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{at}/{i}")
        else:
            out[at] = tree
    walk(pickle.loads(payload)["state"], "")
    return out


def phase_mnist_checkpoint(card):
    """The checkpoint twin (``python -m chainermn_torch.examples.mnist.
    train_mnist_checkpoint``) at its defaults, three runs on the card: an
    uninterrupted one, one with ``--stop-at CKPT_STOP_AT`` (must exit
    non-zero after "simulated crash"), and a resumed one (must print
    "resumed from iteration K'", K' the newest snapshot at or before the
    crash). Fails unless the resumed run's last snapshot equals the
    uninterrupted run's, leaf by leaf (the largest difference is
    reported; the target is 0)."""
    import tempfile

    import numpy as np

    cmd = [sys.executable, "-m",
           "chainermn_torch.examples.mnist.train_mnist_checkpoint",
           "--communicator", "pure_nccl"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra, out in (("uninterrupted", [], "a"),
                                 ("crash", ["--stop-at", str(CKPT_STOP_AT)],
                                  "b"),
                                 ("resumed", [], "b")):
            t0 = time.perf_counter()
            r = subprocess.run(cmd + ["--out", str(Path(tmp) / out)] + extra,
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=600)
            printed = r.stdout.splitlines()
            runs[name] = {"rc": r.returncode, "s": time.perf_counter() - t0,
                          "printed": printed[:2] + printed[-2:],
                          "stderr_tail": r.stderr[-2000:]}
        snaps = {k: sorted(Path(tmp, k).glob("snapshot_mnist_example_*.0"),
                           key=lambda p: int(p.name.split("_")[-1][:-2]))
                 for k in ("a", "b")}
        last = {k: v[-1].name for k, v in snaps.items() if v}
        diffs, same_leaves = {}, False
        if len(last) == 2 and last["a"] == last["b"]:
            a, b = (_snapshot_leaves(snaps[k][-1]) for k in ("a", "b"))
            same_leaves = list(a) == list(b)
            for k in a:
                x, y = np.asarray(a[k]), np.asarray(b.get(k))
                if x.dtype.kind in "fiu" and x.shape == y.shape:
                    diffs[k] = float(np.abs(x.astype(np.float64)
                                            - y.astype(np.float64)).max()
                                     if x.size else 0.0)
                else:
                    diffs[k] = 0.0 if repr(a[k]) == repr(b.get(k)) else \
                        float("inf")
    expect = CKPT_STOP_AT // 5 * 5
    stats = [ln for ln in runs["resumed"]["printed"]
             if ln.startswith("finished at iteration")]
    resumed_from = [ln for ln in runs["resumed"]["printed"]
                    if ln.startswith("resumed from")]
    rec = {"phase": "mnist_checkpoint", "card": card, "runs": runs,
           "last_snapshots": last, "leaves": len(diffs),
           "max_abs_diff": max(diffs.values()) if diffs else None,
           "checkpoint_stats": stats}
    emit(rec)
    if runs["uninterrupted"]["rc"] or runs["resumed"]["rc"]:
        raise AssertionError("mnist_checkpoint: a run failed")
    if not runs["crash"]["rc"] or not any(
            "simulated crash" in ln for ln in runs["crash"]["printed"]):
        raise AssertionError("mnist_checkpoint: the crash run did not crash")
    if resumed_from != [f"resumed from iteration {expect}"]:
        raise AssertionError(f"mnist_checkpoint: did not resume from {expect}")
    if not same_leaves or rec["max_abs_diff"] != 0.0:
        raise AssertionError("mnist_checkpoint: the resumed run's last "
                             "snapshot differs from the uninterrupted run's")


# two ranks on one card: a gloo default group (NCCL refuses two ranks on
# one device), which the twin's communicator joins; parameters and compute
# stay on the card, the boundary tensors are staged through the host
_TWO_RANKS_ON_ONE_CARD = """
import contextlib, io, os, time
import torch
import torch.distributed as dist

dist.init_process_group("gloo", init_method="env://", rank=RANK,
                        world_size=int(os.environ["WORLD_SIZE"]))
import importlib
main = importlib.import_module(ARGS[0]).main
torch.cuda.reset_peak_memory_stats()
buf = io.StringIO()
t0 = time.perf_counter()
with contextlib.redirect_stdout(buf):
    summary = main(["--device", "cuda"])
summary["run_s"] = time.perf_counter() - t0
summary["printed"] = buf.getvalue().splitlines()
summary["peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
summary["backend"] = dist.get_backend()
if len(ARGS) > 1:
    # the host-staged transfer alone: round trips of the boundary tensor
    # (and of one float, the fixed cost) over the same comm.send/recv
    from chainermn_torch import create_communicator

    comm = create_communicator("naive", device="cuda")
    peer = 1 - comm.rank
    summary["pingpong_ms"] = {}
    for name, shape in (("boundary", [int(n) for n in ARGS[1].split(",")]),
                        ("one_float", [1])):
        x = torch.randn(shape, device="cuda")
        for i in range(53):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if comm.rank == 0:
                comm.send(x, peer)
                x = comm.recv(peer)
            else:
                comm.send(comm.recv(peer), peer)
        torch.cuda.synchronize()
        # one way, averaged over 50 round trips
        summary["pingpong_ms"][name] = (time.perf_counter() - t0) / 100 * 1e3
    comm.finalize()
save(summary)
dist.destroy_process_group()
"""


def _two_ranks(module, *pingpong_shape):
    from chainermn_torch.testing import run_ranks

    return run_ranks(_TWO_RANKS_ON_ONE_CARD, 2,
                     args=[module, *pingpong_shape], timeout=600)


def _mp_one_process(device, n_steps):
    """The model-parallel twin's two stages as one module in one process
    (the same seeded weights, batches and per-stage Adam): its first
    ``n_steps`` losses."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch import SerialIterator
    from chainermn_torch.examples.mnist import train_mnist_model_parallel as mp
    from chainermn_torch.examples.mnist.train_mnist import (
        ArrayDataset, collate, load_mnist)

    stages = [mp.MLPHalf0(500).to(device), mp.MLPHalf1(500).to(device)]
    model = torch.nn.Sequential(*stages)
    opts = [torch.optim.Adam(s.parameters(), lr=1e-3) for s in stages]
    (x, y), _ = load_mnist(None, 8000, 1000)
    it = SerialIterator(ArrayDataset(x, y), 100, shuffle=True, seed=1)
    losses = []
    for _ in range(n_steps):
        images, labels = collate(next(it))
        for o in opts:
            o.zero_grad()
        loss = F.cross_entropy(model(torch.as_tensor(images, device=device)),
                               torch.as_tensor(labels, device=device).long())
        loss.backward()
        for o in opts:
            o.step()
        losses.append(float(loss))
    return losses


def phase_mnist_mp(device, card):
    """The model-parallel MNIST twin as two processes on the card (stage 0
    on rank 0, stage 1 on rank 1) at its defaults (unit 500, batch 100,
    10 epochs, 8,000/1,000 images). Fails unless every parameter is on
    the card, the losses are finite and fall, the final validation
    accuracy is at least MNIST_GATE, the first MP_PARITY_STEPS losses
    match the two stages in one process to 1e-5, and each rank ran one
    forward and one backward transfer a step. After training the two
    ranks time round trips of the boundary tensor alone over the same
    host-staged path (the transfer's own cost, apart from waiting for the
    other stage)."""
    t0 = time.perf_counter()
    ranks = _two_ranks("chainermn_torch.examples.mnist."
                       "train_mnist_model_parallel", "100,500")
    run_s = time.perf_counter() - t0
    ref = _mp_one_process(device, MP_PARITY_STEPS)
    stage1 = ranks[1]
    losses = stage1["losses"]
    parity = max(abs(a - b) for a, b in zip(losses, ref))
    per_rank = []
    for r, out in enumerate(ranks):
        t = out["transfers"]
        n = t["forward"] + t["backward"]
        per_rank.append({
            "rank": r, "backend": out["backend"], "steps": out["steps"],
            "param_devices": out["param_devices"],
            "n_params": out["n_params"],
            "step_ms": out["train_seconds"] / out["steps"] * 1e3,
            "transfers_forward": t["forward"],
            "transfers_backward": t["backward"],
            "bytes_per_transfer": t["bytes"] / n if n else None,
            "transfer_ms_per_step": t["seconds"] / out["steps"] * 1e3,
            "send_recv_share_of_step": t["seconds"] / out["train_seconds"],
            "pingpong_one_way_ms": out["pingpong_ms"],
            "peak_memory_allocated_gb": out["peak_memory_allocated_gb"],
            "run_s": out["run_s"]})
    acc = stage1["epochs"][-1]["validation/main/accuracy"]
    rec = {"phase": "mnist_mp", "card": card, "printed": ranks[0]["printed"],
           "run_s": run_s, "ranks": per_rank,
           "epoch_losses": [e["loss"] for e in stage1["epochs"]],
           "val_accuracy": [e["validation/main/accuracy"]
                            for e in stage1["epochs"]],
           "jax_cpu_val_accuracy": JAX_CPU["mnist_mp_val_accuracy"],
           "first_losses": losses[:MP_PARITY_STEPS],
           "one_process_losses": ref, "parity_max_abs_diff": parity}
    emit(rec)
    for p in per_rank:
        if p["param_devices"] != ["cuda"]:
            raise AssertionError(f"mnist_mp: rank {p['rank']} holds "
                                 f"parameters on {p['param_devices']}")
        if p["transfers_forward"] != p["steps"] or \
                p["transfers_backward"] != p["steps"]:
            raise AssertionError(f"mnist_mp: rank {p['rank']} ran "
                                 "other than one transfer each way a step")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError("mnist_mp: the losses are not finite or did "
                             "not fall")
    if acc < MNIST_GATE:
        raise AssertionError(f"mnist_mp: val accuracy {acc} < {MNIST_GATE}")
    if not parity <= 1e-5:
        raise AssertionError(f"mnist_mp: {losses[:MP_PARITY_STEPS]} against "
                             f"one process's {ref}")


def phase_seq2seq_mp(card):
    """The seq2seq twin as two processes on the card (the GRU encoder on
    rank 0, the decoder on rank 1) at its defaults (unit 64, vocab 16,
    seq 8, batch 64, 20 epochs, 2,048 pairs). Fails unless every loss is
    finite and the last epoch's token accuracy is above the first's."""
    t0 = time.perf_counter()
    ranks = _two_ranks("chainermn_torch.examples.seq2seq.seq2seq")
    epochs = ranks[0]["epochs"]
    acc = [e["token_accuracy"] for e in epochs]
    losses = [e["loss"] for e in epochs]
    rec = {"phase": "seq2seq_mp", "card": card, "printed": ranks[0]["printed"],
           "run_s": time.perf_counter() - t0,
           "param_devices": [out["param_devices"] for out in ranks],
           "steps": ranks[1]["steps"],
           "step_ms": ranks[1]["train_seconds"] / ranks[1]["steps"] * 1e3,
           "epoch_losses": losses, "token_accuracy": acc,
           "jax_cpu_token_accuracy": JAX_CPU["seq2seq_token_accuracy"]}
    emit(rec)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"seq2seq_mp: a loss is not finite: {losses}")
    if not acc[-1] > acc[0]:
        raise AssertionError(f"seq2seq_mp: token accuracy did not rise: {acc}")


# --------------------------------------------------------------------------- #
# Context and tensor parallelism: ranks as processes on the one card          #
# --------------------------------------------------------------------------- #
# NCCL refuses two ranks on one device, so these phases start the ranks as
# processes on cuda:0 over a gloo group: parameters and compute stay on the
# card, every transfer is staged through the host by the communicator
# (HOST_STAGED counts it). They prove the paths correct and on the kernels;
# they price nothing about NCCL between cards.

SP_KINDS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
            "ulysses_flash")
# sp_parity: the 220M LM's attention shape, global T over 2 ranks;
# (rtol, atol). bf16 is flash_parity's: one bf16 ulp is 1.6e-2 at
# |x| >= 2, and the plain kinds do not round p to bf16 before PV as the
# kernels do, so an absolute 2e-2 alone fails on a 1-ulp difference
SP_PARITY = dict(batch=8, seq_len=2048, heads=16, head_dim=64,
                 tol={"f32": (0.0, 1e-4), "bf16": TOL["bf16"]})
# sp_train / tp_train: the train phase's LM, batch and AdamW over 2 ranks,
# held to the one-process flash LM trained alike: every step's loss
# (loss_tol, by phase) and the first step's global gradient, by the
# largest relative L2 error of a leaf (grad_rel_tol), both bf16, a few
# times the sound readings; planted faults read in the same run must
# exceed grad_rel_tol (readings in PERF.md section 6). TP's losses drift
# further: its row-parallel partial sums are rounded to bf16 before they
# are summed, and the trajectory rises at step 6, which amplifies that
SP_TRAIN = dict(batch=8, seq_len=2048, warmup_steps=2, timed_steps=5,
                kinds=("ring_flash", "zigzag_flash", "ulysses_flash"),
                loss_tol={"sp_train": 2e-2, "tp_train": 0.15},
                grad_rel_tol=5e-2, small_tol=1e-4)
SMALL_LM = dict(vocab_size=1000, d_model=256, n_heads=4, n_layers=2,
                max_len=256)
SMALL_BATCH = (4, 256)
# hybrid: __graft_entry__.py:278-307 — d_model 16, 8 heads, vocab 8 tp
HYBRID = dict(shape=(2, 2, 2), vocab_size=16, d_model=16, n_heads=8,
              n_layers=1, max_len=128, batch=4, seq_len=12, steps=5,
              lr=1e-2)

_GLOO_RANKS = """
import os
import torch
import torch.distributed as dist

dist.init_process_group("gloo", init_method="env://", rank=RANK,
                        world_size=int(os.environ["WORLD_SIZE"]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
save(getattr(chip_smoke, ARGS[0])(*ARGS[1:]))
dist.destroy_process_group()
"""


def _gloo_ranks(fn: str, n: int, *args):
    """``chip_smoke.<fn>(*args)`` in ``n`` processes on cuda:0 joined by a
    gloo group; what each returned, by rank."""
    from chainermn_torch.testing import run_ranks

    return run_ranks(_GLOO_RANKS, n, args=[fn, *args], timeout=900)


def _flash_counts():
    from chainermn_torch.ops import flash_attention as fa

    return {name: getattr(fa, fn).launches
            for name, (fn, *_) in FLASH_KERNELS.items()}


def _zero_flash_counts():
    from chainermn_torch.ops import flash_attention as fa

    for fn, *_ in FLASH_KERNELS.values():
        getattr(fa, fn).launches = 0


def _staged():
    from chainermn_torch.communicators import process_group_communicator

    return dict(process_group_communicator.HOST_STAGED)


def _launches_per_attention(kind: str, causal: bool, n: int) -> int:
    """Kernel launches of each flash kernel for one attention call (its
    forward and backward) on one rank of ``n``."""
    if kind == "ring_flash" or (kind == "zigzag_flash" and not causal):
        return n
    return {"zigzag_flash": 2 * n + 1, "ulysses_flash": 1}.get(kind, 0)


def rank_sp_parity():
    """One rank of sp_parity: every kind, causal and not, f32 and bf16, at
    B=8, global T=2048, H=16, D=64; this rank's shard of the output and
    q/k/v gradients against one process's ``flash_attention`` on the
    whole sequence."""
    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.ops import flash_attention as fa
    from chainermn_torch.parallel import sequence as sq

    dev = torch.device("cuda", 0)
    comm = create_communicator("naive", device=dev)
    n, r = comm.size, comm.rank
    cfg = SP_PARITY
    b, t, h, d = cfg["batch"], cfg["seq_len"], cfg["heads"], cfg["head_dim"]
    tl = t // n
    gen = torch.Generator().manual_seed(SEED + 8)
    inputs = [torch.randn((b, t, h, d), generator=gen) for _ in range(4)]
    cases = []
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, do = (x.to(dev, dt) for x in inputs)
        for causal in (True, False):
            qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
            ref = fa.flash_attention(qr, kr, vr, causal=causal)
            ref.backward(do)
            want = [x.detach() for x in (ref, qr.grad, kr.grad, vr.grad)]
            del qr, kr, vr, ref
            for kind in SP_KINDS:
                layout = (sq.zigzag_permutation(t, n)
                          if kind.startswith("zigzag") and causal
                          else torch.arange(t))
                mine = layout[r * tl:(r + 1) * tl].to(dev)
                qs, ks, vs = (x[:, mine].detach().requires_grad_()
                              for x in (q, k, v))
                f = sq.sequence_parallel_attention(kind, comm, causal=causal)
                torch.cuda.synchronize()
                _zero_flash_counts()
                staged0 = _staged()
                t0 = time.perf_counter()
                out = f(qs, ks, vs)
                out.backward(do[:, mine])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                staged = _staged()
                got = (out, qs.grad, ks.grad, vs.grad)
                checks = {name: _compare(g, w[:, mine], *cfg["tol"][dname])
                          for name, g, w in zip(("out", "dq", "dk", "dv"),
                                                got, want)}
                cases.append({
                    "kind": kind, "causal": causal, "dtype": dname,
                    "err": {name: c[0] for name, c in checks.items()},
                    "ok": all(c[1] for c in checks.values()),
                    "launches": _flash_counts(),
                    "launches_want": _launches_per_attention(kind, causal, n),
                    "staged_bytes": staged["bytes"] - staged0["bytes"],
                    "staged_s": staged["seconds"] - staged0["seconds"],
                    "fwd_bwd_ms": ms})
                del qs, ks, vs, out, got
            del want
            torch.cuda.empty_cache()
    comm.finalize()
    return cases


def phase_sp_parity(card):
    """The six sequence-parallel kinds on 2 ranks of the card
    (``rank_sp_parity``). Fails unless every output and gradient is
    within SP_PARITY's tolerance (f32 1e-4 absolute; bf16 2e-2 absolute
    plus 2e-2 relative, both sides in bf16) of one process's flash
    attention, and every ``_flash`` kind
    launched each flash kernel the expected number of times a call:
    ``ring_flash`` n, ``zigzag_flash`` 2n + 1 (n when not causal),
    ``ulysses_flash`` 1; the plain kinds none."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_sp_parity", 2)
    cases = []
    for i, c0 in enumerate(ranks[0]):
        per = [rk[i] for rk in ranks]
        cases.append({
            "kind": c0["kind"], "causal": c0["causal"], "dtype": c0["dtype"],
            "err": {k: max(p["err"][k] for p in per) for k in c0["err"]},
            "ok": all(p["ok"] for p in per),
            "launches_per_rank": [p["launches"] for p in per],
            "launches_want": c0["launches_want"],
            "staged_bytes_per_rank": [p["staged_bytes"] for p in per],
            "staged_s_per_rank": [p["staged_s"] for p in per],
            "fwd_bwd_ms_per_rank": [p["fwd_bwd_ms"] for p in per]})
    emit({"phase": "sp_parity", "card": card, "ranks": 2, "backend": "gloo",
          "shape": {k: SP_PARITY[k] for k in ("batch", "seq_len", "heads",
                                              "head_dim")},
          "tol_rtol_atol": SP_PARITY["tol"],
          "run_s": time.perf_counter() - t0,
          "reference": "one process's flash_attention on the whole sequence",
          "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"sp_parity: kinds disagree with one-process "
                             f"flash attention: {bad}")
    bad = [c for c in cases for counts in c["launches_per_rank"]
           if any(v != c["launches_want"] for v in counts.values())]
    if bad:
        raise AssertionError(f"sp_parity: flash launches off: {bad}")
    return cases


def _lm_batch(device, b, t, vocab, seed):
    import torch

    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, vocab, (b, t), generator=gen).to(device)
    return tokens, torch.roll(tokens, -1, dims=1)


def _dense_names(tree: dict, n_heads: int, d_head: int, n_tp) -> dict:
    """A TP model's leaves (weights or gradients) by the dense LM's names,
    the qkv columns in the dense order (``reshard_tp_qkv`` to degree 1);
    ``n_tp=None`` keeps them as they are."""
    from chainermn_torch.parallel.tensor import reshard_tp_qkv

    if n_tp is None:
        return dict(tree)
    tree = reshard_tp_qkv(tree, n_heads, d_head, n_tp, 1)
    return {k.replace("attn.", "").replace("mlp.", ""): w
            for k, w in tree.items()}


def _grad_error(grads: dict, ref: dict) -> dict:
    """The largest relative L2 error of a leaf, ||g - ref|| / ||ref||,
    and the leaf's name."""
    errs = {n: float((grads[n].float() - r.float()).norm()
                     / r.float().norm()) for n, r in ref.items()}
    worst = max(errs, key=errs.get)
    return {"max_rel": errs[worst], "leaf": worst}


def _model_grads(model, n_tp=None, scale_sliced: float = 1.0) -> dict:
    """``model``'s gradients by dense name (``scale_sliced`` multiplies a
    TP model's sliced leaves: a planted fault)."""
    from chainermn_torch.parallel.tensor import sliced_parameters

    sliced = {id(p) for p in sliced_parameters(model)} if n_tp else set()
    grads = {n: p.grad * scale_sliced if id(p) in sliced else p.grad
             for n, p in model.named_parameters()}
    return _dense_names(grads, model.n_heads, model.d_model // model.n_heads,
                        n_tp)


def _reference_run(model, tokens, targets, steps):
    """``model`` trained ``steps`` AdamW steps (TRAIN's) on the whole batch
    in this process: its losses and its first step's gradients."""
    import torch
    import torch.nn.functional as F

    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"],
                            weight_decay=TRAIN["weight_decay"])
    losses, grads = [], None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logits = model(tokens)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
        opt.step()
        losses.append(float(loss))
    return losses, grads


@contextlib.contextmanager
def _offdiag_dkv_dropped():
    """A planted fault: the sequence kinds' dk and dv of every K/V block
    but a rank's own (diagonal) one are lost, as when the accumulators
    that travel with their block are mis-routed."""
    import torch

    from chainermn_torch.parallel import sequence

    real = sequence.flash_block_grads

    def faulty(*args, causal=False, q_offset=0, k_offset=0, **kw):
        dq, dk, dv = real(*args, causal=causal, q_offset=q_offset,
                          k_offset=k_offset, **kw)
        if not (causal and q_offset == k_offset):
            dk, dv = torch.zeros_like(dk), torch.zeros_like(dv)
        return dq, dk, dv

    sequence.flash_block_grads = faulty
    try:
        yield
    finally:
        sequence.flash_block_grads = real


def _one_process_loss(model, tokens, targets) -> float:
    """The pre-update loss of ``model`` on the whole batch in this
    process (the reference of a sharded step's first loss)."""
    import torch
    import torch.nn.functional as F

    with torch.no_grad():
        logits = model(tokens)
        return float(F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     targets.reshape(-1)))


def _dense_from_tp(tp_model, n_tp, **kw):
    """The dense LM holding ``tp_model``'s weights (``_dense_names``)."""
    from chainermn_torch.models import TransformerLM

    dense = TransformerLM(tp_model.vocab_size, tp_model.d_model,
                          tp_model.n_heads, tp_model.n_layers, tp_model.d_ff,
                          tp_model.max_len, tp_model.compute_dtype, **kw)
    dense.load_state_dict(_dense_names(
        tp_model.state_dict(), tp_model.n_heads,
        tp_model.d_model // tp_model.n_heads, n_tp))
    return dense


def _train_run(model, step, tokens, targets, warmup, timed, staged_fn,
               first_grads):
    """``warmup`` + ``timed`` steps of ``step``; the timed window closed by
    a device->host fetch of the loss. ``first_grads()`` reads the
    gradients the first step left."""
    import torch

    _zero_flash_counts()
    losses = [step(tokens, targets)[0]]
    grad = first_grads()
    losses += [step(tokens, targets)[0] for _ in range(warmup - 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged0 = staged_fn()
    t0 = time.perf_counter()
    for _ in range(timed):
        loss, _ = step(tokens, targets)
        losses.append(loss)
    float(loss)
    wall = time.perf_counter() - t0
    staged = staged_fn()
    b, t = tokens.shape
    return {"losses": [float(x) for x in losses], "grad_err": grad,
            "step_ms": wall / timed * 1e3,
            "tokens_per_sec_rank": b * t / (wall / timed),
            "launches": _flash_counts(),
            "staged_bytes_per_step": (staged["bytes"] - staged0["bytes"])
            / timed,
            "staged_share_of_step": (staged["seconds"] - staged0["seconds"])
            / wall,
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}


def _small_parity(build, comm, shard):
    """A small f32 LM built by ``build(attention)`` from one seed: its
    first sharded step's loss against the same weights' loss in this
    process (``shard(tokens)`` is this rank's part of the batch)."""
    import torch

    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    tokens, targets = _lm_batch(dev, *SMALL_BATCH, SMALL_LM["vocab_size"],
                                SEED + 9)
    model, reference = build()
    want = _one_process_loss(reference, tokens, targets)
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"], eps=1e-5)
    if getattr(model, "tensor_axis", None) is None:
        from chainermn_torch import create_multi_node_optimizer

        opt = create_multi_node_optimizer(opt, comm)
    step = lm_train_step(model, opt, comm,
                         shard_sequence=model.sequence_axis is not None)
    got = float(step(shard(tokens), shard(targets))[0])
    return {"loss": got, "one_process_loss": want,
            "abs_diff": abs(got - want)}


def rank_sp_train():
    """One rank of sp_train: the 220M LM (bf16, seed 0) with each
    ``SP_TRAIN['kinds']`` over a 2-rank flat communicator,
    ``create_multi_node_optimizer(AdamW)`` and
    ``lm_train_step(shard_sequence=True)`` on this rank's half of the
    train phase's [8, 2048] batch (zigzag-permuted for zigzag), beside the
    one-process flash LM trained alike on the whole batch; for the ring
    kinds, a first step with the planted ``_offdiag_dkv_dropped`` fault;
    then the small f32 LM's first loss against one process's."""
    import torch

    from chainermn_torch import (
        create_communicator,
        create_multi_node_optimizer,
    )
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.parallel.sequence import zigzag_permutation
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    comm = create_communicator("flat", device=dev)
    n, r = comm.size, comm.rank
    b, t = SP_TRAIN["batch"], SP_TRAIN["seq_len"]
    n_steps = SP_TRAIN["warmup_steps"] + SP_TRAIN["timed_steps"]
    tokens, targets = _lm_batch(dev, b, t, LM["vocab_size"], SEED)
    bf16 = dict(compute_dtype=torch.bfloat16, device=dev, seed=SEED)
    ref_losses, ref_grads = _reference_run(
        TransformerLM(**LM, attention="flash", **bf16), tokens, targets,
        n_steps)
    torch.cuda.empty_cache()
    out = {"one_process_losses": ref_losses}
    for kind in SP_TRAIN["kinds"]:
        layout = (zigzag_permutation(t, n) if kind.startswith("zigzag")
                  else torch.arange(t))
        mine = layout[r * (t // n):(r + 1) * (t // n)].to(dev)

        def sharded(kind=kind):
            model = TransformerLM(**LM, attention=kind, sequence_axis=comm,
                                  **bf16)
            opt = create_multi_node_optimizer(torch.optim.AdamW(
                model.parameters(), lr=TRAIN["lr"],
                weight_decay=TRAIN["weight_decay"]), comm)
            return model, lm_train_step(model, opt, comm,
                                        shard_sequence=True)

        control = None
        if kind != "ulysses_flash":     # Ulysses sends no dk/dv block
            model, step = sharded()
            with _offdiag_dkv_dropped():
                step(tokens[:, mine], targets[:, mine])
            control = _grad_error(_model_grads(model), ref_grads)
            del model, step
        model, step = sharded()
        out[kind] = _train_run(model, step, tokens[:, mine],
                               targets[:, mine], SP_TRAIN["warmup_steps"],
                               SP_TRAIN["timed_steps"], _staged,
                               lambda: _grad_error(_model_grads(model),
                                                   ref_grads))
        out[kind]["planted_fault_grad_err"] = control
        del model, step
        torch.cuda.empty_cache()

        def build(kind=kind):
            kw = dict(compute_dtype=torch.float32, device=dev, seed=SEED + 9)
            return (TransformerLM(**SMALL_LM, attention=kind,
                                  sequence_axis=comm, **kw),
                    TransformerLM(**SMALL_LM, attention="flash", **kw))

        st = SMALL_BATCH[1]
        small = (zigzag_permutation(st, n) if kind.startswith("zigzag")
                 else torch.arange(st))
        small = small[r * (st // n):(r + 1) * (st // n)].to(dev)
        out[kind]["small_f32"] = _small_parity(build, comm,
                                               lambda x: x[:, small])
    comm.finalize()
    return out


def _check_train(name, per_rank, want_launches):
    tol = SP_TRAIN
    for kind, want in want_launches.items():
        for rk in per_rank:
            rec, ref = rk[kind], rk["one_process_losses"]
            losses = rec["losses"]
            if not all(math.isfinite(x) for x in losses) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"{name} {kind}: losses not finite or "
                                     f"not falling: {losses}")
            if max(abs(x - y) for x, y in zip(losses, ref)) > \
                    tol["loss_tol"][name]:
                raise AssertionError(f"{name} {kind}: losses {losses} vs "
                                     f"one process's {ref}")
            if rec["grad_err"]["max_rel"] > tol["grad_rel_tol"]:
                raise AssertionError(f"{name} {kind}: first step's gradient "
                                     f"off one process's: {rec['grad_err']}")
            fault = rec["planted_fault_grad_err"]
            if fault is not None and fault["max_rel"] <= tol["grad_rel_tol"]:
                raise AssertionError(f"{name} {kind}: the planted fault "
                                     f"passes the gradient gate: {fault}")
            if rec["small_f32"]["abs_diff"] > tol["small_tol"]:
                raise AssertionError(f"{name} {kind}: small f32 LM "
                                     f"{rec['small_f32']}")
            if any(v != want for v in rec["launches"].values()):
                raise AssertionError(f"{name} {kind}: flash launches "
                                     f"{rec['launches']} != {want} each")


def phase_sp_train(card):
    """The 220M LM's context-parallel training on 2 ranks of the card
    (``rank_sp_train``). Fails unless, for each kind on each rank, the
    losses are finite and fall, every step's loss is within ``loss_tol``
    of the one-process flash LM's trained alike, the first step's global
    gradient is within ``grad_rel_tol`` of its (a leaf's relative L2
    error) and the planted fault is not, the small f32 LM's first loss is
    within 1e-4 of its one-process loss, and every attention call of
    every step went through the flash kernels (per rank and step:
    ring_flash 2 launches of each kernel a layer, zigzag_flash 5,
    ulysses_flash 1)."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_sp_train", 2)
    n_steps = SP_TRAIN["warmup_steps"] + SP_TRAIN["timed_steps"]
    want = {k: n_steps * LM["n_layers"] * _launches_per_attention(k, True, 2)
            for k in SP_TRAIN["kinds"]}
    emit({"phase": "sp_train", "card": card, "ranks": 2, "backend": "gloo",
          "model": dict(LM, compute_dtype="bf16"),
          "train": dict(SP_TRAIN, lr=TRAIN["lr"],
                        weight_decay=TRAIN["weight_decay"]),
          "reduced": "none: B=8, T=2048 as the train phase",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    _check_train("sp_train", ranks, want)
    return ranks


def rank_tp_train():
    """One rank of tp_train: the 220M LM with ``tensor_axis`` over tp = 2
    (a ``MeshCommunicator`` of shape (1, 1, 2)), the vocab-parallel head
    and local ``attention='flash'``, plain AdamW (the step assembles the
    global gradient), the whole [8, 2048] batch on both ranks, beside its
    dense twin trained alike in one process; the planted fault is the
    first step's gradients with the sliced leaves' x tp left out. Then
    the small f32 TP LM's first loss against its dense twin's."""
    import torch

    from chainermn_torch import MeshCommunicator
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.parallel.mesh import make_3d_mesh
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    comm = MeshCommunicator(make_3d_mesh(shape=(1, 1, 2)), device=dev)
    n_tp = comm.axis_size("tp")
    b, t = SP_TRAIN["batch"], SP_TRAIN["seq_len"]
    tokens, targets = _lm_batch(dev, b, t, LM["vocab_size"], SEED)
    tp_kw = dict(attention="flash", tensor_axis="tp",
                 vocab_parallel_head=True, device=dev)
    model = TransformerLM(**LM, **tp_kw, compute_dtype=torch.bfloat16,
                          seed=SEED)
    ref_losses, ref_grads = _reference_run(
        _dense_from_tp(model, n_tp, attention="flash", device=dev), tokens,
        targets, SP_TRAIN["warmup_steps"] + SP_TRAIN["timed_steps"])
    torch.cuda.empty_cache()
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"],
                            weight_decay=TRAIN["weight_decay"])
    step = lm_train_step(model, opt, comm)
    fault = {}

    def first_grads():
        fault.update(_grad_error(_model_grads(model, n_tp, 1 / n_tp),
                                 ref_grads))
        return _grad_error(_model_grads(model, n_tp), ref_grads)

    out = {"one_process_losses": ref_losses,
           "flash": _train_run(model, step, tokens, targets,
                               SP_TRAIN["warmup_steps"],
                               SP_TRAIN["timed_steps"], _staged,
                               first_grads)}
    out["flash"]["planted_fault_grad_err"] = fault
    del model, opt, step
    torch.cuda.empty_cache()

    def build():
        m = TransformerLM(**SMALL_LM, **tp_kw, compute_dtype=torch.float32,
                          seed=SEED + 9)
        return m, _dense_from_tp(m, n_tp, attention="flash", device=dev)

    out["flash"]["small_f32"] = _small_parity(build, comm, lambda x: x)
    comm.finalize()
    return out


def phase_tp_train(card):
    """The 220M LM's tensor-parallel training on 2 ranks of the card
    (``rank_tp_train``), held as sp_train is: finite falling losses,
    every step's loss and the first step's global gradient against the
    dense flash LM on the converted weights trained alike in one process
    (the planted fault — the sliced leaves without the x tp — must fail
    the gradient gate), the small f32 TP LM against its dense twin to
    1e-4, and one launch of each flash kernel a layer and step on each
    rank."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_tp_train", 2)
    n_steps = SP_TRAIN["warmup_steps"] + SP_TRAIN["timed_steps"]
    want = {"flash": n_steps * LM["n_layers"]}
    emit({"phase": "tp_train", "card": card, "ranks": 2, "backend": "gloo",
          "model": dict(LM, compute_dtype="bf16", tensor_parallel=2,
                        vocab_parallel_head=True, attention="flash"),
          "reduced": "none: B=8, T=2048 as the train phase",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    _check_train("tp_train", ranks, want)
    return ranks


def rank_hybrid():
    """One rank of the hybrid: dp x sp x tp = 2 x 2 x 2 at the dry run's
    size, ``attention='ring_flash'`` over sp, Megatron blocks and the
    vocab-parallel head over tp, the batch over dp; 5 Adam steps."""
    import torch

    from chainermn_torch import MeshCommunicator
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.parallel.mesh import make_3d_mesh
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    cfg = HYBRID
    comm = MeshCommunicator(make_3d_mesh(shape=cfg["shape"]), device=dev)
    ndp, nsp, _ = cfg["shape"]
    model = TransformerLM(cfg["vocab_size"], cfg["d_model"], cfg["n_heads"],
                          cfg["n_layers"], max_len=cfg["max_len"],
                          compute_dtype=torch.float32,
                          attention="ring_flash", sequence_axis="sp",
                          tensor_axis="tp", vocab_parallel_head=True,
                          device=dev, seed=SEED + 10)
    tokens, _ = _lm_batch(dev, cfg["batch"], cfg["seq_len"],
                          cfg["vocab_size"], SEED + 10)
    bl, tl = cfg["batch"] // ndp, cfg["seq_len"] // nsp
    di, si = comm.axis_index("dp"), comm.axis_index("sp")
    mine = tokens[di * bl:(di + 1) * bl, si * tl:(si + 1) * tl]
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    step = lm_train_step(model, opt, comm, shard_sequence=True)
    _zero_flash_counts()
    losses = [float(step(mine, mine)[0]) for _ in range(cfg["steps"])]
    out = {"coords": {a: comm.axis_index(a) for a in ("dp", "sp", "tp")},
           "losses": losses, "launches": _flash_counts()}
    comm.finalize()
    return out


def phase_hybrid(card):
    """dp x sp x tp = 2 x 2 x 2 as 8 processes on the card
    (``rank_hybrid``). Fails unless every rank's losses are finite and
    fall over the 5 steps, and every rank launched each flash kernel
    2 (ring steps) x 5 steps times."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_hybrid", 8)
    want = 2 * HYBRID["steps"] * HYBRID["n_layers"]
    emit({"phase": "hybrid", "card": card, "ranks": 8, "backend": "gloo",
          "config": HYBRID, "launches_want": want,
          "run_s": time.perf_counter() - t0, "ranks_out": ranks})
    for rk in ranks:
        losses = rk["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"hybrid: rank {rk['coords']} losses "
                                 f"{losses}")
        if any(v != want for v in rk["launches"].values()):
            raise AssertionError(f"hybrid: rank {rk['coords']} launches "
                                 f"{rk['launches']} != {want}")


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
    flash_err = phase_flash_parity(device)
    phase_flash_ring_blocks(device)
    flash_launches, comm = phase_train(device)
    flash_timing = phase_flash_timing(device)
    phase_train_parity(device)
    comm.finalize()
    dp = phase_dp_train(device)
    phase_dp_parity(device)
    phase_imagenet(device, dp["images_per_sec"])
    phase_mnist(device, smi)
    phase_mnist_checkpoint(smi)
    phase_mnist_mp(device, smi)
    phase_seq2seq_mp(smi)
    phase_sp_parity(smi)
    sp_train = phase_sp_train(smi)
    phase_tp_train(smi)
    phase_hybrid(smi)
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "chainermn_torch/csrc/paged_decode.cu",
        "replaces": "chainermn_tpu/parallel/paged_kernel.py:91",
        "launches": launches, "max_abs_err": timing["max_abs_err"],
        "parity_max_abs_err": parity_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    for name, (_, _, replaces, source) in FLASH_KERNELS.items():
        rec = flash_timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": flash_launches[name],
            "launches_ring_path": sp_train[0]["ring_flash"]["launches"][name],
            "max_abs_err": rec["max_abs_err"],
            "parity_max_abs_err": flash_err[name],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
