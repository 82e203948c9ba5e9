#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``chainermn_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout (one
``nvcc`` per source, started together), holds each against its plain
PyTorch version on the card (at the kernels' own head dims and at those
the wrappers pad or mask, up to D = 1024, in f32, bf16 and f16, with
more than 65535 (row, head) pairs, and with a planted fault that must
fail), times it, and drives the port's four paths with the
220M-parameter TransformerLM (vocab 32768, d_model 1024, 12 layers, 16
heads) and ResNet-50 (random weights from a seed):

- serving: ``ServingEngine(paged=True, paged_kernel=True)`` and
  ``FCFSScheduler`` answer 32 requests; every decode-step attention must
  go through the paged-decode kernel, and the kernel-read engine's greedy
  tokens must equal the plain-read engine's on a small f32 model; then
  the same LM with n-gram speculation (k = 4: every verify window's
  attention through the kernel at S = 5), with ``decode_window=4``, with
  chunked prefill of 1536-1920-token prompts beside decoding requests,
  and in the dense engine with its prefix store, each f32 stream equal to
  the plain engine's up to a recorded near-tie (a planted unverified
  commit must fail that gate), the kernel's verify-window rows at a slot
  ending at ``cache_len`` against the plain version, and the
  ``serve_lm.py`` twin and ``train_lm.py --serve-samples`` in process.
  The engines run their step programs as captured CUDA graphs; the
  ``serve_graphs`` phase runs the four paths eager and captured side by
  side (f32 streams equal, a planted one-block read failing, compile
  counts flat, launches exact), and ``serve_restart_swap`` warm-restarts
  a captured engine after an injected decode fault and swaps its
  weights behind the scheduler's fence, each followed by a request that
  must stream exactly what a fresh engine streams; ``serve_fleet`` runs
  two replicas of the LM behind a ``FleetRouter`` (warmed at once on
  their threads): one prefill and one decode replica with every
  request's KV migrating between them, prefix sharing on and off, and a
  mid-decode rebalance, with the migration programs timed; on the f32 LM
  the fleets' streams must equal a solo engine's (greedy and sampled),
  an int8 store must migrate bit for bit, and an import planted one
  block short must fail every request; ``serve_control`` runs the fleet's
  control plane (``fleet_health``, ``SLOEngine``, ``FleetController`` on
  their daemon threads) from one replica: a burst scales up, a canary
  deploy promotes, a canary forced critical rolls back under load, idle
  scales down, and on the f32 LM every replica's streams after a
  rollback must equal a solo engine's on the pre-canary weights (the
  pre-canary copy planted as a reference must fail 8/8); ``serve_trace``
  serves the ``serve`` traffic with request tracing off and on: the
  streams must be identical and every retained trace whole;
- training: ``TransformerLM(attention='flash')``,
  ``create_communicator('pure_nccl')``, ``create_multi_node_optimizer``
  over ``AdamW`` and ``lm_train_step`` take 12 steps on a [8, 2048] batch;
  every attention forward and backward must go through the flash kernels,
  the loss must fall, and a small f32 LM trained on the kernels must match
  the same LM trained on plain attention; ``train_fit`` drives the same
  LM through ``training.fit`` (windowed loss fetches, the device
  prefetcher, the tracer on and off) and ``train_resilient`` through
  ``resilient_fit`` with async snapshots and an injected fault: their
  losses must equal the synchronous loop's bit for bit;
- head dims 256 and 512 (``lm_d256``, ``lm_wide``): the same LM at 4
  heads of 256 (run at 4 of its 12 layers) and at 2 heads of 512, each
  served by the captured paged engine (16 requests, every decode step's
  attention through the paged-decode kernel at the head dim; its 2-layer
  f32 twin's streams equal the plain engine's) and trained through the
  flash kernels (1 + 3 steps, exact launches, a falling loss; an f32 LM
  at the head dim takes its first step on the f32 kernels equal to plain
  attention's to 1e-4); then ``lm_wide`` serves the serve LM at
  ``compute_dtype=float16`` (16 requests captured, every decode step
  through the paged-decode kernel on its float16 store; its 2-layer
  float16 twin's streams equal the plain engine's up to a recorded
  near-tie); the parity phases hold every kernel at D 256, 320, 512 and
  1024 and at the padded or masked 160, 192, 257 and 384, and B4 on
  float16 queries and stores, and the timing phases add D = 256 and
  D = 512 rows at the same work and a float16 B4 row;
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
  BatchNorm and double buffering, and from a directory of 512 seeded
  JPEGs it writes first (``d_jpeg_dir``, on the decoder it declares);
  every loss must be finite, the native loader must run where it was
  asked for, and the declared JPEG decoder alone must decode, with no
  failed decode;
- the MNIST and seq2seq twins (no kernel of their own), each at its JAX
  script's defaults but the MNIST twins' epochs (MNIST_EPOCHS, MP_EPOCHS,
  CKPT_EPOCHS): data-parallel MNIST in process on one NCCL rank
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
  block). ``sp_train`` and ``tp_train`` run the LM at 2 of its 12 layers;
- expert, weights-at-rest and pipeline parallelism, ranks as processes
  on the card over gloo: the 220M LM's widths with 8
  experts (top-2) in every second block, expert-parallel over 2 ranks
  against the same weights as a one-process gshard LM trained alike
  (``moe_train``, on the flash kernels, with a planted fault and drop
  fractions at the default capacity); the gshard LM cut to the Megatron
  layout over tp = 2 (``megatron_shard``, ``gspmd_lm_train_step``)
  against the replicated model, with each rank's stored fraction
  (``gspmd_train``); the channel-parallel convolution twin on 2 ranks
  (``parallel_conv``: its parity check, a falling loss, a planted channel
  swap failing the check); a 4-stage GPipe pipeline of the LM's block width on
  4 ranks (``jit_pp_lm_train_step``) against the sequential stack, with a
  planted fault (``pp_train``); and in this process the fused chunked CE
  and remat on the 220M LM against the plain step (``lm_fused_remat``)
  and the ``train_lm.py`` twin's ``main()`` in its MoE, pipeline,
  ``fit`` and resilient modes (``lm_example``). ``moe_train`` and
  ``gspmd_train`` run 4 of the 12 layers and ``serve_graphs`` serves 4
  requests eager (32 captured; its f32 twin at 2 layers), the cuts that
  keep the script inside its time limit;
- the host pieces of the last slice, inside phases that already run:
  ``mnist_mp``'s two rank processes then run the object traffic
  (``scatter_dataset``, a 64 MB ``bcast_obj``, ``allgather_obj``,
  ``scatter_obj``, object and tensor send/recv) over the C++ object-store
  sidecar and over gloo (``objstore_sidecar``: the sidecar taken, every
  result equal to gloo's, no key left after the ack-GC); ``serve_fleet``
  runs its f32 fleet under the runtime sanitizer with the static lock
  graph of ``chainermn_torch/`` (``graftlint``: no violation, observed
  edges within the static graph, and the static checkers clean over the
  tree);
- sharded state, ranks as processes on the card over gloo: the serve LM
  at 4 of its 12 layers at tp = 2 in the paged engine (``serve_tp``: rank
  0 leads, rank 1 replays; eager; every decode step's attention through the paged-decode
  kernel over the rank's 8 local heads), beside the single-card eager
  engine on the same 16 requests, its f32 twin's streams equal to solo
  ``generate`` of the dense LM (a store written one head over must fail),
  and the kernel timed on 8- and 4-head local stores; then ``reshard``:
  the train LM at 2 layers in f32 trained at tp = 2, saved with
  ``ShardedCheckpointer``, restored at tp = 4 by ``restore_train_state``
  (the next step's loss equal to the tp = 2 run's to 1e-4, the restored
  TP engine's streams equal to solo ``generate``; without the qkv
  permutation both gates must fail), and a tp = 1 replica spawned from
  the snapshot into a ``FleetRouter``. ``sp_train``, ``tp_train``,
  ``moe_train`` and ``gspmd_train`` take 1 + 2 steps (were 2 + 5, then
  1 + 3) to pay for them. The ranks of every multi-rank phase run in one
  group of 8 processes (``gloo_batch``), which starts once: first the
  2-rank calls of ``mnist_mp``, ``seq2seq_mp``, ``parallel_conv``,
  ``sp_parity``, ``sp_train``, ``tp_train``, ``serve_tp``,
  ``moe_train``, ``gspmd_train`` and ``reshard``'s first half on two of
  them, then ``reshard``'s second half and ``pp_train`` on four, then
  ``hybrid`` on all eight.

Each launch count is set to 0 just before its path runs and read just
after. Each phase is preceded by one flushed line ``{"phase_start":
name, "elapsed_s": s}`` and prints one JSON line, then one line gives
every phase's seconds; the line before the last two is the kernel
summary, then the card's name and power limit, then ``{"ok": true,
"device": {...}}``. Phases run one after another, never two at once. A
rank group (or ``mnist_checkpoint``'s subprocess) fails after 3x its
phase's seconds in a whole run (GROUP_SECONDS), with an error naming the
phase and carrying the ranks' last output; past DEADLINE_S (1140 s) of
wall time the script exits 1 at the next phase boundary, naming it, and
a phase still running at WATCHDOG_S (1175 s) ends it with exit 1, named.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib
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
T_START = time.monotonic()         # the script's wall clock starts here

# The whole script's limit is 1200 s of wall time. Past DEADLINE_S the
# script exits 1 at the next phase boundary, naming the phase; a phase
# still running at WATCHDOG_S ends the process with exit 1, naming it.
DEADLINE_S = 1140.0
WATCHDOG_S = 1175.0
# The seconds of each phase that starts processes, in a whole run of the
# script from a clean checkout (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 4): a rank group or subprocess of the phase is failed after
# GROUP_TIMEOUT_FACTOR times them, or at the deadline if that comes first.
# Every multi-rank phase reads its ranks' results from gloo_batch's group
GROUP_SECONDS = {"mnist_checkpoint": 31.4, "gloo_batch": 129.8}
GROUP_TIMEOUT_FACTOR = 3.0
GROUP_UNTIMED_S = 900.0
_RUNNING = {"phase": None}          # the phase main() is in

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # H100 SXM f32 peak outside the tensor cores
SEED = 0
SPIN_CYCLES = 4_000_000            # ~2 ms of device spin at H100 clocks

# the served model: scripts/onchip_lm.py's full-width LM
LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
          d_ff=4096, max_len=2048)
# the same LM at 4 heads of 256 (the reference's d_head = d_model //
# n_heads): the same parameters, the flash kernels' FLOPs and the paged
# read's bytes at the serve and train shapes (lm_d256)
LM_D256 = dict(LM, n_heads=4)
# ... and at 2 heads of 512 (lm_wide)
LM_D512 = dict(LM, n_heads=2)
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
# name: (wrapper, the prefix of its kernels' names in traces at every
# head dim and dtype, TPU kernel it replaces, source of the bf16 kernel
# the training path runs)
# the kernels each flash wrapper launches for float32 inputs: at D <= 256,
# past it up to the portable cluster (D <= 2048; dq and dk/dv as clusters
# of the 256-column slices) and past 2048
FLASH_F32_KERNELS = {
    "flash_fwd": ("flash_fwd_f32_sm90", "flash_fwd_wide_f32_sm90",
                  "flash_fwd_wide_f32_sm90"),
    "flash_dq": ("flash_dq_f32_sm90", "flash_dq_cluster_f32_sm90",
                 "flash_dq_wide_f32_sm90"),
    "flash_dkv": ("flash_dkv_f32_sm90", "flash_dkv_cluster_f32_sm90",
                  "flash_dkv_wide_f32_sm90"),
}
FLASH_KERNELS = {
    "flash_fwd": ("flash_fwd_with_lse", "flash_fwd_",
                  "chainermn_tpu/ops/flash_attention.py:195",
                  "chainermn_torch/csrc/flash_fwd_sm90.cuh"),
    "flash_dq": ("flash_dq", "flash_dq_",
                 "chainermn_tpu/ops/flash_attention.py:355",
                 "chainermn_torch/csrc/flash_bwd_sm90.cuh"),
    "flash_dkv": ("flash_dkv", "flash_dkv_",
                  "chainermn_tpu/ops/flash_attention.py:412",
                  "chainermn_torch/csrc/flash_bwd_sm90.cuh"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _f32_flash_launches() -> dict:
    """Each flash wrapper's launches on float32 inputs in this process so
    far (0 before the port's flash module is imported)."""
    fa = sys.modules.get("chainermn_torch.ops.flash_attention")
    return {name: getattr(fa, fn).launches_f32 if fa else 0
            for name, (fn, *_) in FLASH_KERNELS.items()}


def _keep_seeded_weights() -> None:
    """``TransformerLM(seed=s)`` draws its weights on the host, some 3 s
    for the 220M LM, and the phases build that LM some thirty times: keep
    the first draw of each (seed, parameter names, shapes and dtypes) on
    the host and copy it into every later build. Each build gets exactly
    the weights its own draw would give."""
    import torch

    from chainermn_torch.models import transformer

    draw = transformer.TransformerLM.reset_parameters
    kept = {}

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        params = [p for _, p in self.named_parameters()]
        key = (int(seed), tuple((n, tuple(p.shape), p.dtype)
                                for n, p in self.named_parameters()))
        if key not in kept:
            draw(self, seed)
            kept[key] = [p.detach().to("cpu", copy=True) for p in params]
            return
        for p, w in zip(params, kept[key]):
            p.copy_(w)

    transformer.TransformerLM.reset_parameters = reset_parameters


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
    row's length would show), int8 scales when ``dtype`` is int8. Drawn
    on the generator's device (a CUDA generator draws the store where it
    lives)."""
    import torch

    b = len(lengths)
    need = [-(-int(n) // bs) for n in lengths]
    n_max = max(need)
    if n_blocks is None:
        n_blocks = sum(need) + 1 + 8
    at_gen = dict(generator=gen, device=gen.device)
    perm = torch.randperm(n_blocks - 1, **at_gen)[:sum(need)] + 1
    table = torch.zeros((b, n_max), dtype=torch.int32, device=gen.device)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[at:at + n].int()
        at += n
    shape = (n_blocks, bs, h, d)
    out = {"table": table.to(device),
           "lengths": torch.as_tensor(lengths, dtype=torch.int32,
                                      device=device),
           "q": torch.randn((b, s_len, h, d), **at_gen).to(
               device=device, dtype=q_dtype)}
    if dtype == torch.int8:
        for kk in ("k", "v"):
            out[kk] = torch.randint(-127, 128, shape, dtype=torch.int8,
                                    **at_gen).to(device)
            out[kk + "_scale"] = (torch.rand((n_blocks, bs, h), **at_gen)
                                  * 0.05 + 1e-3).to(device)
    else:
        for kk in ("k", "v"):
            out[kk] = torch.randn(shape, **at_gen).to(device=device,
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
    if a bf16 or f32 flash instance named ``*_sm90`` or a paged-decode
    instance spills registers. The builds start from
    ``chainermn_torch/_build.py`` loaded on its own, so the port's package
    is imported (~6 s on the card host) while ``nvcc`` runs; the kernel
    modules then load the libraries built."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_build", ROOT / "chainermn_torch" / "_build.py")
    builder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(builder)
    csrc = ROOT / "chainermn_torch" / "csrc"
    srcs = {"paged_decode": csrc / "paged_decode.cu",
            "flash_attention": csrc / "flash_attention.cu"}

    def build(src):
        t0 = time.perf_counter()
        _, log = builder.load_library(src, {})
        return time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(srcs)) as pool:
        done = pool.map(build, srcs.values())
        flash_attention = importlib.import_module(
            "chainermn_torch.ops.flash_attention")
        from chainermn_torch.parallel import paged_kernel
        seconds, logs = (dict(zip(srcs, x)) for x in zip(*done))
    libs = {"paged_decode": paged_kernel, "flash_attention": flash_attention}
    for mod in libs.values():
        mod.build_library()
    ptxas = {name: _ptxas(logs[name]) for name in libs}
    for name in libs:
        emit({"phase": "build", "kernel": name, "seconds": seconds[name],
              "ptxas": ptxas[name]})
    # the bf16 and f32 (``*_f32_sm90``) flash kernels and the paged kernel
    # keep their accumulators in registers: a spill would put them in
    # local memory
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
# 96, 160) and windows of 12 queries (two launches, chunk_queries); D =
# 256 at S = 1, the verify window's 5 and 12
PAGED_SHAPES = ((64, 1), (64, 4), (64, 8), (128, 1), (128, 8),
                (8, 1), (8, 12), (32, 4), (32, 12), (96, 8), (96, 12),
                (64, 12), (256, 1), (256, 5), (256, 12), (160, 8))
# past 256 (256-column slices of the output), over bf16, f32, int8 and
# f16 stores: D = 512 at S = 1, 5 and 12, 384 at 12, 320 at 8, and 257
# and 1024
PAGED_WIDE_SHAPES = ((512, 1), (512, 5), (512, 12), (384, 12), (320, 8),
                     (257, 4), (1024, 1))
# float16 queries over every store type and float16 stores under every
# query type (the pairs the kernel is not built for run with q widened to
# f32), at the serve shape (D = 64) and at 256 and 512
PAGED_F16_SHAPES = ((64, 1), (64, 8), (256, 5), (512, 1))
# more (row, head) pairs than one grid axis of 65535 holds, for each kernel
GRID_BH = 70_000


def phase_parity(device):
    """paged_attend vs paged_attend_reference on the card: B=16, H=16,
    bs=16, the PAGED_LENGTHS sets (split-K and one-CTA paths), the
    PAGED_SHAPES (D, S) pairs over bf16 / f32 / int8 stores, the
    PAGED_WIDE_SHAPES over those and f16, and the PAGED_F16_SHAPES over
    f16 queries on f16 / int8 / f32 / bf16 stores and f32 or bf16 queries
    on an f16 store (the 16-bit tolerance); then one case with B * H =
    70000 rows and heads (B = 70000, H = 1, a bf16 store). Inputs are drawn on the card.
    A planted fault must fail: at D = 512 the plain version on K with its
    columns past the first 256 zeroed (scores reduced over one slice's
    columns only)."""
    import torch

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
        split_plan,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = {"bf16": (torch.bfloat16, torch.bfloat16),
             "f32": (torch.float32, torch.float32),
             "int8": (torch.int8, torch.float32)}
    wide_cases = dict(cases, f16=(torch.float16, torch.float16))
    f16_cases = {"f16": (torch.float16, torch.float16),
                 "int8_f16q": (torch.int8, torch.float16),
                 "f32_f16q": (torch.float32, torch.float16),
                 "f16_f32q": (torch.float16, torch.float32),
                 "f16_bf16q": (torch.float16, torch.bfloat16),
                 "bf16_f16q": (torch.bfloat16, torch.float16)}
    results = []

    def check(got, want, name):
        rtol, atol = TOL["f16" if name in f16_cases else name]
        err = (got - want).abs()
        return (float(err.max()), rtol, atol,
                bool((err <= atol + rtol * want.abs()).all()))

    for shapes, group in ((PAGED_SHAPES, cases),
                          (PAGED_WIDE_SHAPES, wide_cases),
                          (PAGED_F16_SHAPES, f16_cases)):
        for d, s_len in shapes:
            for path, base in PAGED_LENGTHS.items():
                lengths = [max(n, s_len) for n in base]
                for name, (dtype, q_dtype) in group.items():
                    x = make_paged_inputs(lengths, s_len=s_len, h=16, d=d,
                                          bs=16, dtype=dtype,
                                          q_dtype=q_dtype, gen=gen,
                                          device=device)
                    args, kw = attend_args(x)
                    got = paged_attend(*args, **kw).float()
                    want = paged_attend_reference(*args, **kw).float()
                    torch.cuda.synchronize()
                    err, rtol, atol, ok = check(got, want, name)
                    plan = split_plan(len(lengths), 16, x["table"].shape[1],
                                      16)
                    results.append({"store": name, "D": d, "S": s_len,
                                    "path": path, "n_split": plan[0],
                                    "split_keys": plan[1],
                                    "max_abs_err": err, "rtol": rtol,
                                    "atol": atol, "ok": ok})
    # the grid: B * H past 65535 (B = GRID_BH rows of one head)
    lengths = torch.randint(1, 40, (GRID_BH,), generator=gen,
                            device=device).tolist()
    x = make_paged_inputs(lengths, s_len=1, h=1, d=64, bs=16,
                          dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                          gen=gen, device=device)
    args, kw = attend_args(x)
    err, rtol, atol, ok = check(paged_attend(*args, **kw).float(),
                                paged_attend_reference(*args, **kw).float(),
                                "bf16")
    results.append({"store": "bf16", "D": 64, "S": 1, "path": "grid",
                    "B": GRID_BH, "H": 1, "max_abs_err": err,
                    "rtol": rtol, "atol": atol, "ok": ok})
    # the planted fault: scores over the first 256 of 512 columns only
    x = make_paged_inputs(PAGED_LENGTHS["split"], s_len=1, h=16, d=512,
                          bs=16, dtype=torch.bfloat16,
                          q_dtype=torch.bfloat16, gen=gen, device=device)
    args, kw = attend_args(x)
    cut = x["k"].clone()
    cut[..., 256:] = 0
    err, rtol, atol, ok = check(
        paged_attend(*args, **kw).float(),
        paged_attend_reference(args[0], cut, *args[2:], **kw).float(),
        "bf16")
    planted = {"store": "bf16", "D": 512, "S": 1, "path": "split",
               "fault": "K columns 256.. zeroed in the plain version",
               "max_abs_err": err, "ok": ok}
    del x, args, cut
    emit({"phase": "parity", "kernel": "paged_decode", "cases": results,
          "planted_fault": planted})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"paged_decode disagrees with its plain "
                             f"version: {bad}")
    if planted["ok"]:
        raise AssertionError(f"parity: the planted fault passes: {planted}")
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
    """Where a decode step's time goes (:func:`_profile_steps`). Fails
    unless the trace holds the engine's ``chainermn.decode`` region."""
    rec = dict(_profile_steps(engine, sched, rng, n_steps), phase="profile")
    emit(rec)
    if "chainermn.decode" not in rec["annotations"]:
        raise AssertionError(f"profile: no chainermn.decode region in the "
                             f"trace: {rec['annotations']}")
    return rec


def _profile_steps(engine, sched, rng, n_steps: int = 20,
                   host_events: bool = True):
    """Refill every slot, let admissions finish, then trace ``n_steps``
    pure decode steps with ``torch.profiler``. Device busy time is the sum
    of CUDA activity (kernels, copies; a replayed CUDA graph's kernels
    included) in the window; idle share is what is left of the host wall
    clock; user annotations (``chainermn.*`` regions) are left out of it,
    since they span kernels already counted, and listed by name.
    ``host_events=False`` traces the device alone: the same busy time,
    no host regions, and a fraction of the profiler's own cost (the
    graphs phase profiles eight engines so)."""
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
    activities = ([ProfilerActivity.CPU] if host_events else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in dev)
    # the split-K pass and its combine pass
    kern_us = sum(e.self_device_time_total for e in dev
                  if "paged_decode" in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"decode_steps": n_steps,
           "active_slots": engine.active_slots,
           "step_wall_ms": wall / n_steps * 1e3,
           "step_device_busy_ms": busy_us / n_steps / 1e3 if busy_us
           else "not measured",
           "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us
           else "not measured",
           "paged_decode_ms_per_step": kern_us / n_steps / 1e3,
           "paged_decode_share_of_busy": kern_us / busy_us if busy_us
           else "not measured",
           "annotations": _annotations(prof),
           "top_device": [{"name": e.key[:70], "ms_per_step":
                           e.self_device_time_total / n_steps / 1e3,
                           "calls_per_step": e.count / n_steps}
                          for e in top]}
    return rec


def _annotations(prof) -> dict:
    """``{name: calls}`` of the ``chainermn.*`` host regions in a
    profile."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.key_averages():
        if e.key.startswith("chainermn.") and e.device_type == DeviceType.CPU:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


def phase_timing(device, lengths):
    """Kernel, plain version and library yardstick at the serve phase's
    decode shape (the active slots at the lengths they held when the most
    were decoding; bf16 store of the engine's size; S = 1), L2 flushed
    before each timed call. ``ms`` and ``plain_ms`` are at the table width
    the engine's captured decode program reads (``cache_len / bs`` = 128
    entries, the split plan fixed by that width); ``ms_span_cut`` is the
    table cut to the longest row, as the eager engine of earlier versions
    read it; ``d256`` and ``d512`` are the same read at H = 4, D = 256 and
    H = 2, D = 512 (``lm_d256``'s and ``lm_wide``'s shapes: the same
    bytes), ``f16`` at the serve shape with float16 queries and store."""
    import torch

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
        split_plan,
    )

    h, d, bs = LM["n_heads"], LM["d_model"] // LM["n_heads"], 16
    n_blocks = ENGINE["n_slots"] * (ENGINE["cache_len"] // bs) + 1
    gen = torch.Generator().manual_seed(SEED + 1)

    def inputs(h, d, s_len=1, dtype=torch.bfloat16):
        return make_paged_inputs([max(n, s_len) for n in lengths],
                                 s_len=s_len, h=h, d=d, bs=bs, dtype=dtype,
                                 q_dtype=dtype, gen=gen, device=device,
                                 n_blocks=n_blocks)

    x = inputs(h, d)
    args, kw = attend_args(x)
    span = x["table"].shape[1]
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    flush = scratch.zero_
    launches0 = paged_attend.launches
    got = paged_attend(*args, **kw).float()
    want = paged_attend_reference(*args, **kw).float()
    err = float((got - want).abs().max())
    span_ms = cuda_ms(lambda: paged_attend(*args, **kw), flush=flush)
    span_plain_ms = cuda_ms(lambda: paged_attend_reference(*args, **kw),
                            flush=flush)
    full = _paged_full_table_row(x, lengths, flush)
    # the same rows at a head dim the kernel masks inside (D = 8, the
    # repo's small LM configurations) and with a 12-query window (two
    # launches of chunk_queries)
    wider = {}
    for tag, s_len, dd in (("D8", 1, 8), ("S12", 12, d)):
        y = inputs(h, dd, s_len)
        y_args, y_kw = attend_args(y)
        wider[f"ms_{tag}"] = cuda_ms(lambda: paged_attend(*y_args, **y_kw),
                                     flush=flush)
        del y, y_args, y_kw
    wide = {}
    for name, cfg in (("d256", LM_D256), ("d512", LM_D512)):
        hh = cfg["n_heads"]
        wide[name] = _paged_full_table_row(
            inputs(hh, cfg["d_model"] // hh), lengths, flush)
    wide["f16"] = _paged_full_table_row(inputs(h, d, dtype=torch.float16),
                                        lengths, flush)
    paged_attend.launches = launches0
    b = len(lengths)
    n_split, split_keys = full["split_plan"]
    rec = {"phase": "timing", "kernel": "paged_decode", "B": b, "S": 1,
           "bs": bs, "store": "bf16", "lengths": lengths, **full,
           "n_split": n_split, "split_keys": split_keys,
           "span_cut": {"table_width": span,
                        "split_plan": split_plan(b, h, span, bs),
                        "max_abs_err": err, "ms": span_ms,
                        "plain_ms": span_plain_ms},
           "ms_span_cut": span_ms, **wider, **wide}
    emit(rec)
    bad = [r for r in (full, *wide.values()) if not r["within_tol"]]
    if bad:
        raise AssertionError(f"paged_decode disagrees with its plain version "
                             f"at the decode shape: {bad}")
    return rec


def _paged_full_table_row(x, lengths, flush):
    """Kernel, plain version and SDPA on the gathered store for the paged
    inputs ``x`` (``make_paged_inputs`` at the serve lengths, S = 1) read
    through the captured decode program's full table (``cache_len / bs``
    entries); the bound counts q read, each row's live KV rows read once,
    its table entries and length read, and the output written.
    ``library_backend`` is the backend SDPA picks for those inputs."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
        split_plan,
    )

    b, _, h, d = x["q"].shape
    bs = x["k"].shape[1]
    span = x["table"].shape[1]
    full_w = ENGINE["cache_len"] // bs
    table = torch.zeros((b, full_w), dtype=torch.int32, device=x["q"].device)
    table[:, :span] = x["table"]
    args, kw = attend_args(dict(x, table=table))
    got = paged_attend(*args, **kw).float()
    want = paged_attend_reference(*args, **kw).float()
    rtol, atol = TOL["bf16"]
    err = (got - want).abs()
    flat = x["table"].reshape(-1).long()
    mask = (torch.arange(span * bs, device=flat.device)[None, :]
            <= (x["lengths"].long() - 1)[:, None])[:, None, None, :]

    def library():
        kk = x["k"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        vv = x["v"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(x["q"].transpose(1, 2), kk, vv,
                                              attn_mask=mask)

    kv_rows = sum(lengths)
    n_bytes = (b * h * d * 2 * 2 + kv_rows * h * d * 2 * 2
               + sum(-(-n // bs) for n in lengths) * 4 + b * 4)
    n_ops = 4 * kv_rows * h * d                         # QK and PV, S = 1
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    # what the kernel reads: past D = 256 every 256-column slice's CTA
    # reads q and K whole, V its own slice
    extra = (-(-d // 256) - 1) * (b * h * d * 2 + kv_rows * h * d * 2)
    kv_lib = [x[n].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
              for n in ("k", "v")]
    return {"H": h, "D": d, "dtype": str(x["q"].dtype).split(".")[-1],
            "table_width": full_w,
            "split_plan": split_plan(b, h, full_w, bs),
            "max_abs_err": float(err.max()),
            "within_tol": bool((err <= atol + rtol * want.abs()).all()),
            "library_max_abs_err": float(
                (library().transpose(1, 2).float() - want).abs().max()),
            "ms": cuda_ms(lambda: paged_attend(*args, **kw), flush=flush),
            "plain_ms": cuda_ms(lambda: paged_attend_reference(*args, **kw),
                                flush=flush),
            "library_ms": cuda_ms(library, flush=flush),
            "library_backend": _sdpa_backend(x["q"].transpose(1, 2),
                                             *kv_lib, mask),
            "bytes": n_bytes, "design_bytes": n_bytes + extra, "ops": n_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _sdpa_backend(q, k, v, attn_mask=None, is_causal=False):
    """The name of the backend ``F.scaled_dot_product_attention`` picks
    for these inputs (its own dispatch rule, ``torch._fused_sdp_choice``),
    or ``"unknown"`` where this torch has no such rule."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, attn_mask, 0.0, is_causal)).name
    except (AttributeError, ImportError, RuntimeError, ValueError):
        return "unknown"


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


# -- the serving engine's multi-token rounds, chunked prefill and the dense
#    engine: the 220M LM through the same ServingEngine/FCFSScheduler API --

SPEC = dict(k=4, prefix=256, phrase=32, body=(64, 256), max_new=(64, 128))
PARITY_REQUESTS = 8
NEAR_TIE = 1e-4            # f32 top-2 logit gap under which a flip passes
DRAFT_LM = dict(vocab_size=LM["vocab_size"], d_model=256, n_heads=4,
                n_layers=2, d_ff=1024, max_len=LM["max_len"])
WINDOW = 4
# the long prompts need a 2048 bucket; 256-token chunks fit a 256 bucket
# at every frontier up to 1792
CHUNKED = dict(n_long=8, prompt=(1536, 1920), long_new=(64, 128),
               n_short=8, short_prompt=(64, 128), short_new=128,
               chunk_tokens=256, buckets=(128, 256, 512, 2048),
               parity_long_new=16, parity_short_new=32)
# the near-cache_len check: a 512-token prompt plus 16 new tokens ends at
# cache_len = 528 = 33 blocks, so the last verify windows run past it
NEAR_END = dict(prompt=512, cache_len=528)
DENSE = dict(prefix_cache_blocks=512, prefix_block_size=16)
SERVE_EXAMPLE = {
    "defaults": [],
    "paged_spec_chunked_fair": ["--paged-kv", "--temperature", "0",
                                "--speculate", "ngram", "--chunk-tokens",
                                "8", "--tenants", "3", "--priority",
                                "mixed", "--brownout", "2",
                                "--verify-parity", "--http-port", "0",
                                "--prometheus"],
}


def _spec_traffic(n, seed):
    """``n`` requests sharing a 256-token system prefix, each followed by
    its own 32-token phrase repeated to 64-256 tokens (something for the
    n-gram drafter to find), asking 64-128 new tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = LM["vocab_size"]
    prefix = rng.integers(1, vocab, SPEC["prefix"])
    work = []
    for _ in range(n):
        phrase = rng.integers(1, vocab, SPEC["phrase"])
        body = np.resize(phrase, int(rng.integers(SPEC["body"][0],
                                                  SPEC["body"][1] + 1)))
        work.append((np.concatenate([prefix, body]),
                     int(rng.integers(SPEC["max_new"][0],
                                      SPEC["max_new"][1] + 1))))
    return work


def _capped(work, n_new):
    """``work``'s requests, each asking at most ``n_new`` new tokens."""
    return [(prompt, min(n, n_new)) for prompt, n in work]


def _serve_traffic(n, seed):
    """The ``serve`` phase's requests (its prompt and budget ranges)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    work = []
    for _ in range(n):
        plen = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        prompt = rng.integers(1, LM["vocab_size"], size=plen)
        work.append((prompt, int(rng.integers(MAX_NEW[0], MAX_NEW[1] + 1))))
    return work


def _drive(engine, work, *, seeds=None, sched_kw=None, on_step=None,
           step_s=None):
    """Submit ``work`` to a fresh scheduler and step it dry; returns the
    generated streams, the scheduler and the wall seconds (closed by a
    synchronize). ``step_s``, a list, gets each step's host seconds.
    Fails unless every request finished cleanly with its whole budget."""
    import torch

    from chainermn_torch.serving import FCFSScheduler

    sched = FCFSScheduler(engine, **(sched_kw or {}))
    reqs = [sched.submit(p, n, seed=(seeds[i] if seeds else 0))
            for i, (p, n) in enumerate(work)]
    t0 = time.perf_counter()
    while sched.has_work:
        if on_step is not None:
            on_step(engine)
        if step_s is None:
            sched.step()
            continue
        t_step = time.perf_counter()
        sched.step()
        step_s.append(time.perf_counter() - t_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not (r.finished and r.error is None
                and len(r.tokens) == r.max_new_tokens):
            raise AssertionError(f"request {r.id} did not serve cleanly: "
                                 f"{r.state} {len(r.tokens)} tokens "
                                 f"{r.error}")
    return [[int(t) for t in r.tokens] for r in reqs], sched, wall


def _parity(model, work, got, want, near_tie=NEAR_TIE):
    """Token streams ``got`` against ``want`` (the same requests): a
    stream passes when it is identical, or when its first divergence sits
    where ``model``'s logits (a cacheless forward over the prompt and the
    reference's tokens before it) have a top-2 gap below ``near_tie``."""
    import numpy as np
    import torch

    same, ties, bad = 0, [], []
    for i, ((prompt, _), g, w) in enumerate(zip(work, got, want)):
        if g == w:
            same += 1
            continue
        at = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                  min(len(g), len(w)))
        ctx = np.concatenate([prompt, w[:at]]).astype(np.int64)
        with torch.inference_mode():
            lg = model(torch.as_tensor(ctx[None], device=model.device))
        top2 = torch.topk(lg[0, -1].float(), 2).values
        rec = {"request": i, "position": at,
               "top2_gap": float(top2[0] - top2[1])}
        (ties if rec["top2_gap"] < near_tie else bad).append(rec)
    return {"requests": len(work), "identical": same, "near_ties": ties,
            "failures": bad}


def _check_pool(engine, name):
    pool = engine._pool
    if (engine.active_slots or int(engine._slot_reserved.sum())
            or pool.free_blocks + engine.prefix_cache.evictable_blocks()
            != pool.capacity):
        raise AssertionError(f"{name}: block pool not whole after "
                             f"retirement: {engine.kv_stats()}")


def _check_parity(name, rec):
    if rec["failures"]:
        raise AssertionError(f"{name}: streams diverge away from a near-tie: "
                             f"{rec['failures']}")


def _fullest(snap):
    """An ``on_step`` hook keeping the active slots' positions at the
    step where most slots were decoding."""
    def hook(engine):
        if engine.active_slots > snap.get("most", 0):
            snap["most"] = engine.active_slots
            snap["pos"] = [int(p) for p in engine._pos[engine._active]]
    return hook


def _empty():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_spec(device, card):
    """Speculative decoding through the paged kernel at S = k + 1: the
    220M LM in bf16 serves 32 shared-prefix, repeated-phrase requests
    with the n-gram drafter (k = 4). Fails unless every verify window's
    attention went through the kernel (launches = verify rounds x 12),
    the pool is whole after retirement, the f32 LM's speculative streams
    (n-gram and a 2-layer draft model) equal the non-speculative kernel
    engine's up to recorded near-ties while a planted fault (every draft
    committed unverified) does not, and the kernel's verify-window rows
    below ``valid`` at a slot that ends at ``cache_len`` match the plain
    version within the bf16 tolerance."""
    import numpy as np
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.parallel import paged_kernel
    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
    )
    from chainermn_torch.serving import ServingEngine, SpeculativeConfig
    from chainermn_torch.serving.speculative import NgramDrafter

    t_phase = time.perf_counter()
    k = SPEC["k"]
    work = _spec_traffic(N_REQUESTS, SEED + 10)
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    engine = ServingEngine(model, paged_kernel=True, device=device,
                           speculative=SpeculativeConfig(k=k), **ENGINE)
    engine.warmup()
    snap = {}
    rounds0 = engine.spec_stats()["spec_rounds"]
    paged_attend.launches = 0
    _, sched, wall = _drive(engine, work, on_step=_fullest(snap))
    launches = paged_attend.launches
    rounds = engine.spec_stats()["spec_rounds"] - rounds0
    rep = sched.metrics.report()
    stats = engine.spec_stats()
    _check_pool(engine, "serve_spec")
    if launches != rounds * LM["n_layers"]:
        raise AssertionError(f"serve_spec: kernel launches {launches} != "
                             f"verify rounds {rounds} x {LM['n_layers']}")
    # the verify window's shape at the fullest step, timed alone
    h, d, bs = LM["n_heads"], LM["d_model"] // LM["n_heads"], 16
    gen = torch.Generator().manual_seed(SEED + 11)
    x = make_paged_inputs([p + k + 1 for p in snap["pos"]], s_len=k + 1,
                          h=h, d=d, bs=bs, dtype=torch.bfloat16,
                          q_dtype=torch.bfloat16, gen=gen, device=device,
                          n_blocks=engine.kv_blocks)
    args, kw = attend_args(x)
    got = paged_attend(*args, **kw).float()
    want = paged_attend_reference(*args, **kw).float()
    window_timing = {
        "S": k + 1, "B": len(snap["pos"]),
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: paged_attend(*args, **kw)),
        "plain_ms": cuda_ms(lambda: paged_attend_reference(*args, **kw))}
    del engine, x, args, kw, got, want
    _empty()

    # near cache_len: the last windows' lengths run past the table
    near = []

    def recorder(q, sk, sv, table, lengths, **kw):
        out = real_attend(q, sk, sv, table, lengths, **kw)
        if q.shape[1] == k + 1:
            valid = np.where(eng_near._active,
                             np.clip(eng_near.cache_len - eng_near._pos, 0,
                                     k + 1), 0)
            rows = [b for b in range(q.shape[0]) if 0 < valid[b] < k + 1]
            if rows:
                ref = paged_attend_reference(q, sk, sv, table, lengths, **kw)
                rtol, atol = TOL["bf16"]
                for b in rows:
                    o, r = out[b, :valid[b]].float(), ref[b, :valid[b]].float()
                    near.append({
                        "valid": int(valid[b]), "length": int(lengths[b]),
                        "table_rows": int(kw["max_blocks"]) * sk.shape[1],
                        "max_abs_err": float((o - r).abs().max()),
                        "ok": bool(((o - r).abs()
                                    <= atol + rtol * r.abs()).all())})
        return out

    class WrongNgram(NgramDrafter):
        """The n-gram guesses moved by one: nearly every draft rejected,
        so the slot walks through every position up to cache_len."""

        def propose(self, kk):
            return (super().propose(kk) + 1) % LM["vocab_size"]

    # eager: the recorder wraps each kernel call, which a replayed graph
    # does not make
    eng_near = ServingEngine(model, paged_kernel=True, device=device,
                             speculative=SpeculativeConfig(k=k),
                             capture=False,
                             **dict(ENGINE, cache_len=NEAR_END["cache_len"]))
    eng_near._drafter = WrongNgram(eng_near._spec, eng_near)
    prompt = np.random.default_rng(SEED + 12).integers(
        1, LM["vocab_size"], NEAR_END["prompt"])
    real_attend = paged_kernel.paged_attend
    # the wrapper counts its launches on the module's paged_attend
    recorder.launches = real_attend.launches
    paged_kernel.paged_attend = recorder
    try:
        _drive(eng_near, [(prompt, NEAR_END["cache_len"]
                           - NEAR_END["prompt"])])
    finally:
        paged_kernel.paged_attend = real_attend
        real_attend.launches = recorder.launches
    _check_pool(eng_near, "serve_spec near cache_len")
    del eng_near, model
    _empty()

    # f32 parity: speculative (n-gram, draft model) against the plain
    # kernel engine, and the planted fault
    m32 = TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                        seed=SEED)
    pw = work[:PARITY_REQUESTS]
    base = ServingEngine(m32, paged_kernel=True, device=device, **ENGINE)
    want, _, _ = _drive(base, pw)
    del base
    spec32 = ServingEngine(m32, paged_kernel=True, device=device,
                           speculative=SpeculativeConfig(k=k), **ENGINE)
    got, _, _ = _drive(spec32, pw)
    parity = _parity(m32, pw, got, want)
    real_verify = spec32._spec_verify

    def unverified(tokens, valid):
        g = real_verify(tokens, valid).clone()
        g[:, :k] = torch.as_tensor(tokens[:, 1:], device=g.device)
        return g

    spec32._spec_verify = unverified
    fault, _, _ = _drive(spec32, pw)
    planted = _parity(m32, pw, fault, want)
    del spec32
    _empty()
    draft = TransformerLM(**DRAFT_LM, compute_dtype=torch.float32,
                          device=device, seed=SEED + 13)
    n_draft = PARITY_REQUESTS // 2
    eng_draft = ServingEngine(
        m32, paged_kernel=True, device=device, **ENGINE,
        speculative=SpeculativeConfig(k=k, drafter="draft",
                                      draft_model=draft))
    got_d, _, _ = _drive(eng_draft, pw[:n_draft])
    draft_parity = _parity(m32, pw[:n_draft], got_d, want[:n_draft])
    draft_parity["spec"] = eng_draft.spec_stats()
    del eng_draft, draft, m32
    _empty()

    rec = {"phase": "serve_spec", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(ENGINE, paged_kernel=True, speculative="ngram",
                          spec_k=k),
           "traffic": dict(SPEC, requests=N_REQUESTS), "wall_s": wall,
           "tokens_generated": rep["tokens_generated"],
           "tokens_per_sec": rep["tokens_per_sec"],
           "tpot_p50_s": rep["tpot_p50_s"], "ttft_p50_s": rep["ttft_p50_s"],
           "accept_rate": stats["accept_rate"],
           "tokens_per_verify": 1 + rep["spec_accept_length_mean"],
           "verify_rounds": rounds, "kernel_launches": launches,
           "window_timing": window_timing,
           "f32_parity": parity, "planted_fault": planted,
           "draft_model": dict(DRAFT_LM, requests=n_draft),
           "draft_parity": draft_parity,
           "near_cache_len": dict(NEAR_END, checks=near),
           "run_s": time.perf_counter() - t_phase}
    emit(rec)
    _check_parity("serve_spec", parity)
    _check_parity("serve_spec draft model", draft_parity)
    if not planted["failures"]:
        raise AssertionError("serve_spec: the planted unverified commit "
                             "passes the parity gate")
    past = [c for c in near if c["length"] > c["table_rows"]]
    if not past or not all(c["ok"] for c in near):
        raise AssertionError(f"serve_spec: near-cache_len verify windows "
                             f"{near}")
    return rec


def phase_serve_window(device, card):
    """``decode_window=4`` on the kernel: the ``serve`` phase's 32
    requests, bf16. Fails unless every window step's attention went
    through the kernel (launches = 4 x window calls x 12), the pool is
    whole, the f32 window streams equal the per-token engine's up to
    recorded near-ties, and at temperature 0.8 / top_k 50 the f32 window
    stream equals the per-token stream for the same seeds."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    work = _serve_traffic(N_REQUESTS, SEED)
    calls_ctr = get_registry().counter(
        "serving_decode_steps_total",
        {"engine": "serving", "paged_kernel": "on"})
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    engine = ServingEngine(model, paged_kernel=True, decode_window=WINDOW,
                           device=device, **ENGINE)
    engine.warmup()
    calls0 = calls_ctr.value
    paged_attend.launches = 0
    _, sched, wall = _drive(engine, work)
    launches = paged_attend.launches
    calls = calls_ctr.value - calls0
    rep = sched.metrics.report()
    _check_pool(engine, "serve_window")
    if launches != WINDOW * calls * LM["n_layers"]:
        raise AssertionError(f"serve_window: kernel launches {launches} != "
                             f"{WINDOW} x calls {calls} x {LM['n_layers']}")
    decoded = rep["tokens_generated"] - len(work)    # first tokens: prefill
    del engine, model
    _empty()
    m32 = TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                        seed=SEED)
    pw = work[:PARITY_REQUESTS]
    streams = {}
    for window in (1, WINDOW):
        eng = ServingEngine(m32, paged_kernel=True, decode_window=window,
                            device=device, **ENGINE)
        streams[window], _, _ = _drive(eng, pw)
        del eng
    parity = _parity(m32, pw, streams[WINDOW], streams[1])
    sampled = {}
    seeds = [1000 + i for i in range(len(pw))]
    for window in (1, WINDOW):
        eng = ServingEngine(m32, paged_kernel=True, decode_window=window,
                            temperature=0.8, top_k=50, device=device,
                            **ENGINE)
        sampled[window], _, _ = _drive(eng, pw, seeds=seeds)
        del eng
    del m32
    _empty()
    same_sampled = sampled[1] == sampled[WINDOW]
    rec = {"phase": "serve_window", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(ENGINE, paged_kernel=True, decode_window=WINDOW),
           "requests": N_REQUESTS, "wall_s": wall,
           "tokens_generated": rep["tokens_generated"],
           "tokens_per_sec": rep["tokens_per_sec"],
           "tpot_p50_s": rep["tpot_p50_s"], "window_calls": calls,
           "engine_calls_per_decoded_token": calls / max(decoded, 1),
           "kernel_launches": launches, "f32_parity": parity,
           "sampled_f32": {"temperature": 0.8, "top_k": 50,
                           "requests": len(pw),
                           "window_equals_per_token": same_sampled},
           "run_s": time.perf_counter() - t_phase}
    emit(rec)
    _check_parity("serve_window", parity)
    if not same_sampled:
        raise AssertionError("serve_window: the sampled window stream "
                             "differs from the per-token stream")
    return rec


def _chunked_traffic(seed, long_new=None, short_new=None):
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = LM["vocab_size"]
    short = [(rng.integers(1, vocab, int(rng.integers(
        CHUNKED["short_prompt"][0], CHUNKED["short_prompt"][1] + 1))),
        short_new or CHUNKED["short_new"]) for _ in range(CHUNKED["n_short"])]
    long = [(rng.integers(1, vocab, int(rng.integers(
        CHUNKED["prompt"][0], CHUNKED["prompt"][1] + 1))),
        long_new or int(rng.integers(CHUNKED["long_new"][0],
                                     CHUNKED["long_new"][1] + 1)))
        for _ in range(CHUNKED["n_long"])]
    return short, long


def _short_then_long(engine, short, long, chunk_tokens):
    """The short requests admit first and decode; the long ones arrive
    once all of them are decoding. Returns every stream (short first) and
    the short requests' gaps between consecutive tokens that overlap the
    span from the long requests' arrival to their last first token."""
    import numpy as np
    import torch

    from chainermn_torch.serving import FCFSScheduler, RequestState

    sched = FCFSScheduler(engine, chunk_tokens_per_step=chunk_tokens)
    stamps = [[] for _ in short]
    reqs = [sched.submit(p, n, stream_cb=lambda t, i=i: stamps[i].append(
        time.perf_counter())) for i, (p, n) in enumerate(short)]
    while any(r.state is not RequestState.DECODE for r in reqs):
        sched.step()
    torch.cuda.synchronize()
    t_long = time.perf_counter()
    longs = [sched.submit(p, n) for p, n in long]
    t_prefilled = None
    while sched.has_work:
        sched.step()
        if t_prefilled is None and all(r.tokens or r.finished
                                       for r in longs):
            torch.cuda.synchronize()
            t_prefilled = time.perf_counter()
    for r in reqs + longs:
        if not (r.finished and r.error is None
                and len(r.tokens) == r.max_new_tokens):
            raise AssertionError(f"request {r.id}: {r.state} {r.error}")
    # every gap that overlaps the long prompts' prefill
    gaps = [b - a for s in stamps for a, b in zip(s, s[1:])
            if b > t_long and a < t_prefilled]
    return ([[int(t) for t in r.tokens] for r in reqs + longs],
            np.asarray(gaps, np.float64), t_prefilled - t_long)


def phase_serve_chunked(device, card):
    """Chunked prefill: 8 prompts of 1536-1920 tokens arrive while 8 short
    requests decode, prefilled 256 tokens a step (bf16, kernel reads).
    Reports the short requests' decode-gap p99 while the long prompts
    prefill, chunked against unchunked (not gated). Fails unless the f32
    chunked streams equal the unchunked ones up to recorded near-ties."""
    import numpy as np
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    eng_kw = dict(ENGINE, prefill_buckets=CHUNKED["buckets"])
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    short, long = _chunked_traffic(SEED + 20)
    gaps = {}
    for name, chunk in (("unchunked", None),
                        ("chunked", CHUNKED["chunk_tokens"])):
        eng = ServingEngine(model, paged_kernel=True, device=device,
                            **eng_kw)
        eng.warmup()
        _, g, prefill_s = _short_then_long(eng, short, long, chunk)
        _check_pool(eng, f"serve_chunked {name}")
        gaps[name] = {"samples": int(g.size),
                      "p50_s": float(np.percentile(g, 50)),
                      "p99_s": float(np.percentile(g, 99)),
                      "max_s": float(g.max()),
                      "long_prefill_wall_s": prefill_s}
        del eng
    del model
    _empty()
    m32 = TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                        seed=SEED)
    short, long = _chunked_traffic(SEED + 21, CHUNKED["parity_long_new"],
                                   CHUNKED["parity_short_new"])
    streams = {}
    for name, chunk in (("unchunked", None),
                        ("chunked", CHUNKED["chunk_tokens"])):
        eng = ServingEngine(m32, paged_kernel=True, device=device, **eng_kw)
        streams[name], _, _ = _short_then_long(eng, short, long, chunk)
        del eng
    parity = _parity(m32, short + long, streams["chunked"],
                     streams["unchunked"])
    del m32
    _empty()
    rec = {"phase": "serve_chunked", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(eng_kw, paged_kernel=True), "traffic": CHUNKED,
           "short_decode_gaps_during_long_prefill": gaps,
           "f32_parity": parity, "run_s": time.perf_counter() - t_phase}
    emit(rec)
    _check_parity("serve_chunked", parity)
    return rec


def phase_serve_dense(device, card):
    """The dense engine with its prefix store (``paged=False``, 512
    blocks of 16 tokens), bf16, the ``serve_spec`` traffic without
    speculation. Reports tokens/s, TPOT and the prefix hit rate. Fails
    unless the f32 dense streams equal the paged engine's up to recorded
    near-ties."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    dense_kw = {kk: v for kk, v in ENGINE.items() if kk != "kv_block_size"}
    work = _spec_traffic(N_REQUESTS, SEED + 10)
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    engine = ServingEngine(model, paged=False, device=device, **DENSE,
                           **dense_kw)
    engine.warmup()
    kv_bytes = sum(t.numel() * t.element_size() for c in engine.caches
                   for t in c.values())
    _, sched, wall = _drive(engine, work)
    rep = sched.metrics.report()
    prefix = engine.prefix_stats()
    del engine, model
    _empty()
    m32 = TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                        seed=SEED)
    pw = work[:PARITY_REQUESTS]
    paged = ServingEngine(m32, paged_kernel=True, device=device, **ENGINE)
    want, _, _ = _drive(paged, pw)
    del paged
    dense = ServingEngine(m32, paged=False, device=device, **DENSE,
                          **dense_kw)
    got, _, _ = _drive(dense, pw)
    parity = _parity(m32, pw, got, want)
    del dense, m32
    _empty()
    rec = {"phase": "serve_dense", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(dense_kw, paged=False, **DENSE),
           "traffic": dict(SPEC, requests=N_REQUESTS, speculative=False),
           "dense_kv_gb": kv_bytes / 1e9, "wall_s": wall,
           "tokens_generated": rep["tokens_generated"],
           "tokens_per_sec": rep["tokens_per_sec"],
           "tpot_p50_s": rep["tpot_p50_s"], "ttft_p50_s": rep["ttft_p50_s"],
           "prefix": prefix, "prefix_hit_rate": rep.get("prefix_hit_rate"),
           "f32_parity": parity, "run_s": time.perf_counter() - t_phase}
    emit(rec)
    _check_parity("serve_dense", parity)
    return rec


# -- the engine's fixed step programs: every serving path eager and as
#    captured CUDA graphs, then warm restart and the weight-swap fence --

GRAPH_PROFILE_STEPS = 10
# the eager runs serve the first 4 of the 32 requests, and the f32
# captured-vs-eager parity 4 requests a path and mode: the cuts that keep
# the script inside its time limit (the eager runs took ~95 of the
# phase's 114-120 s at 8 each); the captured bf16 runs serve all 32
GRAPH_EAGER_REQUESTS = 4
GRAPH_PARITY_REQUESTS = 4
# ... and each of those asks at most 32 new tokens (of its 64-128): the
# parity gate and a planted fault part within a few tokens, and an eager
# step's times come from its first tens of steps as well as from its last
GRAPH_NEW_TOKENS = 32
# the f32 twin of that parity at 2 of the 12 layers: its eager runs step
# layer by layer on the host (~40 of the phase's 74-80 s at 12 layers)
GRAPH_F32_LM = dict(LM, n_layers=2)
GRAPH_SAMPLED = dict(temperature=0.8, top_k=50)


def _graph_paths():
    """The serving paths the graphs phase runs: name -> (engine keywords,
    traffic, kernel launches per engine call per layer)."""
    from chainermn_torch.serving import SpeculativeConfig

    dense_kw = {kk: v for kk, v in ENGINE.items() if kk != "kv_block_size"}
    serve = _serve_traffic(N_REQUESTS, SEED)
    spec = _spec_traffic(N_REQUESTS, SEED + 10)
    return {
        "serve": (dict(ENGINE, paged_kernel=True), serve, 1),
        "serve_window": (dict(ENGINE, paged_kernel=True,
                              decode_window=WINDOW), serve, WINDOW),
        "serve_spec": (dict(ENGINE, paged_kernel=True,
                            speculative=SpeculativeConfig(k=SPEC["k"])),
                       spec, 1),
        "serve_dense": (dict(dense_kw, paged=False, **DENSE), spec, 0),
    }


def _graph_pool_bytes(engine):
    """Bytes of the segments in the engine's CUDA-graph memory pool."""
    import torch

    pool = engine._programs._pool
    if pool is None:
        return 0
    try:
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
    except Exception:  # noqa: BLE001 — an allocator without the field
        return "not measured"


def _engine_ptrs(engine):
    """Addresses of every tensor the engine's programs read or write."""
    out = {f"param:{k}": p.data_ptr()
           for k, p in engine.model.state_dict().items()}
    for i, layer in enumerate(engine._store or ()):
        out.update({f"store{i}:{k}": t.data_ptr() for k, t in layer.items()})
    for i, layer in enumerate(engine.caches or ()):
        out.update({f"cache{i}:{k}": t.data_ptr() for k, t in layer.items()})
    progs = list(engine._prefill_progs.values()) + [engine._decode_prog]
    for prog in progs:
        out.update({f"{prog.name}:{k}": t.data_ptr()
                    for k, t in prog.inputs.items()})
    return out


def _graph_run(model, kw, work, capture, device, *, profile=False,
               seeds=None, per_call=0):
    """One engine of a path, eager or captured: warmup, the traffic, and
    (``profile``) a traced steady window. Fails unless the programs are
    built once each and never again, and, on a kernel path, the kernel
    launched ``per_call`` x the model's layers times for every engine
    decode call."""
    import numpy as np
    import torch

    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine

    eng = ServingEngine(model, device=device, capture=capture, **kw)
    reserved0 = torch.cuda.memory_stats()["reserved_bytes.all.current"]
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = eng.compile_counts_detailed()
    labels = {"engine": "serving"}
    if eng.paged:
        labels["paged_kernel"] = "on" if eng.paged_kernel else "off"
    calls_ctr = get_registry().counter("serving_decode_steps_total", labels)
    calls0 = calls_ctr.value
    paged_attend.launches = 0
    streams, sched, wall = _drive(eng, work, seeds=seeds)
    launches = paged_attend.launches
    calls = calls_ctr.value - calls0
    rep = sched.metrics.report()
    rec = {"capture": eng.capture, "warmup_s": warm_s,
           "capture_s": eng._programs.capture_s,
           "graph_pool_bytes": _graph_pool_bytes(eng),
           "reserved_bytes_added_by_warmup":
               torch.cuda.memory_stats()["reserved_bytes.all.current"]
               - reserved0,
           "wall_s": wall, "tokens_generated": rep["tokens_generated"],
           "tokens_per_sec": rep["tokens_per_sec"],
           "tpot_p50_s": rep["tpot_p50_s"], "ttft_p50_s": rep["ttft_p50_s"],
           "ttft_p99_s": rep["ttft_p99_s"], "decode_calls": calls,
           "kernel_launches": launches, "compile_counts": counts,
           "recompiles": eng.recompiles}
    if set(counts.values()) != {1} or eng.compile_counts_detailed() \
            != counts or eng.recompiles:
        raise AssertionError(f"serve_graphs: programs rebuilt: {counts} -> "
                             f"{eng.compile_counts_detailed()} "
                             f"{eng.recompiles}")
    n_layers = len(model.blocks)
    if launches != calls * per_call * n_layers:
        raise AssertionError(f"serve_graphs: kernel launches {launches} != "
                             f"{calls} calls x {per_call} x {n_layers}")
    if profile:
        prof = _profile_steps(eng, sched, np.random.default_rng(SEED + 40),
                              GRAPH_PROFILE_STEPS, host_events=False)
        rec.update({k: prof[k] for k in ("step_wall_ms",
                                         "step_device_busy_ms",
                                         "device_idle_share")})
    del eng, sched
    _empty()
    return streams, rec


def phase_serve_graphs(device, card):
    """Each serving path (``serve``, ``serve_window``, ``serve_spec``,
    ``serve_dense``; the 220M LM in bf16, 4 requests of at most
    GRAPH_NEW_TOKENS eager and 32 captured) with ``capture=False`` and
    then captured: tokens/s, TPOT, TTFT, a profiled step's device-busy
    ms and idle share, the capture seconds and the graph pool's bytes.
    Fails unless every run builds each program once
    (``compile_counts_detailed()`` flat, ``recompiles`` empty), the
    kernel launches equal decode calls x window x layers on both, and, on
    the f32 LM at 2 layers with 4 requests of at most GRAPH_NEW_TOKENS,
    each path's captured streams equal its eager ones up to the near-tie
    rule (greedy; sampled at T 0.8 / top-k 50 except the greedy-only
    verify window) while a planted fault (the captured decode program
    reading one table block) fails that gate."""
    import torch

    from chainermn_torch.models import TransformerLM

    t_phase = time.perf_counter()
    paths = _graph_paths()
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    runs = {}
    for name, (kw, work, per_call) in paths.items():
        runs[name] = {}
        for capture in (False, True):
            _, runs[name][str(capture).lower()] = _graph_run(
                model, kw, work if capture else
                _capped(work[:GRAPH_EAGER_REQUESTS], GRAPH_NEW_TOKENS),
                capture, device, profile=True, per_call=per_call)
    del model
    _empty()
    m32 = TransformerLM(**GRAPH_F32_LM, compute_dtype=torch.float32,
                        device=device, seed=SEED)
    parity = {}
    seeds = [2000 + i for i in range(GRAPH_PARITY_REQUESTS)]
    for name, (kw, work, per_call) in paths.items():
        pw = _capped(work[:GRAPH_PARITY_REQUESTS], GRAPH_NEW_TOKENS)
        modes = [("greedy", {}, None)]
        if name != "serve_spec":
            modes.append(("sampled", GRAPH_SAMPLED, seeds))
        for mode, extra, sd in modes:
            got = {}
            for capture in (False, True):
                got[capture], _ = _graph_run(m32, dict(kw, **extra), pw,
                                             capture, device, seeds=sd,
                                             per_call=per_call)
            parity[f"{name}_{mode}"] = _parity(m32, pw, got[True],
                                               got[False])
            if mode == "greedy" and name == "serve":
                want = got[False]
    # the planted fault: the programs capture a kernel read cut to one
    # table block, then the real wrapper is back for every later phase
    from chainermn_torch.parallel import paged_kernel
    from chainermn_torch.serving import ServingEngine

    kw, work, _ = paths["serve"]
    pw = _capped(work[:GRAPH_PARITY_REQUESTS], GRAPH_NEW_TOKENS)
    real = paged_kernel.paged_attend

    def one_block(*args, **kwargs):
        return real(*args, **dict(kwargs, max_blocks=1))

    one_block.launches = 0
    paged_kernel.paged_attend = one_block
    try:
        bad = ServingEngine(m32, device=device, **kw)
        bad.warmup()
    finally:
        paged_kernel.paged_attend = real
    fault, _, _ = _drive(bad, pw)
    planted = _parity(m32, pw, fault, want)
    del bad, m32
    _empty()
    rec = {"phase": "serve_graphs", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "requests": {"eager": GRAPH_EAGER_REQUESTS,
                        "captured": N_REQUESTS,
                        "f32_parity": GRAPH_PARITY_REQUESTS,
                        "eager_and_f32_max_new": GRAPH_NEW_TOKENS},
           "f32_model": GRAPH_F32_LM,
           "profile_steps": GRAPH_PROFILE_STEPS,
           "runs": runs, "f32_parity": parity, "planted_fault": planted,
           "run_s": time.perf_counter() - t_phase}
    emit(rec)
    for name, p in parity.items():
        _check_parity(f"serve_graphs {name}", p)
    if not planted["failures"]:
        raise AssertionError("serve_graphs: the planted one-block decode "
                             "read passes the parity gate")
    return rec


def phase_serve_restart_swap(device, card):
    """Warm restart and the weight-swap fence on the captured ``serve``
    engine (220M, bf16): a ``serving.decode`` fault mid-run must end
    every in-flight request ERRORED with ``EngineFailed`` after one
    restart, and a probe request afterwards must stream exactly what it
    streamed on the fresh engine; then ``request_swap`` onto a second
    seeded weight set, with requests in flight: they finish on version
    0, and the probe admitted after the fence must stream exactly what a
    fresh engine on the new weights streams. Fails unless the programs'
    counts never move and no store, parameter or static input moves."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.resilience import FaultInjector
    from chainermn_torch.resilience.cutpoints import SERVING_DECODE
    from chainermn_torch.serving import (
        EngineFailed,
        FCFSScheduler,
        RequestState,
        ServingEngine,
    )

    t_phase = time.perf_counter()
    kw = dict(ENGINE, paged_kernel=True)
    work = _serve_traffic(8, SEED + 30)
    probe = work[0]
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    eng = ServingEngine(model, device=device, **kw)
    eng.warmup()
    counts = eng.compile_counts_detailed()
    ptrs = _engine_ptrs(eng)
    fresh_a, _, _ = _drive(eng, [probe])
    sched = FCFSScheduler(eng)
    victims = [sched.submit(p, n) for p, n in work[1:]]
    inj = FaultInjector()
    inj.arm(SERVING_DECODE, kind="raise", after=20, times=1)
    with inj:
        while sched.has_work:
            sched.step()
    torch.cuda.synchronize()
    errored = sum(r.state is RequestState.ERRORED
                  and isinstance(r.error, EngineFailed) for r in victims)
    restarts = sched.engine_restarts
    after_restart, _, _ = _drive(eng, [probe])
    model_b = TransformerLM(**LM, compute_dtype=torch.bfloat16,
                            device=device, seed=SEED + 1).cast_weights_()
    fresh = ServingEngine(model_b, device=device, **kw)
    fresh_b, _, _ = _drive(fresh, [probe])
    del fresh
    state_b = model_b.state_dict()
    sched = FCFSScheduler(eng)
    pre = [sched.submit(p, n) for p, n in work[1:5]]
    for _ in range(5):
        sched.step()
    in_flight = eng.active_slots
    ticket = sched.request_swap(lambda: eng.swap_params(state_b))
    post = sched.submit(*probe)
    while sched.has_work:
        sched.step()
    torch.cuda.synchronize()
    ok_pre = all(r.finished and r.error is None and r.weight_version == 0
                 and len(r.tokens) == r.max_new_tokens for r in pre)
    rec = {"phase": "serve_restart_swap", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(kw, capture=eng.capture),
           "fault": {"in_flight": len(victims), "errored": errored,
                     "engine_restarts": restarts,
                     "probe_equals_fresh_engine": after_restart == fresh_a},
           "swap": {"in_flight_at_request": in_flight,
                    "ticket_result": ticket.result,
                    "ticket_error": repr(ticket.error),
                    "fence_s": ticket.fence_s, "pre_on_version_0": ok_pre,
                    "post_weight_version": post.weight_version,
                    "probe_equals_fresh_engine_b":
                        [int(t) for t in post.tokens] == fresh_b[0]},
           "compile_counts_flat": eng.compile_counts_detailed() == counts,
           "recompiles": eng.recompiles,
           "addresses_unchanged": _engine_ptrs(eng) == ptrs,
           "run_s": time.perf_counter() - t_phase}
    emit(rec)
    del eng, model, model_b, state_b
    _empty()
    f, sw = rec["fault"], rec["swap"]
    if not (f["errored"] == len(victims) and f["engine_restarts"] == 1
            and f["probe_equals_fresh_engine"]):
        raise AssertionError(f"serve_restart_swap: restart {f}")
    if not (ticket.error is None and ticket.result == 1 and ok_pre
            and in_flight and sw["post_weight_version"] == 1
            and sw["probe_equals_fresh_engine_b"]):
        raise AssertionError(f"serve_restart_swap: swap {sw}")
    if not (rec["compile_counts_flat"] and not rec["recompiles"]
            and rec["addresses_unchanged"]):
        raise AssertionError(f"serve_restart_swap: programs or addresses "
                             f"moved: {rec}")
    return rec


# -- the serving fleet: KV migration between replicas on one card --

FLEET_WIDTHS = (4, 32, 128)        # kv_gather/kv_scatter widths timed
FLEET_REBALANCE_NEW = 128
# the f32 fleets' requests ask at most 32 new tokens each (of 64-128), as
# serve_graphs' f32 ones: the short import fails at a request's first
# tokens; the rebalanced stream keeps its 64
FLEET_F32_NEW_TOKENS = 32
FLEET_WAIT_S = 120


def _block_bytes(engine):
    """Bytes one store block holds over every layer (all its tensors)."""
    return sum(t[0].numel() * t.element_size()
               for layer in engine._store for t in layer.values())


def _count_decodes(engines):
    """Count each engine's decode calls that ran (an instance wrapper of
    ``decode_round``, which the replica's scheduler calls); returns the
    boxes and an undo."""
    boxes = []
    for eng in engines:
        box = {"calls": 0}
        real = eng.decode_round

        def counted(ctx=None, _real=real, _box=box):
            out = _real(ctx=ctx)
            if out:
                _box["calls"] += 1
            return out

        eng.decode_round = counted
        boxes.append(box)

    def undo():
        for eng in engines:
            del eng.decode_round

    return boxes, undo


def _hist_tail(name, count0):
    """Samples a ``{"engine": "serving"}`` histogram took since its count
    was ``count0``."""
    from chainermn_torch.monitor import get_registry

    h = get_registry().histogram(name, {"engine": "serving"}, unit="s")
    new = h.count - count0
    return h.samples[-new:] if new else []


def _p(samples, q):
    import numpy as np

    return float(np.percentile(samples, q)) if samples else None


def _fleet_run(engines, work, *, seeds=None, first_alone=False,
               after_first=None, **router_kw):
    """Serve ``work`` through a ``FleetRouter`` over ``engines`` (each
    warm-restarted first, so every run starts from empty stores and
    tries); ``first_alone`` serves the first request before submitting
    the rest, and ``after_first(router)`` runs between. Returns the
    streams and a record: tokens/s, pooled TTFT/TPOT, migrations, blocks
    and bytes moved, export/import seconds, each engine's decode calls
    and kernel launches, shares, affinity. Fails unless every request
    finished with its whole budget and no program was built again."""
    import torch

    from chainermn_torch.fleet import FleetRouter
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend

    for eng in engines:
        eng.restart()
    reg = get_registry()
    lab = {"engine": "serving"}
    mig = reg.counter("kv_migrations_total", lab)
    blk = reg.counter("kv_migrated_blocks_total", lab)
    mig0, blk0 = mig.value, blk.value
    exp0 = reg.histogram("kv_export_seconds", lab, unit="s").count
    imp0 = reg.histogram("kv_import_seconds", lab, unit="s").count
    boxes, undo = _count_decodes(engines)
    router = FleetRouter(engines, **router_kw)
    try:
        if not router.wait_ready(FLEET_WAIT_S):
            raise AssertionError("serve_fleet: a replica did not warm up")
        counts = [e.compile_counts_detailed() for e in engines]
        launches0 = [e._programs.kernel_launches for e in engines]
        paged_attend.launches = 0
        t0 = time.perf_counter()
        frs = []
        for i, (p, n) in enumerate(work):
            frs.append(router.submit(p, n, seed=seeds[i] if seeds else 0))
            if i == 0 and first_alone:
                frs[0].wait(FLEET_WAIT_S)
                if after_first is not None:
                    after_first(router)
        for fr in frs:
            if not fr.wait(FLEET_WAIT_S):
                emit({"phase": "serve_fleet_hang", "request": fr.id,
                      **_fleet_state(router, frs)})
                raise AssertionError(f"serve_fleet: request {fr.id} hung")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paged_attend.launches
        rep = router.fleet_report()
        states = [r.state.value for r in router.replicas]
    finally:
        router.close()
        undo()
    streams = [[int(t) for t in fr.tokens] for fr in frs]
    for fr, (_, n) in zip(frs, work):
        if fr.error is not None or len(fr.tokens) != n:
            raise AssertionError(f"serve_fleet: request {fr.id} ended "
                                 f"{fr.state} with {len(fr.tokens)} of {n} "
                                 f"tokens: {fr.error}")
    for eng, before in zip(engines, counts):
        if eng.compile_counts_detailed() != before or eng.recompiles \
                or set(before.values()) != {1}:
            raise AssertionError(f"serve_fleet: programs rebuilt: {before} "
                                 f"-> {eng.compile_counts_detailed()} "
                                 f"{eng.recompiles}")
    pooled = rep["pooled"]
    ttft = pooled["histograms"]["serving_ttft_seconds"]
    tpot = pooled["histograms"]["serving_tpot_seconds"]
    tokens = sum(len(s) for s in streams)
    blocks = blk.value - blk0
    exp_s = _hist_tail("kv_export_seconds", exp0)
    imp_s = _hist_tail("kv_import_seconds", imp0)
    rec = {"requests": len(work), "wall_s": wall, "tokens": tokens,
           "tokens_per_sec": tokens / wall, "ttft_p50_s": ttft.get("p50_s"),
           "ttft_p99_s": ttft.get("p99_s"), "tpot_p50_s": tpot.get("p50_s"),
           "migrations": mig.value - mig0, "blocks_moved": blocks,
           "bytes_moved": blocks * _block_bytes(engines[0]),
           "export_s_p50": _p(exp_s, 50), "export_s_p99": _p(exp_s, 99),
           "import_s_p50": _p(imp_s, 50), "import_s_p99": _p(imp_s, 99),
           "exports": len(exp_s), "imports": len(imp_s),
           "decode_calls": [b["calls"] for b in boxes],
           "kernel_launches": [e._programs.kernel_launches - n0
                               for e, n0 in zip(engines, launches0)],
           "kernel_launches_total": launches,
           "affinity": rep["affinity"], "kv_reuse": rep["kv_reuse"],
           "tiers": rep["tiers"], "states": states}
    if sum(rec["kernel_launches"]) != launches:
        raise AssertionError(f"serve_fleet: per-engine launches "
                             f"{rec['kernel_launches']} do not add up to "
                             f"the wrapper's count {launches}")
    for calls, n in zip(rec["decode_calls"], rec["kernel_launches"]):
        if n != calls * LM["n_layers"]:
            raise AssertionError(f"serve_fleet: {n} kernel launches on "
                                 f"{calls} decode calls x "
                                 f"{LM['n_layers']} layers")
    return streams, rec


def _fleet_state(router, frs):
    """What a stalled fleet holds: each replica's state, queue, decoding
    slots, pending imports and KV-reuse tickets, the unfinished
    requests, the threads' stacks and the newest events."""
    import sys
    import traceback

    from chainermn_torch.monitor import get_event_log

    reps = {}
    for r in router.replicas:
        sc, eng = r.scheduler, r.engine
        reps[r.replica_id] = {
            "state": r.state.value, "thread_alive": r._thread.is_alive(),
            "queue": len(sc._queue), "by_slot": sorted(sc._by_slot),
            "prefilling": sorted(sc._prefilling),
            "pending_imports": [q.id for q, _ in sc._pending_imports],
            "pending_kv_reuse": len(sc._pending_kv_reuse),
            "active_slots": eng.active_slots,
            "free_slots": sorted(eng.free_slots), "kv": eng.kv_stats()}
    stacks = {str(t): "".join(traceback.format_stack(f))[-1500:]
              for t, f in sys._current_frames().items()}
    return {"replicas": reps,
            "unfinished": [{"id": fr.id, "replica": fr.replica_id,
                            "tokens": len(fr.tokens),
                            "inner_state": str(fr._inner.state)
                            if fr._inner is not None else None}
                           for fr in frs if not fr.finished],
            "events": get_event_log().tail(40), "stacks": stacks}


def _kv_program_ms(engine):
    """CUDA-event ms of ``kv_gather_{w}``/``kv_scatter_{w}`` on an idle
    engine at the widths of ``FLEET_WIDTHS`` (blocks 1..w, the scatter
    writing them), against the bytes bound (w blocks read and w written)
    and the plain PyTorch call a caller could make instead (one
    ``index_select`` a store tensor). Restarts the engine after: the
    scatters overwrite live blocks."""
    import numpy as np
    import torch

    out = {}
    bb = _block_bytes(engine)
    for w in FLEET_WIDTHS:
        ids = np.arange(1, w + 1, dtype=np.int64)
        ids_t = torch.as_tensor(ids, device=engine.device)
        g, s = engine._gather_progs[w], engine._scatter_progs[w]
        stores = [t for layer in engine._store for t in layer.values()]
        out[str(w)] = {
            "gather_ms": cuda_ms(lambda: g.run(ids=ids), reps=20),
            "scatter_ms": cuda_ms(lambda: s.run(ids=ids,
                                                n_used=np.asarray([w])),
                                  reps=20),
            "index_select_ms": cuda_ms(
                lambda: [t.index_select(0, ids_t) for t in stores], reps=20),
            "bytes": w * bb, "bound_ms": 2 * w * bb / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
    engine.restart()
    return out


def _int8_bit_exact(models, device):
    """An int8 store (bf16 model) migrates bit for bit: a prefilled
    slot's rows exported from one captured engine, imported into another
    and exported again are identical, and both decode the same tokens."""
    import torch

    from chainermn_torch.serving import ServingEngine

    kw = dict(ENGINE, paged_kernel=True, kv_quant="int8")
    a, b = (ServingEngine(m, device=device, **kw) for m in models)
    for eng in (a, b):
        eng.warmup()
    prompt = _serve_traffic(1, SEED + 70)[0][0]
    (slot_a, first), = a.admit_batch([a.plan_admission(prompt, max_new=32)])
    payload = a.export_slot_kv(slot_a)
    slot_b = b.import_slot_kv(payload, prompt=prompt, max_new=32)
    back = b.export_slot_kv(slot_b)
    same_rows = all(torch.equal(lp[kk], lb[kk])
                    for lp, lb in zip(payload["layers"], back["layers"])
                    for kk in lp)
    streams = []
    for eng, slot in ((a, slot_a), (b, slot_b)):
        toks = [first]
        while len(toks) < 32:
            for s in range(eng.n_slots):
                while eng.slot_needs_block(s):
                    eng.append_block(s)
            toks.extend(eng.decode_round()[slot])
        streams.append(toks[:32])
    rec = {"blocks": payload["n_blocks"],
           "dtypes": sorted({str(t.dtype) for t in payload["layers"][0]
                             .values()}),
           "rows_bit_exact": bool(same_rows),
           "streams_equal": streams[0] == streams[1],
           "recompiles": [a.recompiles, b.recompiles]}
    del a, b
    _empty()
    if not (same_rows and rec["streams_equal"]
            and not any(rec["recompiles"])):
        raise AssertionError(f"serve_fleet: int8 migration not exact: {rec}")
    return rec


def _drop_last_block(engine):
    """The planted fault: this engine's imports land one block fewer than
    the payload carries (its last block keeps what it held)."""
    real = engine._scatter_block_rows

    def short(new, packed, ctx, fused):
        if len(new) < 2:
            return real(new, packed, ctx, fused)
        return real(new[:-1], {kk: rows[:-1] for kk, rows in packed.items()},
                    ctx, fused)

    engine._scatter_block_rows = short
    return lambda: delattr(engine, "_scatter_block_rows")


def phase_serve_fleet(device, card):
    """The serving fleet on one card: two replicas of the 220M LM (bf16,
    captured, the kernel on the decode reads), each on weights of its own
    from ``SEED``, warmed at once on their threads. ``tiers``: 1 prefill
    + 1 decode replica serve ``serve``'s 32 requests, every request's KV
    migrating after its prefill; ``share``: 2 symmetric replicas with
    prefix sharing on and off over the shared-prefix traffic;
    ``rebalance``: one live decode moved mid-stream. The migration
    programs are timed at 4, 32 and 128 blocks. On the f32 LM (8
    requests of at most FLEET_F32_NEW_TOKENS new tokens, greedy and
    sampled) the 1P+1D and sharing fleets' streams must equal the solo
    engine's up to the near-tie rule, as must a rebalanced stream; an
    int8 store must migrate bit for bit, and the planted fault (an
    import one block short) must fail 8/8. Fails
    unless every replica warms, no program is built twice, and each
    engine's kernel launches are its decode calls x 12."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    kw = dict(ENGINE, paged_kernel=True)
    models = [TransformerLM(**LM, compute_dtype=torch.bfloat16,
                            device=device, seed=SEED) for _ in range(2)]
    engines = [ServingEngine(m, device=device, **kw) for m in models]
    rec = {"phase": "serve_fleet", "card": card,
           "model": dict(LM, compute_dtype="bf16"), "engine": kw,
           "block_bytes": _block_bytes(engines[0])}
    # the first router warms both replicas at once on their own threads
    t0 = time.perf_counter()
    serve = _serve_traffic(N_REQUESTS, SEED)
    _, tiers = _fleet_run(engines, serve, prefill_replicas=1,
                          decode_replicas=1)
    rec["concurrent_warmup"] = {
        "replicas": 2, "states_after_warmup": tiers["states"],
        "capture_s": [e._programs.capture_s for e in engines],
        "programs": len(engines[0].compile_counts_detailed()),
        "router_s_incl_traffic": time.perf_counter() - t0}
    rec["tiers"] = tiers
    rec["kv_programs"] = _kv_program_ms(engines[1])
    spec = _spec_traffic(N_REQUESTS, SEED + 10)
    runs = {}
    for share in (True, False):
        _, runs[str(share).lower()] = _fleet_run(
            engines, spec, first_alone=True, share_prefixes=share,
            prefix_share_min_blocks=2)
    rec["share"] = runs
    # rebalance: one long request alone on replica 0, moved to 1 after
    # its first token; its stream against a solo engine's
    prompt = serve[0][0]
    engines[0].restart()
    solo, _, _ = _drive(engines[0], [(prompt, FLEET_REBALANCE_NEW)])
    rec["rebalance"] = _rebalance(engines, prompt, FLEET_REBALANCE_NEW,
                                  solo[0])
    del engines
    _empty()
    rec["int8"] = _int8_bit_exact(models, device)
    del models
    _empty()
    rec["run_s"] = time.perf_counter() - t_phase
    emit(rec)
    rec["f32"], lint = _fleet_f32_sanitized(device)
    emit({"phase": "serve_fleet_f32", "card": card, **rec["f32"],
          "run_s": time.perf_counter() - t_phase})
    emit({"phase": "graftlint", "card": card, **lint})
    if lint["violations"]:
        raise AssertionError(f"serve_fleet: {len(lint['violations'])} "
                             f"sanitizer violations: "
                             f"{lint['violations'][:2]}")
    if lint["runtime_report_rc"] != 0:
        raise AssertionError("serve_fleet: an observed lock-order edge is "
                             "not in the static graph:\n"
                             + lint["runtime_report"])
    if lint["static"]["errors"] or lint["static"]["warnings"] \
            or lint["static"]["parse_errors"]:
        raise AssertionError(f"serve_fleet: graftlint over the port's "
                             f"tree: {lint['static']}")
    if tiers["states"] != ["healthy", "healthy"]:
        raise AssertionError(f"serve_fleet: replicas warmed at once ended "
                             f"{tiers['states']}")
    if tiers["migrations"] < 1 or tiers["decode_calls"][1] < 1:
        raise AssertionError(f"serve_fleet: the decode tier decoded "
                             f"nothing: {tiers}")
    if not rec["rebalance"]["moved"]:
        raise AssertionError(f"serve_fleet: rebalance {rec['rebalance']}")
    f32 = rec["f32"]
    for name, p in f32["parity"].items():
        _check_parity(f"serve_fleet f32 {name}", p)
    planted = f32["planted_fault"]
    if len(planted["failures"]) != planted["requests"]:
        raise AssertionError(f"serve_fleet: the planted short import "
                             f"failed {len(planted['failures'])} of "
                             f"{planted['requests']}")
    return rec


def _rebalance(engines, prompt, n_new, want):
    """One request alone on replica 0 of a symmetric fleet; after its
    first token the router moves it to replica 1."""
    from chainermn_torch.fleet import FleetRouter

    for eng in engines:
        eng.restart()
    router = FleetRouter(engines)
    try:
        router.wait_ready(FLEET_WAIT_S)
        fr = router.submit(prompt, n_new)
        deadline = time.perf_counter() + FLEET_WAIT_S
        while not fr.tokens and not fr.finished \
                and time.perf_counter() < deadline:
            time.sleep(0.0005)
        at = len(fr.tokens)
        t0 = time.perf_counter()
        ticket = router.rebalance_decode(0, 1)
        moved = bool(ticket.wait(60)) if ticket is not None else False
        handshake_s = time.perf_counter() - t0
        fr.wait(FLEET_WAIT_S)
        return {"moved": moved, "tokens_before_move": at,
                "handshake_s": handshake_s,
                "replica_after": fr.replica_id,
                "equals_solo": [int(t) for t in fr.tokens] == want,
                "rebalances": router.fleet_report()["kv_reuse"]["rebalances"]}
    finally:
        router.close()


def _fleet_f32_sanitized(device):
    """``_fleet_f32`` with the port's runtime sanitizer on (every fleet
    and scheduler lock instrumented), given the static lock-order graph
    of ``chainermn_torch/``: the artifact of observed edges is dumped and
    checked with ``--runtime-report``'s code (observed within static),
    and graftlint's static run over the tree is counted. Returns the f32
    record and the lint record."""
    import contextlib
    import io
    import tempfile

    from chainermn_torch.analysis import run_analysis, sanitizer
    from chainermn_torch.analysis.__main__ import _runtime_report
    from chainermn_torch.analysis.checkers import all_checkers
    from chainermn_torch.analysis.checkers.locks import static_lock_graph
    from chainermn_torch.analysis.core import load_project

    pkg = str(ROOT / "chainermn_torch")
    t0 = time.perf_counter()
    static = run_analysis([pkg], all_checkers()).to_json()["counts"]
    project, _ = load_project([pkg])
    graph = static_lock_graph(project)
    static_s = time.perf_counter() - t0
    sanitizer.reset()
    sanitizer.enable(static_graph=graph)
    try:
        t0 = time.perf_counter()
        f32 = _fleet_f32(device)
        f32_s = time.perf_counter() - t0
        observed = sorted(sanitizer.observed_class_edges(leaf=True))
        holds = sanitizer.hold_stats()
    finally:
        sanitizer.disable()
    tmp = tempfile.mkdtemp(prefix="sanitizer_")
    try:
        art = sanitizer.dump_artifact(str(Path(tmp) / "serve_fleet.json"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = _runtime_report(art, [pkg])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lint = {"static": static, "static_s": static_s,
            "static_edges": sorted(graph), "observed_class_edges": observed,
            "locks_instrumented": sorted(holds),
            "violations": sanitizer.violations(),
            "runtime_report_rc": rc, "runtime_report": buf.getvalue(),
            "sanitized_f32_s": f32_s}
    sanitizer.reset()
    return f32, lint


def _fleet_f32(device):
    """The f32 LM at full width, 8 requests (each asking at most
    FLEET_F32_NEW_TOKENS), greedy then sampled: the
    solo engine's streams against 1P+1D and against 2 replicas sharing
    prefixes (zero-tolerance affinity, so shares happen), a rebalanced
    stream (greedy), and the planted short import (greedy 1P+1D)."""
    import torch

    from chainermn_torch.fleet import RoutingPolicy
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    m32 = [TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                         seed=SEED) for _ in range(2)]
    tiers_work = _capped(_serve_traffic(PARITY_REQUESTS, SEED + 50),
                         FLEET_F32_NEW_TOKENS)
    share_work = _capped(_spec_traffic(PARITY_REQUESTS, SEED + 60),
                         FLEET_F32_NEW_TOKENS)
    seeds = [3000 + i for i in range(PARITY_REQUESTS)]
    out = {"parity": {}, "shares": {}, "migrations": {}}
    for mode, extra in (("greedy", {}), ("sampled", GRAPH_SAMPLED)):
        engines = [ServingEngine(m, device=device,
                                 **dict(ENGINE, paged_kernel=True, **extra))
                   for m in m32]
        for eng in engines:
            eng.warmup()
        for name, work, kw in (
                ("tiers", tiers_work,
                 dict(prefill_replicas=1, decode_replicas=1)),
                ("share", share_work,
                 dict(share_prefixes=True, prefix_share_min_blocks=2,
                      policy=RoutingPolicy(max_imbalance=0.0),
                      first_alone=True))):
            engines[0].restart()
            want, _, _ = _drive(engines[0], work, seeds=seeds)
            got, rec = _fleet_run(engines, work, seeds=seeds, **kw)
            out["parity"][f"{name}_{mode}"] = _parity(m32[0], work, got,
                                                      want)
            out["shares"][f"{name}_{mode}"] = rec["kv_reuse"]["shares"]
            out["migrations"][f"{name}_{mode}"] = rec["migrations"]
            if name == "tiers" and mode == "greedy":
                want_tiers = want
        if mode == "greedy":
            prompt = tiers_work[0][0]
            engines[0].restart()
            solo, _, _ = _drive(engines[0], [(prompt, 64)])
            reb = _rebalance(engines, prompt, 64, solo[0])
            out["rebalance"] = reb
            out["parity"]["rebalance_greedy"] = {
                "requests": 1, "identical": int(reb["equals_solo"]),
                "near_ties": [], "failures": (
                    [] if reb["equals_solo"] and reb["moved"]
                    else [{"moved": reb["moved"]}])}
            undo = _drop_last_block(engines[1])
            try:
                got, _ = _fleet_run(engines, tiers_work,
                                    prefill_replicas=1, decode_replicas=1)
            finally:
                undo()
            out["planted_fault"] = _parity(m32[0], tiers_work, got,
                                           want_tiers)
        del engines
        _empty()
    del m32
    _empty()
    return out


# the control plane on the card: the twin's cadences and autoscale policy
# (bake_s: the bake clock starts at the tick that begins the canary's
# publish, and a fence under load outlasts the twin's 1 s default;
# down_after_s: idle counts from the moment the fleet's load falls to
# idle_low, 8 of 32 slots, while the wave's last requests still decode,
# and the twin's 1 s could run out before the first deploy and retire
# the spawned replica early)
CONTROL = dict(min_replicas=1, max_replicas=2, queue_high=1.0, idle_low=0.25,
               up_after_s=0.2, down_after_s=2.0, cooldown_s=0.3,
               cadence_s=0.05, ts_cadence_s=0.05, bake_s=4.0,
               slo_ttft_s=10.0, load_in_flight=12, wave=16,
               steady_window_s=1.0, after_window_s=1.0)


class _Load:
    """A closed loop of ``in_flight`` requests through a router on its own
    thread (a finished one is replaced at once), every token's arrival
    time kept: the traffic a roll is measured under."""

    def __init__(self, router, work, in_flight):
        import threading

        self.router, self.work, self.in_flight = router, work, in_flight
        self.stamps, self.done, self.failed = [], 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chip-smoke-load")
        self._thread.start()

    def _run(self):
        live, i = [], 0
        while not self._stop.is_set() or live:
            for fr in list(live):
                try:
                    settled = fr.wait(0.001)   # the router settles on waits
                except Exception:  # noqa: BLE001 — recorded below
                    settled = True
                if not settled:
                    continue
                live.remove(fr)
                if fr.error is not None or len(fr.tokens) != \
                        fr.max_new_tokens:
                    self.failed.append((fr.id, repr(fr.error)))
                self.done += 1
            while not self._stop.is_set() and len(live) < self.in_flight:
                p, n = self.work[i % len(self.work)]
                i += 1
                live.append(self.router.submit(
                    p, n, stream_cb=lambda _t: self.stamps.append(
                        time.perf_counter())))
            time.sleep(0.002)

    def rate(self, t0, t1):
        """Tokens a second that arrived in ``[t0, t1]``."""
        n = sum(1 for t in list(self.stamps) if t0 <= t <= t1)
        return n / max(t1 - t0, 1e-9)

    def stop(self, timeout):
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise AssertionError("serve_control: the load did not drain")


def _record_publishes(router):
    """Wrap ``router.publish`` to keep every roll's window and per-replica
    outcome (the controller calls it through the instance)."""
    pubs = []
    real = router.publish

    def recorded(params, **kw):
        t0 = time.perf_counter()
        out = real(params, **kw)
        pubs.append({"t0": t0, "t1": time.perf_counter(),
                     "canary": kw.get("canary"),
                     "exclude": list(kw.get("exclude", ())),
                     "ok": out["ok"], "replicas": out["replicas"]})
        return out

    router.publish = recorded
    return pubs


def _until(pred, timeout, what):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(0.005)
    raise AssertionError(f"serve_control: timed out waiting for {what}")


def _bumped(state, delta, pinned):
    """Every float tensor of ``state`` plus ``delta``, in pinned host
    memory (``pinned``) or where it lies."""
    import torch

    with torch.no_grad():
        out = {}
        for k, v in state.items():
            t = v + delta if v.is_floating_point() else v.clone()
            out[k] = t.cpu().pin_memory() if pinned else t
        return out


def _prefix_counts(engines):
    return [(e.prefix_stats().get("hits", 0),
             e.prefix_stats().get("misses", 0)) for e in engines]


def _hit_rate(a, b):
    hits = sum(h1 - h0 for (h0, _), (h1, _) in zip(a, b))
    misses = sum(m1 - m0 for (_, m0), (_, m1) in zip(a, b))
    return {"hits": hits, "misses": misses,
            "hit_rate": hits / max(hits + misses, 1)}


def phase_serve_control(device, card):
    """The fleet's control plane on one card over the 220M LM (bf16,
    captured, the kernel on every decode read), run as the ``serve_lm.py``
    twin runs it: ``FleetRouter`` + ``fleet_health`` + ``SLOEngine`` +
    ``FleetController`` with their daemon threads at the twin's cadences,
    from one replica (``min_replicas=1, max_replicas=2``). ``serve``'s 32
    requests as a burst must scale up, and the spawned replica must serve
    the next wave; a deploy of every tensor bumped by 0.01 must bake and
    promote (every replica then on one weight version); a second deploy,
    its canary forced critical through a ``ThresholdDetector``, must roll
    back, under a closed loop of 12 requests; idle must scale down to 1.
    Then, on the f32 LM with 8 greedy requests, the streams of every
    replica after a rollback must equal a solo engine's on the pre-canary
    weights up to the near-tie rule, and the same rollback with the
    controller's pre-canary copy planted as a reference to the canary's
    live tensors must fail 8/8 on every replica. Fails unless no request
    is lost, no survivor rebuilds a program and each engine's kernel
    launches are its decode calls x 12. One card and one interpreter:
    these numbers are the cost and correctness of control, not capacity."""
    t_phase = time.perf_counter()
    rec = {"phase": "serve_control", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(ENGINE, paged_kernel=True), "policy": CONTROL,
           "note": "one card, one interpreter: the cost and correctness of "
                   "control, not capacity"}
    try:
        _control_bf16(device, rec)  # its engines are freed when it returns
    except BaseException:
        emit(dict(rec, phase="serve_control_failed"))
        raise
    _empty()
    rec["run_s"] = time.perf_counter() - t_phase
    emit(rec)
    rec["f32"] = _control_f32(device)
    emit({"phase": "serve_control_f32", "card": card, **rec["f32"],
          "run_s": time.perf_counter() - t_phase})
    _check_control(rec)
    return rec


def _control_bf16(device, rec):
    """The bf16 part of :func:`phase_serve_control`, filling ``rec``."""
    import torch

    from chainermn_torch.fleet import (
        AutoscalePolicy,
        CanaryPolicy,
        FleetController,
        FleetRouter,
    )
    from chainermn_torch.fleet import control as fleet_control
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import (
        LatencyObjective,
        SLOEngine,
        ThresholdDetector,
        fleet_health,
    )
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine

    kw = dict(ENGINE, paged_kernel=True)
    engines, boxes, undos, counts = [], [], [], {}
    t_built = {}

    def make_engine():
        t0 = time.perf_counter()
        eng = ServingEngine(TransformerLM(**LM, compute_dtype=torch.bfloat16,
                                          device=device, seed=SEED),
                            device=device, **kw)
        box, undo = _count_decodes([eng])
        engines.append(eng)
        boxes.extend(box)
        undos.append(undo)
        t_built[len(engines) - 1] = time.perf_counter() - t0
        return eng

    router = FleetRouter([make_engine()])
    pubs = _record_publishes(router)
    load = collector = controller = None
    try:
        if not router.wait_ready(FLEET_WAIT_S):
            raise AssertionError("serve_control: replica 0 did not warm up")
        counts[0] = engines[0].compile_counts_detailed()
        launches0 = {0: engines[0]._programs.kernel_launches}
        # both deploys' weights made before the controller starts: a
        # pinned copy of the LM takes about a second, which must not sit
        # between the wave and the first deploy
        v1 = _bumped(engines[0].model.state_dict(), 0.01, pinned=True)
        v2 = _bumped(v1, 0.01, pinned=True)
        collector = fleet_health(router, cadence_s=CONTROL["ts_cadence_s"],
                                 stall_timeout_s=30.0)
        slo = SLOEngine().add(LatencyObjective(
            "ttft_p99", "serving_ttft_seconds",
            threshold_s=CONTROL["slo_ttft_s"], windows=(5.0, 30.0)))
        controller = FleetController(
            router, collector, slo=slo, engine_factory=make_engine,
            autoscale=AutoscalePolicy(**{
                k: CONTROL[k] for k in (
                    "min_replicas", "max_replicas", "queue_high",
                    "idle_low", "up_after_s", "down_after_s",
                    "cooldown_s")}),
            canary=CanaryPolicy(bake_s=CONTROL["bake_s"]),
            cadence_s=CONTROL["cadence_s"],
            sensor_kw=dict(stall_timeout_s=30.0))
        paged_attend.launches = 0
        collector.start()
        controller.start()

        # 1. the burst: queue pressure scales up; the next wave, sent at
        # once, queues on the spawned replica while it warms (the fleet
        # must not go idle here, or the policy retires it again)
        burst = [router.submit(p, n)
                 for p, n in _serve_traffic(N_REQUESTS, SEED)]
        up = _until(lambda: next((d for d in controller.report()["decisions"]
                                  if d["action"] == "scale_up"), None),
                    60, "controller_scale_up")
        spawned = router.replicas[up["replica"]]
        wave = [router.submit(p, n)
                for p, n in _serve_traffic(CONTROL["wave"], SEED + 1)]
        spawned.ready.wait(FLEET_WAIT_S)
        t_ready = time.monotonic()
        if not spawned.accepting:
            raise AssertionError(f"serve_control: the spawned replica is "
                                 f"{spawned.state.value}")
        counts[1] = engines[1].compile_counts_detailed()
        launches0[1] = engines[1]._programs.kernel_launches
        rec["scale_up"] = {
            "decision": up, "ready_s": t_ready - up["t"],
            "engine_build_s": t_built.get(1),
            "capture_s": engines[1]._programs.capture_s}
        for fr in burst + wave:
            if not fr.wait(FLEET_WAIT_S):
                raise AssertionError(f"serve_control: request {fr.id} hung")
        rec["wave_served_by"] = [sum(fr.replica_id == r for fr in wave)
                                 for r in range(2)]

        # 2. a canary deploy that bakes and promotes (no traffic)
        t_deploy = time.monotonic()
        controller.deploy(v1, step=1)
        promote = _until(
            lambda: (controller.report()["canary"]["last_outcome"]
                     if controller.report()["phase"] == "idle" else None),
            60, "the first canary's outcome")
        rec["promote"] = {
            "outcome": promote,
            "deploy_to_outcome_s": time.monotonic() - t_deploy,
            "weight_versions": [r.engine.weight_version
                                for r in router.replicas]}

        # 3. under a closed loop of requests: the steady rate, then a
        # canary forced critical, rolled back
        load = _Load(router, _spec_traffic(64, SEED + 90),
                     CONTROL["load_in_flight"])
        time.sleep(0.5)
        t_s0 = time.perf_counter()
        pre0 = _prefix_counts(engines)
        time.sleep(CONTROL["steady_window_s"])
        t_s1 = time.perf_counter()
        pre1 = _prefix_counts(engines)
        n_pubs = len(pubs)
        controller.deploy(v2, step=2)
        active = _until(lambda: controller.report()["canary"]["active"],
                        60, "the second canary")
        rid = active["replica"]
        collector.health.add_detectors(str(rid), ThresholdDetector(
            f"planted@{rid}", "planted_regression", 0.5,
            severity="critical"))
        collector.store.append("planted_regression", time.monotonic(), 1.0)
        rollback = _until(
            lambda: (controller.report()["canary"]["last_outcome"]
                     if controller.report()["phase"] == "idle" else None),
            60, "the rollback")
        post0 = _prefix_counts(engines)
        time.sleep(CONTROL["after_window_s"])
        post1 = _prefix_counts(engines)
        load.stop(FLEET_WAIT_S)
        rolls = pubs[n_pubs:]
        steady = load.rate(t_s0, t_s1)
        rec["rollback"] = {
            "outcome": rollback,
            "weight_versions": [r.engine.weight_version
                                for r in router.replicas],
            "load_requests": load.done, "load_failed": load.failed,
            "tokens_per_sec_steady": steady,
            "rolls": [{"what": ("canary" if p["canary"] is not None
                                else "rollback"),
                       "s": p["t1"] - p["t0"],
                       "tokens_per_sec": load.rate(p["t0"], p["t1"]),
                       "vs_steady": load.rate(p["t0"], p["t1"]) / steady,
                       "replicas": p["replicas"]} for p in rolls],
            "prefix_before": _hit_rate(pre0, pre1),
            # from the second deploy (each swap clears a replica's trie)
            # to the end of the after-window
            "prefix_across_rollback": _hit_rate(pre1, post1),
            "prefix_after": _hit_rate(post0, post1)}

        # 4. idle: scale down to the floor
        down = _until(lambda: next((d for d in controller.report()[
            "decisions"] if d["action"] == "scale_down"), None),
            30, "controller_scale_down")
        rec["scale_down"] = {"decision": down, "capacity": router.capacity,
                             "states": [r.state.value
                                        for r in router.replicas]}
        controller.stop()
        collector.stop()
        torch.cuda.synchronize()
        rec["launches_control_path"] = paged_attend.launches
        rec["decode_calls"] = [b["calls"] for b in boxes]
        rec["engines_built"] = len(engines)
        rec["kernel_launches"] = [
            e._programs.kernel_launches - launches0.get(i, 0)
            for i, e in enumerate(engines)]
        rec["warm_run_launches"] = (paged_attend.launches
                                    - sum(rec["kernel_launches"]))
        rec["compile_counts_flat"] = [
            e.compile_counts_detailed() == counts.get(i)
            and not e.recompiles
            for i, e in enumerate(engines)]
        rec["controller"] = {k: controller.report()[k] for k in (
            "versions", "decisions", "autoscale")}
        rec["health"] = router.fleet_report()["health"]
        rec["slo"] = slo.last
        rec["requests"] = {"burst": len(burst), "wave": len(wave),
                           "load": load.done}
        lost = [fr.id for fr in burst + wave
                if fr.error is not None or len(fr.tokens)
                != fr.max_new_tokens] + load.failed
        rec["lost"] = lost
    except BaseException:
        from chainermn_torch.monitor import get_event_log

        keep = ("controller_", "canary_", "fleet_replica", "fleet_spawn",
                "fleet_retire", "fleet_publish", "publish", "engine_restart",
                "health_changed", "detector_fired", "slo_breach")
        rec["failure_state"] = {
            "decisions": (controller.report()["decisions"]
                          if controller is not None else None),
            "replicas": [(r.replica_id, r.state.value, r.restarts,
                          r.scheduler.queue_depth) for r in router.replicas],
            "events": [e for e in get_event_log().tail(1024)
                       if e["kind"].startswith(keep)][-60:]}
        raise
    finally:
        if load is not None:
            load.stop(FLEET_WAIT_S)
        for part in (controller, collector):
            if part is not None:
                part.stop()
        router.close()
        for undo in undos:
            undo()
    pub_stats = {}
    for p in pubs:
        for r, out in p["replicas"].items():
            if out.get("ok"):
                ent = pub_stats.setdefault(r, {"commit_s": [], "fence_s": []})
                ent["commit_s"].append(out["commit_s"])
                ent["fence_s"].append(out["fence_s"])
    rec["publish"] = {
        r: {"swaps": len(v["commit_s"]),
            "commit_s_p50": _p(v["commit_s"], 50),
            "commit_s_p99": _p(v["commit_s"], 99),
            "fence_s_p50": _p(v["fence_s"], 50),
            "fence_s_p99": _p(v["fence_s"], 99)}
        for r, v in sorted(pub_stats.items())}
    rec["canary_start_to_promote_s"] = promote.get("baked_s")
    # what one pre-canary copy costs: the controller's clone of a
    # replica's state_dict, on the card (the router is closed)
    state = engines[0].model.state_dict()
    rec["rollback"]["copy_ms"] = cuda_ms(
        lambda: fleet_control._private_copy(state), reps=5)
    rec["rollback"]["copy_bytes"] = sum(
        t.numel() * t.element_size() for t in state.values())


def _check_control(rec):
    bad = []
    if rec["wave_served_by"][1] < 1:
        bad.append(f"the spawned replica served none of the wave: "
                   f"{rec['wave_served_by']}")
    if rec["promote"]["outcome"]["action"] != "canary_promote" or len(
            set(rec["promote"]["weight_versions"])) != 1:
        bad.append(f"the first deploy did not promote onto one version: "
                   f"{rec['promote']}")
    if rec["rollback"]["outcome"]["action"] != "canary_rollback":
        bad.append(f"the planted regression did not roll back: "
                   f"{rec['rollback']['outcome']}")
    if rec["scale_down"]["capacity"] != 1:
        bad.append(f"idle did not scale down to 1: {rec['scale_down']}")
    acts = [d["action"] for d in rec["controller"]["decisions"]]
    if rec["engines_built"] != 2 or acts.count("scale_up") != 1 \
            or acts.count("scale_down") != 1:
        bad.append(f"one scale-up and one scale-down expected: {acts}")
    if not all(rec["compile_counts_flat"]):
        bad.append(f"programs rebuilt: {rec['compile_counts_flat']}")
    if rec["lost"]:
        bad.append(f"requests lost: {rec['lost']}")
    for calls, n in zip(rec["decode_calls"], rec["kernel_launches"]):
        if n != calls * LM["n_layers"] or not calls:
            bad.append(f"{n} kernel launches on {calls} decode calls x "
                       f"{LM['n_layers']} layers")
    f32 = rec["f32"]
    for name, p in f32["honest"].items():
        if p["failures"]:
            bad.append(f"f32 rollback stream of replica {name} diverges "
                       f"from the pre-canary weights: {p['failures']}")
    for name, p in f32["planted_alias"].items():
        if len(p["failures"]) != p["requests"]:
            bad.append(f"the planted alias failed {len(p['failures'])} of "
                       f"{p['requests']} on replica {name}")
    if bad:
        raise AssertionError("serve_control: " + "; ".join(bad))


def _control_f32(device):
    """The f32 LM at full width, two replicas under a controller ticked by
    hand: a deploy promoted (the pre-canary weights v1), then a canary
    forced critical and rolled back; every replica's 8 greedy streams
    against a solo engine on v1. Then the same rollback with the
    controller's pre-canary copy planted as a reference (the alias the
    port must not keep): every replica must fail 8/8."""
    import torch

    from chainermn_torch.fleet import CanaryPolicy, FleetController, FleetRouter
    from chainermn_torch.fleet import control as fleet_control
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import ThresholdDetector, fleet_health
    from chainermn_torch.serving import ServingEngine

    kw = dict(ENGINE, paged_kernel=True)
    models = [TransformerLM(**LM, compute_dtype=torch.float32, device=device,
                            seed=SEED) for _ in range(3)]
    engines = [ServingEngine(m, device=device, **kw) for m in models]
    work = _serve_traffic(PARITY_REQUESTS, SEED + 80)
    v1 = _bumped(models[0].state_dict(), 0.01, pinned=False)
    solo_model = models[2]
    with torch.no_grad():
        for k, t in solo_model.state_dict().items():
            t.copy_(v1[k])
    engines[2].warmup()
    want, _, _ = _drive(engines[2], work)
    out = {"requests": len(work)}
    router = FleetRouter(engines[:2])
    try:
        if not router.wait_ready(FLEET_WAIT_S):
            raise AssertionError("serve_control f32: replicas did not warm")
        col = fleet_health(router, stall_timeout_s=60.0)
        ctrl = FleetController(router, col, canary=CanaryPolicy(bake_s=1.0))
        now = [1.0]

        def tick(dt=0.5):
            now[0] += dt
            col.tick(now=now[0])
            return ctrl.tick(now=now[0])

        def cycle(params, planted):
            ctrl.deploy(params)
            rid = tick()["actions"][0]["replica"]
            if planted is None:
                acts = tick(1.5)["actions"]
            else:
                col.health.add_detectors(str(rid), ThresholdDetector(
                    f"{planted}@{rid}", planted, 0.5, severity="critical"))
                col.store.append(planted, now[0] + 0.1, 1.0)
                acts = tick()["actions"]
                col.store.append(planted, now[0] + 0.1, 0.0)
                tick()
            return [a["action"] for a in acts]

        def streams(replica):
            reqs = [replica.submit(p, n) for p, n in work]
            for r in reqs:
                if not r.wait(FLEET_WAIT_S):
                    raise AssertionError("serve_control f32: request hung")
            return [[int(t) for t in r.tokens] for r in reqs]

        out["promote"] = cycle(v1, None)
        v2 = _bumped(v1, 0.01, pinned=False)
        out["rollback"] = cycle(v2, "f32_regression")
        out["honest"] = {str(r.replica_id): _parity(
            solo_model, work, streams(r), want) for r in router.replicas}
        real = fleet_control._private_copy
        fleet_control._private_copy = dict
        try:
            out["planted_rollback"] = cycle(v2, "f32_planted")
        finally:
            fleet_control._private_copy = real
        out["planted_alias"] = {str(r.replica_id): _parity(
            solo_model, work, streams(r), want) for r in router.replicas}
        out["recompiles"] = [e.recompiles for e in engines]
        out["versions"] = [h["source"] for h in
                           ctrl.report()["versions"]["history"]]
    finally:
        router.close()
    del engines, models, solo_model
    _empty()
    if out["promote"] != ["canary_promote"] or out["rollback"] != [
            "canary_rollback"] or out["planted_rollback"] != [
            "canary_rollback"]:
        raise AssertionError(f"serve_control f32: the canary path went "
                             f"wrong: {out}")
    return out


def phase_serve_example(card):
    """The ``serve_lm.py`` twin's ``main()`` in this process on the card,
    at its defaults and with the paged store, n-gram speculation, chunked
    prefill, three tenants of mixed classes, brownout up to L2 and
    ``--verify-parity``, serving the scrape endpoints and printing the
    Prometheus exposition; then ``train_lm.py --serve-samples`` (the dense
    engine with the prefix store after three training steps). Fails
    unless each twin run prints its done line and serves every request,
    the parity check passes, and the scraping run read its own ``/costs``
    with the three tenants and a conserving ledger, and printed each
    tenant's ``tenant_device_seconds_total`` and
    ``serving_decode_steps_total``."""
    import contextlib
    import io

    from chainermn_torch.examples.lm import serve_lm, train_lm

    out = {}
    for name, extra in SERVE_EXAMPLE.items():
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = serve_lm.main(extra)
        printed = buf.getvalue()
        done = [ln for ln in printed.splitlines()
                if "requests served in" in ln]
        out[name] = {"done_line": done[0] if done else None,
                     "served": res["served"], "requests": res["requests"],
                     "compute_dtype": res["compute_dtype"],
                     "tokens_per_sec": res["report"]["tokens_per_sec"],
                     "spec": res["spec"], "parity": res.get("parity"),
                     "brownout": res.get("brownout"),
                     "run_s": time.perf_counter() - t0}
        if "--http-port" in extra:
            scraped = res["http"]["costs"]
            text = res["exposition"]
            out[name]["scraped_costs"] = {
                "tenants": sorted(scraped["tenants"]),
                "device_time": scraped["device_time"],
                "goodput": scraped["goodput"]}
            lines = text.splitlines()
            out[name]["exposition_lines"] = len(lines)
            out[name]["exposition_has"] = dict(
                printed=text in printed,
                serving_decode_steps_total=any(
                    ln.startswith("serving_decode_steps_total")
                    for ln in lines),
                **{f"tenant{j}": any(
                    ln.startswith("tenant_device_seconds_total{")
                    and f'tenant="tenant{j}"' in ln for ln in lines)
                   for j in range(3)})
    t0 = time.perf_counter()
    res = train_lm.main(["--iterations", "3", "--serve-samples", "4"])
    out["train_lm_serve_samples"] = {
        "losses": res["losses"],
        "samples": len(res["serve_samples"]["samples"]),
        "prefix": res["serve_samples"]["prefix"],
        "run_s": time.perf_counter() - t0}
    emit({"phase": "serve_example", "card": card, "modes": SERVE_EXAMPLE,
          "out": out})
    for name, rec in out.items():
        if name == "train_lm_serve_samples":
            if rec["samples"] != 4:
                raise AssertionError(f"serve_example: {rec}")
            continue
        if rec["done_line"] is None or rec["served"] != rec["requests"]:
            raise AssertionError(f"serve_example {name}: {rec}")
        scraped = rec.get("scraped_costs")
        if scraped is not None and not (
                {"tenant0", "tenant1", "tenant2"} <= set(scraped["tenants"])
                and scraped["device_time"]["conservation_error"] < 1e-6
                and all(rec["exposition_has"].values())):
            raise AssertionError(f"serve_example {name}: the scrape or the "
                                 f"exposition: {rec}")
    return out


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
        return torch.randn(shape, generator=gen, device=gen.device).to(
            device=device, dtype=dtype)

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


# the FLASH_CASES run at head dims the wrapper pads (8, 32, 96 and 192)
FLASH_PAD_CASES = ("square_causal", "ragged_full", "rect_causal",
                   "offset_k300")
FLASH_HEAD_DIMS = (64, 128, 256)   # the one-tile kernels' own widths
FLASH_PAD_DIMS = (8, 32, 96, 192)
# past 256 (256-column slices of the output; the 16-bit forward, dq and
# dk/dv and the f32 dq and dk/dv as clusters of the slices up to D =
# 2048), each width at a few
# FLASH_CASES only: D = 512, the wide LM's, at three (the blind rows of
# offset_k300 among them), 320 and 1024 (a cluster of 4) at one each, 257
# (padded to 320) and 384 (a slice of 128 columns beside a whole one) at
# one each, 2048 (a cluster of 8, the portable cluster size) at one, and
# 2112 (9 slices: past the portable cluster size, the unclustered route)
# at one
FLASH_WIDE_CASES = {512: ("square_causal", "ragged_full", "offset_k300"),
                    320: ("rect_causal",), 1024: ("square_causal",),
                    257: ("offset_k300",), 384: ("ragged_full",),
                    2048: ("square_causal",), 2112: ("square_causal",)}


def phase_flash_parity(device):
    """Each flash kernel against its plain version on the card: B=2,
    H=16, D in FLASH_HEAD_DIMS with the FLASH_CASES shapes (ragged tails,
    Tq != Tk, offsets, a sequence below one tile), D in FLASH_PAD_DIMS
    with the FLASH_PAD_CASES and the widths past 256 with their
    FLASH_WIDE_CASES, bf16, f32 and f16 each; then one case with
    B * H past 65535 (B = 4375, H = 16, T = 8, bf16, causal). Inputs are
    drawn on the card. The backward
    kernels take the plain forward's lse and delta, so each kernel sees
    its plain version's inputs; gradients come back in the input dtype, as
    in training. Rows that see no key must hold out == 0 and lse == -1e30,
    and their dq and the unseen keys' dk and dv must be 0, exactly. A
    planted fault must fail: the D = 512 bf16 ``square_causal`` kernels
    against the plain versions on K with its columns past the first 256
    zeroed (scores reduced over one slice's columns only): each of out,
    dq, dk and dv must fail its tolerance; the D = 64 f32
    ``square_causal`` kernels against the plain versions on K with its
    last 64 keys zeroed: out, lse, dq and dk must fail ``TOL["f32"]``;
    and the D = 512 f32 ones on K with its columns past 256 zeroed: every
    output must fail it."""
    import torch

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32,
              "f16": torch.float16}
    grid_case = ("grid_bh", 8, 8, True, 0, 0)
    results = []
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    padded = [c for c in FLASH_CASES if c[0] in FLASH_PAD_CASES]
    # (B, D, dtypes, cases)
    groups = ([(2, d, dtypes, FLASH_CASES) for d in FLASH_HEAD_DIMS]
              + [(2, d, dtypes, padded) for d in FLASH_PAD_DIMS]
              + [(2, d, dtypes, [c for c in FLASH_CASES if c[0] in names])
                 for d, names in FLASH_WIDE_CASES.items()]
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
    planted = _flash_planted_fault(fa, gen, device)
    planted_f32 = _flash_planted_fault_f32(fa, gen, device)
    planted_f32_wide = _flash_planted_fault_f32(fa, gen, device, d=512)
    emit({"phase": "flash_parity", "H": 16, "tol": TOL,
          "shapes": {c[0]: c[1:] for c in FLASH_CASES + [grid_case]},
          "shape_fields": ["Tq", "Tk", "causal", "q_offset", "k_offset"],
          "cases": results, "planted_fault": planted,
          "planted_fault_f32": planted_f32,
          "planted_fault_f32_wide": planted_f32_wide})
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions: {bad}")
    if planted["ok"] or planted["passed"]:
        raise AssertionError(f"flash_parity: the planted fault passes: "
                             f"{planted}")
    if {"out", "lse", "dq", "dk"} & set(planted_f32["passed"]):
        raise AssertionError(f"flash_parity: the f32 planted fault passes: "
                             f"{planted_f32}")
    if planted_f32_wide["passed"]:
        raise AssertionError(f"flash_parity: the D = 512 f32 planted fault "
                             f"passes: {planted_f32_wide}")
    return worst


def _flash_planted_fault(fa, gen, device):
    """The D = 512 bf16 ``square_causal`` kernels against the plain
    versions on K with columns 256.. zeroed; ``ok`` is the parity gate's
    verdict (every output inside the tolerance), which must be False, and
    ``passed`` the outputs inside it, which must be none."""
    import torch

    _, tq, tk, causal, qo, ko = FLASH_CASES[0]
    q, k, v, do = _flash_inputs(2, tq, tk, 16, 512, torch.bfloat16, gen,
                                device)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    gkw = dict(kw, grad_dtype=torch.bfloat16)
    cut = k.clone()
    cut[..., 256:] = 0
    out, _ = fa.flash_fwd_with_lse(q, k, v, **kw)
    r_out, r_lse = fa.flash_fwd_reference(q, cut, v, **kw)
    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    got = {"out": out, "dq": fa.flash_dq(q, k, v, do, r_lse, delta, **gkw)}
    got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, r_lse, delta, **gkw)
    want = {"out": r_out,
            "dq": fa.flash_dq_reference(q, cut, v, do, r_lse, delta, **gkw)}
    want["dk"], want["dv"] = fa.flash_dkv_reference(q, cut, v, do, r_lse,
                                                    delta, **gkw)
    rtol, atol = TOL["bf16"]
    checks = {n: _compare(got[n], want[n], rtol, atol) for n in got}
    return {"D": 512, "dtype": "bf16", "case": FLASH_CASES[0][0],
            "fault": "K columns 256.. zeroed in the plain versions",
            "err": {n: c[0] for n, c in checks.items()},
            "passed": [n for n, c in checks.items() if c[1]],
            "ok": all(c[1] for c in checks.values())}


def _flash_planted_fault_f32(fa, gen, device, d=64):
    """The f32 kernels, ``square_causal``, against the plain versions on a
    cut K: at D = 64 its last 64 keys zeroed, at D = 512 (the wide
    kernels) its columns past the first 256 zeroed (scores reduced over
    one slice's columns only). The backward kernels take lse and delta
    from the plain forward on the cut K. ``passed`` lists the outputs
    inside ``TOL["f32"]``: at D = 64 it must hold none of out, lse, dq and
    dk, at D = 512 nothing."""
    import torch

    _, tq, tk, causal, qo, ko = FLASH_CASES[0]
    q, k, v, do = _flash_inputs(2, tq, tk, 16, d, torch.float32, gen,
                                device)
    kw = dict(causal=causal, q_offset=qo, k_offset=ko)
    gkw = dict(kw, grad_dtype=torch.float32)
    cut = k.clone()
    if d > 256:
        cut[..., 256:] = 0
        fault = "K columns 256.. zeroed in the plain versions"
    else:
        cut[:, -64:] = 0
        fault = "the last 64 keys of K zeroed in the plain versions"
    r_out, r_lse = fa.flash_fwd_reference(q, cut, v, **kw)
    delta = (do.float() * r_out.float()).sum(-1).transpose(1, 2).contiguous()
    got = dict(zip(("out", "lse"), fa.flash_fwd_with_lse(q, k, v, **kw)))
    got["dq"] = fa.flash_dq(q, k, v, do, r_lse, delta, **gkw)
    got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, r_lse, delta, **gkw)
    want = {"out": r_out, "lse": r_lse,
            "dq": fa.flash_dq_reference(q, cut, v, do, r_lse, delta, **gkw)}
    want["dk"], want["dv"] = fa.flash_dkv_reference(q, cut, v, do, r_lse,
                                                    delta, **gkw)
    rtol, atol = TOL["f32"]
    checks = {n: _compare(got[n], want[n], rtol, atol) for n in got}
    return {"D": d, "dtype": "f32", "case": FLASH_CASES[0][0],
            "fault": fault, "err": {n: c[0] for n, c in checks.items()},
            "passed": [n for n, c in checks.items() if c[1]]}


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

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
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
        monitor,
    )
    from chainermn_torch.models import TransformerLM
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
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
    steps_ctr = monitor.get_registry().counter(
        "steps_total", {"step": "lm_train_step"})
    steps0 = steps_ctr.value
    tail = monitor.get_event_log().tail(1)
    seq0 = tail[-1]["i"] if tail else -1
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
    monitored = _monitored_step_check(device, step, steps_ctr.value - steps0,
                                      seq0, n_steps)
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
           "steps": n_steps, "launches": launches, "stats": stats,
           "monitored": dict(monitored, host_us_share_of_step=(
               monitored["host_us_per_step"] / 1e3 / (step_s * 1e3)))}
    emit(rec)
    if monitored["failures"]:
        raise AssertionError(f"train: the monitored step: "
                             f"{monitored['failures']}")
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


def _monitored_step_check(device, step, counted, seq0, n_steps):
    """What the monitored train step left in the telemetry: the
    ``steps_total{step="lm_train_step"}`` rise (``counted``, exactly the
    steps run), its ``step_start``/``step_end`` events since sequence
    ``seq0``, the CUDA memory gauge against the allocator at that point,
    the event dump's memory line for device 0, and the wrapper's own host
    microseconds a call (an instrumented no-op against the bare one,
    10,000 calls each)."""
    import io

    import torch

    from chainermn_torch import monitor
    from chainermn_torch.monitor.registry import MetricsRegistry

    failures = []
    if not isinstance(step, monitor.MonitoredFunction):
        failures.append(f"lm_train_step returned {type(step).__name__}")
    if counted != n_steps:
        failures.append(f"steps_total rose {counted}, not {n_steps}")
    evs = [e for e in monitor.get_event_log().tail() if e["i"] > seq0
           and e.get("step") == "lm_train_step"]
    starts = sum(e["kind"] == "step_start" for e in evs)
    ends = sum(e["kind"] == "step_end" for e in evs)
    if (starts, ends) != (n_steps, n_steps):
        failures.append(f"step_start/step_end events {starts}/{ends}")
    reg = monitor.get_registry()
    torch.cuda.synchronize(device)
    monitor.record_memory_gauges(reg)
    want = torch.cuda.memory_stats(device)["allocated_bytes.all.current"]
    gauge = reg.gauge("device_bytes_in_use", {"device": "0"}).value
    if gauge != want:
        failures.append(f"device_bytes_in_use {gauge} != allocator {want}")
    buf = io.StringIO()
    monitor.get_event_log().dump(file=buf, last=4, memory=True)
    mem_lines = [ln.strip() for ln in buf.getvalue().splitlines()
                 if ln.strip().startswith("device 0 (")]
    if not mem_lines:
        failures.append("the event dump has no memory line for device 0")
    n = 10000

    def noop():
        return None

    wrapped = monitor.instrument(noop, "probe", registry=MetricsRegistry(),
                                 events=monitor.EventLog(),
                                 memory_interval=0)
    t0 = time.perf_counter()
    for _ in range(n):
        noop()
    bare = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        wrapped()
    host_us = (time.perf_counter() - t0 - bare) / n * 1e6
    return {"steps_total_rise": counted, "step_events": [starts, ends],
            "device_bytes_in_use": gauge, "allocator_bytes": want,
            "memory_line": mem_lines[0] if mem_lines else None,
            "host_us_per_step": host_us, "failures": failures}


def phase_train_profile(step, tokens, targets, n_steps):
    """Where a train step's time goes (:func:`_train_step_profile`), with
    the monitored step's annotations in the trace."""
    rec = dict(phase="train_profile",
               **_train_step_profile(step, tokens, targets, n_steps))
    emit(rec)
    want = {"chainermn.step.lm_train_step", "chainermn.lm_train_step"}
    if not want <= set(rec["annotations"]):
        raise AssertionError(f"train_profile: the trace lacks "
                             f"{sorted(want - set(rec['annotations']))}")
    return rec


def _train_step_profile(step, tokens, targets, n_steps):
    """``torch.profiler`` over ``n_steps`` train steps. Device busy time
    is the sum of CUDA activity in the window, without user annotations
    (the optimizer's ``Optimizer.step#AdamW.step`` range spans kernels
    already counted); idle share is what is left of the host wall
    clock."""
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
    return {"steps": n_steps, "step_wall_ms": wall / n_steps * 1e3,
            "step_device_busy_ms": busy_us / n_steps / 1e3 if measured
            else "not measured",
            "device_idle_share": 1 - busy_us / 1e6 / wall if measured
            else "not measured",
            "flash_ms_per_step": {n: us / n_steps / 1e3
                                  for n, us in flash_us.items()},
            "flash_share_of_busy": (sum(flash_us.values()) / busy_us
                                    if measured else "not measured"),
            "annotations": _annotations(prof),
            "top_device": [{"name": e.key[:70], "ms_per_step":
                            e.self_device_time_total / n_steps / 1e3,
                            "calls_per_step": e.count / n_steps}
                           for e in top]}


def _launched_kernels(calls):
    """What one call of each flash wrapper in ``calls`` (``{name: call}``)
    ran on the card: ``{name: (kernel, cluster_size)}``, the kernel's name
    in a ``torch.profiler`` trace (matched by its FLASH_KERNELS prefix;
    each call runs inside a ``record_function`` range, and a call whose
    kernel the trace missed runs again in a new trace, up to three, and
    is "not measured" if they all miss it) and the thread-block cluster
    size the library launched it with (``flash_last_cluster``: 1 for
    none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
    lib = fa.build_library()
    found, clusters = {}, {}
    for _ in range(3):
        todo = [n for n in calls if n not in found]
        if not todo:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.empty(1, device="cuda").zero_()
            torch.cuda.synchronize()
            for name in todo:
                with record_function(f"chip_smoke.{name}"):
                    calls[name]()
                clusters[name] = int(lib.flash_last_cluster())
                torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        for name in todo:
            hit = sorted({m for k in keys for m in
                          re.findall(FLASH_KERNELS[name][1] + r"\w*", k)})
            if hit:
                found[name] = ",".join(hit)
    return {n: (found.get(n, "not measured"), clusters[n]) for n in calls}


def _flash_rows(b, t, h, d, gen, device, flush, dname="bf16", reps=50,
                plain_reps=5):
    """The three flash kernels, their plain versions and the library
    yardstick at one causal shape in dtype ``dname`` (q, k and v sliced
    from one fused qkv tensor), as :func:`phase_flash_timing` describes:
    ``reps`` timed calls a kernel, ``plain_reps`` of each plain version
    (0: not timed). Returns ``{name: record}``; the launches are counted
    here and the caller restores them."""
    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

    dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
             "f32": torch.float32}[dname]
    q, k, v, do = _flash_inputs(b, t, t, h, d, dtype, gen, device,
                                fused=True)
    kw = dict(causal=True)
    gkw = dict(kw, grad_dtype=dtype)
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
    elem, rows, size = b * t * h * d, b * h * t, q.element_size()
    work = {"flash_fwd": (4 * elem * size + rows * 4, 4 * d * pairs),
            "flash_dq": (5 * elem * size + 2 * rows * 4, 6 * d * pairs),
            "flash_dkv": (6 * elem * size + 2 * rows * 4, 8 * d * pairs)}
    # f32 runs on the FMA units, not the tensor cores
    ops_per_s = F32_OPS_PER_S if dname == "f32" else BF16_OPS_PER_S

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
    backend = _sdpa_backend(qt, kt, vt, is_causal=True)
    library = {"flash_fwd": cuda_ms(lib_fwd, reps=reps, flush=flush)}
    library["flash_dq"] = library["flash_dkv"] = cuda_ms(lib_bwd, reps=reps,
                                                         flush=flush)
    del lib_out, qt, kt, vt
    rtol, atol = TOL[dname]
    launched = _launched_kernels({n: kern for n, (kern, _) in calls.items()})
    recs = {}
    for name, (kern, plain) in calls.items():
        got, again, want = kern(), kern(), plain()
        got, again, want = (x if isinstance(x, tuple) else (x,)
                            for x in (got, again, want))
        checks = [_compare(g, w, rtol, atol) for g, w in zip(got, want)]
        same = all(torch.equal(g, x) for g, x in zip(got, again))
        del got, again, want
        kernel_ms = cuda_ms(kern, reps=reps, flush=flush)
        plain_ms = (cuda_ms(plain, reps=plain_reps, flush=flush)
                    if plain_reps else None)
        n_bytes, n_ops = work[name]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / ops_per_s * 1e3
        recs[name] = {"max_abs_err": max(c[0] for c in checks),
                      "within_tol": all(c[1] for c in checks),
                      "deterministic": same, "ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library[name],
                      "library_max_abs_err": lib_err,
                      "library_backend": backend,
                      "bytes": n_bytes, "ops": n_ops,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations",
                      "tflops": n_ops / kernel_ms / 1e9, "dtype": dname,
                      "kernel": launched[name][0],
                      "cluster_size": launched[name][1], "reps": reps}
        torch.cuda.empty_cache()
    return recs


# flash_timing's rows beside the main shape's: H = 4, D = 256 and H = 2,
# D = 512 in bf16, the main shape in float16 and float32, and float32 at
# H = 2, D = 512 and H = 1, D = 1024
FLASH_TIMING_TAGS = ("d256", "d512", "f16", "f32", "f32_d512", "f32_d1024")
# the cluster size each f32 row's dq and dk/dv must launch with (the f32
# forward never clusters)
FLASH_F32_CLUSTER = {"f32": 1, "f32_d512": 2, "f32_d1024": 4}


def phase_flash_timing(device):
    """Each flash kernel, its plain version and a library yardstick at the
    training shape (B=8, T=2048, H=16, D=64, bf16, causal; q, k and v
    sliced from one fused qkv tensor as the model passes them), L2
    flushed before each timed call; then the same at H=4, D=256 and H=2,
    D=512 (the ``lm_d256`` and ``lm_wide`` shapes: the same FLOPs and
    bytes), at the training shape in float16 and float32 and in float32
    at H=2, D=512 and H=1, D=1024 (20 calls each, the plain versions not
    timed, SDPA in the same dtype; the f32 bound at 67 TFLOP/s, the FMA
    units' peak) and at D=8 (padded to 64). Each row names the kernel one
    profiled call ran and the cluster size the library launched it with;
    the D=512 forward, dq and dk/dv must have run as clusters
    (``*_cluster_sm90``, 2 CTAs), and the f32 rows as
    ``FLASH_F32_KERNELS`` names them where the trace names a kernel
    (``flash_fwd_f32_sm90``, ``flash_dq_f32_sm90``,
    ``flash_dkv_f32_sm90`` at D=64, unclustered; past 256 the
    unclustered ``flash_fwd_wide_f32_sm90`` and the clusters
    ``flash_dq_cluster_f32_sm90`` and ``flash_dkv_cluster_f32_sm90``, of
    2 CTAs at D=512 and 4 at D=1024: ``FLASH_F32_CLUSTER``). Each
    kernel's outputs must agree with its plain version's within its
    dtype's tolerance, so the strided reads of the training path are held
    to a limit. The yardstick, which the port never calls, is
    ``F.scaled_dot_product_attention(is_causal=True)`` forward, and its
    backward as one number for dq, dk and dv together. The bound is the
    larger of the causal FLOPs this run needs (visible (q, k) pairs x 4 D
    for fwd, 6 D for dq, 8 D for dk/dv) at 989 TFLOP/s and each input
    read once plus each output written once at 3.35 TB/s. Each kernel runs
    twice on the same inputs and must give bitwise-equal outputs: no
    atomics, so the results are deterministic."""
    import torch

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

    b, t = TRAIN["batch"], TRAIN["seq_len"]
    h, d = LM["n_heads"], LM["d_model"] // LM["n_heads"]
    gen = torch.Generator().manual_seed(SEED + 5)
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=device)
    flush = scratch.zero_
    saved = {fn: getattr(fa, fn).launches for fn, *_
             in FLASH_KERNELS.values()}
    recs = _flash_rows(b, t, h, d, gen, device, flush)
    for tag, cfg in (("d256", LM_D256), ("d512", LM_D512)):
        hh = cfg["n_heads"]
        rows = _flash_rows(b, t, hh, cfg["d_model"] // hh, gen, device, flush)
        for name, rec in rows.items():
            recs[name][tag] = dict(rec, H=hh, D=cfg["d_model"] // hh)
    # the main shape in float16 and float32 (the f32 forward, dq and dk/dv
    # the register-tiled kernels of flash_f32_sm90.cuh), each beside SDPA
    # in its dtype, and float32 at the lm_wide shape (H = 2, D = 512) and
    # at H = 1, D = 1024 (the f32 forward's register tiles on 256-column
    # slices, dq and dk/dv clusters of 2 and 4 such slices)
    hw = LM_D512["n_heads"]
    for tag, dname, hh in (("f16", "f16", h), ("f32", "f32", h),
                           ("f32_d512", "f32", hw), ("f32_d1024", "f32", 1)):
        dd = LM["d_model"] // hh
        rows = _flash_rows(b, t, hh, dd, gen, device, flush, dname=dname,
                           reps=20, plain_reps=0)
        for name, rec in rows.items():
            recs[name][tag] = dict(rec, H=hh, D=dd)
    # the same shape at D = 8 (the repo's small LM configurations), which
    # the wrapper runs padded to 64
    q, k, v, do = _flash_inputs(b, t, t, h, 8, torch.bfloat16, gen, device,
                                fused=True)
    kw = dict(causal=True)
    gkw = dict(kw, grad_dtype=torch.bfloat16)
    out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    small = {"flash_fwd": lambda: fa.flash_fwd_with_lse(q, k, v, **kw),
             "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, **gkw),
             "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta,
                                               **gkw)}
    for name, kern in small.items():
        recs[name]["ms_D8"] = cuda_ms(kern, flush=flush)
    for fn, n in saved.items():
        getattr(fa, fn).launches = n
    emit({"phase": "flash_timing", "B": b, "T": t, "H": h, "D": d,
          "dtype": "bf16", "causal": True, "tol": TOL["bf16"],
          "library_call": "F.scaled_dot_product_attention(is_causal=True); "
                          "dq and dkv rows share its backward (dq, dk, dv)",
          "kernels": recs})
    rows = [(n, r) for n, r in recs.items()] + [
        (f"{n} {tag}", r[tag]) for n, r in recs.items()
        for tag in FLASH_TIMING_TAGS]
    bad = [n for n, r in rows if not r["within_tol"]]
    if bad:
        raise AssertionError(f"flash kernels {bad} disagree with their plain "
                             f"versions at the training shape")
    bad = [n for n, r in rows if not r["deterministic"]]
    if bad:
        raise AssertionError(f"flash kernels {bad} gave different outputs "
                             f"for the same inputs")
    # the wide kernels run as clusters of the 256-column slices (the
    # trace's kernel name, where it has one, must say so too)
    bad = [n for n in ("flash_fwd", "flash_dq", "flash_dkv")
           if recs[n]["d512"]["cluster_size"] < 2
           or recs[n]["d512"]["kernel"] != "not measured"
           and "cluster" not in recs[n]["d512"]["kernel"]]
    if bad:
        raise AssertionError(f"flash kernels {bad} at D = 512 launched "
                             f"without a cluster")
    # f32 runs its own kernels (FLASH_F32_KERNELS) wherever the trace
    # names one: the register-tiled forward, dq and dk/dv at D = 64,
    # unclustered; at D = 512 and 1024 the unclustered wide forward and
    # the dq and dk/dv clusters of FLASH_F32_CLUSTER's sizes
    bad = [f"{n} {tag}" for n, names in FLASH_F32_KERNELS.items()
           for tag, want in (("f32", names[0]), ("f32_d512", names[1]),
                             ("f32_d1024", names[1]))
           if recs[n][tag]["cluster_size"] != (
               1 if n == "flash_fwd" else FLASH_F32_CLUSTER[tag])
           or recs[n][tag]["kernel"] != "not measured"
           and want not in recs[n][tag]["kernel"].split(",")]
    if bad:
        raise AssertionError(f"f32 flash rows {bad} did not run "
                             f"{FLASH_F32_KERNELS}")
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


LM_WIDE_REQUESTS = 16
LM_WIDE_STEPS = dict(warmup=1, timed=3)
# lm_d256 serves and trains its LM at 4 of the 12 layers (its D = 256
# coverage stays whole in parity, flash_parity and the timing rows): the
# cut that pays for lm_wide
LM_D256_RUN = dict(LM_D256, n_layers=4)
LM_D256_TWIN = dict(LM_D256, n_layers=2)        # the f32 serving twins
LM_D512_TWIN = dict(LM_D512, n_layers=2)
LM_D256_PARITY = dict(vocab_size=1000, d_model=1024, n_heads=4, n_layers=2,
                      max_len=256, batch=4, seq_len=256, tol=1e-4)
LM_D512_PARITY = dict(LM_D256_PARITY, n_heads=2)
# the float16 serve: the serve LM at compute_dtype=float16, and its
# 2-layer twin for the kernel-against-plain streams
SERVE_F16_TWIN = dict(LM, n_layers=2)
# float16 logits carry 11 bits: a top-2 gap of a few ulps at the LM's
# logit scale (|x| < 8: ulp <= 2**-8) is a tie the two read paths may
# break either way
NEAR_TIE_F16 = 2e-2


def phase_lm_d256(device, card, comm):
    """The slice's paths at head dim 256: ``LM_D256`` (the 220M LM at 4
    heads, ``d_head = d_model // n_heads`` = 256, the same parameters),
    run by :func:`_lm_wide` at 4 of its 12 layers (``LM_D256_RUN``)."""
    return _lm_wide("lm_d256", LM_D256_RUN, LM_D256_TWIN, LM_D256_PARITY,
                    device, card, comm)


def phase_lm_wide(device, card, comm):
    """The slice's last input ranges at full width: ``LM_D512`` (the 220M
    LM at 2 heads of 512, the same parameters), run by :func:`_lm_wide` at
    all 12 layers; then the serve LM at ``compute_dtype=float16``
    (:func:`_serve_f16`)."""
    return _lm_wide("lm_wide", LM_D512, LM_D512_TWIN, LM_D512_PARITY,
                    device, card, comm, extra=_serve_f16)


def _lm_wide(name, cfg, twin, parity_cfg, device, card, comm, extra=None):
    """One LM ``cfg`` at a wide head dim, ``d_head = d_model // n_heads``:

    - serve: the captured paged ``ServingEngine`` (``ENGINE``'s settings,
      greedy) under ``FCFSScheduler`` answers 16 of ``_serve_traffic``'s
      requests; every decode step's attention runs B4 (launches = decode
      steps x layers, a replay counted), then 10 decode steps are
      profiled for the device's idle share. Its f32 ``twin`` streams 8
      requests through the kernel engine and the plain engine: equal up
      to a recorded near-tie.
    - train: ``attention='flash'``, ``lm_train_step``, AdamW, 1 warm-up and
      3 timed steps at [8, 2048] (B1-B3 at the head dim, a launch a layer
      a step each); the loss must fall; then one step profiled for its
      device time by kernel. Then ``parity_cfg`` (f32, the f32
      kernels) takes one SGD step at lr 1 with ``'flash'`` and with
      ``'full'`` from one seed: the loss and every gradient (the step's
      parameter change) agree to ``train_parity``'s 1e-4.
    - ``extra()``, when given, returns ``(key, record, check)``: its record
      joins the phase's and ``check(record)`` gates it."""
    import numpy as np
    import torch

    from chainermn_torch import create_multi_node_optimizer
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine
    from chainermn_torch.training import lm_train_step
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

    t_phase = time.perf_counter()
    h, dh = cfg["n_heads"], cfg["d_model"] // cfg["n_heads"]
    n_layers = cfg["n_layers"]
    # -- serve
    work = _serve_traffic(LM_WIDE_REQUESTS, SEED)
    model = TransformerLM(**cfg, compute_dtype=torch.bfloat16,
                          device=device, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, paged=True, paged_kernel=True,
                           device=device, **ENGINE)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    steps_ctr = get_registry().counter(
        "serving_decode_steps_total",
        {"engine": "serving", "paged_kernel": "on"})
    steps0 = steps_ctr.value
    paged_attend.launches = 0
    _, sched, wall = _drive(engine, work)
    serve_launches = paged_attend.launches
    decode_steps = steps_ctr.value - steps0
    rep = sched.metrics.report()
    _check_pool(engine, name)
    prof = _profile_steps(engine, sched, np.random.default_rng(SEED + 40),
                          n_steps=10, host_events=False)
    del engine, sched, model
    _empty()
    m32 = TransformerLM(**twin, compute_dtype=torch.float32, device=device,
                        seed=SEED)
    pw = work[:PARITY_REQUESTS]
    streams = {}
    for kernel in (True, False):
        eng = ServingEngine(m32, paged_kernel=kernel, device=device,
                            **ENGINE)
        streams[kernel], _, _ = _drive(eng, pw)
        del eng
    parity = _parity(m32, pw, streams[True], streams[False])
    del m32
    _empty()

    # -- train
    model = TransformerLM(**cfg, attention="flash",
                          compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    opt = create_multi_node_optimizer(torch.optim.AdamW(
        model.parameters(), lr=TRAIN["lr"],
        weight_decay=TRAIN["weight_decay"]), comm)
    step = lm_train_step(model, opt, comm)
    b, t = TRAIN["batch"], TRAIN["seq_len"]
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg["vocab_size"], (b, t),
                           generator=gen).to(device)
    targets = torch.roll(tokens, -1, dims=1)
    counted = {k: getattr(fa, fn) for k, (fn, *_) in FLASH_KERNELS.items()}
    for fn in counted.values():
        fn.launches = 0
    losses = [step(tokens, targets)[0]
              for _ in range(LM_WIDE_STEPS["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(LM_WIDE_STEPS["timed"]):
        loss, _ = step(tokens, targets)
        losses.append(loss)
    float(loss)                     # the device->host fetch closes the window
    step_s = (time.perf_counter() - t0) / LM_WIDE_STEPS["timed"]
    train_launches = {k: fn.launches for k, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated(device)
    # where the step's time goes: one more step, profiled (its wall clock
    # carries the profiler's host cost; the device times do not)
    train_prof = _train_step_profile(step, tokens, targets, 1)
    train_prof.pop("annotations")
    losses = [float(x) for x in losses]
    n_nonembed = n_params - (cfg["vocab_size"]
                             + cfg["max_len"]) * cfg["d_model"]
    flops = (6.0 * n_nonembed * b * t
             + 12.0 * b * h * t * t * dh / 2 * n_layers)
    del model, opt, step
    _empty()

    # -- the f32 twin's first step, flash against full attention
    pcfg = {k: v for k, v in parity_cfg.items()
            if k not in ("batch", "seq_len", "tol")}
    gen = torch.Generator().manual_seed(SEED + 3)
    tok2 = torch.randint(0, pcfg["vocab_size"], (parity_cfg["batch"],
                                                 parity_cfg["seq_len"]),
                         generator=gen).to(device)
    tgt2 = torch.roll(tok2, -1, dims=1)
    first = {}
    for attention in ("flash", "full"):
        m = TransformerLM(**pcfg, attention=attention,
                          compute_dtype=torch.float32, device=device,
                          seed=SEED + 3)
        before = {n: w.detach().clone() for n, w in m.named_parameters()}
        sgd = create_multi_node_optimizer(
            torch.optim.SGD(m.parameters(), lr=1.0), comm)
        loss = float(lm_train_step(m, sgd, comm, monitored=False)(
            tok2, tgt2)[0])
        first[attention] = (loss, {n: before[n] - w.detach()
                                   for n, w in m.named_parameters()})
        del m, sgd, before
    (l_f, g_f), (l_p, g_p) = first["flash"], first["full"]
    grad_err = {n: float((g_f[n] - g_p[n]).abs().max()) for n in g_f}
    worst = max(grad_err, key=grad_err.get)
    tol = parity_cfg["tol"]
    train_parity = {"model": dict(pcfg, compute_dtype="f32"),
                    "B": parity_cfg["batch"], "T": parity_cfg["seq_len"],
                    "loss_flash": l_f, "loss_full": l_p,
                    "loss_abs_err": abs(l_f - l_p),
                    "grad_max_abs_err": grad_err[worst],
                    "worst_grad": worst, "tol": tol,
                    "ok": abs(l_f - l_p) <= tol and grad_err[worst] <= tol}
    del first, g_f, g_p
    _empty()

    rec = {"phase": name, "card": card,
           "model": dict(cfg, params=n_params, d_head=dh),
           "serve": {"engine": dict(ENGINE, paged_kernel=True,
                                    capture=True),
                     "requests": len(work), "warmup_s": warmup_s,
                     "wall_s": wall, "decode_steps": decode_steps,
                     "kernel_launches": serve_launches,
                     "tokens_generated": rep["tokens_generated"],
                     "tokens_per_sec": rep["tokens_per_sec"],
                     "ttft_p50_s": rep["ttft_p50_s"],
                     "tpot_p50_s": rep["tpot_p50_s"],
                     "profile": prof,
                     "f32_twin": dict(twin, parity=parity)},
           "train": {"B": b, "T": t, "steps": LM_WIDE_STEPS,
                     "step_ms": step_s * 1e3,
                     "tokens_per_sec": b * t / step_s,
                     "analytic_flop_per_step": flops,
                     "mfu_vs_989_tflops": flops / step_s / BF16_OPS_PER_S,
                     "peak_memory_allocated_gb": peak / 1e9,
                     "losses": losses, "launches": train_launches,
                     "profile": train_prof, "parity": train_parity}}
    if extra is not None:
        key, extra_rec, extra_check = extra(device)
        rec[key] = extra_rec
    rec["run_s"] = time.perf_counter() - t_phase
    emit(rec)
    if serve_launches != decode_steps * n_layers:
        raise AssertionError(f"{name}: kernel launches {serve_launches} != "
                             f"decode steps {decode_steps} x {n_layers}")
    _check_parity(f"{name} f32 twin", parity)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    want = (LM_WIDE_STEPS["warmup"] + LM_WIDE_STEPS["timed"]) * n_layers
    if any(n != want for n in train_launches.values()):
        raise AssertionError(f"{name}: flash launches {train_launches} != "
                             f"{want}")
    if not train_parity["ok"]:
        raise AssertionError(f"{name}: the flash step diverges from plain "
                             f"attention: {train_parity}")
    if extra is not None:
        extra_check(extra_rec)
    return rec


def _serve_f16(device):
    """The serve LM (``LM``, 16 heads of 64) at
    ``compute_dtype=torch.float16``: its paged store is float16, so every
    decode step's attention runs B4 on float16 queries and store. The
    captured engine answers ``LM_WIDE_REQUESTS`` of ``_serve_traffic``'s
    requests with ``paged_kernel=True`` (launches = decode steps x 12, a
    replay counted); then its 2-layer float16 twin (``SERVE_F16_TWIN``)
    streams ``PARITY_REQUESTS`` requests through the kernel engine and the
    plain-read engine: equal up to a recorded near-tie
    (``NEAR_TIE_F16``). Returns ``(key, record, check)`` for
    :func:`_lm_wide`."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine

    def serve(model, work, kernel):
        steps_ctr = get_registry().counter(
            "serving_decode_steps_total",
            {"engine": "serving", "paged_kernel": "on" if kernel else "off"})
        eng = ServingEngine(model, paged=True, paged_kernel=kernel,
                            device=device, **ENGINE)
        t0 = time.perf_counter()
        eng.warmup()
        warmup_s = time.perf_counter() - t0
        steps0 = steps_ctr.value
        paged_attend.launches = 0
        streams, sched, wall = _drive(eng, work)
        rep = sched.metrics.report()
        run = {"store_dtype": str(eng._store[0]["k"].dtype).split(".")[-1],
               "layers": len(model.blocks), "requests": len(work),
               "decode_steps": steps_ctr.value - steps0,
               "kernel_launches": paged_attend.launches,
               "warmup_s": warmup_s, "wall_s": wall,
               "tokens_per_sec": rep["tokens_per_sec"],
               "ttft_p50_s": rep["ttft_p50_s"],
               "tpot_p50_s": rep["tpot_p50_s"]}
        del eng, sched
        _empty()
        return streams, run

    work = _serve_traffic(LM_WIDE_REQUESTS, SEED + 19)
    model = TransformerLM(**LM, compute_dtype=torch.float16, device=device,
                          seed=SEED)
    _, full = serve(model, work, True)
    del model
    _empty()
    twin = TransformerLM(**SERVE_F16_TWIN, compute_dtype=torch.float16,
                         device=device, seed=SEED)
    pw = work[:PARITY_REQUESTS]
    streams, twin_runs = {}, {}
    for kernel in (True, False):
        streams[kernel], twin_runs["kernel" if kernel else "plain"] = serve(
            twin, pw, kernel)
    parity = _parity(twin, pw, streams[True], streams[False],
                     near_tie=NEAR_TIE_F16)
    del twin
    _empty()
    rec = {"model": dict(LM, compute_dtype="f16"),
           "engine": dict(ENGINE, capture=True), "serve": full,
           "twin": dict(SERVE_F16_TWIN, compute_dtype="f16",
                        runs=twin_runs, near_tie=NEAR_TIE_F16,
                        parity=parity)}

    def check(r):
        runs = [("serve", r["serve"])] + [
            (f"twin {k}", v) for k, v in r["twin"]["runs"].items()]
        for what, run in runs:
            if run["store_dtype"] != "float16":
                raise AssertionError(f"serve_f16 {what}: store is "
                                     f"{run['store_dtype']}")
        for what, run in runs[:2]:
            if run["kernel_launches"] != run["decode_steps"] * run["layers"] \
                    or not run["kernel_launches"]:
                raise AssertionError(
                    f"serve_f16 {what}: kernel launches "
                    f"{run['kernel_launches']} != decode steps "
                    f"{run['decode_steps']} x {run['layers']}")
        if r["twin"]["runs"]["plain"]["kernel_launches"]:
            raise AssertionError("serve_f16: the plain engine launched B4")
        _check_parity("serve_f16 twin", r["twin"]["parity"])

    return "f16_serve", rec, check


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
# name -> (flags, native loader asked for, profiled). The two c_ layouts
# are not profiled since PR 17 (their idle share paid for d_jpeg_dir).
# Cut to pay for the script's time limit: 4,096 synthetic images (of
# 16,384), 12 recipe iterations (of 30), 4 JPEG-tree iterations (of 12),
# 5 numpy-collate ones (of 8) and 3 for each c_ layout (of 5); a profile
# skips one iteration, then traces three.
IMAGENET = ["--arch", "resnet50", "--classes", "1000", "--image-size", "224",
            "--communicator", "pure_nccl", "--dtype", "bfloat16",
            "--n-synthetic", "4096"]
IMAGENET_MODES = {
    # the recipe (warmup-cosine LR over 90 epochs, label smoothing,
    # held-out top-1) on the native C++ loader and the device prefetcher
    "a_recipe_native_prefetch": (
        ["--batchsize", "256", "--recipe", "--epoch", "90", "--val-frac",
         "0.02", "--native-loader", "--device-prefetch", "2",
         "--iterations", "12"], True, True),
    # the numpy collate on the loop's thread
    "b_numpy_collate": (["--batchsize", "256", "--no-native-loader",
                         "--iterations", "5"], False, True),
    # the two other layouts run on NCCL
    "c_fsdp": (["--batchsize", "64", "--fsdp", "--iterations", "3"], False,
               False),
    "c_mnbn_double_buffering": (["--batchsize", "64", "--mnbn",
                                 "--double-buffering", "--iterations", "3"],
                                False, False),
    # JPEGs from a directory (JPEG_TREE, written at the phase's start),
    # through the device prefetcher; the tree sets the class count. Its
    # classes are noise, so LR 0.01: at the default 0.1 the loss climbed
    # 2.15 -> 25 in the 12 steps. The decoder is declared: PIL, because
    # the card host has no libjpeg headers or library for the native one
    # (PERF.md, PR 17)
    "d_jpeg_dir": (["--batchsize", "256", "--train-dir", "{jpeg_tree}",
                    "--jpeg-decoder", "pil", "--device-prefetch", "2",
                    "--epoch", "1000", "--lr", "0.01", "--iterations", "4"],
                   False, True),
}
# d_jpeg_dir's tree: seeded JPEGs about the size of an ImageNet file
JPEG_TREE = dict(files=512, classes=8, width=500, height=375, quality=90,
                 seed=SEED)
IMAGENET_PROFILE = dict(wait=1, active=3)   # loop iterations


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


def _jpeg_tree(root):
    """JPEG_TREE under ``root``: ``classes`` folders of seeded 500x375
    JPEGs (a smooth base plus noise, quality 90: ~100 KB a file, about an
    ImageNet file's size), written by PIL. 32 distinct images, each under
    16 names, keep the write short; the decoder does the same work for
    each file. Returns the bytes written."""
    import io

    import numpy as np
    from PIL import Image

    t = JPEG_TREE
    rs = np.random.RandomState(t["seed"])
    h, w = t["height"], t["width"]
    blobs = []
    for _ in range(32):
        base = np.kron(rs.rand(h // 8 + 1, w // 8 + 1, 3),
                       np.ones((8, 8, 1)))[:h, :w] * 255
        img = np.clip(base + rs.randn(h, w, 3) * 16, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=t["quality"])
        blobs.append(buf.getvalue())
    per_class = t["files"] // t["classes"]
    total = 0
    for c in range(t["classes"]):
        d = Path(root) / f"class_{c:02d}"
        d.mkdir(parents=True)
        for i in range(per_class):
            data = blobs[(c * per_class + i) % len(blobs)]
            (d / f"{i:04d}.jpg").write_bytes(data)
            total += len(data)
    return total


def _jpeg_host() -> dict:
    """What the host offers the JPEG decoders: PIL's version, libjpeg's
    header and shared library, and whether that library is
    libjpeg-turbo."""
    import ctypes.util
    import importlib.util

    pil = None
    if importlib.util.find_spec("PIL"):
        import PIL

        pil = PIL.__version__
    lib = ctypes.util.find_library("jpeg")
    turbo = None
    for d in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib",
              "/usr/local/lib"):
        for name in ("libjpeg.so", "libjpeg.so.8", "libjpeg.so.62"):
            path = Path(d) / name
            if path.exists():
                turbo = b"libjpeg-turbo" in path.read_bytes()
                lib = str(path.resolve())
                break
        if turbo is not None:
            break
    return {"pil": pil, "jpeglib_h": Path("/usr/include/jpeglib.h").exists(),
            "libjpeg": lib, "libjpeg_turbo": turbo}


def _decode_alone(root, batch, image_size):
    """One batch of the tree decoded alone, by each decoder the host has:
    ms a batch, and the native decoder's thread count."""
    import importlib.util
    import os

    from chainermn_torch.native import jpeg

    paths, _, _ = jpeg.scan_image_directory(str(root))
    blobs = [Path(p).read_bytes() for p in paths[:batch]]
    out = {"batch": len(blobs), "threads": min(8, os.cpu_count() or 1)}
    decoders = []
    if jpeg.native_available():
        decoders.append("native")
    else:
        out["native_ms_per_batch"] = ("not measured: the C++ decoder does "
                                      "not build here")
    if importlib.util.find_spec("PIL"):
        decoders.append("pil")
    for dec in decoders:
        jpeg.decode_jpeg_batch(blobs[:8], image_size, decoder=dec)  # warm
        t0 = time.perf_counter()
        _, nfail = jpeg.decode_jpeg_batch(blobs, image_size, decoder=dec)
        out[f"{dec}_ms_per_batch"] = (time.perf_counter() - t0) * 1e3
        out[f"{dec}_failed"] = nfail
    return out


def phase_imagenet(device, step_images_per_sec, card):
    """The ImageNet trainer twin (``chainermn_torch.examples.imagenet.
    train_imagenet.main``) in process at full width, in each of
    IMAGENET_MODES: a timed run (the loop's images/s excludes the first
    iteration, as the reference's does), then, for the profiled modes, a
    run of IMAGENET_PROFILE's iterations for the device idle share
    (kernel time over the window's wall time; the copies are reported
    beside it). One JSON line per mode, beside dp_train's step-only
    images/s. ``d_jpeg_dir`` reads JPEG_TREE, written at the start, on
    the native decoder it declares, and also reports a batch decoded
    alone by each decoder the host has. Fails if a loss is not finite, a
    mode prints no ``done:`` line, the native loader was asked for and
    did not run, or the JPEG mode's native decoder did not run or a
    decode failed."""
    import os
    import tempfile

    import torch

    from chainermn_torch.native import jpeg

    torch.backends.cudnn.benchmark = True
    tree = tempfile.mkdtemp(prefix="jpeg_tree_")
    records = []
    try:
        t0 = time.perf_counter()
        tree_bytes = _jpeg_tree(tree)
        tree_s = time.perf_counter() - t0
        for mode, (flags, native, profiled) in IMAGENET_MODES.items():
            argv = IMAGENET + [f.format(jpeg_tree=tree) for f in flags]
            decoded0 = dict(jpeg.DECODED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            summary, printed = _twin(argv)
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device)
            decoded = {k: jpeg.DECODED[k] - decoded0[k] for k in decoded0}
            cut = argv.index("--iterations")
            kernel_s = copy_s = wall = None
            if profiled:
                kernel_s, copy_s, wall = _profiled_twin(
                    argv[:cut] + argv[cut + 2:], **IMAGENET_PROFILE)
            done = [ln for ln in printed if ln.startswith("done: ")]
            per = IMAGENET_PROFILE["active"]
            rec = {"phase": "imagenet", "mode": mode, "card": card,
                   "argv": argv, "printed": printed, "run_s": run_s,
                   "iterations": summary["iterations"],
                   "loop_images_per_sec": summary["images_per_sec"],
                   "dp_train_step_images_per_sec": step_images_per_sec,
                   "loop_over_step": (summary["images_per_sec"]
                                      / step_images_per_sec
                                      if summary["images_per_sec"]
                                      else None),
                   "native_loader": summary["native_loader"],
                   "h2d_seconds_per_batch": summary["h2d_seconds_per_batch"],
                   "profiled_iterations": per if profiled else 0,
                   "profiled_wall_ms_per_iter":
                       wall / per * 1e3 if profiled else "not measured",
                   "device_kernel_ms_per_iter":
                       kernel_s / per * 1e3 if profiled else "not measured",
                   "device_copy_ms_per_iter":
                       copy_s / per * 1e3 if profiled else "not measured",
                   "device_idle_share": (1 - kernel_s / wall)
                   if profiled and kernel_s > 0 else "not measured",
                   "peak_memory_allocated_gb": peak / 1e9,
                   "top1": summary["top1"], "params": summary["params"],
                   "losses": summary["losses"],
                   "losses_finite": summary["losses_finite"]}
            if summary["jpeg_decoder"] is not None:
                rec.update({
                    "jpeg_tree": dict(JPEG_TREE, bytes=tree_bytes,
                                      write_s=tree_s),
                    "classes": summary["classes"],
                    "jpeg_decoder": summary["jpeg_decoder"],
                    "images_decoded": decoded,
                    "failed_decodes": summary["failed_decodes"],
                    "decode_alone": _decode_alone(tree, 256, 224),
                    "host": _jpeg_host(), "cpu_count": os.cpu_count()})
            emit(rec)
            records.append(rec)
            if not summary["losses_finite"]:
                raise AssertionError(f"imagenet {mode}: a loss is not "
                                     "finite")
            if not done:
                raise AssertionError(f"imagenet {mode}: no 'done:' line")
            if native and not summary["native_loader"]:
                raise AssertionError(f"imagenet {mode}: the native loader "
                                     "was asked for and did not run")
            if "--train-dir" in argv:
                want = argv[argv.index("--jpeg-decoder") + 1]
                other = ({"native", "pil"} - {want}).pop()
                if summary["jpeg_decoder"] != want \
                        or decoded[want] < summary["iterations"] * 256 \
                        or decoded[other]:
                    raise AssertionError(f"imagenet {mode}: the declared "
                                         f"{want} decoder did not run "
                                         f"alone: {decoded}")
                if summary["failed_decodes"] != 0:
                    raise AssertionError(f"imagenet {mode}: "
                                         f"{summary['failed_decodes']} "
                                         "failed decodes")
                if summary["classes"] != JPEG_TREE["classes"]:
                    raise AssertionError(f"imagenet {mode}: "
                                         f"{summary['classes']} classes")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tree, ignore_errors=True)
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
# the MNIST twins' epochs: the data-parallel one at 5 of its 20 and the
# model-parallel one at 1 of its 10 (both reach validation accuracy 1.0,
# the JAX figure, in the first); the seq2seq twin at 5 of its 20 (token
# accuracy 0.21 -> 0.63 by the fifth; the JAX figure is the twentieth's),
# the channel-parallel one at 2 of its 5 (the loss falls 2.08 -> 0.77)
MNIST_EPOCHS = 5
MP_EPOCHS = 1
SEQ2SEQ_EPOCHS = 5
PCONV_EPOCHS = 2
MP_TWIN = "chainermn_torch.examples.mnist.train_mnist_model_parallel"
MP_PINGPONG = "100,500"            # the boundary tensor's shape
SEQ2SEQ_TWIN = "chainermn_torch.examples.seq2seq.seq2seq"
# the checkpoint twin at 1 of its 5 epochs (40 iterations): each of its
# three runs is a process of its own, so the iterations are its time
CKPT_EPOCHS = 1
CKPT_STOP_AT = 24                  # crash after 24 of 40 iterations
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
    (batch 100, unit 1000, 10,000/2,000 synthetic images) but
    MNIST_EPOCHS epochs.
    Fails unless every loss is finite, the last epoch's loss is below the
    first step's and the final validation accuracy is at least
    MNIST_GATE."""
    import torch

    from chainermn_torch.examples.mnist.train_mnist import main as twin

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    summary, printed = _lines(lambda: twin(["--communicator", "pure_nccl",
                                            "--epoch", str(MNIST_EPOCHS)]))
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


# the resumed checkpoint run's process: it imports the twin and sets up
# CUDA while the crash run runs, then waits for the file argv[1] (made
# once the crash run has ended) and only then runs the twin's main() as
# ``python -m`` would, with the remaining arguments
_RESUME_AFTER = """
import os, runpy, sys, time
import torch
import chainermn_torch.examples.mnist.train_mnist_checkpoint
del sys.modules["chainermn_torch.examples.mnist.train_mnist_checkpoint"]
torch.cuda.init()
while not os.path.exists(sys.argv[1]):
    time.sleep(0.01)
sys.argv = sys.argv[:1] + sys.argv[2:]
runpy.run_module("chainermn_torch.examples.mnist.train_mnist_checkpoint",
                 run_name="__main__", alter_sys=True)
"""


def phase_mnist_checkpoint(card):
    """The checkpoint twin (``python -m chainermn_torch.examples.mnist.
    train_mnist_checkpoint``) at its defaults but ``--epoch CKPT_EPOCHS``,
    three runs on the card: an
    uninterrupted one, one with ``--stop-at CKPT_STOP_AT`` (must exit
    non-zero after "simulated crash"), and a resumed one (must print
    "resumed from iteration K'", K' the newest snapshot at or before the
    crash). The first two share nothing (each its own output directory
    and one-rank group) and run at once; the resumed run's process starts
    beside them, imports the twin and waits, and its run starts after the
    crash run's process has ended. Fails unless the resumed run's last
    snapshot equals the uninterrupted run's, leaf by leaf (the largest
    difference is reported; the target is 0)."""
    import tempfile

    import numpy as np

    module = "chainermn_torch.examples.mnist.train_mnist_checkpoint"
    args = ["--communicator", "pure_nccl", "--epoch", str(CKPT_EPOCHS)]
    runs = {}

    def run(name, extra, out, pre=None):
        t0 = time.perf_counter()
        timeout = _group_timeout()
        cmd = ([sys.executable, "-c", _RESUME_AFTER, pre] if pre else
               [sys.executable, "-m", module])
        try:
            r = subprocess.run(cmd + args + ["--out", str(Path(tmp) / out)]
                               + extra, cwd=ROOT, capture_output=True,
                               text=True, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            tail = "\n".join(
                (x.decode(errors="replace") if isinstance(x, bytes)
                 else x or "")[-3000:] for x in (e.stdout, e.stderr))
            raise RuntimeError(f"phase mnist_checkpoint: its {name} run ran "
                               f"out of its {timeout:.0f} s; its last "
                               f"output:\n{tail}") from None
        printed = r.stdout.splitlines()
        runs[name] = {"rc": r.returncode, "s": time.perf_counter() - t0,
                      "printed": printed[:2] + printed[-2:],
                      "stderr_tail": r.stderr[-2000:]}

    with tempfile.TemporaryDirectory() as tmp:
        crashed = str(Path(tmp) / "crashed")

        def crash():
            try:
                run("crash", ["--stop-at", str(CKPT_STOP_AT)], "b")
            finally:
                Path(crashed).touch()

        with ThreadPoolExecutor(3) as pool:
            done = [pool.submit(run, "uninterrupted", [], "a"),
                    pool.submit(crash),
                    pool.submit(run, "resumed", [], "b", crashed)]
            for f in done:
                f.result()
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
def rank_twin(module, epochs, pingpong="", objstore=""):
    """One rank of a two-process twin: ``module``'s ``main`` for
    ``epochs`` epochs on the card; then, when ``pingpong`` names the
    boundary tensor's shape ("100,500"), round trips of that tensor alone
    (and of one float, the fixed cost) over the same host-staged
    send/recv; then, when ``objstore`` is set, the object-store part.
    The twin's summary, with what was added."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist

    main = importlib.import_module(module).main
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = main(["--device", "cuda", "--epoch", str(epochs)])
    summary["run_s"] = time.perf_counter() - t0
    summary["printed"] = buf.getvalue().splitlines()
    summary["peak_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    summary["backend"] = dist.get_backend()
    if pingpong:
        from chainermn_torch import create_communicator

        comm = create_communicator("naive", device="cuda")
        peer = 1 - comm.rank
        summary["pingpong_ms"] = {}
        for name, shape in (("boundary", [int(n) for n in
                                          pingpong.split(",")]),
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
            summary["pingpong_ms"][name] = \
                (time.perf_counter() - t0) / 100 * 1e3
        comm.finalize()
    if objstore:
        summary["objstore"] = _objstore_part()
    return summary


# the object-store sidecar inside mnist_mp's two ranks, after the twin:
# rank 0 starts the C++ store, both ranks make a communicator with
# CHAINERMN_TORCH_OBJSTORE set, and the same object traffic runs over the
# sidecar and over gloo (the dataset scatter ships the twin's training
# set; a 64 MB bcast_obj). Digests of every result, each op's ms on both
# transports, and the store's keys after the ack-GC's flush.
def _objstore_part():
    """mnist_mp's object traffic over gloo and over the sidecar, on
    this rank: the record phase_mnist_mp prints."""
    import hashlib
    import os
    import pickle

    import numpy as np
    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.datasets import scatter_dataset
    from chainermn_torch.examples.mnist.train_mnist import (
        ArrayDataset, load_mnist)
    from chainermn_torch.native import objstore

    def digest(obj):
        if isinstance(obj, torch.Tensor):
            obj = (str(obj.dtype), tuple(obj.shape),
                   obj.detach().cpu().contiguous().view(-1)
                   .view(torch.uint8).numpy().tobytes())
        return hashlib.sha1(pickle.dumps(obj)).hexdigest()

    (x, y), _ = load_mnist(None, 8000, 1000)
    data = ArrayDataset(x, y)
    big = np.random.RandomState(7).bytes(64 << 20)

    def ops(comm):
        out, ms = {}, {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3
            out[name] = res

        timed("scatter_dataset", lambda: digest([
            (a.tobytes(), int(b)) for a, b in scatter_dataset(
                data, comm, shuffle=True, seed=0, force_transport=True)]))
        timed("bcast_obj_64mb", lambda: digest(comm.bcast_obj(
            big if comm.rank == 0 else None)))
        timed("allgather_obj", lambda: comm.allgather_obj(
            ("rank", comm.rank, list(range(comm.rank + 3)))))
        timed("scatter_obj", lambda: comm.scatter_obj(
            [{"part": r} for r in range(comm.size)]
            if comm.rank == 0 else None))
        peer = 1 - comm.rank

        def p2p_obj():
            if comm.rank == 0:
                comm.send_obj({"ping": np.arange(5)}, peer, tag=11)
                return digest(comm.recv_obj(peer, tag=12))
            got = comm.recv_obj(peer, tag=11)
            comm.send_obj({"pong": got["ping"] * 2}, peer, tag=12)
            return digest(got)

        timed("send_recv_obj", p2p_obj)
        g = torch.Generator(device="cuda").manual_seed(5)
        t = torch.randn(100, 500, device="cuda", generator=g)

        def p2p_tensor():
            if comm.rank == 0:
                comm.send({"x": t, "y": [t.to(torch.bfloat16)]}, peer,
                          tag=13)
                return digest(t)
            got = comm.recv(peer, tag=13)
            return [digest(got["x"]), digest(got["y"][0]),
                    str(got["x"].device)]

        timed("send_recv_tensor", p2p_tensor)
        comm.barrier()
        return out, ms

    gloo = create_communicator("naive", device="cuda")
    plain, plain_ms = ops(gloo)
    server = objstore.ObjStoreServer() if gloo.rank == 0 else None
    port = gloo.bcast_obj(server.port if server is not None else None)
    os.environ["CHAINERMN_TORCH_OBJSTORE"] = f"127.0.0.1:{port}"
    comm = create_communicator("naive", device="cuda")
    native, native_ms = ops(comm)
    left = comm._obj.flush_gc(60)
    gloo.barrier()
    keys = (comm._obj._store.list_prefix("chainermn_torch/obj/")
            if server is not None else None)
    gloo.barrier()
    rec = {"transport": comm.object_transport,
           "gloo_transport": gloo.object_transport,
           "equal": {k: native[k] == plain[k] for k in plain},
           "results": native, "gloo_ms": plain_ms, "objstore_ms": native_ms,
           "pending_rounds_after_flush": left, "keys_left": keys}
    comm.finalize()
    del os.environ["CHAINERMN_TORCH_OBJSTORE"]
    gloo.finalize()
    if server is not None:
        server.stop()
    return rec


def _two_ranks(module, epochs, pingpong="", objstore=False):
    """``rank_twin`` of the twin ``module`` on 2 gloo ranks on the card
    (from phase_gloo_batch's run when it ran there): each rank's
    summary."""
    return _gloo_ranks("rank_twin", 2, module, str(epochs), pingpong,
                       "objstore" if objstore else "")


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
    8,000/1,000 images) but MP_EPOCHS epochs. Fails unless every parameter is on
    the card, the losses are finite and fall, the final validation
    accuracy is at least MNIST_GATE, the first MP_PARITY_STEPS losses
    match the two stages in one process to 1e-5, and each rank ran one
    forward and one backward transfer a step. After training the two
    ranks time round trips of the boundary tensor alone over the same
    host-staged path (the transfer's own cost, apart from waiting for the
    other stage)."""
    t0 = time.perf_counter()
    ranks = _two_ranks(MP_TWIN, MP_EPOCHS, MP_PINGPONG, objstore=True)
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
    sidecar = [out["objstore"] for out in ranks]
    emit({"phase": "objstore_sidecar", "card": card, "ranks": 2,
          "host": "mnist_mp's two rank processes, after the twin",
          "payload_bcast_bytes": 64 << 20,
          "ranks_out": [{k: v for k, v in r.items() if k != "results"}
                        for r in sidecar]})
    for r, side in enumerate(sidecar):
        if side["transport"] != "objstore" or \
                side["gloo_transport"] != "gloo":
            raise AssertionError(f"objstore_sidecar rank {r}: transports "
                                 f"{side['transport']}/"
                                 f"{side['gloo_transport']}")
        if not all(side["equal"].values()):
            raise AssertionError(f"objstore_sidecar rank {r}: results "
                                 f"differ from gloo's: {side['equal']}")
        if side["pending_rounds_after_flush"]:
            raise AssertionError(f"objstore_sidecar rank {r}: "
                                 f"{side['pending_rounds_after_flush']} "
                                 "rounds never collected")
    if sidecar[0]["keys_left"] != []:
        raise AssertionError(f"objstore_sidecar: keys left in the store "
                             f"after the last round: "
                             f"{sidecar[0]['keys_left'][:8]}")
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
    seq 8, batch 64, 2,048 pairs) but SEQ2SEQ_EPOCHS epochs (of its 20).
    Fails unless every loss is finite and the last epoch's token accuracy
    is above the first's."""
    t0 = time.perf_counter()
    ranks = _two_ranks(SEQ2SEQ_TWIN, SEQ2SEQ_EPOCHS)
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
# sp_parity: the 220M LM's attention shape, global T over 2 ranks, at
# batch 4 (8 before the script's last time cut; PERF.md section 4);
# (rtol, atol). bf16 is flash_parity's: one bf16 ulp is 1.6e-2 at
# |x| >= 2, and the plain kinds do not round p to bf16 before PV as the
# kernels do, so an absolute 2e-2 alone fails on a 1-ulp difference
SP_PARITY = dict(batch=4, seq_len=2048, heads=16, head_dim=64,
                 tol={"f32": (0.0, 1e-4), "bf16": TOL["bf16"]})
# sp_train / tp_train: the train phase's LM, batch and AdamW over 2 ranks,
# held to the one-process flash LM trained alike: every step's loss
# (loss_tol, by phase) and the first step's global gradient, by the
# largest relative L2 error of a leaf (grad_rel_tol), both bf16, a few
# times the sound readings; planted faults read in the same run must
# exceed grad_rel_tol (readings in PERF.md section 6). TP's losses drift
# further: its row-parallel partial sums are rounded to bf16 before they
# are summed, and the trajectory rises at step 6, which amplifies that
# SP_LM: the 220M LM's widths at 2 of its 12 layers — the depth cut so
# that the script, grown by the MoE, GSPMD and pipeline phases, stays
# well inside its time limit (12 layers took 165 + 54 s of it; 4 layers
# until the whole script had to fall well under 1200 s on a slower card
# host); 1 + 2 steps (were 2 + 5, then 1 + 3), the cuts that keep the
# script inside its limit; batch 4 of the train phase's 8 (the
# host-staged transfers, 0.95 of each step, halve with it)
SP_LM = dict(LM, n_layers=2)
SP_TRAIN = dict(batch=4, seq_len=2048, warmup_steps=1, timed_steps=2,
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
HYBRID_RANKS = math.prod(HYBRID["shape"])

_GLOO_RANKS = """
import os
import torch
import torch.distributed as dist

dist.init_process_group("gloo", init_method="env://", rank=RANK,
                        world_size=int(os.environ["WORLD_SIZE"]))
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
chip_smoke._keep_seeded_weights()
save(getattr(chip_smoke, ARGS[0])(*ARGS[1:]))
dist.destroy_process_group()
"""

# every multi-rank phase's ranks run in one group of 8 processes
# (phase_gloo_batch), which starts once instead of once a phase: a start
# is 10-15 s of imports and CUDA set-up on the card host, more for 4 or 8
# processes. The calls run in stages of 2, 4 and 8 ranks, one after
# another; for each stage its first ``world`` processes form a gloo group
# of their own (a fresh port), run the stage's calls in order and end the
# group. The others wait, asleep and without a CUDA context, until rank 0
# starts the next stage they belong to (a file beside the ranks' results
# says so)
_GLOO_BATCH = """
import datetime, gc, json, os, time
import torch
import torch.distributed as dist

torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
chip_smoke._keep_seeded_weights()
stages, timeout = json.loads(ARGS[0]), float(ARGS[1])
setup = {"ready_unix_s": time.time(), "group_init_s": {}}
out = []
for world, port, calls in stages:
    if RANK >= world:
        continue
    go = os.path.join(sys.argv[2], f"stage{world}")
    if RANK == 0:
        open(go, "w").close()
    while not os.path.exists(go):
        time.sleep(0.05)
    torch.cuda.set_device(0)   # a rank's CUDA context from its first stage
    os.environ.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_PORT=str(port))
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method="env://", rank=RANK,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    setup["group_init_s"][world] = time.perf_counter() - t0
    for phase, fn, *args in calls:
        # names the call a group cut at its time limit was in
        print(json.dumps({"phase_start": phase, "rank": RANK, "fn": fn}),
              flush=True)
        t0 = time.perf_counter()
        out.append((getattr(chip_smoke, fn)(*args),
                    time.perf_counter() - t0))
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
save((out, setup))
"""
_GLOO_DONE = {}
_RESHARD_SNAP = {}     # the batch's reshard snapshot directory
_PP_REF = {}           # the losses of the batch's pipeline reference


def _gloo_batch_stages(snap, pp_ref):
    """phase_gloo_batch's calls by stage, each stage's in the phases'
    order: [(ranks, [(phase, rank function, its string arguments)])],
    the stages by their number of ranks."""
    calls = [
        (2, "mnist_mp", "rank_twin", (MP_TWIN, str(MP_EPOCHS), MP_PINGPONG,
                                      "objstore")),
        (2, "seq2seq_mp", "rank_twin", (SEQ2SEQ_TWIN, str(SEQ2SEQ_EPOCHS),
                                        "", "")),
        (2, "parallel_conv", "rank_pconv", (str(PCONV_EPOCHS),)),
        (2, "sp_parity", "rank_sp_parity", ()),
        (2, "sp_train", "rank_sp_train", ()),
        (2, "tp_train", "rank_tp_train", ()),
        (SERVE_TP["tp"], "serve_tp", "rank_serve_tp", ()),
        (MOE["ranks"], "moe_train", "rank_moe_train", ()),
        (MOE["ranks"], "gspmd_train", "rank_gspmd_train", ()),
        (RESHARD["train_tp"], "reshard", "rank_reshard_train", (snap,)),
        (RESHARD["serve_tp"], "reshard", "rank_reshard_serve", (snap,)),
        (PP["stages"], "pp_train", "rank_pp_train", (pp_ref,)),
        (HYBRID_RANKS, "hybrid", "rank_hybrid", ()),
    ]
    return [(world, [c[1:] for c in calls if c[0] == world])
            for world in sorted({c[0] for c in calls})]


def _group_timeout() -> float:
    """Seconds a rank group or subprocess of the running phase may take:
    GROUP_TIMEOUT_FACTOR times the phase's GROUP_SECONDS, cut so that it
    ends by DEADLINE_S (at least 10 s). A phase called on its own, outside
    main(), gets GROUP_UNTIMED_S."""
    phase = _RUNNING["phase"]
    if phase not in GROUP_SECONDS:
        return GROUP_UNTIMED_S
    left = DEADLINE_S - (time.monotonic() - T_START)
    return max(10.0, min(GROUP_TIMEOUT_FACTOR * GROUP_SECONDS[phase], left))


def _run_group(code: str, n: int, args) -> list:
    """``run_ranks(code, n, args)`` under the running phase's
    :func:`_group_timeout`. A group that fails or runs out of time raises
    ``RuntimeError`` naming the phase, with the end of the ranks'
    output."""
    from chainermn_torch.testing import run_ranks

    phase, timeout = _RUNNING["phase"], _group_timeout()
    t0 = time.monotonic()
    try:
        return run_ranks(code, n, args=list(args), timeout=timeout)
    except RuntimeError as e:
        took = time.monotonic() - t0
        what = (f"ran out of its {timeout:.0f} s" if took >= timeout
                else "failed")
        raise RuntimeError(f"phase {phase}: its {n}-rank group {what} after "
                           f"{took:.1f} s; the ranks' last output:\n"
                           f"{str(e)[-6000:]}") from None


def _gloo_ranks(fn: str, n: int, *args):
    """``chip_smoke.<fn>(*args)`` in ``n`` processes on cuda:0 joined by a
    gloo group; what each returned, by rank (from phase_gloo_batch's run
    when ``fn`` ran there with these arguments)."""
    if (fn, n, args) in _GLOO_DONE:
        return _GLOO_DONE.pop((fn, n, args))
    return _run_group(_GLOO_RANKS, n, [fn, *args])


def phase_gloo_batch(card):
    """The multi-rank phases' rank functions (``_gloo_batch_stages``) in
    one group of 8 processes on the card, by stage of 2, 4 and 8 ranks;
    each of those phases then reads its ranks' results from here instead
    of starting a group of its own (reshard's first half writes its
    snapshot into a directory under ``build/`` that its second half
    reads and phase_reshard deletes; pp_train's sequential reference runs
    in this process first, into a file its ranks read). Prints each
    call's seconds on each of its ranks."""
    import tempfile

    from chainermn_torch.testing import free_port

    (ROOT / "build").mkdir(exist_ok=True)
    _RESHARD_SNAP["dir"] = tempfile.mkdtemp(prefix="reshard_",
                                            dir=ROOT / "build")
    t0 = time.perf_counter()
    path = ROOT / "build" / "pp_reference.pt"
    _PP_REF["losses"] = _pp_reference(path)
    reference_s = time.perf_counter() - t0
    stages = _gloo_batch_stages(str(Path(_RESHARD_SNAP["dir"]) / "snap"),
                                str(path))
    n = max(world for world, _ in stages)
    timeout = _group_timeout()
    t_start = time.time()
    ranks = _run_group(_GLOO_BATCH, n, [json.dumps(
        [[world, free_port(), [[phase, fn, *args]
                               for phase, fn, args in calls]]
         for world, calls in stages]), str(timeout)])
    seconds, at = {}, [0] * n
    for world, calls in stages:
        for phase, fn, args in calls:
            got = [ranks[r][0][at[r]] for r in range(world)]
            _GLOO_DONE[(fn, world, args)] = [x[0] for x in got]
            seconds[f"{phase}:{fn}"] = [x[1] for x in got]
            for r in range(world):
                at[r] += 1
    # each rank's start (imports, CUDA, the seeded-weight hook) and the
    # seconds its stages' groups took to form
    setup = [{"start_s": s["ready_unix_s"] - t_start,
              "group_init_s": s["group_init_s"]} for _, s in ranks]
    emit({"phase": "gloo_batch", "card": card, "ranks": n,
          "stages": [world for world, _ in stages], "backend": "gloo",
          "pp_reference_s": reference_s, "rank_setup": setup,
          "rank_seconds": seconds, "run_s": time.perf_counter() - t0})


def _flash_counts():
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

    return {name: getattr(fa, fn).launches
            for name, (fn, *_) in FLASH_KERNELS.items()}


def _zero_flash_counts():
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")

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
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
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


def _reference_run(model, tokens, targets, steps, stats=None):
    """``model`` trained ``steps`` AdamW steps (TRAIN's) on the whole batch
    in this process: its losses and its first step's gradients. An MoE
    model trains on ``ce + 0.01 * aux`` as ``lm_train_step`` does, and
    appends each step's mean drop fraction to ``stats``."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.parallel.moe import drop_frac_from_sown

    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"],
                            weight_decay=TRAIN["weight_decay"])
    losses, grads = [], None
    moe = bool(getattr(model, "moe_experts", 0))
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        logits, aux = model(tokens, return_aux=True)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        if moe:
            loss = loss + 0.01 * aux
            stats.append(float(drop_frac_from_sown(model.moe_stats())))
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
    out = [step(tokens, targets)]
    grad = first_grads()
    out += [step(tokens, targets) for _ in range(warmup - 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged0 = staged_fn()
    t0 = time.perf_counter()
    for _ in range(timed):
        out.append(step(tokens, targets))
    float(out[-1][0])
    wall = time.perf_counter() - t0
    staged = staged_fn()
    b, t = tokens.shape
    losses = [loss for loss, _ in out]
    drops = [float(st["moe_drop_frac"]) for _, st in out
             if "moe_drop_frac" in st]
    return {"losses": [float(x) for x in losses], "grad_err": grad,
            "moe_drop_frac": drops,
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
    """One rank of sp_train: the 220M LM at 2 layers (SP_LM; bf16, seed 0)
    with each
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
        TransformerLM(**SP_LM, attention="flash", **bf16), tokens, targets,
        n_steps)
    torch.cuda.empty_cache()
    out = {"one_process_losses": ref_losses}
    for kind in SP_TRAIN["kinds"]:
        layout = (zigzag_permutation(t, n) if kind.startswith("zigzag")
                  else torch.arange(t))
        mine = layout[r * (t // n):(r + 1) * (t // n)].to(dev)

        def sharded(kind=kind):
            model = TransformerLM(**SP_LM, attention=kind, sequence_axis=comm,
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
    """The 220M LM's context-parallel training (at 2 layers) on 2 ranks of
    the card
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
    want = {k: n_steps * SP_LM["n_layers"]
            * _launches_per_attention(k, True, 2)
            for k in SP_TRAIN["kinds"]}
    emit({"phase": "sp_train", "card": card, "ranks": 2, "backend": "gloo",
          "model": dict(SP_LM, compute_dtype="bf16"),
          "train": dict(SP_TRAIN, lr=TRAIN["lr"],
                        weight_decay=TRAIN["weight_decay"]),
          "reduced": f"{SP_LM['n_layers']} of the 12 layers; B=4 of the "
                     "train phase's 8, "
                     "T=2048",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    _check_train("sp_train", ranks, want)
    return ranks


def rank_tp_train():
    """One rank of tp_train: the 220M LM at 2 layers (SP_LM) with
    ``tensor_axis`` over tp = 2
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
    model = TransformerLM(**SP_LM, **tp_kw, compute_dtype=torch.bfloat16,
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
    # the fleet-wide telemetry over the group: both ranks' registries
    # merged, the same dict on each
    from chainermn_torch import monitor

    out["aggregate"] = monitor.aggregate(comm)
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
    """The 220M LM's tensor-parallel training (at 2 layers) on 2 ranks of
    the card
    (``rank_tp_train``), held as sp_train is: finite falling losses,
    every step's loss and the first step's global gradient against the
    dense flash LM on the converted weights trained alike in one process
    (the planted fault — the sliced leaves without the x tp — must fail
    the gradient gate), the small f32 TP LM against its dense twin to
    1e-4, and one launch of each flash kernel a layer and step on each
    rank; and ``monitor.aggregate(comm)`` must return the same dict on
    both ranks, its ``steps_total`` of the TP step 2 x the steps run."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_tp_train", 2)
    n_steps = SP_TRAIN["warmup_steps"] + SP_TRAIN["timed_steps"]
    want = {"flash": n_steps * SP_LM["n_layers"]}
    aggs = [rk.pop("aggregate") for rk in ranks]
    tp_steps = aggs[0]["counters"].get('steps_total{step="lm_tp_train_step"}')
    emit({"phase": "tp_train", "card": card, "ranks": 2, "backend": "gloo",
          "model": dict(SP_LM, compute_dtype="bf16", tensor_parallel=2,
                        vocab_parallel_head=True, attention="flash"),
          "reduced": f"{SP_LM['n_layers']} of the 12 layers; B=4 of the "
                     "train phase's 8, "
                     "T=2048",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "aggregate": {"ranks": aggs[0]["ranks"],
                        "same_on_every_rank": aggs[0] == aggs[1],
                        "tp_steps_total": tp_steps,
                        "counters": len(aggs[0]["counters"]),
                        "histograms": len(aggs[0]["histograms"])},
          "ranks_out": ranks})
    _check_train("tp_train", ranks, want)
    if aggs[0] != aggs[1] or aggs[0]["ranks"] != 2 or tp_steps != 2 * n_steps:
        raise AssertionError(f"tp_train: monitor.aggregate: ranks "
                             f"{aggs[0]['ranks']}, equal {aggs[0] == aggs[1]},"
                             f" lm_tp_train_step steps {tp_steps} != "
                             f"2 x {n_steps}")
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
    ranks = _gloo_ranks("rank_hybrid", HYBRID_RANKS)
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


# the MoE LM: the 220M LM's widths and depth with every second block's
# FFN routed through 8 experts, top-2 (the JAX script's --moe-experts 8
# --moe-top-k 2), attention on the flash kernels, bf16 compute. EP over 2
# ranks holds 4 experts a rank; each rank trains on 2 x 1024 tokens, the
# one-process reference (gshard) on the 4 x 1024 global batch. The seeded
# gate routes unevenly (12-28% of assignments dropped at a capacity factor
# of 2, PERF.md section 6), so the parity runs at E / k = 4, where an
# expert can take every token and nothing drops (read, not assumed); then
# 3 steps at the default 1.25. Tolerances (PERF.md section 6): the
# gate's logits are bf16, and a token whose second and third choices lie
# within one bf16 step of each other changes experts under any rounding
# difference upstream, so two sound runs drift apart step by step (0.039
# EP, 0.118 GSPMD over 7 steps) and the gate's own gradient differs most
# (0.17 under GSPMD, whose blocks round their partial sums apart). The
# pre-update loss is held tightly, the trajectory loosely; the gradient
# gate carries the power, against planted faults that read >= 1.
# moe_train runs 4 of the 12 layers (2 MoE blocks): the depth cut that
# keeps the script inside its time limit as the later phases grow it
# (12 layers took 87.2 s of it; 6 before the script's last time cut);
# 1 + 2 steps at the parity capacity and 2 at the default one (were
# 1 + 3 and 3), as gspmd_train's 1 + 2
MOE = dict(experts=8, top_k=2, ranks=2, batch=2, seq_len=1024,
           warmup_steps=1, timed_steps=2, drop_steps=2, parity_capacity=4.0,
           first_loss_tol=1e-3, loss_tol=0.25, grad_rel_tol=5e-2,
           n_layers=4)
GSPMD_TOL = dict(first_loss_tol=1e-3, loss_tol=0.25, grad_rel_tol=0.35)
# gspmd_train's depth: 4 of the 220M LM's 12 layers (6, then 4 in the
# script's time cuts; the widths stay the LM's)
GSPMD_LAYERS = 4
# GPipe: 4 stages (one block of the 220M LM's width each, 'full'
# attention as make_pipeline_lm builds them) on 4 ranks, 8 microbatches
# of 2 x 1024, remat (the step's default), 2 AdamW steps (of 5, then 3,
# before the script's time limit called for the cuts)
PP = dict(stages=4, microbatches=8, micro_batch=2, seq_len=1024, steps=2,
          loss_tol=2e-2, grad_rel_tol=5e-2)
# fused CE and remat on the 220M dense LM at the train phase's batch
FUSED = dict(batch=8, seq_len=2048, steps=3, loss_tol=2e-2)
# the twin's main() on the card at its own defaults
LM_EXAMPLE = {"moe": ["--moe-experts", "8", "--moe-top-k", "2",
                      "--attention", "flash"],
              "pipeline": ["--pipeline"]}


def _moe_lm(n_layers=LM["n_layers"], **kw):
    """The MoE LM of MOE (bf16, seed 0) on cuda:0, at ``n_layers``."""
    import torch

    from chainermn_torch.models import TransformerLM

    return TransformerLM(**dict(LM, n_layers=n_layers), attention="flash",
                         moe_experts=MOE["experts"],
                         moe_top_k=MOE["top_k"], compute_dtype=torch.bfloat16,
                         device=torch.device("cuda", 0), seed=SEED, **kw)


@contextlib.contextmanager
def _top2_unrenormalised():
    """A planted fault: the top-2 combine weights left as the raw gate
    probabilities instead of renormalised to sum to 1."""
    import torch

    from chainermn_torch.parallel import moe

    real = moe._route

    def faulty(gate_probs, n_experts, top_k, capacity_factor):
        out = list(real(gate_probs, n_experts, top_k, capacity_factor))
        out[0] = torch.topk(gate_probs, top_k, dim=-1).values
        return tuple(out)

    moe._route = faulty
    try:
        yield
    finally:
        moe._route = real


def rank_moe_train():
    """One rank of moe_train: the MoE LM with ``moe_impl='ep'`` over a
    2-rank flat communicator, ``create_multi_node_optimizer(AdamW)`` and
    ``lm_train_step`` on this rank's 2 x 1024 tokens of a 4 x 1024 global
    batch, beside the same weights as a one-process ``moe_impl='gshard'``
    LM trained alike on the global batch; the planted fault (top-2 weights
    left unrenormalised) on one more first step; then 3 steps at the
    default capacity factor."""
    import torch

    from chainermn_torch import create_communicator, create_multi_node_optimizer
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    comm = create_communicator("flat", device=dev)
    n, r, b = comm.size, comm.rank, MOE["batch"]
    n_steps = MOE["warmup_steps"] + MOE["timed_steps"]
    tokens, targets = _lm_batch(dev, n * b, MOE["seq_len"], LM["vocab_size"],
                                SEED + 11)
    mine = slice(r * b, (r + 1) * b)
    ref_drops = []
    ref_losses, ref_grads = _reference_run(
        _moe_lm(MOE["n_layers"], moe_impl="gshard",
                moe_capacity_factor=MOE["parity_capacity"]),
        tokens, targets, n_steps, ref_drops)
    torch.cuda.empty_cache()

    def ep(capacity):
        model = _moe_lm(MOE["n_layers"], moe_axis=comm,
                        moe_capacity_factor=capacity)
        opt = create_multi_node_optimizer(torch.optim.AdamW(
            model.parameters(), lr=TRAIN["lr"],
            weight_decay=TRAIN["weight_decay"]), comm)
        return model, lm_train_step(model, opt, comm)

    model, step = ep(MOE["parity_capacity"])
    with _top2_unrenormalised():
        step(tokens[mine], targets[mine])
    fault = _grad_error(_model_grads(model), ref_grads)
    del model, step
    torch.cuda.empty_cache()
    model, step = ep(MOE["parity_capacity"])
    out = {"one_process_losses": ref_losses,
           "one_process_moe_drop_frac": ref_drops,
           "ep": _train_run(model, step, tokens[mine], targets[mine],
                            MOE["warmup_steps"], MOE["timed_steps"], _staged,
                            lambda: _grad_error(_model_grads(model),
                                                ref_grads))}
    out["ep"]["planted_fault_grad_err"] = fault
    del model, step
    torch.cuda.empty_cache()
    model, step = ep(1.25)
    out["default_capacity"] = _train_run(
        model, step, tokens[mine], targets[mine], 1, MOE["drop_steps"] - 1,
        _staged, lambda: None)
    comm.finalize()
    return out


def phase_moe_train(card):
    """The MoE LM's expert-parallel training on 2 ranks of the card
    (``rank_moe_train``). Fails unless nothing dropped at the parity
    capacity (EP and reference), every EP loss is finite, the pre-update
    loss within ``first_loss_tol`` and every loss within ``loss_tol`` of
    the one-process gshard LM's trained alike, the first
    step's global gradient within ``grad_rel_tol`` of its and the planted
    fault's not, every attention call of the 4 steps went through the
    flash kernels (6 launches of each a step, one a layer), and the 3
    steps at the default capacity gave finite losses and drop
    fractions."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_moe_train", MOE["ranks"])
    n_steps = MOE["warmup_steps"] + MOE["timed_steps"]
    want = n_steps * MOE["n_layers"]
    emit({"phase": "moe_train", "card": card, "ranks": MOE["ranks"],
          "backend": "gloo",
          "model": dict(LM, n_layers=MOE["n_layers"], compute_dtype="bf16",
                        attention="flash", moe_experts=MOE["experts"],
                        moe_top_k=MOE["top_k"], moe_every=2, moe_impl="ep"),
          "train": dict(MOE, lr=TRAIN["lr"],
                        weight_decay=TRAIN["weight_decay"]),
          "reduced": f"{MOE['n_layers']} of the 12 layers "
                     f"({MOE['n_layers'] // 2} MoE blocks); the 220M LM's "
                     "widths",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    for rk in ranks:
        rec = rk["ep"]
        drops = rec["moe_drop_frac"] + rk["one_process_moe_drop_frac"]
        if any(d != 0 for d in drops):
            raise AssertionError(f"moe_train: tokens dropped at the parity "
                                 f"capacity {MOE['parity_capacity']}: {drops}")
        _check_losses_and_grads("moe_train", rec, rk["one_process_losses"],
                                MOE)
        if any(v != want for v in rec["launches"].values()):
            raise AssertionError(f"moe_train: flash launches "
                                 f"{rec['launches']} != {want} each")
        dflt = rk["default_capacity"]
        if not all(math.isfinite(x) for x in dflt["losses"] +
                   dflt["moe_drop_frac"]):
            raise AssertionError(f"moe_train: default capacity {dflt}")
    return ranks


def _check_losses_and_grads(name, rec, ref_losses, tol, fault=True):
    """Finite losses within ``loss_tol`` of the one-process run's, the
    first step's gradient within ``grad_rel_tol``, and (``fault``) the
    planted fault's gradient outside it."""
    losses = rec["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if abs(losses[0] - ref_losses[0]) > tol.get("first_loss_tol", math.inf):
        raise AssertionError(f"{name}: pre-update loss {losses[0]} vs one "
                             f"process's {ref_losses[0]}")
    if max(abs(x - y) for x, y in zip(losses, ref_losses)) > tol["loss_tol"]:
        raise AssertionError(f"{name}: losses {losses} vs one process's "
                             f"{ref_losses}")
    if rec["grad_err"]["max_rel"] > tol["grad_rel_tol"]:
        raise AssertionError(f"{name}: first step's gradient off one "
                             f"process's: {rec['grad_err']}")
    fault = rec.get("planted_fault_grad_err") if fault else None
    if fault is not None and fault["max_rel"] <= tol["grad_rel_tol"]:
        raise AssertionError(f"{name}: the planted fault passes the gradient "
                             f"gate: {fault}")


@contextlib.contextmanager
def _dispatch_grads_unsummed():
    """A planted fault: Megatron's *f* on the gshard dispatch's payload
    and combine weights left out, so each rank's backward keeps only its
    own experts' share of their gradients."""
    from chainermn_torch.parallel import moe

    real = moe.copy_to_parallel_region
    moe.copy_to_parallel_region = lambda x, comm: x
    try:
        yield
    finally:
        moe.copy_to_parallel_region = real


def rank_gspmd_train():
    """One rank of gspmd_train: the MoE LM with ``moe_impl='gshard'`` cut
    to the Megatron layout over tp = 2 (``megatron_shard``), plain AdamW
    over the shards and ``gspmd_lm_train_step`` on the whole 4 x 1024
    batch, beside the replicated model trained alike in one process; the
    first step's gradient of every leaf against the replicated model's
    same shard, and a planted fault's (``_dispatch_grads_unsummed``, one
    more first step); the stored parameter and optimizer fractions."""
    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.parallel import gspmd

    dev = torch.device("cuda", 0)
    comm = create_communicator("flat", device=dev)
    n = comm.size
    n_steps = MOE["warmup_steps"] + MOE["timed_steps"]
    tokens, targets = _lm_batch(dev, MOE["ranks"] * MOE["batch"],
                                MOE["seq_len"], LM["vocab_size"], SEED + 11)
    ref_drops = []
    kw = dict(moe_impl="gshard", moe_capacity_factor=MOE["parity_capacity"])
    ref_losses, ref_grads = _reference_run(_moe_lm(GSPMD_LAYERS, **kw),
                                           tokens, targets, n_steps,
                                           ref_drops)
    torch.cuda.empty_cache()
    def sharded():
        model = gspmd.megatron_shard(_moe_lm(GSPMD_LAYERS, **kw), comm)
        opt = torch.optim.AdamW(model.parameters(), lr=TRAIN["lr"],
                                weight_decay=TRAIN["weight_decay"])
        return model, opt, gspmd.gspmd_lm_train_step(model, opt, comm)

    def grad_err():
        return _grad_error({k: p.grad for k, p in model.named_parameters()},
                           want_grads)

    model, opt, step = sharded()
    want_grads = gspmd.shard_state_dict(ref_grads, model._megatron_specs,
                                        comm.rank, n, LM["n_heads"])
    with _dispatch_grads_unsummed():
        step(tokens, targets)
    fault = grad_err()
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step = sharded()
    out = {"one_process_losses": ref_losses,
           "one_process_moe_drop_frac": ref_drops,
           "gspmd": _train_run(
               model, step, tokens, targets, MOE["warmup_steps"],
               MOE["timed_steps"], _staged, grad_err)}
    out["gspmd"]["planted_fault_grad_err"] = fault
    out["gspmd"]["stored_fraction"] = gspmd.stored_fraction(model, opt)
    out["gspmd"]["one_over_n"] = 1 / n
    comm.finalize()
    return out


def phase_gspmd_train(card):
    """The gshard MoE LM in the weights-at-rest Megatron layout over tp = 2
    ranks of the card (``rank_gspmd_train``). Fails unless the pre-update
    loss is within ``first_loss_tol`` and all 7 losses within
    ``loss_tol`` of the replicated model's trained alike in one process
    (the dry run's b5 check), every shard's first-step gradient within
    ``grad_rel_tol`` of the replicated model's and the planted fault's
    not, the stored parameter and optimizer fractions at most 1/2 plus
    the replicated leaves' share, and every attention call on the flash
    kernels (GSPMD_LAYERS launches of each a step)."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_gspmd_train", MOE["ranks"])
    want = (MOE["warmup_steps"] + MOE["timed_steps"]) * GSPMD_LAYERS
    emit({"phase": "gspmd_train", "card": card, "ranks": MOE["ranks"],
          "backend": "gloo",
          "model": dict(LM, n_layers=GSPMD_LAYERS, compute_dtype="bf16",
                        attention="flash", moe_experts=MOE["experts"],
                        moe_top_k=MOE["top_k"], moe_impl="gshard",
                        layout="megatron, tp=2",
                        moe_capacity_factor=MOE["parity_capacity"]),
          "tolerances": GSPMD_TOL,
          "reduced": f"{GSPMD_LAYERS} of the 220M LM's 12 layers, its "
                     "widths",
          "launches_want": want, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    for rk in ranks:
        rec = rk["gspmd"]
        _check_losses_and_grads("gspmd_train", rec, rk["one_process_losses"],
                                GSPMD_TOL)
        frac = rec["stored_fraction"]
        bound = rec["one_over_n"] + frac["replicated_share"]
        if frac["params"] > bound or frac["opt"] > bound:
            raise AssertionError(f"gspmd_train: stores {frac}, more than "
                                 f"1/n plus the replicated share ({bound})")
        if any(v != want for v in rec["launches"].values()):
            raise AssertionError(f"gspmd_train: flash launches "
                                 f"{rec['launches']} != {want} each")
    return ranks


def _pp_modules(stage: int):
    import torch

    from chainermn_torch.ops import init_pipeline_lm, make_pipeline_lm

    mods = make_pipeline_lm(LM["vocab_size"], LM["d_model"], LM["n_heads"],
                            PP["stages"], d_ff=LM["d_ff"],
                            max_len=LM["max_len"],
                            compute_dtype=torch.bfloat16,
                            device=torch.device("cuda", 0))
    init_pipeline_lm(mods, SEED, stage)
    return mods


def _pp_batch():
    import torch

    return _lm_batch(torch.device("cuda", 0),
                     PP["microbatches"] * PP["micro_batch"], PP["seq_len"],
                     LM["vocab_size"], SEED + 12)


def _pp_reference(path: Path) -> list:
    """The four stages as one sequential stack in this process, trained
    ``PP['steps']`` AdamW steps on the whole batch: its losses and first
    step's gradients, saved to ``path`` for the ranks."""
    import torch
    import torch.nn.functional as F

    stages = [_pp_modules(s) for s in range(PP["stages"])]
    embed, head = stages[0][0], stages[0][2]
    blocks = [m[1] for m in stages]
    params = [p for m in (embed, *blocks, head) for p in m.parameters()]
    opt = torch.optim.AdamW(params, lr=TRAIN["lr"],
                            weight_decay=TRAIN["weight_decay"])
    tokens, targets = _pp_batch()
    losses, grads = [], None
    for _ in range(PP["steps"]):
        opt.zero_grad(set_to_none=True)
        x = embed(tokens)
        for blk in blocks:
            x = blk(x)
        logits = head(x)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
        loss.backward()
        del logits, x
        if grads is None:
            grads = {"embed": {n: p.grad.detach().cpu() for n, p in
                               embed.named_parameters()},
                     "head": {n: p.grad.detach().cpu() for n, p in
                              head.named_parameters()},
                     "blocks": [{n: p.grad.detach().cpu() for n, p in
                                 blk.named_parameters()} for blk in blocks]}
        opt.step()
        losses.append(float(loss))
    torch.save({"losses": losses, "grads": grads}, path)
    del stages, embed, head, blocks, params, opt
    torch.cuda.empty_cache()
    return losses


@contextlib.contextmanager
def _embed_grad_unsummed():
    """A planted fault: the pipeline step's sum of the embedding gradient
    over the ranks left out (each rank keeps its own: rank 0's whole
    gradient, the others' zeros)."""
    import torch

    from chainermn_torch.ops import pipeline

    real = pipeline._reduce_grads

    def faulty(params, comm, op):
        if op != "sum":
            return real(params, comm, op)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    pipeline._reduce_grads = faulty
    try:
        yield
    finally:
        pipeline._reduce_grads = real


def rank_pp_train(ref_path):
    """One rank of pp_train: its stage of the 4-stage pipelined LM,
    ``pp_lm_opt_init(AdamW)`` and ``jit_pp_lm_train_step`` (8 microbatches,
    remat) on the whole batch; the planted fault on one more first step;
    the first step's gradients (embedding, this rank's block, head)
    against the sequential stack's."""
    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.ops import jit_pp_lm_train_step, pp_lm_opt_init

    dev = torch.device("cuda", 0)
    comm = create_communicator("naive", device=dev)
    r = comm.rank
    ref = torch.load(ref_path, weights_only=False)
    want = {**{f"embed.{k}": v for k, v in ref["grads"]["embed"].items()},
            **{f"block.{k}": v for k, v in ref["grads"]["blocks"][r].items()},
            **{f"head.{k}": v for k, v in ref["grads"]["head"].items()}}
    want = {k: v.to(dev) for k, v in want.items()}
    tokens, targets = _pp_batch()

    def build():
        mods = _pp_modules(r)
        opt = pp_lm_opt_init(lambda ps: torch.optim.AdamW(
            ps, lr=TRAIN["lr"], weight_decay=TRAIN["weight_decay"]), mods)
        step = jit_pp_lm_train_step(mods, opt, comm, PP["microbatches"])
        return mods, lambda tok, tgt: (step(tok, tgt), {})

    def grads(mods):
        return {f"{part}.{k}": p.grad for part, m in
                zip(("embed", "block", "head"), mods)
                for k, p in m.named_parameters()}

    mods, step = build()
    with _embed_grad_unsummed():
        step(tokens, targets)
    fault = _grad_error(grads(mods), want)
    del mods, step
    torch.cuda.empty_cache()
    mods, step = build()
    rec = _train_run(mods[1], step, tokens, targets, 1, PP["steps"] - 1,
                     _staged, lambda: _grad_error(grads(mods), want))
    rec["planted_fault_grad_err"] = fault
    comm.finalize()
    return {"pp": rec, "one_process_losses": ref["losses"], "rank": r}


def phase_pp_train(card):
    """The 220M LM's width as a 4-stage GPipe pipeline on 4 ranks of the
    card (``rank_pp_train``; the sequential reference runs in this process
    first, in gloo_batch when that ran the ranks). Fails unless the first
    (pre-update) loss and every later one are within ``loss_tol`` of the
    unpipelined four-block stack's trained
    alike (the dry run's b6 check), every rank's first-step gradients
    within ``grad_rel_tol`` of it, and the planted fault (the embedding
    gradient left unsummed) fails that gate."""
    t0 = time.perf_counter()
    path = ROOT / "build" / "pp_reference.pt"
    ref_losses = _PP_REF.pop("losses", None)     # gloo_batch's reference
    if ref_losses is None:
        path.parent.mkdir(exist_ok=True)
        ref_losses = _pp_reference(path)
    ranks = _gloo_ranks("rank_pp_train", PP["stages"], str(path))
    path.unlink(missing_ok=True)
    emit({"phase": "pp_train", "card": card, "ranks": PP["stages"],
          "backend": "gloo",
          "model": dict(vocab_size=LM["vocab_size"], d_model=LM["d_model"],
                        n_heads=LM["n_heads"], d_ff=LM["d_ff"],
                        stages=PP["stages"], attention="full",
                        compute_dtype="bf16"),
          "train": dict(PP, lr=TRAIN["lr"],
                        weight_decay=TRAIN["weight_decay"]),
          "reduced": "4 blocks, one a stage (the 220M LM has 12)",
          "bubble_fraction": (PP["stages"] - 1)
          / (PP["microbatches"] + PP["stages"] - 1),
          "one_process_losses": ref_losses,
          "run_s": time.perf_counter() - t0, "ranks_out": ranks})
    for rk in ranks:       # rank 0 holds the whole embedding gradient
        _check_losses_and_grads("pp_train", rk["pp"], ref_losses, PP,
                                fault=False)
    if all(rk["pp"]["planted_fault_grad_err"]["max_rel"] <= PP["grad_rel_tol"]
           for rk in ranks):
        raise AssertionError("pp_train: the planted fault passes the "
                             "gradient gate on every rank")
    return ranks


def phase_lm_fused_remat(device, card):
    """``lm_train_step(fused_ce=True)`` and ``TransformerLM(remat=True)``,
    each alone and both, on the 220M dense flash LM (bf16, seed 0), one
    NCCL rank, FUSED's batch, against the plain step on the same weights.
    Fails unless every config's losses are finite and within ``loss_tol``
    of the plain step's, and under remat the flash forward launches twice
    a layer and step while dq and dk/dv launch once."""
    import torch

    from chainermn_torch import create_communicator, create_multi_node_optimizer
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.training import lm_train_step

    t0 = time.perf_counter()
    comm = create_communicator("pure_nccl", device=device)
    tokens, targets = _lm_batch(device, FUSED["batch"], FUSED["seq_len"],
                                LM["vocab_size"], SEED)
    configs = {}
    for fused, remat in ((False, False), (True, False), (False, True),
                         (True, True)):
        model = TransformerLM(**LM, attention="flash", remat=remat,
                              compute_dtype=torch.bfloat16, device=device,
                              seed=SEED)
        opt = create_multi_node_optimizer(torch.optim.AdamW(
            model.parameters(), lr=TRAIN["lr"],
            weight_decay=TRAIN["weight_decay"]), comm)
        step = lm_train_step(model, opt, comm, fused_ce=fused)
        step(tokens, targets)                  # AdamW's state allocated
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _zero_flash_counts()
        t1 = time.perf_counter()
        losses = [step(tokens, targets)[0] for _ in range(FUSED["steps"])]
        losses = [float(x) for x in losses]
        configs[f"fused_ce={fused},remat={remat}"] = {
            "losses": losses,
            "step_ms": (time.perf_counter() - t1) / FUSED["steps"] * 1e3,
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated(device) / 1e9,
            "launches": _flash_counts()}
        del model, opt, step
        torch.cuda.empty_cache()
    comm.finalize()
    plain = configs["fused_ce=False,remat=False"]["losses"]
    for rec in configs.values():
        rec["max_loss_diff"] = max(abs(a - b)
                                   for a, b in zip(rec["losses"], plain))
    emit({"phase": "lm_fused_remat", "card": card,
          "model": dict(LM, compute_dtype="bf16", attention="flash"),
          "train": dict(FUSED, lr=TRAIN["lr"],
                        weight_decay=TRAIN["weight_decay"]),
          "reduced": "none", "run_s": time.perf_counter() - t0,
          "configs": configs})
    per = FUSED["steps"] * LM["n_layers"]
    for name, rec in configs.items():
        if not all(math.isfinite(x) for x in rec["losses"]) or \
                rec["max_loss_diff"] > FUSED["loss_tol"]:
            raise AssertionError(f"lm_fused_remat {name}: {rec['losses']} vs "
                                 f"the plain step's {plain}")
        fwd = 2 * per if name.endswith("remat=True") else per
        want = {"flash_fwd": fwd, "flash_dq": per, "flash_dkv": per}
        if rec["launches"] != want:
            raise AssertionError(f"lm_fused_remat {name}: flash launches "
                                 f"{rec['launches']} != {want}")
    return configs


# the async loop and the recovery boundary on the train cell: its LM,
# optimizer and batch shape over 14 distinct seeded [8, 2048] batches
# (runs a-c take the first 12; the resumed launch the last 2)
FIT = dict(steps=12, batches=14, fetch_every=8, prefetch_depth=2,
           warmup_steps=2, profile_steps=4, save_every=6, fault_at=8,
           resume_to=14, n_retains=2)


def _fit_setup(device, comm):
    """The train phase's LM, AdamW and ``lm_train_step`` over ``comm``,
    the batches as host arrays, and ``reset()``, which puts the model and
    the optimizer back to their initial state (a device clone)."""
    import copy

    import numpy as np
    import torch

    from chainermn_torch import create_multi_node_optimizer
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.training import lm_train_step

    model = TransformerLM(**LM, attention="flash",
                          compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    comm.bcast_data(model)
    opt = create_multi_node_optimizer(torch.optim.AdamW(
        model.parameters(), lr=TRAIN["lr"],
        weight_decay=TRAIN["weight_decay"]), comm)
    step = lm_train_step(model, opt, comm)
    gen = torch.Generator().manual_seed(SEED + 20)
    tokens = torch.randint(0, LM["vocab_size"],
                           (FIT["batches"], TRAIN["batch"],
                            TRAIN["seq_len"]), generator=gen).numpy()
    targets = np.roll(tokens, -1, axis=2)
    init_model = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    init_opt = copy.deepcopy(opt.state_dict())      # no state yet

    def reset():
        model.load_state_dict(init_model)
        opt.load_state_dict(init_opt)
        torch.cuda.synchronize()

    return dict(model=model, opt=opt, step=step, tokens=tokens,
                targets=targets, reset=reset)


def _device_idle(fn, n_steps):
    """``fn()`` (``n_steps`` steps, closed by a device-to-host fetch)
    under ``torch.profiler``: host wall ms a step, device busy ms a step
    (CUDA activity without user annotations) and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    return {"step_wall_ms": wall / n_steps * 1e3,
            "step_device_busy_ms": busy_us / n_steps / 1e3 if busy_us
            else "not measured",
            "device_idle_share": 1 - busy_us / 1e6 / wall if busy_us
            else "not measured"}


def _sync_calls(step, tokens, targets, device):
    """One step on batches the device prefetcher delivered, under
    ``torch.cuda.set_sync_debug_mode("warn")``: where it synchronized."""
    import warnings

    import torch

    from chainermn_torch.dataflow import DevicePrefetcher

    with DevicePrefetcher(iter([(tokens, targets)]), depth=1,
                          device=device) as pre:
        x, y = next(pre)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(x, y)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own notice that it is a prototype is not a sync
    return sorted({f"{Path(w.filename).name}:{w.lineno}: "
                   f"{str(w.message)[:80]}" for w in caught
                   if "synchroniz" in str(w.message)
                   and "prototype" not in str(w.message)})


def _tracer_host_us():
    """Host microseconds of one traced step's tracer work (a train_step
    trace with its two spans), over 2000 steps on a private tracer."""
    from chainermn_torch.monitor.trace import Tracer

    tr = Tracer(sample=1, ring=256)
    t0 = time.perf_counter()
    for i in range(2000):
        with tr.trace("train_step", kind="train", step=i, loop="bench"):
            with tr.span("prefetch_wait"):
                pass
            with tr.span("dispatch"):
                pass
    return (time.perf_counter() - t0) / 2000 * 1e6


def phase_train_fit(device, card, comm):
    """``training.fit`` on the train cell (the 220M LM, ``flash``, bf16
    over f32, AdamW, the one-rank NCCL ``comm``): from one device clone of
    the initial state, three runs of FIT['steps'] steps over the same
    distinct seeded batches — (a) the synchronous loop, one ``float(loss)``
    a step, twice; (b) ``fit(fetch_every=8, prefetch_depth=2)`` with the
    tracer at ``sample=1``; (c) the same at ``sample=0``. Fails unless
    (b)'s and (c)'s losses equal (a)'s bit for bit, each of (b) and (c)
    fetched the losses ceil(12/8) = 2 times, B1-B3 launched 12 x 12 times
    in every run, every retained step trace of (b) has ``prefetch_wait``
    and ``dispatch`` and floor(12/8) = 1 of them ``loss_fetch`` (the
    closing drain runs after the last step's trace), and (c) retains
    nothing. Prints each run's wall ms a step (closed by the fetch), the
    device idle share of (a) and (b) over FIT['profile_steps'] profiled
    steps, the tracer's host cost a step ((b) - (c), and a host-only
    measure) and where a (b) step synchronizes."""
    import torch

    from chainermn_torch.monitor import get_registry, get_tracer
    from chainermn_torch.training import fit

    t_phase = time.perf_counter()
    ctx = _fit_setup(device, comm)
    step, reset = ctx["step"], ctx["reset"]
    tokens, targets = ctx["tokens"], ctx["targets"]
    n, every = FIT["steps"], FIT["fetch_every"]
    batches = [(tokens[i], targets[i]) for i in range(n)]
    for _ in range(FIT["warmup_steps"]):           # allocator, cuBLAS
        float(step(tokens[0], targets[0])[0])
    tracer = get_tracer()
    fetch_ctr = get_registry().counter("loss_fetch_total",
                                       {"loop": "train_fit"})

    def sync_run():
        losses = []
        for i in range(n):
            loss, _ = step(tokens[i], targets[i])
            losses.append(float(loss))
        return losses

    runs, traces = {}, {}
    for name, sample in (("a", None), ("a_repeat", None), ("b", 1),
                         ("c", 0)):
        reset()
        if sample is not None:
            tracer.configure(sample=sample)
            tracer.clear()
        _zero_flash_counts()
        f0 = fetch_ctr.value
        t0 = time.perf_counter()
        if sample is None:
            losses = sync_run()
        else:
            losses = fit(step, iter(batches), n, fetch_every=every,
                         prefetch_depth=FIT["prefetch_depth"], device=device,
                         name="train_fit")
        wall = time.perf_counter() - t0
        runs[name] = {"losses": losses, "step_ms": wall / n * 1e3,
                      "launches": _flash_counts(),
                      "loss_fetches": fetch_ctr.value - f0}
        if sample is not None:
            traces[name] = [[s.name for s in t.spans]
                            for t in tracer.finished(kind="train")]
    tracer.configure(sample=1)
    reset()
    k = FIT["profile_steps"]
    idle = {"a": _device_idle(
        lambda: [float(step(tokens[i], targets[i])[0]) for i in range(k)],
        k)}
    reset()
    idle["b"] = _device_idle(
        lambda: fit(step, iter(batches[:k]), k, fetch_every=every,
                    prefetch_depth=FIT["prefetch_depth"], device=device,
                    name="train_fit_profile"), k)
    syncs = _sync_calls(step, tokens[0], targets[0], device)
    want = {name: n * LM["n_layers"] for name in FLASH_KERNELS}
    b_traces = traces["b"]
    rec = {"phase": "train_fit", "card": card,
           "model": dict(LM, attention="flash", compute_dtype="bf16"),
           "train": dict(TRAIN, **FIT), "communicator": repr(comm),
           "runs": runs, "losses_bit_equal": {
               name: runs[name]["losses"] == runs["a"]["losses"]
               for name in ("a_repeat", "b", "c")},
           "first_diff_step": {
               name: next((i for i, (x, y) in enumerate(zip(
                   runs[name]["losses"], runs["a"]["losses"])) if x != y),
                   None) for name in ("a_repeat", "b", "c")},
           "profiled": idle,
           "tracer_host_ms_per_step_b_minus_c":
               runs["b"]["step_ms"] - runs["c"]["step_ms"],
           "tracer_host_us_per_step_alone": _tracer_host_us(),
           "b_traces": len(b_traces),
           "b_spans_per_trace": sorted({len(t) for t in b_traces}),
           "b_traces_with_loss_fetch": sum("loss_fetch" in t
                                           for t in b_traces),
           "c_traces": len(traces["c"]), "sync_calls_in_a_b_step": syncs,
           "launches_want": want, "run_s": time.perf_counter() - t_phase}
    emit(rec)
    for name in ("b", "c"):
        if runs[name]["losses"] != runs["a"]["losses"]:
            raise AssertionError(f"train_fit ({name}): losses "
                                 f"{runs[name]['losses']} != the "
                                 f"synchronous loop's {runs['a']['losses']}")
        if runs[name]["loss_fetches"] != -(-n // every):
            raise AssertionError(f"train_fit ({name}): "
                                 f"{runs[name]['loss_fetches']} loss "
                                 f"fetches for {n} steps at {every}")
    for name, r in runs.items():
        if r["launches"] != want:
            raise AssertionError(f"train_fit ({name}): flash launches "
                                 f"{r['launches']} != {want}")
    if len(b_traces) != n or not all(
            t[:3] == ["train_step", "prefetch_wait", "dispatch"]
            or t[:4] == ["train_step", "prefetch_wait", "prefetch_stall",
                         "dispatch"] for t in b_traces):
        raise AssertionError(f"train_fit (b): step traces {b_traces}")
    if rec["b_traces_with_loss_fetch"] != n // every:
        raise AssertionError(f"train_fit (b): "
                             f"{rec['b_traces_with_loss_fetch']} traces "
                             f"with a loss_fetch, want {n // every}")
    if traces["c"]:
        raise AssertionError(f"train_fit (c): sample=0 retained "
                             f"{len(traces['c'])} traces")
    ctx["losses_a"] = runs["a"]["losses"]
    return ctx, rec


def phase_train_resilient(device, card, comm, ctx):
    """``resilient_fit`` over the train_fit model and batches (batch i at
    step i, device-resident): FIT['steps'] steps with ``save_every=6``
    and ``async_save=True`` on a ``MultiNodeCheckpointer`` in a temporary
    directory under ``build/`` (deleted at the end), a ``FaultInjector``
    raise at ``trainer.step`` step 8 (restored from snapshot 6), then a
    second ``resilient_fit`` on the same directory to 14 steps. Fails
    unless the per-step losses equal train_fit's synchronous loop's bit
    for bit, the report reads failures 1, restores 1, resumed_from 0, the
    second launch resumes from 12, B1-B3 launched (12 + 2 replayed + 2)
    x 12 times, and the planted fault (snapshot 6's model and optimizer
    with snapshot 0's iterator) changes the losses. Prints MTTR, the
    snapshot bytes, the ``host_state`` copy s on the critical path (the
    ``checkpoint_enqueue`` spans) and ``get_stats``' save and load s."""
    import os
    import tempfile

    import torch

    from chainermn_torch import SerialIterator, create_multi_node_checkpointer
    from chainermn_torch.extensions.checkpoint import to_tensors
    from chainermn_torch.monitor import get_tracer
    from chainermn_torch.resilience import FaultInjector, resilient_fit

    t_phase = time.perf_counter()
    model, opt, step = ctx["model"], ctx["opt"], ctx["step"]
    tokens = torch.as_tensor(ctx["tokens"], device=device)
    targets = torch.as_tensor(ctx["targets"], device=device)
    n = FIT["steps"]

    def live(loss):
        # the live tensors: the checkpointer's host_state copies them
        # before save_async returns
        return {"model": model.state_dict(), "optimizer": opt.state_dict(),
                "loss": loss}

    def step_fn(state, sel):
        i = int(sel[0])
        return live(step(tokens[i], targets[i])[0])

    def restore_hook(state):
        model.load_state_dict(to_tensors(state["model"]))
        opt.load_state_dict(to_tensors(state["optimizer"]))
        return live(state["loss"])

    def iterator():
        return SerialIterator(list(range(FIT["batches"])), batch_size=1)

    (ROOT / "build").mkdir(exist_ok=True)
    path = tempfile.mkdtemp(prefix="train_resilient_", dir=ROOT / "build")
    tracer = get_tracer()
    tracer.configure(sample=1)
    try:
        ctx["reset"]()
        tracer.clear()
        _zero_flash_counts()
        ckpt = create_multi_node_checkpointer(
            "train_resilient", comm, path=path, n_retains=FIT["n_retains"])
        inj = FaultInjector(seed=0)
        inj.arm("trainer.step", kind="raise", after=FIT["fault_at"],
                times=1)
        losses = {}
        t0 = time.perf_counter()
        with inj:
            _, report = resilient_fit(
                step_fn, live(None), iterator(), n, ckpt,
                save_every=FIT["save_every"], async_save=True,
                restore_hook=restore_hook,
                on_step=lambda i, s: losses.__setitem__(i, s["loss"]))
        run_s = time.perf_counter() - t0
        launches = _flash_counts()
        got = [float(losses[i]) for i in range(n)]
        enqueue = [s.duration_s for t in tracer.finished(kind="train")
                   for s in t.spans if s.name == "checkpoint_enqueue"]
        snap_bytes = os.path.getsize(ckpt.filename(n))
        stats = ckpt.get_stats()
        # the planted fault: snapshot 6's state with snapshot 0's iterator
        restore_hook(ckpt._try_load(FIT["save_every"])["state"]["state"])
        it = iterator()
        planted = []
        for _ in range(2):
            i = int(next(it)[0])
            planted.append(float(step(tokens[i], targets[i])[0]))
        ckpt._shutdown_writer()         # its snapshots stay for the resume
        _zero_flash_counts()
        ckpt2 = create_multi_node_checkpointer(
            "train_resilient", comm, path=path, n_retains=FIT["n_retains"])
        more = {}
        t0 = time.perf_counter()
        _, report2 = resilient_fit(
            step_fn, live(None), iterator(), FIT["resume_to"], ckpt2,
            save_every=FIT["save_every"], async_save=True,
            restore_hook=restore_hook,
            on_step=lambda i, s: more.__setitem__(i, float(s["loss"])))
        resume_s = time.perf_counter() - t0
        launches = {k: v + _flash_counts()[k] for k, v in launches.items()}
        stats2 = ckpt2.get_stats()
        ckpt2.finalize()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    replayed = FIT["fault_at"] - FIT["save_every"]
    steps_run = n + replayed + (FIT["resume_to"] - n)
    want = {name: steps_run * LM["n_layers"] for name in FLASH_KERNELS}
    rec = {"phase": "train_resilient", "card": card,
           "model": dict(LM, attention="flash", compute_dtype="bf16"),
           "train": dict(TRAIN, **FIT), "losses": got,
           "losses_bit_equal": got == ctx["losses_a"],
           "report": report, "mttr_s": report["mttr_s"],
           "run_s": run_s, "snapshot_bytes": snap_bytes,
           "host_state_copy_s": enqueue,
           "checkpoint_stats": stats, "resume": {
               "report": report2, "losses": more, "run_s": resume_s,
               "checkpoint_stats": stats2},
           "planted_fault_losses": planted,
           "planted_fault_want": ctx["losses_a"][FIT["save_every"]:
                                                 FIT["save_every"] + 2],
           "launches": launches, "launches_want": want,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    if got != ctx["losses_a"]:
        raise AssertionError(f"train_resilient: losses {got} != the "
                             f"synchronous loop's {ctx['losses_a']}")
    if (report["failures"], report["restores"],
            report["resumed_from"]) != (1, 1, 0):
        raise AssertionError(f"train_resilient: report {report}")
    if report2["resumed_from"] != n or report2["failures"] or \
            sorted(more) != list(range(n, FIT["resume_to"])):
        raise AssertionError(f"train_resilient: the second launch "
                             f"{report2} {more}")
    if launches != want:
        raise AssertionError(f"train_resilient: flash launches {launches} "
                             f"!= {want}")
    if planted == rec["planted_fault_want"]:
        raise AssertionError("train_resilient: snapshot 6 with snapshot "
                             "0's iterator reproduces the losses")
    del ctx["model"], ctx["opt"], ctx["step"], model, opt, step
    _empty()
    return rec


def _time_engine_calls(engine, box):
    """Sum into ``box["s"]`` the host seconds of the engine's device
    calls that the cost ledger books (a decode round that ran, an
    admission's prefill, a chunk); returns an undo."""
    names = ("decode_round", "admit_batch", "prefill_chunk")
    for name in names:
        real = getattr(engine, name)

        def timed(*args, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(*args, **kw)
            if out or _name != "decode_round":
                box["s"] += time.perf_counter() - t0
            return out

        setattr(engine, name, timed)

    def undo():
        for name in names:
            delattr(engine, name)

    return undo


def _time_ledger(box):
    """Sum into ``box`` the host seconds and calls of every cost-ledger
    booking the scheduler makes (its decode split with the block-seconds
    read, and each ``CostLedger`` method it calls outside that); returns
    an undo."""
    from chainermn_torch.monitor.costs import CostLedger
    from chainermn_torch.serving.scheduler import FCFSScheduler

    patched = []
    for cls, names in ((FCFSScheduler, ("_book_decode",)),
                       (CostLedger, ("record_prefill", "record_queue_wait",
                                     "record_migration", "note_preempt",
                                     "finalize", "flush",
                                     "tenant_device_seconds"))):
        for name in names:
            real = getattr(cls, name)

            def timed(*args, _real=real, **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kw)
                finally:
                    box["s"] += time.perf_counter() - t0
                    box["calls"] += 1

            setattr(cls, name, timed)
            patched.append((cls, name, real))

    def undo():
        for cls, name, real in patched:
            setattr(cls, name, real)

    return undo


def _ledger_pairs(runs) -> dict:
    """Tokens/s and TPOT p50 of the untraced runs ledger off and on, in
    the order off, on, on, off (a drift across the four cancels to first
    order): each run's figure and the means."""
    out = {}
    for key in ("tokens_per_sec", "tpot_p50_s"):
        for side in ("off", "on"):
            vals = [runs[f"ledger_{side}"][key],
                    runs[f"ledger_{side}_2"][key]]
            out[f"{key}_{side}"] = vals
            out[f"{key}_{side}_mean"] = sum(vals) / 2
        out[f"{key}_change"] = (out[f"{key}_on_mean"]
                                / out[f"{key}_off_mean"] - 1)
    return out


def phase_serve_trace(device, card):
    """The serve cell's LM and engine (captured, the kernel on) serving
    its 32 greedy requests with a tracer at ``sample=0`` and at
    ``sample=1``, alternating (off, on, off, on), every run with the
    scheduler's cost ledger (the default); then, tracer off, runs with
    ``cost_accounting=False`` and with it on in the order off, on, on,
    off (the ledger's cost), and one more with the ledger's bookings
    timed (its host ms a step).
    Fails unless the token streams are identical, the compile counts stay
    flat, B4 launches = decode calls x 12 in every run, every retained
    trace reads ``request -> queue -> admit -> prefill ->
    decode_step...`` with a finish reason, ``ServingMetrics``'
    ``critical_path`` is present when on, the runs at ``sample=0`` record
    nothing, and every ledger conserves (error < 1e-6) with its measured
    seconds between the engine calls' summed windows and the steps'
    summed host time. Prints tokens/s and TPOT p50 traced and not, and
    ledger off and on."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.monitor import get_registry
    from chainermn_torch.monitor.trace import Tracer
    from chainermn_torch.parallel.paged_kernel import paged_attend
    from chainermn_torch.serving import ServingEngine

    t_phase = time.perf_counter()
    model = TransformerLM(**LM, compute_dtype=torch.bfloat16, device=device,
                          seed=SEED)
    eng = ServingEngine(model, paged=True, paged_kernel=True, device=device,
                        **ENGINE)
    eng.warmup()
    counts = eng.compile_counts_detailed()
    calls_ctr = get_registry().counter(
        "serving_decode_steps_total",
        {"engine": "serving", "paged_kernel": "on"})
    work = _serve_traffic(N_REQUESTS, SEED)
    runs, streams, ledger_box = {}, {}, {"s": 0.0, "calls": 0}
    for name, sample, ledger in (
            ("off", 0, True), ("on", 1, True), ("off_2", 0, True),
            ("on_2", 1, True), ("ledger_off", 0, False),
            ("ledger_on", 0, True), ("ledger_on_2", 0, True),
            ("ledger_off_2", 0, False), ("ledger_timed", 0, True)):
        tracer = Tracer(sample=sample, ring=256)
        c0 = calls_ctr.value
        paged_attend.launches = 0
        windows, step_s = {"s": 0.0}, []
        undo = [_time_engine_calls(eng, windows)]
        if name == "ledger_timed":
            undo.append(_time_ledger(ledger_box))
        try:
            streams[name], sched, wall = _drive(
                eng, work, step_s=step_s,
                sched_kw={"tracer": tracer, "cost_accounting": ledger})
        finally:
            for fn in undo:
                fn()
        rep = sched.metrics.report()
        traces = tracer.finished(kind="serving")
        costs = rep.get("costs")
        runs[name] = {
            "ledger": ledger,
            "ledger_device_time": costs["device_time"] if costs else None,
            "ledger_tenants": sorted(costs["tenants"]) if costs else None,
            "engine_call_windows_s": windows["s"],
            "steps": len(step_s), "steps_host_s": sum(step_s),
            "wall_s": wall, "tokens_per_sec": rep["tokens_per_sec"],
            "tpot_p50_s": rep["tpot_p50_s"], "ttft_p50_s": rep["ttft_p50_s"],
            "decode_calls": calls_ctr.value - c0,
            "kernel_launches": paged_attend.launches,
            "traces": len(traces),
            "spans_per_request": sorted(len(t.spans) for t in traces),
            "dropped_spans": sum(t.dropped_spans for t in traces),
            "reasons": sorted({t.root.labels.get("reason") for t in traces}),
            "bad_trees": [t.trace_id for t in traces
                          if [s.name for s in t.spans][:4] != [
                              "request", "queue", "admit", "prefill"]
                          or {s.name for s in t.spans[4:]}
                          - {"decode_step"}],
            "critical_path": rep.get("critical_path")}
    rec = {"phase": "serve_trace", "card": card,
           "model": dict(LM, compute_dtype="bf16"),
           "engine": dict(ENGINE, paged_kernel=True, capture=eng.capture),
           "requests": N_REQUESTS, "runs": runs,
           "ledger_cost": dict(_ledger_pairs(runs), **{
               "booking_host_ms_per_step": (
                   ledger_box["s"] / runs["ledger_timed"]["steps"] * 1e3),
               "booking_calls_per_step": (
                   ledger_box["calls"] / runs["ledger_timed"]["steps"]),
               "step_host_ms": (runs["ledger_timed"]["steps_host_s"]
                                / runs["ledger_timed"]["steps"] * 1e3)}),
           "compile_counts": counts,
           "compile_counts_after": eng.compile_counts_detailed(),
           "run_s": time.perf_counter() - t_phase}
    emit(rec)
    del eng, model
    _empty()
    first = streams["off"]
    for name, r in runs.items():
        if streams[name] != first:
            raise AssertionError(f"serve_trace {name}: the streams differ "
                                 "from the untraced run's")
        if r["kernel_launches"] != r["decode_calls"] * LM["n_layers"]:
            raise AssertionError(f"serve_trace {name}: kernel launches "
                                 f"{r['kernel_launches']} != "
                                 f"{r['decode_calls']} x {LM['n_layers']}")
        dt = r["ledger_device_time"]
        if (dt is None) == r["ledger"]:
            raise AssertionError(f"serve_trace {name}: ledger "
                                 f"{'missing' if r['ledger'] else 'present'}")
        if dt is not None and not (
                dt["conservation_error"] < 1e-6
                and dt["max_dispatch_error"] < 1e-6
                and 0 < r["engine_call_windows_s"] <= dt["measured_s"]
                + 1e-6 <= r["steps_host_s"] + 2e-6):
            raise AssertionError(f"serve_trace {name}: the ledger: {dt}, "
                                 f"engine calls {r['engine_call_windows_s']}"
                                 f" s, steps {r['steps_host_s']} s")
        if name.startswith("on"):
            if (r["traces"] != N_REQUESTS or r["bad_trees"]
                    or r["reasons"] != ["length"]
                    or r["critical_path"] is None):
                raise AssertionError(f"serve_trace {name}: {r}")
        elif r["traces"] or r["critical_path"] is not None:
            raise AssertionError(f"serve_trace {name}: sample=0 recorded "
                                 f"{r['traces']} traces")
    if rec["compile_counts_after"] != counts or set(counts.values()) != {1}:
        raise AssertionError(f"serve_trace: programs rebuilt: {counts} -> "
                             f"{rec['compile_counts_after']}")
    return rec


def rank_pconv(epochs):
    """One rank of parallel_conv: the channel-parallel twin's ``main``
    with ``--check`` for ``epochs`` epochs on the card, then the planted
    fault (two channels of this rank's pconv2 slice swapped) through the
    same parity check: the twin's summary, with what was added."""
    import contextlib
    import io

    import torch

    from chainermn_torch import create_communicator
    from chainermn_torch.examples.parallel_convolution import (
        train_parallel_conv as twin)

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = twin.main(["--device", "cuda", "--check", "--epoch",
                             str(epochs)])
    summary["run_s"] = time.perf_counter() - t0
    summary["printed"] = buf.getvalue().splitlines()
    comm = create_communicator("tpu", device="cuda")
    full = twin.init_params(32, 10, 0)
    local = twin.shard_params(full, comm.rank, comm.size, comm.device)
    with torch.no_grad():
        w = local["pconv2.weight"]
        w[[0, 1]] = w[[1, 0]].clone()
    x, _ = twin.synthetic_cifar(2048, 32, 10)
    try:
        twin.parity_error(full, local, x[:64], comm)
        summary["planted_fault_failed"] = False
    except AssertionError:
        summary["planted_fault_failed"] = True
    comm.finalize()
    return summary


def phase_parallel_conv(card):
    """The channel-parallel convolution twin's ``main()`` at its own
    defaults but PCONV_EPOCHS epochs, with ``--check``, on 2 ranks as processes on the card over
    gloo (every collective staged through the host). Fails unless rank 0
    prints ``parity check OK``, every rank's parity error is within 2e-4
    and its epoch losses are finite and fall, and the planted fault (two
    channels of a shard's kernel swapped) fails the check on every rank.
    Prints ms a step and the share of it staged through the host."""
    t0 = time.perf_counter()
    ranks = _gloo_ranks("rank_pconv", 2, str(PCONV_EPOCHS))
    for rk in ranks:
        ms = sorted(rk.pop("step_ms"))
        rk["step_ms_p50"] = ms[len(ms) // 2]
        rk["staged_share_of_steps"] = rk["staged_s"] / (sum(ms) / 1e3)
    emit({"phase": "parallel_conv", "card": card, "ranks": 2,
          "backend": "gloo", "defaults": "batch 64, 2048 images of 32x32, "
          "10 classes", "epochs": PCONV_EPOCHS, "run_s": time.perf_counter() - t0,
          "ranks_out": ranks})
    if not any("parity check OK" in ln for ln in ranks[0]["printed"]):
        raise AssertionError(f"parallel_conv: {ranks[0]['printed']}")
    for rk in ranks:
        losses = rk["epoch_losses"]
        if not (rk["parity_max_abs_err"] <= 2e-4
                and all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"parallel_conv: {rk}")
        if not rk["planted_fault_failed"]:
            raise AssertionError("parallel_conv: the swapped channels pass "
                                 "the parity check")
    return ranks


def phase_lm_example(card):
    """The LM trainer twin's ``main()`` in this process on one NCCL rank,
    3 iterations at its own defaults, in the MoE mode (8 experts, top-2,
    flash), the pipeline mode (one stage), the ``fit`` mode (``flash``,
    ``--fetch-every 4 --prefetch-depth 2 --trace-out``) and the resilient
    mode (``flash``, ``--resume --inject-fault 2 --async-save`` in a
    temporary directory under ``build/``). Fails unless each finishes
    with finite losses; the MoE and fit modes' attention went through the
    flash kernels 3 x 2 times, the resilient mode's (3 + 2 replayed) x 2
    times; the trace file is Chrome JSON with the 3 steps' span trees;
    and the resilient run recovered once."""
    import tempfile

    from chainermn_torch.examples.lm import train_lm
    from chainermn_torch.monitor import get_tracer

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lm_example_", dir=ROOT / "build")
    trace_out = str(Path(tmp) / "trace.json")
    modes = dict(LM_EXAMPLE,
                 fit=["--attention", "flash", "--fetch-every", "4",
                      "--prefetch-depth", "2", "--trace-out", trace_out],
                 resilient=["--attention", "flash", "--resume",
                            "--inject-fault", "2", "--async-save",
                            "--checkpoint-dir", str(Path(tmp) / "ckpt")])
    out = {}
    try:
        for name, extra in modes.items():
            t0 = time.perf_counter()
            _zero_flash_counts()
            get_tracer().clear()      # the file holds this mode's traces
            res = train_lm.main(["--iterations", "3", *extra])
            out[name] = dict(res, run_s=time.perf_counter() - t0,
                             launches=_flash_counts())
        events = json.loads(Path(trace_out).read_text())["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sorted(e["args"]["step"] for e in events
                   if e["ph"] == "X" and e["name"] == "train_step")
    emit({"phase": "lm_example", "card": card, "modes": modes,
          "trace_out_steps": steps, "out": out})
    for name, res in out.items():
        if len(res["losses"]) != 3 or not all(math.isfinite(x)
                                              for x in res["losses"]):
            raise AssertionError(f"lm_example {name}: losses {res['losses']}")
    for name, n_steps in (("moe", 3), ("fit", 3), ("resilient", 5)):
        if any(v != n_steps * 2 for v in out[name]["launches"].values()):
            raise AssertionError(f"lm_example {name}: flash launches "
                                 f"{out[name]['launches']} != "
                                 f"{n_steps * 2} each")
    if steps != [0, 1, 2]:
        raise AssertionError(f"lm_example fit: traced steps {steps}")
    rep = out["resilient"]["report"]
    if (rep["failures"], rep["restores"]) != (1, 1):
        raise AssertionError(f"lm_example resilient: {rep}")
    return out


# -- sharded state end to end: tensor-parallel serving on the head-sharded
#    paged store, the sharded checkpointer and the elastic resharded
#    restore (ranks as processes on cuda:0 over gloo) ----------------------

# serve_tp: the serve LM and engine at tp = 2 (eager: a gloo step cannot
# be captured), the serve cell's first 16 requests; its f32 twin at 2 of
# the 12 layers, 8 requests
SERVE_TP = dict(tp=2, requests=16, window_steps=8, f32_layers=2,
                f32_requests=8, f32_max_new=32)
# ... its bf16 LM at 4 of the 12 layers: a decode step's host-staged
# collectives scale with the layers (12 layers took 25-41 s of the pair's
# time for the 16 requests)
SERVE_TP_LM = dict(LM, n_layers=4)
# B4 on a rank's local-head store: tp = 2 and tp = 4 of the 16 heads
LOCAL_HEADS = (8, 4)
# reshard: the train LM at 2 layers (SP_LM) in f32, AdamW; train at
# tp = 2, snapshot, restore at tp = 4; the batch cut to [2, 2048], the
# served requests' budgets to 16 tokens
RESHARD = dict(train_tp=2, serve_tp=4, steps=3, batch=2, seq_len=2048,
               lr=TRAIN["lr"], weight_decay=TRAIN["weight_decay"], eps=1e-5,
               loss_tol=1e-4, requests=8, spawn_requests=4, max_new=16)


@contextlib.contextmanager
def _store_heads_rolled():
    """A planted fault: every rank writes its K/V rows into the store one
    head over (head h's rows land in head h + 1's place), so each rank
    attends all its heads' rows of a wrongly sliced store."""
    from chainermn_torch.parallel import sequence

    real = sequence.update_cache_and_attend

    def faulty(kv_cache, q, k, v, pos_offset, **kw):
        return real(kv_cache, q, k.roll(1, dims=2), v.roll(1, dims=2),
                    pos_offset, **kw)

    sequence.update_cache_and_attend = faulty
    try:
        yield
    finally:
        sequence.update_cache_and_attend = real


def _tp_serve_lead(engine, work, comm_bytes):
    """The leader's drive of ``work``: a plain scheduler stepped dry; once
    every request is admitted, ``SERVE_TP['window_steps']`` pure decode
    steps are timed (staged bytes and seconds a step) and one more is
    profiled. Returns the streams, the metrics report and the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chainermn_torch.monitor import get_registry
    from chainermn_torch.serving import FCFSScheduler

    steps_ctr = get_registry().counter(
        "serving_decode_steps_total",
        {"engine": "serving", "paged_kernel": "on"})
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(p, n) for p, n in work]
    steps0 = steps_ctr.value
    window = profiled = None
    t0 = time.perf_counter()
    while sched.has_work:
        if window is None and not sched.queue_depth \
                and engine.active_slots == len(work):
            torch.cuda.synchronize()
            st0, ch0 = _staged(), comm_bytes()
            w0 = time.perf_counter()
            for _ in range(SERVE_TP["window_steps"]):
                sched.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            st1 = _staged()
            n = SERVE_TP["window_steps"]
            window = {
                "steps": n, "active_slots": engine.active_slots,
                "step_ms": wall / n * 1e3,
                "staged_bytes_per_step": (st1["bytes"] - st0["bytes"]) / n,
                "staged_share_of_step": (st1["seconds"] - st0["seconds"])
                / wall,
                "operand_bytes_per_step": (comm_bytes() - ch0) / n}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                p0 = time.perf_counter()
                sched.step()
                torch.cuda.synchronize()
                p_wall = time.perf_counter() - p0
            busy = sum(e.self_device_time_total
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)) / 1e3
            profiled = {"step_wall_ms": p_wall * 1e3,
                        "device_busy_ms": busy if busy else "not measured",
                        "device_idle_share": 1 - busy / 1e3 / p_wall
                        if busy else "not measured"}
            continue
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not (r.finished and r.error is None
                and len(r.tokens) == r.max_new_tokens):
            raise AssertionError(f"serve_tp request {r.id} did not serve "
                                 f"cleanly: {r.state} {r.error}")
    rep = sched.metrics.report()
    return ([[int(t) for t in r.tokens] for r in reqs],
            {"wall_s": wall, "tokens_per_sec": rep["tokens_per_sec"],
             "tpot_p50_s": rep["tpot_p50_s"], "ttft_p50_s": rep["ttft_p50_s"],
             "decode_steps": steps_ctr.value - steps0,
             "window": window, "profiled_step": profiled})


def _tp_engine_run(engine, lead, work, comm_bytes=None):
    """One TP engine's run on this rank: the leader warms it, drives
    ``work`` and closes it; a follower replays. The paged-decode launch
    count is zeroed first and read after, beside the decode programs
    this rank ran."""
    from chainermn_torch.parallel.paged_kernel import paged_attend

    paged_attend.launches = 0
    if lead:
        engine.warmup()
        warm = paged_attend.launches       # warmup's decode: counted apart
        paged_attend.launches = 0
        streams, rec = _tp_serve_lead(engine, work,
                                      comm_bytes or (lambda: 0))
        engine.close()
        rec.update(kernel_launches=paged_attend.launches,
                   warmup_launches=warm, decode_runs=rec["decode_steps"])
        return streams, rec
    runs = engine.follow()
    return None, {"kernel_launches": paged_attend.launches,
                  "decode_runs": runs.get("decode", 0), "runs": runs}


def rank_serve_tp():
    """One rank of serve_tp: the serve LM (bf16, 4 layers) at tp = 2 with
    the vocab-parallel head in the paged engine, eager, the paged-decode
    kernel on every decode step over this rank's 8 local heads; rank 0
    serves the serve cell's first 16 requests, rank 1 follows. Then the
    f32 twin honest and with the store's heads rolled (planted)."""
    import torch

    from chainermn_torch import MeshCommunicator
    from chainermn_torch.models import TransformerLM, generate
    from chainermn_torch.parallel.mesh import make_3d_mesh
    from chainermn_torch.serving import ServingEngine

    dev = torch.device("cuda", 0)
    comm = MeshCommunicator(make_3d_mesh(shape=(1, 1, SERVE_TP["tp"])),
                            device=dev)
    lead = comm.axis_index("tp") == 0
    tp_kw = dict(tensor_axis="tp", vocab_parallel_head=True, device=dev)
    out = {"rank": comm.rank}
    model = TransformerLM(**SERVE_TP_LM, **tp_kw,
                          compute_dtype=torch.bfloat16, seed=SEED)
    engine = ServingEngine(model, paged=True, paged_kernel=True,
                           capture=False, comm=comm, device=dev, **ENGINE)
    work = _serve_traffic(N_REQUESTS, SEED)[:SERVE_TP["requests"]]
    channel = engine.tp_channel
    _, out["bf16"] = _tp_engine_run(engine, lead, work,
                                    lambda: channel.operand_bytes)
    out["bf16"]["local_heads"] = engine._heads
    out["bf16"]["store_shape"] = list(engine._store[0]["k"].shape)
    del engine, model
    _empty()

    f32_lm = dict(LM, n_layers=SERVE_TP["f32_layers"])
    small = [(p, min(n, SERVE_TP["f32_max_new"])) for p, n in
             _serve_traffic(SERVE_TP["f32_requests"], SEED + 16)]
    model = TransformerLM(**f32_lm, **tp_kw, compute_dtype=torch.float32,
                          seed=SEED + 16)
    dense = (_dense_from_tp(model, SERVE_TP["tp"], device=dev) if lead
             else None)
    want = None
    if lead:
        want = [generate(dense, p[None], n)[0, len(p):].tolist()
                for p, n in small]
    for name, fault in (("honest", contextlib.nullcontext),
                        ("planted_fault", _store_heads_rolled)):
        engine = ServingEngine(model, paged=True, paged_kernel=True,
                               capture=False, comm=comm, device=dev,
                               **ENGINE)
        with fault():
            got, rec = _tp_engine_run(engine, lead, small)
        if lead:
            rec["parity"] = _parity(dense, small, got, want)
        out[f"f32_{name}"] = rec
        del engine
    comm.finalize()
    return out


def _b4_local_heads(device, lengths, h):
    """B4 on a rank's local-head store (``h`` of the 16 heads) at the
    serve phase's decode lengths and the engine's full 128-entry table:
    kernel, plain version and SDPA on the gathered store, L2 flushed."""
    import torch
    import torch.nn.functional as F

    from chainermn_torch.parallel.paged_kernel import (
        paged_attend,
        paged_attend_reference,
        split_plan,
    )

    d, bs = LM["d_model"] // LM["n_heads"], 16
    full_w = ENGINE["cache_len"] // bs
    n_blocks = ENGINE["n_slots"] * full_w + 1
    gen = torch.Generator().manual_seed(SEED + 3 + h)
    x = make_paged_inputs(lengths, s_len=1, h=h, d=d, bs=bs,
                          dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                          gen=gen, device=device, n_blocks=n_blocks)
    b, span = len(lengths), x["table"].shape[1]
    wide = torch.zeros((b, full_w), dtype=torch.int32, device=device)
    wide[:, :span] = x["table"]
    args = (x["q"], x["k"], x["v"], wide, x["lengths"])
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device=device).zero_
    n0 = paged_attend.launches
    want = paged_attend_reference(*args).float()
    err = float((paged_attend(*args).float() - want).abs().max())
    ms = cuda_ms(lambda: paged_attend(*args), flush=flush)
    plain_ms = cuda_ms(lambda: paged_attend_reference(*args), flush=flush)
    paged_attend.launches = n0
    flat = x["table"].reshape(-1).long()
    mask = (torch.arange(span * bs, device=device)[None, :]
            <= (x["lengths"].long() - 1)[:, None])[:, None, None, :]

    def library():
        kk = x["k"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        vv = x["v"].index_select(0, flat).view(b, -1, h, d).transpose(1, 2)
        return F.scaled_dot_product_attention(x["q"].transpose(1, 2), kk,
                                              vv, attn_mask=mask)

    library_ms = cuda_ms(library, flush=flush)
    kv_rows = sum(lengths)
    n_bytes = (x["q"].numel() * 2 * 2 + kv_rows * h * d * 2 * 2
               + sum(-(-n // bs) for n in lengths) * 4 + b * 4)
    n_ops = 4 * kv_rows * h * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_OPS_PER_S * 1e3
    return {"H": h, "B": b, "D": d, "table_width": full_w,
            "split_plan": split_plan(b, h, full_w, bs),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bytes": n_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "ms_per_head": ms / h}


def phase_serve_tp(device, card, lengths):
    """Tensor-parallel serving on the card (``rank_serve_tp`` on 2 ranks):
    tokens/s, TPOT p50, the staged bytes and share of a decode step and
    one profiled step, beside the single-card eager engine on the same 16
    requests in this process (SERVE_TP_LM: 4 of the 12 layers); B4
    launches = decode steps x 4 on each rank; the f32 twin's streams equal
    solo ``generate`` of the dense LM on the converted weights (near-ties aside), and the planted fault
    must fail that gate. Then B4 against its plain version and SDPA on a
    rank's local-head store at tp = 2 and tp = 4."""
    import torch

    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = TransformerLM(**SERVE_TP_LM, compute_dtype=torch.bfloat16,
                          device=device, seed=SEED)
    engine = ServingEngine(model, paged=True, paged_kernel=True,
                           capture=False, device=device, **ENGINE)
    engine.warmup()
    work = _serve_traffic(N_REQUESTS, SEED)[:SERVE_TP["requests"]]
    _, sched, wall = _drive(engine, work)
    rep = sched.metrics.report()
    single = {"tokens_per_sec": rep["tokens_per_sec"],
              "tpot_p50_s": rep["tpot_p50_s"], "wall_s": wall}
    del engine, model, sched
    _empty()
    ranks = _gloo_ranks("rank_serve_tp", SERVE_TP["tp"])
    local = {str(h): _b4_local_heads(device, lengths, h)
             for h in LOCAL_HEADS}
    lead = next(r for r in ranks if r["rank"] == 0)
    rec = {"phase": "serve_tp", "card": card, "ranks": SERVE_TP["tp"],
           "backend": "gloo", "capture": False,
           "model": dict(SERVE_TP_LM, compute_dtype="bf16",
                         tensor_parallel=2, vocab_parallel_head=True),
           "engine": dict(ENGINE, paged_kernel=True),
           "requests": SERVE_TP["requests"],
           "reduced": "4 of the 12 layers; the serve cell's first 16 of 32 "
                      "requests, eager; f32 twin at 2 of the 12 layers, 8 "
                      "requests of at most 32 new tokens",
           "single_card_eager": single,
           "tp_over_single_tokens_per_sec":
               lead["bf16"]["tokens_per_sec"] / single["tokens_per_sec"],
           "ranks_out": ranks, "b4_local_heads": local,
           "run_s": time.perf_counter() - t0}
    emit(rec)
    for r in ranks:
        b = r["bf16"]
        n_layers = SERVE_TP_LM["n_layers"]
        if b["kernel_launches"] != b["decode_runs"] * n_layers \
                or not b["decode_runs"]:
            raise AssertionError(f"serve_tp rank {r['rank']}: B4 launches "
                                 f"{b['kernel_launches']} != decode steps "
                                 f"{b['decode_runs']} x {n_layers}")
        if r["f32_honest"]["kernel_launches"] != \
                r["f32_honest"]["decode_runs"] * SERVE_TP["f32_layers"]:
            raise AssertionError(f"serve_tp f32 rank {r['rank']}: launches")
    follower = next(r for r in ranks if r["rank"] != 0)
    if follower["bf16"]["decode_runs"] != lead["bf16"]["decode_runs"] + 1:
        raise AssertionError("serve_tp: the follower ran other decode steps "
                             "than the leader (+1 for warmup)")
    _check_parity("serve_tp f32", lead["f32_honest"]["parity"])
    if not lead["f32_planted_fault"]["parity"]["failures"]:
        raise AssertionError("serve_tp: the planted store fault passed the "
                             "parity gate")
    for h, r in local.items():
        if r["max_abs_err"] > TOL["bf16"][1]:
            raise AssertionError(f"B4 at {h} local heads: max abs err "
                                 f"{r['max_abs_err']}")
    return rec


@contextlib.contextmanager
def _qkv_not_permuted():
    """A planted fault: the elastic restore skips the qkv permutation (a
    tp = 2 snapshot loaded as if it were tp = 4's)."""
    from chainermn_torch.deploy import reshard

    real = reshard._permute_qkv
    reshard._permute_qkv = lambda tree, *a: 1
    try:
        yield
    finally:
        reshard._permute_qkv = real


def _reshard_lm(n_tp_axis, device, seed=None):
    """reshard's LM; ``seed=None`` (no host draw) for a model whose every
    parameter a restore then replaces."""
    import torch

    from chainermn_torch.models import TransformerLM

    return TransformerLM(**SP_LM, attention="flash", tensor_axis=n_tp_axis,
                         vocab_parallel_head=True,
                         compute_dtype=torch.float32, device=device,
                         seed=seed)


def _reshard_opt(model):
    import torch

    return torch.optim.AdamW(model.parameters(), lr=RESHARD["lr"],
                             weight_decay=RESHARD["weight_decay"],
                             eps=RESHARD["eps"])


def rank_reshard_train(ckpt):
    """One rank of reshard's first half: the train LM at 2 layers in f32,
    tp = 2, AdamW, 3 steps on the flash kernels; the train state saved
    with ``ShardedCheckpointer`` and ``snapshot_meta``; then a 4th step
    in place (the loss the resharded run must match)."""
    import torch

    from chainermn_torch import MeshCommunicator
    from chainermn_torch.deploy import snapshot_meta, train_state_dict
    from chainermn_torch.extensions import ShardedCheckpointer
    from chainermn_torch.parallel.mesh import make_3d_mesh
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    comm = MeshCommunicator(make_3d_mesh(shape=(1, 1, RESHARD["train_tp"])),
                            device=dev)
    model = _reshard_lm("tp", dev, SEED + 17)
    opt = _reshard_opt(model)
    step = lm_train_step(model, opt, comm)
    b, t, n = RESHARD["batch"], RESHARD["seq_len"], RESHARD["steps"]
    batches = [_lm_batch(dev, b, t, LM["vocab_size"], SEED + 20 + i)
               for i in range(n + 1)]
    _zero_flash_counts()
    losses = [float(step(*batches[i])[0]) for i in range(n)]
    launches = _flash_counts()
    cp = ShardedCheckpointer(ckpt, keep=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp.save(n, train_state_dict(model, opt),
            meta=snapshot_meta(comm=comm, model=model))
    save_s = time.perf_counter() - t0
    written = sum(f.stat().st_size for f in (Path(ckpt) / str(n)).iterdir())
    continued = float(step(*batches[n])[0])
    comm.finalize()
    return {"rank": comm.rank, "losses": losses, "launches": launches,
            "save_s": save_s, "bytes_written": written,
            "continued_loss": continued, "manifest": cp.manifest()}


def rank_reshard_serve(ckpt):
    """One rank of reshard's second half, tp = 4: restore the train state
    with ``restore_train_state`` and serve the restored weights in a TP
    paged engine (8 requests, f32, against solo ``generate`` of a tp = 1
    restore), then take the 4th training step; the same with the qkv
    permutation left out (planted). Rank 0 then spawns a tp = 1 replica
    from the snapshot into a ``FleetRouter`` and serves 4 requests."""
    import torch

    from chainermn_torch import MeshCommunicator, create_communicator
    from chainermn_torch.deploy import elastic_restore, restore_train_state
    from chainermn_torch.extensions import ShardedCheckpointer
    from chainermn_torch.fleet import FleetRouter
    from chainermn_torch.models import generate
    from chainermn_torch.parallel.mesh import make_3d_mesh
    from chainermn_torch.serving import ServingEngine
    from chainermn_torch.training import lm_train_step

    dev = torch.device("cuda", 0)
    base = create_communicator("naive", device=dev)
    solo = base.split(base.rank)             # a one-rank tensor axis
    comm = MeshCommunicator(make_3d_mesh(shape=(1, 1, RESHARD["serve_tp"])),
                            device=dev)
    lead = comm.axis_index("tp") == 0
    cp = ShardedCheckpointer(ckpt)
    # rank 0's own restores (the reference, the spawned replica) read the
    # snapshot alone: over its one-rank group
    cp_solo = ShardedCheckpointer(ckpt, process_group=solo.group)
    b, t, n = RESHARD["batch"], RESHARD["seq_len"], RESHARD["steps"]
    batch = _lm_batch(dev, b, t, LM["vocab_size"], SEED + 20 + n)
    work = [(p, min(n, RESHARD["max_new"])) for p, n in
            _serve_traffic(RESHARD["requests"], SEED + 18)]
    out = {"rank": comm.rank}
    want = ref = None
    if lead:                 # solo generate of a tp = 1 restore
        one = _reshard_lm(solo, dev)
        elastic_restore(cp_solo, {"params": one.state_dict()}, model=one)
        ref = _dense_from_tp(one, 1, attention="flash", device=dev)
        want = [generate(ref, p[None], m)[0, len(p):].tolist()
                for p, m in work]
        del one
    for name, fault in (("honest", contextlib.nullcontext),
                        ("planted_fault", _qkv_not_permuted)):
        model = _reshard_lm("tp", dev)
        opt = _reshard_opt(model)
        torch.cuda.synchronize()
        comm.barrier()               # rank 0's reference is done
        t0 = time.perf_counter()
        with fault():
            state, got_step = restore_train_state(cp, model=model,
                                                  optimizer=opt, comm=comm)
        torch.cuda.synchronize()
        rec = {"load_s": time.perf_counter() - t0, "step": got_step}
        engine = ServingEngine(model, paged=True, paged_kernel=True,
                               capture=False, comm=comm, device=dev,
                               **ENGINE)
        got, srec = _tp_engine_run(engine, lead, work)
        del engine
        if lead:
            rec["parity"] = _parity(ref, work, got, want)
        rec["serve"] = srec
        model.train()
        step = lm_train_step(model, opt, comm)
        _zero_flash_counts()
        rec["loss"] = float(step(*batch)[0])
        rec["launches"] = _flash_counts()
        out[name] = rec
        del model, opt, step, state
        _empty()
    if lead:
        router_model = _reshard_lm(solo, dev)
        spawn = {}
        first = ServingEngine(ref, paged=True, paged_kernel=True,
                              capture=False, device=dev, **ENGINE)
        with FleetRouter([first]) as router:
            t0 = time.perf_counter()
            replica = router.spawn_replica(
                checkpoint=cp_solo,
                params_template=router_model.state_dict(),
                model=router_model,
                engine_factory=lambda params: ServingEngine(
                    router_model, paged=True, paged_kernel=True,
                    capture=False, comm=solo, device=dev, **ENGINE),
                timeout=120)
            spawn["ready_s"] = time.perf_counter() - t0
            router.retire_replica(0, timeout=120)    # only the spawned one
            hs = [router.submit(p, m) for p, m in
                  work[:RESHARD["spawn_requests"]]]
            for h in hs:
                if not h.wait(120):
                    raise AssertionError(f"spawned replica: request {h.id} "
                                         "timed out")
            streams = [[int(x) for x in h.tokens] for h in hs]
            spawn["served_by"] = sorted({h.replica_id for h in hs})
            spawn["replica"] = replica.replica_id
        spawn["parity"] = _parity(ref, work[:RESHARD["spawn_requests"]],
                                  streams,
                                  want[:RESHARD["spawn_requests"]])
        out["spawn"] = spawn
    comm.finalize()
    solo.finalize()
    base.finalize()
    return out


def phase_reshard(card):
    """Train at tp = 2, snapshot, restore at tp = 4 (``rank_reshard_train``
    on 2 ranks, then ``rank_reshard_serve`` on 4, over gloo on the card):
    the resharded 4th step's loss must match the tp = 2 run continued in
    place to 1e-4 in f32 and the restored TP engine's f32 streams must
    equal solo ``generate`` of a tp = 1 restore (near-ties aside); with
    the qkv permutation left out both gates must fail. B1-B3 launches =
    steps x 2 layers on each rank; B4 = decode steps x 2 in the engine;
    the tp = 1 replica spawned from the snapshot serves its 4 requests
    equal to the same reference."""
    import tempfile

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = _RESHARD_SNAP.pop("dir", None) or tempfile.mkdtemp(
        prefix="reshard_", dir=ROOT / "build")
    try:
        train = _gloo_ranks("rank_reshard_train", RESHARD["train_tp"],
                            str(Path(tmp) / "snap"))
        serve = _gloo_ranks("rank_reshard_serve", RESHARD["serve_tp"],
                            str(Path(tmp) / "snap"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lead = next(r for r in serve if r["rank"] == 0)
    want_loss = train[0]["continued_loss"]
    rec = {"phase": "reshard", "card": card, "backend": "gloo",
           "model": dict(SP_LM, compute_dtype="f32", vocab_parallel_head=True,
                         attention="flash"),
           "config": RESHARD,
           "reduced": f"{SP_LM['n_layers']} of the 12 layers (as tp_train); "
                      "batch [2, 2048]; "
                      f"8 served requests of at most {RESHARD['max_new']} "
                      "new tokens",
           "train": train, "serve": serve,
           "loss_diff": abs(lead["honest"]["loss"] - want_loss),
           "planted_fault_loss_diff":
               abs(lead["planted_fault"]["loss"] - want_loss),
           "run_s": time.perf_counter() - t0}
    emit(rec)
    n_layers = SP_LM["n_layers"]
    for r in train:
        if any(v != RESHARD["steps"] * n_layers for v in
               r["launches"].values()):
            raise AssertionError(f"reshard train rank {r['rank']}: flash "
                                 f"launches {r['launches']}")
        if r["manifest"]["tp_degree"] != RESHARD["train_tp"]:
            raise AssertionError(f"reshard: manifest {r['manifest']}")
    for r in serve:
        h = r["honest"]
        if any(v != n_layers for v in h["launches"].values()):
            raise AssertionError(f"reshard serve rank {r['rank']}: flash "
                                 f"launches {h['launches']}")
        s = h["serve"]
        if s["kernel_launches"] != s["decode_runs"] * n_layers \
                or not s["decode_runs"]:
            raise AssertionError(f"reshard serve rank {r['rank']}: B4 "
                                 f"launches {s['kernel_launches']} != "
                                 f"{s['decode_runs']} x {n_layers}")
    if not rec["loss_diff"] <= RESHARD["loss_tol"]:
        raise AssertionError(f"reshard: resharded loss off by "
                             f"{rec['loss_diff']}")
    if not rec["planted_fault_loss_diff"] > RESHARD["loss_tol"]:
        raise AssertionError("reshard: the unpermuted restore passed the "
                             "loss gate")
    _check_parity("reshard", lead["honest"]["parity"])
    if not lead["planted_fault"]["parity"]["failures"]:
        raise AssertionError("reshard: the unpermuted restore passed the "
                             "parity gate")
    _check_parity("reshard spawn", lead["spawn"]["parity"])
    if lead["spawn"]["served_by"] != [lead["spawn"]["replica"]]:
        raise AssertionError(f"reshard spawn: served by "
                             f"{lead['spawn']['served_by']}")
    return rec


def _exit_now(code: int) -> None:
    """Kill this process's child processes, then end the process at once
    with ``code``: a thread that still runs cannot hold the exit up."""
    import os
    import signal

    sys.stdout.flush()
    me = os.getpid()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            ppid = int(stat.read_text().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                os.kill(int(stat.parent.name), signal.SIGKILL)
        except (OSError, ValueError, IndexError):
            continue
    os._exit(code)


def _start_watchdog() -> None:
    """A daemon thread that ends the process with exit 1 at WATCHDOG_S of
    wall time, naming the phase still running: a phase that hangs in
    this process then fails with its name instead of being cut."""
    import threading

    def watch():
        time.sleep(max(0.0, WATCHDOG_S - (time.monotonic() - T_START)))
        msg = (f"chip_smoke: phase {_RUNNING['phase']!r} still running at "
               f"{time.monotonic() - T_START:.1f} s of wall time "
               f"(watchdog {WATCHDOG_S:.0f} s)")
        print(msg, flush=True)
        print(msg, file=sys.stderr, flush=True)
        _exit_now(1)

    threading.Thread(target=watch, name="chip_smoke-watchdog",
                     daemon=True).start()


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
    _keep_seeded_weights()
    seconds, f32_launches = {}, {}
    _start_watchdog()

    def timed(name, fn, *args):
        elapsed = time.monotonic() - T_START
        if elapsed > DEADLINE_S:
            print(f"chip_smoke: past the {DEADLINE_S:.0f} s deadline at "
                  f"{elapsed:.1f} s, before phase {name!r} (the last to "
                  f"end: {_RUNNING['phase']!r})", file=sys.stderr,
                  flush=True)
            _exit_now(1)
        emit({"phase_start": name, "elapsed_s": round(elapsed, 3)})
        _RUNNING["phase"] = name
        t0 = time.perf_counter()
        before = _f32_flash_launches()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        after = _f32_flash_launches()
        if after != before:
            f32_launches[name] = {n: after[n] - before[n] for n in after}
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    parity_err = timed("parity", phase_parity, device)
    launches, lengths, _ = timed("serve", phase_serve, device)
    timing = timed("timing", phase_timing, device, lengths)
    timed("engine_parity", phase_engine_parity, device)
    spec = timed("serve_spec", phase_serve_spec, device, smi)
    window = timed("serve_window", phase_serve_window, device, smi)
    timed("serve_chunked", phase_serve_chunked, device, smi)
    timed("serve_dense", phase_serve_dense, device, smi)
    graphs = timed("serve_graphs", phase_serve_graphs, device, smi)
    timed("serve_restart_swap", phase_serve_restart_swap, device, smi)
    fleet = timed("serve_fleet", phase_serve_fleet, device, smi)
    control = timed("serve_control", phase_serve_control, device, smi)
    traced = timed("serve_trace", phase_serve_trace, device, smi)
    timed("serve_example", phase_serve_example, smi)
    flash_err = timed("flash_parity", phase_flash_parity, device)
    timed("flash_ring_blocks", phase_flash_ring_blocks, device)
    flash_launches, comm = timed("train", phase_train, device)
    flash_timing = timed("flash_timing", phase_flash_timing, device)
    timed("train_parity", phase_train_parity, device)
    d256 = timed("lm_d256", phase_lm_d256, device, smi, comm)
    wide = timed("lm_wide", phase_lm_wide, device, smi, comm)
    fit_ctx, fit_rec = timed("train_fit", phase_train_fit, device, smi, comm)
    resilient = timed("train_resilient", phase_train_resilient, device, smi,
                      comm, fit_ctx)
    del fit_ctx
    comm.finalize()
    dp = timed("dp_train", phase_dp_train, device)
    timed("dp_parity", phase_dp_parity, device)
    timed("imagenet", phase_imagenet, device, dp["images_per_sec"], smi)
    timed("mnist", phase_mnist, device, smi)
    timed("mnist_checkpoint", phase_mnist_checkpoint, smi)
    timed("gloo_batch", phase_gloo_batch, smi)
    timed("mnist_mp", phase_mnist_mp, device, smi)
    timed("seq2seq_mp", phase_seq2seq_mp, smi)
    timed("parallel_conv", phase_parallel_conv, smi)
    timed("sp_parity", phase_sp_parity, smi)
    sp_train = timed("sp_train", phase_sp_train, smi)
    timed("tp_train", phase_tp_train, smi)
    serve_tp = timed("serve_tp", phase_serve_tp, device, smi, lengths)
    reshard = timed("reshard", phase_reshard, smi)
    timed("hybrid", phase_hybrid, smi)
    moe = timed("moe_train", phase_moe_train, smi)
    gspmd = timed("gspmd_train", phase_gspmd_train, smi)
    timed("pp_train", phase_pp_train, smi)
    timed("lm_fused_remat", phase_lm_fused_remat, device, smi)
    timed("lm_example", phase_lm_example, smi)
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "chainermn_torch/csrc/paged_decode.cu",
        "replaces": "chainermn_tpu/parallel/paged_kernel.py:91",
        "launches": launches,
        "launches_spec_path": spec["kernel_launches"],
        "launches_window_path": window["kernel_launches"],
        "launches_captured": {
            name: runs["true"]["kernel_launches"]
            for name, runs in graphs["runs"].items()},
        "launches_fleet_path": dict(zip(
            ("prefill_tier", "decode_tier"),
            fleet["tiers"]["kernel_launches"])),
        "launches_control_path": control["launches_control_path"],
        "launches_control_path_by_engine": control["kernel_launches"],
        "launches_traced_path": {
            name: r["kernel_launches"] for name, r in traced["runs"].items()},
        "launches_tp_path": {
            f"rank{r['rank']}": r["bf16"]["kernel_launches"]
            for r in serve_tp["ranks_out"]},
        "launches_reshard_serve_path": {
            f"rank{r['rank']}": r["honest"]["serve"]["kernel_launches"]
            for r in reshard["serve"]},
        "local_heads": {
            h: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "max_abs_err")}
            for h, r in serve_tp["b4_local_heads"].items()},
        "launches_lm_d256_path": d256["serve"]["kernel_launches"],
        "launches_lm_wide_path": {
            "d512": wide["serve"]["kernel_launches"],
            "f16": wide["f16_serve"]["serve"]["kernel_launches"],
            "f16_twin": wide["f16_serve"]["twin"]["runs"]["kernel"][
                "kernel_launches"]},
        **{tag: {k: timing[tag][k] for k in (
            "H", "D", "dtype", "ms", "plain_ms", "library_ms",
            "library_backend", "bound_ms", "bound_by", "max_abs_err")}
           for tag in ("d256", "d512", "f16")},
        "ms_span_cut": timing["ms_span_cut"],
        "max_abs_err": timing["max_abs_err"],
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
            "launches_moe_path": moe[0]["ep"]["launches"][name],
            "launches_gspmd_path": gspmd[0]["gspmd"]["launches"][name],
            "launches_fit_path": {
                run: fit_rec["runs"][run]["launches"][name]
                for run in ("a", "b", "c")},
            "launches_resilient_path": resilient["launches"][name],
            "launches_lm_d256_path": d256["train"]["launches"][name],
            "launches_lm_wide_path": wide["train"]["launches"][name],
            "launches_f32_by_phase": {
                phase: n[name] for phase, n in f32_launches.items()
                if n[name]},
            **{tag: {k: rec[tag][k] for k in (
                "H", "D", "dtype", "kernel", "cluster_size", "ms",
                "plain_ms",
                "library_ms", "library_backend", "bound_ms", "bound_by",
                "max_abs_err")}
               for tag in FLASH_TIMING_TAGS},
            "f32_kernels": dict(zip(("d_le_256", "d_le_2048", "d_gt_2048"),
                                    FLASH_F32_KERNELS[name])),
            "launches_reshard_path": {
                "train_tp2": reshard["train"][0]["launches"][name],
                "restored_tp4": reshard["serve"][0]["honest"]["launches"][
                    name]},
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
    try:
        status = main()
    except BaseException:
        # a failed phase ends the process here, whatever threads it left
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        _exit_now(1)
    sys.stderr.flush()
    _exit_now(status)
