"""Continuous-batching decode engine (the port of
``chainermn_tpu/serving/engine.py``'s single-device paths).

Two KV layouts:

- **paged** (``paged=True``, the port's default): one shared block store
  (:func:`~chainermn_torch.models.transformer.init_paged_kv_caches`) holds
  every slot's KV; each slot reaches its sequence through a row of the
  ``[n_slots, max_blocks]`` block table, kept on the host and sent with
  every call. Block 0 is a reserved scratch block: inactive rows,
  unallocated table entries and writes a window masks out land there.
  Slots allocate blocks lazily as their writes cross block boundaries
  (:meth:`ServingEngine.append_block`, driven by the scheduler); a
  prefix-cache hit is a shared table entry (no copy); retirement gives
  the slot's block references back to the pool.
- **dense** (``paged=False``): one ``[n_slots, cache_len]`` region a slot
  (:func:`~chainermn_torch.models.transformer.init_kv_caches`). With
  ``prefix_cache_blocks > 0`` a separate block store and a private-pool
  trie cache prompt prefixes: each prefill copies its row's matched
  blocks into the slot first (inside the same call), and a freshly
  prefilled prompt's full blocks are copied into the store after the
  step (:meth:`ServingEngine.flush_inserts`).

Device paths, each a fixed step program (:mod:`._programs`; on a CUDA
device one captured CUDA graph, replayed every call):

- **prefill** (one program per bucket of padded prompt-suffix lengths): up
  to ``prefill_batch`` requests write their suffix K/V and sample their
  first token from their last real position;
- **decode step**: every slot advances one token at its own position;
  ``decode_window=n`` runs ``n`` such steps in one engine call
  (:meth:`ServingEngine.decode_steps`), one program of ``n`` chained
  steps;
- **speculative verify** (paged, greedy): every slot scores ``[token,
  d1..dk]`` at ``k + 1`` positions in one forward and commits the
  accepted drafts plus one correction token
  (:meth:`ServingEngine.spec_decode_step`);
- **chunked prefill** (paged): a long prompt's suffix prefills one chunk
  a scheduler step through the same bucket programs
  (:meth:`ServingEngine.prefill_chunk`);
- **prefix insert** (dense with a prefix store), and the draft model's
  prefill and decode (``drafter='draft'``);
- **KV migration** (paged): ``kv_gather_{w}`` reads ``w`` blocks' rows
  out of the store and ``kv_scatter_{w}`` writes ``w`` rows into it in
  place, one pair per migration width (powers of two up to the table
  width, plus 1 and the table width). :meth:`ServingEngine.export_slot_kv`
  / :meth:`ServingEngine.import_slot_kv` move a decoding request between
  engines through them, :meth:`ServingEngine.export_prefix_kv` /
  :meth:`ServingEngine.import_prefix_kv` a cached prompt prefix.

Every program reads the full width its shape allows (the whole block
table, the whole dense cache), as the reference's single compiled decode
program does; the position mask and the kernel's per-row lengths keep
the rows past a sequence out. Host operands (tables, tokens, positions,
``valid``, the active mask) are copied into each program's static
buffers. :meth:`ServingEngine.warmup` builds every program, and a
``RecompileGuard`` watches them (:meth:`ServingEngine.compile_counts`,
:meth:`ServingEngine.compile_counts_detailed`,
:attr:`ServingEngine.recompiles`).

Per-request sampling: each slot holds its own ``torch.Generator`` seeded
from the request's integer ``seed`` at admission, so its draws do not
depend on its batch neighbours, a preempted request replays the same
stream, and a decode window draws exactly what the per-token steps draw.
Greedy decoding (``temperature=0``) draws nothing and takes its argmax
inside the programs. With ``temperature > 0`` the programs stop at the
logits and the draws run outside them, so a captured engine samples
exactly the eager engine's stream; a sampled decode window replays the
one-step program ``n`` times, sampling between replays.

The stores are written in place, so a failed call leaves them usable;
there is no donated buffer to lose. :meth:`ServingEngine.restart` and
:meth:`ServingEngine.swap_params` work in place too (the graphs hold the
buffers' addresses): nothing a program reads is ever reallocated, an
import included.

**Tensor-parallel serving** (``model.tensor_axis`` set, ``comm=``): every
rank of the tensor axis builds the same engine over a store of its
``n_heads / tp`` local heads (paged ``k``/``v`` and int8 scales, or the
dense slot caches and prefix store), and every program body is the
single-device one with a vocab-parallel head's logits all-gathered
before the argmax or the draw. The ranks are processes, so one of them
decides: the tensor axis's rank 0 runs the scheduler and announces every
program run to the others, which replay it (:mod:`._tp`; ranks > 0 call
:meth:`ServingEngine.follow`, the leader ends them with
:meth:`ServingEngine.close`). Sampling happens on the leader only. Two
decisions, written down here:

- *capture*: a step's collectives over a gloo group stage through the
  host, which a CUDA graph cannot hold, and capture between collectives
  is not built. A tensor-parallel engine runs its programs eagerly
  (``capture=None`` means ``False``), and ``capture=True`` raises
  ``ValueError`` naming this;
- *migration and sharing*: a rank's rows are a head shard, so the
  KV-migration and prefix-share surface declines (``migration_supported``
  is False; an export reads ``None``, an import raises), as the
  reference's does for its head-sharded store.

A migration payload is a dict with the reference's keys (``n_blocks``,
``block_size``, ``kv_quant``, ``n_layers``, ``layers``, ``t_start``, and
``pos``/``token``/``key`` for a slot or ``tokens`` for a prefix).
``layers[l][name]`` is a CPU tensor of ``n_blocks`` store rows as stored
(int8 rows and their scales are not dequantised), a view into
``packed[name]``, one ``[n_blocks, n_layers, ...]`` host buffer a store
tensor (pinned when the engine is on a card), which a transfer moves in
one copy. ``key`` is the slot's sampler generator state (``None`` when
greedy).
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from chainermn_torch._device import resolve_device
from chainermn_torch.dataflow.dispatch import device_fetch
from chainermn_torch.extensions.profiling import Watchdog
from chainermn_torch.models.transformer import (
    _check_sampler,
    _sampler,
    gather_vocab,
    init_kv_caches,
    init_paged_kv_caches,
    tensor_group,
)
from chainermn_torch.monitor import RecompileGuard, get_event_log, get_registry
from chainermn_torch.monitor.annotations import annotate
from chainermn_torch.parallel.sequence import chunk_spans
from chainermn_torch.resilience.cutpoints import (
    SERVING_CHUNK_PREFILL,
    SERVING_DECODE,
    SERVING_KV_APPEND,
    SERVING_PREFILL,
    SERVING_PREFILL_BATCH,
    SERVING_PREFIX_COPY,
    SERVING_SPEC_VERIFY,
)
from chainermn_torch.resilience.faults import inject
from chainermn_torch.serving._programs import ProgramSet
from chainermn_torch.serving._tp import CLOSE, RESTART, SWAP, TPChannel
from chainermn_torch.serving.prefix_cache import (
    BlockPool,
    PrefixCacheIndex,
    PrefixMatch,
)
from chainermn_torch.serving.speculative import (
    SpeculativeConfig,
    build_drafter,
)


@dataclass
class AdmitPlan:
    """One request's admission decision: the pinned prefix match (if
    any), the suffix start position, and the prefill bucket its padded
    suffix runs in. Built by :meth:`ServingEngine.plan_admission`;
    consumed by :meth:`ServingEngine.admit_batch` or dropped with
    :meth:`ServingEngine.cancel_plan`."""

    prompt: np.ndarray
    seed: int
    match: Optional[PrefixMatch]
    start: int          # cached tokens reused (0 on a miss)
    bucket: int         # padded suffix length
    max_new: int = 1    # token budget (reserves growth blocks)

    @property
    def cached_frac(self) -> float:
        return self.start / len(self.prompt) if len(self.prompt) else 0.0


@dataclass
class ChunkedPrefill:
    """One slot's chunked prefill in progress: the prompt and seed, the
    slot's block ids (allocated up front, not yet in the decode table —
    see :meth:`ServingEngine.begin_chunked`), and the chunk schedule
    ``[(frontier, chunk_len, bucket), ...]`` that
    :meth:`ServingEngine.prefill_chunk` walks one entry a call."""

    prompt: np.ndarray
    seed: int
    start: int                     # cached-prefix tokens (chunk 0 frontier)
    max_new: int
    ids: list = field(default_factory=list)
    chunks: list = field(default_factory=list)
    next_idx: int = 0

    @property
    def done(self) -> bool:
        return self.next_idx >= len(self.chunks)

    @property
    def frontier(self) -> int:
        """Tokens prefilled so far (the cached prefix included)."""
        if self.done:
            return len(self.prompt)
        return self.chunks[self.next_idx][0]


class EngineStateError(RuntimeError):
    """The engine cannot carry on in its current state: a weight swap
    that does not match the engine's parameters (rejected before anything
    is written), or a device failure that leaves its state unknown (the
    scheduler fails the in-flight work and warm-restarts)."""


class ServingEngine:
    """Slot-pool decode engine (mechanism only; admission policy and
    request bookkeeping live in
    :class:`~chainermn_torch.serving.scheduler.FCFSScheduler`).

    Parameters
    ----------
    model : TransformerLM
        On ``device``; not sequence-sharded, MoE only as
        ``moe_impl='gshard'``; tensor-parallel with ``comm``. The engine
        calls
        ``model.cast_weights_()`` (matmul weights stored in the compute
        dtype; logits unchanged).
    n_slots : int
        Concurrently decoding requests: the decode batch.
    prefill_len / prefill_buckets :
        Largest admitted prompt, and the ascending ladder of padded
        prompt-suffix lengths (default ``(prefill_len,)``).
    prefill_batch : int
        Requests admitted per prefill call (clamped to ``n_slots``).
    prefix_cache_blocks / prefix_block_size / prefix_min_insert_blocks :
        Dense engines only: ``prefix_cache_blocks > 0`` builds a prefix
        store of that many ``prefix_block_size``-token blocks and its
        trie; prompts adding fewer than ``prefix_min_insert_blocks`` new
        full blocks are not inserted (on the paged store the same gate
        applies to zero-copy inserts).
    paged : bool
        The shared block store (default) or the dense per-slot cache.
    kv_blocks / kv_block_size / kv_quant :
        Paged only: store blocks including the scratch block (default
        ``n_slots * ceil(cache_len / kv_block_size) + 1``), tokens per
        block, and ``'int8'`` rows with per-row-per-head f32 scales.
    paged_kernel : bool
        Paged only: decode, decode-window and verify attention reads go
        through the hand-written CUDA kernel.
    speculative : SpeculativeConfig, optional
        Paged and greedy only: draft ``k`` tokens a slot a round and
        verify them in one forward (:meth:`spec_decode_step`); admission
        reserves ``ceil(k / kv_block_size)`` extra blocks a slot.
    decode_window : int
        ``n > 1`` advances every slot ``n`` tokens per engine call
        (:meth:`decode_steps`); exclusive with ``speculative``.
    cache_len : int, optional
        Per-slot KV capacity (prompt + generated); default
        ``model.max_len``.
    temperature / top_k / top_p :
        Sampler shared by every request.
    watchdog : Watchdog or float, optional
        Hang detection around every device call; a float builds
        ``Watchdog(timeout=...)`` (abort on fire). Off by default.
    capture : bool, optional
        Capture each step program into a CUDA graph (``None``: on a CUDA
        device, as the reference always runs compiled programs). ``False``
        runs the same programs eagerly; ``True`` on the CPU, or on a
        tensor-parallel engine, raises ``ValueError``.
    comm : communicator, optional
        Required iff ``model.tensor_axis`` is set: the model's tensor-axis
        communicator, or the mesh communicator binding its axis name.
        Every rank of the axis builds the engine; rank 0 leads (module
        docstring).
    device : optional
        Where the engine runs: the current CUDA card when ``None`` (raises
        when there is none); ``"cpu"`` must be asked for.
    """

    def __init__(self, model, *, n_slots: int,
                 prefill_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefill_batch: int = 1, prefix_cache_blocks: int = 0,
                 prefix_block_size: int = 16,
                 prefix_min_insert_blocks: int = 1, paged: bool = True,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16,
                 kv_quant: str = "none", paged_kernel: bool = False,
                 speculative: Optional[SpeculativeConfig] = None,
                 decode_window: int = 1,
                 cache_len: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 watchdog: Optional[Union[Watchdog, float]] = None,
                 capture: Optional[bool] = None, comm=None,
                 device=None) -> None:
        self.device = resolve_device(device)
        if model.tensor_axis is not None and comm is None:
            raise ValueError("tensor-parallel serving needs comm= (every "
                             "rank of the tensor axis runs the programs on "
                             "its local heads)")
        self._tp = tensor_group(model, comm)
        if capture is None:
            capture = self.device.type == "cuda" and self._tp is None
        elif capture and self._tp is not None:
            raise ValueError(
                "capture=True on a tensor-parallel engine: its step's "
                "collectives over the tensor group stage through the host "
                "(a gloo group) and capture between collectives is not "
                "built, so a CUDA graph cannot hold the step — use "
                "capture=False")
        elif capture and self.device.type != "cuda":
            raise ValueError("capture=True needs a CUDA device (the step "
                             "programs become CUDA graphs); the CPU runs "
                             "them eagerly")
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}: move the model first")
        if model.sequence_axis is not None:
            raise ValueError("serving does not support sequence-sharded "
                             "models: rebuild with sequence_axis=None")
        self._heads = model.n_heads
        if self._tp is not None:
            if model.n_heads % self._tp.size:
                raise ValueError(f"n_heads {model.n_heads} not divisible by "
                                 f"tensor-axis size {self._tp.size}")
            self._heads = model.n_heads // self._tp.size
        if model.moe_experts and model.moe_impl != "gshard":
            raise ValueError("serving supports MoE only via "
                             "moe_impl='gshard' (same parameters)")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        cache_len = cache_len or model.max_len
        if cache_len > model.max_len:
            raise ValueError(f"cache_len {cache_len} exceeds model.max_len "
                             f"{model.max_len}")
        if prefill_buckets is None:
            if prefill_len is None:
                raise ValueError("pass prefill_len or prefill_buckets")
            buckets = (int(prefill_len),)
        else:
            buckets = tuple(sorted({int(b) for b in prefill_buckets}))
            if not buckets:
                raise ValueError("prefill_buckets must be non-empty")
            if prefill_len is not None and int(prefill_len) != buckets[-1]:
                raise ValueError(
                    f"prefill_len {prefill_len} != max(prefill_buckets) "
                    f"{buckets[-1]}")
        if not (0 < buckets[0] and buckets[-1] <= cache_len):
            raise ValueError(f"prefill buckets must be in (0, cache_len="
                             f"{cache_len}], got {buckets}")
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got "
                             f"{prefill_batch}")
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got "
                             f"{kv_quant!r}")
        if kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{kv_block_size}")
        if int(decode_window) < 1:
            raise ValueError(f"decode_window must be >= 1, got "
                             f"{decode_window}")
        if speculative is not None:
            speculative.validate()
            if not paged:
                raise ValueError("speculative decode needs paged=True: the "
                                 "verify window writes through block "
                                 "tables")
            if float(temperature) != 0.0:
                raise ValueError("speculative decode is greedy-only "
                                 "(temperature=0): the verify step takes "
                                 "the argmax at every position")
            if int(decode_window) != 1:
                raise ValueError("speculative= and decode_window > 1 are "
                                 "mutually exclusive: the verify window "
                                 "already commits several tokens a call")
        if not paged and kv_quant != "none":
            raise ValueError("kv_quant needs paged=True (the dense cache "
                             "regions are not quantized)")
        if not paged and paged_kernel:
            raise ValueError("paged_kernel=True needs paged=True (the "
                             "kernel reads the shared block store)")
        if paged and prefix_cache_blocks:
            raise ValueError("the paged engine keeps its prefix cache on "
                             "the shared block store: drop "
                             "prefix_cache_blocks and size the store with "
                             "kv_blocks/kv_block_size")
        _check_sampler(model, float(temperature), int(top_k), float(top_p))
        self.model = model.eval().cast_weights_()
        self.n_slots = int(n_slots)
        self.prefill_buckets = buckets
        self.prefill_len = buckets[-1]
        self.prefill_batch = min(int(prefill_batch), self.n_slots)
        self.cache_len = int(cache_len)
        self.paged = bool(paged)
        self.kv_quant = kv_quant
        self.paged_kernel = bool(paged_kernel)
        self.decode_window = int(decode_window)
        self.temperature = float(temperature)
        self._sample = _sampler(self.temperature, int(top_k), float(top_p))
        if watchdog is not None and not isinstance(watchdog, Watchdog):
            watchdog = Watchdog(timeout=float(watchdog))
        self.watchdog = watchdog
        self._events = get_event_log()
        reg = get_registry()
        labels = {"engine": "serving"}
        self._c_prefills = {
            b: reg.counter("serving_prefills_total",
                           dict(labels, prefill_bucket=str(b)))
            for b in buckets}
        self._c_appends = reg.counter("kv_block_appends_total", labels)
        self._c_chunks = reg.counter("prefill_chunks_total", labels)
        self._h_chunk_tokens = reg.histogram("chunk_tokens", labels)
        decode_labels = dict(labels)
        if self.paged:
            decode_labels["paged_kernel"] = ("on" if self.paged_kernel
                                             else "off")
        self._c_decode_steps = reg.counter("serving_decode_steps_total",
                                           decode_labels)
        self._c_restarts = reg.counter("serving_engine_restarts_total",
                                       labels)
        self._c_migrations = reg.counter("kv_migrations_total", labels)
        self._c_migrated_blocks = reg.counter("kv_migrated_blocks_total",
                                              labels)
        self._h_migration = reg.histogram("migration_seconds", labels,
                                          unit="s")
        # the two halves of a transfer, each closed by its device sync
        self._h_export = reg.histogram("kv_export_seconds", labels, unit="s")
        self._h_import = reg.histogram("kv_import_seconds", labels, unit="s")
        # versioned weights: 0 is the constructor's; every successful
        # swap_params bumps it and moves the gauge
        self.weight_version = 0
        self._g_weight_version = reg.gauge("serving_weight_version", labels)
        self._g_weight_version.set(0)
        self._programs = ProgramSet(self.device, bool(capture))
        self._channel = None
        if self._tp is not None:
            self._channel = TPChannel(self._tp)
            if self._channel.leader:
                self._programs.announce = self._channel.announce
            else:
                self._programs.follower = True
        self._closed = False
        self.peak_active = 0
        self._min_insert = max(1, int(prefix_min_insert_blocks))
        self._spec = speculative
        self._spec_headroom = 0
        self.prefix_cache: Optional[PrefixCacheIndex] = None
        if self.paged:
            self.kv_block_size = int(kv_block_size)
            # table width: blocks covering a full-length slot
            self._n_max = -(-self.cache_len // self.kv_block_size)
            self.kv_blocks = int(kv_blocks if kv_blocks is not None
                                 else self.n_slots * self._n_max + 1)
            self._pool = BlockPool(self.kv_blocks, reserve_scratch=True)
            self.prefix_cache = PrefixCacheIndex(self.kv_block_size,
                                                 pool=self._pool)
            self._n_prog_blocks = self._n_max      # match cap for planning
            self._tables = np.zeros((self.n_slots, self._n_max), np.int32)
            self._slot_blocks: list[list[int]] = [
                [] for _ in range(self.n_slots)]
            # worst-case growth blocks each active slot may still append:
            # admission reserves them, append_block draws them down
            self._slot_reserved = np.zeros((self.n_slots,), np.int64)
            # a multi-token round writes up to this many rows past the
            # commit frontier (a verify window's drafts, a decode window's
            # later steps); admission reserves the blocks they may need
            self._write_horizon = (speculative.k if speculative is not None
                                   else self.decode_window - 1)
            self._spec_headroom = -(-self._write_horizon
                                    // self.kv_block_size)
            # slot -> ChunkedPrefill: neither free nor active, its table
            # row all-scratch until the final chunk commits the real ids
            self._chunking: dict[int, ChunkedPrefill] = {}
            self.caches = None        # the block store is the cache
            self._store = init_paged_kv_caches(
                model, self.kv_blocks, self.kv_block_size,
                local_heads=self._heads, quant=kv_quant, device=self.device)
        else:
            if prefix_cache_blocks:
                if not 0 < prefix_block_size <= self.prefill_len:
                    raise ValueError(
                        f"prefix_block_size must be in (0, prefill_len="
                        f"{self.prefill_len}], got {prefix_block_size}")
                self.prefix_cache = PrefixCacheIndex(
                    int(prefix_cache_blocks), int(prefix_block_size))
                # blocks each prefill's prefix splice moves (whole blocks)
                self._n_prog_blocks = max(
                    1, self.prefill_len // prefix_block_size)
            self.caches = init_kv_caches(model, self.n_slots,
                                         self.cache_len,
                                         local_heads=self._heads,
                                         device=self.device)
            self._store = (self._init_store()
                           if self.prefix_cache is not None else None)
        self._token = np.zeros((self.n_slots,), np.int32)
        self._pos = np.zeros((self.n_slots,), np.int32)
        self._active = np.zeros((self.n_slots,), bool)
        self._gens: list[Optional[torch.Generator]] = [None] * self.n_slots
        self.free_slots = set(range(self.n_slots))
        self._warm = False
        # dense prefix inserts (prompt, slot), copied by flush_inserts()
        # after the step's tokens are out and before a donor slot can be
        # reused
        self._pending_inserts: list[tuple[np.ndarray, int]] = []
        self._drafter = None
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._spec_rounds = 0
        self._last_spec_window: Optional[tuple] = None
        self._last_spec_slots: dict = {}
        if speculative is not None:
            self._drafter = build_drafter(speculative, self)
        self._build_programs()

    @property
    def migration_supported(self) -> bool:
        """KV migration needs the paged store and a single-device layout:
        a tensor-parallel engine's rows are head shards on its ranks."""
        return self.paged and self._tp is None

    def _migration_error(self) -> str:
        if self._tp is not None:
            return ("KV migration needs a single-device store: a tensor-"
                    "parallel engine's rows are head shards on its ranks")
        return ("KV migration needs paged=True (the dense engine has no "
                "block store)")

    @property
    def tp_leader(self) -> bool:
        """Whether this engine drives its programs: a single-device engine,
        or rank 0 of a tensor-parallel one."""
        return self._channel is None or self._channel.leader

    @property
    def tp_channel(self) -> Optional[TPChannel]:
        """A tensor-parallel engine's leader-to-followers channel."""
        return self._channel

    @property
    def capture(self) -> bool:
        """Whether the step programs run as captured CUDA graphs."""
        return self._programs.capture

    @property
    def stream(self):
        """The engine's own CUDA stream (``None`` on the CPU): its programs
        are captured on it, and a fleet replica drives the engine on it,
        so no two engines share one."""
        return self._programs.stream if self.device.type == "cuda" else None

    def _init_store(self) -> list[dict]:
        """The dense engine's prefix store: ``[n_blocks, block_size, H,
        D]`` per layer in the compute dtype."""
        pc = self.prefix_cache
        h = self._heads
        dh = self.model.d_model // self.model.n_heads

        def z():
            return torch.zeros((pc.n_blocks, pc.block_size, h, dh),
                               dtype=self.model.compute_dtype,
                               device=self.device)

        return [{"k": z(), "v": z()} for _ in range(self.model.n_layers)]

    def _watched(self, label: str, **ctx):
        """Watchdog window around one device call (a no-op when hang
        detection is off); ``ctx`` names whose work it is."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.step(label, **ctx)

    @property
    def prefix_enabled(self) -> bool:
        return self.prefix_cache is not None

    # ------------------------------------------------------------------ #
    # step programs                                                        #
    # ------------------------------------------------------------------ #

    def _build_programs(self) -> None:
        """Declare every step program (built at its first call, or all at
        :meth:`warmup`) and watch each one with the recompile guard."""
        ps = self._programs
        k, n = self.prefill_batch, self.n_slots
        i64, i32, flag = torch.int64, torch.int32, torch.bool
        self._prefill_progs = {}
        for b in self.prefill_buckets:
            ins = {"tokens": ((k, b), i64), "starts": ((k,), i64),
                   "last_idx": ((k,), i64), "active": ((k,), flag)}
            if self.paged:
                ins["table"] = ((k, self._n_max), i32)
                body = self._paged_prefill_body
            else:
                ins["slots"] = ((k,), i64)
                if self.prefix_cache is not None:
                    ins["fetch"] = ((k, self._n_prog_blocks), i64)
                body = self._dense_prefill_body
            self._prefill_progs[b] = ps.program(
                f"prefill_{b}", functools.partial(body, b), ins)
        self._decode_prog = ps.program(
            "decode", functools.partial(self._decode_body, 1),
            self._decode_inputs(1))
        self._window_prog = None
        if self.decode_window > 1:
            # sampled: the window replays the one-step program n times
            self._window_prog = self._decode_prog if self.temperature else \
                ps.program("decode_window",
                           functools.partial(self._decode_body,
                                             self.decode_window),
                           self._decode_inputs(self.decode_window))
        self._spec_prog = None
        if self._spec is not None:
            k1 = self._spec.k + 1
            self._spec_prog = ps.program(
                "spec_verify", self._verify_body,
                {"tokens": ((n, k1), i64), "pos": ((n, k1), i64),
                 "valid": ((n,), i32), "active": ((n,), flag),
                 "table": ((n, self._n_max), i32)})
        self._insert_prog = None
        if self.prefix_cache is not None and not self.paged:
            nb = self._n_prog_blocks
            self._insert_prog = ps.program(
                "prefix_insert", self._insert_body,
                {"slot": ((1,), i64), "ids": ((nb,), i64),
                 "row_starts": ((nb,), i64)})
        self._gather_progs: dict = {}
        self._scatter_progs: dict = {}
        if self.migration_supported:
            self._mig_buckets = self._migration_bucket_widths()
            for w in self._mig_buckets:
                self._gather_progs[w] = ps.program(
                    f"kv_gather_{w}", self._kv_gather_body,
                    {"ids": ((w,), i64)})
                ins = {"ids": ((w,), i64), "n_used": ((1,), i64)}
                ins.update({f"rows_{kk}": self._packed_spec(kk, w)
                            for kk in self._store[0]})
                self._scatter_progs[w] = ps.program(
                    f"kv_scatter_{w}",
                    functools.partial(self._kv_scatter_body, w), ins)
        self._guard = RecompileGuard()
        for b, prog in self._prefill_progs.items():
            self._guard.watch(f"serving_prefill_{b}", prog)
        self._guard.watch("serving_decode", self._decode_prog)
        if self._insert_prog is not None:
            self._guard.watch("serving_prefix_insert", self._insert_prog)
        if self._window_prog is not None:
            self._guard.watch("serving_decode_window", self._window_prog)
        if self._spec_prog is not None:
            self._guard.watch("serving_spec_verify", self._spec_prog)
            for name, prog in self._drafter.watched_fns().items():
                self._guard.watch(name, prog)
        for w in self._gather_progs:
            self._guard.watch(f"serving_kv_gather_{w}", self._gather_progs[w])
            self._guard.watch(f"serving_kv_scatter_{w}",
                              self._scatter_progs[w])

    def _decode_inputs(self, n: int) -> dict:
        ins = {"tok": ((self.n_slots,), torch.int64),
               "pos": ((n, self.n_slots), torch.int64),
               "active": ((self.n_slots,), torch.bool)}
        if self.paged:
            ins["valid"] = ((n, self.n_slots), torch.int32)
            ins["table"] = ((self.n_slots, self._n_max), torch.int32)
        return ins

    def _vocab(self, logits):
        """A vocab-parallel head's local logits all-gathered to the whole
        vocabulary (on every rank); other logits as they are."""
        if self._tp is not None and self.model.vocab_parallel_head:
            return gather_vocab(logits, self._tp)
        return logits

    def _first_tokens(self, logits, ins):
        """Each row's last real position: its greedy token (0 on inactive
        rows), or its logits when sampling (drawn outside the program)."""
        k = logits.shape[0]
        last = self._vocab(
            logits[torch.arange(k, device=self.device), ins["last_idx"]])
        if self.temperature:
            return last
        nxt = torch.argmax(last, dim=-1)
        return torch.where(ins["active"], nxt, torch.zeros_like(nxt))

    def _paged_prefill_body(self, bucket: int, ins):
        """Each group row writes its padded suffix through its table row
        into the shared store and attends its table. Inactive rows carry
        all-scratch tables."""
        caches = [dict(layer, table=ins["table"]) for layer in self._store]
        pos = (ins["starts"][:, None]
               + torch.arange(bucket, device=self.device)[None, :])
        logits = self.model(ins["tokens"], pos, kv_caches=caches)
        return self._first_tokens(logits, ins)

    def _dense_prefill_body(self, bucket: int, ins):
        """Gather each group row's slot region, splice in its matched
        prefix blocks from the store (``fetch``; rows without a match
        splice junk that their own prefill overwrites or the mask hides),
        run the padded suffixes at their start positions, and write the
        regions back: the active rows' new ones, the inactive rows'
        (distinct, unused slots) as they were."""
        sl = ins["slots"]
        k = sl.shape[0]
        slot_c = [{kk: c[kk].index_select(0, sl) for kk in ("k", "v")}
                  for c in self.caches]
        if self.prefix_cache is not None:
            span = self._n_prog_blocks * self.prefix_cache.block_size
            ids = ins["fetch"].reshape(-1)
            for sc, st in zip(slot_c, self._store):
                for kk in ("k", "v"):
                    rows = st[kk].index_select(0, ids)
                    sc[kk][:, :span] = rows.reshape(
                        (k, span) + tuple(rows.shape[2:]))
        pos = (ins["starts"][:, None]
               + torch.arange(bucket, device=self.device)[None, :])
        logits = self.model(ins["tokens"], pos, kv_caches=slot_c)
        keep = ins["active"][:, None, None, None]
        for c, sc in zip(self.caches, slot_c):
            for kk in ("k", "v"):
                c[kk].index_copy_(0, sl, torch.where(
                    keep, sc[kk], c[kk].index_select(0, sl)))
        return self._first_tokens(logits, ins)

    def _decode_body(self, n: int, ins):
        """``n`` chained one-token steps of every slot (step ``i`` at
        ``pos[i]``, fed the tokens step ``i - 1`` took): ``[n_slots, n]``
        greedy tokens, or the one step's logits when sampling."""
        tok, act = ins["tok"], ins["active"]
        out = []
        for i in range(n):
            if self.paged:
                caches = [dict(layer, table=ins["table"],
                               valid=ins["valid"][i],
                               use_kernel=self.paged_kernel)
                          for layer in self._store]
            else:
                caches = self.caches
            lg = self._vocab(self.model(tok[:, None], ins["pos"][i][:, None],
                                        kv_caches=caches)[:, 0])
            if self.temperature:
                return lg
            tok = torch.where(act, torch.argmax(lg, dim=-1),
                              torch.zeros_like(tok))
            out.append(tok)
        return torch.stack(out, 1)

    def _verify_body(self, ins):
        caches = [dict(layer, table=ins["table"], valid=ins["valid"],
                       use_kernel=self.paged_kernel)
                  for layer in self._store]
        lg = self._vocab(self.model(ins["tokens"], ins["pos"],
                                    kv_caches=caches))
        g = torch.argmax(lg, dim=-1)
        return torch.where(ins["active"][:, None], g, torch.zeros_like(g))

    def _insert_body(self, ins):
        """Copy a slot's prompt blocks into the dense prefix store (the
        padding entries repeat the first one: same rows, same block)."""
        bs = self.prefix_cache.block_size
        rows = (ins["row_starts"][:, None]
                + torch.arange(bs, device=self.device)[None, :])
        for st, c in zip(self._store, self.caches):
            for kk in ("k", "v"):
                src = c[kk].index_select(0, ins["slot"])[0]
                st[kk].index_copy_(0, ins["ids"], src[rows])

    def _packed_spec(self, kk: str, w: int) -> tuple:
        """(shape, dtype) of ``w`` blocks' rows of store tensor ``kk`` over
        every layer: ``[w, n_layers, ...]``."""
        t = self._store[0][kk]
        return (w, len(self._store)) + tuple(t.shape[1:]), t.dtype

    def _kv_gather_body(self, ins):
        """Migration read side: every store tensor's rows at ``ids``
        (int8 rows and their scales as stored), packed ``[w, n_layers,
        ...]`` a tensor. Pad ids read the scratch block; the exporter
        keeps the first ``n`` rows. Reads only: the source keeps decoding
        if the handover fails."""
        ids = ins["ids"]
        return {kk: torch.stack([layer[kk].index_select(0, ids)
                                 for layer in self._store], 1)
                for kk in self._store[0]}

    def _kv_scatter_body(self, width: int, ins):
        """Migration write side: rows ``[0, n_used)`` of the packed input
        land in blocks ``ids`` of the store, in place (the captured graphs
        hold the store's addresses). Rows past ``n_used`` carry the
        scratch id 0 and rewrite what scratch already holds, so duplicate
        pad indices write equal values."""
        ids = ins["ids"]
        keep = torch.arange(width, device=self.device) < ins["n_used"]
        for li, layer in enumerate(self._store):
            for kk, t in layer.items():
                cur = t.index_select(0, ids)
                mask = keep.reshape((-1,) + (1,) * (cur.dim() - 1))
                t.index_copy_(0, ids, torch.where(
                    mask, ins[f"rows_{kk}"][:, li], cur))

    def _migration_bucket_widths(self) -> tuple:
        """Migration widths: powers of two below the table width, plus 1
        and the table width. A transfer pads its block list to the least
        width that covers it, so at most twice the live blocks move and no
        block count builds a new program."""
        widths = {1, self._n_max}
        w = 2
        while w < self._n_max:
            widths.add(w)
            w *= 2
        return tuple(sorted(widths))

    def _mig_bucket(self, n: int) -> int:
        """The least migration width covering ``n`` blocks."""
        for w in self._mig_buckets:
            if w >= n:
                return w
        raise RuntimeError(f"{n} blocks exceed the largest migration width "
                           f"{self._mig_buckets[-1]}")

    # ------------------------------------------------------------------ #
    # device paths                                                         #
    # ------------------------------------------------------------------ #

    def _row_gens(self, gens: Sequence[Optional[torch.Generator]]):
        """Per-row generators for a sampled call (``None`` when greedy);
        rows without one (inactive, or a chunk that samples nothing) draw
        from a throwaway generator."""
        if not self.temperature:
            return None
        spare = torch.Generator(device=self.device)
        return [g if g is not None else spare for g in gens]

    def _new_gen(self, seed: int) -> Optional[torch.Generator]:
        if not self.temperature:
            return None
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _draw(self, prog, out, gens):
        """A program's greedy tokens as they are, or its logits sampled
        with each row's generator (0 on inactive rows)."""
        if not self.temperature:
            return out
        with torch.inference_mode():
            nxt = self._sample(out, self._row_gens(gens))
            return torch.where(prog.inputs["active"], nxt,
                               torch.zeros_like(nxt))

    def _paged_prefill(self, bucket: int, table, tokens, starts, last_idx,
                       active, gens):
        """One bucket program over the group's host operands: returns
        each row's first token (device tensor)."""
        prog = self._prefill_progs[bucket]
        with annotate("chainermn.prefill"):
            out = prog.run(table=table, tokens=tokens, starts=starts,
                           last_idx=last_idx, active=active)
            return self._draw(prog, out, gens)

    def _dense_prefill(self, bucket: int, slots, tokens, starts, last_idx,
                       active, gens, fetch_ids=None):
        prog = self._prefill_progs[bucket]
        feed = dict(slots=slots, tokens=tokens, starts=starts,
                    last_idx=last_idx, active=active)
        if fetch_ids is not None:
            feed["fetch"] = fetch_ids
        with annotate("chainermn.prefill"):
            return self._draw(prog, prog.run(**feed), gens)

    def _decode_round(self, n: int) -> torch.Tensor:
        """``n`` chained one-token steps of every slot from its commit
        frontier; returns the ``[n_slots, n]`` tokens. Paged inactive rows
        decode at position 0 of their all-scratch table row; a row past
        ``cache_len`` (the tail of a decode window) writes nothing (paged:
        ``valid``) or its own last row (dense, as the reference's clamped
        update) and sits at ``cache_len - 1``; the scheduler drops its
        tokens. Dense inactive rows ride along at their stale position,
        past their last prompt, so a pending prefix insert still finds the
        donor's prompt rows intact."""
        with annotate("chainermn.decode"):
            return self._decode_round_run(n)

    def _decode_round_run(self, n: int) -> torch.Tensor:
        act = self._active
        pos = self._pos.astype(np.int64)[None, :] + np.arange(n)[:, None]
        feed = {"tok": self._token, "active": act}
        if self.paged:
            feed["valid"] = (act[None, :]
                             & (pos < self.cache_len)).astype(np.int32)
            feed["pos"] = np.where(act[None, :],
                                   np.minimum(pos, self.cache_len - 1), 0)
            feed["table"] = self._tables
        else:
            feed["pos"] = np.minimum(pos, self.cache_len - 1)
        if not self.temperature:
            prog = self._decode_prog if n == 1 else self._window_prog
            return prog.run(**feed)
        prog, gens, out = self._decode_prog, self._gens, []
        for i in range(n):
            step = dict(feed, pos=feed["pos"][i:i + 1])
            if self.paged:
                step["valid"] = feed["valid"][i:i + 1]
            if i:                    # table and mask are in place already
                step.pop("active")
                step.pop("table", None)
            feed["tok"] = self._draw(prog, prog.run(**step), gens)
            out.append(feed["tok"])
        return torch.stack(out, 1)

    def _spec_verify(self, tokens, valid) -> torch.Tensor:
        """Score the ``[n_slots, k+1]`` window ``tokens`` at positions
        ``pos .. pos+k`` in one forward and return every position's
        argmax. Rows ``j >= valid`` (past ``cache_len``) write into the
        scratch block and sit at ``cache_len - 1``; none of them is ever
        committed. Inactive rows run at position 0 with ``valid = 0``."""
        act = self._active
        k1 = tokens.shape[1]
        base = np.where(act, self._pos, 0).astype(np.int64)
        pos = np.minimum(base[:, None] + np.arange(k1)[None, :],
                         self.cache_len - 1)
        with annotate("chainermn.spec_verify"):
            return self._spec_prog.run(tokens=tokens, pos=pos, valid=valid,
                                       active=act, table=self._tables)

    def warmup(self) -> None:
        """Build every step program on no-op inputs: every prefill bucket,
        the decode step, the decode window, the verify window, the prefix
        insert and the drafter's two. All rows are inactive: paged writes
        land in the scratch block, dense writes in free slots' rows that
        their next tenant rewrites. On a CUDA device this captures the
        graphs (and builds the paged-decode kernel when ``paged_kernel``);
        the guard then records each build as its one compile."""
        if self._warm:
            return
        if self.active_slots or (self.paged and self._chunking):
            raise RuntimeError("warmup needs an idle engine")
        k = self.prefill_batch
        zeros = np.zeros((k,), np.int32)
        for b in self.prefill_buckets:
            with self._watched(f"serving warmup prefill[{b}]"):
                if self.paged:
                    self._paged_prefill(
                        b, np.zeros((k, self._n_max), np.int32),
                        np.zeros((k, b), np.int32), zeros, zeros,
                        np.zeros((k,), bool), [None] * k)
                else:
                    self._dense_prefill(
                        b, np.arange(k), np.zeros((k, b), np.int32), zeros,
                        zeros, np.zeros((k,), bool), [None] * k,
                        None if self.prefix_cache is None else
                        np.zeros((k, self._n_prog_blocks), np.int32))
        with self._watched("serving warmup decode"):
            self._decode_round(1)
            if self.decode_window > 1:
                self._decode_round(self.decode_window)
            if self._spec is not None:
                self._spec_verify(
                    np.zeros((self.n_slots, self._spec.k + 1), np.int32),
                    np.zeros((self.n_slots,), np.int32))
                self._drafter.warmup()
            if self._insert_prog is not None:
                nb = self._n_prog_blocks
                self._insert_prog.run(slot=np.zeros((1,), np.int64),
                                      ids=np.zeros((nb,), np.int64),
                                      row_starts=np.zeros((nb,), np.int64))
        # all-scratch ids with n_used = 0 at every width: the gather reads
        # scratch, the scatter rewrites scratch's own rows
        for w in self._gather_progs:
            zeros_w = np.zeros((w,), np.int64)
            with self._watched(f"serving warmup kv_gather[{w}]"):
                self._gather_progs[w].run(ids=zeros_w)
            with self._watched(f"serving warmup kv_scatter[{w}]"):
                self._scatter_progs[w].run(ids=zeros_w,
                                           n_used=np.zeros((1,), np.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._guard.check()
        self._warm = True
        self._events.emit("serving_warmup", buckets=list(self.prefill_buckets),
                          prefill_batch=k, paged=self.paged,
                          paged_kernel=self.paged_kernel,
                          prefix=self.prefix_enabled, capture=self.capture,
                          capture_s=self._programs.capture_s)

    # ------------------------------------------------------------------ #
    # admission planning (host side)                                       #
    # ------------------------------------------------------------------ #

    def bucket_for(self, suffix_len: int, start: int = 0) -> Optional[int]:
        """Smallest bucket covering a ``suffix_len``-token prefill that
        starts at row ``start`` and stays inside ``cache_len``."""
        for b in self.prefill_buckets:
            if b >= suffix_len and start + b <= self.cache_len:
                return b
        return None

    def plan_admission(self, prompt, seed: Optional[int] = None,
                       max_new: int = 1) -> AdmitPlan:
        """Match (and pin) the longest cached prefix that still leaves a
        bucket inside ``cache_len``, and pick that bucket. Host work only.
        The caller feeds the plan to :meth:`admit_batch` or returns the pin
        with :meth:`cancel_plan`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.validate_request(len(prompt), max_new)
        match = None
        if self.prefix_cache is not None:
            max_blocks = self._n_prog_blocks
            while True:
                match = (self.prefix_cache.match(prompt, max_blocks)
                         if max_blocks > 0 else None)
                if match is None or self.bucket_for(
                        len(prompt) - match.length,
                        match.length) is not None:
                    break
                # a long match can leave no bucket inside cache_len
                max_blocks = len(match.nodes) - 1
                self.prefix_cache.release(match)
        start = match.length if match is not None else 0
        bucket = self.bucket_for(len(prompt) - start, start)
        return AdmitPlan(prompt=prompt, seed=int(seed or 0), match=match,
                         start=start, bucket=bucket, max_new=int(max_new))

    def cancel_plan(self, plan: AdmitPlan) -> None:
        """Discard an unused plan, unpinning its prefix match."""
        if self.prefix_cache is not None:
            self.prefix_cache.release(plan.match)

    # ------------------------------------------------------------------ #
    # slot API (host side)                                                 #
    # ------------------------------------------------------------------ #

    @property
    def active_slots(self) -> int:
        return int(self._active.sum())

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if prompt_len > self.prefill_len:
            raise ValueError(f"prompt of {prompt_len} tokens exceeds "
                             f"prefill_len={self.prefill_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt_len + max_new_tokens > self.cache_len:
            raise ValueError(
                f"{prompt_len} prompt + {max_new_tokens} new tokens exceed "
                f"cache_len={self.cache_len}")
        if self.paged:
            need = self.blocks_needed(prompt_len, max_new_tokens)
            if need > self._pool.capacity:
                raise ValueError(
                    f"request needs {need} KV blocks worst-case but the "
                    f"pool holds {self._pool.capacity} — raise kv_blocks "
                    "or shrink the request")

    def prefill(self, prompt, seed: Optional[int] = None,
                ctx: Optional[dict] = None) -> tuple[int, int]:
        """Admit one prompt into a free slot with no prefix reuse: runs
        the smallest covering bucket's prefill and returns ``(slot,
        first_token)``. ``seed`` is the request's own sampler seed (its
        draws match a solo ``generate()``). Raises ``RuntimeError`` when
        no slot is free — admission control is the scheduler's job."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.validate_request(len(prompt), 1)
        plan = AdmitPlan(prompt=prompt, seed=int(seed or 0), match=None,
                         start=0, bucket=self.bucket_for(len(prompt)))
        return self.admit_batch([plan], point=SERVING_PREFILL, ctx=ctx)[0]

    def admit_batch(self, plans: Sequence[AdmitPlan], *,
                    point: str = SERVING_PREFILL_BATCH,
                    ctx: Optional[dict] = None) -> list[tuple[int, int]]:
        """Admit a same-bucket group in ONE prefill call; returns
        ``[(slot, first_token), ...]`` in plan order. Slot mirrors commit
        only after the call succeeds: a failure (an injected fault
        included) rolls the allocations back, leaves every decoding slot
        untouched, and re-raises. ``point`` is the fault cut-point the
        call injects; ``ctx`` labels the watchdog window and the prefill
        event."""
        if not plans:
            return []
        if len(plans) > self.prefill_batch:
            raise ValueError(f"group of {len(plans)} exceeds prefill_batch="
                             f"{self.prefill_batch}")
        if len(plans) > len(self.free_slots):
            raise RuntimeError("no free slot (scheduler admitted too many)")
        buckets = {p.bucket for p in plans}
        if len(buckets) != 1:
            raise ValueError(f"admission group mixes buckets "
                             f"{sorted(buckets)}")
        out = (self._paged_admit(plans, ctx, point) if self.paged
               else self._dense_admit(plans, ctx, point))
        self._guard.check()
        return out

    def _group_arrays(self, plans, bucket: int):
        """Host operands of one prefill call over ``prefill_batch`` rows:
        the padded suffixes, start positions, last real indices, the
        active mask and each row's sampler generator."""
        k = self.prefill_batch
        tokens = np.zeros((k, bucket), np.int32)
        starts = np.zeros((k,), np.int32)
        last = np.zeros((k,), np.int32)
        active = np.zeros((k,), bool)
        gens: list[Optional[torch.Generator]] = [None] * k
        for i, plan in enumerate(plans):
            suffix = plan.prompt[plan.start:]
            tokens[i, :len(suffix)] = suffix
            starts[i] = plan.start
            last[i] = len(suffix) - 1
            active[i] = True
            gens[i] = self._new_gen(plan.seed)
        return tokens, starts, last, active, gens

    def _commit_slot(self, slot: int, plan, first: int, gen, bucket: int,
                     batch: int, ctx: Optional[dict], **event) -> None:
        self.free_slots.discard(slot)
        self._token[slot] = first
        self._pos[slot] = len(plan.prompt)
        self._active[slot] = True
        self._gens[slot] = gen
        self._c_prefills[bucket].inc()
        self._events.emit("prefill", slot=slot, prompt_len=len(plan.prompt),
                          bucket=bucket, cached=plan.start, batch=batch,
                          **event, **(ctx or {}))
        if self._drafter is not None:
            self._drafter.on_admit(slot, plan.prompt, first)

    def _dense_admit(self, plans, ctx, point) -> list[tuple[int, int]]:
        bucket = plans[0].bucket
        if self._pending_inserts:
            self.flush_inserts()   # before slots are picked: no donor reuse
        slots = sorted(self.free_slots)[:len(plans)]
        n_cached = sum(p.match is not None for p in plans)
        try:
            with self._watched("serving prefill", **(ctx or {})), \
                    annotate("chainermn.serving_prefill"):
                if n_cached:
                    inject(SERVING_PREFIX_COPY, op="fetch", hits=n_cached,
                           batch=len(plans))
                inject(point, batch=len(plans), bucket=bucket, slots=slots)
                tokens, starts, last, active, gens = self._group_arrays(
                    plans, bucket)
                # the rows past the group ride on distinct unused slots,
                # whose regions the program writes back unchanged
                spare = [i for i in range(self.n_slots) if i not in slots]
                slot_ids = np.asarray(
                    slots + spare[:self.prefill_batch - len(slots)],
                    np.int64)
                fetch = None
                if self.prefix_cache is not None:
                    fetch = np.zeros((self.prefill_batch,
                                      self._n_prog_blocks), np.int32)
                    for i, plan in enumerate(plans):
                        if plan.match is not None:
                            ids = plan.match.block_ids
                            fetch[i, :len(ids)] = ids
                firsts = device_fetch(self._dense_prefill(
                    bucket, slot_ids, tokens, starts, last, active, gens,
                    fetch))
        finally:
            for plan in plans:
                self.cancel_plan(plan)      # the pins served their purpose
        out = []
        for i, (plan, slot) in enumerate(zip(plans, slots)):
            first = int(firsts[i])
            self._commit_slot(slot, plan, first, gens[i], bucket, len(plans),
                              ctx)
            out.append((slot, first))
            if self.prefix_cache is not None:
                self._pending_inserts.append((plan.prompt, slot))
        self.peak_active = max(self.peak_active, self.active_slots)
        return out

    def _alloc_prompt_blocks(self, plan: AdmitPlan, slot: int) -> list:
        """The blocks a plan's prompt lives in: its shared prefix blocks
        (referenced, not copied) then new ones for the rest, with the
        slot's worst-case decode growth plus the multi-token round's
        headroom reserved. Raises ``RuntimeError`` with nothing taken
        when the pool (plus trie eviction) cannot cover it."""
        bs = self.kv_block_size
        plen = len(plan.prompt)
        shared = list(plan.match.block_ids) if plan.match is not None else []
        need_now = -(-plen // bs) - len(shared)
        new = self.prefix_cache.alloc_blocks_atomic(need_now)
        if new is None:
            raise RuntimeError(
                f"kv block pool exhausted: slot {slot} needs {need_now} "
                f"blocks (free={self._pool.free_blocks})")
        for block in shared:
            self._pool.incref(block)    # the slot co-owns its prefix
        self._slot_reserved[slot] = (-(-(plen + plan.max_new) // bs)
                                     - (-(-plen // bs))
                                     + self._spec_headroom)
        return shared + new

    # graftlint: hot — the paged-path body of admit_batch
    def _paged_admit(self, plans, ctx, point) -> list[tuple[int, int]]:
        """Allocate table rows (prefix hits are shared entries), run the
        prefill through them, then commit the slot mirrors and adopt each
        prompt's full blocks into the trie (zero copy)."""
        bucket = plans[0].bucket
        slots = sorted(self.free_slots)[:len(plans)]
        n_cached = sum(p.match is not None for p in plans)
        records: list[tuple[int, list]] = []
        try:
            try:
                with self._watched("serving prefill", **(ctx or {})), \
                        annotate("chainermn.serving_prefill"):
                    if n_cached:
                        inject(SERVING_PREFIX_COPY, op="share",
                               hits=n_cached, batch=len(plans))
                    inject(point, batch=len(plans), bucket=bucket,
                           slots=slots)
                    tokens, starts, last, active, gens = self._group_arrays(
                        plans, bucket)
                    table = np.zeros((self.prefill_batch, self._n_max),
                                     np.int32)
                    for i, (plan, slot) in enumerate(zip(plans, slots)):
                        ids = self._alloc_prompt_blocks(plan, slot)
                        records.append((slot, ids))
                        self._tables[slot, :] = 0
                        self._tables[slot, :len(ids)] = ids
                        table[i, :len(ids)] = ids
                    firsts = device_fetch(self._paged_prefill(
                        bucket, table, tokens, starts, last, active, gens))
            except Exception:
                for slot, ids in records:   # undo: nothing admitted
                    for block in ids:
                        self._pool.decref(block)
                    self._slot_reserved[slot] = 0
                    self._tables[slot, :] = 0
                raise
        finally:
            for plan in plans:
                self.cancel_plan(plan)      # the pins served their purpose
        out = []
        for i, (plan, (slot, ids)) in enumerate(zip(plans, records)):
            first = int(firsts[i])
            self._slot_blocks[slot] = list(ids)
            self._commit_slot(slot, plan, first, gens[i], bucket, len(plans),
                              ctx, blocks=len(ids))
            out.append((slot, first))
            # zero-copy trie insert: the slot's blocks already hold the
            # prompt's KV, so adopting them IS the cache insert
            if self.prefix_cache.missing_blocks(plan.prompt) \
                    >= self._min_insert:
                self.prefix_cache.insert_shared(plan.prompt, ids)
        self.peak_active = max(self.peak_active, self.active_slots)
        return out

    # ------------------------------------------------------------------ #
    # chunked prefill (paged only)                                         #
    # ------------------------------------------------------------------ #

    def plan_chunks(self, plan: AdmitPlan,
                    chunk_tokens: int) -> Optional[list]:
        """The chunk schedule of a plan's suffix: ``[(frontier,
        chunk_len, bucket), ...]`` over ``[start, len(prompt))`` in
        ``chunk_tokens`` pieces, each bucket picked at its own frontier.
        ``None`` (admit unchunked) on a dense engine, when the suffix fits
        one chunk, or when a frontier leaves no bucket inside
        ``cache_len``."""
        if not self.paged:
            return None
        chunk_tokens = int(chunk_tokens)
        if chunk_tokens < 1:
            return None
        plen = len(plan.prompt)
        if plen - plan.start <= chunk_tokens:
            return None
        chunks = []
        for frontier, clen in chunk_spans(plan.start, plen, chunk_tokens):
            bucket = self.bucket_for(clen, frontier)
            if bucket is None:
                return None
            chunks.append((frontier, clen, bucket))
        return chunks

    def begin_chunked(self, plan: AdmitPlan, chunks: list) -> int:
        """Stage a chunked admission: claim a free slot, allocate all the
        prompt's blocks up front (shared prefix blocks referenced) and
        reserve decode growth, but leave the slot's decode-table row
        all-scratch, so decode rounds interleaving with the chunks write
        the slot's ride-along row into the scratch block. The real ids
        live in the :class:`ChunkedPrefill` until the final chunk commits
        them. Consumes the plan. Returns the slot."""
        if not self.paged:
            raise RuntimeError("chunked prefill needs paged=True")
        if not self.free_slots:
            raise RuntimeError("no free slot for chunked prefill")
        slot = min(self.free_slots)
        try:
            ids = self._alloc_prompt_blocks(plan, slot)
        finally:
            self.cancel_plan(plan)
        self._tables[slot, :] = 0          # scratch until the commit
        self._slot_blocks[slot] = list(ids)
        self.free_slots.discard(slot)
        self._chunking[slot] = ChunkedPrefill(
            prompt=plan.prompt, seed=plan.seed, start=plan.start,
            max_new=int(plan.max_new), ids=ids, chunks=list(chunks))
        return slot

    def chunk_state(self, slot: int) -> Optional[ChunkedPrefill]:
        return self._chunking.get(slot) if self.paged else None

    def prefill_chunk(self, slot: int,
                      ctx: Optional[dict] = None) -> Optional[int]:
        """Run one staged chunk through its bucket's prefill (row 0 holds
        the chunk at ``starts=frontier``; the other rows ride inactive on
        all-scratch tables). An intermediate chunk discards its sample and
        draws nothing from the request's generator (its padded tail rows
        are rewritten by the next chunk before anything attends them);
        the final chunk samples with the request's own seed, commits the
        slot's table and mirrors, and returns the first token. ``None``
        after an intermediate chunk. A raise leaves the staged state as it
        was."""
        st = self._chunking[slot]
        frontier, clen, bucket = st.chunks[st.next_idx]
        final = st.next_idx == len(st.chunks) - 1
        k = self.prefill_batch
        with self._watched("serving chunk_prefill", **(ctx or {})), \
                annotate("chainermn.serving_chunk_prefill"):
            inject(SERVING_CHUNK_PREFILL, slot=slot, chunk=st.next_idx,
                   of=len(st.chunks), bucket=bucket, frontier=frontier)
            tokens = np.zeros((k, bucket), np.int32)
            starts = np.zeros((k,), np.int32)
            last = np.zeros((k,), np.int32)
            active = np.zeros((k,), bool)
            table = np.zeros((k, self._n_max), np.int32)
            gens: list[Optional[torch.Generator]] = [None] * k
            tokens[0, :clen] = st.prompt[frontier:frontier + clen]
            starts[0] = frontier
            last[0] = clen - 1
            active[0] = True
            table[0, :len(st.ids)] = st.ids
            if final:
                gens[0] = self._new_gen(st.seed)
            nxt = self._paged_prefill(bucket, table, tokens, starts, last,
                                      active, gens)
            first = int(device_fetch(nxt)[0]) if final else None
        self._guard.check()
        st.next_idx += 1
        self._c_chunks.inc()
        self._h_chunk_tokens.observe(clen)
        self._events.emit("prefill_chunk", slot=slot, chunk=st.next_idx,
                          of=len(st.chunks), tokens=clen, bucket=bucket,
                          frontier=frontier, final=final)
        if not final:
            self._c_prefills[bucket].inc()
            return None
        # the staged ids become the slot's decode table and the slot joins
        # the active set: from here on it is an ordinary admitted slot
        self._tables[slot, :len(st.ids)] = st.ids
        self._chunking.pop(slot)
        self._commit_slot(slot, AdmitPlan(st.prompt, st.seed, None, st.start,
                                          bucket, st.max_new),
                          first, gens[0], bucket, 1, ctx,
                          blocks=len(st.ids), chunks=len(st.chunks))
        if self.prefix_cache.missing_blocks(st.prompt) >= self._min_insert:
            self.prefix_cache.insert_shared(st.prompt, st.ids)
        self.peak_active = max(self.peak_active, self.active_slots)
        return first

    # ------------------------------------------------------------------ #
    # KV migration (paged)                                                 #
    # ------------------------------------------------------------------ #

    def _host_rows(self, shape, dtype) -> torch.Tensor:
        """A host buffer for store rows, pinned when the engine is on a
        card (one DMA each way, no pageable bounce)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _gather_block_rows(self, ids: list, ctx: Optional[dict],
                           fused: bool) -> dict:
        """``ids``' rows on the host, ``{name: [n, n_layers, ...]}``.
        Fused: one gather at the least covering width. Per-block: one
        width-1 gather a block (the reference path the fused one is held
        to). Both copy out of the program's static outputs before any
        other program runs, and return after the copies landed."""
        n = len(ids)
        packed = {kk: self._host_rows(self._packed_spec(kk, n)[0],
                                      t.dtype)
                  for kk, t in self._store[0].items()}
        plan = ([(self._mig_bucket(n), list(ids), 0)] if fused
                else [(1, [b], j) for j, b in enumerate(ids)])
        for w, chunk, at in plan:
            ids_op = np.zeros((w,), np.int64)
            ids_op[:len(chunk)] = chunk
            with self._watched(f"serving kv_gather[{w}]", **(ctx or {})), \
                    annotate("chainermn.kv_gather"):
                out = self._gather_progs[w].run(ids=ids_op)
                with torch.no_grad():
                    for kk, t in out.items():
                        packed[kk][at:at + len(chunk)].copy_(
                            t[:len(chunk)], non_blocking=True)
                self._sync()
            self._guard.check()
        return packed

    def _scatter_block_rows(self, new: list, packed: dict,
                            ctx: Optional[dict], fused: bool) -> None:
        """Land ``packed``'s rows in blocks ``new`` of this store: one
        scatter at the least covering width (fused) or one width-1
        scatter a block. Returns after the writes landed; a raise leaves
        the rollback to the caller."""
        n = len(new)
        plan = ([(self._mig_bucket(n), list(new), 0)] if fused
                else [(1, [b], j) for j, b in enumerate(new)])
        for w, chunk, at in plan:
            prog = self._scatter_progs[w]
            ids_op = np.zeros((w,), np.int64)
            ids_op[:len(chunk)] = chunk
            with self._watched(f"serving kv_scatter[{w}]", **(ctx or {})), \
                    annotate("chainermn.kv_scatter"):
                with torch.inference_mode():
                    for kk, rows in packed.items():
                        prog.inputs[f"rows_{kk}"][:len(chunk)].copy_(
                            rows[at:at + len(chunk)], non_blocking=True)
                prog.run(ids=ids_op, n_used=np.asarray([len(chunk)]))
                self._sync()
            self._guard.check()

    def _payload(self, packed: dict, n: int, t0: float, **fields) -> dict:
        layers = [{kk: rows[:, li] for kk, rows in packed.items()}
                  for li in range(self.model.n_layers)]
        return dict({"n_blocks": n, "block_size": self.kv_block_size,
                     "kv_quant": self.kv_quant,
                     "n_layers": self.model.n_layers, "layers": layers,
                     "packed": packed, "t_start": t0}, **fields)

    @staticmethod
    def _payload_rows(payload: dict) -> dict:
        """``{name: [n, n_layers, ...]}`` host rows of a payload: its
        ``packed`` buffers, or its per-layer tensors stacked."""
        if "packed" in payload:
            return payload["packed"]
        layers = payload["layers"]
        return {kk: torch.stack([torch.as_tensor(layer[kk])
                                 for layer in layers], 1)
                for kk in layers[0]}

    def _layout_ok(self, payload: dict) -> bool:
        """Block size, quantisation, depth, block count and row shapes
        agree with this engine: a False here never clears."""
        if (int(payload["block_size"]) != self.kv_block_size
                or str(payload["kv_quant"]) != self.kv_quant
                or int(payload["n_layers"]) != self.model.n_layers):
            return False
        if not 0 < int(payload["n_blocks"]) <= self._n_max:
            return False
        layer = payload["layers"][0]
        if set(layer) != set(self._store[0]):
            return False
        for kk, arr in layer.items():
            st = self._store[0][kk]
            if (tuple(arr.shape[1:]) != tuple(st.shape[1:])
                    or torch.as_tensor(arr[:0]).dtype != st.dtype):
                return False
        return True

    def _state_ok(self) -> bool:
        """Whether the store still answers after a failed transfer (the
        port donates nothing, so only a device fault breaks it)."""
        try:
            self._store[0]["k"][:1].sum().item()    # a device fault raises
            return True
        except Exception:  # noqa: BLE001 — cannot tell: assume the worst
            return False

    def export_slot_kv(self, slot: int, ctx: Optional[dict] = None, *,
                       fused: bool = True) -> dict:
        """An active slot's whole KV state on the host (module docstring:
        the payload), read through one ``kv_gather`` at the least width
        covering its blocks (``fused=False``: one width-1 gather a block).
        With the slot's position, last token and sampler state it is all
        a peer needs to continue the request token for token
        (:meth:`import_slot_kv`). Read-only: the slot stays active; the
        caller releases it after the import commits."""
        if not self.migration_supported:
            raise RuntimeError(self._migration_error())
        if not self._active[slot]:
            raise RuntimeError(f"slot {slot} is not active")
        t0 = time.perf_counter()
        ids = list(self._slot_blocks[slot])
        packed = self._gather_block_rows(ids, ctx, fused)
        self._h_export.observe(time.perf_counter() - t0)
        gen = self._gens[slot]
        return self._payload(packed, len(ids), t0,
                             pos=int(self._pos[slot]),
                             token=int(self._token[slot]),
                             key=None if gen is None else gen.get_state())

    def can_import(self, payload: dict, max_new: int = 1, *,
                   static_only: bool = False) -> bool:
        """Host-side check that :meth:`import_slot_kv` would succeed: the
        layout agrees, the position leaves room for ``max_new`` tokens,
        and (unless ``static_only``) the engine is warm with a free slot
        and the blocks for the rows plus the remaining growth and the
        multi-token round's headroom. A ``static_only`` False never
        clears; any other False is transient."""
        if not self.migration_supported:
            return False
        if not static_only and not (self._warm and self.free_slots):
            return False
        if not self._layout_ok(payload):
            return False
        n, pos = int(payload["n_blocks"]), int(payload["pos"])
        if pos + int(max_new) > self.cache_len:
            return False
        if static_only:
            return True
        bs = self.kv_block_size
        need = (n + max(0, -(-(pos + int(max_new)) // bs) - n)
                + self._spec_headroom)
        return need <= self.kv_blocks_admittable()

    def import_slot_kv(self, payload: dict, *,
                       prompt: Optional[np.ndarray] = None,
                       max_new: int = 1, ctx: Optional[dict] = None,
                       fused: bool = True) -> int:
        """Land a migrated request here: allocate its blocks (all or
        none), write the rows in place through ``kv_scatter`` and commit
        the slot's position, token and sampler state, so the next decode
        round continues the request token for token. With ``prompt`` its
        full blocks join this engine's prefix trie and the drafter sees
        the prompt. Returns the slot. Raises ``RuntimeError`` with the
        engine as it was (layout, slots, blocks); the caller's fallback
        is decoding at the source."""
        if not self.migration_supported:
            raise RuntimeError(self._migration_error())
        if not self._layout_ok(payload):
            raise RuntimeError(
                "migration layout mismatch: source and destination "
                "disagree on block_size/kv_quant/n_layers/rows, or the "
                f"payload's {payload['n_blocks']} blocks exceed this "
                f"engine's table width {self._n_max}")
        if not self.free_slots:
            raise RuntimeError("no free slot for migration import")
        n, pos = int(payload["n_blocks"]), int(payload["pos"])
        if pos + int(max_new) > self.cache_len:
            raise RuntimeError(
                f"migrated position {pos} + {max_new} new tokens exceed "
                f"cache_len={self.cache_len}")
        new = self.prefix_cache.alloc_blocks_atomic(n)
        if new is None:
            raise RuntimeError(
                f"kv block pool exhausted: import needs {n} blocks "
                f"(free={self._pool.free_blocks})")
        slot = min(self.free_slots)
        t0 = time.perf_counter()
        try:
            self._scatter_block_rows(new, self._payload_rows(payload), ctx,
                                     fused)
        except Exception as e:
            for block in new:
                self._pool.decref(block)
            if not self._state_ok():
                raise EngineStateError(
                    f"migration import failed mid-device-call "
                    f"({type(e).__name__}: {e}) and the store no longer "
                    "answers: restart required") from e
            raise
        self._h_import.observe(time.perf_counter() - t0)
        bs = self.kv_block_size
        self.free_slots.discard(slot)
        self._tables[slot, :] = 0
        self._tables[slot, :n] = new
        self._slot_blocks[slot] = list(new)
        self._slot_reserved[slot] = (
            max(0, -(-(pos + int(max_new)) // bs) - n) + self._spec_headroom)
        self._pos[slot] = pos
        self._token[slot] = int(payload["token"])
        self._active[slot] = True
        gen = self._new_gen(0)
        if gen is not None and payload.get("key") is not None:
            gen.set_state(payload["key"])
        self._gens[slot] = gen
        seconds = (time.perf_counter() - float(payload["t_start"])
                   if payload.get("t_start") else 0.0)
        self._c_migrations.inc()
        self._c_migrated_blocks.inc(n)
        if seconds > 0.0:
            self._h_migration.observe(seconds)
        self._events.emit("kv_migrate", slot=slot, blocks=n, pos=pos,
                          seconds=round(seconds, 6))
        if prompt is not None:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if self._drafter is not None:
                self._drafter.on_admit(slot, prompt, int(payload["token"]))
            if self.prefix_cache.missing_blocks(prompt) >= self._min_insert:
                self.prefix_cache.insert_shared(prompt, new)
        self.peak_active = max(self.peak_active, self.active_slots)
        return slot

    def export_prefix_kv(self, tokens, ctx: Optional[dict] = None, *,
                         min_blocks: int = 1) -> Optional[dict]:
        """This engine's cached prefix of ``tokens`` on the host, through
        the fused gather: the share payload a peer adopts with
        :meth:`import_prefix_kv` instead of prefilling blocks the fleet
        already holds. ``None`` (never a raise on a cold cache) when the
        engine is not warm or the trie holds fewer than ``min_blocks`` of
        the prompt. The matched blocks are pinned only for the gather."""
        if not (self.migration_supported and self._warm):
            return None
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        m = self.prefix_cache.match(tokens)
        if m is None:
            return None
        try:
            n = len(m.block_ids)
            if n < max(1, int(min_blocks)):
                return None
            t0 = time.perf_counter()
            packed = self._gather_block_rows(list(m.block_ids), ctx, True)
            self._h_export.observe(time.perf_counter() - t0)
            return self._payload(packed, n, t0,
                                 tokens=tokens[:m.length].copy())
        finally:
            self.prefix_cache.release(m)

    def can_import_prefix(self, payload: dict, *,
                          static_only: bool = False) -> bool:
        """Check that :meth:`import_prefix_kv` would succeed: the layout
        agrees and (unless ``static_only``) the engine is warm with the
        blocks to spare. Same static/transient split as
        :meth:`can_import`."""
        if not self.migration_supported or not self._layout_ok(payload):
            return False
        if static_only:
            return True
        return (self._warm
                and int(payload["n_blocks"]) <= self.kv_blocks_admittable())

    def import_prefix_kv(self, payload: dict,
                         ctx: Optional[dict] = None) -> int:
        """Adopt a shared prefix payload into this engine's trie: allocate
        its blocks (all or none), write the rows in place, then hand them
        to the trie (``insert_shared``): each adopted block settles at
        refcount 1, held by the trie, and a block whose position was
        cached meanwhile goes straight back to the free list. The next
        admission matching the prefix prefills none of its blocks.
        Returns the blocks adopted (0: already cached here); raises
        ``RuntimeError`` with the engine as it was on a layout mismatch
        or a dry pool (the caller's fallback is a plain prefill)."""
        if not self.migration_supported:
            raise RuntimeError("prefix sharing: " + self._migration_error())
        if not self._layout_ok(payload):
            raise RuntimeError(
                "share layout mismatch: source and destination disagree "
                "on block_size/kv_quant/n_layers/rows, or the payload's "
                f"{payload['n_blocks']} blocks exceed this engine's table "
                f"width {self._n_max}")
        tokens = np.asarray(payload["tokens"], np.int32).reshape(-1)
        if self.prefix_cache.missing_blocks(tokens) == 0:
            return 0                       # already cached here
        n = int(payload["n_blocks"])
        new = self.prefix_cache.alloc_blocks_atomic(n)
        if new is None:
            raise RuntimeError(
                f"kv block pool exhausted: share import needs {n} blocks "
                f"(free={self._pool.free_blocks})")
        t0 = time.perf_counter()
        try:
            self._scatter_block_rows(new, self._payload_rows(payload), ctx,
                                     True)
        except Exception as e:
            for block in new:
                self._pool.decref(block)
            if not self._state_ok():
                raise EngineStateError(
                    f"share import failed mid-device-call "
                    f"({type(e).__name__}: {e}) and the store no longer "
                    "answers: restart required") from e
            raise
        self._h_import.observe(time.perf_counter() - t0)
        adopted = self.prefix_cache.insert_shared(tokens, new)
        for block in new:
            self._pool.decref(block)
        return adopted

    # ------------------------------------------------------------------ #
    # paged block management                                               #
    # ------------------------------------------------------------------ #

    def blocks_needed(self, prompt_len: int, max_new: int,
                      start: int = 0) -> int:
        """Worst-case new blocks a request admits with: blocks covering
        ``[start, prompt_len + max_new)`` (``start`` cached tokens sit in
        shared blocks) plus the multi-token round's headroom."""
        bs = self.kv_block_size
        return (-(-(prompt_len + max_new) // bs) - start // bs
                + self._spec_headroom)

    def kv_blocks_admittable(self) -> int:
        """Blocks an admission may claim without starving a decode: free
        blocks plus trie blocks eviction could reclaim, minus the growth
        active slots have reserved."""
        return (self._pool.free_blocks
                + self.prefix_cache.evictable_blocks()
                - int(self._slot_reserved.sum()))

    def _horizon_block_range(self, slot: int) -> range:
        """Table indices the slot's next round may write: blocks covering
        ``[pos, pos + write_horizon]`` inside ``cache_len`` (horizon 0 is
        the next write's block)."""
        bs = self.kv_block_size
        p = int(self._pos[slot])
        if p >= self.cache_len:
            return range(0)
        hi = min(p + self._write_horizon, self.cache_len - 1)
        return range(p // bs, hi // bs + 1)

    def slot_needs_block(self, slot: int) -> bool:
        """True when a write of the slot's next round falls in a block it
        has not allocated yet (a table entry in the span still points at
        scratch)."""
        if not self.paged or not self._active[slot]:
            return False
        return any(self._tables[slot, i] == 0
                   for i in self._horizon_block_range(slot))

    def append_block(self, slot: int) -> bool:
        """Allocate the first unallocated block of the slot's next round
        (evicting idle trie prefixes when the free list is dry). False
        when the pool is truly exhausted: the scheduler then preempts a
        request and retries. Carries the ``serving.kv_append`` cut-point."""
        inject(SERVING_KV_APPEND, slot=slot, pos=int(self._pos[slot]))
        idx = next((i for i in self._horizon_block_range(slot)
                    if self._tables[slot, i] == 0), None)
        if idx is None:
            return True
        got = self.prefix_cache.alloc_blocks(1)
        if not got:
            return False
        block = got[0]
        self._tables[slot, idx] = block
        self._slot_blocks[slot].append(block)
        if self._slot_reserved[slot] > 0:
            self._slot_reserved[slot] -= 1
        self._c_appends.inc()
        self._events.emit("kv_append", slot=slot, block=block,
                          pos=int(self._pos[slot]))
        return True

    def slot_block_count(self, slot: int) -> int:
        """Blocks the slot's table references now (0 for a dense
        engine)."""
        return len(self._slot_blocks[slot]) if self.paged else 0

    def slot_block_shares(self, slot: int) -> float:
        """Refcount-weighted blocks the slot holds now (0.0 when dense):
        a private block counts 1, a prefix block shared by ``r`` live
        holders ``1/r``, so the sum over holders is the pool's true
        occupancy. The cost ledger integrates it into per-tenant KV
        block-seconds, once a step over every slot: one numpy expression
        over the slot's block ids, not a Python loop over refcounts."""
        if not self.paged or not self._slot_blocks[slot]:
            return 0.0
        refs = self._pool.refcounts[self._slot_blocks[slot]]
        return float((1.0 / np.maximum(refs, 1)).sum())

    def slot_tokens_used(self, slot: int) -> int:
        """Current sequence depth of a slot (prompt plus generated so
        far); 0 when the slot is free."""
        return int(self._pos[slot]) + 1 if self._active[slot] else 0

    def kv_pool_stats(self) -> tuple[int, int]:
        """(blocks in use, blocks free)."""
        return self._pool.used_blocks, self._pool.free_blocks

    def kv_stats(self) -> dict:
        """Paged-store occupancy and configuration (``{}`` when dense)."""
        if not self.paged:
            return {}
        return {
            "kv_blocks": self.kv_blocks,
            "kv_block_size": self.kv_block_size,
            "kv_quant": self.kv_quant,
            "blocks_in_use": self._pool.used_blocks,
            "blocks_free": self._pool.free_blocks,
            "blocks_evictable": self.prefix_cache.evictable_blocks(),
            "blocks_reserved": int(self._slot_reserved.sum()),
            "peak_active": self.peak_active,
        }

    # ------------------------------------------------------------------ #
    # dense prefix inserts                                                 #
    # ------------------------------------------------------------------ #

    def flush_inserts(self) -> None:
        """Copy the pending prompts' new full blocks into the dense
        engine's prefix store. The scheduler calls it after each step's
        tokens are delivered; admission calls it before picking slots, so
        a donor's rows are copied before its slot can be reused. A no-op
        for the paged engine, whose inserts are zero-copy."""
        if self.paged:
            return
        pending, self._pending_inserts = self._pending_inserts, []
        for prompt, slot in pending:
            self._insert_prefix(prompt, slot)
        if pending:
            self._guard.check()

    def _insert_prefix(self, prompt: np.ndarray, slot: int) -> None:
        """Cache a freshly prefilled prompt's full blocks through the
        prefix-insert program, best effort: a failure aborts the insert
        and never touches the admitted request."""
        if self.prefix_cache.missing_blocks(prompt) < self._min_insert:
            return
        plan = self.prefix_cache.plan_insert(prompt)
        if plan is None:
            return
        try:
            inject(SERVING_PREFIX_COPY, op="insert", slot=slot,
                   blocks=len(plan.block_ids))
            nb = self._n_prog_blocks
            ids = np.full((nb,), plan.block_ids[0], np.int64)
            ids[:len(plan.block_ids)] = plan.block_ids
            starts = np.full((nb,), plan.row_starts[0], np.int64)
            starts[:len(plan.row_starts)] = plan.row_starts
            with self._watched("serving prefix insert"), \
                    annotate("chainermn.prefix_insert"):
                self._insert_prog.run(slot=np.array([slot], np.int64),
                                      ids=ids, row_starts=starts)
            self.prefix_cache.commit_insert(plan)
        except Exception as e:  # noqa: BLE001 — inserting is best effort
            self.prefix_cache.abort_insert(plan)
            self._events.emit("prefix_insert_error", error=type(e).__name__,
                              detail=str(e)[:200])

    # ------------------------------------------------------------------ #
    # decode rounds                                                        #
    # ------------------------------------------------------------------ #

    def decode_step(self, ctx: Optional[dict] = None) -> dict[int, int]:
        """Advance every active slot one token (one pass of the model over
        the whole pool); returns ``{slot: token}`` for the active slots,
        ``{}`` when none is active. The token fetch is the step's one
        device-to-host sync, inside the watchdog window."""
        if not self._active.any():
            return {}
        with self._watched("serving decode_step", **(ctx or {})), \
                annotate("chainermn.serving_decode"):
            inject(SERVING_DECODE, active=self.active_slots)
            nxt = device_fetch(self._decode_round(1))[:, 0]
        self._guard.check()
        self._c_decode_steps.inc()
        self._events.emit("decode_step", active=self.active_slots)
        out = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            tok = int(nxt[slot])
            self._token[slot] = tok
            self._pos[slot] += 1
            out[slot] = tok
        return out

    def decode_steps(self, ctx: Optional[dict] = None
                     ) -> dict[int, list[int]]:
        """Advance every active slot ``decode_window`` tokens in one engine
        call: ``decode_window`` real one-token steps, each feeding the
        last one's tokens, with one fetch at the end. Returns ``{slot:
        [tokens...]}``; the stream equals ``decode_window`` calls of
        :meth:`decode_step` (the same generator draws), and the scheduler
        drops the tail past a retirement."""
        if self.decode_window < 2:
            raise RuntimeError(
                "decode_steps needs ServingEngine(decode_window=n>1)")
        if not self._active.any():
            return {}
        n = self.decode_window
        with self._watched("serving decode_steps", **(ctx or {})), \
                annotate("chainermn.serving_decode"):
            inject(SERVING_DECODE, active=self.active_slots, window=n)
            out = device_fetch(self._decode_round(n))
        self._guard.check()
        self._c_decode_steps.inc()
        self._events.emit("decode_step", active=self.active_slots, window=n)
        res = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            toks = [int(t) for t in out[slot]]
            self._token[slot] = toks[-1]
            self._pos[slot] += n
            res[slot] = toks
        return res

    def spec_decode_step(self, ctx: Optional[dict] = None
                         ) -> dict[int, list[int]]:
        """One speculative round for every active slot: draft ``k`` tokens
        a slot, verify the ``k + 1``-token window in one forward, and
        commit each slot's longest matching draft prefix plus the
        correction token. Returns ``{slot: [tokens...]}``; blocks appended
        for rejected rows are rolled back."""
        if self._spec is None:
            raise RuntimeError(
                "spec_decode_step needs ServingEngine(speculative=...)")
        if not self._active.any():
            return {}
        k = self._spec.k
        drafts = self._drafter.propose(k)             # [n_slots, k] int32
        tokens = np.concatenate([self._token[:, None], drafts], axis=1)
        # rows past valid write into the scratch block: a slot near
        # cache_len must not reach past its table
        valid = np.where(self._active,
                         np.clip(self.cache_len - self._pos, 0, k + 1),
                         0).astype(np.int32)
        with self._watched("serving spec_verify", **(ctx or {})), \
                annotate("chainermn.serving_spec_verify"):
            inject(SERVING_SPEC_VERIFY, active=self.active_slots, k=k)
            g = device_fetch(self._spec_verify(tokens, valid))
        self._guard.check()
        self._c_decode_steps.inc()
        self._spec_rounds += 1
        self._events.emit("decode_step", active=self.active_slots,
                          window=k + 1)
        res = {}
        proposed = accepted = 0
        lengths = []
        spec_slots = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            kd = min(k, int(valid[slot]) - 1)   # drafts that fit the slot
            a = 0
            while a < kd and int(drafts[slot, a]) == int(g[slot, a]):
                a += 1
            toks = [int(t) for t in drafts[slot, :a]] + [int(g[slot, a])]
            self._token[slot] = toks[-1]
            self._pos[slot] += len(toks)
            self._drafter.on_commit(slot, toks)
            self._rollback_spec_blocks(slot)
            proposed += kd
            accepted += a
            lengths.append(a)
            spec_slots[slot] = (kd, a)
            res[slot] = toks
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted
        self._last_spec_window = (proposed, accepted, lengths)
        self._last_spec_slots = spec_slots
        return res

    def _rollback_spec_blocks(self, slot: int) -> None:
        """Free the blocks the window appended past the block of the
        slot's next write (back into its reserved headroom). Shared prefix
        blocks are out of reach: they cover rows below the prompt's end."""
        keep = min(int(self._pos[slot]) // self.kv_block_size + 1,
                   self._n_max)
        freed = 0
        for idx in range(keep, self._n_max):
            block = int(self._tables[slot, idx])
            if block == 0:
                continue
            self._pool.decref(block)
            self._slot_blocks[slot].remove(block)
            self._tables[slot, idx] = 0
            self._slot_reserved[slot] += 1
            freed += 1
        if freed:
            self._events.emit("spec_rollback", slot=slot, blocks=freed,
                              pos=int(self._pos[slot]))

    def decode_round(self, ctx: Optional[dict] = None
                     ) -> dict[int, list[int]]:
        """One decode call under the engine's mode — the scheduler's one
        entry point: a verify window, a decode window, or one token."""
        if self._spec is not None:
            return self.spec_decode_step(ctx=ctx)
        if self.decode_window > 1:
            return self.decode_steps(ctx=ctx)
        return {slot: [tok]
                for slot, tok in self.decode_step(ctx=ctx).items()}

    @property
    def spec_enabled(self) -> bool:
        return self._spec is not None

    @property
    def last_spec_slots(self) -> dict:
        """``{slot: (drafts that fit, drafts accepted)}`` of the last
        verify round; not cleared on read."""
        return self._last_spec_slots

    def pop_spec_window(self) -> Optional[tuple]:
        """``(proposed, accepted, accept_lengths)`` of the last verify
        round, cleared on read (the scheduler drains it into its
        metrics)."""
        win, self._last_spec_window = self._last_spec_window, None
        return win

    def spec_stats(self) -> dict:
        """Cumulative speculative counters (``{}`` when speculation is
        off)."""
        if self._spec is None:
            return {}
        prop = self._spec_proposed_total
        acc = self._spec_accepted_total
        return {
            "drafter": self._spec.drafter,
            "spec_k": self._spec.k,
            "spec_rounds": self._spec_rounds,
            "spec_tokens_proposed": prop,
            "spec_tokens_accepted": acc,
            "accept_rate": (acc / prop) if prop else 0.0,
        }

    def release(self, slot: int) -> None:
        """Retire a slot: paged, its block references go back to the pool
        (blocks the prefix trie also holds stay resident for later hits),
        and a half-prefilled chunked slot releases the same way. The
        caches are not zeroed: the position mask makes stale rows
        unreachable to the next tenant."""
        if slot in self.free_slots:
            return
        if self.paged:
            for block in self._slot_blocks[slot]:
                self._pool.decref(block)
            self._slot_blocks[slot] = []
            self._slot_reserved[slot] = 0
            self._tables[slot, :] = 0
            self._chunking.pop(slot, None)
        if self._drafter is not None:
            self._drafter.on_release(slot)
        self._gens[slot] = None
        self._active[slot] = False
        self.free_slots.add(slot)

    def restart(self) -> None:
        """Warm restart after an engine-side failure, in place: every store
        and cache is zeroed where it lies (the captured programs hold
        their addresses), the prefix trie and the pool are emptied with
        them (a stale trie would "hit" on KV that is gone), the slot
        tables, mirrors and generators are cleared, and the drafter is
        reset. The same programs run afterwards with nothing rebuilt. The
        scheduler drives this from its exception boundary; every restart
        is counted (``serving_engine_restarts_total``) and logged. A
        tensor-parallel leader's followers zero their shards too."""
        if self._channel is not None:
            self._channel.send(RESTART)
        self._zero_stores()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        if self.paged:
            self._pool.reset()
            self._tables[:] = 0
            self._slot_blocks = [[] for _ in range(self.n_slots)]
            self._slot_reserved[:] = 0
            self._chunking.clear()
        self._pending_inserts = []
        self._token[:] = 0
        self._pos[:] = 0
        self._active[:] = False
        self._gens = [None] * self.n_slots
        self.free_slots = set(range(self.n_slots))
        if self._drafter is not None:
            self._drafter.reset()
        self._c_restarts.inc()
        self._events.emit("engine_restart")

    def _zero_stores(self) -> None:
        with torch.no_grad():
            for layers in (self._store, self.caches):
                for layer in layers or ():
                    for t in layer.values():
                        t.zero_()

    def _copy_params(self, new_state) -> None:
        with torch.no_grad():
            for name, old in self.model.state_dict().items():
                old.copy_(new_state[name])

    def follow(self) -> dict[str, int]:
        """A tensor-parallel follower's loop (ranks > 0 of the axis):
        replay each program the leader announces on this rank's shards,
        zero the stores on its restarts, copy its weight swaps; when the
        leader closes, return how many times each program ran
        (:mod:`._tp`)."""
        if self._channel is None or self._channel.leader:
            raise RuntimeError("follow() is for ranks > 0 of a tensor-"
                               "parallel engine; rank 0 drives it")
        progs, runs = self._programs, {}
        progs.replaying = True
        try:
            while True:
                name, payload = self._channel.recv()
                if name == CLOSE:
                    return runs
                if name == RESTART:
                    self._zero_stores()
                elif name == SWAP:
                    self._copy_params(payload)
                else:
                    progs.programs[name].run(**payload)
                    runs[name] = runs.get(name, 0) + 1
        finally:
            progs.replaying = False

    def close(self) -> None:
        """End a tensor-parallel engine's followers (the leader's call;
        idempotent; a no-op for a single-device engine)."""
        if self._channel is not None and self._channel.leader \
                and not self._closed:
            self._channel.send(CLOSE)
        self._closed = True

    def swap_params(self, new_state, *, version: Optional[int] = None
                    ) -> int:
        """Copy a new weight set into the model's parameters in place and
        return the new version. ``new_state`` maps exactly
        ``model.state_dict()``'s keys to tensors of the same shape and of
        the dtype the engine stores (matmul weights in the compute dtype
        after ``cast_weights_()``). Every entry is checked before any is
        written, so a rejected swap raises :class:`EngineStateError`
        naming the first mismatch and leaves every parameter as it was.
        The programs read the parameters' storage, so they run on the new
        weights with nothing rebuilt. The prefix trie is cleared with the
        swap: its blocks hold KV the old weights computed (the reference
        keeps its trie, which would serve that KV to the new weights). The
        scheduler runs it behind its swap fence
        (:meth:`FCFSScheduler.request_swap`), where no slot is active."""
        cur = self.model.state_dict()
        if not isinstance(new_state, Mapping):
            raise EngineStateError(f"swap_params: expected a mapping of "
                                   f"tensors, got {type(new_state).__name__}")
        missing = [k for k in cur if k not in new_state]
        extra = [k for k in new_state if k not in cur]
        if missing or extra:
            raise EngineStateError(
                f"swap_params: keys differ from the model's state_dict "
                f"(missing {missing[:3]}, unexpected {extra[:3]})")
        for name, old in cur.items():
            new = new_state[name]
            if not isinstance(new, torch.Tensor) or \
                    tuple(new.shape) != tuple(old.shape) or \
                    new.dtype != old.dtype:
                raise EngineStateError(
                    f"swap_params: {name!r} is "
                    f"{tuple(getattr(new, 'shape', ()))}/"
                    f"{getattr(new, 'dtype', type(new).__name__)}, the "
                    f"engine stores {tuple(old.shape)}/{old.dtype}")
        if self._channel is not None:
            self._channel.send(SWAP, {k: v.detach().cpu()
                                      for k, v in new_state.items()})
        self._copy_params(new_state)
        if self.prefix_cache is not None:
            self._pending_inserts = []
            self.prefix_cache.clear()
        self.weight_version = (int(version) if version is not None
                               else self.weight_version + 1)
        self._g_weight_version.set(self.weight_version)
        self._events.emit("weight_swap", version=self.weight_version)
        return self.weight_version

    def compile_counts(self) -> dict[str, int]:
        """Builds of the prefill family (summed over buckets) and of the
        decode program: ``{'prefill': len(buckets), 'decode': 1}`` after
        :meth:`warmup`, and no later call adds one."""
        return {"prefill": sum(p._cache_size()
                               for p in self._prefill_progs.values()),
                "decode": self._decode_prog._cache_size()}

    def compile_counts_detailed(self) -> dict[str, int]:
        """Builds per program (every bucket, decode, the decode window, the
        verify window, the prefix insert, the drafter's two, and the paged
        engine's ``kv_gather_{w}``/``kv_scatter_{w}`` at every migration
        width): each exactly 1 after :meth:`warmup`."""
        out = {f"prefill_{b}": p._cache_size()
               for b, p in self._prefill_progs.items()}
        out["decode"] = self._decode_prog._cache_size()
        if self._insert_prog is not None:
            out["prefix_insert"] = self._insert_prog._cache_size()
        if self._spec_prog is not None:
            out["spec_verify"] = self._spec_prog._cache_size()
            out.update(self._drafter.compile_counts())
        if self._window_prog is not None:
            out["decode_window"] = self._window_prog._cache_size()
        for w in self._gather_progs:
            out[f"kv_gather_{w}"] = self._gather_progs[w]._cache_size()
            out[f"kv_scatter_{w}"] = self._scatter_progs[w]._cache_size()
        return out

    @property
    def recompiles(self) -> dict[str, int]:
        """Rebuilds past each program's first build (the guard's live
        count; empty while the fixed-program invariant holds)."""
        return self._guard.recompiles

    def prefix_stats(self) -> dict:
        """The prefix cache's hit, eviction and occupancy numbers."""
        return self.prefix_cache.stats() if self.prefix_cache else {}

    def occupancy(self) -> dict:
        """Host-side occupancy snapshot (no device call)."""
        if self.paged:
            kv_free = self._pool.free_blocks / max(self._pool.capacity, 1)
        else:
            kv_free = len(self.free_slots) / max(self.n_slots, 1)
        return {
            "n_slots": self.n_slots,
            "active_slots": self.active_slots,
            "free_slots": len(self.free_slots),
            "kv_free_frac": kv_free,
            "prefix_enabled": self.prefix_enabled,
            "paged": self.paged,
            "warm": self._warm,
            "weight_version": self.weight_version,
        }


__all__ = ["AdmitPlan", "ChunkedPrefill", "EngineStateError",
           "ServingEngine"]
