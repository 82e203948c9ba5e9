"""Continuous-batching decode engine over the paged KV store (the port of
the paged path of ``chainermn_tpu/serving/engine.py``).

One shared block store (:func:`~chainermn_torch.models.transformer.
init_paged_kv_caches`) holds every slot's KV; each slot reaches its
sequence through a row of the ``[n_slots, max_blocks]`` block table, kept
on the host and sent with every call. Block 0 is a reserved scratch
block: inactive rows and unallocated table entries point at it, so
ride-along writes land nowhere. Slots allocate blocks lazily as their
sequence crosses block boundaries (:meth:`ServingEngine.append_block`,
driven by the scheduler); a prefix-cache hit is a shared table entry (no
copy); retirement gives the slot's block references back to the pool.

Two device paths, both plain eager PyTorch around the model:

- **prefill** (per bucket of padded prompt-suffix lengths): up to
  ``prefill_batch`` requests write their suffix K/V through their table
  rows and sample their first token from their last real position;
- **decode step**: every slot advances one token at its own position.
  With ``paged_kernel=True`` the attention read of each layer is the
  hand-written paged-decode CUDA kernel
  (:func:`chainermn_torch.parallel.paged_kernel.paged_attend`); prefill
  and every write stay plain torch, as in the reference.

Why stale rows never leak: the causal position mask only admits rows at
positions ``<= q_pos``, and each of those was written by this request's
prefill or one of its decode steps (each step writes its row before it
attends). Shared prefix blocks are never written: a match covers only
full prompt blocks, and every write position ``>= match.length`` lands in
a block the slot owns.

Per-request sampling: each slot holds its own ``torch.Generator`` seeded
from the request's integer ``seed`` at admission, so its draws do not
depend on its batch neighbours and a preempted request replays the same
stream. Greedy decoding (``temperature=0``) draws nothing.

The dense per-slot engine (``paged=False``), tensor parallelism,
speculative decoding, decode windows, chunked prefill, KV migration,
``restart``/``swap_params``, the watchdog and fault cut-points are not
part of this port yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from chainermn_torch._device import resolve_device
from chainermn_torch.dataflow.dispatch import device_fetch
from chainermn_torch.models.transformer import (
    _check_sampler,
    _sampler,
    init_paged_kv_caches,
)
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.serving.prefix_cache import (
    BlockPool,
    PrefixCacheIndex,
    PrefixMatch,
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


class ServingEngine:
    """Slot-pool paged-KV decode engine (mechanism only; admission policy
    and request bookkeeping live in
    :class:`~chainermn_torch.serving.scheduler.FCFSScheduler`).

    Parameters
    ----------
    model : TransformerLM
        On ``device``. The engine calls ``model.cast_weights_()`` (matmul
        weights stored in the compute dtype; logits unchanged).
    n_slots : int
        Concurrently decoding requests: the decode batch.
    prefill_len / prefill_buckets :
        Largest admitted prompt, and the ascending ladder of padded
        prompt-suffix lengths (default ``(prefill_len,)``).
    prefill_batch : int
        Requests admitted per prefill call (clamped to ``n_slots``).
    paged : bool
        Must be True: only the paged path is ported.
    kv_blocks : int, optional
        Store blocks including the scratch block; default
        ``n_slots * ceil(cache_len / kv_block_size) + 1``.
    kv_block_size : int
        Tokens per block.
    kv_quant : {'none', 'int8'}
        int8 rows with per-row-per-head f32 scales.
    paged_kernel : bool
        Decode attention reads through the hand-written CUDA kernel.
    cache_len : int, optional
        Per-slot KV capacity (prompt + generated); default
        ``model.max_len``.
    temperature / top_k / top_p :
        Sampler shared by every request.
    device : optional
        Where the engine runs: the current CUDA card when ``None`` (raises
        when there is none); ``"cpu"`` must be asked for.
    """

    def __init__(self, model, *, n_slots: int,
                 prefill_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefill_batch: int = 1, paged: bool = True,
                 kv_blocks: Optional[int] = None, kv_block_size: int = 16,
                 kv_quant: str = "none", paged_kernel: bool = False,
                 cache_len: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, device=None) -> None:
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}: move the model first")
        if not paged:
            raise ValueError("only the paged engine is ported "
                             "(pass paged=True); the dense per-slot cache "
                             "is still to port (ROADMAP.md)")
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
        _check_sampler(model, float(temperature), int(top_k), float(top_p))
        self.model = model.eval().cast_weights_()
        self.n_slots = int(n_slots)
        self.prefill_buckets = buckets
        self.prefill_len = buckets[-1]
        self.prefill_batch = min(int(prefill_batch), self.n_slots)
        self.cache_len = int(cache_len)
        self.kv_quant = kv_quant
        self.paged_kernel = bool(paged_kernel)
        self.temperature = float(temperature)
        self._sample = _sampler(self.temperature, int(top_k), float(top_p))
        self._events = get_event_log()
        reg = get_registry()
        labels = {"engine": "serving"}
        self._c_prefills = {
            b: reg.counter("serving_prefills_total",
                           dict(labels, prefill_bucket=str(b)))
            for b in buckets}
        self._c_appends = reg.counter("kv_block_appends_total", labels)
        self._c_decode_steps = reg.counter(
            "serving_decode_steps_total",
            dict(labels, paged_kernel="on" if self.paged_kernel else "off"))
        self.peak_active = 0

        self.kv_block_size = int(kv_block_size)
        # table width: blocks covering a full-length slot
        self._n_max = -(-self.cache_len // self.kv_block_size)
        self.kv_blocks = int(kv_blocks if kv_blocks is not None
                             else self.n_slots * self._n_max + 1)
        self._pool = BlockPool(self.kv_blocks, reserve_scratch=True)
        self.prefix_cache = PrefixCacheIndex(self.kv_block_size,
                                             pool=self._pool)
        self._store = init_paged_kv_caches(model, self.kv_blocks,
                                           self.kv_block_size,
                                           quant=kv_quant,
                                           device=self.device)
        self._tables = np.zeros((self.n_slots, self._n_max), np.int32)
        self._slot_blocks: list[list[int]] = [[] for _ in range(n_slots)]
        # worst-case growth blocks each active slot may still append:
        # admission reserves them, append_block draws them down
        self._slot_reserved = np.zeros((self.n_slots,), np.int64)
        self._token = np.zeros((self.n_slots,), np.int32)
        self._pos = np.zeros((self.n_slots,), np.int32)
        self._active = np.zeros((self.n_slots,), bool)
        self._gens: list[Optional[torch.Generator]] = [None] * self.n_slots
        self.free_slots = set(range(self.n_slots))
        self._warm = False

    # ------------------------------------------------------------------ #
    # device paths                                                         #
    # ------------------------------------------------------------------ #

    def _dev(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _span(self, max_len: int) -> int:
        """Table entries covering the longest row's ``max_len`` rows —
        the read span, from host values (no device sync)."""
        return max(1, min(self._n_max, -(-int(max_len)
                                         // self.kv_block_size)))

    def _row_gens(self, gens: Sequence[Optional[torch.Generator]]):
        """Per-row generators for a sampled call (``None`` when greedy);
        rows without one (inactive) draw from a throwaway generator."""
        if not self.temperature:
            return None
        spare = torch.Generator(device=self.device)
        return [g if g is not None else spare for g in gens]

    @torch.inference_mode()
    def _paged_prefill(self, bucket: int, table, tokens, starts, last_idx,
                       active, gens):
        """Each group row writes its padded suffix through its table row
        into the shared store, attends its table span, and samples its
        first token from its last real position. Inactive rows carry
        all-scratch tables."""
        k = len(starts)
        tab = self._dev(table)
        caches = [dict(layer, table=tab,
                       max_blocks=self._span(int(starts.max()) + bucket))
                  for layer in self._store]
        pos = (self._dev(starts).long()[:, None]
               + torch.arange(bucket, device=self.device)[None, :])
        logits = self.model(self._dev(tokens).long(), pos, kv_caches=caches)
        lg = logits[torch.arange(k, device=self.device),
                    self._dev(last_idx).long()]
        nxt = self._sample(lg, self._row_gens(gens))
        return torch.where(self._dev(active), nxt, torch.zeros_like(nxt))

    @torch.inference_mode()
    def _paged_decode(self):
        """One token for every slot through the ``[n_slots, max_blocks]``
        table. Inactive rows decode at position 0 of their all-scratch
        table row (their output is discarded), so the read span and the
        kernel's per-row work follow the active rows only."""
        act = self._active
        pos = np.where(act, self._pos, 0).astype(np.int64)
        span = self._span(int(pos.max()) + 1)
        tab = self._dev(self._tables)
        caches = [dict(layer, table=tab, max_blocks=span,
                       use_kernel=self.paged_kernel)
                  for layer in self._store]
        lg = self.model(self._dev(self._token).long()[:, None],
                        self._dev(pos)[:, None], kv_caches=caches)[:, 0]
        nxt = self._sample(lg, self._row_gens(self._gens))
        return torch.where(self._dev(act), nxt, torch.zeros_like(nxt))

    def warmup(self) -> None:
        """Run every prefill bucket and the decode step once on no-op
        inputs (all rows inactive, all-scratch tables: every write lands
        in the scratch block). This builds the paged-decode kernel when
        ``paged_kernel`` is on a CUDA device, and takes the first-call
        costs of the math libraries off the first request."""
        if self._warm:
            return
        if self.active_slots:
            raise RuntimeError("warmup needs an idle engine")
        k = self.prefill_batch
        zeros = np.zeros((k,), np.int32)
        for b in self.prefill_buckets:
            self._paged_prefill(b, np.zeros((k, self._n_max), np.int32),
                                np.zeros((k, b), np.int32), zeros, zeros,
                                np.zeros((k,), bool), [None] * k)
        self._paged_decode()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        self._events.emit("serving_warmup", buckets=list(self.prefill_buckets),
                          prefill_batch=k, paged=True,
                          paged_kernel=self.paged_kernel)

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
        max_blocks = self._n_max
        while True:
            match = (self.prefix_cache.match(prompt, max_blocks)
                     if max_blocks > 0 else None)
            if match is None or self.bucket_for(
                    len(prompt) - match.length, match.length) is not None:
                break
            # a long match can leave no bucket inside cache_len: shrink
            max_blocks = len(match.nodes) - 1
            self.prefix_cache.release(match)
        start = match.length if match is not None else 0
        bucket = self.bucket_for(len(prompt) - start, start)
        return AdmitPlan(prompt=prompt, seed=int(seed or 0), match=match,
                         start=start, bucket=bucket, max_new=int(max_new))

    def cancel_plan(self, plan: AdmitPlan) -> None:
        """Discard an unused plan, unpinning its prefix match."""
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
        need = self.blocks_needed(prompt_len, max_new_tokens)
        if need > self._pool.capacity:
            raise ValueError(
                f"request needs {need} KV blocks worst-case but the pool "
                f"holds {self._pool.capacity} — raise kv_blocks or shrink "
                "the request")

    def _paged_alloc_slot(self, plan: AdmitPlan, slot: int) -> list:
        """Allocate the blocks a plan's prefill writes (shared prefix
        blocks are referenced, not copied), write the slot's table mirror
        and reserve its worst-case decode growth. Raises ``RuntimeError``
        when the pool (plus trie eviction) cannot cover it."""
        bs = self.kv_block_size
        plen = len(plan.prompt)
        shared = list(plan.match.block_ids) if plan.match is not None else []
        need_now = -(-plen // bs) - len(shared)
        new = self.prefix_cache.alloc_blocks(need_now)
        if len(new) < need_now:
            for block in new:
                self._pool.decref(block)
            raise RuntimeError(
                f"kv block pool exhausted: slot {slot} needs {need_now} "
                f"blocks, {len(new)} allocatable (free="
                f"{self._pool.free_blocks})")
        for block in shared:
            self._pool.incref(block)    # the slot co-owns its prefix
        ids = shared + new
        self._tables[slot, :] = 0
        self._tables[slot, :len(ids)] = ids
        self._slot_reserved[slot] = (-(-(plen + plan.max_new) // bs)
                                     - (-(-plen // bs)))
        return ids

    def admit_batch(self, plans: Sequence[AdmitPlan], *,
                    ctx: Optional[dict] = None) -> list[tuple[int, int]]:
        """Admit a same-bucket group in ONE prefill call: allocate table
        rows (prefix hits are shared entries), run the prefill, then commit
        the slot mirrors and adopt each prompt's full blocks into the
        prefix trie. Returns ``[(slot, first_token), ...]`` in plan order.
        A failure rolls the allocations back and re-raises; the rows it
        may have written belong to blocks now free, which a later tenant
        rewrites before reading. ``ctx`` labels the prefill event."""
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
        bucket = plans[0].bucket
        k = self.prefill_batch
        slots = sorted(self.free_slots)[:len(plans)]
        records: list[tuple[int, list]] = []
        gens: list[Optional[torch.Generator]] = [None] * k
        try:
            try:
                tokens = np.zeros((k, bucket), np.int32)
                starts = np.zeros((k,), np.int32)
                last = np.zeros((k,), np.int32)
                active = np.zeros((k,), bool)
                table = np.zeros((k, self._n_max), np.int32)
                for i, (plan, slot) in enumerate(zip(plans, slots)):
                    ids = self._paged_alloc_slot(plan, slot)
                    records.append((slot, ids))
                    table[i, :len(ids)] = ids
                    suffix = plan.prompt[plan.start:]
                    tokens[i, :len(suffix)] = suffix
                    starts[i] = plan.start
                    last[i] = len(suffix) - 1
                    active[i] = True
                    if self.temperature:
                        gens[i] = torch.Generator(
                            device=self.device).manual_seed(plan.seed)
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
            self.free_slots.discard(slot)
            self._token[slot] = first
            self._pos[slot] = len(plan.prompt)
            self._active[slot] = True
            self._gens[slot] = gens[i]
            self._slot_blocks[slot] = list(ids)
            self._c_prefills[bucket].inc()
            self._events.emit("prefill", slot=slot,
                              prompt_len=len(plan.prompt), bucket=bucket,
                              cached=plan.start, batch=len(plans),
                              blocks=len(ids), **(ctx or {}))
            out.append((slot, first))
            # zero-copy trie insert: the slot's blocks already hold the
            # prompt's KV, so adopting them IS the cache insert
            self.prefix_cache.insert_shared(plan.prompt, ids)
        self.peak_active = max(self.peak_active, self.active_slots)
        return out

    # ------------------------------------------------------------------ #
    # paged block management                                               #
    # ------------------------------------------------------------------ #

    def blocks_needed(self, prompt_len: int, max_new: int,
                      start: int = 0) -> int:
        """Worst-case new blocks a request admits with: blocks covering
        ``[start, prompt_len + max_new)`` (``start`` cached tokens sit in
        shared blocks)."""
        bs = self.kv_block_size
        return -(-(prompt_len + max_new) // bs) - start // bs

    def kv_blocks_admittable(self) -> int:
        """Blocks an admission may claim without starving a decode: free
        blocks plus trie blocks eviction could reclaim, minus the growth
        active slots have reserved."""
        return (self._pool.free_blocks
                + self.prefix_cache.evictable_blocks()
                - int(self._slot_reserved.sum()))

    def _next_block_index(self, slot: int) -> Optional[int]:
        """Table index of the slot's next write (``None`` past
        ``cache_len``)."""
        p = int(self._pos[slot])
        return p // self.kv_block_size if p < self.cache_len else None

    def slot_needs_block(self, slot: int) -> bool:
        """True when the slot's next decode write falls in a block it has
        not allocated yet (its table entry still points at scratch)."""
        if not self._active[slot]:
            return False
        idx = self._next_block_index(slot)
        return idx is not None and self._tables[slot, idx] == 0

    def append_block(self, slot: int) -> bool:
        """Allocate the block of the slot's next write (evicting idle trie
        prefixes when the free list is dry). False when the pool is truly
        exhausted: the scheduler then preempts a request and retries."""
        idx = self._next_block_index(slot)
        if idx is None or self._tables[slot, idx] != 0:
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
        """Blocks the slot's table references now."""
        return len(self._slot_blocks[slot])

    def kv_pool_stats(self) -> tuple[int, int]:
        """(blocks in use, blocks free)."""
        return self._pool.used_blocks, self._pool.free_blocks

    def kv_stats(self) -> dict:
        """Paged-store occupancy and configuration."""
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
    # decode + retirement                                                  #
    # ------------------------------------------------------------------ #

    def decode_step(self, ctx: Optional[dict] = None) -> dict[int, int]:
        """Advance every active slot one token (one pass of the model over
        the whole pool); returns ``{slot: token}`` for the active slots,
        ``{}`` when none is active. The token fetch is the step's one
        device-to-host sync."""
        if not self._active.any():
            return {}
        nxt = device_fetch(self._paged_decode())
        self._c_decode_steps.inc()
        self._events.emit("decode_step", active=self.active_slots,
                          **(ctx or {}))
        out = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            tok = int(nxt[slot])
            self._token[slot] = tok
            self._pos[slot] += 1
            out[slot] = tok
        return out

    def release(self, slot: int) -> None:
        """Retire a slot: its block references go back to the pool
        (blocks the prefix trie also holds stay resident for later hits).
        The store is not zeroed: the position mask makes stale rows
        unreachable to the next tenant."""
        if slot in self.free_slots:
            return
        for block in self._slot_blocks[slot]:
            self._pool.decref(block)
        self._slot_blocks[slot] = []
        self._slot_reserved[slot] = 0
        self._tables[slot, :] = 0
        self._gens[slot] = None
        self._active[slot] = False
        self.free_slots.add(slot)

    def occupancy(self) -> dict:
        """Host-side occupancy snapshot (no device call)."""
        return {
            "n_slots": self.n_slots,
            "active_slots": self.active_slots,
            "free_slots": len(self.free_slots),
            "kv_free_frac": self._pool.free_blocks
            / max(self._pool.capacity, 1),
            "prefix_enabled": True,
            "paged": True,
            "warm": self._warm,
        }


__all__ = ["AdmitPlan", "ServingEngine"]
