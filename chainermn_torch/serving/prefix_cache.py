"""Host-side block pool and ref-counted prefix trie over a KV block
store (the port's copy of ``chainermn_tpu/serving/prefix_cache.py``).

- :class:`BlockPool` hands out store block ids with refcounts; with
  ``reserve_scratch`` block 0 is the reserved scratch block. A block
  returns to the free list only when its last holder (a decode slot's
  table or a trie node) lets go.
- :class:`PrefixCacheIndex` is a trie over ``block_size``-token blocks.
  ``match`` pins the longest cached prefix of a prompt. On the shared
  pool of a paged engine the matched blocks are referenced from the
  slot's table (no copy) and ``insert_shared`` adopts a freshly
  prefilled slot's full blocks. With a private pool (the dense engine's
  prefix store) a hit is copied into the slot and an insert is a
  ``plan_insert`` -> device copy -> ``commit_insert`` (or
  ``abort_insert``) transaction. Eviction takes least-recently-used,
  unpinned leaves.

Pure host state (numpy and the monitor spine), driven from the
scheduler's one thread.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from chainermn_torch.monitor import get_event_log, get_registry


class BlockPool:
    """Ref-counted allocator over the store's block ids.
    ``reserve_scratch=True`` pins block 0 as the scratch block: never
    allocated, the write target for inactive rows and for table entries
    past a slot's allocated span."""

    def __init__(self, n_blocks: int, *, reserve_scratch: bool = False):
        lo = 1 if reserve_scratch else 0
        if n_blocks < lo + 1:
            raise ValueError(f"n_blocks must be >= {lo + 1}, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._lo = lo
        self._free = list(range(self.n_blocks - 1, lo - 1, -1))
        self._refs = np.zeros(self.n_blocks, np.int64)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the scratch block)."""
        return self.n_blocks - self._lo

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    def refs(self, block: int) -> int:
        return int(self._refs[block])

    @property
    def refcounts(self) -> np.ndarray:
        """Every block's live refcount (the pool's own array: read it,
        do not write it), for vectorised reads over many blocks."""
        return self._refs

    def alloc(self) -> Optional[int]:
        """One free block at refcount 1, or ``None`` when the pool is dry."""
        if not self._free:
            return None
        block = self._free.pop()
        self._refs[block] = 1
        return block

    def incref(self, block: int) -> None:
        self._refs[block] += 1

    def decref(self, block: int) -> None:
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)
        elif self._refs[block] < 0:
            raise RuntimeError(
                f"block {block} over-released (refcount went negative)")

    def reset(self) -> None:
        """Everything free, every refcount dropped."""
        self._free = list(range(self.n_blocks - 1, self._lo - 1, -1))
        self._refs[:] = 0


class _Node:
    """One cached block: ``block_size`` tokens -> one store block."""

    __slots__ = ("key", "block", "parent", "children", "refs", "last_use")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict = {}
        self.refs = 0             # matches pinning this node
        self.last_use = 0


@dataclass
class PrefixMatch:
    """A pinned longest-cached-prefix result: ``length`` tokens (=
    ``len(block_ids) * block_size``) covered by ``block_ids``. The holder
    ``release()``\\ s it once the blocks are referenced from a table."""

    nodes: list
    length: int
    block_ids: list
    released: bool = False


@dataclass
class InsertPlan:
    """Blocks allocated for a pending insert whose device copy is not done
    yet. ``start_block`` is the first new block's index in the prompt (the
    blocks before it were cached already); ``row_starts`` are the slot
    cache rows the copy reads. ``commit_insert`` links the nodes,
    ``abort_insert`` gives the blocks back."""

    parent: object
    keys: list
    block_ids: list
    start_block: int
    row_starts: list = field(default_factory=list)
    closed: bool = False


class PrefixCacheIndex:
    """Ref-counted trie over token blocks mapping prefixes to store block
    ids. Drive from one thread.

    Two forms, as in the reference: ``PrefixCacheIndex(n_blocks,
    block_size)`` owns a private pool of ``n_blocks`` blocks (the dense
    engine's prefix store); with ``pool=`` it allocates from that shared
    pool (the paged engine's store), and the block count may be left out:
    ``PrefixCacheIndex(block_size, pool=pool)``."""

    def __init__(self, *args, pool: Optional[BlockPool] = None) -> None:
        if len(args) == 3 and pool is None:
            args, pool = args[:2], args[2]
        if len(args) == 2:
            n_blocks, block_size = args
        elif len(args) == 1 and pool is not None:
            n_blocks, block_size = pool.n_blocks, args[0]
        else:
            raise TypeError("PrefixCacheIndex(n_blocks, block_size, "
                            "pool=None) or PrefixCacheIndex(block_size, "
                            "pool=pool)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self._pool_private = pool is None
        if pool is None:
            if n_blocks < 1:
                raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
            pool = BlockPool(int(n_blocks))
        self.pool = pool
        self.n_blocks = pool.n_blocks
        self.block_size = int(block_size)
        self._root = _Node(None, -1, None)
        self._clock = itertools.count(1)
        self._events = get_event_log()
        reg = get_registry()
        self._c_hits = reg.counter("prefix_cache_hits_total")
        self._c_misses = reg.counter("prefix_cache_misses_total")
        self._c_evictions = reg.counter("prefix_cache_evictions_total")
        self._c_inserted = reg.counter("prefix_cache_inserted_blocks_total")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserted_blocks = 0

    def _key(self, tokens: np.ndarray, i: int) -> tuple:
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens, max_blocks: Optional[int] = None
              ) -> Optional[PrefixMatch]:
        """Longest cached prefix of ``tokens``, pinned; ``None`` on miss.
        Covers at most ``(len - 1) // block_size`` blocks, so at least one
        token is left to prefill for the first sampled token's logits;
        ``max_blocks`` caps it further."""
        tokens = np.asarray(tokens).reshape(-1)
        cap = (len(tokens) - 1) // self.block_size
        if max_blocks is not None:
            cap = min(cap, max_blocks)
        node, nodes = self._root, []
        for i in range(cap):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            nodes.append(child)
            node = child
        if not nodes:
            self.misses += 1
            self._c_misses.inc()
            return None
        nodes[-1].refs += 1
        t = next(self._clock)
        for nd in nodes:
            nd.last_use = t
        self.hits += 1
        self._c_hits.inc()
        return PrefixMatch(nodes=nodes, length=len(nodes) * self.block_size,
                           block_ids=[nd.block for nd in nodes])

    def missing_blocks(self, tokens) -> int:
        """How many of ``tokens``' full blocks are not cached yet (no
        allocation, no pin, no LRU touch)."""
        tokens = np.asarray(tokens).reshape(-1)
        total = len(tokens) // self.block_size
        node, i = self._root, 0
        while i < total:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            node, i = child, i + 1
        return total - i

    def ngram_continuation(self, tokens, k: int) -> Optional[list]:
        """Up to ``k`` tokens a cached prompt says follow ``tokens``, for
        the n-gram drafter: ``tokens`` must walk the trie cleanly (every
        full block present, the ragged tail a prefix of exactly one child
        key); the tail key's remainder comes first, then deeper blocks
        while the path has one child. ``None`` when the trie has no
        unambiguous answer. A pure read: no pin, no LRU touch, no hit or
        miss counted."""
        if k <= 0:
            return None
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        bs = self.block_size
        node = self._root
        for i in range(len(tokens) // bs):
            child = node.children.get(self._key(tokens, i))
            if child is None:
                return None
            node = child
        tail = tuple(int(t) for t in tokens[(len(tokens) // bs) * bs:])
        out: list = []
        if tail:
            matches = [key for key in node.children
                       if key[:len(tail)] == tail]
            if len(matches) != 1:
                return None
            key = matches[0]
            out.extend(key[len(tail):])
            node = node.children[key]
        while len(out) < k and len(node.children) == 1:
            (key, node), = node.children.items()
            out.extend(key)
        return out[:k] if out else None

    def release(self, match: Optional[PrefixMatch]) -> None:
        """Unpin a match (idempotent)."""
        if match is None or match.released:
            return
        match.released = True
        match.nodes[-1].refs -= 1

    def plan_insert(self, tokens) -> Optional[InsertPlan]:
        """Allocate blocks for the not-yet-cached full blocks of
        ``tokens`` (evicting LRU leaves as needed) and pin the node they
        attach under. ``None`` when nothing new would be cached. The
        caller copies the KV, then commits or aborts."""
        tokens = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        total = len(tokens) // bs
        node, i = self._root, 0
        t = next(self._clock)
        while i < total:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.last_use = t
            node, i = child, i + 1
        if i >= total:
            return None
        node.refs += 1                  # pin the attachment point
        blocks = self.alloc_blocks(total - i)
        if not blocks:
            node.refs -= 1
            return None
        return InsertPlan(
            parent=node,
            keys=[self._key(tokens, i + j) for j in range(len(blocks))],
            block_ids=blocks, start_block=i,
            row_starts=[(i + j) * bs for j in range(len(blocks))])

    def commit_insert(self, plan: InsertPlan) -> None:
        if plan.closed:
            return
        plan.closed = True
        node = plan.parent
        node.refs -= 1
        t = next(self._clock)
        for key, block in zip(plan.keys, plan.block_ids):
            child = _Node(key, block, node)
            child.last_use = t
            node.children[key] = child
            node = child
        n = len(plan.block_ids)
        self.inserted_blocks += n
        self._c_inserted.inc(n)
        self._events.emit("prefix_insert", blocks=n,
                          depth=plan.start_block + n, used=self.used_blocks)

    def abort_insert(self, plan: InsertPlan) -> None:
        if plan.closed:
            return
        plan.closed = True
        plan.parent.refs -= 1
        for block in plan.block_ids:
            self.pool.decref(block)

    def insert_shared(self, tokens, block_ids) -> int:
        """Adopt already-resident blocks: ``block_ids[j]`` holds the KV of
        the prompt's ``j``-th full block. Links trie nodes for the
        not-yet-cached full blocks and increfs each adopted block, so it
        outlives the donor slot. Returns blocks adopted."""
        tokens = np.asarray(tokens).reshape(-1)
        total = min(len(tokens) // self.block_size, len(block_ids))
        node, i = self._root, 0
        t = next(self._clock)
        while i < total:
            child = node.children.get(self._key(tokens, i))
            if child is None:
                break
            child.last_use = t
            node, i = child, i + 1
        adopted = 0
        for j in range(i, total):
            block = int(block_ids[j])
            self.pool.incref(block)
            child = _Node(self._key(tokens, j), block, node)
            child.last_use = t
            node.children[child.key] = child
            node = child
            adopted += 1
        if adopted:
            self.inserted_blocks += adopted
            self._c_inserted.inc(adopted)
            self._events.emit("prefix_insert", blocks=adopted, depth=total,
                              used=self.used_blocks, shared=True)
        return adopted

    def _evictable(self):
        """All ref-zero leaves."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and not node.children and not node.refs:
                out.append(node)
        return out

    def alloc_blocks(self, n: int) -> list:
        """Up to ``n`` blocks from the pool, evicting LRU ref-zero leaves
        when the free list runs dry (a partial result is possible)."""
        out = []
        while len(out) < n:
            block = self.pool.alloc()
            if block is not None:
                out.append(block)
                continue
            victims = self._evictable()
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_use)
            del victim.parent.children[victim.key]
            # a decode slot still referencing the block keeps it alive
            self.pool.decref(victim.block)
            self.evictions += 1
            self._c_evictions.inc()
            self._events.emit("prefix_evict", block=victim.block,
                              age=victim.last_use)
        return out

    def alloc_blocks_atomic(self, n: int) -> Optional[list]:
        """Exactly ``n`` blocks, or ``None`` with nothing taken."""
        out = self.alloc_blocks(int(n))
        if len(out) < int(n):
            for block in out:
                self.pool.decref(block)
            return None
        return out

    def evictable_blocks(self) -> int:
        """Blocks eviction could return to the free list right now: nodes
        in fully unpinned subtrees whose block has no other holder."""
        pool = self.pool

        def walk(node):
            unpinned = node is self._root or node.refs == 0
            count = 0
            for child in node.children.values():
                child_ok, child_count = walk(child)
                count += child_count
                unpinned = unpinned and child_ok
            if (node is not self._root and unpinned
                    and pool.refs(node.block) == 1):
                count += 1
            return unpinned, count

        return walk(self._root)[1]

    def clear(self) -> None:
        """Drop every cached prefix. A private pool is reset wholesale
        (uncommitted plans' blocks too); a shared pool keeps its other
        holders' references, and the trie's own are dropped with it only
        when its owner resets the pool."""
        self._root = _Node(None, -1, None)
        if self._pool_private:
            self.pool.reset()

    @property
    def used_blocks(self) -> int:
        """Allocated blocks in the pool: with a private pool the trie's
        own footprint, with a shared one the store's whole occupancy."""
        return self.pool.used_blocks

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
            "evictions": self.evictions,
            "inserted_blocks": self.inserted_blocks,
            "used_blocks": self.used_blocks,
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
        }


__all__ = ["BlockPool", "InsertPlan", "PrefixCacheIndex", "PrefixMatch"]
