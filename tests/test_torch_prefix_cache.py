"""The port's block pool and prefix trie against the JAX package's, in
shared-pool mode: one seeded sequence of admissions (match, share,
allocate, adopt), retirements and raw allocations drives both, and every
result and every occupancy figure must agree step by step."""

import numpy as np
import pytest

from chainermn_torch.serving import prefix_cache as port
from chainermn_tpu.serving import prefix_cache as ref

BLOCK = 4
N_BLOCKS = 24
PREFIXES = [[1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9, 9], [1, 2, 3, 4, 6, 6]]


def _build(mod, is_port):
    pool = mod.BlockPool(N_BLOCKS, reserve_scratch=True)
    trie = (mod.PrefixCacheIndex(BLOCK, pool=pool) if is_port
            else mod.PrefixCacheIndex(N_BLOCKS, BLOCK, pool=pool))
    return pool, trie


def _drive(mod, is_port, seed, n_ops=120):
    """Run the seeded op sequence; returns one record per op."""
    rng = np.random.default_rng(seed)
    pool, trie = _build(mod, is_port)
    held: list[list[int]] = []          # block lists owned by live "slots"
    log = []
    for _ in range(n_ops):
        op = rng.choice(["admit", "admit", "retire", "alloc"])
        if op == "admit":
            base = PREFIXES[rng.integers(len(PREFIXES))]
            tail = rng.integers(1, 12, size=int(rng.integers(1, 7)))
            prompt = np.asarray(base + list(tail), np.int32)
            match = trie.match(prompt)
            shared = list(match.block_ids) if match is not None else []
            need = -(-len(prompt) // BLOCK) - len(shared)
            new = trie.alloc_blocks_atomic(need)
            if new is None:
                trie.release(match)
                rec = ("admit", len(shared), None)
            else:
                for block in shared:
                    pool.incref(block)
                ids = shared + list(new)
                adopted = trie.insert_shared(prompt, ids)
                trie.release(match)
                held.append(ids)
                rec = ("admit", len(shared), ids, adopted)
        elif op == "retire" and held:
            ids = held.pop(int(rng.integers(len(held))))
            for block in ids:
                pool.decref(block)
            rec = ("retire", ids)
        else:
            got = trie.alloc_blocks(int(rng.integers(1, 4)))
            held.append(list(got))
            rec = ("alloc", list(got))
        log.append(rec + (pool.free_blocks, pool.used_blocks,
                          trie.evictable_blocks()))
    stats = trie.stats()
    for ids in held:                    # retire everything: pool whole
        for block in ids:
            pool.decref(block)
    whole = pool.free_blocks + trie.evictable_blocks() == pool.capacity
    return log, stats, whole


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_op_sequence_matches_reference(seed):
    got = _drive(port, True, seed)
    want = _drive(ref, False, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] and want[2]
    # the sequence reaches hits, evictions and a refused admission
    assert got[1]["hits"] > 0 and got[1]["evictions"] > 0
    assert any(r[0] == "admit" and r[2] is None for r in got[0])


def test_atomic_alloc_takes_nothing_when_short():
    pool, trie = _build(port, True)
    taken = trie.alloc_blocks(pool.capacity - 2)
    assert len(taken) == pool.capacity - 2
    assert trie.alloc_blocks_atomic(3) is None
    assert pool.free_blocks == 2
    assert len(trie.alloc_blocks_atomic(2)) == 2 and pool.free_blocks == 0
    with pytest.raises(RuntimeError, match="over-released"):
        pool.decref(0)
