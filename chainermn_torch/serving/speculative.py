"""Speculative decoding for the paged serving engine (the port of
``chainermn_tpu/serving/speculative.py``): draft ``k`` tokens cheaply,
verify them in one target-model call, commit the accepted run.

A drafter proposes ``k`` continuation tokens per slot; the engine scores
the window ``[t0, d1..dk]`` at positions ``[p..p+k]`` in one forward
(:meth:`~chainermn_torch.serving.engine.ServingEngine.spec_decode_step`)
and commits the longest prefix of drafts that match the target's own
greedy choices plus one correction token: 1 to ``k+1`` tokens a call.
Greedy only, and exact: logits at window row ``j`` depend only on the
committed tokens and drafts ``d1..dj``, and a row's choice is committed
only when every draft before it matched, so the stream is the
non-speculative greedy stream whatever the drafter proposed.

Two drafters behind one interface (:class:`SpeculativeConfig`):

- ``'ngram'``: :class:`NgramDrafter`, prompt-lookup decoding from the
  request's own history (prompt + generated), then the shared prefix
  trie (:meth:`~chainermn_torch.serving.prefix_cache.PrefixCacheIndex.
  ngram_continuation`), then repeating the last token. Host only.
- ``'draft'``: :class:`DraftModelDrafter`, a small ``TransformerLM``
  decoding ``k`` greedy tokens a window against its own dense per-slot
  caches, through two step programs of the engine's program set (a
  one-request prompt prefill and the ``k``-step draft window). Every
  window rewrites the rows a rejected draft left behind before any query
  attends them, so partial acceptance keeps the caches consistent.

With ``ServingEngine(paged_kernel=True)`` the verify window's attention
reads go through the paged-decode kernel at ``S = k + 1`` queries a row
(:func:`chainermn_torch.parallel.paged_kernel.paged_attend`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = [
    "DraftModelDrafter",
    "NgramDrafter",
    "SpeculativeConfig",
    "build_drafter",
]


@dataclass
class SpeculativeConfig:
    """``ServingEngine(speculative=...)`` configuration.

    - ``k``: drafted tokens a verify window; each call scores ``k + 1``
      positions and commits ``1..k+1`` tokens. Admission reserves
      ``ceil(k / kv_block_size)`` extra blocks a slot for the window.
    - ``drafter``: ``'ngram'`` (prompt lookup) or ``'draft'`` (a draft
      model, ``draft_model=`` required: a ``TransformerLM`` of the
      target's vocabulary on the engine's device, ``max_len >=
      cache_len``, not sharded; it carries its own weights).
    - ``ngram_max`` / ``ngram_min``: longest and shortest trailing n-gram
      the lookup tries, longest first.
    """

    k: int = 4
    drafter: str = "ngram"
    draft_model: object = None
    ngram_max: int = 3
    ngram_min: int = 1

    def validate(self) -> None:
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if self.drafter not in ("ngram", "draft"):
            raise ValueError(
                f"drafter must be 'ngram' or 'draft', got {self.drafter!r}")
        if not 1 <= self.ngram_min <= self.ngram_max:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"({self.ngram_min}, {self.ngram_max})")
        if self.drafter == "draft" and self.draft_model is None:
            raise ValueError("drafter='draft' needs draft_model=")


class NgramDrafter:
    """Prompt-lookup drafter: per-slot host history only. ``propose``
    takes the tokens that followed the most recent earlier occurrence of
    the history's trailing n-gram (longest ``n`` first), tops up from the
    prefix trie, and pads by repeating the last token — the right draft
    whenever greedy decoding has reached a fixed point."""

    def __init__(self, config: SpeculativeConfig, engine) -> None:
        self.config = config
        self.engine = engine
        self._hist: list[list[int]] = [[] for _ in range(engine.n_slots)]

    def on_admit(self, slot: int, prompt, first_token: int) -> None:
        self._hist[slot] = [int(t) for t in prompt] + [int(first_token)]

    def on_commit(self, slot: int, tokens) -> None:
        self._hist[slot].extend(int(t) for t in tokens)

    def on_release(self, slot: int) -> None:
        self._hist[slot] = []

    def reset(self) -> None:
        self._hist = [[] for _ in range(self.engine.n_slots)]

    # no device programs
    def warmup(self) -> None:
        pass

    def watched_fns(self) -> dict:
        return {}

    def compile_counts(self) -> dict:
        return {}

    def _lookup(self, hist: list[int], k: int) -> list[int]:
        """The tokens after the most recent earlier occurrence of the
        trailing n-gram, longest n first."""
        h = np.asarray(hist, np.int32)
        length = len(h)
        hi = min(self.config.ngram_max, length - 1)
        for n in range(hi, self.config.ngram_min - 1, -1):
            tail = h[length - n:]
            win = np.lib.stride_tricks.sliding_window_view(h, n)
            # windows starting before the tail itself
            hits = np.flatnonzero((win[:length - n] == tail).all(axis=1))
            if hits.size:
                i = int(hits[-1])
                cont = h[i + n:i + n + k]
                if cont.size:
                    return [int(t) for t in cont]
        return []

    def propose(self, k: int) -> np.ndarray:
        """``[n_slots, k]`` int32 drafts; inactive slots get zeros."""
        eng = self.engine
        out = np.zeros((eng.n_slots, k), np.int32)
        trie = eng.prefix_cache
        for slot in np.flatnonzero(eng._active):
            slot = int(slot)
            hist = self._hist[slot] or [int(eng._token[slot])]
            draft = self._lookup(hist, k)
            if len(draft) < k and trie is not None:
                cont = trie.ngram_continuation(hist + draft, k - len(draft))
                if cont:
                    draft.extend(cont)
            last = draft[-1] if draft else hist[-1]
            while len(draft) < k:
                draft.append(int(last))
            out[slot, :] = draft[:k]
        return out


class DraftModelDrafter:
    """Draft-``TransformerLM`` drafter with dense per-slot caches
    ``[n_slots, cache_len]`` and two step programs: ``draft_prefill``, a
    full-prompt prefill of one slot per admission (the slot a device
    index), and ``draft_decode``, ``k`` all-slot greedy steps per window.
    Both read the whole cache; the position mask hides the rows past
    each query.

    A window at base ``p`` writes draft rows ``p..p+k-1`` before its
    queries attend them; the next window starts at the commit frontier
    ``p' <= p+k+1`` and rewrites every row a rejected draft wrote, so
    rejected drafts never reach a later window's attention."""

    def __init__(self, config: SpeculativeConfig, engine) -> None:
        from chainermn_torch.models.transformer import init_kv_caches

        config.validate()
        model = config.draft_model
        if model.vocab_size != engine.model.vocab_size:
            raise ValueError(
                f"draft model vocab {model.vocab_size} != target vocab "
                f"{engine.model.vocab_size}: drafted ids must be target ids")
        if model.tensor_axis is not None or model.sequence_axis is not None:
            raise ValueError("the draft model runs unsharded: build it "
                             "with tensor_axis=None, sequence_axis=None")
        if model.max_len < engine.cache_len:
            raise ValueError(f"draft model max_len {model.max_len} < "
                             f"engine cache_len {engine.cache_len}")
        if model.device != engine.device:
            raise ValueError(f"draft model is on {model.device}, engine "
                             f"on {engine.device}")
        self.config = config
        self.engine = engine
        self.model = model.eval().cast_weights_()
        self._caches = init_kv_caches(model, engine.n_slots,
                                      engine.cache_len)
        n, k = engine.n_slots, config.k
        i64 = torch.int64
        self._prefill_prog = engine._programs.program(
            "draft_prefill", self._prefill_body,
            {"slot": ((1,), i64), "tokens": ((1, engine.prefill_len), i64)})
        self._decode_prog = engine._programs.program(
            "draft_decode", self._decode_body,
            {"tok": ((n,), i64), "pos": ((k, n), i64),
             "active": ((n,), torch.bool)})

    def _prefill_body(self, ins):
        slot = ins["slot"]
        views = [{kk: c[kk].index_select(0, slot) for kk in ("k", "v")}
                 for c in self._caches]
        self.model(ins["tokens"], 0, kv_caches=views)
        for c, v in zip(self._caches, views):
            for kk in ("k", "v"):
                c[kk].index_copy_(0, slot, v[kk])

    def _decode_body(self, ins):
        tok, act = ins["tok"], ins["active"]
        drafts = []
        for j in range(ins["pos"].shape[0]):
            lg = self.model(tok[:, None], ins["pos"][j][:, None],
                            kv_caches=self._caches)[:, 0]
            tok = torch.where(act, torch.argmax(lg, dim=-1),
                              torch.zeros_like(tok))
            drafts.append(tok)
        return torch.stack(drafts, 1)

    def on_admit(self, slot: int, prompt, first_token: int) -> None:
        """The slot's whole prompt (the drafter has no prefix cache),
        padded to ``prefill_len``, at positions ``[0, prefill_len)`` of
        the slot's rows. No sampling: the first draft conditions on the
        engine's committed token."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        tokens = np.zeros((1, self.engine.prefill_len), np.int64)
        tokens[0, :len(prompt)] = prompt
        self._prefill_prog.run(slot=np.array([slot], np.int64),
                               tokens=tokens)

    def on_commit(self, slot: int, tokens) -> None:
        pass   # the caches advance inside propose()

    def on_release(self, slot: int) -> None:
        pass   # stale rows stay masked until the next tenant rewrites them

    def reset(self) -> None:
        """Zero the caches in place (the programs hold their addresses)."""
        with torch.no_grad():
            for c in self._caches:
                for t in c.values():
                    t.zero_()

    def warmup(self) -> None:
        """Build both programs on no-op inputs (the engine is idle: slot
        0's rows and every slot's row 0 are rewritten before use)."""
        eng = self.engine
        self._prefill_prog.run(slot=np.zeros((1,), np.int64),
                               tokens=np.zeros((1, eng.prefill_len),
                                               np.int64))
        self.propose(self.config.k)

    def watched_fns(self) -> dict:
        return {"spec_draft_prefill": self._prefill_prog,
                "spec_draft_decode": self._decode_prog}

    def compile_counts(self) -> dict:
        return {"draft_prefill": self._prefill_prog._cache_size(),
                "draft_decode": self._decode_prog._cache_size()}

    def propose(self, k: int) -> np.ndarray:
        """``k`` chained greedy draft steps from the engine's commit
        frontier (``_token`` at ``_pos`` a slot); the tokens stay on the
        device between steps and come back in one fetch ``[n_slots, k]``.
        Rows past ``cache_len`` (inactive slots at a stale position, or
        drafts no slot can commit) sit at ``cache_len - 1``."""
        from chainermn_torch.dataflow.dispatch import device_fetch

        if k != self.config.k:
            raise ValueError(f"the draft window program drafts "
                             f"{self.config.k} tokens, asked for {k}")
        eng = self.engine
        pos = np.minimum(eng._pos.astype(np.int64)[None, :]
                         + np.arange(k)[:, None], eng.cache_len - 1)
        out = self._decode_prog.run(tok=eng._token, pos=pos,
                                    active=eng._active)
        return np.asarray(device_fetch(out), np.int32)


def build_drafter(config: SpeculativeConfig, engine):
    """Validate the config and build its drafter (the engine's hook)."""
    config.validate()
    if config.drafter == "draft":
        return DraftModelDrafter(config, engine)
    return NgramDrafter(config, engine)
