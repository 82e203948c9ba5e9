"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that these functions read.

Serving lengths follow a published trace's statistics: each of prompt
and output is a lognormal (``median``, ``sigma``) truncated to
``[min, max]``. Every seed asks for the same set of lengths in its own
order: a pool of ``pool`` lengths a dimension sits at the middles of
equal-probability strata of the truncated law, and each run of ``pool``
consecutive requests takes a fresh permutation of each pool, drawn from
the seed (prompt and output independently). So the seed moves which
request is long and what arrives behind it, not the amount of work. An
output is cut to what the context leaves after its prompt. Token ids
are uniform over the vocabulary, from the seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from harness.common import sub_seed


def length_pool(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the middles of ``n`` equal-probability strata of
    the lognormal ``spec`` truncated to ``[min, max]``, ascending."""
    law = NormalDist(math.log(float(spec["median"])), float(spec["sigma"]))
    lo, hi = int(spec["min"]), int(spec["max"])
    f_lo = law.cdf(math.log(lo - 0.5)) if lo > 1 else 0.0
    f_hi = law.cdf(math.log(hi + 0.5))
    u = f_lo + (np.arange(n) + 0.5) / n * (f_hi - f_lo)
    out = np.array([round(math.exp(law.inv_cdf(float(x)))) for x in u])
    return np.clip(out, lo, hi).astype(np.int64)


class ServeTraffic:
    """Requests of a closed loop: :meth:`initial` gives each client the
    request it holds when the window opens, :meth:`next` the stream that
    follows, both as ``(prompt int32 array, max_new_tokens)``."""

    def __init__(self, params: dict, seed: int, vocab: int) -> None:
        self.clients = int(params["clients"])
        self.context = int(params["context_tokens"])
        n = int(params["pool"])
        self.prompts = length_pool(params["prompt_tokens"], n)
        self.outputs = length_pool(params["output_tokens"], n)
        self.vocab = int(vocab)
        self._ids = np.random.Generator(np.random.PCG64(
            sub_seed(seed, "prompt_ids")))
        self._order = np.random.Generator(np.random.PCG64(
            sub_seed(seed, "lengths")))
        self._queue: list = []

    def _request(self, plen: int, budget: int) -> tuple:
        budget = max(1, min(int(budget), self.context - int(plen)))
        return (self._ids.integers(0, self.vocab, size=int(plen),
                                   dtype=np.int32), budget)

    def initial(self) -> list:
        """One request a client, caught in flight as a closed loop in
        equilibrium holds it: its output drawn from the pool with odds
        proportional to its length, the tokens still to come uniform over
        it; its prompt drawn from the pool."""
        total = self._order.choice(self.outputs, size=self.clients,
                                   p=self.outputs / self.outputs.sum())
        left = [int(self._order.integers(1, t + 1)) for t in total]
        plen = self._order.choice(self.prompts, size=self.clients)
        return [self._request(p, b) for p, b in zip(plen, left)]

    def next(self) -> tuple:
        if not self._queue:
            self._queue = list(zip(self._order.permutation(self.prompts),
                                   self._order.permutation(self.outputs)))
            self._queue.reverse()
        return self._request(*self._queue.pop())


class TrainTraffic:
    """Fresh rows every step: ``[batch, seq_len + 1]`` token ids uniform
    over the vocabulary from a generator on the device seeded by the run;
    inputs are the first ``seq_len`` columns, targets the last."""

    def __init__(self, params: dict, seed: int, vocab: int, device) -> None:
        self.batch = int(params["batch"])
        self.seq_len = int(params["seq_len"])
        self.vocab = int(vocab)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(sub_seed(seed, "train_tokens"))

    def next(self) -> tuple:
        rows = torch.randint(0, self.vocab, (self.batch, self.seq_len + 1),
                             generator=self._gen, device=self.device)
        return rows[:, :-1], rows[:, 1:]
