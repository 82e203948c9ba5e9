#!/usr/bin/env python3
"""Holds the f32 flash dq and dk/dv past D = 256 to the order in which the
plain versions sum, on one card.

    python3 f32_order_check.py

The plain versions (``flash_dq_reference``, ``flash_dkv_reference``) form
each element of S and dP in one f32 product over all of D. At B=2, T=1024,
H=16, causal (q, k, v and do drawn from a seeded generator, lse and delta
from the plain forward) and D = 512, 1024 and 2048 it prints one JSON line
a D. For each of dq, dk and dv it gives the largest error and the largest
share of ``chip_smoke.TOL["f32"]`` (|x - y| / (atol + rtol |y|), the
smoke's rule; above 1 fails it) of:

- ``kernel_vs_plain``: the kernels against the plain versions;
- ``plain_vs_f64`` and ``kernel_vs_f64``: each against a float64 version
  (its own lse and delta);
- ``partials_vs_plain``: the same gradients with S and dP summed as
  256-column-slice partials added in slice order (what a cluster that
  splits D between its CTAs would compute), against the plain versions.

Then the card's name and power limit.
"""

from __future__ import annotations

import functools
import importlib
import json
import subprocess
import sys

SLICE = 256  # the columns a CTA of the wide kernels owns


def _grads(q, k, v, do, lse, delta, scores):
    """dq, dk and dv as the plain versions form them (causal, q and k at
    offset 0), with S and dP from ``scores(a, b)``: ``[B, T, H, D]`` pairs
    to ``[B, H, Tq, Tk]``."""
    import torch

    scale = q.shape[-1] ** -0.5
    t = q.shape[1]
    masked = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    p = torch.exp(scores(q, k) * scale - lse[..., None]).masked_fill(masked,
                                                                    0.0)
    ds = p * (scores(do, v) - delta[..., None])
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            "dk": torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale,
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do)}


def _full(a, b):
    import torch

    return torch.einsum("bqhd,bkhd->bhqk", a, b)


def _partials(a, b):
    """The score product as per-slice partials added in slice order."""
    return functools.reduce(lambda x, y: x + y, (
        _full(a[..., c:c + SLICE], b[..., c:c + SLICE])
        for c in range(0, a.shape[-1], SLICE)))


def _exact(q, k, v, do):
    """The float64 gradients, with their own lse and delta."""
    import torch

    q, k, v, do = (x.double() for x in (q, k, v, do))
    t = q.shape[1]
    masked = torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1)
    s = (_full(q, k) * q.shape[-1] ** -0.5).masked_fill(masked, float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    delta = (do * out).sum(-1).transpose(1, 2)
    return _grads(q, k, v, do, lse, delta, _full)


def main() -> int:
    import torch

    import chip_smoke as cs

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rtol, atol = cs.TOL["f32"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 11)

    def err(x, y):
        e = (x.double() - y.double()).abs()
        return [float(e.max()),
                float((e / (atol + rtol * y.double().abs())).max())]

    for d in (512, 1024, 2048):
        q, k, v, do = cs._flash_inputs(2, 1024, 1024, 16, d, torch.float32,
                                       gen, dev)
        kw = dict(causal=True)
        gkw = dict(kw, grad_dtype=torch.float32)
        out, lse = fa.flash_fwd_reference(q, k, v, **kw)
        delta = (do * out).sum(-1).transpose(1, 2).contiguous()
        plain = {"dq": fa.flash_dq_reference(q, k, v, do, lse, delta, **gkw)}
        plain["dk"], plain["dv"] = fa.flash_dkv_reference(q, k, v, do, lse,
                                                          delta, **gkw)
        kern = {"dq": fa.flash_dq(q, k, v, do, lse, delta, **gkw)}
        kern["dk"], kern["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, **gkw)
        parts = _grads(q, k, v, do, lse, delta, _partials)
        exact = _exact(q, k, v, do)
        rec = {"D": d, "tol": [rtol, atol],
               "fields": ["max_abs_err", "max_share_of_tol"]}
        for n in ("dq", "dk", "dv"):
            rec[n] = {"kernel_vs_plain": err(kern[n], plain[n]),
                      "plain_vs_f64": err(plain[n], exact[n]),
                      "kernel_vs_f64": err(kern[n], exact[n]),
                      "partials_vs_plain": err(parts[n], plain[n])}
        print(json.dumps(rec), flush=True)
        del q, k, v, do, out, lse, delta, plain, kern, parts, exact
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
