#!/usr/bin/env python3
"""Times the f32 flash kernels under edits of their source, on one card.

    python3 kernel_variants.py VARIANTS_JSON [SHAPES_JSON [KERNELS]]

VARIANTS_JSON maps a variant's name to a list of ``[file, old, new]``
edits of ``chainermn_torch/csrc`` (``file`` relative to it; ``old`` must
occur once). Each variant is a copy of ``csrc`` under
``build/variants/<name>`` with its edits, built with the port's own
``nvcc`` step (all at once, one thread each), and the registers and
spills of its f32 instances of the timed kernels printed. Then every
variant's f32 kernels named in KERNELS (a comma list of ``fwd``, ``dq``
and ``dkv``; default ``fwd``) are timed at B=8, T=2048, causal, q/k/v
sliced from one fused tensor, at each ``[H, D]`` of SHAPES_JSON (default
``[[16, 64], [4, 256], [2, 512]]``): CUDA-event medians of 20 calls
(``chip_smoke.cuda_ms``, L2 flushed), in the order A B .. B A so that
drift falls on both sides, each beside its largest error against the
plain version (dq and dk/dv take the plain forward's lse and delta).
Prints one JSON line a variant, then the card's name and power limit. A
variant with no edits is the tree as it stands.
"""

from __future__ import annotations

import importlib
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _variant(name: str, edits: list) -> Path:
    """A copy of csrc with ``edits``; returns its flash_attention.cu."""
    dst = ROOT / "build" / "variants" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "chainermn_torch" / "csrc", dst)
    for fname, old, new in edits:
        path = dst / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {fname}")
        path.write_text(text.replace(old, new))
    return dst / "flash_attention.cu"


def main() -> int:
    if len(sys.argv) not in (2, 3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from chainermn_torch import _build

    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
    variants = json.loads(Path(sys.argv[1]).read_text())
    shapes = (json.loads(sys.argv[2]) if len(sys.argv) >= 3
              else [[16, 64], [4, 256], [2, 512]])
    kinds = sys.argv[3].split(",") if len(sys.argv) == 4 else ["fwd"]
    srcs = {n: _variant(n, e) for n, e in variants.items()}

    def build(name):
        _, log = _build.load_library(srcs[name], fa._SIGNATURES)
        return name, [e for e in cs._ptxas(log) if "f32" in e["entry"]
                      and any(f"_{k}_" in e["entry"] for k in kinds)]

    with ThreadPoolExecutor(len(srcs)) as pool:
        ptxas = dict(pool.map(build, srcs))
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev).zero_
    kw = dict(causal=True)
    gkw = dict(kw, grad_dtype=torch.float32)
    cases = []
    for h, d in shapes:
        q, k, v, do = cs._flash_inputs(8, 2048, 2048, h, d, torch.float32,
                                       torch.Generator().manual_seed(10),
                                       dev, fused=True)
        r_out, r_lse = fa.flash_fwd_reference(q, k, v, **kw)
        delta = (do * r_out).sum(-1).transpose(1, 2).contiguous()
        # (kernel, plain version's outputs) of each timed kind
        calls = {
            "fwd": (lambda q=q, k=k, v=v: fa.flash_fwd_with_lse(q, k, v, **kw),
                    (r_out, r_lse)),
            "dq": (lambda q=q, k=k, v=v, do=do, lse=r_lse, dl=delta:
                   (fa.flash_dq(q, k, v, do, lse, dl, **gkw),),
                   (fa.flash_dq_reference(q, k, v, do, r_lse, delta, **gkw),)
                   if "dq" in kinds else None),
            "dkv": (lambda q=q, k=k, v=v, do=do, lse=r_lse, dl=delta:
                    fa.flash_dkv(q, k, v, do, lse, dl, **gkw),
                    fa.flash_dkv_reference(q, k, v, do, r_lse, delta, **gkw)
                    if "dkv" in kinds else None)}
        cases += [(f"{kind}_d{d}", *calls[kind]) for kind in kinds]
    recs = {n: {"variant": n, "ptxas": ptxas[n]} for n in srcs}
    for name in list(srcs) + list(srcs)[::-1]:
        fa._SRC = srcs[name]
        for tag, call, want in cases:
            err = max(float((g - w).abs().max())
                      for g, w in zip(call(), want))
            rec = recs[name]
            rec.setdefault(f"ms_{tag}", []).append(
                cs.cuda_ms(call, reps=20, flush=flush))
            rec[f"max_abs_err_{tag}"] = max(
                rec.get(f"max_abs_err_{tag}", 0.0), err)
    for rec in recs.values():
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
