#!/usr/bin/env python3
"""Times the port's kernels in two checkouts, in turns, on one card.

    python3 kernel_ab.py PARENT_ROOT [CHANGE_ROOT]

CHANGE_ROOT defaults to the checkout holding this script. It runs parent,
change, change, parent, each in its own process with that checkout first
on ``sys.path`` (each builds its kernels into its own ``build/``), and
prints one JSON line a run: CUDA-event medians (``chip_smoke.cuda_ms``, L2
flushed before each call) of the flash forward, dq and dk/dv kernels in
bf16 and f32 at B=2, T=1024, H=16, D=64, causal, q/k/v sliced from one
fused tensor, of the bf16 forward at the training shape (B=8, T=2048),
of the f32 forward, dq and dk/dv at the training shape (H=16, D=64), at
H=4, D=256, at H=2, D=512 and at H=1, D=1024 (the same FLOPs), each
shape beside SDPA's f32 forward and backward (dq, dk and dv in one call;
``F.scaled_dot_product_attention``, the backend it picks, which is
recorded; the port never calls it), of the bf16 forward, dq and dk/dv
past D = 256 at the wide LM's shape (B=8, T=2048, H=2, D=512) and at
H=1, D=1024 (the same FLOPs), each beside SDPA's bf16 forward and
backward, and of the paged-decode kernel on 16 rows of 64..639 keys;
then the card's name and power limit. Both
checkouts need ``chip_smoke.py``; two versions are only compared inside
one such call.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path


def _child(name: str, root: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    fa = importlib.import_module("chainermn_torch.ops.flash_attention")
    from chainermn_torch.parallel.paged_kernel import paged_attend

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev).zero_
    rec = {"tree": name, "root": root}
    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        q, k, v, do = cs._flash_inputs(2, 1024, 1024, 16, 64, dtype, gen, dev,
                                       fused=True)
        kw = dict(causal=True)
        gkw = dict(kw, grad_dtype=dtype)
        out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        calls = {"fwd": lambda: fa.flash_fwd_with_lse(q, k, v, **kw),
                 "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, **gkw),
                 "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, **gkw)}
        for kname, fn in calls.items():
            rec[f"{kname}_{dname}_ms"] = cs.cuda_ms(fn, flush=flush)
    q, k, v, _ = cs._flash_inputs(8, 2048, 2048, 16, 64, torch.bfloat16,
                                  torch.Generator().manual_seed(8), dev,
                                  fused=True)
    rec["fwd_bf16_train_shape_ms"] = cs.cuda_ms(
        lambda: fa.flash_fwd_with_lse(q, k, v, causal=True), flush=flush)
    del q, k, v

    def sdpa(tag, q, k, v, do):
        """SDPA's forward and backward on the kernels' inputs."""
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            rec[f"sdpa_fwd_{tag}_ms"] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                flush=flush)
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        rec[f"sdpa_bwd_{tag}_ms"] = cs.cuda_ms(
            lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                        retain_graph=True), flush=flush)
        rec[f"sdpa_backend_{tag}"] = cs._sdpa_backend(qt, kt, vt,
                                                      is_causal=True)

    for h, d in ((16, 64), (4, 256), (2, 512), (1, 1024)):
        q, k, v, do = cs._flash_inputs(8, 2048, 2048, h, d, torch.float32,
                                       torch.Generator().manual_seed(10),
                                       dev, fused=True)
        sdpa(f"f32_train_d{d}", q, k, v, do)
        torch.cuda.empty_cache()
        kw = dict(causal=True)
        gkw = dict(kw, grad_dtype=torch.float32)
        out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        f32 = {"fwd": lambda: fa.flash_fwd_with_lse(q, k, v, **kw),
               "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, **gkw),
               "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, **gkw)}
        for kname, fn in f32.items():
            rec[f"{kname}_f32_train_d{d}_ms"] = cs.cuda_ms(fn, flush=flush)
        del q, k, v, do, out, lse, delta
    for h, d in ((2, 512), (1, 1024)):
        q, k, v, do = cs._flash_inputs(8, 2048, 2048, h, d, torch.bfloat16,
                                       torch.Generator().manual_seed(9), dev,
                                       fused=True)
        sdpa(f"bf16_d{d}", q, k, v, do)
        torch.cuda.empty_cache()
        kw = dict(causal=True)
        gkw = dict(kw, grad_dtype=torch.bfloat16)
        out, lse = fa.flash_fwd_with_lse(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        wide = {"fwd": lambda: fa.flash_fwd_with_lse(q, k, v, **kw),
                "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, **gkw),
                "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, **gkw)}
        for kname, fn in wide.items():
            rec[f"{kname}_bf16_d{d}_ms"] = cs.cuda_ms(fn, flush=flush)
        del q, k, v, do, out, lse, delta
    lengths = [int(n) for n in torch.randint(64, 640, (16,), generator=gen)]
    x = cs.make_paged_inputs(lengths, s_len=1, h=16, d=64, bs=16,
                             dtype=torch.bfloat16, q_dtype=torch.bfloat16,
                             gen=gen, device=dev, n_blocks=16 * 128 + 1)
    args, kw = cs.attend_args(x)
    rec["paged_bf16_ms"] = cs.cuda_ms(lambda: paged_attend(*args, **kw),
                                      flush=flush)
    print(json.dumps(rec), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        _child(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3
                            else Path(__file__).parent).resolve()}
    for root in roots.values():
        if not (root / "chip_smoke.py").is_file():
            print(f"kernel_ab: no chip_smoke.py in {root}", file=sys.stderr)
            return 2
    for name in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, __file__, "--child", name,
                              str(roots[name])], timeout=600)
        if res.returncode != 0:
            return res.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
