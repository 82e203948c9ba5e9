"""Plain PyTorch reference of the GPT-2-style decoder the port runs
(Cerebras-GPT: pre-LN blocks, one fused qkv projection for multi-head
causal attention, a dense FFN, learned positions), in float32 with TF32
off, with no kernel, cache or batching.

It takes the port's form of the published block where the two differ,
as the configuration file's ``as_run`` states it: LayerNorm eps as
given there, the tanh form of GELU, and a head of its own with a bias
where the source ties it to the embedding.

Weights come from the seed, a group at a time
(:func:`harness.weights.draw_group`), so a forward over a 6.7B model runs
layer by layer beside whatever the card still holds. Nothing here
imports the program under test.

``precision='fp8'`` is the control: every matrix product takes its
operands rounded to float8 e4m3 (weights a scale per output row,
activations a scale per row), products and the rest in float32, the
step a lower precision would take.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness.weights import dims, draw_group, group_specs, part_norms

_FP8_MAX = 448.0


def set_exact() -> None:
    """float32 matrix products in float32: TF32 off everywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x):
    """``x`` rounded to float8 e4m3 with a scale per row (last axis)."""
    amax = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = amax / _FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    # the rounding passes gradients straight through
    return x + (q - x).detach()


def linear(x, w, b, precision: str):
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    return F.linear(x, w, b)


def block(x, p: dict, prefix: str, cfg: dict, precision: str = "f32"):
    """One pre-LN block over ``x [B, T, d]`` float32, causal."""
    m = dims(cfg)
    b_, t, d = x.shape
    h, dh = m["heads"], d // m["heads"]
    a = F.layer_norm(x, (d,), p[prefix + "ln1.weight"],
                     p[prefix + "ln1.bias"], m["eps"])
    qkv = linear(a, p[prefix + "qkv.weight"], p[prefix + "qkv.bias"],
                 precision).view(b_, t, 3, h, dh)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(b_, t, d)
    x = x + linear(o, p[prefix + "proj.weight"], p[prefix + "proj.bias"],
                   precision)
    a = F.layer_norm(x, (d,), p[prefix + "ln2.weight"],
                     p[prefix + "ln2.bias"], m["eps"])
    a = F.gelu(linear(a, p[prefix + "fc1.weight"], p[prefix + "fc1.bias"],
                      precision), approximate="tanh")
    return x + linear(a, p[prefix + "fc2.weight"], p[prefix + "fc2.bias"],
                      precision)


def embed(tokens, p: dict):
    t = tokens.shape[-1]
    pos = torch.arange(t, device=tokens.device)
    return p["embed.weight"][tokens] + p["pos_embed.weight"][pos]


def head(x, p: dict, cfg: dict, precision: str = "f32"):
    d = x.shape[-1]
    a = F.layer_norm(x, (d,), p["ln_f.weight"], p["ln_f.bias"],
                     dims(cfg)["eps"])
    return linear(a, p["lm_head.weight"], p["lm_head.bias"], precision)


@torch.no_grad()
def served_logits(cfg: dict, seed: int, seqs: list, starts: list, *,
                  weight_dtype, device, precisions=("f32",)) -> dict:
    """Logits of each sequence in ``seqs`` (int64 ``[T_i]`` tensors) at
    the positions ``starts[i] ..`` to its end: ``{precision: [[n_i, V]
    float32, ...]}``. The weights are drawn a group at a time in
    ``weight_dtype`` (the dtype the program serves them in) and used in
    float32. Every precision runs over the same drawn weights."""
    set_exact()
    n_groups = len(group_specs(cfg))

    def weights(gi):
        return draw_group(cfg, seed, gi, weight_dtype, device,
                          out_dtype=torch.float32)

    p = weights(0)
    xs = {pr: [embed(s.to(device)[None], p) for s in seqs]
          for pr in precisions}
    del p
    for gi in range(1, n_groups - 1):
        p = weights(gi)
        for pr in precisions:
            xs[pr] = [block(x, p, f"blocks.{gi - 1}.", cfg, pr)
                      for x in xs[pr]]
        del p
    p = weights(n_groups - 1)
    out = {pr: [head(x[0, st:], p, cfg, pr) for x, st in zip(xs[pr], starts)]
           for pr in precisions}
    return out


def _loss_rows(p, tokens, targets, cfg, precision, n_total):
    """Summed token cross entropy of the rows over ``n_total`` tokens."""
    x = embed(tokens, p)
    for i in range(dims(cfg)["layers"]):
        x = block(x, p, f"blocks.{i}.", cfg, precision)
    lg = head(x, p, cfg, precision)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), targets.reshape(-1),
                           reduction="sum") / n_total


def train_reference(cfg: dict, seed: int, batches: list, opt: dict, *,
                    device, precision: str = "f32", rows_per_call: int = 1,
                    rows: slice = slice(None)) -> dict:
    """Train from the seed's float32 weights over ``batches`` (a list of
    ``(tokens, targets)`` ``[B, T]``), one AdamW step a batch, with the
    gradient of the token-mean cross entropy summed over blocks of
    ``rows_per_call`` rows. ``rows`` keeps part of each batch (the mean
    then over those rows: a fault a test plants).

    Returns ``losses`` (one a step), ``grad_norms`` (each leaf's first
    gradient) and ``change_norms`` (each leaf's change after the last
    step), the norms by part of a leaf
    (:func:`harness.weights.leaf_parts`)."""
    set_exact()
    params = {}
    for gi in range(len(group_specs(cfg))):
        params.update(draw_group(cfg, seed, gi, torch.float32, device))
    for v in params.values():
        v.requires_grad_(True)
    start = {k: v.detach().clone() for k, v in params.items()}
    adam = AdamW(params, **opt)
    losses, grad_norms = [], None
    for tokens, targets in batches:
        tokens, targets = tokens[rows].to(device), targets[rows].to(device)
        n_total = tokens.numel()
        loss = torch.zeros((), device=device)
        for r in range(0, tokens.shape[0], rows_per_call):
            part = _loss_rows(params, tokens[r:r + rows_per_call],
                              targets[r:r + rows_per_call], cfg, precision,
                              n_total)
            part.backward()
            loss += part.detach()
        losses.append(float(loss))
        if grad_norms is None:
            grad_norms = part_norms({k: v.grad for k, v in params.items()})
        adam.step()
    change = part_norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


class AdamW:
    """AdamW as Loshchilov and Hutter give it, in the form
    ``torch.optim.AdamW`` uses: decoupled decay ``p -= lr wd p``, then
    ``p -= lr m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments."""

    def __init__(self, params: dict, lr: float, betas, eps: float,
                 weight_decay: float, name: str = "AdamW") -> None:
        if name != "AdamW":
            raise ValueError(f"the reference has AdamW only, not {name!r}")
        self.params = params
        self.lr, self.eps, self.wd = float(lr), float(eps), float(weight_decay)
        self.b1, self.b2 = (float(b) for b in betas)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / bc2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
            p.grad = None
