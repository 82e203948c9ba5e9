"""Seeded weights of the GPT-2-style models, drawn on the device.

The leaves fall into groups: group 0 holds the two embedding tables,
group ``1 + i`` block ``i``, and group ``L + 1`` the final LayerNorm and
the head. A group is one draw of standard normals ``z`` from a
``torch.Generator`` on the device, seeded by the run's seed and the
group's index, in the dtype the cell keeps its weights in; each leaf is
its slice of ``z``: matrices, embeddings, biases and LayerNorm shifts
``0.02 z``, LayerNorm scales ``1 + 0.02 z``, rounded to the leaf's dtype.

The program under test and the reference both take their weights from
:func:`draw_group`, so the reference can draw one group at a time while
the program holds them all.
"""

from __future__ import annotations

import torch

from harness.common import sub_seed

SCALE = 0.02


def dims(cfg: dict) -> dict:
    """The widths a configuration file gives, under short names, and the
    LayerNorm eps the port runs (``as_run`` where it departs from the
    source)."""
    d = int(cfg["n_embd"])
    run = {**cfg, **cfg.get("as_run", {})}
    return {"vocab": int(cfg["vocab_size"]), "d": d,
            "layers": int(cfg["n_layer"]), "heads": int(cfg["n_head"]),
            "ff": int(cfg.get("n_inner") or 4 * d),
            "positions": int(cfg["n_positions"]),
            "eps": float(run["layer_norm_epsilon"])}


def group_specs(cfg: dict) -> list[list[tuple]]:
    """``[[(name, shape, kind), ...], ...]`` a group, names and shapes as
    the port's ``TransformerLM`` holds them (``nn.Linear`` weights are
    ``[out, in]``; ``qkv``'s outputs in ``(3, heads, head_dim)`` order)."""
    m = dims(cfg)
    d, ff, v = m["d"], m["ff"], m["vocab"]
    groups = [[("embed.weight", (v, d), "w"),
               ("pos_embed.weight", (m["positions"], d), "w")]]
    for i in range(m["layers"]):
        p = f"blocks.{i}."
        groups.append([
            (p + "ln1.weight", (d,), "ln"), (p + "ln1.bias", (d,), "w"),
            (p + "qkv.weight", (3 * d, d), "w"), (p + "qkv.bias", (3 * d,), "w"),
            (p + "proj.weight", (d, d), "w"), (p + "proj.bias", (d,), "w"),
            (p + "ln2.weight", (d,), "ln"), (p + "ln2.bias", (d,), "w"),
            (p + "fc1.weight", (ff, d), "w"), (p + "fc1.bias", (ff,), "w"),
            (p + "fc2.weight", (d, ff), "w"), (p + "fc2.bias", (d,), "w")])
    groups.append([("ln_f.weight", (d,), "ln"), ("ln_f.bias", (d,), "w"),
                   ("lm_head.weight", (v, d), "w"),
                   ("lm_head.bias", (v,), "w")])
    return groups


def draw_group(cfg: dict, seed: int, index: int, dtype: torch.dtype,
               device, out_dtype=None) -> dict:
    """Group ``index``'s leaves ``{name: tensor}``: drawn in ``dtype``,
    each rounded to ``dtype`` and returned in ``out_dtype`` (default
    ``dtype``)."""
    specs = group_specs(cfg)[index]
    n = sum(_numel(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights", index))
    z = torch.randn(n, generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for name, shape, kind in specs:
        k = _numel(shape)
        x = z[at:at + k].float().mul_(SCALE)
        if kind == "ln":
            x.add_(1.0)
        out[name] = x.to(dtype).to(out_dtype or dtype).view(shape)
        at += k
    return out


def fill_model(model, cfg: dict, seed: int, dtype: torch.dtype) -> None:
    """Write every leaf of ``model`` (a ``TransformerLM`` of ``cfg``'s
    widths) from its group's draw in ``dtype``; a leaf keeps its own
    dtype. Every leaf must be covered exactly once."""
    params = dict(model.named_parameters())
    seen = set()
    device = next(iter(params.values())).device
    with torch.no_grad():
        for gi in range(len(group_specs(cfg))):
            for name, value in draw_group(cfg, seed, gi, dtype,
                                          device).items():
                params[name].copy_(value)
                seen.add(name)
    missing = set(params) - seen
    if missing:
        raise ValueError(f"leaves with no draw: {sorted(missing)}")


def leaf_parts(name: str, t) -> dict:
    """``{part name: tensor}`` of one leaf: the fused ``qkv`` leaves as
    their query, key and value blocks (``name#q``, ``#k``, ``#v``, which
    the architecture holds apart), every other leaf whole. Gradients and
    changes are compared a part at a time, so a key bias, whose gradient
    is nought under softmax, is a part of its own."""
    if name.endswith(("qkv.weight", "qkv.bias")):
        return {f"{name}#{k}": c for k, c in zip("qkv", t.chunk(3, dim=0))}
    return {name: t}


def part_norms(tensors: dict) -> dict:
    """The float norm of every part of every leaf in ``{name: tensor}``."""
    return {k: float(c.norm()) for name, t in tensors.items()
            for k, c in leaf_parts(name, t).items()}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
