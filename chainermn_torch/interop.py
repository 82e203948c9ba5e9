"""Weights across the frameworks: the flax ``TransformerLM`` parameter tree
as a :class:`chainermn_torch.models.TransformerLM` ``state_dict``.

The tree is taken as nested dicts of numpy arrays (``jax.device_get`` of
the flax params, with or without the outer ``{"params": ...}``), so this
module needs neither jax nor flax. Layout conversions:

- ``qkv`` ``DenseGeneral`` kernel ``[d, 3, H, Dh]`` -> ``Linear`` weight
  ``[3*H*Dh, d]``; bias ``[3, H, Dh]`` -> ``[3*H*Dh]``;
- ``proj`` ``DenseGeneral`` kernel ``[H, Dh, d]`` -> weight ``[d, H*Dh]``;
- ``Dense`` kernel ``[in, out]`` -> ``Linear`` weight ``[out, in]``;
- ``Embed`` ``embedding`` -> ``Embedding`` weight (same layout);
- ``LayerNorm`` ``scale``/``bias`` -> ``weight``/``bias``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _linear(p, prefix: str) -> dict:
    kernel = np.asarray(p["kernel"], np.float32)
    return {f"{prefix}.weight": _t(kernel.reshape(kernel.shape[0], -1).T),
            f"{prefix}.bias": _t(np.asarray(p["bias"]).reshape(-1))}


def _layer_norm(p, prefix: str) -> dict:
    return {f"{prefix}.weight": _t(p["scale"]),
            f"{prefix}.bias": _t(p["bias"])}


def params_from_flax(tree) -> dict:
    """Convert the flax ``TransformerLM`` (dense blocks) parameter tree to
    the port's ``state_dict`` (float32 tensors on the CPU; load it with
    ``model.load_state_dict``)."""
    p = tree.get("params", tree)
    sd = {"embed.weight": _t(p["embed"]["embedding"]),
          "pos_embed.weight": _t(p["pos_embed"]["embedding"])}
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}"
        proj = np.asarray(blk["proj"]["kernel"], np.float32)  # [H, Dh, d]
        sd.update(_layer_norm(blk["LayerNorm_0"], f"{pre}.ln1"))
        sd.update(_linear(blk["qkv"], f"{pre}.qkv"))   # [d, 3*H*Dh]
        sd[f"{pre}.proj.weight"] = _t(proj.reshape(-1, proj.shape[-1]).T)
        sd[f"{pre}.proj.bias"] = _t(blk["proj"]["bias"])
        sd.update(_layer_norm(blk["LayerNorm_1"], f"{pre}.ln2"))
        sd.update(_linear(blk["Dense_0"], f"{pre}.fc1"))
        sd.update(_linear(blk["Dense_1"], f"{pre}.fc2"))
    sd.update(_layer_norm(p["LayerNorm_0"], "ln_f"))
    sd.update(_linear(p["lm_head"], "lm_head"))
    return sd


__all__ = ["params_from_flax"]
