"""Weights and images across the frameworks: flax variable trees as the
port's ``state_dict``s (``TransformerLM``, ``ResNet``, ``MLP``,
``AlexNet``, ``GoogLeNet``, ``VGG16``), and NHWC images in the port's
layout.

A tree is taken as nested dicts of numpy arrays (``jax.device_get`` of
the flax variables, with or without the outer ``{"params": ...}``), so
this module needs neither jax nor flax. Layout conversions:

- ``qkv`` ``DenseGeneral`` kernel ``[d, 3, H, Dh]`` -> ``Linear`` weight
  ``[3*H*Dh, d]``; bias ``[3, H, Dh]`` -> ``[3*H*Dh]``;
- ``proj`` ``DenseGeneral`` kernel ``[H, Dh, d]`` -> weight ``[d, H*Dh]``;
- the tensor-parallel blocks' global ``Dense``-shaped kernels (``qkv_tpcol``,
  ``proj_tprow`` and the MLP's column/row pair) -> the port's
  ``attn.qkv``, ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``;
- ``Dense`` kernel ``[in, out]`` -> ``Linear`` weight ``[out, in]``;
- ``Conv`` kernel HWIO -> OIHW;
- ``Embed`` ``embedding`` -> ``Embedding`` weight (same layout);
- ``LayerNorm`` / ``BatchNorm`` ``scale``/``bias`` -> ``weight``/``bias``;
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``GRUCell`` (``ir``/``iz``/``in``, ``hr``/``hz``/``hn``) -> ``nn.GRU``'s
  stacked ``(r, z, n)`` gates (:func:`gru_params_from_flax`);
- an MoE block's ``moe/gate`` -> ``moe.gate``; its expert stacks
  ``moe/w1|b1|w2|b2`` cross in flax's ``[E, in, out]`` layout (float32
  here; ``load_state_dict`` stores them in the model's ``compute_dtype``,
  as flax declares them).

:func:`megatron_params_from_flax` cuts a converted dense tree to one
rank's Megatron shards, and :func:`pipeline_params_from_flax` takes one
stage of the pipelined LM's stacked blocks.

:func:`load_chain_from_flax` loads a ``MultiNodeChainList`` component by
component from the JAX chain's ``init``.

:func:`parallel_conv_params_from_jax` takes the parallel-convolution
example's full parameter dict (``{"conv1": {"w": HWIO, "b": ...}, ...}``)
as the port twin's NCHW/OIHW ``state_dict``.

:func:`kv_payload_from_jax` takes a KV migration or prefix-share payload
the JAX engine exported (numpy rows) as the port engine's payload, so a
request prefilled there continues here.
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
    """Convert the flax ``TransformerLM`` parameter tree to the port's
    ``state_dict`` (float32 tensors on the CPU; load it with
    ``model.load_state_dict``). Dense blocks and tensor-parallel blocks
    (``tensor_axis``: ``attn/qkv_tpcol``, ``attn/proj_tprow``,
    ``mlp/ColumnParallelDense_0``, ``mlp/RowParallelDense_0``) both
    convert, and so does the vocab-parallel head: the global kernels
    cross unchanged, qkv columns in the tree's own
    ``(rank, 3, local_head, d_head)`` order."""
    p = tree.get("params", tree)
    sd = {"embed.weight": _t(p["embed"]["embedding"]),
          "pos_embed.weight": _t(p["pos_embed"]["embedding"])}
    n_layers = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_layers):
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}"
        sd.update(_layer_norm(blk["LayerNorm_0"], f"{pre}.ln1"))
        if "attn" in blk:       # a tensor-parallel (Megatron) block
            attn, mlp = blk["attn"], blk["mlp"]
            sd.update(_linear(attn["qkv_tpcol"], f"{pre}.attn.qkv"))
            sd.update(_linear(attn["proj_tprow"], f"{pre}.attn.proj"))
            sd.update(_layer_norm(blk["LayerNorm_1"], f"{pre}.ln2"))
            sd.update(_linear(mlp["ColumnParallelDense_0"], f"{pre}.mlp.fc1"))
            sd.update(_linear(mlp["RowParallelDense_0"], f"{pre}.mlp.fc2"))
            continue
        sd.update(_dense_block(blk, f"{pre}."))
    sd.update(_layer_norm(p["LayerNorm_0"], "ln_f"))
    sd.update(_linear(p["lm_head"], "lm_head"))
    return sd


def _dense_block(blk, pre: str = "") -> dict:
    """A dense (not tensor-parallel) block after its first LayerNorm, its
    names prefixed by ``pre``: the attention, the second LayerNorm and
    the FFN — ``Dense_0``/``Dense_1``, or an MoE block's ``moe`` (the
    gate, and the expert stacks in flax's ``[E, in, out]`` layout)."""
    proj = np.asarray(blk["proj"]["kernel"], np.float32)  # [H, Dh, d]
    sd = _linear(blk["qkv"], f"{pre}qkv")                  # [d, 3*H*Dh]
    sd[f"{pre}proj.weight"] = _t(proj.reshape(-1, proj.shape[-1]).T)
    sd[f"{pre}proj.bias"] = _t(blk["proj"]["bias"])
    sd.update(_layer_norm(blk["LayerNorm_1"], f"{pre}ln2"))
    if "moe" in blk:
        moe = blk["moe"]
        sd.update(_linear(moe["gate"], f"{pre}moe.gate"))
        for name in ("w1", "b1", "w2", "b2"):
            sd[f"{pre}moe.{name}"] = _t(moe[name])
        return sd
    sd.update(_linear(blk["Dense_0"], f"{pre}fc1"))
    sd.update(_linear(blk["Dense_1"], f"{pre}fc2"))
    return sd


def megatron_params_from_flax(tree, model, rank: int, n_tp: int) -> dict:
    """Rank ``rank``'s Megatron shards (of ``n_tp``) of a flax dense
    ``TransformerLM`` tree, for the port's ``model`` of the same shape —
    the slice JAX's ``megatron_shard`` places on that rank
    (``sharding.shard_shape``), in the port's layouts. Load it into a
    model already cut by :func:`chainermn_torch.parallel.gspmd.
    megatron_shard`."""
    from chainermn_torch.parallel.gspmd import (
        megatron_param_specs,
        shard_state_dict,
    )

    specs = getattr(model, "_megatron_specs", None) or \
        megatron_param_specs(model, n_tp)
    return shard_state_dict(params_from_flax(tree), specs, rank, n_tp,
                            model.n_heads)


def pipeline_params_from_flax(tree, stage: int) -> dict:
    """The flax pipelined LM's ``{'embed', 'blocks', 'head'}`` variables
    (``init_pipeline_lm``; ``blocks`` stacked on a leading stage axis) as
    ``state_dict``s of the port's ``make_pipeline_lm`` parts on the rank
    that holds stage ``stage``: ``{'embed': ..., 'block': ..., 'head':
    ...}``."""
    def params(t):
        return t.get("params", t)

    emb, head = params(tree["embed"]), params(tree["head"])
    blk = {k: {kk: np.asarray(vv)[stage] for kk, vv in v.items()}
           for k, v in params(tree["blocks"]).items()}
    block = {**_layer_norm(blk["LayerNorm_0"], "ln1"), **_dense_block(blk)}
    return {"embed": {"embed.weight": _t(emb["embed"]["embedding"]),
                      "pos_embed.weight": _t(emb["pos_embed"]["embedding"])},
            "block": block,
            "head": {**_layer_norm(head["LayerNorm_0"], "ln_f"),
                     **_linear(head["lm_head"], "lm_head")}}


def _conv(p, prefix: str) -> dict:
    hwio = np.asarray(p["kernel"])
    sd = {f"{prefix}.weight": _t(hwio.transpose(3, 2, 0, 1))}
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])
    return sd


def _batch_norm(p, stats, prefix: str) -> dict:
    sd = {f"{prefix}.running_mean": _t(stats["mean"]),
          f"{prefix}.running_var": _t(stats["var"])}
    for flax_name, name in (("scale", "weight"), ("bias", "bias")):
        if flax_name in p:
            sd[f"{prefix}.{name}"] = _t(p[flax_name])
    return sd


def _numbered(tree, *stems: str) -> list:
    """The keys ``<stem>_<i>`` of ``tree`` in index order, for whichever
    of ``stems`` it uses (flax names unnamed submodules by class)."""
    keys = [k for k in tree if k.rsplit("_", 1)[0] in stems]
    return sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))


def resnet_params_from_flax(variables) -> dict:
    """Convert the flax ``ResNet`` variables (``params`` and
    ``batch_stats``; blocks ``BottleneckBlock_i``/``BasicBlock_i``
    numbered across stages, norms ``BatchNorm_k`` or
    ``MultiNodeBatchNormalization_k``) to the port's
    :class:`~chainermn_torch.models.ResNet` ``state_dict``."""
    p, stats = variables["params"], variables["batch_stats"]
    norms = ("BatchNorm", "MultiNodeBatchNormalization")
    sd = _conv(p["stem_conv"], "stem_conv")
    sd.update(_batch_norm(p["stem_norm"], stats["stem_norm"], "stem_norm"))
    for i, name in enumerate(_numbered(p, "BottleneckBlock", "BasicBlock")):
        blk, bst, pre = p[name], stats[name], f"blocks.{i}"
        for k, conv in enumerate(_numbered(blk, "Conv")):
            sd.update(_conv(blk[conv], f"{pre}.conv{k}"))
        for k, norm in enumerate(_numbered(blk, *norms)):
            sd.update(_batch_norm(blk[norm], bst[norm], f"{pre}.norm{k}"))
        if "downsample" in blk:
            sd.update(_conv(blk["downsample"], f"{pre}.downsample"))
            sd.update(_batch_norm(blk["downsample_norm"],
                                  bst["downsample_norm"],
                                  f"{pre}.downsample_norm"))
    sd.update(_linear(p["Dense_0"], "head"))
    return sd


def mlp_params_from_flax(tree) -> dict:
    """Convert the flax ``MLP`` params to the port's
    :class:`~chainermn_torch.models.MLP` ``state_dict``."""
    p = tree.get("params", tree)
    return {k: v for i, name in enumerate(_numbered(p, "Dense"))
            for k, v in _linear(p[name], f"fcs.{i}").items()}


def alexnet_params_from_flax(tree) -> dict:
    """Convert the flax ``AlexNet`` params to the port's
    :class:`~chainermn_torch.models.AlexNet` ``state_dict``."""
    p = tree.get("params", tree)
    sd = mlp_params_from_flax(p)
    for i, name in enumerate(_numbered(p, "Conv")):
        sd.update(_conv(p[name], f"convs.{i}"))
    return sd


def googlenet_params_from_flax(tree) -> dict:
    """Convert the flax ``GoogLeNet`` params (``stem1``,
    ``stem2_reduce``, ``stem2``, ``InceptionBlock_i`` with their named
    branch convolutions, the ``Dense_0`` head) to the port's
    :class:`~chainermn_torch.models.vision.GoogLeNet` ``state_dict``."""
    p = tree.get("params", tree)
    sd = {}
    for name in ("stem1", "stem2_reduce", "stem2"):
        sd.update(_conv(p[name], name))
    for i, name in enumerate(_numbered(p, "InceptionBlock")):
        for branch, conv in p[name].items():
            sd.update(_conv(conv, f"blocks.{i}.{branch}"))
    sd.update(_linear(p["Dense_0"], "head"))
    return sd


def vgg16_params_from_flax(tree) -> dict:
    """Convert the flax ``VGG16`` params (``conv<stage>_<i>``,
    ``Dense_0..2``) to the port's
    :class:`~chainermn_torch.models.vision.VGG16` ``state_dict``. Both
    flatten in NHWC order, so the first dense kernel keeps its rows."""
    p = tree.get("params", tree)
    sd = mlp_params_from_flax(p)
    convs = sorted((k for k in p if k.startswith("conv")),
                   key=lambda k: tuple(map(int, k[4:].split("_"))))
    for i, name in enumerate(convs):
        sd.update(_conv(p[name], f"convs.{i}"))
    return sd


def gru_params_from_flax(p, prefix: str = "gru") -> dict:
    """Convert a flax ``GRUCell``'s params to a one-layer ``nn.GRU``'s
    (``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``).

    flax: ``r = σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``,
    ``n = tanh(in(x) + r * hn(h))``, ``h' = (1 - z) n + z h``, where the
    ``i*`` denses and ``hn`` have biases and ``hr``/``hz`` have none.
    torch computes the same with the gates stacked ``(r, z, n)`` and a
    hidden bias on every gate, so ``hr``/``hz``'s is zero and ``hn``'s
    bias, which sits inside ``r * (...)``, is ``bias_hh``'s n block.
    Training must hold those two zero blocks at zero (flax has no such
    parameters; the seq2seq twin's GRUs drop their gradient)."""
    def w(name):
        return np.asarray(p[name]["kernel"], np.float32).T

    hidden = np.asarray(p["ir"]["kernel"]).shape[1]
    zeros = np.zeros(hidden, np.float32)
    return {
        f"{prefix}.weight_ih_l0": _t(np.concatenate([w("ir"), w("iz"),
                                                     w("in")])),
        f"{prefix}.weight_hh_l0": _t(np.concatenate([w("hr"), w("hz"),
                                                     w("hn")])),
        f"{prefix}.bias_ih_l0": _t(np.concatenate(
            [p["ir"]["bias"], p["iz"]["bias"], p["in"]["bias"]])),
        f"{prefix}.bias_hh_l0": _t(np.concatenate([zeros, zeros,
                                                   p["hn"]["bias"]])),
    }


def load_chain_from_flax(chain, variables, converters) -> None:
    """Load a :class:`~chainermn_torch.links.MultiNodeChainList` from the
    JAX ``MultiNodeChainList.init``'s list of flax variables (one a
    component, in insertion order): each component this rank holds gets
    ``converters[i](variables[i])`` as its ``state_dict`` (``converters``
    one callable for every component, or a list of one a component). The
    other ranks' components stay where they are."""
    if callable(converters):
        converters = [converters] * len(variables)
    if not len(variables) == len(converters) == len(chain.components):
        raise ValueError(f"{len(variables)} variables and "
                         f"{len(converters)} converters for "
                         f"{len(chain.components)} components")
    held = set(map(id, chain.local_components()))
    for link, v, convert in zip(chain.components, variables, converters):
        if id(link) in held:
            link.load_state_dict(convert(v))


def _rows(x) -> torch.Tensor:
    """A numpy array of store rows as a tensor of the same type; bfloat16
    (numpy has none, so it arrives as its ``ml_dtypes`` extension type)
    crosses bit for bit through its 16-bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def kv_payload_from_jax(payload: dict) -> dict:
    """A reference engine's ``export_slot_kv`` / ``export_prefix_kv``
    payload as the port's: the same keys, each layer's rows (int8 rows
    and their scales as stored) as CPU tensors viewing one ``packed``
    ``[n_blocks, n_layers, ...]`` buffer a store tensor. The reference's
    sampler ``key`` is a JAX PRNG key, which no torch generator can
    continue: it becomes ``None``, so a greedy request continues token
    for token and a sampled one draws a fresh stream."""
    layers = payload["layers"]
    packed = {kk: torch.stack([_rows(layer[kk]) for layer in layers], 1)
              for kk in layers[0]}
    out = {k: v for k, v in payload.items() if k not in ("layers", "key")}
    out["layers"] = [{kk: rows[:, li] for kk, rows in packed.items()}
                     for li in range(len(layers))]
    out["packed"] = packed
    if "pos" in payload:
        out["key"] = None
    if "tokens" in payload:
        out["tokens"] = np.asarray(payload["tokens"], np.int32).copy()
    return out


def parallel_conv_params_from_jax(params) -> dict:
    """The parallel-convolution example's parameters
    (``examples/parallel_convolution/train_parallel_conv.py:63``: ``w``
    HWIO kernels and biases for ``conv1``/``pconv2``/``pconv3``, ``w``
    ``[feat, classes]`` for the head) as the full, unsharded
    ``state_dict`` of the port twin's ``ConvNet``: OIHW conv weights and
    an ``nn.Linear`` head whose input features keep the reference's
    NHWC flatten order."""
    sd = {}
    for name in ("conv1", "pconv2", "pconv3"):
        sd.update(_conv({"kernel": params[name]["w"],
                         "bias": params[name]["b"]}, name))
    sd.update(_linear({"kernel": params["head"]["w"],
                       "bias": params["head"]["b"]}, "head"))
    return sd


def images_from_nhwc(images, device=None) -> torch.Tensor:
    """NHWC images (numpy or torch, the reference's layout) as the port's
    NCHW tensor in ``channels_last`` memory: a view, not a copy, of a
    contiguous NHWC input (then moved to ``device`` when given)."""
    x = torch.as_tensor(images)
    if x.dim() != 4:
        raise ValueError(f"images must be [N, H, W, C], got {tuple(x.shape)}")
    x = x.permute(0, 3, 1, 2)
    return x if device is None else x.to(device)


__all__ = ["params_from_flax", "resnet_params_from_flax",
           "mlp_params_from_flax", "alexnet_params_from_flax",
           "googlenet_params_from_flax", "vgg16_params_from_flax",
           "gru_params_from_flax", "load_chain_from_flax",
           "images_from_nhwc", "kv_payload_from_jax",
           "megatron_params_from_flax", "parallel_conv_params_from_jax",
           "pipeline_params_from_flax"]
