"""Gradient flat-packing: one flat buffer per dtype, so a strategy moves
one collective per dtype instead of one per parameter (the port's copy of
``chainermn_tpu/communicators/_memory_utility.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class _PackMeta:
    dtype: torch.dtype
    indices: tuple[int, ...]      # positions in the original leaf list
    shapes: tuple[torch.Size, ...]
    sizes: tuple[int, ...]


def pack_leaves(leaves: list[torch.Tensor]
                ) -> tuple[list[torch.Tensor], list[_PackMeta]]:
    """Group leaves by dtype and concatenate each group into one new flat
    buffer (never a view of a leaf). Returns ``(buffers, metas)``;
    :func:`unpack_leaves` inverts. Order inside a buffer follows the leaf
    order, so pack/unpack round-trips exactly."""
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buffers, metas = [], []
    for dtype, idxs in by_dtype.items():
        buffers.append(torch.cat([leaves[i].reshape(-1) for i in idxs]))
        metas.append(_PackMeta(
            dtype=dtype, indices=tuple(idxs),
            shapes=tuple(leaves[i].shape for i in idxs),
            sizes=tuple(leaves[i].numel() for i in idxs)))
    return buffers, metas


def unpack_leaves(buffers: list[torch.Tensor],
                  metas: list[_PackMeta]) -> list[torch.Tensor]:
    """The leaves as views of the buffers, in the original order."""
    out: list = [None] * sum(len(m.indices) for m in metas)
    for buf, meta in zip(buffers, metas):
        for idx, shape, chunk in zip(meta.indices, meta.shapes,
                                     buf.split(list(meta.sizes))):
            out[idx] = chunk.view(shape)
    return out


__all__ = ["pack_leaves", "unpack_leaves"]
