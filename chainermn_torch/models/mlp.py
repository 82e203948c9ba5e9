"""MLP, the reference's MNIST model (the port of
``chainermn_tpu/models/mlp.py``): ``n_in -> n_units -> n_units ->
n_out`` with relu, every layer in ``compute_dtype`` over float32
parameters, logits cast to float32. flax infers the input width at init;
here it is ``n_in`` (MNIST's 784 by default)."""

from __future__ import annotations

import torch
from torch import nn

from chainermn_torch._device import resolve_device
from chainermn_torch.models.resnet import _dense, _lecun_normal_


class MLP(nn.Module):
    def __init__(self, n_units: int = 1000, n_out: int = 10,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 n_in: int = 784, device=None, seed: int = 0) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.fcs = nn.ModuleList([
            nn.Linear(n_in, n_units, device=device),
            nn.Linear(n_units, n_units, device=device),
            nn.Linear(n_units, n_out, device=device)])
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for fc in self.fcs:
                _lecun_normal_(fc.weight, fc.in_features, gen)
                fc.bias.zero_()

    def forward(self, x, train=None):
        del train
        dt = self.compute_dtype
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_dense(self.fcs[0], x, dt))
        x = torch.relu(_dense(self.fcs[1], x, dt))
        return _dense(self.fcs[2], x, dt).float()


__all__ = ["MLP"]
