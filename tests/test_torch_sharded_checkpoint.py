"""The port's sharded checkpointer
(``chainermn_torch/extensions/sharded_checkpoint.py``, on
``torch.distributed.checkpoint``) against the reference's contracts
(``chainermn_tpu/extensions/sharded_checkpoint.py``).

In one process: a save/restore round trip is bit-exact (f32, bf16,
int64, nested dicts and plain leaves), ``keep`` GCs the older snapshots
and their manifests, a corrupt manifest reads ``None``, the manifest's
footer bytes check with the JAX package's ``_strip_footer``, the retry
and the save/load cut-points fire, ``wait=False`` joins, and an empty
directory restores ``(None, None)``.

On two gloo ranks (started once for the module): a tensor both ranks
hold whole under one key (a TP parameter) is written once, and an FSDP2
model and its optimizer state saved on 2 ranks restore on 2 with the
same ``DTensor`` placements and values
(``tests/parallel_tests/test_fsdp.py:130-165``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from _torch_isolation import fresh_telemetry
from chainermn_tpu.extensions.checkpoint import _strip_footer as jax_strip
from chainermn_torch.extensions import ShardedCheckpointer
from chainermn_torch.monitor import get_registry
from chainermn_torch.resilience import RetryPolicy
from chainermn_torch.resilience.cutpoints import (
    SHARDED_CHECKPOINT_LOAD,
    SHARDED_CHECKPOINT_SAVE,
)
from chainermn_torch.resilience.faults import FaultInjector, InjectedFault
from chainermn_torch.testing import run_ranks


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(5, 3, generator=gen),
                       "b16": torch.randn(4, generator=gen).bfloat16(),
                       "idx": torch.randint(0, 9, (6,), generator=gen)},
            "opt": {"state": {"w": {"exp_avg": torch.randn(5, 3,
                                                            generator=gen),
                                    "step": torch.tensor(float(seed))}},
                    "lr": 1e-3 * seed},
            "it": seed}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return type(tree)(0)


def _assert_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, torch.Tensor)
                                  and isinstance(b, torch.Tensor))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        assert a == b


def test_round_trip_is_bit_exact_and_in_place(tmp_path):
    cp = ShardedCheckpointer(str(tmp_path / "ck"))
    assert cp.maybe_restore(_state(1)) == (None, None)
    assert cp.manifest() is None and cp.all_steps() == []
    saved = _state(3)
    cp.save(7, saved, meta={"tp_degree": 2, "note": "x"})
    template = _zeros_like(saved)
    w = template["params"]["w"]
    restored, step = cp.maybe_restore(template)
    assert step == 7
    _assert_equal(restored, saved)
    assert restored["params"]["w"] is w          # filled in place
    assert cp.manifest() == {"tp_degree": 2, "note": "x", "step": 7}
    # a device override loads onto fresh tensors, the template untouched
    fresh = _zeros_like(saved)
    out, _ = cp.maybe_restore(fresh, shardings="cpu")
    _assert_equal(out, saved)
    assert float(fresh["params"]["w"].abs().sum()) == 0.0
    # a subset template restores just its keys
    part, _ = cp.maybe_restore({"params": _zeros_like(saved["params"])})
    _assert_equal(part["params"], saved["params"])


def test_keep_gc_drops_old_snapshots_and_manifests(tmp_path):
    cp = ShardedCheckpointer(str(tmp_path / "ck"), keep=2)
    for s in range(1, 6):
        cp.save(s, _state(s), meta={"s": s})
    assert cp.all_steps() == [4, 5]
    assert sorted(os.listdir(str(tmp_path / "ck.meta"))) == [
        "manifest_4.bin", "manifest_5.bin"]
    restored, step = cp.maybe_restore(_zeros_like(_state(0)), step=4)
    assert step == 4
    _assert_equal(restored, _state(4))
    assert cp.manifest(4)["s"] == 4 and cp.manifest()["s"] == 5


def test_corrupt_manifest_reads_absent_and_footer_matches_jax(tmp_path):
    cp = ShardedCheckpointer(str(tmp_path / "ck"))
    cp.save(2, _state(2), meta={"tp_degree": 4, "n_heads": 8})
    path = tmp_path / "ck.meta" / "manifest_2.bin"
    raw = path.read_bytes()
    payload, ok = jax_strip(raw)      # the reference's footer reader
    assert ok is True
    assert pickle.loads(payload) == {"tp_degree": 4, "n_heads": 8,
                                     "step": 2}
    bad = bytearray(raw)
    bad[3] ^= 0xFF
    path.write_bytes(bytes(bad))
    assert cp.manifest(2) is None and cp.manifest() is None
    # the tensors themselves still restore
    restored, _ = cp.maybe_restore(_zeros_like(_state(0)))
    _assert_equal(restored, _state(2))


def test_retry_and_cut_points_fire(tmp_path):
    cp = ShardedCheckpointer(str(tmp_path / "ck"),
                             retry=RetryPolicy(3, base_delay_s=0.0,
                                               jitter=0.0))
    with FaultInjector() as inj:
        inj.arm(SHARDED_CHECKPOINT_SAVE, times=1)
        inj.arm(SHARDED_CHECKPOINT_LOAD, times=1)
        cp.save(1, _state(1))
        restored, _ = cp.maybe_restore(_zeros_like(_state(0)))
    _assert_equal(restored, _state(1))
    reg = get_registry()
    for op in ("sharded_checkpoint.save", "sharded_checkpoint.load"):
        assert reg.counter("retries_total", {"op": op}).value == 1
    plain = ShardedCheckpointer(str(tmp_path / "ck2"))
    with FaultInjector() as inj:
        inj.arm(SHARDED_CHECKPOINT_SAVE, times=1)
        with pytest.raises(InjectedFault):
            plain.save(1, _state(1))
    assert plain.all_steps() == []


def test_async_save_joins(tmp_path):
    with ShardedCheckpointer(str(tmp_path / "ck")) as cp:
        cp.save(3, _state(3), wait=False, meta={"a": 1})
        cp.wait_until_finished()
        assert cp.all_steps() == [3] and cp.manifest() == {"a": 1, "step": 3}
        cp.save(4, _state(4), wait=False)
    restored, step = ShardedCheckpointer(str(tmp_path / "ck")).maybe_restore(
        _zeros_like(_state(0)))
    assert step == 4
    _assert_equal(restored, _state(4))


_RANKS = """
import os
import torch
from torch.distributed.tensor import DTensor
from chainermn_torch import create_communicator
from chainermn_torch.deploy import restore_train_state, train_state_dict
from chainermn_torch.extensions import ShardedCheckpointer
from chainermn_torch.models import ResNet
from chainermn_torch.parallel.fsdp import fsdp_shard, fsdp_train_step

torch.set_float32_matmul_precision("highest")
comm = create_communicator("pure_nccl", device="cpu")
out = {}
# a tensor both ranks hold whole under one key: written once
whole = torch.arange(1 << 16, dtype=torch.float32)
cp = ShardedCheckpointer(os.path.join(ARGS[0], "tp"))
cp.save(1, {"w": whole.clone()})
files = os.path.join(ARGS[0], "tp", "1")
out["bytes"] = sum(os.path.getsize(os.path.join(files, f))
                   for f in os.listdir(files))
got, _ = cp.maybe_restore({"w": torch.zeros_like(whole)})
out["whole_ok"] = bool(torch.equal(got["w"], whole))

cfg = dict(stage_sizes=[1], width=4, num_classes=10)

def build(seed):
    m = ResNet(**cfg, compute_dtype=torch.float32, device="cpu", seed=seed)
    m = fsdp_shard(m, comm)
    return m, torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)

model, opt = build(0)
step = fsdp_train_step(model, opt, comm)
gen = torch.Generator().manual_seed(RANK)
step(torch.randn(2, 3, 16, 16, generator=gen),
     torch.randint(0, 10, (2,), generator=gen))
ck = ShardedCheckpointer(os.path.join(ARGS[0], "fsdp"))
ck.save(1, train_state_dict(model, opt))
other, other_opt = build(5)
state, at = restore_train_state(ck, model=other, optimizer=other_opt)
out["step"] = at

def describe(sd):
    rec = {}
    for k, v in sd.items():
        if isinstance(v, DTensor):
            rec[k] = (str(v.placements), v.to_local().clone(),
                      v.full_tensor().clone())
        else:
            rec[k] = ("whole", v.clone(), v.clone())
    return rec

out["saved"] = describe(model.state_dict())
out["restored"] = describe(other.state_dict())
mom = lambda o: {k: v["momentum_buffer"] for k, v in o.state_dict()["state"].items()}
out["moments"] = [(mom(opt)[k].to_local().clone()
                   if isinstance(mom(opt)[k], DTensor) else mom(opt)[k].clone(),
                   mom(other_opt)[k].to_local().clone()
                   if isinstance(mom(other_opt)[k], DTensor)
                   else mom(other_opt)[k].clone())
                  for k in mom(opt)]
save(out)
comm.finalize()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(_RANKS, 2, args=[str(tmp_path_factory.mktemp("sc"))],
                     timeout=240)


def test_replicated_tensor_is_written_once(ranks):
    for r in ranks:
        assert r["whole_ok"]
        # one copy of 256 KB (plus DCP's framing), not one a rank
        assert 4 << 16 <= r["bytes"] < 2 * (4 << 16)


def test_fsdp_state_restores_with_its_placements(ranks):
    for r in ranks:
        assert r["step"] == 1
        assert r["saved"].keys() == r["restored"].keys()
        sharded = 0
        for k, (place, local, full) in r["saved"].items():
            got_place, got_local, got_full = r["restored"][k]
            assert got_place == place, k
            assert torch.equal(got_local, local), k
            assert torch.equal(got_full, full), k
            sharded += place != "whole"
        assert sharded > 0
        assert r["moments"]
        for want, got in r["moments"]:
            assert torch.equal(got, want)
    # the ranks hold different shards of the same tensors
    k = next(k for k, v in ranks[0]["saved"].items() if v[0] != "whole")
    assert not torch.equal(ranks[0]["saved"][k][1], ranks[1]["saved"][k][1])
    assert torch.equal(ranks[0]["saved"][k][2], ranks[1]["saved"][k][2])
