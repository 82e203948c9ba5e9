"""The port's twin of ``examples/lm/train_lm.py``
(``chainermn_torch/examples/lm/train_lm.py``): the reference's data
stream draw for draw, its flag guards, ``--snapshot-to``, the ``fit``,
``resilient_fit`` and ``--trace-out`` flags on one rank, and two
iterations in every mode it ports on two gloo CPU ranks (started once
for the module)."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_torch.examples.lm import train_lm
from chainermn_torch.monitor import trace as torch_trace
from chainermn_torch.testing import run_ranks

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--iterations", "2", "--n-tokens", "6000",
        "--seq-len", "32", "--d-model", "32", "--vocab", "32"]
MODES = {
    "plain": [],
    "flash": ["--attention", "flash"],
    "seq_parallel_ring": ["--seq-parallel", "--attention", "ring_flash"],
    "seq_parallel_zigzag": ["--seq-parallel", "--attention", "zigzag"],
    "seq_parallel_ulysses": ["--seq-parallel", "--attention",
                             "ulysses_flash"],
    "tensor_parallel": ["--tensor-parallel", "--vocab-parallel-head",
                        "--attention", "flash"],
    "moe_top2": ["--moe-experts", "4", "--moe-top-k", "2", "--attention",
                 "flash"],
    "remat_fused_ce": ["--remat", "--fused-ce", "--moe-experts", "4"],
    "gspmd_moe": ["--gspmd", "--moe-experts", "4", "--remat"],
    "gspmd_dense": ["--gspmd", "--attention", "flash"],
    "pipeline": ["--pipeline", "--microbatches", "2"],
}

@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    """A fresh default tracer a test: the twins configure and fill it."""
    monkeypatch.setattr(torch_trace, "_TRACER", torch_trace.Tracer())


_RANKS = """
from chainermn_torch import create_communicator
from chainermn_torch.examples.lm import train_lm

base = create_communicator("naive", device="cpu")   # owns the default group
save({name: train_lm.main(ARGS[0].split() + extra.split())
      for name, extra in (a.split("=", 1) for a in ARGS[1:])})
base.finalize()
"""


@pytest.fixture(scope="module")
def runs():
    return run_ranks(_RANKS, 2, args=[" ".join(TINY)] + [
        f"{name}={' '.join(extra)}" for name, extra in MODES.items()],
        timeout=300)


def test_markov_stream_matches_the_jax_script():
    """``markov_stream`` and the sequences cut from it equal the JAX
    script's (``train_lm.py:52-74``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm", ROOT / "examples" / "lm" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    np.testing.assert_array_equal(train_lm.markov_stream(5000, 64),
                                  ref.markov_stream(5000, 64))
    args = train_lm._parser().parse_args(["--n-tokens", "3000",
                                          "--seq-len", "16"])
    for got, want in zip(train_lm._stream_data(args),
                         ref._stream_data(args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MODES))
def test_every_mode_trains_two_iterations(runs, name):
    """Each mode finishes its two iterations with finite losses that both
    ranks agree on; MoE modes report their drop fractions, gspmd its
    stored fraction (below 1), the pipeline its bubble."""
    for rank in runs:
        out = rank[name]
        assert len(out["losses"]) == 2
        assert np.isfinite(out["losses"]).all()
        assert out["losses"] == runs[0][name]["losses"]
    out = runs[0][name]
    if "--moe-experts" in MODES[name]:
        assert out["moe_drop"]["steps"] == 2
    if name.startswith("gspmd"):
        assert out["mode"] == "gspmd"
        assert out["stored_fraction"]["params"] < 1.0
    if name == "pipeline":
        assert out["mode"] == "pipeline"
        assert out["bubble"] == pytest.approx(1 / 3)


@pytest.mark.parametrize("extra", [
    ["--pipeline", "--moe-experts", "2"],
    ["--pipeline", "--remat"],
    ["--fused-ce", "--gspmd"],
    ["--gspmd", "--seq-parallel"],
    ["--gspmd", "--attention", "ring"],
    ["--resume", "--pipeline"],
    ["--fetch-every", "2", "--gspmd"],
    ["--publish-to", "somewhere"],
    ["--publish-to", "engine", "--tensor-parallel"],
    ["--snapshot-to", "x", "--gspmd"],
], ids=lambda e: "_".join(a.strip("-") for a in e))
def test_flag_guards_refuse_before_any_rank_starts(extra):
    """The reference's flag guards (``train_lm.py:520-573``)."""
    with pytest.raises(SystemExit):
        train_lm.main(TINY + extra)


@pytest.mark.parametrize("extra", [[], ["--fetch-every", "2"]],
                         ids=["plain", "fit"])
def test_snapshot_to_saves_params_and_manifest(extra, tmp_path):
    """``--snapshot-to`` (``train_lm.py:178-191``): the trained parameters
    at step ``--iterations`` with the resharding manifest, from the plain
    and the ``fit`` loop (``test_torch_serve_lm_example.py`` serves a
    tensor-parallel one resharded)."""
    from chainermn_torch.extensions import ShardedCheckpointer
    from chainermn_torch.models import TransformerLM

    snap = str(tmp_path / "snap")
    out = train_lm.main(TINY + extra + ["--snapshot-to", snap])
    cp = ShardedCheckpointer(snap)
    assert cp.all_steps() == [2]
    m = cp.manifest()
    assert (m["tp_degree"], m["tensor_parallel"], m["n_heads"], m["d_head"],
            m["world_size"], m["step"]) == (1, False, 8, 4, 1, 2)
    model = TransformerLM(32, 32, 8, 2, max_len=512, device="cpu")
    restored, step = cp.maybe_restore({"params": model.state_dict()})
    assert step == 2
    fresh = TransformerLM(32, 32, 8, 2, max_len=512, device="cpu", seed=0)
    assert not all(torch.equal(a, b) for a, b in zip(
        restored["params"].values(), fresh.state_dict().values()))
    assert len(out["losses"]) == 2


LIFTED = ["--iterations", "5"]


@pytest.fixture(scope="module")
def plain_losses():
    """The synchronous loop's losses over five iterations, one rank."""
    return train_lm.main(TINY + LIFTED)["losses"]


@pytest.mark.parametrize("flag", ["resume", "inject-fault", "prefetch-depth",
                                  "fetch-every", "trace-out"])
def test_lifted_flags_run(flag, plain_losses, tmp_path):
    """The flags that drive ``training.fit``, ``resilient_fit`` and the
    tracer, on one rank: the windowed loop's losses equal the synchronous
    loop's bit for bit; ``--resume`` continues a stopped run on an
    uninterrupted run's losses, and so does a run crashed at step 3 by
    ``--inject-fault 3``; ``--trace-out`` writes Chrome trace-event
    JSON with every step's span tree."""
    ckpt = ["--checkpoint-dir", str(tmp_path / "ck"), "--save-every", "2"]
    if flag in ("prefetch-depth", "fetch-every"):
        extra = (["--prefetch-depth", "2"] if flag == "prefetch-depth"
                 else ["--fetch-every", "4", "--prefetch-depth", "2"])
        out = train_lm.main(TINY + LIFTED + extra)
        assert out["mode"] == "fit"
        assert out["losses"] == plain_losses
    elif flag == "resume":
        whole = train_lm.main(TINY + LIFTED + ["--resume", "--checkpoint-dir",
                                               str(tmp_path / "whole")])
        assert whole["mode"] == "resilient" and len(whole["losses"]) == 5
        first = train_lm.main(TINY + ["--iterations", "3", "--resume"]
                              + ckpt)
        out = train_lm.main(TINY + LIFTED + ["--resume"] + ckpt)
        assert out["report"]["resumed_from"] == 3
        assert first["losses"] + out["losses"] == whole["losses"]
    elif flag == "inject-fault":
        whole = train_lm.main(TINY + LIFTED + ["--resume"] + ckpt[:1]
                              + [str(tmp_path / "whole")])
        out = train_lm.main(TINY + LIFTED + ["--resume", "--inject-fault",
                                             "3"] + ckpt)
        rep = out["report"]
        assert (rep["failures"], rep["restores"],
                rep["resumed_from"]) == (1, 1, 0)
        assert rep["mttr_s"][0] > 0
        assert out["losses"] == whole["losses"]
    else:
        path = tmp_path / "t.json"
        out = train_lm.main(TINY + LIFTED + ["--fetch-every", "2",
                                             "--trace-out", str(path)])
        events = json.loads(path.read_text())["traceEvents"]
        steps = [e for e in events
                 if e["ph"] == "X" and e["name"] == "train_step"]
        assert sorted(e["args"]["step"] for e in steps) == list(range(5))
        names = {e["name"] for e in events if e["ph"] == "X"}
        assert {"prefetch_wait", "dispatch", "loss_fetch"} <= names
        assert all(e["dur"] >= 0 for e in events if e["ph"] == "X")
        assert out["losses"] == plain_losses


@pytest.mark.parametrize("extra", [
    ["--pipeline", "--n-layers", "3"],
    ["--seq-parallel"],
    ["--vocab-parallel-head"],
], ids=["pipeline_layers", "seq_parallel_full", "vocab_head_alone"])
def test_guards_that_need_the_ranks(extra):
    """The guards that read the group (``train_lm.py:577-597``), on one
    rank."""
    with pytest.raises(SystemExit):
        train_lm.main(TINY + extra)
