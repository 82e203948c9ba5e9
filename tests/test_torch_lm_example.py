"""The port's twin of ``examples/lm/train_lm.py``
(``chainermn_torch/examples/lm/train_lm.py``): the reference's data
stream draw for draw, its flag guards, the flags whose machinery is not
ported yet, and two iterations in every mode it ports on two gloo CPU
ranks (started once for the module)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from chainermn_torch.examples.lm import train_lm
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


@pytest.mark.parametrize("extra", [
    ["--resume"], ["--inject-fault", "3"], ["--prefetch-depth", "2"],
    ["--fetch-every", "4"], ["--snapshot-to", "snap"],
    ["--trace-out", "t.json"],
], ids=lambda e: e[0].strip("-"))
def test_unported_flags_raise_naming_the_roadmap(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_lm.main(TINY + extra)


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
