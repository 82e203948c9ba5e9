"""The port's twin of ``examples/lm/serve_lm.py``
(``chainermn_torch/examples/lm/serve_lm.py``) with tiny flags on the CPU:
its defaults, each single-engine feature with ``--verify-parity``
(float32, so every checked stream must equal solo ``generate()``
exactly), the combination ``chip_smoke.py`` runs on the card, its flag
guards, and ``train_lm.py --serve-samples`` on the dense engine with the
prefix store."""

import pytest
import torch

from chainermn_torch.examples.lm import serve_lm
from chainermn_torch.testing import run_ranks

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--requests", "6", "--max-new", "8"]
RUNS = {
    "defaults": [],
    "dense_sampled_parity": ["--verify-parity"],
    "prefix_store": ["--prefix-blocks", "16", "--prefix-block-size", "2",
                     "--shared-prefix", "8", "--prefill-buckets", "4,16",
                     "--prefill-batch", "2", "--verify-parity"],
    "paged_int8": ["--paged-kv", "--kv-block-size", "4", "--kv-quant",
                   "int8"],
    "spec_ngram": ["--paged-kv", "--kv-block-size", "4", "--temperature",
                   "0", "--speculate", "ngram", "--shared-prefix", "6",
                   "--verify-parity"],
    "spec_draft": ["--paged-kv", "--temperature", "0", "--speculate",
                   "draft", "--spec-k", "3", "--verify-parity"],
    "chunked": ["--paged-kv", "--kv-block-size", "4", "--chunk-tokens", "4",
                "--verify-parity"],
    "tenants_mixed": ["--tenants", "3", "--priority", "mixed",
                      "--tenant-weights", "tenant0=4,tenant1=1",
                      "--brownout", "2"],
    "chip_combination": ["--paged-kv", "--temperature", "0", "--speculate",
                         "ngram", "--chunk-tokens", "8", "--tenants", "3",
                         "--priority", "mixed", "--brownout", "2",
                         "--verify-parity"],
}


@pytest.mark.parametrize("name", list(RUNS))
def test_twin_serves_the_burst(name, capsys):
    out = serve_lm.main(TINY + RUNS[name])
    printed = capsys.readouterr().out
    assert "6/6 requests served in" in printed
    assert out["served"] == 6 and out["shed_or_failed"] == 0
    assert out["report"]["tokens_generated"] > 0
    assert out["compute_dtype"] == "float32"
    if "--verify-parity" in RUNS[name]:
        assert out["parity"]["checked"] == 3
        assert out["parity"]["near_ties"] == []
    if "--speculate" in RUNS[name]:
        assert out["spec"]["spec_tokens_proposed"] > 0
        assert out["report"]["spec_tokens_proposed"] \
            == out["spec"]["spec_tokens_proposed"]
    if "--prefix-blocks" in RUNS[name]:
        assert out["prefix"]["hits"] > 0
    if "--paged-kv" in RUNS[name]:
        assert out["kv"]["blocks_reserved"] == 0
    if "--brownout" in RUNS[name]:
        assert out["brownout"]["level"] <= 2


@pytest.mark.parametrize("extra", [
    ["--replicas", "2"], ["--prefill-replicas", "1"], ["--share-prefixes"],
    ["--rebalance"], ["--affinity"], ["--no-affinity"], ["--autoscale"],
    ["--canary"],
    ["--reshard-from", "snap"], ["--tensor-parallel"], ["--prometheus"],
    ["--trace", "2"], ["--trace-out", "t.json"], ["--slo-ttft-ms", "50"],
    ["--http-port", "0"], ["--health"],
], ids=lambda e: e[0].strip("-"))
def test_unported_flags_name_the_roadmap(extra):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        serve_lm.main(TINY + extra)


@pytest.mark.parametrize("extra", [
    ["--paged-kv", "--prefix-blocks", "4"],
    ["--speculate", "ngram", "--temperature", "0"],
    ["--paged-kv", "--speculate", "ngram"],
    ["--chunk-tokens", "4"],
    ["--tenant-weights", "tenant0"],
], ids=["paged_prefix_blocks", "spec_dense", "spec_sampled",
        "chunk_dense", "weights_syntax"])
def test_reference_guards(extra):
    with pytest.raises(SystemExit):
        serve_lm.main(TINY + extra)


_SERVE_SAMPLES = """
from chainermn_torch import create_communicator
from chainermn_torch.examples.lm import train_lm

base = create_communicator("naive", device="cpu")   # owns the default group
save({name: train_lm.main(ARGS[0].split() + extra.split())
      for name, extra in (a.split("=", 1) for a in ARGS[1:])})
base.finalize()
"""


def test_train_lm_serve_samples_on_the_dense_engine():
    """``train_lm.py --serve-samples 5`` trains, then serves five
    shared-context continuations through the dense engine's prefix store
    (a dense LM, and an expert-parallel one through its gshard copy). The
    first four admit in one batched prefill before anything is cached;
    the fifth hits the prefix they inserted."""
    tiny = ["--device", "cpu", "--iterations", "2", "--n-tokens", "6000",
            "--seq-len", "32", "--d-model", "32", "--vocab", "32",
            "--serve-samples", "5"]
    out, = run_ranks(_SERVE_SAMPLES, 1, args=[
        " ".join(tiny), "dense=", "moe=--moe-experts 2"], timeout=300)
    for name in ("dense", "moe"):
        served = out[name]["serve_samples"]
        assert len(served["samples"]) == 5
        # context min(seq_len // 2, 24) = 16, a 1..8-token tail, 12 new
        assert [len(s) for s in served["samples"]] == [
            16 + 1 + i % 8 + 12 for i in range(5)]
        assert served["prefix"]["hits"] >= 1
        assert served["prefix"]["inserted_blocks"] >= 4
