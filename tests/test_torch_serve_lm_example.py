"""The port's twin of ``examples/lm/serve_lm.py``
(``chainermn_torch/examples/lm/serve_lm.py``) with tiny flags on the CPU:
its defaults, each single-engine feature with ``--verify-parity``
(float32, so every checked stream must equal solo ``generate()``
exactly), the combination ``chip_smoke.py`` runs on the card, the fleet
(two replicas, disaggregated tiers, prefix sharing and the rebalance
probe), the control plane (``--health``, ``--autoscale`` with a
``--canary`` deploy and ``--slo-ttft-ms``), its request traces
(``--trace``, ``--trace-out``), its flag guards, and
``train_lm.py --serve-samples`` on the dense engine with the prefix store
and ``--publish-to engine``."""

import json

import pytest
import torch

from chainermn_torch.examples.lm import serve_lm
from chainermn_torch.monitor import trace as torch_trace
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
    "fleet_replicas": ["--replicas", "2", "--verify-parity"],
    "fleet_tiers": ["--prefill-replicas", "1", "--decode-replicas", "1",
                    "--paged-kv", "--kv-block-size", "4",
                    "--temperature", "0", "--verify-parity"],
    "fleet_share": ["--replicas", "2", "--paged-kv", "--kv-block-size", "2",
                    "--shared-prefix", "8", "--share-prefixes",
                    "--temperature", "0", "--verify-parity"],
    "fleet_rebalance": ["--replicas", "2", "--paged-kv", "--rebalance",
                        "--max-new", "24", "--temperature", "0",
                        "--verify-parity"],
}


@pytest.fixture(autouse=True)
def _fresh_tracer(monkeypatch):
    """A fresh default tracer a test: the twins configure and fill it."""
    monkeypatch.setattr(torch_trace, "_TRACER", torch_trace.Tracer())


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
    if name.startswith("fleet"):
        fleet = out["fleet"]
        assert out["report"]["fleet_capacity"] == 2
        assert sum(r["served"] for r in fleet["replicas"].values()) == 6
        for r in fleet["replicas"].values():
            assert r["recompiles"] == {}
            assert set(r["executables"].values()) == {1}
        if "--decode-replicas" in RUNS[name]:
            assert fleet["tiers"] == {"prefill": [0], "decode": [1]}
            assert fleet["kv_migrations_total"] > 0
        if "--share-prefixes" in RUNS[name]:
            assert fleet["kv_reuse"]["share_enabled"]
        if "--rebalance" in RUNS[name]:
            assert fleet["rebalanced"] is not None


CONTROL = {
    # one replica, held: a burst on a slow host must not scale it up
    "autoscale_canary": ["--autoscale", "--max-replicas", "1", "--canary",
                         "--canary-bake", "0.2", "--slo-ttft-ms", "50",
                         "--verify-parity"],
    "autoscale_fleet": ["--autoscale", "--min-replicas", "2",
                        "--max-replicas", "2", "--paged-kv", "--canary",
                        "--canary-bake", "0.2", "--temperature", "0"],
    "health_engine": ["--health", "--ts-cadence", "0.01"],
    "health_fleet": ["--replicas", "2", "--health", "--ts-cadence", "0.01"],
}


@pytest.mark.parametrize("name", list(CONTROL))
def test_twin_control_plane(name, capsys):
    """The telemetry and the controller's canary on the twin: every
    request served, the canary promoted fleet-wide (nothing regresses on
    an idle fleet), one health verdict per replica."""
    out = serve_lm.main(TINY + CONTROL[name])
    printed = capsys.readouterr().out
    assert out["served"] == 6 and out["shed_or_failed"] == 0
    n = 2 if "2" in CONTROL[name] else 1
    assert out["health"]["n_watched"] == n
    assert out["health"]["worst"] == "healthy"
    assert out["health"]["ticks"] >= 1 and out["health"]["series"] > 0
    assert "health: worst=healthy" in printed
    if "--canary" in CONTROL[name]:
        control = out["control"]
        assert control["canary"]["action"] == "canary_promote"
        assert control["history"] == [(0, "init"), (1, "canary"),
                                      (1, "publish")]
        for r in out["fleet"]["replicas"].values():
            assert r["recompiles"] == {}
        assert "canary deploy: canary_promote" in printed
    if "--verify-parity" in CONTROL[name]:
        assert out["parity"]["checked"] == 3
    if "--slo-ttft-ms" in CONTROL[name]:
        assert set(out["slo"]["ttft_p99"]["windows"]) == {"30s", "120s"}


@pytest.mark.parametrize("extra", [
    ["--prometheus"], ["--http-port", "0"],
], ids=lambda e: e[0].strip("-"))
def test_unported_flags_name_the_roadmap(extra, capsys):
    """The two flags that waited for ``monitor/`` (they raised, naming
    their ROADMAP item, until it was ported) now run: ``--prometheus``
    prints the registry's exposition, with the ledger's per-tenant
    device seconds; ``--http-port 0`` serves the scrape endpoints for the
    burst and scrapes its own ``/costs``, which agrees with the printed
    tenant bill and conserves."""
    out = serve_lm.main(TINY + ["--tenants", "3"] + extra)
    printed = capsys.readouterr().out
    assert out["served"] == out["requests"]
    costs = out["costs"]
    assert costs["device_time"]["conservation_error"] < 1e-6
    assert {"tenant0", "tenant1", "tenant2"} <= set(costs["tenants"])
    assert "cost accounting: measured=" in printed
    assert "  tenant tenant0: device=" in printed
    if extra[0] == "--prometheus":
        text = out["exposition"]
        assert "# process metrics registry (Prometheus exposition)" in printed
        assert text in printed
        for t in ("tenant0", "tenant1", "tenant2"):
            assert f'tenant="{t}"' in text
        assert "tenant_device_seconds_total{" in text
        assert "serving_decode_steps_total" in text
        assert "http" not in out
    else:
        scraped = out["http"]["costs"]
        assert scraped["tenants"].keys() == costs["tenants"].keys()
        assert scraped["device_time"] == costs["device_time"]
        assert out["http"]["metrics_lines"] > 0
        assert (f"scraped /costs: {len(costs['tenants'])} tenant(s)"
                in printed)
        assert out["http"]["url"] in printed
        assert "exposition" not in out


@pytest.mark.parametrize("flag", ["trace", "trace-out"])
def test_trace_flags_run(flag, tmp_path, monkeypatch):
    """``--trace N`` keeps every Nth request's trace (3 of 6 at N = 2,
    none at 0) and streams the same tokens; ``--trace-out`` writes Chrome
    trace-event JSON with each retained request's span tree."""
    if flag == "trace":
        def run(n):
            monkeypatch.setattr(torch_trace, "_TRACER", torch_trace.Tracer())
            return serve_lm.main(TINY + ["--trace", n, "--verify-parity"])

        every, half, off = run("1"), run("2"), run("0")
        assert (every["traces_retained"], half["traces_retained"],
                off["traces_retained"]) == (6, 3, 0)
        assert "critical_path" in every["report"]
        assert "critical_path" not in off["report"]
        assert off["parity"]["checked"] == every["parity"]["checked"] == 3
        return
    path = tmp_path / "t.json"
    out = serve_lm.main(TINY + ["--trace-out", str(path)])
    events = json.loads(path.read_text())["traceEvents"]
    roots = [e for e in events if e["ph"] == "X" and e["name"] == "request"]
    assert len(roots) == out["traces_retained"] == 6
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"queue", "admit", "prefill", "decode_step"} <= names
    assert all(e["args"]["reason"] == "length" for e in roots)


@pytest.mark.parametrize("extra", [
    ["--paged-kv", "--prefix-blocks", "4"],
    ["--speculate", "ngram", "--temperature", "0"],
    ["--paged-kv", "--speculate", "ngram"],
    ["--chunk-tokens", "4"],
    ["--tenant-weights", "tenant0"],
    ["--prefill-replicas", "1", "--paged-kv"],
    ["--prefill-replicas", "1", "--decode-replicas", "1"],
    ["--replicas", "2", "--share-prefixes"],
    ["--paged-kv", "--rebalance"],
    ["--replicas", "2", "--paged-kv", "--share-prefixes", "--no-affinity"],
    ["--canary"],
    ["--autoscale", "--prefill-replicas", "1", "--decode-replicas", "1",
     "--paged-kv"],
    ["--tensor-parallel", "--replicas", "2"],
], ids=["paged_prefix_blocks", "spec_dense", "spec_sampled",
        "chunk_dense", "weights_syntax", "tiers_one_side", "tiers_dense",
        "share_dense", "rebalance_no_fleet", "share_no_affinity",
        "canary_without_autoscale", "autoscale_tiers", "tp_fleet"])
def test_reference_guards(extra):
    """The guards of ``examples/lm/serve_lm.py:519-540`` among them: the
    tiers need both sides and the paged store, sharing and rebalancing a
    paged fleet, sharing the affinity trie."""
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


def test_train_lm_publish_to_engine():
    """``train_lm.py --publish-to engine --publish-every 2``: a live engine
    on a copy of the initial weights takes the trained weights through
    the swap fence every second iteration, sampling at each version, with
    no program rebuilt (the closing check)."""
    tiny = ["--device", "cpu", "--iterations", "4", "--n-tokens", "6000",
            "--seq-len", "32", "--d-model", "32", "--vocab", "32",
            "--publish-to", "engine", "--publish-every", "2"]
    out, = run_ranks(_SERVE_SAMPLES, 1, args=[" ".join(tiny), "dense="],
                     timeout=300)
    pub = out["dense"]["publish"]
    assert pub["weight_version"] == 2
    assert pub["versions"] == [0, 1, 2] and pub["steps"] == [None, 2, 4]
    # context min(seq_len // 2, 16) = 16 and 12 new tokens per sample
    assert [len(s) for s in pub["samples"]] == [28, 28, 28]
    assert set(pub["executables"].values()) == {1}


_CHAIN = """
import contextlib, io
from chainermn_torch import create_communicator
from chainermn_torch.examples.lm import serve_lm, train_lm

base = create_communicator("naive", device="cpu")   # owns the default group
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    out = (train_lm if ARGS[0] == "train" else serve_lm).main(ARGS[1].split())
save(dict(out, printed=buf.getvalue()))
base.finalize()
"""


def test_snapshot_then_serve_resharded(tmp_path):
    """``tests/examples_tests/test_examples.py:433-461``: a snapshot saved
    while training tensor-parallel at degree 2 (2 ranks) serves at degree
    4 (4 ranks) through ``--reshard-from``; the resharded engine's streams
    equal solo ``generate()`` of the dense LM on the same weights."""
    ckpt = str(tmp_path / "snap")
    train = run_ranks(_CHAIN, 2, args=["train", " ".join(
        ["--device", "cpu", "--iterations", "10", "--tensor-parallel",
         "--seq-len", "14", "--max-len", "14", "--vocab", "64",
         "--d-model", "32", "--n-heads", "8", "--n-layers", "1",
         "--n-tokens", "20000", "--snapshot-to", ckpt])], timeout=240)
    assert (f"snapshot -> {ckpt} (step 10, tp_degree=2)"
            in train[0]["printed"])
    serve = run_ranks(_CHAIN, 4, args=["serve", " ".join(
        ["--device", "cpu", "--requests", "4", "--slots", "2",
         "--max-new", "6", "--prefill-len", "8", "--vocab", "64",
         "--d-model", "32", "--layers", "1", "--heads", "8",
         "--tensor-parallel", "--reshard-from", ckpt,
         "--verify-parity"])], timeout=240)
    lead, followers = serve[0], serve[1:]
    assert ("resharded snapshot step 10: save-time tp_degree=2 -> "
            "serving tp_degree=4") in lead["printed"]
    assert "4/4 requests served" in lead["printed"]
    assert "parity vs solo generate: OK (3 requests" in lead["printed"]
    assert lead["recompiles"] == {} and lead["tensor_parallel"] == 4
    for f in followers:
        assert f["follower"] and f["programs"]["decode"] >= 1
        assert f["reshard"] == lead["reshard"] == {
            "step": 10, "save_tp_degree": 2, "serve_tp_degree": 4}
