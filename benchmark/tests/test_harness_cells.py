"""Both drivers at tiny presets on the CPU's plain kernels: the result
line, faults planted under a run, a run without a card, a new cell and
metric from new files alone, and what the harness and the reference
load. These check the harness, not speed."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run
import tiny
from harness.common import FORBIDDEN_MODULES

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77      # past 32 signed bits, as the driver's seeds are
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dummy = ('LAYER = "test"\nMOVES = "setup_s"\n\n\n'
             'def read(run):\n    return 42.0\n')
    return tiny.make_root(tmp_path_factory.mktemp("bench"),
                          {"dummy_metric.test": dummy})


def _run(root, cell, trace=0, seconds=0.5):
    return run.run_cell(cell, SEED, seconds, trace, root=root, device="cpu")


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_line(root, cell, trace):
    line = _run(root, cell, trace)
    json.loads(json.dumps(line))
    keys = list(line)
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    man = json.loads((root / "BENCHMARK.json").read_text())
    section = man["per_layer"] if trace else man["end_to_end"]
    units = {m["name"]: m["unit"] for m in section}
    for name, m in line["metrics"].items():
        assert units[name] == m["unit"]
        assert isinstance(m["value"], float)
    if trace:
        assert line["metrics"]["dummy_metric.test"]["value"] == 42.0
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = {"tiny.serve": {"serve_tokens_per_s", "setup_s"},
               "tiny.train": {"train_step_ms", "setup_s"}}[cell]
        assert set(line["metrics"]) == e2e
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_work(root):
    a = _run(root, "tiny.train", seconds=0.2)
    b = _run(root, "tiny.train", seconds=0.2)
    assert a["checks"] == b["checks"]


def test_altered_token_fails(root, monkeypatch):
    from chainermn_torch.serving.engine import ServingEngine

    body = ServingEngine._decode_body

    def altered(self, n, ins):
        out = body(self, n, ins)
        return (out + 1) % self.model.vocab_size

    monkeypatch.setattr(ServingEngine, "_decode_body", altered)
    line = _run(root, "tiny.serve")
    assert line["correct"] is False
    gap = line["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_unwritten_kv_fails(root, monkeypatch):
    """A decode step that leaves the cache as it was: the K/V rows the
    step should write are never written."""
    from chainermn_torch.parallel import sequence

    orig = sequence.paged_update_cache_and_attend

    def frozen(kv_cache, q, k, v, pos_offset, **kw):
        if q.shape[1] == 1:
            k, v = torch.zeros_like(k), torch.zeros_like(v)
        return orig(kv_cache, q, k, v, pos_offset, **kw)

    monkeypatch.setattr(sequence, "paged_update_cache_and_attend", frozen)
    line = _run(root, "tiny.serve")
    assert line["correct"] is False


def test_unchanged_state_fails(root, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    line = _run(root, "tiny.train", seconds=0.2)
    assert line["correct"] is False
    assert line["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails(root, monkeypatch):
    import chainermn_torch.training as training

    build = training.lm_train_step

    def half(*a, **k):
        step = build(*a, **k)

        def body(tokens, targets):
            b = tokens.shape[0] // 2
            return step(tokens[:b], targets[:b])

        return body

    monkeypatch.setattr(training, "lm_train_step", half)
    line = _run(root, "tiny.train", seconds=0.2)
    assert line["correct"] is False


def test_control_in_the_programs_place_fails(root):
    """The reference in float8 matrix products against the float32 one:
    the tiny cells' numbers must fail by at least one."""
    from harness import checks
    from harness.common import cell_files
    from harness.traffic import TrainTraffic
    from reference import gpt2

    cell, cfg, traffic = cell_files(root, "tiny.train")
    feed = TrainTraffic(traffic, SEED, cfg["vocab_size"], "cpu")
    batches = [feed.next() for _ in range(3)]
    ref = gpt2.train_reference(cfg, SEED, batches, cell["optimizer"],
                               device="cpu")
    low = gpt2.train_reference(cfg, SEED, batches, cell["optimizer"],
                               device="cpu", precision="fp8")
    lim = cell["check"]["limits"]
    got = {"loss_gap": checks.loss_gap(low["losses"], ref["losses"]),
           "grad_norm_gap": checks.leaf_gap(low["grad_norms"],
                                            ref["grad_norms"])[0]}
    assert any(got[k] > lim[k] for k in got), got

    cell, cfg, _ = cell_files(root, "tiny.serve")
    gen = torch.Generator().manual_seed(3)
    seqs = [torch.randint(0, cfg["vocab_size"], (40,), generator=gen)
            for _ in range(3)]
    out = gpt2.served_logits(cfg, SEED, seqs, [10] * 3,
                             weight_dtype=torch.bfloat16, device="cpu",
                             precisions=("f32", "fp8"))
    gap = checks.widest_logit_gap(out["f32"],
                                  [lg.argmax(-1) for lg in out["fp8"]])
    assert gap > cell["check"]["limits"]["max_logit_gap"]


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "cerebras-gpt-6.7b.serve_long", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA card" in res.stderr


_PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _loaded(body: str) -> set:
    code = _PROBE.format(root=str(ROOT), bench=str(ROOT / "benchmark"),
                         body=body)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax(root):
    body = (f"import run\nrun.run_cell('tiny.train', {SEED}, 0.2, 1, "
            f"root={str(root)!r}, device='cpu')\n"
            f"run.run_cell('tiny.serve', {SEED}, 0.2, 0, "
            f"root={str(root)!r}, device='cpu')")
    tops = _loaded(body)
    assert not tops & set(FORBIDDEN_MODULES)
    assert "chainermn_torch" in tops


def test_reference_loads_no_program():
    body = (
        "import torch\nfrom reference import gpt2\n"
        "from harness import checks, traffic, weights, common\n"
        "cfg = dict(vocab_size=11, n_embd=8, n_layer=1, n_head=2, "
        "n_inner=16, n_positions=16, layer_norm_epsilon=1e-6)\n"
        "gpt2.served_logits(cfg, 1, [torch.arange(6)], [2], "
        "weight_dtype=torch.bfloat16, device='cpu')\n"
        "gpt2.train_reference(cfg, 1, [(torch.zeros(1, 4, dtype=torch.long),"
        " torch.ones(1, 4, dtype=torch.long))], dict(lr=1e-3, "
        "betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0), device='cpu')")
    tops = _loaded(body)
    assert not tops & set(FORBIDDEN_MODULES)
    assert "chainermn_torch" not in tops


@pytest.mark.chip
def test_cells_build_on_the_card():
    """Each cell's first seconds on a card (run by hand on the chip)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        line = run.run_cell(w["name"], SEED, 2.0, 0)
        assert line["correct"], (w["name"], line["checks"])
