"""The operation and byte counts the per-layer metrics carry, checked by
hand at the shapes the port's kernel table uses, the readers against a
synthetic trace, and the manifest against the benchmark's files."""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from harness.common import PEAKS, load_module
from harness.trace import TraceSummary, reduce_events
from harness.weights import group_specs

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
H100 = "NVIDIA H100 80GB HBM3"
# the captured serve table of the port's smoke test: 16 slots' lengths
SERVE_LENGTHS = [450, 158, 514, 513, 99, 130, 127, 129, 436, 365, 306, 342,
                 78, 108, 105, 96]
LM_220M = {"n_embd": 1024, "n_inner": 4096, "vocab_size": 32768,
           "n_positions": 2048, "n_layer": 12, "n_head": 16}


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def test_flash_counts_at_the_kernel_table_shape():
    fr = metric("flash_roofline.train")
    # B 8, T 2048, H 16, D 64, causal: 268,566,528 visible pairs
    assert fr.pairs(8, 16, 2048) == 268_566_528
    assert fr.fwd_flops(8, 16, 2048, 64) == 68_753_031_168        # 68.75 G
    assert fr.dq_flops(8, 16, 2048, 64) == 103_129_546_752        # 103.1 G
    assert fr.dkv_flops(8, 16, 2048, 64) == 137_506_062_336       # 137.5 G


def test_paged_decode_bytes_at_the_captured_serve_table():
    pr = metric("paged_decode_roofline.serve")
    assert pr.call_bytes(SERVE_LENGTHS, 16, 64, 16) == 16_270_400


def test_lm_step_flops_and_parameters():
    mt = metric("mfu.train")
    assert mt.n_params(LM_220M) == 220_395_520
    assert mt.step_flops(LM_220M, 8, 2048) == pytest.approx(2.0635e13,
                                                            rel=1e-4)
    c13 = json.loads((BENCH / "configs" / "cerebras-gpt-1.3b.json")
                     .read_text())
    assert mt.n_params(c13) == pytest.approx(1.42e9, rel=0.01)
    assert mt.step_flops(c13, 4, 2048) == pytest.approx(6.94e13, rel=0.01)
    # the harness's weight groups cover exactly the counted parameters
    n = sum(_numel(s) for g in group_specs(c13) for _, s, _ in g)
    assert n == mt.n_params(c13)


def _numel(shape):
    out = 1
    for s in shape:
        out *= s
    return out


def test_serve_step_counts_by_hand():
    ms = metric("mfu.serve")
    cfg = {"n_embd": 4, "n_inner": 16, "n_layer": 2, "vocab_size": 10}
    w = ms.widths(cfg)
    assert w["block_weights"] == 2 * (4 * 16 + 2 * 4 * 16)
    ops, nbytes = ms.decode_round([3, 5], w)
    mats = 384 + 40
    assert ops == 2 * mats * 2 + 4 * 4 * 2 * 8
    assert nbytes == 2 * mats + 4 * 4 * 2 * 8
    ops, nbytes = ms.prefill_span(2, 5, True, w)
    keys = 3 + 4 + 5
    assert ops == 2 * 384 * 3 + 4 * 4 * 2 * keys + 2 * 40
    assert nbytes == 2 * 384 + 4 * 4 * 2 * 5 + 2 * 40


def _view(trace, host=None, **kw):
    base = dict(config={"n_embd": 1024, "n_head": 16, "n_layer": 12,
                        "n_inner": 4096, "vocab_size": 32768,
                        "n_positions": 2048},
                cell={"engine": {"kv_block_size": 16}},
                traffic={"batch": 8, "seq_len": 2048},
                device_kind=H100, host=host or {}, trace=trace)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_against_a_synthetic_table():
    pk = PEAKS[H100]
    trace = TraceSummary(
        window_s=2.0, busy_s=1.5,
        ops={"void paged_decode_kernel<128, true>(Params)": [0.004, 120],
             "void paged_decode_combine_kernel<128>(Params)": [0.001, 120],
             "void flash_fwd_kernel_sm90<64>(...)": [0.010, 12],
             "void flash_dq_kernel_sm90<64>(...)": [0.012, 12],
             "void flash_dkv_kernel_sm90<64>(...)": [0.018, 12],
             "sm90_xmma_gemm_bf16": [1.0, 400]},
        steps={"train_steps": 1})
    host = {"traced_steps": [{"decode_rows": SERVE_LENGTHS,
                              "prefill_spans": []}] * 10,
            "window_s": 4.0, "train_steps": 2, "decode_steps": 100,
            "occupancy": [12, 16], "n_slots": 16}
    v = _view(trace, host)
    want = 10 * 12 * 16_270_400 / pk["hbm_bytes_per_s"] / 0.005 * 100
    assert metric("paged_decode_roofline.serve").read(v) == \
        pytest.approx(want)
    fr = metric("flash_roofline.train")
    flops = 12 * (fr.fwd_flops(8, 16, 2048, 64) + fr.dq_flops(8, 16, 2048, 64)
                  + fr.dkv_flops(8, 16, 2048, 64))
    assert fr.read(v) == pytest.approx(
        flops / pk["bf16_flop_per_s"] / 0.040 * 100)
    assert metric("idle_share.serve").read(v) == pytest.approx(25.0)
    assert metric("idle_share.train").read(v) == pytest.approx(25.0)
    assert metric("decode_step_ms.serve").read(v) == pytest.approx(40.0)
    assert metric("slot_occupancy.serve").read(v) == pytest.approx(87.5)
    mt = metric("mfu.train")
    assert mt.read(v) == pytest.approx(
        mt.step_flops(v.config, 8, 2048) / 2.0 / pk["bf16_flop_per_s"] * 100)


def test_readers_find_nothing_and_return_nothing():
    empty = TraceSummary(window_s=1.0, busy_s=0.0)
    for name in ("paged_decode_roofline.serve", "flash_roofline.train",
                 "mfu.serve", "idle_share.serve", "idle_share.train"):
        assert metric(name).read(_view(None)) is None
        assert metric(name).read(_view(empty, {"traced_steps": []})) is None
    # an unknown card: no peak, so no share of one
    t = TraceSummary(window_s=1.0, busy_s=0.5,
                     ops={"void paged_decode_kernel<>": [0.1, 1]})
    v = _view(t, {"traced_steps": [{"decode_rows": [5],
                                    "prefill_spans": []}]},
              device_kind="cpu")
    assert metric("paged_decode_roofline.serve").read(v) is None
    assert metric("mfu.serve").read(v) is None


class _Ev:
    def __init__(self, name, start, end, device):
        from torch.autograd import DeviceType

        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = False


def test_trace_reduction_busy_gaps_and_labels():
    ev = [_Ev("bench.traced", 100, 200, False),
          _Ev("bench.sched_step", 100, 150, False),
          _Ev("chainermn.decode", 110, 140, False),
          _Ev("bench.clients", 150, 200, False),
          _Ev("k1", 90, 120, True),       # clipped to the window: 20 us
          _Ev("k2", 115, 130, True),      # overlaps k1
          _Ev("k1", 160, 170, True)]
    t = reduce_events(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 10) * 1e-6)
    assert t.ops["k1"] == [pytest.approx(30e-6), 2]
    assert t.ops["k2"] == [pytest.approx(15e-6), 1]
    # the gap 130-160 opens inside chainermn.decode, 170-200 inside
    # bench.clients
    assert t.gaps["chainermn.decode"][0] == pytest.approx(30e-6)
    assert t.gaps["bench.clients"][0] == pytest.approx(30e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert len(b["idle_gaps"]) == 2


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keeps_the_contract():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    n_cells = 24
    assert ((2 + 14 * n_cells) * (man["run_seconds"] + 60)
            + 2 * 90 * n_cells + 1200) <= 43200
    names = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cf = json.loads((ROOT / c["file"]).read_text())
        assert cf["reduced"] == c["reduced"] and cf["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert m["bound"] <= 0.25 and m["bound"] >= 0.01
    cells = {w["name"]: w for w in man["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= 1
    for name, w in cells.items():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(name) and w["config"] in names
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        f = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        reported = [m for m in man["end_to_end"]
                    if "workloads" not in m or name in m["workloads"]]
        assert len(reported) >= 2
        assert any(name in m["workloads"] for m in man["per_layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in man["per_layer"]:
        mod = metric(m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert any(e["name"] == m["moves"] and w in e.get(
                "workloads", [w]) for e in man["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
