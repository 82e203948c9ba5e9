"""The port's tracer (``chainermn_torch/monitor/trace.py``) against the JAX
package's: the cases of ``tests/monitor_tests/test_trace.py``, each driven
with the same operations on a ``chainermn_tpu`` tracer and on the port's,
and the results compared exactly: span names, ids, parents, labels and
error flags, sampling decisions, the ring's contents and drop counts,
``breakdown`` and the Chrome events (spans on fixed timestamps, pid and
tid normalised)."""

import json
import threading

import pytest
from _torch_isolation import fresh_telemetry

from chainermn_torch.monitor import trace as torch_trace
from chainermn_tpu.monitor import trace as jax_trace

PACKAGES = {"jax": jax_trace, "torch": torch_trace}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _spans(t) -> list:
    return [(s.name, s.span_id, s.parent_id, dict(s.labels))
            for s in t.spans]


def _flags(t) -> tuple:
    return (t.error, t.deadline_miss, t.forced, t.dropped_spans,
            t.kind, t.seq, t.finished)


def _fix_times(t, t0=10.0, t1=12.0) -> None:
    """Fixed root times, so every duration of ``t`` is deterministic."""
    t.root.t0, t.root.t1 = t0, t1


def _norm_id(x, trace_ids: dict):
    return trace_ids.setdefault(x, f"trace{len(trace_ids)}")


def _norm_events(events) -> list:
    """Chrome events with the pid dropped and trace ids and tids
    renumbered in order of appearance."""
    ids, tids, out = {}, {}, []
    for e in events:
        e = json.loads(json.dumps(e))
        e.pop("pid")
        e["tid"] = tids.setdefault(e["tid"], len(tids))
        if "trace_id" in e["args"]:
            e["args"]["trace_id"] = _norm_id(e["args"]["trace_id"], ids)
        if e["ph"] == "M":
            kind, tid = e["args"]["name"].split(" ")
            e["args"]["name"] = f"{kind} {_norm_id(tid, ids)}"
        out.append(e)
    return out


# --------------------------------------------------------------------- #
# the cases                                                              #
# --------------------------------------------------------------------- #

def case_span_tree(m):
    tr = m.Tracer(sample=1, ring=8)
    t = tr.trace("request", kind="serving", req=7)
    with t.span("queue"):
        pass
    with t.span("prefill", bucket=16) as p:
        p.label(batch=2)
    t.add_span("decode_step", 1.0, 1.25, token=0)
    t.finish(reason="eos")
    [kept] = tr.finished()
    assert {s.trace_id for s in kept.spans} == {kept.trace_id}
    return {"spans": _spans(kept), "flags": _flags(kept),
            "decode_s": kept.spans[3].duration_s}


def case_sampling(m):
    tr = m.Tracer(sample=4, ring=64)
    for i in range(8):
        tr.trace("request", i=i).finish()
    kept = [t.root.labels["i"] for t in tr.finished()]
    for flag in ("error", "deadline", "forced"):
        t = tr.trace("request", flag=flag)
        if flag == "error":
            t.mark_error("Boom")
        elif flag == "deadline":
            t.mark_deadline_miss()
        else:
            t.force()
        t.finish()
    return {"kept": kept,
            "flags": [(t.root.labels.get("flag"), _flags(t))
                      for t in tr.finished()],
            "stats": tr.stats()}


def case_sample_zero(m):
    tr = m.Tracer(sample=0)
    t = tr.trace("request")
    assert t is m.NULL_TRACE
    with t.span("anything"):
        t.add_span("x", 0.0, 1.0)
    t.mark_error("e")
    t.finish()
    return {"enabled": t.enabled, "finished": tr.finished(),
            "breakdown": t.breakdown(), "start": t.start_span("x"),
            "trace_id": t.trace_id, "stats": tr.stats(),
            "tracer_enabled": tr.enabled}


def case_ring_bounded(m):
    tr = m.Tracer(sample=1, ring=4)
    for i in range(10):
        tr.trace("t", i=i).finish()
    out = {"kept": [t.root.labels["i"] for t in tr.finished()]}
    tr.configure(ring=2)              # a smaller ring keeps the newest
    out["after_configure"] = [t.root.labels["i"] for t in tr.finished()]
    tr.clear()
    out["after_clear"] = tr.finished()
    return out


def case_max_spans(m):
    tr = m.Tracer(sample=1, ring=4, max_spans=3)
    t = tr.trace("request")
    for i in range(5):
        t.add_span("decode_step", 0.0, 0.1, token=i)
    t.finish()
    t.add_span("late", 0.0, 0.1)      # after finish: dropped too
    return {"spans": _spans(t), "flags": _flags(t)}


def case_cross_thread(m):
    tr = m.Tracer(sample=1, ring=4)
    t = tr.trace("request")

    def worker():
        with t.span("prefill", where="worker"):
            pass
        # the worker thread has no ambient context of its own
        with tr.span("orphan"):
            pass

    th = threading.Thread(target=worker)
    th.start()
    th.join()
    t.finish()
    return {"spans": _spans(t), "flags": _flags(t)}


def case_ambient_nesting(m):
    tr = m.Tracer(sample=1, ring=4)
    with tr.trace("train_step", kind="train", step=3) as t:
        assert tr.current() is t
        with tr.span("dispatch"):
            with tr.span("inner", k=1):
                pass
    [kept] = tr.finished()
    current = tr.current()
    with tr.span("orphan"):
        pass
    return {"spans": _spans(kept), "flags": _flags(kept),
            "current_after": current, "n_finished": len(tr.finished())}


def case_module_helper(m):
    with m.span("anything", k=1):
        pass
    tr = m.get_tracer()
    with tr.trace("train_step", kind="train", step=0):
        with m.span("loss_fetch", n=8):
            pass
    return {"spans": [_spans(t) for t in tr.finished()],
            "stats": tr.stats()}


def case_ambient_exception(m):
    tr = m.Tracer(sample=100, ring=4)
    tr.trace("warmup").finish()
    with pytest.raises(ValueError):
        with tr.trace("train_step", step=1):
            with tr.span("dispatch"):
                raise ValueError("boom")
    [t] = [x for x in tr.finished() if x.root.name == "train_step"]
    tr.mark_current_error("recompile:x")   # no ambient trace: a no-op
    return {"spans": _spans(t), "flags": _flags(t),
            "stats": tr.stats()}


def case_chrome_events(m):
    tr = m.Tracer(sample=1, ring=8)
    for req in range(2):
        t = tr.trace("request", kind="serving", req=req)
        t.add_span("queue", 10.0, 10.5)
        t.add_span("prefill", 10.5, 10.75, bucket=16)
        open_span = t.start_span("never_closed")
        t.end_span(open_span, note="closed")
        open_span.t0, open_span.t1 = 10.75, 11.0
        t.finish(reason="length")
        _fix_times(t, 10.0 + req, 11.5 + req)
    return _norm_events(tr.chrome_events())


def case_export_file(m, path):
    tr = m.Tracer(sample=1, ring=8)
    t = tr.trace("request", when="now")
    t.add_span("queue", 1.0, 2.0)
    t.finish()
    _fix_times(t, 1.0, 3.0)
    out = tr.export_chrome(str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk == json.loads(json.dumps(out))
    return {"keys": sorted(on_disk), "unit": on_disk["displayTimeUnit"],
            "events": _norm_events(on_disk["traceEvents"])}


def case_breakdown(m):
    tr = m.Tracer(sample=1, ring=8)
    t = tr.trace("request")
    t.add_span("queue", 0.0, 0.5)
    t.add_span("prefill", 0.5, 0.8)
    t.add_span("decode_step", 0.8, 0.9)
    t.add_span("decode_step", 0.9, 1.0)
    t.mark_deadline_miss()
    t.mark_error("Late")
    t.finish()
    _fix_times(t, 0.0, 1.25)
    bd = t.breakdown()
    bd["trace_id"] = None
    json.dumps(bd)
    return bd


def case_default_tracer(m):
    tr = m.get_tracer()
    assert tr is m.get_tracer()
    return {"enabled": tr.enabled, "stats": tr.stats(),
            "sample": tr.sample, "max_spans": tr.max_spans}


CASES = {
    "span_tree": case_span_tree,
    "sampling": case_sampling,
    "sample_zero": case_sample_zero,
    "ring_bounded": case_ring_bounded,
    "max_spans": case_max_spans,
    "cross_thread": case_cross_thread,
    "ambient_nesting": case_ambient_nesting,
    "module_helper": case_module_helper,
    "ambient_exception": case_ambient_exception,
    "chrome_events": case_chrome_events,
    "breakdown": case_breakdown,
    "default_tracer": case_default_tracer,
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_the_reference(name):
    got, want = CASES[name](torch_trace), CASES[name](jax_trace)
    assert got == want


def test_export_file_matches_the_reference(tmp_path):
    got = case_export_file(torch_trace, tmp_path / "torch.json")
    want = case_export_file(jax_trace, tmp_path / "jax.json")
    assert got == want


def test_spot_values():
    """A few of the reference test's own assertions, on the port alone."""
    span_tree = case_span_tree(torch_trace)
    assert [s[0] for s in span_tree["spans"]] == [
        "request", "queue", "prefill", "decode_step"]
    assert span_tree["spans"][2][3] == {"bucket": 16, "batch": 2}
    assert span_tree["decode_s"] == pytest.approx(0.25)
    assert case_sampling(torch_trace)["kept"] == [0, 4]
    assert case_max_spans(torch_trace)["flags"][3] == 4
    bd = case_breakdown(torch_trace)
    assert bd["phases_s"] == {"queue": 0.5, "prefill": 0.3,
                              "decode_step": 0.2}
    assert bd["untracked_s"] == 0.25 and bd["deadline_miss"]
