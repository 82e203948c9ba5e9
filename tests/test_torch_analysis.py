"""graftlint on the port (``chainermn_torch.analysis``): the twins of the
reference's ``tests/analysis_tests/`` (all but ``test_sanitizer.py``,
whose cases live in ``test_torch_fleet_policy.py``).

- **Shared fixtures.** For the rules whose meaning the port keeps
  (framework, locks, threads, blocking on non-device calls, names and
  consistency, imports), every fixture test of the reference runs as it
  is, with its ``analyze_source`` routed through a recorder that also
  runs the port's checker of the same name on the same source (package
  names renamed; ``jax`` renamed to ``torch`` for the import rule). The
  reference test's own assertions hold, and both packages' findings must
  be equal as ``(rule, line, symbol, severity)``.
- **Retargeted rules.** ``host-sync``, ``recompile-hazard`` and the
  device half of ``blocking-under-lock`` look for the port's idioms; the
  reference's cases are translated to torch, each positive case with a
  negative twin, and the escape tokens checked.
- **The tree.** graftlint over ``chainermn_torch/``: 0 errors, 0
  warnings, no parse errors, checked per module; the built-in hot and
  capture sets resolve to functions of the port.
- **The CLI** (the twin of ``test_lint_script.py``): exit codes,
  ``--json``, the baseline round trip and ``--runtime-report`` on a port
  sanitizer artifact.
"""

from __future__ import annotations

import ast
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

import pytest

import chainermn_torch.analysis.checkers as port_checkers
from chainermn_torch.analysis import analyze_source, run_analysis
from chainermn_torch.analysis.checkers import all_checkers
from chainermn_torch.analysis.checkers.blocking import (
    BlockingUnderLockChecker,
)
from chainermn_torch.analysis.checkers.hotpath import (
    HOT_FUNCTIONS,
    HostSyncChecker,
)
from chainermn_torch.analysis.checkers.recompile import (
    CAPTURE_FUNCTIONS,
    RecompileChecker,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "chainermn_torch")
REF_TESTS = os.path.join(REPO, "tests", "analysis_tests")

# -------------------------------------------------------------------- #
# the reference's fixture tests, run through both packages              #
# -------------------------------------------------------------------- #

# reference test files whose fixtures keep their meaning in the port;
# tests left out use run_analysis / the CLI (twinned below) or device
# fetches (translated below)
SHARED = {
    "test_framework.py": {"test_baseline_waives", "test_parse_errors_always_gate",
                          "test_cli_json_and_exit_codes",
                          "test_cli_write_baseline_then_clean"},
    "test_lock_checker.py": set(),
    "test_thread_checker.py": set(),
    "test_blocking_checker.py": {"test_device_fetch_under_lock_fires"},
    "test_consistency_checker.py": set(),
    "test_import_checker.py": set(),
}


def _load_ref(fname):
    spec = importlib.util.spec_from_file_location(
        f"_ref_analysis_{fname[:-3]}", os.path.join(REF_TESTS, fname))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shared_cases():
    out = []
    for fname, skip in sorted(SHARED.items()):
        src = open(os.path.join(REF_TESTS, fname)).read()
        for node in ast.parse(src).body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test_") \
                    and node.name not in skip:
                out.append((fname, node.name))
    return out


def _to_port(text: str, imports: bool) -> str:
    text = text.replace("chainermn_tpu", "chainermn_torch")
    return re.sub(r"\bjax\b", "torch", text) if imports else text


def _key(findings, imports=False):
    return sorted((f.rule, f.line, _to_port(f.symbol, imports), f.severity)
                  for f in findings)


@pytest.mark.parametrize("fname,test", _shared_cases())
def test_reference_fixture_gives_equal_findings(fname, test, tmp_path):
    mod = _load_ref(fname)
    imports = fname == "test_import_checker.py"
    ref_analyze = mod.analyze_source
    pairs = []

    def recording(src, checker, **kw):
        want = ref_analyze(src, checker, **kw)
        port_checker = getattr(port_checkers, type(checker).__name__)()
        pkw = dict(kw)
        for k in ("path", "modname"):
            if k in pkw:
                pkw[k] = _to_port(pkw[k], imports)
        if pkw.get("extra_modules"):
            pkw["extra_modules"] = {
                _to_port(k, imports): _to_port(v, imports)
                for k, v in pkw["extra_modules"].items()}
        got = analyze_source(_to_port(src, imports), port_checker, **pkw)
        pairs.append((want, got))
        return want

    mod.analyze_source = recording
    fn = getattr(mod, test)
    params = inspect.signature(fn).parameters
    fn(**({"tmp_path": tmp_path} if "tmp_path" in params else {}))
    assert pairs, f"{test} ran no fixture"
    for want, got in pairs:
        assert _key(got) == _key(want, imports)


# -------------------------------------------------------------------- #
# blocking-under-lock: the port's device syncs                          #
# -------------------------------------------------------------------- #

_BLOCKING = """\
import threading, torch

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._out = None
        self._ev = None

    def fetch(self):
        with self._lock:
            return {call}

    def fetch_outside(self):
        with self._lock:
            out = self._out
        return {call_outside}
"""

DEVICE_SYNCS = {
    "torch.cuda.synchronize()": "torch.cuda.synchronize",
    "self._out.item()": ".item",
    "self._out.cpu()": ".cpu",
    "self._out.tolist()": ".tolist",
    "self._out.numpy()": ".numpy",
    "self._ev.synchronize()": ".synchronize",
}


@pytest.mark.parametrize("call", sorted(DEVICE_SYNCS))
def test_device_sync_under_lock_fires_and_outside_is_clean(call):
    src = _BLOCKING.format(call=call,
                           call_outside=call.replace("self._out", "out"))
    findings = analyze_source(src, BlockingUnderLockChecker())
    assert [f.symbol for f in findings] == [f"C.fetch:{DEVICE_SYNCS[call]}"]
    escaped = src.replace(f"return {call}\n",
                          f"return {call}  # graftlint: blocking-ok\n")
    assert analyze_source(escaped, BlockingUnderLockChecker()) == []


def test_jax_fetches_are_not_the_ports_syncs():
    """The reference's ``jax.device_get`` is not a port idiom; the port's
    rule flags its own syncs instead."""
    src = _BLOCKING.format(call="jax.device_get(self._out)",
                           call_outside="out")
    assert analyze_source(src, BlockingUnderLockChecker()) == []


# -------------------------------------------------------------------- #
# host-sync, retargeted                                                 #
# -------------------------------------------------------------------- #


def _hot(src, **kw):
    return analyze_source(src, HostSyncChecker(), **kw)


HOT_COERCION = """\
import numpy as np

class Engine:
    def step(self):  # graftlint: hot
        out = self._decode_round(1)
        host = np.asarray(out)
        return host
"""


def test_coercion_on_step_program_result_fires():
    assert [f.symbol for f in _hot(HOT_COERCION)] == \
        ["Engine.step:np.asarray"]


def test_device_fetch_is_sanctioned():
    src = HOT_COERCION.replace("np.asarray(out)", "device_fetch(out)")
    assert _hot(src) == []


def test_device_fetch_untaints():
    assert _hot(HOT_COERCION.replace(
        "        host =", "        out = device_fetch(out)\n        host =")
    ) == []


@pytest.mark.parametrize("producer", [
    "self._programs['decode'].run(tokens=t)",
    "self._programs.run(t)",
    "self._spec_verify(t, v)",
    "self.model(t)",
    "self._model(t)",
    "self._decode_fn(t)",
    "self._prefill_fns[8](t)",
])
@pytest.mark.parametrize("sync", [".item()", ".cpu()", ".tolist()",
                                  ".numpy()"])
def test_sync_method_on_device_result_fires(producer, sync):
    src = f"""\
class Engine:
    def step(self, t, v):  # graftlint: hot
        out = {producer}
        return out{sync}
"""
    assert [f.symbol for f in _hot(src)] == [f"Engine.step:{sync[:-2]}"]
    # the same call on a host value is clean
    host = src.replace(f"out = {producer}", "out = self.queue.pop()")
    assert _hot(host) == []


@pytest.mark.parametrize("call,symbol", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("self._stream.synchronize()", ".synchronize"),
    ("done.synchronize()", ".synchronize"),
])
def test_always_sync_fires_without_taint(call, symbol):
    src = f"""\
import torch

class Engine:
    def step(self, done):  # graftlint: hot
        {call}
"""
    assert [f.symbol for f in _hot(src)] == [f"Engine.step:{symbol}"]
    cold = src.replace("  # graftlint: hot", "")
    assert _hot(cold) == []


def test_coercion_on_host_value_is_clean():
    assert _hot("""\
import numpy as np

class Engine:
    def step(self):  # graftlint: hot
        rows = self.queue.pop()
        return np.asarray(rows)
""") == []


def test_cold_function_never_flagged():
    assert _hot(HOT_COERCION.replace("  # graftlint: hot", "")) == []


@pytest.mark.parametrize("path,qual", HOT_FUNCTIONS)
def test_builtin_hot_set_by_path_and_qualname(path, qual):
    cls, _, fn = qual.rpartition(".")
    body = f"""\
    def {fn}(self):
        nxt = self._programs["x"].run()
        return nxt.item()
"""
    src = (f"class {cls}:\n{body}" if cls
           else "\n".join(line[4:] for line in body.splitlines()) + "\n")
    got = _hot(src, path=f"chainermn_torch/{path}",
               modname="chainermn_torch." + path[:-3].replace("/", "."))
    assert [f.symbol for f in got] == [f"{qual}:.item"]
    # same source under another path is not in the built-in hot set
    assert _hot(src) == []


def test_hot_sync_ok_escape():
    src = HOT_COERCION.replace(
        "host = np.asarray(out)",
        "host = np.asarray(out)  # graftlint: hot-sync-ok")
    assert _hot(src) == []


# -------------------------------------------------------------------- #
# recompile-hazard, retargeted                                          #
# -------------------------------------------------------------------- #


def _rc(src, **kw):
    return analyze_source(src, RecompileChecker(), **kw)


def test_compile_in_loop_fires_and_setup_is_clean():
    assert [f.symbol for f in _rc("""\
import torch

def run(fns, xs):
    for f in fns:
        step = torch.compile(f)
        step(xs)
""")] == ["run:compile-in-loop"]
    assert _rc("""\
import torch

def build(f):
    return torch.compile(f, mode="reduce-overhead")
""") == []


def test_compile_then_call_fires_and_escape():
    src = """\
import torch

def init(f, x):
    return torch.compile(f)(x)
"""
    assert [f.symbol for f in _rc(src)] == ["init:compile-then-call"]
    assert _rc(src.replace("    return", "    # graftlint: recompile-ok\n"
                                         "    return")) == []


def test_compile_in_hot_body_fires_and_cold_is_clean():
    src = """\
import torch

class Engine:
    def step(self, f, x):  # graftlint: hot
        g = torch.jit.script(f)
        return g(x)
"""
    assert [f.symbol for f in _rc(src)] == ["Engine.step:compile-in-hot"]
    assert _rc(src.replace("  # graftlint: hot", "")) == []


@pytest.mark.parametrize("sync", ["torch.cuda.synchronize()",
                                  "out.item()", "out.cpu()",
                                  "out.tolist()", "out.numpy()",
                                  "stream.synchronize()"])
def test_sync_inside_graph_capture_fires(sync):
    src = f"""\
import torch

def capture(body, ins, stream):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = body(ins)
        {sync}
    {sync}
    return g, out
"""
    findings = _rc(src)
    assert len(findings) == 1 and findings[0].line == 7
    what = sync.split("(")[0]
    assert findings[0].symbol == "capture:capture-sync:" + (
        what if what.startswith("torch.") else "." + what.split(".")[-1])
    escaped = src.replace(f"        {sync}\n",
                          f"        {sync}  # graftlint: recompile-ok\n")
    assert _rc(escaped) == []


_BRANCH = "StepProgram._capture_locked:capture-branch"


@pytest.mark.parametrize("test,expected", [
    ("mask.any()", [_BRANCH]),
    ("bool(x.sum())", [_BRANCH]),
    ("torch.equal(a, b)", [_BRANCH]),
    # a host read in the test is a sync as well as a branch
    ("x.item() > 0", [_BRANCH, "StepProgram._capture_locked:"
                                "capture-sync:.item"]),
    ("self.warm", []),
    ("n > 0", [])])
def test_tensor_branch_inside_capture_body_fires(test, expected):
    src = f"""\
class StepProgram:
    def _capture_locked(self, mask, x, a, b, n):
        if {test}:
            return self._body(x)
        return self._body(a)
"""
    got = _rc(src, path="chainermn_torch/serving/_programs.py",
              modname="chainermn_torch.serving._programs")
    assert sorted(f.symbol for f in got) == sorted(expected)
    # the same body is no capture body elsewhere, unless marked
    assert _rc(src) == []
    marked = src.replace("b, n):", "b, n):  # graftlint: capture")
    assert len(_rc(marked)) == len(expected)


def test_capture_functions_exist_in_the_port():
    project_src = {
        path: open(os.path.join(PKG_DIR, path)).read()
        for path, _ in CAPTURE_FUNCTIONS}
    for path, qual in CAPTURE_FUNCTIONS:
        cls, fn = qual.split(".")
        tree = ast.parse(project_src[path])
        classes = {n.name: n for n in tree.body
                   if isinstance(n, ast.ClassDef)}
        assert fn in {m.name for m in classes[cls].body
                      if isinstance(m, ast.FunctionDef)}, qual


# -------------------------------------------------------------------- #
# consistency: the port's own pins                                      #
# -------------------------------------------------------------------- #


def _tree_with(tmp_path, tests: dict, readme: str):
    pkg = tmp_path / "chainermn_torch"
    (pkg / "resilience").mkdir(parents=True)
    (pkg / "monitor").mkdir()
    for d in (pkg, pkg / "resilience", pkg / "monitor"):
        (d / "__init__.py").write_text("")
    (pkg / "resilience" / "cutpoints.py").write_text('FOO_BAR = "foo.bar"\n')
    (pkg / "monitor" / "catalog.py").write_text(
        'METRIC_NAMES = frozenset({"widget_total"})\n'
        'EVENT_KINDS = frozenset({\n'
        '    "widget_fired",\n'
        '    # graftlint: name-ok — kept for parity, never emitted\n'
        '    "widget_parked",\n'
        '})\n')
    (pkg / "work.py").write_text(
        "from chainermn_torch.resilience.cutpoints import FOO_BAR\n\n"
        "def work(reg, events):\n"
        "    inject(FOO_BAR)\n"
        '    reg.counter("widget_total", {}).inc()\n'
        '    events.emit("widget_fired")\n')
    (tmp_path / "tests").mkdir()
    for name, text in tests.items():
        (tmp_path / "tests" / name).write_text(text)
    (tmp_path / "README.md").write_text(readme)
    from chainermn_torch.analysis.checkers.names import ConsistencyChecker
    return run_analysis([str(pkg)], [ConsistencyChecker()])


PINS = "P = ('foo.bar', 'widget_total', 'widget_fired', 'widget_parked')\n"
PORT_README = ("# x\n\n## Reference\n\n`foo.bar`\n\n"
               "## PyTorch port (`chainermn_torch`)\n\n`foo.bar`\n\n"
               "## Layout\n")


def test_port_pins_come_from_port_tests_and_the_port_readme(tmp_path):
    clean = _tree_with(tmp_path, {"test_torch_pins.py": PINS}, PORT_README)
    assert clean.findings == []
    # the parity-only catalog entry is waived on its own line
    assert [f.symbol for f in clean.suppressed] == ["event:widget_parked"]


def test_reference_pins_do_not_count_for_the_port(tmp_path):
    found = _tree_with(
        tmp_path, {"test_pins.py": PINS, "test_torch_other.py": "x = 1\n"},
        PORT_README.replace("`foo.bar`\n\n## Layout", "\n## Layout"))
    messages = sorted(f.message for f in found.findings)
    assert any("not referenced by any port test" in m for m in messages)
    assert any("README's port section" in m for m in messages)
    assert {f.severity for f in found.findings
            if f.symbol == "metric:widget_total"} == {"warning"}


# -------------------------------------------------------------------- #
# the port's tree is clean                                              #
# -------------------------------------------------------------------- #


def _tree_modules():
    out = []
    for dirpath, dirnames, files in os.walk(PKG_DIR):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += sorted(os.path.relpath(os.path.join(dirpath, f), REPO)
                      for f in files if f.endswith(".py"))
    return out


@pytest.fixture(scope="module")
def tree_result():
    return run_analysis([PKG_DIR], all_checkers())


@pytest.mark.parametrize("path", _tree_modules())
def test_module_is_lint_clean(tree_result, path):
    mine = [f.render() for f in tree_result.findings if f.path == path]
    assert mine == []


def test_tree_has_no_errors_warnings_or_parse_errors(tree_result):
    counts = tree_result.to_json()["counts"]
    assert (counts["errors"], counts["warnings"],
            counts["parse_errors"]) == (0, 0, 0), counts
    assert counts["suppressed"] > 0     # the escapes are read


def test_hot_set_resolves_to_port_functions(tree_result):
    from chainermn_torch.analysis.checkers.hotpath import _is_hot
    from chainermn_torch.analysis.core import load_project
    from chainermn_torch.analysis import astutil

    project, _ = load_project([PKG_DIR])
    found = set()
    for m in project.modules:
        for n in ast.walk(m.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _is_hot(m, n):
                found.add(astutil.func_qualname(n))
    assert {q for _, q in HOT_FUNCTIONS} <= found


# -------------------------------------------------------------------- #
# the CLI                                                               #
# -------------------------------------------------------------------- #

RACY = """\
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def add(self, x):
        with self._lock:
            self._items.append(x)

    def peek(self):
        return self._items[-1]
"""


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "chainermn_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_json_exit_codes_and_rules(tmp_path):
    target = tmp_path / "box.py"
    target.write_text(RACY)
    proc = _cli("--json", "--rules", "lock-discipline", str(target))
    assert proc.returncode == 1
    payload = json.loads(proc.stdout)
    assert payload["counts"]["errors"] == 1
    assert payload["findings"][0]["rule"] == "lock-discipline"
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert _cli("--json", "--rules", "lock-discipline",
                str(clean)).returncode == 0
    assert _cli("--rules", "no-such-rule", str(clean)).returncode == 2
    listed = _cli("--list-rules", str(clean))
    assert listed.returncode == 0
    assert [line.split()[0] for line in listed.stdout.splitlines()] == \
        [c.rule for c in all_checkers()]
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert _cli(str(broken)).returncode == 1


def test_cli_baseline_round_trip(tmp_path):
    target = tmp_path / "box.py"
    target.write_text(RACY)
    base = tmp_path / "baseline.json"
    proc = _cli("--rules", "lock-discipline", "--write-baseline", str(base),
                str(target))
    assert proc.returncode == 1   # recording does not waive this run
    assert json.loads(base.read_text())["fingerprints"]
    proc = _cli("--rules", "lock-discipline", "--baseline", str(base),
                str(target))
    assert proc.returncode == 0
    assert "1 baselined" in proc.stdout


def test_cli_over_the_port_tree_is_clean():
    proc = _cli("chainermn_torch/")
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "0 error(s), 0 warning(s)" in proc.stdout


def test_cli_runtime_report_on_a_port_sanitizer_artifact(tmp_path):
    """Observed ⊆ static passes; an edge the static graph lacks fails."""
    from chainermn_torch.analysis.checkers.locks import static_lock_graph
    from chainermn_torch.analysis.core import load_project

    project, _ = load_project([PKG_DIR])
    static = sorted(static_lock_graph(project))
    assert static, "the port's static lock graph has no edge"
    a, b = static[0]
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"version": 1,
                                "edges": [[f"{a}._lock",
                                           f"{b}._lock"]],
                                "leaf_edges": []}))
    proc = _cli("--runtime-report", str(good), "chainermn_torch/")
    assert proc.returncode == 0, proc.stdout
    assert "observed ⊆ static" in proc.stdout
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1,
                               "edges": [[f"{b}._lock",
                                          "NoSuchClass._lock"]],
                               "leaf_edges": []}))
    proc = _cli("--runtime-report", str(bad), "chainermn_torch/")
    assert proc.returncode == 1
    assert "OBSERVED-ONLY" in proc.stdout


def test_runtime_report_on_an_observed_sanitizer_run(tmp_path):
    """Locks built through the port's sanitizer, nested as a router
    nests its replica's scheduler: the dumped artifact's edge is in a
    static graph that has it and fails one that lacks it."""
    from chainermn_torch.analysis import sanitizer
    from chainermn_torch.analysis.__main__ import _runtime_report

    src = tmp_path / "pkg"
    src.mkdir()
    (src / "__init__.py").write_text("")
    (src / "mod.py").write_text("""\
from chainermn_torch.analysis import sanitizer


class Inner:
    def __init__(self):
        self._lock = sanitizer.make_lock("Inner")

    def poke(self):
        with self._lock:
            return 1


class Outer:
    def __init__(self):
        self._lock = sanitizer.make_lock("Outer")
        self.inner = Inner()

    def run(self):
        with self._lock:
            return self.inner.poke()
""")
    sys.path.insert(0, str(tmp_path))
    try:
        import pkg.mod as mod

        sanitizer.reset()
        sanitizer.enable()
        try:
            mod.Outer().run()
            art = sanitizer.dump_artifact(str(tmp_path / "art.json"))
        finally:
            sanitizer.disable()
            sanitizer.reset()
    finally:
        sys.path.remove(str(tmp_path))
        for name in ("pkg.mod", "pkg"):
            sys.modules.pop(name, None)
    assert _runtime_report(art, [str(src)]) == 0
    (src / "mod.py").write_text((src / "mod.py").read_text().replace(
        "return self.inner.poke()", "pass\n        return self.inner.poke()"
    ).replace("        with self._lock:\n            pass\n", ""))
    assert _runtime_report(art, [str(src)]) == 1


def test_fleet_under_the_sanitizer_stays_inside_the_static_graph(tmp_path):
    """What chip_smoke.py's serve_fleet does on the card, at toy size on
    the CPU: a 1P+1D fleet run with the sanitizer on and the static lock
    graph of the port's tree given raises no violation, and the observed
    edges pass ``--runtime-report``."""
    import numpy as np
    import torch

    from chainermn_torch.analysis import sanitizer
    from chainermn_torch.analysis.__main__ import _runtime_report
    from chainermn_torch.analysis.checkers.locks import static_lock_graph
    from chainermn_torch.analysis.core import load_project
    from chainermn_torch.fleet import FleetRouter
    from chainermn_torch.models import TransformerLM
    from chainermn_torch.serving import ServingEngine

    project, _ = load_project([PKG_DIR])
    sanitizer.reset()
    sanitizer.enable(static_graph=static_lock_graph(project))
    try:
        engines = [ServingEngine(
            TransformerLM(17, d_model=16, n_heads=4, n_layers=2, max_len=48,
                          compute_dtype=torch.float32, seed=0,
                          device="cpu"),
            n_slots=2, prefill_buckets=(4, 8, 16), kv_block_size=2,
            cache_len=48, device="cpu") for _ in range(2)]
        with FleetRouter(engines, prefill_replicas=1,
                         decode_replicas=1) as router:
            router.wait_ready(60)
            outs = [router.generate(np.arange(1, 9) + i, 4, timeout=60)
                    for i in range(3)]
        observed = sanitizer.observed_class_edges(leaf=True)
        violations = sanitizer.violations()
        art = sanitizer.dump_artifact(str(tmp_path / "fleet.json"))
    finally:
        sanitizer.disable()
        sanitizer.reset()
    assert all(len(o) >= 4 for o in outs)
    assert violations == []
    assert observed, "no lock order was observed"
    assert _runtime_report(art, [PKG_DIR]) == 0
