"""Import rules of the port: ``chainermn_torch``, ``chip_smoke.py``,
``kernel_ab.py``, ``kernel_variants.py``, ``smoke_ab.py`` and
``f32_order_check.py`` never import
jax, flax, optax or anything of ``chainermn_tpu``, and the port's entry
points do not carry on quietly on the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "chainermn_torch"
SCRIPTS = [(name, PKG.parent / f"{name}.py")
           for name in ("chip_smoke", "kernel_ab", "kernel_variants",
                        "smoke_ab", "f32_order_check")]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chainermn_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def test_the_parallel_modules_are_checked():
    names = {name for name, _ in _modules()}
    assert {"chainermn_torch.parallel.mesh", "chainermn_torch.parallel.tensor",
            "chainermn_torch.parallel.sequence",
            "chainermn_torch.communicators.mesh_communicator",
            "chainermn_torch.parallel.moe", "chainermn_torch.parallel.gspmd",
            "chainermn_torch.ops.pipeline", "chainermn_torch.ops.losses",
            "chainermn_torch.examples.lm.train_lm",
            "chainermn_torch.examples.lm.serve_lm",
            "chainermn_torch.serving.speculative",
            "chainermn_torch.serving.fairness",
            "chainermn_torch.serving._programs",
            "chainermn_torch.monitor.instrument",
            "chainermn_torch.monitor.costs", "chainermn_torch.monitor.http",
            "chainermn_torch.monitor.catalog",
            "chainermn_torch.monitor.annotations",
            "chainermn_torch.analysis", "chainermn_torch.analysis.sanitizer",
            "chainermn_torch.fleet", "chainermn_torch.fleet.routing",
            "chainermn_torch.fleet.replica", "chainermn_torch.fleet.router",
            "chainermn_torch.fleet.overload",
            "chainermn_torch.fleet.share", "chainermn_torch.fleet.control",
            "chainermn_torch.monitor.timeseries",
            "chainermn_torch.monitor.health", "chainermn_torch.monitor.slo",
            "chainermn_torch.deploy", "chainermn_torch.deploy.versions",
            "chainermn_torch.deploy.publish", "chainermn_torch.monitor.trace",
            "chainermn_torch.dataflow.dispatch",
            "chainermn_torch.resilience.trainer",
            "chainermn_torch.examples.parallel_convolution."
            "train_parallel_conv"} <= names


def test_importing_every_module_pulls_in_no_jax():
    names = [name for name, _ in _modules()]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PKG.parent))
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "name,path", list(_modules()) + SCRIPTS,
    ids=[n for n, _ in _modules()] + [n for n, _ in SCRIPTS])
def test_module_source_names_no_jax(name, path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (
            f"{name}:{node.lineno} imports {roots}")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from chainermn_torch import create_communicator
    from chainermn_torch.models import MLP, AlexNet, ResNet, TransformerLM
    from chainermn_torch.serving import ServingEngine

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=11, d_model=8, n_heads=2, n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=11, d_model=8, n_heads=2, n_layers=1,
                      attention="flash")
    for name in ("pure_nccl", "naive", "hierarchical", "two_dimensional"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_communicator(name)
    from chainermn_torch.dataflow import DevicePrefetcher
    from chainermn_torch.links import BatchNorm, MultiNodeBatchNormalization
    from chainermn_torch.models import VGG16, GoogLeNet

    for build in (lambda: ResNet([1], width=4), MLP, AlexNet,
                  lambda: BatchNorm(4),
                  lambda: MultiNodeBatchNormalization(4, None),
                  GoogLeNet, VGG16, lambda: DevicePrefetcher(iter([]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    model = TransformerLM(vocab_size=11, d_model=8, n_heads=2, n_layers=1,
                          max_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, n_slots=1, prefill_len=4)


# names of chainermn_tpu.__all__ the port does not have yet; each has its
# item in ROADMAP.md's Queue A
STILL_TO_PORT = ()


def test_facade_covers_the_jax_package():
    import chainermn_torch
    import chainermn_tpu

    missing = {n for n in chainermn_tpu.__all__
               if not hasattr(chainermn_torch, n)}
    assert missing == set(STILL_TO_PORT)
    roadmap = (PKG.parent / "ROADMAP.md").read_text()
    queue_a = roadmap.split("### Queue A")[1].split("### Queue B")[0]
    for name in STILL_TO_PORT:
        assert f"`{name}`" in queue_a, f"{name} has no item in Queue A"


# names of a subpackage's __all__ the port leaves out: on purpose (the
# JAX-only mechanisms of ROADMAP.md's standing constraints), or until
# the ROADMAP item named beside them lands
LEFT_OUT = {
    "extensions": {"parse_hlo_collectives", "collective_stats"},
    "utils": {"apply_env_platform", "axis_size", "pcast_varying"},
}
WAITING: dict = {}   # every subpackage facade is ported


def _kind(obj) -> str:
    import inspect
    import types

    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else "constant"


def _subpackages():
    import pkgutil

    import chainermn_tpu

    return sorted(m.name for m in pkgutil.iter_modules(chainermn_tpu.__path__)
                  if m.ispkg)


@pytest.mark.parametrize("sub", _subpackages())
def test_subpackage_facade_matches_the_reference(sub):
    """Every name of ``chainermn_tpu.<sub>.__all__`` is in the port's
    ``<sub>`` and of the same kind (function, class, module or constant),
    but for the names left out on purpose or waiting for their item."""
    import importlib

    ref = importlib.import_module(f"chainermn_tpu.{sub}")
    names = getattr(ref, "__all__", None)
    if names is None:       # native/: no facade names on either side
        return
    port = importlib.import_module(f"chainermn_torch.{sub}")
    skip = LEFT_OUT.get(sub, set()) | WAITING.get(sub, set())
    missing = {n for n in names if not hasattr(port, n)}
    assert missing == skip
    for n in set(names) - skip:
        assert _kind(getattr(port, n)) == _kind(getattr(ref, n)), n
    if sub in WAITING:
        roadmap = (PKG.parent / "ROADMAP.md").read_text()
        queue_a = roadmap.split("### Queue A")[1].split("### Queue B")[0]
        assert "13.3" in queue_a, "analysis/ has no item in Queue A"


def test_function_facades_shadow_their_submodules():
    """As in the reference, ``monitor.instrument`` and
    ``ops.flash_attention`` are functions; their modules stay importable
    by path."""
    import importlib
    import inspect

    from chainermn_torch import monitor, ops
    from chainermn_torch.monitor.instrument import RecompileGuard

    assert inspect.isfunction(monitor.instrument)
    assert inspect.isfunction(ops.flash_attention)
    assert RecompileGuard is monitor.RecompileGuard
    mod = importlib.import_module("chainermn_torch.ops.flash_attention")
    assert mod.flash_attention is ops.flash_attention
    mod = importlib.import_module("chainermn_torch.monitor.instrument")
    assert mod.instrument is monitor.instrument
