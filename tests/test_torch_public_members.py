"""Every public attribute of every class the JAX package exports from a
(sub)package's ``__all__`` exists on the port's class of the same name.

The facade test (``test_torch_imports.py``) matches names; this one
matches the members of each class, by ``dir()``, so a method the port
never grew (``ServingEngine.prefill``, ``EventLog.clear``,
``Gauge.inc``, ``CommunicatorBase.process_size``) fails here. What the
port leaves out on purpose is listed in ``LEFT_OUT`` with its reason.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect

import pytest

SUBPACKAGES = ("", "analysis", "communicators", "dataflow", "datasets",
               "deploy", "extensions", "fleet", "functions", "links",
               "models", "monitor", "native", "ops", "parallel",
               "resilience", "serving")

_SHARDING = ("JAX's sharding API (device mesh, partition specs, "
             "shard_map); the port's ranks are processes in a "
             "torch.distributed group")
_TRACED_RANK = ("the rank as a traced value inside shard_map; the port's "
                "rank is the eager comm.rank (MeshCommunicator keeps "
                "axis_index(name) for its named axes)")
_MESH = ("every reference communicator is a mesh over devices; the "
         "port's strategies are process groups, and comm.group is the "
         "counterpart of axis_name")

# member -> reason, for every class that has it
LEFT_OUT = {
    "shard_map": _SHARDING,
    "named_sharding": _SHARDING,
    "data_spec": _SHARDING,
    "check_vma": _SHARDING,
    "axis_index": _TRACED_RANK,
    "axis_name": _MESH,
    "mesh": _MESH,
    "tree_flatten": "JAX pytree registration; torch autograd needs none",
    "tree_unflatten": "JAX pytree registration; torch autograd needs none",
    "init": ("flax's parameter initialisation; a torch module makes its "
             "parameters in its constructor"),
    "draft_params": ("a flax parameter tree beside draft_model; the "
                     "port's draft model holds its own weights"),
    "rng": ("a JAX PRNG key; the port's requests carry an int seed for "
            "their own sampler generator"),
}
# Left out of every flax module class: the flax.linen.Module API
# (init/apply/bind/..., and the bound ``scope``) and the class's dataclass
# fields. The port's torch module takes the same arguments in its
# constructor and keeps the ones its forward reads.
FLAX_RUNTIME = {"scope"}


def _flax_members(cls) -> set:
    import flax.linen as nn

    if not (inspect.isclass(cls) and issubclass(cls, nn.Module)):
        return set()
    return (set(dir(nn.Module)) | FLAX_RUNTIME
            | {f.name for f in dataclasses.fields(cls)})


def _classes():
    out = []
    for sub in SUBPACKAGES:
        ref = importlib.import_module(
            "chainermn_tpu" + ("." + sub if sub else ""))
        for name in getattr(ref, "__all__", ()):
            if inspect.isclass(getattr(ref, name, None)):
                out.append((sub, name))
    return out


def _public(cls) -> set:
    return {a for a in dir(cls) if not a.startswith("_")}


@pytest.mark.parametrize("sub,name", _classes(),
                         ids=lambda v: v or "top")
def test_port_class_has_every_public_member(sub, name):
    ref_cls = getattr(importlib.import_module(
        "chainermn_tpu" + ("." + sub if sub else "")), name)
    port_mod = importlib.import_module(
        "chainermn_torch" + ("." + sub if sub else ""))
    port_cls = getattr(port_mod, name, None)
    assert inspect.isclass(port_cls), f"{sub}.{name} is not a class"
    missing = (_public(ref_cls) - _public(port_cls) - set(LEFT_OUT)
               - _flax_members(ref_cls))
    assert not missing, f"{sub or 'top'}.{name} lacks {sorted(missing)}"


def test_left_out_names_are_really_absent_somewhere():
    """Each LEFT_OUT entry is still needed: some reference class has the
    member and its port class does not."""
    needed = set()
    for sub, name in _classes():
        ref_cls = getattr(importlib.import_module(
            "chainermn_tpu" + ("." + sub if sub else "")), name)
        port_cls = getattr(importlib.import_module(
            "chainermn_torch" + ("." + sub if sub else "")), name)
        needed |= _public(ref_cls) - _public(port_cls)
    assert set(LEFT_OUT) <= needed, sorted(set(LEFT_OUT) - needed)
    assert all(LEFT_OUT.values())
