"""Import hygiene of the port, checked in a fresh subprocess (the twin of
``tests/monitor_tests/test_import_hygiene.py``).

- ``chainermn_torch.monitor``, ``.fleet`` and ``.deploy`` import no
  ``chainermn_torch.extensions`` module at module level (the
  extensions <-> monitor cycle);
- ``.fleet`` and ``.deploy`` import neither ``torch`` nor
  ``chainermn_torch.serving`` at module level (the reference's rule
  forbids ``jax`` there; ``torch`` is its counterpart): the router and
  the policy layer stay host logic until an engine is driven;
- ``.analysis`` imports nothing outside itself: no ``torch``, no
  ``numpy``, no other ``chainermn_torch`` package — the analyzer never
  imports the code it analyzes.

The subprocess stubs the ``chainermn_torch`` parent package, so the
top-level facade (which imports everything by design) never runs, and
imports every module of the package under test, globbed from its
directory so that modules added later are covered too. The static
``import-hygiene`` rule of ``chainermn_torch.analysis`` proves the same
property without running anything.
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, "chainermn_torch")

_SCRIPT = r"""
import glob
import importlib
import os
import sys
import types

pkg_dir, pkg_name = sys.argv[1], sys.argv[2]
required = set(sys.argv[3].split(","))
forbidden = tuple(sys.argv[4].split(","))
allowed = tuple(a for a in sys.argv[5].split(",") if a)

stub = types.ModuleType("chainermn_torch")
stub.__path__ = [os.path.dirname(pkg_dir)]
sys.modules["chainermn_torch"] = stub

modules = []
for sub in ("", "checkers"):
    for p in sorted(glob.glob(os.path.join(pkg_dir, sub, "*.py"))):
        name = os.path.splitext(os.path.basename(p))[0]
        prefix = pkg_name + (f".{sub}" if sub else "")
        modules.append(prefix if name == "__init__" else f"{prefix}.{name}")
missing = required - {m.rsplit(".", 1)[-1] for m in modules}
assert not missing, f"glob missed {missing}: {modules}"


def bad(m):
    if m == "chainermn_torch":               # the stub itself
        return False
    if any(m == a or m.startswith(a + ".") for a in allowed):
        return False
    return any(m == f or m.startswith(f + ".") for f in forbidden)


for mod in modules:
    importlib.import_module(mod)
    offenders = sorted(m for m in sys.modules if bad(m))
    assert not offenders, (
        f"importing {mod} pulled in {offenders[:5]} at module level; "
        f"{pkg_name} must import them lazily, inside functions")
print("clean:", len(modules), "modules")
"""

CASES = {
    "monitor": (("trace", "slo", "http", "costs", "catalog"),
                ("chainermn_torch.extensions",), ()),
    "fleet": (("router", "replica", "routing", "control", "overload"),
              ("chainermn_torch.extensions", "chainermn_torch.serving",
               "torch"), ()),
    "deploy": (("publish", "reshard", "versions"),
               ("chainermn_torch.extensions", "chainermn_torch.serving",
                "torch"), ()),
    "analysis": (("core", "astutil", "sanitizer", "__main__", "locks",
                  "names", "hotpath", "recompile"),
                 ("chainermn_torch", "torch", "numpy"),
                 ("chainermn_torch.analysis",)),
}


@pytest.mark.parametrize("pkg", sorted(CASES))
def test_package_imports_stay_lazy(pkg):
    required, forbidden, allowed = CASES[pkg]
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, os.path.join(_PKG, pkg),
         f"chainermn_torch.{pkg}", ",".join(required),
         ",".join(forbidden), ",".join(allowed)],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=_REPO))
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}")
    assert "clean:" in proc.stdout
