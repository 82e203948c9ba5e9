"""One nvcc build step for every CUDA kernel library of the port.

A source under ``chainermn_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, written to
``build/`` at the repository root and loaded with ``ctypes``. The library
is named by a hash of its source and of every header it includes with
``#include "..."`` (transitively), so an edited kernel or header is never
served from a stale build. Nothing here runs while a module is imported:
a kernel module calls :func:`load_library` the first time it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

_loaded: dict[Path, tuple[ctypes.CDLL, str]] = {}
_locks: dict[Path, threading.Lock] = {}
_locks_guard = threading.Lock()
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _included(src: Path) -> list[Path]:
    """Every file ``src`` includes with ``#include "..."``, transitively
    (each path relative to the file that names it), sorted."""
    seen: set[Path] = set()
    todo = [src]
    while todo:
        f = todo.pop()
        for name in _INCLUDE.findall(f.read_text()):
            inc = (f.parent / name).resolve()
            if inc.is_file() and inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return sorted(seen)


def library_path(src: Path) -> Path:
    """Where the library built from ``src`` lives: named by a hash of the
    source and of the headers it includes."""
    src = Path(src).resolve()
    h = hashlib.sha256(src.read_bytes())
    for inc in _included(src):
        h.update(inc.name.encode())
        h.update(inc.read_bytes())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:12]}.so"


def load_library(src: Path, signatures: dict) -> tuple[ctypes.CDLL, str]:
    """Compile ``src`` (once per source version) and load it.

    ``signatures`` maps each exported C function to ``(argtypes,
    restype)``. Returns ``(library, log)``: ``log`` is the compiler's
    output of this process's build (``-Xptxas -v`` registers, shared
    memory and spills per kernel), empty when the library was already
    built. Raises ``RuntimeError`` with that output when ``nvcc`` fails.
    Different sources build concurrently; one source builds once."""
    src = Path(src).resolve()
    with _locks_guard:
        lock = _locks.setdefault(src, threading.Lock())
    with lock:
        if src in _loaded:
            return _loaded[src]
        so = library_path(src)
        log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            # --split-compile: the optimiser's passes on 4 threads; two
            # sources build at once on the card host's 8 cores
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "--split-compile=4", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
                   str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {src}:\n{log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[src] = (lib, log)
        return lib, log


__all__ = ["BUILD_DIR", "library_path", "load_library"]
