"""Build-on-demand for the native (C++) components (the port of
``chainermn_tpu/native/_build.py``).

Each component is one ``.cc`` beside this file, compiled with the
system ``g++`` into a shared library with a C interface, loaded with
``ctypes``. The library goes to ``build/`` at the repository root (git
ignores it), named by a hash of the source, so an edited source is never
served from a stale build; a file lock keeps concurrent processes from
racing the compiler. Callers catch the ``RuntimeError`` and fall back to
Python.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path

from chainermn_torch._build import BUILD_DIR

_DIR = Path(__file__).resolve().parent


def library_path(src_basename: str, stem: str) -> Path:
    """Where the library built from ``<native>/<src_basename>`` lives."""
    digest = hashlib.sha256((_DIR / src_basename).read_bytes()).hexdigest()
    py = f"py{sys.version_info[0]}{sys.version_info[1]}"
    return BUILD_DIR / f"_{stem}_{py}_{digest[:12]}.so"


def build_and_load(src_basename: str, stem: str,
                   extra_flags: tuple = ()) -> ctypes.CDLL:
    """Compile ``<native>/<src_basename>`` (once per source version) and
    load it. ``extra_flags`` append to the ``g++`` line. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    lib_path = library_path(src_basename, stem)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(f"{lib_path}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                res = subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-pthread", str(_DIR / src_basename), "-o", tmp,
                     *extra_flags],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed ({res.returncode}) "
                                       f"building {src_basename}:\n"
                                       f"{res.stdout}{res.stderr}")
                os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


__all__ = ["build_and_load", "library_path"]
