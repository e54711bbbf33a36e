"""The native motion cache (port of ``ase_tpu/native/__init__.py``).

``native/motion_cache.cpp`` is a CPython extension: ``pack`` writes a
``.msc`` dataset cache and ``load`` memory-maps one. ``motion_cache()``
compiles it at first use with g++ into ``ase_tpu_torch/_build/``, under a
name carrying the hash of the source, the flags and the Python it builds
for, and loads it from that path with ``importlib`` (no ``sys.path``
entry, so it never meets ``ase_tpu``'s build of the same module). A build
writes to a temporary name and renames it into place, so concurrent
processes never load half a library and no lock file is left behind. A
failed build raises with the compiler's output: there is no fallback that
parses the clips instead. Nothing is built when this module is imported.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "motion_cache.cpp")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_module = None


def _include() -> str:
    return sysconfig.get_paths()["include"]


def lib_path(source: str = SOURCE) -> str:
    """Where the build of ``source`` goes (and is looked for)."""
    with open(source, "rb") as f:
        key = f.read() + " ".join(GXX_FLAGS + [_include(), sys.version]).encode()
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    return os.path.join(BUILD_DIR, f"_motion_cache_{hashlib.sha1(key).hexdigest()[:12]}{suffix}")


def build(source: str = SOURCE) -> str:
    """Compile ``source`` with g++; returns the library's path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, f"-I{_include()}", source, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"motion cache build failed (g++ exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def motion_cache():
    """The ``_motion_cache`` extension module, built on first use."""
    global _module
    if _module is None:
        path = lib_path()
        if not os.path.exists(path):
            build()
        loader = importlib.machinery.ExtensionFileLoader("_motion_cache", path)
        spec = importlib.util.spec_from_file_location("_motion_cache", path, loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        _module = module
    return _module
