"""Build the hand-written CUDA kernels and the host I/O runtime at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``; ``csrc/hostio.cpp`` (the
prefetch reader and the shared-memory rings of ``io/hostio.py``) is
compiled the same way by the host compiler (``build_host``).  The library
goes to ``build/dspsr_tpu_torch/`` at the repository root (ignored by git)
under a name that carries a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dspsr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: the host compiler's flags (the JAX package's ``native/Makefile``)
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
HOST_LIBS = ("-lrt",)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def cxx_path() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host I/O runtime "
                           "(csrc/hostio.cpp) cannot be built")
    return cxx


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every file it includes by ``#include "..."`` from the
    source directory, recursively, each once, in first-include order."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.exists():
            _sources(dep, seen)
    return seen


def library_path(name: str, ext: str = ".cu") -> Path:
    """Where ``csrc/<name><ext>`` is built (``.cu`` by nvcc, ``.cpp`` by the
    host compiler): named by a hash of the source, the headers it includes
    and the flags, so an edit to any of them rebuilds."""
    flags = NVCC_FLAGS if ext == ".cu" else HOST_FLAGS + HOST_LIBS
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources(_SRC_DIR / f"{name}{ext}", []):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(tool: str, out: Path, head: list, src: Path,
             tail: tuple = ()) -> tuple[Path, str, float]:
    """Run ``head -o <tmp> src tail`` (compiler ``tool``) and move the
    library to ``out`` (atomically, so concurrent builders of one source
    never load a partial file).  Returns (out, compiler messages, seconds
    compiling)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*head, "-o", str(tmp), str(src), *tail],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{tool} failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr, seconds


def build(name: str, verbose: bool = False) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    Returns (library path, compiler messages, seconds spent compiling).
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills).
    """
    out = library_path(name)
    if out.exists():
        return out, "", 0.0
    head = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    return _compile("nvcc", out, head, _SRC_DIR / f"{name}.cu")


def build_host(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless an
    up-to-date library exists; returns as ``build`` does."""
    out = library_path(name, ".cpp")
    if out.exists():
        return out, "", 0.0
    return _compile("g++", out, [cxx_path(), *HOST_FLAGS],
                    _SRC_DIR / f"{name}.cpp", HOST_LIBS)


def load(name: str, host: bool = False) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (``csrc/<name>.cpp`` when
    ``host``), built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build_host(name) if host else build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
