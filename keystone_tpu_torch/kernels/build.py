"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``, and each
``csrc/<name>.cpp`` (host code) by ``g++``, into
``_build/lib<name>-<hash>.so`` with a plain C interface, and loaded with
``ctypes``.  The hash covers the source and the command's flags, so an
edited source rebuilds and an unchanged one is loaded from the build
directory.  Nothing builds at import: the first call that needs a
library builds it.  Only the repository's sources, the CUDA toolkit and
the system's libjpeg are used (``text.cpp``, the host text chain, needs
nothing beyond the C++ standard library).

``build`` and ``load`` run under one process-wide re-entrant lock
(``LOCK``), which the kernel wrappers' first-use loaders take too: two
threads (two serving replicas priming at once) build a library once and
load one copy of it.  A compiler's temporary output is named by process
and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the reference's native build flags (native/Makefile), for host code
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++20", "-shared")
#: libraries a source links against
LINK = {"jpeg": ("-ljpeg", "-lpthread"), "nvjpeg": ("-lnvjpeg",), "text": ("-lpthread",)}

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A native source failed to build, or a kernel failed to launch: a
    fault of the machine, never of the data (the serving path does not
    bisect a flush for it)."""


#: held around every build and load, and by the wrappers' first-use loaders
LOCK = threading.RLock()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if _source(name).suffix == ".cu" else CXX_FLAGS


def _lib_path(name: str) -> Path:
    src = _source(name).read_bytes()
    h = hashlib.blake2b(src + " ".join(_flags(name) + LINK.get(name, ())).encode(), digest_size=8)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()}.so"


def source_hashes() -> Dict[str, str]:
    """Each native library's source-and-flags hash, by name (the hash its
    build is named by), for every source under ``csrc/``.  Builds
    nothing: a frozen applier's CUDA-graph bundle is keyed by these, so a
    changed kernel source or build flag refuses a bundle captured
    against the old one."""
    names = sorted({p.stem for p in CSRC.iterdir() if p.suffix in (".cu", ".cpp")})
    return {n: _lib_path(n).stem.rsplit("-", 1)[1] for n in names}


def _compiler(name: str) -> str:
    if _source(name).suffix == ".cu":
        return nvcc_path()
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelError("g++ not found: the host sources build with it")
    return gxx


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all compiler
    processes started together; raise with the compiler's output if any
    fails.  Returns the library path of each name.  The compiler's
    output (for ``nvcc``, the resource report of ``-Xptxas -v``) goes to
    ``_build/<name>.log``."""
    with LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_compiler(n), *_flags(n), "-o", str(tmp), str(_source(n)), *LINK.get(n, ())]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{Path(p.args[0]).name} {_source(n).name} exited {p.returncode}:\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise KernelError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on first use."""
    with LOCK:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
