"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds.  Libraries are named by a digest of their source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is;
``build_all`` compiles several sources at once, one ``nvcc`` each.

The build directory is ``kernels/_build/`` inside the package (listed in
``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR`` when that is set.
Nothing here runs when a module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use")
    return str(path)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of that source,
    every shared header ``csrc/*.cuh`` and the flags, so an edit to any
    of them builds anew."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def build_all(names: Iterable[str]) -> None:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    each, all started together, and load them all.  A failed build
    raises with the compiler's output."""
    names = [n for n in names if n not in _LOADED]
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        BUILD_SECONDS[name] = time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    A failed build raises with the compiler's output."""
    build_all([name])
    return _LOADED[name]


def build_log(name: str) -> str:
    """The compiler's output (ptxas registers, spills) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
