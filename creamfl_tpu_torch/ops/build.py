"""Build a source of ``csrc/`` into a shared library loaded with ctypes.

Each source is compiled on its own, at first use, into
``creamfl_tpu_torch/_build/<hash>/lib<name>.so`` (the directory is
git-ignored), where the hash covers the source, every ``*.cuh`` header
beside it (which the source may include), the flags and the source's link
flags (``-lnvjpeg`` for ``csrc/jpeg.cu``): a changed source or header gets
a new library and an unchanged one is built once. The kernels are built
with nvcc (``NVCC_FLAGS``); the host-only caption tokenizer
(``csrc/native.cpp``) with g++ (``GXX_FLAGS``). The libraries have a
plain C interface: no PyTorch headers, so a build takes seconds. Each call
of ``build`` (a library built, or found built and loaded) is a
``creamfl.ops.build`` span and counts in the recorder's ``ops.builds``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

from creamfl_tpu_torch.utils import profiling

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the kernels are built from "
                       "creamfl_tpu_torch/csrc/ at first use and need the "
                       "CUDA toolkit")


def toolkit_lib_dir() -> str:
    """The CUDA toolkit's library directory (beside ``nvcc``'s)."""
    return os.path.join(os.path.dirname(os.path.dirname(nvcc())), "lib64")


def library_path(source: Path, link: Sequence[str] = (),
                 flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Where the library built from ``source`` with ``flags`` (linked with
    ``link``) lives."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    if link:
        h.update(" ".join(link).encode())
    digest = h.hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{source.stem}.so"


def build(source: Path, link: Sequence[str] = (), compiler: str = "nvcc",
          flags: Sequence[str] = NVCC_FLAGS) -> Tuple[Path, float, str]:
    """Compile ``source`` with ``compiler`` ("nvcc": the toolkit's, found
    by ``nvcc()``; else a command on the PATH) and ``flags`` (linked with
    ``link``) unless a library for this exact source and these flags
    exists. The library is written under a temporary name and renamed, so
    that a concurrent process never loads half of it. Returns (library
    path, build seconds, compiler output). Raises if the compiler fails or
    is missing."""
    profiling.count("ops.builds")
    with profiling.span("creamfl.ops.build"):
        return _build(source, link, compiler, flags)


def _build(source: Path, link: Sequence[str], compiler: str,
           flags: Sequence[str]) -> Tuple[Path, float, str]:
    lib = library_path(source, link, flags)
    if lib.exists():
        return lib, 0.0, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")
    exe = nvcc() if compiler == "nvcc" else compiler
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([exe, *flags, "-o", str(tmp), str(source),
                               *link], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler} cannot run to build "
                           f"{source.name}: {e}") from e
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {source.name} "
                           f"({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log
