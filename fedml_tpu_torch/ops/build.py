"""Builds the port's CUDA kernels from ``fedml_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root, then loaded with ``ctypes``. A library's file name carries
a hash of its source, of every header in ``csrc`` (``*.cuh``, ``*.h``) and
of the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is. :func:`build_all` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build fedml_tpu_torch's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    headers = sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")])
    for header in headers:  # any of them may be included
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, started) -> str:
    """Wait for one build; returns the compiler's report (registers,
    shared memory, spills) and raises with it if the build failed."""
    if started is None:
        return ""
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    return out


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel; returns each source's
    compiler report (empty for a library that was already built)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, started[n]) for n in names}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(_target(name)))
