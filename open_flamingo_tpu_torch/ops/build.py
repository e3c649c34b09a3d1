"""Builds the CUDA sources under `csrc/` at first use and loads them.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc`
for `sm_90a` into `_build/<name>-<hash>.so` (the hash covers the source,
the shared `csrc/*.cuh` headers and the flags, so an edit rebuilds) and
loaded with `ctypes`. Nothing is
built when a module is imported: the CPU path never needs `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def target(name: str) -> Path:
    """The path of `csrc/<name>.cu`'s built library."""
    # every header is hashed with every source: an edit to a shared
    # header rebuilds the sources that include it
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one `nvcc` each,
    all started together. Returns each name's `ptxas -v` report. Raises on
    a failed compile with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built if needed."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(target(name)))
    return _libs[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
