"""Build a CUDA source of this package into a shared library and load it.

Route: `nvcc` by hand into a library with a plain C interface, bound with
`ctypes` (no PyTorch headers, so a build takes seconds). The library lands in
`.build/kernels/<name>-<hash>/` at the repository root, keyed by a hash of the
source and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--use_fast_math",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to (depends on its content and the flags)."""
    digest = hashlib.sha256((CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{digest.hexdigest()[:16]}" / f"lib{stem}.so"


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; returns the path."""
    out = _library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` once per process."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build(source)))
    return lib
