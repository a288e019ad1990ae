"""Build CUDA sources of this package into shared libraries and load them.

Route: `nvcc` by hand into a library with a plain C interface, bound with
`ctypes` (no PyTorch headers, so a build takes seconds). A library lands in
`.build/kernels/<name>-<hash>/` at the repository root, keyed by a hash of the
source and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. `build_all` starts one `nvcc` per source at once. A failed build
raises; nothing falls back.
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
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "act_quant.cu", "norm_rope.cu")
# K1 takes the approximate exp and division; the flash backward, act-quant
# and norm+rope kernels need accurate arithmetic to round bf16 and int8
# values as their plain versions do.
FAST_MATH = frozenset({"flash_fwd.cu"})

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_flags(source: str) -> tuple[str, ...]:
    fast = ("--use_fast_math",) if source in FAST_MATH else ()
    return ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *fast,
            "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to (depends on its content and the flags)."""
    digest = hashlib.sha256((CSRC / source).read_bytes() + " ".join(nvcc_flags(source)).encode())
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{digest.hexdigest()[:16]}" / f"lib{stem}.so"


def build_all(sources=SOURCES) -> list[Path]:
    """Compile each `csrc/<source>` whose library is missing, all at once;
    returns the library paths in order."""
    outs = [_library_path(s) for s in sources]
    running = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(source), "-o", str(tmp), str(CSRC / source)]
        running.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, out, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; returns the path."""
    return build_all((source,))[0]


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` once per process."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build(source)))
    return lib
