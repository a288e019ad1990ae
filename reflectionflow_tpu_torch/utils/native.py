"""ctypes bindings for the native tar shard indexer (`native/genref_loader.cpp`
at the repository root: one sequential header pass, batched `pread`s).

Counterpart of `reflectionflow_tpu/utils/native.py`. The library is built
with g++ by `ops/kernel_build.py::build_host_all` into
`.build/host/genref_loader-<hash>/`; a missing source or compiler, or a
failed build, raises. The one fallback is the JAX package's: a shard the
indexer cannot take (return code -2, more members than the cap; -3, a
base-256 size or a PAX header over 1 MiB) is read with Python's `tarfile` by
`train/data.py::iter_tar_samples`, which counts it in `fallbacks`.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "genref_loader.cpp"
NAME_STRIDE = 256
_FALLBACK_CODES = (-2, -3)

fallbacks = 0  # shards read with tarfile because the indexer returned -2 or -3
_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _lib
    if _lib is None:
        from ..ops.kernel_build import load_host

        if not SOURCE.exists():
            raise FileNotFoundError(f"the native tar indexer's source {SOURCE} is missing")
        lib = load_host(SOURCE)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rf_tar_index.restype = ctypes.c_int64
        lib.rf_tar_index.argtypes = [ctypes.c_char_p, i64p, i64p, ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.rf_tar_read_batch.restype = ctypes.c_int32
        lib.rf_tar_read_batch.argtypes = [ctypes.c_char_p, i64p, i64p, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_uint8), i64p]
        _lib = lib
    return _lib


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def tar_index(path: str, max_members: int | None = None):
    """-> (names list[str], offsets int64 array, sizes int64 array) of the
    shard's regular files, or None when the indexer cannot take the shard
    (-2 capacity, -3 base-256 size); an I/O error raises."""
    lib = get_lib()
    if max_members is None:
        # members are >= 1 KiB (512 B header + padded data) in GenRef shards;
        # the cap keeps the name buffer bounded
        max_members = max(64, min(1 << 20, os.path.getsize(path) // 512))
    offsets = np.zeros(max_members, np.int64)
    sizes = np.zeros(max_members, np.int64)
    names = np.zeros(max_members * NAME_STRIDE, np.uint8)
    n = lib.rf_tar_index(os.fsencode(path), _i64p(offsets), _i64p(sizes),
                         names.ctypes.data_as(ctypes.c_char_p), max_members, NAME_STRIDE)
    if n in _FALLBACK_CODES:
        return None
    if n < 0:
        raise OSError(f"cannot index tar shard {path} (code {n})")
    raw = names[: n * NAME_STRIDE].tobytes()
    out_names = [raw[i * NAME_STRIDE:(i + 1) * NAME_STRIDE].split(b"\0", 1)[0].decode()
                 for i in range(n)]
    return out_names, offsets[:n].copy(), sizes[:n].copy()


def tar_read_batch(path: str, offsets: np.ndarray, sizes: np.ndarray) -> list[bytes]:
    """Read the given members in one native batched call."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    out_offsets = np.cumsum(sizes) - sizes
    buf = np.zeros(max(int(sizes.sum()), 1), np.uint8)
    rc = get_lib().rf_tar_read_batch(os.fsencode(path), _i64p(offsets), _i64p(sizes), len(offsets),
                                     buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                     _i64p(out_offsets))
    if rc != 0:
        raise OSError(f"rf_tar_read_batch failed for {path}")
    return [buf[o:o + s].tobytes() for o, s in zip(out_offsets, sizes)]
