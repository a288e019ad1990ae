"""Build CUDA sources of this package into shared libraries and load them.

Route: `nvcc` by hand into a library with a plain C interface, bound with
`ctypes` (no PyTorch headers, so a build takes seconds). A library lands in
`.build/kernels/<name>-<hash>/` at the repository root, keyed by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited kernel is
rebuilt and an unchanged one is reused. `build_all` starts one `nvcc` per
source at once. A failed build raises; nothing falls back. ptxas's report of
each kernel's registers and spills is kept beside its library
(`ptxas_report`); `sass_opcodes` counts the instructions a built kernel holds
(cuobjdump), to show which tensor-core and copy paths it really took.

Host route: `build_host_all` compiles C++ sources that run on the CPU (the
image codecs of `csrc/host/`, the repository's `native/genref_loader.cpp`)
with `g++ -O3 -shared -fPIC -std=c++17` into
`.build/host/<name>-<hash>/lib<name>.so`, keyed by the source, the headers
beside it (`csrc/host/*.h`) and the flags,
through the same process-unique temporary file and rename; a missing compiler
or a failed build raises, as on the nvcc route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO = Path(__file__).resolve().parents[2]
BUILD_ROOT = REPO / ".build" / "kernels"
HOST_BUILD_ROOT = REPO / ".build" / "host"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "act_quant.cu", "norm_rope.cu", "flash_fwd_int8.cu",
           "flash_fwd_nr.cu")
# K1 and K7a take the approximate exp and division; the flash backward, act-quant,
# norm+rope, int8 and norm+rope attention kernels need accurate arithmetic to
# round bf16 and int8 values as their plain versions do.
FAST_MATH = frozenset({"flash_fwd.cu"})

_LOADED: dict[str, ctypes.CDLL] = {}
_LOADED_HOST: dict[Path, ctypes.CDLL] = {}


def nvcc_flags(source: str) -> tuple[str, ...]:
    fast = ("--use_fast_math",) if source in FAST_MATH else ()
    return ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *fast,
            "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def _cuda_tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which(name), os.path.join(cuda_home, "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put {name} on PATH)")


def _library_path(source: str) -> Path:
    """Where `csrc/<source>` builds to (depends on its content, the headers and
    the flags)."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / source).read_bytes() + headers
                            + " ".join(nvcc_flags(source)).encode())
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{digest.hexdigest()[:16]}" / f"lib{stem}.so"


def _compile_all(jobs, tool: str) -> None:
    """Run every (label, output, command, report) compile job at once; each
    output is written to a process-unique temporary file and renamed into
    place after `report(output, stderr)`. Raises after all have ended if any
    failed."""
    running = []
    for label, out, cmd, report in jobs:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        running.append((label, out, tmp, report, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for label, out, tmp, report, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{tool} failed for {label}:\n{err}")
        else:
            report(out, err)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(sources=SOURCES) -> list[Path]:
    """Compile each `csrc/<source>` whose library is missing, all at once;
    returns the library paths in order."""
    outs = [_library_path(s) for s in sources]
    jobs = [(source, out, [_cuda_tool("nvcc"), *nvcc_flags(source), str(CSRC / source)],
             lambda out, err: out.with_suffix(".ptxas").write_text(err))
            for source, out in zip(sources, outs) if not out.exists()]
    _compile_all(jobs, "nvcc")
    return outs


def _kernel_name(mangled: str) -> str:
    """The `*_kernel` identifier of an Itanium-mangled name: the last
    length-prefixed component."""
    found = mangled
    for m in re.finditer(r"\d+", mangled):
        digits = m[0]
        for i in range(len(digits)):
            name = mangled[m.end():m.end() + int(digits[i:])]
            if name.endswith("_kernel") and name.isidentifier():
                found = name
    return found


def ptxas_report(source: str) -> dict[str, dict[str, int]]:
    """{kernel: {"registers": n, "spill_stores": n, "spill_loads": n}} from
    ptxas's report of the built `csrc/<source>`."""
    report, name = {}, None
    for line in _library_path(source).with_suffix(".ptxas").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:  # a template's instances share a name: number the later ones
            base = name = _kernel_name(m[1])
            while name in report:
                name = f"{base}#{sum(k.split('#')[0] == base for k in report)}"
            report[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m[1])
    return report


def sass_opcodes(source: str, kernel: str, modifiers: bool = False) -> dict[str, int]:
    """{opcode: count} over the SASS of `kernel` (its `*_kernel` name) in the
    built `csrc/<source>`, opcodes without their modifiers (HGMMA, UTMALDG,
    HMMA, ...), or with them when `modifiers` (LDG.E.128, MUFU.EX2, ...)."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(build(source))],
                          capture_output=True, text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        if _kernel_name(name.strip()) != kernel:
            continue
        counts: dict[str, int] = {}
        for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*)",
                             body):
            op = op if modifiers else op.split(".")[0]
            counts[op] = counts.get(op, 0) + 1
        return counts
    raise KeyError(f"no kernel {kernel} in the SASS of {source}")


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless its library exists; returns the path."""
    return build_all((source,))[0]


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source>` once per process."""
    lib = _LOADED.get(source)
    if lib is None:
        lib = _LOADED[source] = ctypes.CDLL(str(build(source)))
    return lib


def host_library_path(source: Path) -> Path:
    """Where the host C++ file `source` builds to (depends on its content, the
    headers beside it and the flags)."""
    source = Path(source)
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.h")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(HOST_FLAGS).encode())
    return HOST_BUILD_ROOT / f"{source.stem}-{digest.hexdigest()[:16]}" / f"lib{source.stem}.so"


def build_host_all(sources) -> list[Path]:
    """Compile each host C++ file whose library is missing, all at once, with
    g++; returns the library paths in order."""
    sources = [Path(s) for s in sources]
    outs = [host_library_path(s) for s in sources]
    missing = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if missing:
        compiler = shutil.which(os.environ.get("CXX", "g++"))
        if compiler is None:
            raise RuntimeError(f"no C++ compiler to build {missing[0][0]} (install g++ or set CXX)")
        _compile_all([(source, out, [compiler, *HOST_FLAGS, str(source)], lambda out, err: None)
                      for source, out in missing], "g++")
    return outs


def load_host(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the host C++ file `source` once per process."""
    source = Path(source).resolve()
    lib = _LOADED_HOST.get(source)
    if lib is None:
        lib = _LOADED_HOST[source] = ctypes.CDLL(str(build_host_all([source])[0]))
    return lib
