"""Host decode times of two checkouts of the PyTorch port, in turns.

    python tools/host_decode_ab.py OTHER_CHECKOUT [--rounds 2] [--reps 15] [FIXTURE ...]

Times `reflectionflow_tpu_torch.train.data.decode_image` on committed fixtures
of `tests/data/torch_jpeg/` (default: the 1024x768 baseline JPEG and the
1024x768 TIFF timing files; a file a checkout does not read is left out of
its times), or on the files `chip_smoke.py` phase 5e writes (the names
tga_rle, psd_packbits and qoi: this checkout's writers over the decoded
baseline JPEG; dds_bc7: its 1024x768 BC7 file), in this checkout and in
OTHER_CHECKOUT (for
example the parent commit unpacked with `git archive`), each in its own
process on one thread, in the order this, other, other, this per round; each
process reports the median of `--reps` decodes per file after one warm-up.
Prints one JSON line per process and a last line with, per file, the median
over rounds of each checkout and their ratio (this / other). The host
libraries are built first (g++), outside the timed region.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ["bad_1024x768_q75_420.jpg", "tiff_lzw_pred2_1024x768.tif", "tiff_jpeg_ycbcr_420_1024x768.tif",
           "tiff_zstd_1024x768.tif", "tiff_ojpeg_420_1024x768.tif"]

CHILD = r"""
import json, os, statistics, sys, time
import torch
torch.set_num_threads(1)
from reflectionflow_tpu_torch.train.data import decode_image
from reflectionflow_tpu_torch.utils import image_io
from reflectionflow_tpu_torch.ops import kernel_build
kernel_build.build_host_all(image_io.SOURCES)
fixtures, reps = sys.argv[1], int(sys.argv[2])
out = {}
for name in sys.argv[3:]:
    path = os.path.join(fixtures, name)
    if not os.path.exists(path):
        continue
    data = open(path, "rb").read()
    try:
        decode_image(data)
    except ValueError:  # a kind this checkout does not read
        continue
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_image(data)
        ts.append(time.perf_counter() - t0)
    out[name] = statistics.median(ts) * 1e3
print(json.dumps(out))
"""


def run(root: str, fixtures: str, reps: int, names: list) -> dict:
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", CHILD, fixtures, str(reps), *names], cwd=root, env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def generated(names: list, where: str) -> list:
    """`names` with each of phase 5e's written kinds replaced by the path of
    the file this checkout's `chip_smoke.py` writes for it."""
    kinds = ("tga_rle", "psd_packbits", "qoi", "dds_bc7")
    if not set(names) & set(kinds):
        return names
    sys.path.insert(0, HERE)
    import chip_smoke
    from reflectionflow_tpu_torch.train.data import decode_image

    with open(os.path.join(HERE, "tests", "data", "torch_jpeg", "bad_1024x768_q75_420.jpg"), "rb") as f:
        rgb = decode_image(f.read())
    out = []
    for name in names:
        if name in kinds:
            data = (chip_smoke.dds_timing_file() if name == "dds_bc7" else
                    getattr(chip_smoke, "write_" + name)(rgb))
            path = os.path.join(where, name)
            with open(path, "wb") as f:
                f.write(data)
            name = path
        out.append(name)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("names", nargs="*", default=DEFAULT)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    fixtures = os.path.join(HERE, "tests", "data", "torch_jpeg")  # this checkout's files, for both
    times = {"this": [], "other": []}
    with tempfile.TemporaryDirectory() as tmp:
        paths = generated(args.names, tmp)  # absolute paths: os.path.join(fixtures, path) is the path
        for _ in range(args.rounds):
            for which in ("this", "other", "other", "this"):
                res = run(HERE if which == "this" else os.path.abspath(args.other), fixtures, args.reps, paths)
                res = {os.path.basename(k): v for k, v in res.items()}
                print(json.dumps({which: res}), flush=True)
                times[which].append(res)
    summary = {}
    for name in args.names:
        a = [t[name] for t in times["this"] if name in t]
        b = [t[name] for t in times["other"] if name in t]
        if a:
            summary[name] = {"this_ms": statistics.median(a), "other_ms": statistics.median(b) if b else None,
                             "ratio": statistics.median(a) / statistics.median(b) if b else None}
    print(json.dumps({"decode_ms": summary}))


if __name__ == "__main__":
    main()
