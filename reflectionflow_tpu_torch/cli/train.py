"""Corrector training CLI of the PyTorch port.

Usage, as the JAX package's `reflectionflow_tpu.cli.train`, plus `--device`:
  python -m reflectionflow_tpu_torch.cli.train --config train.json \
      [--shards genref_000.tar ...] [--synthetic_data] [--synthetic_weights] [--device cpu]

Without `--synthetic_weights` it trains the bf16 FLUX.1 snapshot in the local
directory `$FLUX_MODEL_DIR` (default: the working directory), as the JAX CLI
does. `--synthetic_weights` trains the tiny fp32 pipeline (random weights,
seeded) with the data sizes shrunk to smoke sizes when no config is given;
`--synthetic_data` writes a random PNG shard when no shards are named. The
run is on one device (`--device`, default cuda; it raises when CUDA is
missing); data parallelism over a device mesh is ROADMAP slice 7b part 2.
"""

from __future__ import annotations

import argparse
import glob
import os

import torch

from ..config import TrainConfig
from ..train.data import GENREF_SPLIT_RATIOS, GenRefDataset, StageSchedule, write_synthetic_shard
from ..train.train_loop import train
from .common import add_device_arg, resolve_device, synthetic_pipeline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--shards", type=str, nargs="*", default=None, help="tar shard paths or globs")
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--synthetic_weights", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--attn_impl", type=str, default=None, choices=["xla", "pallas", "pallas_interpret"],
                   help="override TrainConfig.attn_impl (pallas = K1 forward + K6 backward on "
                   "CUDA tensors; pallas_interpret has no CUDA counterpart and raises)")
    add_device_arg(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = TrainConfig.load(args.config) if args.config else TrainConfig()
    if args.synthetic_weights and args.config is None:
        # the tiny synthetic model with the full-scale 512px data defaults
        # would allocate far more attention than it needs: shrink to smoke sizes
        cfg.data.batch_size = min(cfg.data.batch_size, 2)
        cfg.data.target_size = min(cfg.data.target_size, 16)
        cfg.data.condition_size = min(cfg.data.condition_size, 8)
    if args.max_steps is not None:
        cfg.max_steps = args.max_steps
    if args.attn_impl is not None:
        cfg.attn_impl = args.attn_impl
    if cfg.attn_impl == "pallas_interpret":
        raise NotImplementedError("attn_impl='pallas_interpret': Pallas interpret mode has no CUDA "
                                  "counterpart; use 'pallas' (its plain versions run on CPU tensors)")
    if any(d > 1 for d in cfg.mesh_shape):
        raise NotImplementedError(f"mesh_shape={cfg.mesh_shape}: training over a device mesh is "
                                  "ROADMAP slice 7b part 2; the port trains on one device")

    shards = []
    for pat in args.shards or list(cfg.data.shards):
        shards.extend(sorted(glob.glob(pat)) or [pat])
    if args.synthetic_data and not shards:
        path = os.path.join(cfg.checkpoint_dir, "synthetic_000.tar")
        write_synthetic_shard(path, n=16, size=cfg.data.target_size)
        shards = [path]

    schedule = None
    if cfg.data.training_stages:
        stages = [s if isinstance(s, int) else s[0] for s in cfg.data.training_stages]
        ratios = cfg.split_ratios or GENREF_SPLIT_RATIOS
        schedule = StageSchedule(split_ratios=ratios, training_stages=stages)

    ds = GenRefDataset(
        shards=shards,
        batch_size=cfg.data.batch_size,
        target_size=cfg.data.target_size,
        condition_size=cfg.data.condition_size,
        drop_text_prob=cfg.data.drop_text_prob,
        drop_image_prob=cfg.data.drop_image_prob,
        drop_reflection_prob=cfg.data.drop_reflection_prob,
        schedule=schedule,
        seed=cfg.seed,
    )
    if args.synthetic_weights:
        pipe = synthetic_pipeline(device)
    else:
        from ..sampler.pipeline import FluxPipeline

        pipe = FluxPipeline.from_pretrained(os.environ.get("FLUX_MODEL_DIR", "."), dtype=torch.bfloat16,
                                            device=device)
    out = train(pipe, cfg, ds)
    print({"final_metrics": out["metrics"]})


if __name__ == "__main__":
    main()
