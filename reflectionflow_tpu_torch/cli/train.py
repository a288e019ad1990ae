"""Corrector training CLI of the PyTorch port.

Usage, as the JAX package's `reflectionflow_tpu.cli.train`, plus `--device`:
  python -m reflectionflow_tpu_torch.cli.train --config train.json \
      [--shards genref_000.tar ...] [--synthetic_data] [--synthetic_weights] [--device cpu]

Without `--synthetic_weights` it trains the bf16 FLUX.1 snapshot in the local
directory `$FLUX_MODEL_DIR` (default: the working directory), as the JAX CLI
does. `--synthetic_weights` trains the tiny fp32 pipeline (random weights,
seeded) with the data sizes shrunk to smoke sizes when no config is given;
`--synthetic_data` writes a random PNG shard a data rank when no shards are
named. `--device` (default cuda) raises when CUDA is missing.

Over a mesh of ranks, one process a device, as the JAX CLI trains over every
device: under torchrun (`torchrun --nproc_per_node N -m
reflectionflow_tpu_torch.cli.train ...`) each process joins the group; else
the CLI spawns the ranks that `TrainConfig.mesh_shape` names on this host (a
-1 takes every visible card for `--device cuda`, and one rank for the CPU or
a named card, so the default (-1,) is data-parallel over every card). The
ranks train on a `RankMesh` of that shape over ("data", "model"); each rank
reads the shards of its data coordinate (`GenRefDataset(host_index,
host_count)`) at `data.batch_size` / data ranks a step, so `data.batch_size`
is the global batch, as on one JAX host; rank 0 writes.
"""

from __future__ import annotations

import argparse
import glob
import math
import os

import torch
import torch.distributed as dist

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


def _config(args) -> TrainConfig:
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
    return cfg


def _world(mesh_shape, device: str) -> int:
    """The ranks that `mesh_shape` names; a -1 takes every visible card for
    `--device cuda` and one rank for the CPU or a named card."""
    known = math.prod(d for d in mesh_shape if d != -1)
    if -1 not in mesh_shape or device != "cuda":
        return known
    return max(1, torch.cuda.device_count() // known) * known


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:  # torchrun
        from ..parallel.distributed import init_distributed

        init_distributed(device=args.device)
    world = _world(_config(args).mesh_shape, args.device)
    if not dist.is_initialized() and world > 1:
        import tempfile

        from ..parallel.distributed import launch
        from ..parallel.dryrun import file_init

        with tempfile.TemporaryDirectory() as td:
            return launch(_rank_main, world, args=(argv,), device=args.device,
                          init_method=file_init(td), timeout=7 * 86400.0)[0]
    return _train(args)


def _rank_main(device, argv):
    return _train(build_parser().parse_args(argv), device)


def _train(args, device=None):
    device = device or resolve_device(args.device)
    if dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
    cfg = _config(args)
    if cfg.attn_impl == "pallas_interpret":
        raise NotImplementedError("attn_impl='pallas_interpret': Pallas interpret mode has no CUDA "
                                  "counterpart; use 'pallas' (its plain versions run on CPU tensors)")
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(tuple(cfg.mesh_shape), ("data", "model"))
    dp = mesh.axis_size("data") if mesh is not None else 1
    host = mesh.coords["data"] if mesh is not None else 0
    if cfg.data.batch_size % dp:
        raise ValueError(f"data.batch_size={cfg.data.batch_size} (the global batch) does not divide "
                         f"by the {dp} data ranks")

    shards = []
    for pat in args.shards or list(cfg.data.shards):
        shards.extend(sorted(glob.glob(pat)) or [pat])
    if args.synthetic_data and not shards:
        shards = [os.path.join(cfg.checkpoint_dir, f"synthetic_{i:03d}.tar") for i in range(dp)]
        from ..parallel.distributed import RankZero

        def write_all():
            for i, path in enumerate(shards):
                write_synthetic_shard(path, n=16, size=cfg.data.target_size, seed=i)
        RankZero(mesh).call(write_all)  # the others wait for rank 0's files
    if dp > 1 and len(shards) < dp:
        raise ValueError(f"{len(shards)} shards for {dp} data ranks: each data rank reads its own")

    schedule = None
    if cfg.data.training_stages:
        stages = [s if isinstance(s, int) else s[0] for s in cfg.data.training_stages]
        ratios = cfg.split_ratios or GENREF_SPLIT_RATIOS
        schedule = StageSchedule(split_ratios=ratios, training_stages=stages)

    ds = GenRefDataset(
        shards=shards,
        batch_size=cfg.data.batch_size // dp,
        target_size=cfg.data.target_size,
        condition_size=cfg.data.condition_size,
        drop_text_prob=cfg.data.drop_text_prob,
        drop_image_prob=cfg.data.drop_image_prob,
        drop_reflection_prob=cfg.data.drop_reflection_prob,
        schedule=schedule,
        seed=cfg.seed,
        host_index=host,
        host_count=dp,
    )
    if args.synthetic_weights:
        pipe = synthetic_pipeline(device)
    else:
        from ..sampler.pipeline import FluxPipeline

        pipe = FluxPipeline.from_pretrained(os.environ.get("FLUX_MODEL_DIR", "."), dtype=torch.bfloat16,
                                            device=device)
    out = train(pipe, cfg, ds, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print({"final_metrics": out["metrics"]})
    return out["metrics"]


if __name__ == "__main__":
    main()
