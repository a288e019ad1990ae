"""Corrector training loop: LoRA rectified-flow tuning on one device.

Counterpart of `reflectionflow_tpu/train/train_loop.py::train`: streaming
GenRef batches, the stage-ratio schedule advanced per step, one
`metrics.jsonl` row per step (loss, t_mean, grad_norm, step, ema_loss,
step_time_s), a checkpoint every `save_interval` steps and at the end, and
resume from the latest one; `make_validation_hook` samples the current
adapters through the conditioned `generate` every `sample_interval` steps.

Divergence: a checkpoint is `torch.save` of {adapters, opt_state} at
`<checkpoint_dir>/<step>/state.pt` (the JAX package writes orbax
checkpoints); the `latest` marker file is the same. The LoRA init and each
step's t and noise come from `cfg.seed` through the JAX package's key chain
(`utils/threefry.py`), so a seed draws what it draws in JAX; as in the JAX
package, a resumed run restarts its key chain and its data stream from the
seed.

`train(mesh=)` trains over a mesh of ranks (`parallel.mesh.RankMesh`; every
rank calls it): the DiT is cut over "model" first when the mesh has that
axis, each rank's `dataset` yields its slice of the global batch (the CLI
splits the shards by the rank's data coordinate, as JAX splits them by
host), and `make_train_step(mesh=)` reduces the gradients.
Rank 0 alone writes the checkpoints and `metrics.jsonl`; every rank reads the
same checkpoint on resume. Sequence parallelism runs through
`ops.attention.set_ring_context(mesh, "seq")` and `cfg.attn_impl =
"ring_pallas"` (or "ring"): on a `RankMesh` with a "seq" axis (("seq",),
("data", "seq") or ("model", "seq")) each rank runs K7a forward and K7b/K7c
backward on its chunk of every attention, the ranks of a seq line feed the
same data slice, and the gradients are reduced over "data" (and "model")
only; on a one-process `parallel.mesh.Mesh` the one process runs the whole
ring. The train CLI's `TrainConfig.mesh_shape` reads ("data", "model"), as
the JAX CLI, which has no ring entry. `train(hooks=...)` takes any
callables; they run on every rank.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from ..lora.lora import lora_init, lora_parameters
from ..parallel.distributed import RankZero
from ..parallel.specs import shard_dit_params
from ..utils import threefry
from ..utils.jsonl import append_jsonl
from ..utils.safetensors_io import save_file
from .rectified_flow import make_optimizer, make_train_step, prepare_batch_tensors


def save_checkpoint(ckpt_dir: str, step: int, adapters: dict, opt_state) -> None:
    path = os.path.join(ckpt_dir, str(step))
    os.makedirs(path, exist_ok=True)
    state = {name: {k: t.detach() for k, t in ab.items()} for name, ab in adapters.items()}
    torch.save({"adapters": state, "opt_state": opt_state}, os.path.join(path, "state.pt"))
    with open(os.path.join(ckpt_dir, "latest"), "w") as f:
        f.write(str(step))


def latest_checkpoint(ckpt_dir: str) -> int | None:
    marker = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, step: int, device) -> dict:
    return torch.load(os.path.join(ckpt_dir, str(step), "state.pt"), map_location=device,
                      weights_only=True)


def train(pipeline, cfg, dataset, mesh=None, position_delta: tuple[int, int] | None = None,
          log_path: str | None = None, hooks: list | None = None) -> dict:
    """Run (or resume) training; returns {adapters, metrics} of the last step.

    `mesh`: a `RankMesh` to train over (see the module docstring); `dataset`
    then yields this rank's slice over "data" of each global batch (the
    ranks of a "seq" line take the same slice). Sequence-parallel ring
    attention needs no argument here: call
    `ops.attention.set_ring_context(mesh, "seq")` (a `RankMesh` with a "seq"
    axis, or a one-process `Mesh`) and set `cfg.attn_impl` to "ring_pallas"
    (or "ring")."""
    if mesh is not None and mesh.axis_size("model") > 1 and getattr(pipeline.dit, "tp_size", 1) == 1:
        shard_dit_params(pipeline.dit, mesh)
    writer = RankZero(mesh)
    k_init, key = threefry.split(threefry.prng_key(cfg.seed))
    lora = lora_init(k_init, pipeline.dit, r=cfg.lora.r, alpha=cfg.lora.alpha, init=cfg.lora.init)
    adapters = lora["adapters"]
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(lora_parameters(lora))
    step_fn = make_train_step(pipeline.dit, optimizer, alpha=cfg.lora.alpha, r=cfg.lora.r,
                              latent_lora=False, attn_impl=cfg.attn_impl, mesh=mesh)

    start_step = 0
    last = latest_checkpoint(cfg.checkpoint_dir) if os.path.isdir(cfg.checkpoint_dir) else None
    if last is not None:
        restored = restore_checkpoint(cfg.checkpoint_dir, last, pipeline.device)
        with torch.no_grad():
            for name, ab in adapters.items():
                for k, t in ab.items():
                    t.copy_(restored["adapters"][name][k])
        opt_state, start_step = restored["opt_state"], last

    if position_delta is None:
        position_delta = (0, -cfg.data.condition_size // 16)
    log_path = log_path or os.path.join(cfg.checkpoint_dir, "metrics.jsonl")
    writer.write(os.makedirs, cfg.checkpoint_dir, exist_ok=True)

    data_iter = iter(dataset)
    metrics: dict = {}
    ema_loss = None
    for step in range(start_step, cfg.max_steps):
        if hasattr(dataset, "set_step"):
            dataset.set_step(step)
        t0 = time.perf_counter()
        raw = next(data_iter)
        batch = prepare_batch_tensors(pipeline, raw, position_delta)
        key, k_step = threefry.split(key)
        adapters, opt_state, metrics = step_fn(adapters, opt_state, batch, k_step)
        metrics = {k: float(v) for k, v in metrics.items()}
        ema_loss = metrics["loss"] if ema_loss is None else 0.95 * ema_loss + 0.05 * metrics["loss"]
        row = dict(metrics, step=step, ema_loss=ema_loss, step_time_s=time.perf_counter() - t0)
        writer.write(append_jsonl, log_path, row)
        for hook in hooks or []:
            hook(step, adapters, row)
        if (step + 1) % cfg.save_interval == 0 or step + 1 == cfg.max_steps:
            writer.write(save_checkpoint, cfg.checkpoint_dir, step + 1, adapters, opt_state)
    return {"adapters": adapters, "metrics": metrics}


def export_diffusers_lora(adapters: dict, path: str) -> None:
    """Write the adapters as a diffusers/peft FLUX LoRA safetensors file
    (`transformer.<module>.lora_A.weight` (r, in), `.lora_B.weight` (out, r),
    fp32), the keys `lora.convert_diffusers_lora` reads back."""
    out = {}
    for name, ab in adapters.items():
        for which in ("lora_A", "lora_B"):
            out[f"transformer.{name}.{which}.weight"] = ab[which].detach().float()
    save_file(out, path)


def make_validation_hook(pipeline, cfg, val_samples: list[dict], out_dir: str):
    """A `train` hook: every `sample_interval` steps, fold the current adapters
    into a cond view of the DiT, run the conditioned `generate` (20 steps at
    target_size) on the val conditions unsharded (`pipeline.mesh = None`, as
    JAX; a DiT cut over "model" still sums across its group), save
    `step{n}_{i:02d}.png` under `out_dir` (rank 0 alone under a process
    group), and restore `pipeline.cond_dit_params` and `pipeline.mesh`.

    val_samples rows: {"prompt": str, "condition": (H, W, 3) uint8}."""
    from ..lora.lora import make_dit_param_views
    from ..sampler.condition import Condition, cot_position_delta
    from ..search.artifacts import save_image

    def hook(step: int, adapters, metrics_row: dict) -> None:
        if (step + 1) % cfg.sample_interval != 0:
            return
        lora = {"_alpha": cfg.lora.alpha, "_r": cfg.lora.r, "adapters": adapters}
        _, cond_view = make_dit_param_views(pipeline.dit, lora, latent_lora=False)
        prev_cond, prev_mesh = pipeline.cond_dit_params, pipeline.mesh
        pipeline.cond_dit_params = cond_view
        pipeline.mesh = None
        writes = not dist.is_initialized() or dist.get_rank() == 0
        try:
            delta = cot_position_delta(cfg.data.condition_size)
            images = pipeline.generate(
                [s["prompt"] for s in val_samples],
                height=cfg.data.target_size,
                width=cfg.data.target_size,
                num_inference_steps=20,
                conditions=[Condition("cot", s["condition"], position_delta=delta)
                            for s in val_samples],
            )
            for i, img in enumerate(images):
                if writes:
                    save_image(os.path.join(out_dir, f"step{step + 1}_{i:02d}.png"), img)
        finally:
            pipeline.cond_dit_params, pipeline.mesh = prev_cond, prev_mesh

    return hook
