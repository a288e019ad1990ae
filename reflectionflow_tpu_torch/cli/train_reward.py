"""Image-Verifier (reward model) training CLI of the PyTorch port.

Usage, as the JAX package's `reflectionflow_tpu.cli.train_reward`, plus `--device`:
  python -m reflectionflow_tpu_torch.cli.train_reward --meta_data rows.jsonl \
      --output_dir out [--model_name_or_path <Qwen2.5-VL snapshot> | --synthetic_weights] \
      [--quantize_base int8|nf4] [--vision_lora] [--device cpu]

GSB comparison rows (csv, jsonl or json; images as PNG paths under
`--data_dir`) -> a seeded held-out split -> the pairwise A/B train loop
(`rm_train.train.make_rm_train_step`) -> `metrics.jsonl`, a checkpoint
`checkpoint-N` every `--save_epochs` (adapters, head and special row in the
JAX package's layout, with the optimizer state beside them), pairwise
accuracy on the held-out rows, and `final_model` with the training rewards'
mean and std as `VQ_mean` / `VQ_std`: the directory `QwenRewardVerifier`
reads in both packages. `--resume_from checkpoint-N` continues the run (the
checkpoint's lora_r / lora_alpha win). `--synthetic_weights` trains a tiny
random fp32 Qwen2.5-VL. `--device` (default cuda) raises when CUDA is
missing.

`--fsdp_devices N` trains over a "data" mesh of N ranks, one process a
device, as the JAX CLI's FSDP mesh of N devices: the frozen base sharded and
gathered on use, each step's `--per_device_train_batch_size` rows (the
global batch, as in JAX) split over the ranks, rank 0 writing. Under
torchrun (`torchrun --nproc_per_node N -m
reflectionflow_tpu_torch.cli.train_reward --fsdp_devices N ...`) each
process joins the group; otherwise the CLI spawns the N ranks on this host
(`--device cuda`: rank i on cuda:i; `cpu`: gloo ranks on the CPU). A world of
another size raises ValueError.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from .common import add_device_arg, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    # DataConfig
    p.add_argument("--meta_data", type=str, required=True, help="GSB csv or jsonl of comparison rows")
    p.add_argument("--data_dir", type=str, default="", help="image root prefix")
    p.add_argument("--max_pixels", type=int, default=448 * 448)
    p.add_argument("--use_tied_data", action="store_true", default=True)
    p.add_argument("--no_tied_data", dest="use_tied_data", action="store_false")
    # ModelConfig
    p.add_argument("--model_name_or_path", type=str, default=None)
    p.add_argument("--output_dim", type=int, default=1)
    p.add_argument("--reward_token", type=str, default="special", choices=["last", "mean", "special"])
    p.add_argument("--use_special_tokens", action="store_true", default=True)
    p.add_argument("--loss_type", type=str, default="btt",
                   choices=["bt", "reg", "btt", "margin", "constant_margin", "scaled"])
    # PEFTLoraConfig
    p.add_argument("--lora_r", type=int, default=16)
    p.add_argument("--lora_alpha", type=float, default=32.0)
    p.add_argument("--quantize_base", type=str, default=None, choices=["int8", "nf4"],
                   help="store the frozen base blocks quantized, weight-only (int8 w8a16 or NF4 "
                        "w4a16; the product stays float, so gradients reach every adapter)")
    p.add_argument("--vision_lora", action="store_true",
                   help="also LoRA the vision tower (trains on raw patches at one fixed square grid per run)")
    # TrainingConfig
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--special_token_lr", type=float, default=None)
    p.add_argument("--head_lr", type=float, default=None)
    p.add_argument("--vision_lr", type=float, default=None, help="LR for the vision-tower adapters")
    p.add_argument("--merger_lr", type=float, default=None, help="LR for the patch-merger adapters")
    p.add_argument("--fsdp_devices", type=int, default=0,
                   help=">0: shard the frozen base over a \"data\" mesh of this many ranks (FSDP)")
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--per_device_train_batch_size", type=int, default=2)
    p.add_argument("--save_epochs", type=float, default=1.0)
    p.add_argument("--conduct_eval", action="store_true", default=True)
    p.add_argument("--eval_fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume_from", type=str, default=None,
                   help="checkpoint dir (checkpoint-N/final_model) to resume weights + optimizer from")
    p.add_argument("--synthetic_weights", action="store_true",
                   help="tiny random base model (hermetic smoke runs)")
    add_device_arg(p)
    return p


def load_rows(meta_data: str, data_dir: str) -> list[dict]:
    from ..rm_train.data import convert_gsb_csv
    from ..utils.jsonl import iter_jsonl

    if meta_data.endswith(".csv"):
        return convert_gsb_csv(meta_data, data_dir)
    if meta_data.endswith(".jsonl"):
        rows = list(iter_jsonl(meta_data))
    else:
        with open(meta_data) as f:
            rows = json.load(f)
    for r in rows:
        for side in ("image_A", "image_B"):
            if data_dir and isinstance(r.get(side), str):
                r[side] = os.path.join(data_dir, r[side])
    return rows


def pairwise_accuracy(rw_A: np.ndarray, rw_B: np.ndarray, labels: np.ndarray) -> float:
    """Fraction of untied pairs ranked consistently with the GSB label."""
    untied = np.abs(labels) == 1
    if not untied.any():
        return float("nan")
    pred_a_better = (rw_A > rw_B)[untied]
    return float(np.mean(pred_a_better == (labels[untied] == 1)))


def build_model(args, device: torch.device):
    """-> (QwenVLModel, tokenizer or None): the tiny random fp32 model of
    `--synthetic_weights` (seeded by `--seed`), else the snapshot."""
    from ..models.qwen_vl.model import QwenVLModel

    if args.synthetic_weights:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return QwenVLModel.random_init(gen, dtype=torch.float32, device=device), None
    if args.model_name_or_path is None:
        raise ValueError("--model_name_or_path (a Qwen2.5-VL snapshot) or --synthetic_weights is required")
    from ..utils.hf_loader import load_qwen_vl

    return load_qwen_vl(args.model_name_or_path, device=device)


def init_trainable(model, args, device: torch.device) -> dict:
    """Fresh adapters (B = 0) on the LM (and the tower under `--vision_lora`),
    rm_head and the special row ~ N(0, 0.02^2), fp32, drawn from `--seed`."""
    from ..rm_train.train import rm_lora_init, rm_vision_lora_init

    gen = torch.Generator(device=device).manual_seed(args.seed)
    H = model.lm_cfg.hidden_size
    trainable = {
        "lora": rm_lora_init(gen, model.model, r=args.lora_r, alpha=args.lora_alpha)["adapters"],
        "rm_head": torch.randn((H, args.output_dim), generator=gen, device=device) * 0.02,
        "special": torch.randn((H,), generator=gen, device=device) * 0.02,
    }
    if args.vision_lora:
        trainable["vision_lora"] = rm_vision_lora_init(gen, model.visual, r=args.lora_r,
                                                       alpha=args.lora_alpha)["adapters"]
    return trainable


@torch.no_grad()
def _resume(trainable: dict, resumed: dict) -> None:
    """Copy a loaded checkpoint (the JAX layout) into the trainable tensors in place."""
    from ..lora.lora import qwen_adapters_from_jax

    for key, value in resumed.items():
        if key in ("lora", "vision_lora"):
            for name, ab in qwen_adapters_from_jax(value, tower=key == "vision_lora").items():
                for k in ("lora_A", "lora_B"):
                    trainable[key][name][k].copy_(ab[k])
        else:
            trainable[key].copy_(value)


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.fsdp_devices > 0 and not dist.is_initialized():
        from ..parallel.distributed import init_distributed, launch

        if "WORLD_SIZE" in os.environ:  # torchrun
            init_distributed(device=args.device)
        elif args.fsdp_devices > 1:
            import tempfile

            from ..parallel.dryrun import file_init

            with tempfile.TemporaryDirectory() as td:
                return launch(_rank_main, args.fsdp_devices, args=(argv,), device=args.device,
                              init_method=file_init(td), timeout=7 * 86400.0)[0]
    return _run(args)


def _rank_main(device, argv):
    return _run(build_parser().parse_args(argv), device)


def _run(args, device=None):
    from ..parallel.distributed import RankZero

    device = device or resolve_device(args.device)
    mesh = None
    if args.fsdp_devices > 0:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != args.fsdp_devices:
            raise ValueError(f"--fsdp_devices {args.fsdp_devices}, but the process group has {world} ranks")
        if device.type == "cuda" and dist.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        if args.per_device_train_batch_size % world:
            raise ValueError(f"--per_device_train_batch_size {args.per_device_train_batch_size} (the global "
                             f"batch) does not divide by --fsdp_devices {world}")
        if world > 1:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh((world,), ("data",))
    writer = RankZero(mesh)
    say = print if writer.is_writer else (lambda *a, **k: None)

    from ..rm_train.data import collate_rm_batch, vision_train_geometry
    from ..rm_train.train import (apply_vision_lora_embeds, load_rm_checkpoint, load_rm_opt_state,
                                  make_rm_optimizer, make_rm_train_step, rm_forward_rewards, save_rm_checkpoint,
                                  save_rm_opt_state)
    from ..utils.jsonl import append_jsonl

    rng = np.random.default_rng(args.seed)
    model, tokenizer = build_model(args, device)

    rows = load_rows(args.meta_data, args.data_dir)
    if not args.use_tied_data:
        rows = [r for r in rows if r.get("gsb", "S") in ("G", "B") or r.get("chosen_label") in (1, -1)]
    order = rng.permutation(len(rows))
    n_eval = int(len(rows) * args.eval_fraction) if args.conduct_eval else 0
    eval_rows = [rows[i] for i in order[:n_eval]]
    train_rows = [rows[i] for i in order[n_eval:]]
    if not train_rows:
        raise SystemExit("no training rows after split")

    if args.resume_from:
        # the checkpoint's LoRA geometry wins: another alpha / r would rescale the adapters
        with open(os.path.join(args.resume_from, "model_config.json")) as f:
            ck = json.load(f)
        if (ck.get("lora_r"), ck.get("lora_alpha")) != (args.lora_r, args.lora_alpha):
            say(f"resume: overriding lora_r/alpha {args.lora_r}/{args.lora_alpha} "
                  f"-> checkpoint {ck['lora_r']}/{ck['lora_alpha']}")
            args.lora_r = int(ck["lora_r"])
            args.lora_alpha = float(ck["lora_alpha"])

    special_token_id = model.lm_cfg.vocab_size - 1 if args.use_special_tokens else None
    pooling = args.reward_token if args.reward_token != "special" or special_token_id is not None else "last"
    trainable = init_trainable(model, args, device)
    optimizer = make_rm_optimizer(lr=args.learning_rate, head_lr=args.head_lr, special_lr=args.special_token_lr,
                                  vision_lr=args.vision_lr, merger_lr=args.merger_lr)
    opt_state = optimizer.init(trainable)
    start_step = 0
    if args.resume_from:
        resumed, _cfg = load_rm_checkpoint(args.resume_from)
        _resume(trainable, resumed)
        opt_state = load_rm_opt_state(args.resume_from, opt_state, trainable)
        m = re.search(r"checkpoint-(\d+)", args.resume_from)
        start_step = int(m.group(1)) if m else 0
        # continue the data stream, don't replay it
        rng = np.random.default_rng(args.seed + start_step)
        say(f"resumed from {args.resume_from} at step {start_step}")
    grid_thw = vision_train_geometry(model.vis_cfg, args.max_pixels)[1] if args.vision_lora else None
    step_fn = make_rm_train_step(
        model.model, optimizer, loss_type=args.loss_type, pooling=pooling, special_token_id=special_token_id,
        alpha=args.lora_alpha, r=args.lora_r, tower=model.visual if args.vision_lora else None,
        grid_thw=grid_thw, quantize_base=args.quantize_base, mesh=mesh)

    writer.write(os.makedirs, args.output_dir, exist_ok=True)
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    bs = args.per_device_train_batch_size
    steps_per_epoch = max(1, len(train_rows) // bs)
    total_steps = max(1, int(args.num_train_epochs * steps_per_epoch))
    save_every = max(1, int(args.save_epochs * steps_per_epoch))

    def collate(rows_chunk):
        return collate_rm_batch(model, rows_chunk, tokenizer=tokenizer, max_pixels=args.max_pixels,
                                special_token_id=special_token_id, train_vision=args.vision_lora)

    all_rewards: list[float] = []
    # a resume finishes the original schedule: steps already done count toward total_steps
    step = start_step
    t0 = time.time()
    while step < total_steps:
        epoch_order = rng.permutation(len(train_rows))
        for b0 in range(0, steps_per_epoch * bs, bs):
            if step >= total_steps:
                break
            batch = collate([train_rows[i] for i in epoch_order[b0 : b0 + bs]])
            trainable, opt_state, aux = step_fn(trainable, opt_state, batch)
            step += 1
            all_rewards.extend(aux["rewards_A"].float().cpu().ravel().tolist())
            all_rewards.extend(aux["rewards_B"].float().cpu().ravel().tolist())
            rec = {"step": step, "loss": float(aux["loss"]), "elapsed_s": round(time.time() - t0, 2)}
            writer.write(append_jsonl, metrics_path, rec)
            say(f"step {step}/{total_steps} loss={rec['loss']:.4f}")
            if step % save_every == 0 or step == total_steps:
                ckpt = os.path.join(args.output_dir, f"checkpoint-{step}")
                writer.write(save_rm_checkpoint, ckpt, trainable, pooling, special_token_id,
                             lora_alpha=args.lora_alpha, lora_r=args.lora_r)
                writer.write(save_rm_opt_state, ckpt, opt_state, trainable)

    # held-out pairwise accuracy
    if eval_rows:
        accs = []
        with torch.no_grad():
            for b0 in range(0, len(eval_rows), bs):
                batch = collate(eval_rows[b0 : b0 + bs])
                rw = {}
                for side in ("A", "B"):
                    emb = batch[f"embeds_{side}"]
                    if args.vision_lora:
                        emb = apply_vision_lora_embeds(trainable, model.visual, emb, batch[f"patches_{side}"],
                                                       grid_thw, args.lora_alpha, args.lora_r)
                    rw[side] = rm_forward_rewards(trainable, model.model, emb, batch[f"pos_{side}"],
                                                  batch[f"mask_{side}"], batch[f"ids_{side}"], pooling,
                                                  special_token_id, args.lora_alpha, args.lora_r)
                acc = pairwise_accuracy(rw["A"][:, 0].float().cpu().numpy(), rw["B"][:, 0].float().cpu().numpy(),
                                        batch["chosen_label"][:, 0].cpu().numpy())
                if not np.isnan(acc):
                    accs.append(acc)
        eval_acc = float(np.mean(accs)) if accs else None
        writer.write(append_jsonl, metrics_path, {"eval_pairwise_accuracy": eval_acc})
        say(f"eval pairwise accuracy: {eval_acc}")

    # final_model with the z-norm statistics of the training rewards (the verifier's normalisation)
    vq_mean = float(np.mean(all_rewards)) if all_rewards else 0.0
    vq_std = float(np.std(all_rewards) + 1e-6) if all_rewards else 1.0
    final = os.path.join(args.output_dir, "final_model")
    writer.write(save_rm_checkpoint, final, trainable, pooling, special_token_id, vq_mean=vq_mean,
                 vq_std=vq_std, lora_alpha=args.lora_alpha, lora_r=args.lora_r)
    say(f"saved {final} (VQ_mean={vq_mean:.4f}, VQ_std={vq_std:.4f})")
    return final


if __name__ == "__main__":
    main()
