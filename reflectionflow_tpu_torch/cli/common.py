"""Shared CLI plumbing for the port's tts_* entry points.

Counterpart of `reflectionflow_tpu/cli/common.py`, with the same flags. The
port runs the bf16 text-to-image path; options that select later ROADMAP
slices raise `NotImplementedError` naming the slice.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config, TTSConfig
from ..ops.attention import check_impl
from ..sampler.pipeline import FluxPipeline


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--pipeline_config_path", type=str, required=True)
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=-1)
    p.add_argument("--imgpath", type=str, default="")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--meta_path", type=str, default="meta.jsonl", help="GenEval-style prompt metadata jsonl")
    p.add_argument("--prompt", type=str, default=None, help="single prompt override (skips meta_path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_weights", action="store_true",
                   help="random tiny fp32 weights on the CPU (smoke runs, no model files)")
    p.add_argument(
        "--attn_impl", type=str, default=None,
        choices=["xla", "pallas", "pallas_interpret", "pallas_nr", "pallas_nr_interpret",
                 "pallas_int8", "pallas_int8_interpret"],
        help="unset -> the config's pipeline_args.attn_impl (default xla). 'pallas' is "
        "kernel K1 on CUDA tensors; the other pallas_* impls are not ported yet",
    )
    p.add_argument("--quantize", type=str, default=None, choices=["none", "int8"],
                   help="int8 (W8A8) is not ported yet (ROADMAP slice 2)")
    p.add_argument("--phase_swap", action="store_true",
                   help="not ported: text-encoder offload is a 16 GB-device measure")
    p.add_argument("--act_quant_exclude", type=str, nargs="*", default=[],
                   help="W8A8 option; not ported yet (ROADMAP slice 2)")
    p.add_argument("--compilation_cache", type=str, default=None,
                   help="accepted for flag compatibility; PyTorch runs eagerly")
    return p


def load_config(args) -> TTSConfig:
    overrides = {}
    if args.output_dir:
        overrides["output_dir"] = args.output_dir
    return TTSConfig.load(args.pipeline_config_path, overrides)


def slice_rows(rows: list, args) -> list:
    """--start_index/--end_index window (end_index < 0 means "to the end")."""
    end = args.end_index if args.end_index >= 0 else len(rows)
    return rows[args.start_index : end]


def load_prompts(args) -> list[dict]:
    if args.prompt is not None:
        return [{"prompt": args.prompt, "tag": None}]
    rows = []
    with open(args.meta_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return slice_rows(rows, args)


def print_throughput(timer, pipe) -> None:
    """Candidate images per second of generate-phase wall time (one device)."""
    rate = timer.rate("candidates", "generate")
    if rate == rate:  # skip when no generate spans ran
        print(f"candidates/sec/chip: {rate:.4f} ({timer.counts['candidates']} candidates, 1 chip(s))")


def load_pipeline(cfg: TTSConfig, args) -> FluxPipeline:
    pa = cfg.pipeline_args
    cli_quant = getattr(args, "quantize", None)
    quantize = pa.quantize if cli_quant is None else (None if cli_quant == "none" else cli_quant)
    if quantize is not None:
        raise NotImplementedError(f"quantize={quantize!r} (W8A8 DiT, int8/NF4 T5) is ROADMAP slice 2")
    if getattr(args, "phase_swap", False):
        raise NotImplementedError("--phase_swap offloads text encoders for 16 GB devices; "
                                  "it is on the ROADMAP's do-not-port list")
    if pa.vae_tiling:
        raise NotImplementedError("vae_tiling (vae_decode_tiled) is ROADMAP slice 1, item 8")
    if pa.vcache:
        raise NotImplementedError("the velocity cache is ROADMAP slice 5, item 20")
    attn_impl = args.attn_impl or pa.attn_impl or "xla"
    check_impl(attn_impl)
    if pa.lora_path and not args.synthetic_weights:
        raise NotImplementedError("LoRA adapters (lora_path) are ROADMAP slice 3, item 15")
    if not args.synthetic_weights:
        raise NotImplementedError(
            "loading published weights (FluxPipeline.from_pretrained) is ROADMAP slice 1, "
            "item 9; use --synthetic_weights")
    pipe = FluxPipeline.random_init(
        torch.Generator().manual_seed(0),
        dit_cfg=FluxDiTConfig.tiny(),
        vae_cfg=FluxVAEConfig.tiny(),
        t5_cfg=T5Config.tiny(),
        clip_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
    )
    pipe.attn_impl = attn_impl
    return pipe
