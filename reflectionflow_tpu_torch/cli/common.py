"""Shared CLI plumbing for the port's tts_* entry points.

Counterpart of `reflectionflow_tpu/cli/common.py`, with the same flags. The
port runs the bf16 text-to-image path and, with `--quantize int8`, the W8A8
serving profile (or, by `pipeline_args.dit_quant` / `t5_quant`, its NF4
co-residency profiles), with or without the corrector's condition stream and
the velocity cache (`pipeline_args.vcache`), and builds the search loops'
verifier, reflector and refiner from the config; options that select later
ROADMAP slices raise `NotImplementedError` naming the slice.

The pipeline is `FluxPipeline.from_pretrained` of the config's
`pretrained_model_name_or_path`, a local diffusers snapshot, or with
`--synthetic_weights` the JAX recipe of tiny fp32 random weights.
`--device` (default `cuda`) picks where the pipeline and the colocated
verifier and reflector are built and run; when CUDA is missing the CLI raises
unless `--device cpu` was given, and never falls back. On the card, fp32 with
`--attn_impl pallas` raises K1's dtype error (the kernels take bf16), as any
non-bf16 input does.

One divergence: the int8 profile keeps T5 resident and does not phase-swap it
(the JAX package offloads it to fit a 16 GB chip; the card has 80 GB), with
the prompt-embedding cache on, as JAX's co-resident profile has it. That
changes memory orchestration only, never outputs.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config, TTSConfig
from ..ops.attention import check_impl
from ..reflect import load_reflector, load_refiner
from ..sampler.pipeline import FluxPipeline
from ..verifiers import load_verifier


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="where the pipeline runs: cuda (default; raises when CUDA is missing) "
                   "or cpu")


def resolve_device(name: str) -> torch.device:
    """`--device` -> torch.device; a CUDA device without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda[:N] or cpu")
    return device


def synthetic_pipeline(device: torch.device) -> FluxPipeline:
    """The tiny fp32 pipeline of `--synthetic_weights`, seeded, on `device`."""
    return FluxPipeline.random_init(
        torch.Generator(device=device).manual_seed(0),
        dit_cfg=FluxDiTConfig.tiny(),
        vae_cfg=FluxVAEConfig.tiny(),
        t5_cfg=T5Config.tiny(),
        clip_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32,
        device=device,
    )


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
                   help="random tiny fp32 weights (smoke runs, no model files)")
    add_device_arg(p)
    p.add_argument(
        "--attn_impl", type=str, default=None,
        choices=["xla", "pallas", "pallas_interpret", "pallas_nr", "pallas_nr_interpret",
                 "pallas_int8", "pallas_int8_interpret"],
        help="unset -> the config's pipeline_args.attn_impl (default xla). On CUDA tensors "
        "'pallas' is kernel K1, 'pallas_int8' K8 (int8 QK^T), and 'pallas_nr' K9 (QK-norm + "
        "RoPE inside the attention) in the --quantize int8 split layout and K1 otherwise; "
        "the *_interpret impls have no CUDA counterpart and raise",
    )
    p.add_argument("--quantize", type=str, default=None, choices=["none", "int8"],
                   help="int8: W8A8 DiT in the fused split-RoPE serving layout + w8a16 T5 (NF4 "
                   "MLPs and T5 by pipeline_args.dit_quant/t5_quant); "
                   "unset -> the config's pipeline_args.quantize; none turns it off")
    p.add_argument("--phase_swap", action="store_true",
                   help="not ported: text-encoder offload is a 16 GB-device measure")
    p.add_argument("--act_quant_exclude", type=str, nargs="*", default=[],
                   help="JAX tree-path substrings (e.g. _mod) of DiT linears kept weight-only "
                   "int8 (w8a16) under --quantize int8")
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
    """Candidate images per second per chip of generate-phase wall time: the
    data axis of `pipe.mesh` is the chip count (each candidate runs on one
    data slice)."""
    rate = timer.rate("candidates", "generate")
    if rate == rate:  # skip when no generate spans ran
        mesh = getattr(pipe, "mesh", None)
        n_chips = mesh.shape.get("data", 1) if mesh is not None else 1
        print(f"candidates/sec/chip: {rate / n_chips:.4f} ({timer.counts['candidates']} candidates, "
              f"{n_chips} chip(s))")


def _int8_profile(pa) -> tuple[str, bool]:
    """The int8 serving profile's T5 mode ("int8" w8a16 or "int4" NF4) and
    whether the DiT's MLPs go NF4, from t5_quant/dit_quant with the JAX CLI's
    defaults and errors."""
    t5_mode, dit_mode = pa.t5_quant, pa.dit_quant
    if t5_mode not in (None, "int4", "int8"):
        raise ValueError(
            f"pipeline_args.t5_quant={t5_mode!r}: expected 'int8' (w8a16, "
            "phase-swap fast encode) or 'int4' (packed NF4, co-residency)")
    if dit_mode not in ("int8", "int8_int4mlp"):
        raise ValueError(
            f"pipeline_args.dit_quant={dit_mode!r}: expected 'int8' (full "
            "W8A8 + phase swap) or 'int8_int4mlp' (NF4 MLP co-residency)")
    int4mlp = dit_mode == "int8_int4mlp"
    if int4mlp and t5_mode == "int8":
        raise ValueError(
            "pipeline_args.t5_quant='int8' cannot combine with "
            "dit_quant='int8_int4mlp': the 4.8 GB w8a16 T5 does not "
            "co-reside with the DiT on 16 GB — use t5_quant='int4' or "
            "leave it unset")
    if t5_mode is None:  # the profile's default: NF4 T5 beside NF4 MLPs, else w8a16
        t5_mode = "int4" if int4mlp else "int8"
    return t5_mode, int4mlp


def apply_lora_path(pipe: FluxPipeline, cfg: TTSConfig, args) -> None:
    """`pipeline_args.lora_path`: a diffusers-peft FLUX LoRA file (read by
    `utils/safetensors_io.py`) folded into the cond stream's model,
    `pipe.cond_dit_params`; the main stream keeps the base weights. Skipped
    under --synthetic_weights, as in the JAX CLI (random tiny weights match
    no published adapter). Call it before `quantize`."""
    path = cfg.pipeline_args.lora_path
    if not path or args.synthetic_weights:
        return
    from ..lora.lora import convert_diffusers_lora, make_dit_param_views
    from ..utils.safetensors_io import load_file

    lora = convert_diffusers_lora(load_file(path))
    pipe.dit, pipe.cond_dit_params = make_dit_param_views(pipe.dit, lora, latent_lora=False)


def load_pipeline(cfg: TTSConfig, args, rewrites_prompts: bool = False) -> FluxPipeline:
    """`rewrites_prompts` (the loop re-encodes changed prompts every round) is
    the JAX signature's: there it flags the phase-swap profile, which the port
    does not have, so here it changes nothing."""
    pa = cfg.pipeline_args
    device = resolve_device(args.device)
    cli_quant = getattr(args, "quantize", None)
    quantize = pa.quantize if cli_quant is None else (None if cli_quant == "none" else cli_quant)
    if quantize == "int8":
        t5_mode, int4mlp = _int8_profile(pa)
    elif cli_quant is None and (pa.t5_quant or pa.dit_quant != "int8"):
        # the quant fields only act under quantize="int8": set without it, the
        # profile is misconfigured; an explicit --quantize none is allowed
        raise ValueError(
            f"pipeline_args sets t5_quant={pa.t5_quant!r} / dit_quant={pa.dit_quant!r} but "
            f"quantization is disabled (quantize={quantize!r}) — set pipeline_args.quantize="
            "'int8' or remove the quant fields (use --quantize none to force a bf16 run)")
    if getattr(args, "phase_swap", False):
        raise NotImplementedError("--phase_swap offloads text encoders for 16 GB devices; "
                                  "it is on the ROADMAP's do-not-port list")
    attn_impl = args.attn_impl or pa.attn_impl or "xla"
    check_impl(attn_impl)
    if args.synthetic_weights:
        pipe = synthetic_pipeline(device)
    else:
        pipe = FluxPipeline.from_pretrained(cfg.pretrained_model_name_or_path, dtype=pa.dtype, device=device)
    pipe.attn_impl = attn_impl
    pipe.vae_tiling = pa.vae_tiling
    pipe.vcache = pa.vcache
    pipe.model_flags = {"union_cond_attn": cfg.model.union_cond_attn,
                        "add_cond_attn": cfg.model.add_cond_attn}
    apply_lora_path(pipe, cfg, args)  # before quantize: the fold needs float weights
    if quantize == "int8":
        # the JAX int8 profiles; T5 stays resident (no phase swap)
        pipe.quantize(act_quant_exclude=tuple(getattr(args, "act_quant_exclude", None) or ()),
                      int4=("t5",) if t5_mode == "int4" else (),
                      weight_only=("t5",) if t5_mode == "int8" else (), dit_int4_mlp=int4mlp)
        # co-resident profile: no swap, but each prompt is encoded once
        pipe.enable_prompt_cache()
    return pipe


def build_verifier(cfg: TTSConfig, device: str | None = None):
    """The config's verifier; `qwen_rm` / `image_verifier` and `nvila_jax` load
    `verifier_args.model_path` on `device` (or cuda:`device_index`), `nvila`
    the local hub snapshot of `verifier_args.model_name` (under `cache_dir`)
    on `device`, at full precision whatever `quantize` says, as in JAX."""
    va = cfg.verifier_args
    kw = {}
    if va.name == "openai":
        kw = dict(
            verifier_prompt=va.verifier_prompt_relpath,
            refine_prompt=va.refine_prompt_relpath,
            reflexion_prompt=va.reflexion_prompt_relpath,
            max_workers=va.max_workers,
        )
        if va.model_name:
            kw["model_name"] = va.model_name
        if va.base_url:
            kw["base_url"] = va.base_url
    elif va.name in ("qwen_rm", "image_verifier"):
        kw = dict(model_path=va.model_path, device=device)
        if va.quantize:
            kw["quantize"] = va.quantize
        if va.device_index is not None:
            kw["device_index"] = va.device_index
    elif va.name == "nvila":  # as JAX: the hub name and cache only, never quantize or device_index
        kw = dict(device=device)
        if va.model_name:
            kw["model_name"] = va.model_name
        if va.cache_dir:
            kw["cache_dir"] = va.cache_dir
    elif va.name == "nvila_jax":
        kw = dict(model_path=va.model_path, device=device)
        if va.quantize:
            kw["quantize"] = va.quantize
        if va.device_index is not None:
            kw["device_index"] = va.device_index
    return load_verifier(va.name, **kw)


def build_reflector(cfg: TTSConfig, device: str | None = None):
    """None without run_reflection; `local_qwen` loads `reflection_args.model_path`
    (else the verifier's) on `device` (or cuda:`device_index`); any other
    backend name than openai gets the fake reflector, as in JAX."""
    ra = cfg.reflection_args
    if not ra.run_reflection:
        return None
    if ra.backend == "openai":
        kw = {"max_retries": ra.max_retries, "retry_delay_s": ra.retry_delay_s}
        if ra.base_url:
            kw["base_url"] = ra.base_url
        if ra.model_name:
            kw["model_name"] = ra.model_name
        return load_reflector("openai", **kw)
    if ra.backend == "local_qwen":
        from ..models.qwen_vl import load_generator

        return load_reflector(
            "local_qwen",
            model=load_generator(ra.model_path or cfg.verifier_args.model_path, quantize=ra.quantize,
                                 device_index=ra.device_index, device=device),
            template=ra.template,
            system=ra.system_prompt,
        )
    return load_reflector("fake")


def build_refiner(cfg: TTSConfig):
    pr = cfg.prompt_refiner_args
    if not pr.run_refinement:
        return None
    if pr.backend == "openai":
        kw = {}
        if pr.base_url:
            kw["base_url"] = pr.base_url
        if pr.model_name:
            kw["model_name"] = pr.model_name
        return load_refiner("openai", **kw)
    return load_refiner("fake")
