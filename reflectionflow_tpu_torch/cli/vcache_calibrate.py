"""Velocity-cache calibration CLI of the PyTorch port.

Counterpart of the JAX package's `tools/vcache_calibrate.py`, with its flags
plus `--device`: sweeps skip schedules against the dense trajectory
(`sampler/vcache_calibrate.py`) and writes the selection and its evidence to
`--out`, which is required (the JAX package's own record,
docs/VCACHE_CALIBRATION.json, is never written from here).

Modes:
  * --synthetic_weights: the tiny fp32 random pipeline and the fake
    verifier; with --device cpu it runs anywhere (weights_kind "synthetic");
  * --synthetic_weights --synthetic_scale full: FLUX.1-dev at full width and
    depth, random weights, in the serving formats (W8A8 DiT, NF4 T5, "pallas"
    attention) on the card: the mechanics and the wall-clock at scale;
  * --model_dir (or $FLUX_MODEL_DIR): a local diffusers snapshot, optionally
    in the int8 serving profile, with a model verifier (weights_kind "real").

Usage:
  python -m reflectionflow_tpu_torch.cli.vcache_calibrate --synthetic_weights --device cpu --out cal.json
  python -m reflectionflow_tpu_torch.cli.vcache_calibrate --model_dir /ckpts/flux --quantize int8 \\
      --verifier qwen_rm --verifier_model_path /ckpts/qwen --prompts 8 --out cal.json
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
from ..sampler.pipeline import FluxPipeline
from ..sampler.vcache_calibrate import calibrate, save_calibration
from ..verifiers import load_verifier
from .common import add_device_arg, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic_weights", action="store_true",
                   help="random weights (tiny fp32 unless --synthetic_scale full) + the fake verifier")
    p.add_argument("--synthetic_scale", default="tiny", choices=["tiny", "full"],
                   help="with --synthetic_weights: 'full' builds FLUX.1-dev at full size in the serving "
                   "formats (W8A8 DiT, NF4 T5) on the card")
    p.add_argument("--model_dir", default=os.environ.get("FLUX_MODEL_DIR"))
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: the CLIs' int8 serving profile (W8A8 DiT + w8a16 T5)")
    p.add_argument("--verifier", default="fake",
                   choices=["fake", "nvila_jax", "qwen_rm", "openai", "none"])
    p.add_argument("--verifier_model_path", default=None)
    p.add_argument("--prompts", type=int, default=4, help="number of GenEval prompts to calibrate on")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps_score", type=float, default=0.25,
                   help="max allowed mean-score drop (verifier scale)")
    p.add_argument("--max_latent_rel_err", type=float, default=0.35)
    p.add_argument("--out", required=True, help="where the calibration JSON is written")
    add_device_arg(p)
    return p


def geneval_prompts(n: int) -> list[str]:
    """The first `n` prompts of the repository's configs/geneval_metadata.jsonl."""
    prompts = []
    with open(os.path.join(REPO, "configs", "geneval_metadata.jsonl")) as f:
        for line in f:
            prompts.append(json.loads(line)["prompt"])
            if len(prompts) >= n:
                break
    return prompts


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.synthetic_weights and args.synthetic_scale == "full":
        # the serving formats at full size: W8A8 DiT in the split layout, NF4 T5
        pipe = FluxPipeline.random_init(gen, dtype=torch.bfloat16, device=device)
        pipe.quantize(int4=("t5",))
        pipe.attn_impl = "pallas"
        size, steps, weights_kind = 1024, 30, "synthetic"
    elif args.synthetic_weights:
        pipe = FluxPipeline.random_init(gen, dit_cfg=FluxDiTConfig.tiny(), vae_cfg=FluxVAEConfig.tiny(),
                                        t5_cfg=T5Config.tiny(), clip_cfg=CLIPTextConfig.tiny(),
                                        dtype=torch.float32, device=device)
        size, steps, weights_kind = 16, 8, "synthetic"
    else:
        if not args.model_dir:
            raise SystemExit("--model_dir (or $FLUX_MODEL_DIR) required without --synthetic_weights")
        pipe = FluxPipeline.from_pretrained(args.model_dir, device=device)
        if args.quantize == "int8":
            pipe.quantize(int4=(), weight_only=("t5",))
        size, steps, weights_kind = 1024, 30, "real"

    verifier = verifier_name = None
    if args.verifier != "none":
        kw = {}
        if args.verifier_model_path:
            kw["model_path"] = args.verifier_model_path
        if args.verifier in ("nvila_jax", "qwen_rm"):
            kw["device"] = args.device
        verifier = load_verifier(args.verifier, **kw)
        verifier_name = args.verifier

    result = calibrate(
        pipe, geneval_prompts(args.prompts), verifier=verifier, height=args.height or size,
        width=args.width or size, num_steps=args.steps or steps, guidance_scale=args.guidance_scale,
        seed=args.seed, eps_score=args.eps_score, max_latent_rel_err=args.max_latent_rel_err,
    )
    save_calibration(args.out, result, weights_kind, verifier_name)
    print(json.dumps({"selected": result["selected"], "selected_vcache": result["selected_vcache"],
                      "weights_kind": weights_kind, "results": result["results"], "out": args.out}))
    return result


if __name__ == "__main__":
    main()
