"""Noise + prompt scaling CLI of the PyTorch port.

Usage, as the JAX package's `reflectionflow_tpu.cli.tts_t2i_noise_prompt_scaling`:
  python -m reflectionflow_tpu_torch.cli.tts_t2i_noise_prompt_scaling \
      --pipeline_config_path configs/flux.1_dev_fake.json \
      --meta_path geneval/evaluation_metadata.jsonl --output_dir out/ \
      --synthetic_weights
"""

from __future__ import annotations

from ..search.noise_prompt_scaling import run_noise_prompt_scaling
from ..utils.timing import PhaseTimer
from .common import (
    build_parser,
    build_refiner,
    build_verifier,
    load_config,
    load_pipeline,
    load_prompts,
    print_throughput,
)


def main(argv=None):
    args = build_parser(__doc__).parse_args(argv)
    cfg = load_config(args)
    prompts = load_prompts(args)
    verifier = build_verifier(cfg, device=args.device)
    refiner = build_refiner(cfg)
    pipe = load_pipeline(cfg, args, rewrites_prompts=cfg.prompt_refiner_args.run_refinement)
    timer = PhaseTimer()
    run_noise_prompt_scaling(
        pipe, verifier, refiner, cfg, prompts, cfg.output_dir,
        start_index=args.start_index, run_seed=args.seed, timer=timer,
    )
    print(timer.summary())
    print_throughput(timer, pipe)


if __name__ == "__main__":
    main()
