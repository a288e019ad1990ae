"""Full ReflectionFlow CLI of the PyTorch port.

Usage, as the JAX package's `reflectionflow_tpu.cli.tts_reflectionflow`:
consumes a stage-1 output directory via --imgpath (round-0 candidates per
prompt) or bootstraps round 0 itself when --imgpath is omitted:
  python -m reflectionflow_tpu_torch.cli.tts_reflectionflow \
      --pipeline_config_path configs/flux.1_dev_fake.json \
      --meta_path geneval/evaluation_metadata.jsonl --output_dir out/ \
      --synthetic_weights
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os

from ..search.reflectionflow import run_reflectionflow_block, run_reflectionflow_prompt
from ..utils.timing import PhaseTimer
from .common import (
    build_parser,
    build_refiner,
    build_reflector,
    build_verifier,
    load_config,
    load_pipeline,
    load_prompts,
    print_throughput,
)


def stage1_round0(imgpath: str, prompt_index: int) -> list[str] | None:
    if not imgpath:
        return None
    d = os.path.join(imgpath, f"{prompt_index:05d}", "samples")
    # all stage-1 candidates (every round) form the round-0 parent pool
    imgs = sorted(glob.glob(os.path.join(d, "*_round@*.png")))
    return imgs or None


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument(
        "--prompt_block", type=int, default=1,
        help="prompts run in lockstep per round; their candidates share one batched "
        "generate (block x branch candidates, micro-batched to batch_size_for_img_gen)",
    )
    parser.add_argument(
        "--parallel_blocks", type=int, default=1,
        help="blocks processed concurrently in threads: one block's host stages "
        "(verify/reflect/refine via API) overlap another block's generation",
    )
    args = parser.parse_args(argv)
    cfg = load_config(args)
    prompts = load_prompts(args)
    # the models behind the host stages first: an unported one raises before the
    # pipeline is built
    verifier = build_verifier(cfg, device=args.device)
    reflector = build_reflector(cfg, device=args.device)
    refiner = build_refiner(cfg)
    pipe = load_pipeline(
        cfg, args,
        rewrites_prompts=cfg.prompt_refiner_args.run_refinement
        or cfg.reflection_args.run_reflection,
    )
    timer = PhaseTimer()
    if args.prompt_block > 1 or args.parallel_blocks > 1:
        def run_block(c0):
            block = prompts[c0 : c0 + args.prompt_block]
            run_reflectionflow_block(
                pipe, verifier, reflector, refiner, cfg, block, cfg.output_dir,
                start_index=args.start_index + c0,
                round0_images_fn=lambda idx: stage1_round0(args.imgpath, idx),
                run_seed=args.seed, timer=timer,
            )

        starts = list(range(0, len(prompts), args.prompt_block))
        if args.parallel_blocks > 1:
            with cf.ThreadPoolExecutor(max_workers=args.parallel_blocks) as ex:
                list(ex.map(run_block, starts))
        else:
            for c0 in starts:
                run_block(c0)
    else:
        for offset, row in enumerate(prompts):
            idx = args.start_index + offset
            prompt = row["prompt"] if isinstance(row, dict) else row
            tag = row.get("tag") if isinstance(row, dict) else None
            run_reflectionflow_prompt(
                pipe, verifier, reflector, refiner, cfg,
                prompt_index=idx, original_prompt=prompt, tag=tag,
                output_root=cfg.output_dir,
                round0_images=stage1_round0(args.imgpath, idx),
                run_seed=args.seed, timer=timer,
            )
    summary = timer.summary()
    print(summary)
    if "round" in summary:
        print(f"p50 reflection-round latency: {summary['round']['p50_s']:.3f}s")
    print_throughput(timer, pipe)


if __name__ == "__main__":
    main()
