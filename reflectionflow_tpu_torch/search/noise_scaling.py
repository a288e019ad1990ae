"""Stage-1 noise scaling: round-based best-of-N generation (no verifier).

Counterpart of `reflectionflow_tpu/search/noise_scaling.py`. Each generate
call carries a chunk of prompts x `search_branch` candidates on the batch
axis; every candidate image lands at `samples/{round}_round@{seed}.png` and
every (prompt, round) appends one row to `metadata.jsonl`. With
`pipeline.mesh` set, every rank of the mesh runs the loop (each generate
call is collective) and rank 0 alone writes (`parallel.distributed.RankZero`).
"""

from __future__ import annotations

import torch

from ..config import TTSConfig
from ..parallel.distributed import RankZero
from ..utils.timing import PhaseTimer
from .artifacts import PromptDirs, round_image_name, save_image
from .seeds import candidate_seeds, seeds_to_latents


def run_noise_scaling(
    pipeline,
    cfg: TTSConfig,
    prompts: list[dict] | list[str],
    output_root: str,
    start_index: int = 0,
    run_seed: int = 0,
    timer: PhaseTimer | None = None,
) -> None:
    """prompts: list of strings or GenEval rows ({'prompt':..., 'tag':...})."""
    timer = timer or PhaseTimer()
    pa = cfg.pipeline_args
    sa = cfg.search_args
    branch = sa.search_branch
    # prompts per generate call (>=1), from the configured generation batch
    chunk = max(1, cfg.batch_size_for_img_gen // branch)
    r0 = RankZero(getattr(pipeline, "mesh", None))

    entries = []
    for offset, row in enumerate(prompts):
        prompt = row["prompt"] if isinstance(row, dict) else row
        idx = start_index + offset
        entries.append((idx, prompt, PromptDirs.create(output_root, idx, make=r0.is_writer)))

    if getattr(pipeline, "_embed_cache", None) is not None:
        # encode every prompt once; the rounds then read cached embeddings
        with timer.span("encode"):
            pipeline.warm_prompt_cache([e[1] for e in entries], pa.max_sequence_length)

    for c0 in range(0, len(entries), chunk):
        block = entries[c0 : c0 + chunk]
        for rnd in range(1, sa.search_rounds + 1):
            all_seeds = [candidate_seeds(run_seed, idx, rnd, branch) for idx, _, _ in block]
            latents = torch.cat([
                seeds_to_latents(seeds, pa.height, pa.width, pipeline.vae_cfg.latent_channels,
                                 pipeline.dtype, pipeline.vae_cfg.downscale, pipeline.device)
                for seeds in all_seeds
            ])
            flux_prompts = [prompt for _, prompt, _ in block for _ in range(branch)]
            with timer.span("generate"):
                # output_type="np" returns host images, so the span ends after the device work
                images = pipeline.generate(
                    flux_prompts,
                    height=pa.height,
                    width=pa.width,
                    num_inference_steps=pa.num_inference_steps,
                    guidance_scale=pa.guidance_scale,
                    max_sequence_length=pa.max_sequence_length,
                    latents=latents,
                )
            timer.add_count("candidates", images.shape[0])
            for bi, (idx, prompt, dirs) in enumerate(block):
                for k, seed in enumerate(all_seeds[bi]):
                    r0.write(save_image, f"{dirs.samples}/{round_image_name(rnd, seed)}",
                             images[bi * branch + k])
                r0.write(dirs.append_metadata, {
                    "prompt": prompt,
                    "search_round": rnd,
                    "num_noises": branch,
                    "seeds": [int(s) for s in all_seeds[bi]],
                })
