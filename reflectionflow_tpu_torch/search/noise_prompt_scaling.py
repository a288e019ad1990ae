"""Noise + prompt scaling: best-of-N with per-round verifier scoring and
prompt refinement (no corrector conditioning).

Counterpart of `reflectionflow_tpu/search/noise_prompt_scaling.py`: per
round, score the previous candidates, keep top-k, refine the prompt from the
best images' evaluations, and regenerate with fresh noise; refined prompts
feed the next round. Prompts run in lockstep blocks: a round's generation for
the whole block is one batched `generate` (micro-batched to
`batch_size_for_img_gen`), and the verify / refine host stages are one
batched call each across the block (tag-grouped for the per-GenEval-tag
schemas), as in `reflectionflow.run_reflectionflow_block`, and, with
`pipeline.mesh` set, on every rank with rank 0 reading, writing and calling
the verifier and refiner (`parallel.distributed.RankZero`).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import TTSConfig
from ..parallel.distributed import RankZero
from ..utils.timing import PhaseTimer
from ..verifiers.base import RankingRule, Verifier, select_topk
from .artifacts import PromptDirs, load_image, round_image_name, save_image
from .reflectionflow import _score_grouped
from .seeds import candidate_seeds, seeds_to_latents


def run_noise_prompt_scaling(
    pipeline,
    verifier: Verifier,
    refiner,
    cfg: TTSConfig,
    prompts: list[dict] | list[str],
    output_root: str,
    start_index: int = 0,
    run_seed: int = 0,
    timer: PhaseTimer | None = None,
) -> None:
    timer = timer or PhaseTimer()
    pa, sa = cfg.pipeline_args, cfg.search_args
    branch = sa.search_branch
    rule = RankingRule(
        kind=verifier.output_kind,
        choice_of_metric=cfg.verifier_args.choice_of_metric,
    )
    refine_on = refiner is not None and cfg.prompt_refiner_args.run_refinement
    r0 = RankZero(getattr(pipeline, "mesh", None))

    states = []
    for offset, row in enumerate(prompts):
        prompt = row["prompt"] if isinstance(row, dict) else row
        tag = row.get("tag") if isinstance(row, dict) else None
        idx = start_index + offset
        states.append(
            {
                "idx": idx, "prompt": prompt, "tag": tag,
                "dirs": PromptDirs.create(output_root, idx, make=r0.is_writer),
                "current": [prompt] * branch, "prev": [],
            }
        )

    chunk = max(1, cfg.batch_size_for_img_gen // branch)
    for c0 in range(0, len(states), chunk):
        block = states[c0 : c0 + chunk]
        for rnd in range(1, sa.search_rounds + 1):
            # --- batched refine from the previous round's best (skipped rnd 1)
            if rnd > 1 and refine_on:
                with timer.span("verify"):
                    v_imgs, v_prompts, v_tags = [], [], []
                    arrays_of = r0.call(lambda: [[load_image(p) for p in s["prev"]] for s in block])
                    for s, arrays in zip(block, arrays_of):
                        v_imgs += arrays
                        v_prompts += [s["prompt"]] * len(arrays)
                        v_tags += [s["tag"]] * len(arrays)
                    flat = r0.call(
                        _score_grouped, verifier, v_imgs, v_prompts, v_tags,
                        cfg.verifier_args.max_new_tokens,
                    )
                r_args = {"images": [], "orig": [], "cur": [], "evals": []}
                off = 0
                topk_of = []
                for s, arrays in zip(block, arrays_of):
                    outputs = flat[off : off + len(s["prev"])]
                    off += len(s["prev"])
                    topk_idx = select_topk(outputs, branch, rule)
                    topk_of.append(topk_idx)
                    r_args["images"] += [arrays[i] for i in topk_idx]
                    r_args["orig"] += [s["prompt"]] * branch
                    r_args["cur"] += list(s["current"])
                    r_args["evals"] += [json.dumps(outputs[i]) for i in topk_idx]
                    r0.write(
                        s["dirs"].append_detailed_scores,
                        [outputs[i] for i in topk_idx], [s["prev"][i] for i in topk_idx],
                    )
                with timer.span("refine"):
                    flat_refined = r0.call(
                        refiner.refine, r_args["images"], r_args["orig"], r_args["cur"],
                        evaluations=r_args["evals"],
                    )
                for i, s in enumerate(block):
                    s["current"] = list(flat_refined[i * branch : (i + 1) * branch])

            # --- one batched generate for the whole block
            flux_prompts, lat_parts, seed_lists = [], [], []
            for s in block:
                seeds = candidate_seeds(run_seed, s["idx"], rnd, branch)
                seed_lists.append(seeds)
                lat_parts.append(
                    seeds_to_latents(
                        seeds, pa.height, pa.width, pipeline.vae_cfg.latent_channels,
                        pipeline.dtype, pipeline.vae_cfg.downscale, pipeline.device,
                    )
                )
                flux_prompts += list(s["current"])
            latents = torch.cat(lat_parts, dim=0)
            micro = max(1, cfg.batch_size_for_img_gen)  # the per-call memory cap
            with timer.span("generate"):
                images = np.concatenate([
                    pipeline.generate(
                        flux_prompts[m0 : m0 + micro], height=pa.height, width=pa.width,
                        num_inference_steps=pa.num_inference_steps, guidance_scale=pa.guidance_scale,
                        max_sequence_length=pa.max_sequence_length,
                        latents=latents[m0 : m0 + micro], output_type="np",
                    )
                    for m0 in range(0, len(flux_prompts), micro)
                ], axis=0)
            timer.add_count("candidates", len(flux_prompts))

            for bi, s in enumerate(block):
                s["prev"] = []
                for k, seed in enumerate(seed_lists[bi]):
                    path = os.path.join(s["dirs"].samples, round_image_name(rnd, seed))
                    r0.write(save_image, path, images[bi * branch + k])
                    s["prev"].append(path)
                r0.write(
                    s["dirs"].append_metadata,
                    {
                        "prompt": s["prompt"],
                        "current_prompts": s["current"],
                        "search_round": rnd,
                        "seeds": [int(x) for x in seed_lists[bi]],
                    }
                )
