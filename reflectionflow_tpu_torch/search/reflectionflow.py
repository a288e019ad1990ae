"""The full ReflectionFlow loop: generate -> verify -> reflect -> refine.

Counterpart of `reflectionflow_tpu/search/reflectionflow.py`, per prompt and
round:

  1. score the previous round's images with the verifier;
  2. pick top-k parents (wraparound repeat to the branch count);
  3. generate textual reflections for each parent;
  4. refine the prompt;
  5. build "cot" conditions from the parents (resized to condition_size,
     position_delta [0, -cond//16]);
  6. regenerate `branch` candidates with the corrector, FLUX prompt =
     `refined + " [Reflexion]: " + reflection`;
  7. re-score, update per-candidate chains, save last/best-per-chain/global
     best images and the JSONL artifacts.

The round structure, the per-path score cache, the resume rules, every file
name and every JSONL field are the JAX package's. Two differences: the
condition resize is the port's C++ copy of PIL's bicubic
(`train/data.py::resize`, bit for bit the same pixels), and each micro-batch's `generate` returns host
images before the next one starts, where JAX dispatches every micro-batch
before fetching any.

With `pipeline.mesh` set (a `parallel.mesh.RankMesh`), every rank runs the
loop, since each generate call is collective and returns the gathered
batch. Rank 0 alone writes the artifacts, reads the files, and calls the
verifier, reflector and refiner, whose answers (an OpenAI-compatible
backend's may differ from call to call) it hands every rank
(`parallel.distributed.RankZero`); so every rank takes the same selections
and builds the same conditions.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from ..config import TTSConfig
from ..parallel.distributed import RankZero
from ..sampler.condition import Condition, cot_position_delta
from ..train.data import resize
from ..utils.jsonl import read_jsonl
from ..utils.timing import PhaseTimer
from ..verifiers.base import RankingRule, Verifier, select_topk
from .artifacts import PromptDirs, load_image, round_image_name, save_image
from .seeds import candidate_seeds, seeds_to_latents
from .state import Chains, SearchManifest


def _score_grouped(verifier, images, prompts, tags, max_new_tokens):
    """One order-preserving verifier pass over a mixed-tag batch.

    The verifier API takes a single `tag` (it selects the per-tag GenEval
    schema), so indices group by tag; each group is ONE batched score call
    and results return in input order."""
    by_tag: dict = {}
    for i, t in enumerate(tags):
        by_tag.setdefault(t, []).append(i)
    out = [None] * len(images)
    for tag, idxs in by_tag.items():
        scores = verifier.score(
            [images[i] for i in idxs], [prompts[i] for i in idxs], tag=tag,
            max_new_tokens=max_new_tokens,
        )
        for i, sc in zip(idxs, scores):
            out[i] = sc
    return out


def _copy_image(src: str, dst: str) -> None:
    save_image(dst, load_image(src))


def run_reflectionflow_prompt(
    pipeline,
    verifier: Verifier,
    reflector,
    refiner,
    cfg: TTSConfig,
    prompt_index: int,
    original_prompt: str,
    tag: str | None,
    output_root: str,
    round0_images: list[str] | None = None,
    run_seed: int = 0,
    timer: PhaseTimer | None = None,
) -> dict:
    """Run all reflection rounds for one prompt. Returns the final datapoint.

    `round0_images`: paths of stage-1 candidates (the CLI's --imgpath
    contract). If None, a bootstrap round of plain generation runs first.

    A block of one through `run_reflectionflow_block`: one code path for both
    granularities."""
    return run_reflectionflow_block(
        pipeline, verifier, reflector, refiner, cfg,
        [{"prompt": original_prompt, "tag": tag}], output_root,
        start_index=prompt_index,
        round0_images_fn=(lambda idx: round0_images) if round0_images else None,
        run_seed=run_seed, timer=timer,
    )[0]


# ---------------------------------------------------------------------------
# lockstep multi-prompt execution
# ---------------------------------------------------------------------------


def run_reflectionflow_block(
    pipeline,
    verifier: Verifier,
    reflector,
    refiner,
    cfg: TTSConfig,
    rows: list[dict],
    output_root: str,
    start_index: int = 0,
    round0_images_fn=None,  # prompt_index -> list[str] | None
    run_seed: int = 0,
    timer: PhaseTimer | None = None,
) -> list[dict]:
    """Run the reflection rounds for a block of prompts in lockstep.

    The per-prompt host stages (verify/top-k/reflect/refine/chains) stay per
    prompt, but the round's image generation for the whole block is one
    batched conditioned `generate` of (n_prompts x branch) candidates, in
    micro-batches of `batch_size_for_img_gen`. Per-prompt state checkpoints;
    prompts whose manifest is already complete are skipped.
    """
    timer = timer or PhaseTimer()
    pa, sa = cfg.pipeline_args, cfg.search_args
    branch = sa.search_branch
    rule = RankingRule(
        kind=verifier.output_kind,
        choice_of_metric=cfg.verifier_args.choice_of_metric,
    )

    r0 = RankZero(getattr(pipeline, "mesh", None))

    def load_state(dirs, idx, prompt, tag):
        """The prompt's manifest, its round-0 parents and, when complete, its
        final datapoint, from the files (rank 0's, under a mesh)."""
        manifest = SearchManifest.load(dirs.root)
        if manifest is None or manifest.original_prompt != prompt:
            manifest = SearchManifest(
                prompt_index=idx, original_prompt=prompt, tag=tag,
                updated_prompts=[prompt] * branch, reflections=[""] * branch,
            )
        round0 = None
        if manifest.round_done > 0:
            # resume: parents are the LAST COMPLETED round's images
            round0 = sorted(
                glob.glob(os.path.join(dirs.midimg, f"{manifest.round_done}_round@*.png"))
            )
        if not round0:
            round0 = round0_images_fn(idx) if round0_images_fn else None
        if not round0:
            round0 = sorted(glob.glob(os.path.join(dirs.midimg, "0_round@*.png")))
        datapoint: dict = {}
        if manifest.round_done >= sa.search_rounds and os.path.exists(dirs.metadata):
            # already complete: the final datapoint is the last metadata row
            rows_done = read_jsonl(dirs.metadata)
            if rows_done:
                datapoint = rows_done[-1]
        return manifest, round0, datapoint

    # per-prompt state
    states = []
    for offset, row in enumerate(rows):
        idx = start_index + offset
        prompt = row["prompt"] if isinstance(row, dict) else row
        tag = row.get("tag") if isinstance(row, dict) else None
        dirs = PromptDirs.create(output_root, idx, stage2=True, make=r0.is_writer)
        manifest, round0, datapoint = r0.call(load_state, dirs, idx, prompt, tag)
        chains = (
            Chains.from_json({"chains": manifest.chains, "rule": rule.__dict__})
            if manifest.chains
            else Chains(rule)
        )
        states.append(
            {
                "idx": idx, "prompt": prompt, "tag": tag, "dirs": dirs,
                "manifest": manifest, "chains": chains, "prev": round0,
                "pixels": {}, "datapoint": datapoint,
            }
        )

    # bootstrap round 0 for prompts with no stage-1 images — one batched call
    need = [s for s in states if not s["prev"] and s["manifest"].round_done == 0]
    if need:
        flux_prompts, lat_parts, seed_lists = [], [], []
        for s in need:
            seeds = candidate_seeds(run_seed, s["idx"], 0, branch)
            seed_lists.append(seeds)
            lat_parts.append(
                seeds_to_latents(
                    seeds, pa.height, pa.width, pipeline.vae_cfg.latent_channels,
                    pipeline.dtype, pipeline.vae_cfg.downscale, pipeline.device,
                )
            )
            flux_prompts.extend([s["prompt"]] * branch)
        all_latents = torch.cat(lat_parts, dim=0)
        micro = max(1, cfg.batch_size_for_img_gen)
        with timer.span("generate"):
            # output_type="np" returns host images, so the span ends after the device work
            images = np.concatenate([
                pipeline.generate(
                    flux_prompts[m0 : m0 + micro], height=pa.height, width=pa.width,
                    num_inference_steps=pa.num_inference_steps, guidance_scale=pa.guidance_scale,
                    max_sequence_length=pa.max_sequence_length,
                    latents=all_latents[m0 : m0 + micro],
                    output_type="np",
                )
                for m0 in range(0, len(flux_prompts), micro)
            ], axis=0)
        timer.add_count("candidates", len(flux_prompts))
        for bi, s in enumerate(need):
            paths = []
            for k, seed in enumerate(seed_lists[bi]):
                path = os.path.join(s["dirs"].midimg, round_image_name(0, seed))
                r0.write(save_image, path, images[bi * branch + k])
                paths.append(path)
            s["prev"] = paths
            s["pixels"] = dict(zip(paths, images[bi * branch : (bi + 1) * branch]))

    total_rounds = sa.search_rounds
    for rnd in range(1, total_rounds + 1):
        active = [s for s in states if s["manifest"].round_done < rnd]
        if not active:
            continue
        with timer.span("round"):
            # the parents' pixels stay in memory from the round that made
            # them; parents from the files (resume, stage-1 images) are read
            # on rank 0 and handed every rank
            for s in active:
                missing = [p for p in s["prev"] if p not in s["pixels"]]
                if missing:
                    s["pixels"].update(zip(missing, r0.call(lambda m=missing: [load_image(p) for p in m])))
            # --- batched host stages: one verify / reflect / refine call per
            # round across the whole block ---
            with timer.span("verify"):
                # the previous round already scored its fresh candidates:
                # reuse the cached per-path scores and only verify images
                # without one (round 0 / resume)
                v_imgs, v_prompts, v_tags = [], [], []
                need_idx = []  # (state, path) needing a fresh score
                for s in active:
                    cache = s.setdefault("_score_cache", {})
                    for p in s["prev"]:
                        if p not in cache:
                            v_imgs.append(s["pixels"][p])
                            v_prompts.append(s["prompt"])
                            v_tags.append(s["tag"])
                            need_idx.append((s, p))
                fresh = r0.call(
                    _score_grouped, verifier, v_imgs, v_prompts, v_tags,
                    cfg.verifier_args.max_new_tokens,
                )
                for (s, p), out in zip(need_idx, fresh):
                    s["_score_cache"][p] = out
            # split scores back per prompt, pick top-k parents
            sel = []
            for s in active:
                prev_arrays = [s["pixels"][p] for p in s["prev"]]
                outputs = [s["_score_cache"][p] for p in s["prev"]]
                topk_idx = select_topk(outputs, branch, rule)
                sel_imgs = [s["prev"][i] for i in topk_idx]
                sel_arrays = [prev_arrays[i] for i in topk_idx]
                sel_outputs = [outputs[i] for i in topk_idx]
                r0.write(s["dirs"].append_detailed_scores, sel_outputs, sel_imgs)
                sel.append((s, sel_imgs, sel_arrays, sel_outputs))

            reflection_performed = cfg.reflection_args.run_reflection and reflector is not None
            all_reflections: list[list[str]] = [s["manifest"].reflections for s, *_ in sel]
            if reflection_performed:
                r_args = {"images": [], "orig": [], "cur": [], "prev": [], "evals": []}
                for s, _, sel_arrays, sel_outputs in sel:
                    r_args["images"] += sel_arrays
                    r_args["orig"] += [s["prompt"]] * branch
                    r_args["cur"] += list(s["manifest"].updated_prompts)
                    r_args["prev"] += list(s["manifest"].reflections)
                    r_args["evals"] += [json.dumps(o) for o in sel_outputs]
                with timer.span("reflect"):
                    flat_refl = r0.call(
                        reflector.generate, r_args["images"], r_args["orig"], r_args["cur"],
                        prev_reflections=r_args["prev"], evaluations=r_args["evals"],
                    )
                all_reflections = [flat_refl[i * branch : (i + 1) * branch] for i in range(len(sel))]

            refinement_performed = cfg.prompt_refiner_args.run_refinement and refiner is not None
            all_refined: list[list[str]] = [s["manifest"].updated_prompts for s, *_ in sel]
            if refinement_performed:
                f_args = {"images": [], "orig": [], "cur": [], "refl": [], "evals": []}
                for i, (s, _, sel_arrays, sel_outputs) in enumerate(sel):
                    f_args["images"] += sel_arrays
                    f_args["orig"] += [s["prompt"]] * branch
                    f_args["cur"] += list(s["manifest"].updated_prompts)
                    f_args["refl"] += list(all_reflections[i])
                    f_args["evals"] += [json.dumps(o) for o in sel_outputs]
                with timer.span("refine"):
                    flat_ref = r0.call(
                        refiner.refine, f_args["images"], f_args["orig"], f_args["cur"],
                        reflections=f_args["refl"], evaluations=f_args["evals"],
                    )
                all_refined = [flat_ref[i * branch : (i + 1) * branch] for i in range(len(sel))]

            plans = []
            for i, (s, sel_imgs, sel_arrays, sel_outputs) in enumerate(sel):
                reflections = list(all_reflections[i])
                refined = list(all_refined[i])
                if reflection_performed or refinement_performed:
                    r0.write(
                        s["dirs"].append_best_meta, rnd,
                        reflections=reflections if reflection_performed else None,
                        refined_prompt=refined if refinement_performed else None,
                        filenames=sel_imgs,
                    )
                cond_size = pa.condition_size
                conditions = [
                    Condition("cot", resize(a, (cond_size, cond_size)), position_delta=cot_position_delta(cond_size))
                    for a in sel_arrays
                ]
                if reflection_performed:
                    flux_prompts = [f"{rp} [Reflexion]: {rf}" for rp, rf in zip(refined, reflections)]
                elif refinement_performed:
                    flux_prompts = list(refined)
                else:
                    flux_prompts = [s["prompt"]] * branch
                seeds = candidate_seeds(run_seed, s["idx"], rnd, branch)
                plans.append(
                    {
                        "state": s, "sel_imgs": sel_imgs, "conditions": conditions,
                        "flux_prompts": flux_prompts, "seeds": seeds,
                        "reflections": reflections, "refined": refined,
                        "reflection_performed": reflection_performed,
                        "refinement_performed": refinement_performed,
                    }
                )

            # --- one conditioned generate for the whole block, micro-batched
            # to batch_size_for_img_gen ---
            all_prompts = [p for plan in plans for p in plan["flux_prompts"]]
            all_conditions = [c for plan in plans for c in plan["conditions"]]
            lat_parts = [
                seeds_to_latents(
                    plan["seeds"], pa.height, pa.width, pipeline.vae_cfg.latent_channels,
                    pipeline.dtype, pipeline.vae_cfg.downscale, pipeline.device,
                )
                for plan in plans
            ]
            all_latents = torch.cat(lat_parts, dim=0)
            micro = max(1, cfg.batch_size_for_img_gen)
            with timer.span("generate"):
                images = np.concatenate([
                    pipeline.generate(
                        all_prompts[m0 : m0 + micro], height=pa.height, width=pa.width,
                        num_inference_steps=pa.num_inference_steps, guidance_scale=pa.guidance_scale,
                        max_sequence_length=pa.max_sequence_length,
                        latents=all_latents[m0 : m0 + micro],
                        conditions=all_conditions[m0 : m0 + micro],
                        image_guidance_scale=pa.image_guidance_scale,
                        output_type="np",
                    )
                    for m0 in range(0, len(all_prompts), micro)
                ], axis=0)
            timer.add_count("candidates", len(all_prompts))

            # --- batched re-verify of the new candidates ---
            with timer.span("verify"):
                nv_imgs = [images[bi * branch + k] for bi in range(len(plans)) for k in range(branch)]
                nv_prompts = [plan["state"]["prompt"] for plan in plans for _ in range(branch)]
                nv_tags = [plan["state"]["tag"] for plan in plans for _ in range(branch)]
                flat_new = r0.call(
                    _score_grouped, verifier, nv_imgs, nv_prompts, nv_tags,
                    cfg.verifier_args.max_new_tokens,
                )

            # --- per-prompt: save, chains, manifest ---
            for bi, plan in enumerate(plans):
                s = plan["state"]
                block_imgs = [images[bi * branch + k] for k in range(branch)]
                full_imgnames = []
                for k, seed in enumerate(plan["seeds"]):
                    path = os.path.join(s["dirs"].midimg, round_image_name(rnd, seed))
                    r0.write(save_image, path, block_imgs[k])
                    full_imgnames.append(path)
                new_outputs = flat_new[bi * branch : (bi + 1) * branch]
                # next round's "verify prev" reuses these scores by path
                s.setdefault("_score_cache", {}).update(zip(full_imgnames, new_outputs))
                if rnd == 1:
                    s["chains"].init_round(full_imgnames, new_outputs)
                else:
                    s["chains"].update(plan["sel_imgs"], full_imgnames, new_outputs)
                if rnd == total_rounds:
                    for i, img in enumerate(block_imgs):
                        r0.write(save_image, os.path.join(s["dirs"].samples_lastround, f"{i:05d}.png"),
                                 img)
                best_paths = full_imgnames if rnd == 1 else s["chains"].best_per_chain()
                for i, path in enumerate(best_paths):
                    r0.write(_copy_image, path, os.path.join(s["dirs"].samples_bestround, f"{i:05d}.png"))
                if rnd == total_rounds:
                    best_img, _ = s["chains"].global_best()
                    r0.write(_copy_image, best_img, os.path.join(s["dirs"].samples_best, "00000.png"))
                s["manifest"].updated_prompts = list(plan["refined"])
                s["manifest"].reflections = list(plan["reflections"])
                s["manifest"].round_done = rnd
                s["manifest"].chains = s["chains"].chains
                r0.write(s["manifest"].save, s["dirs"].root)
                datapoint = {
                    "original_prompt": s["prompt"],
                    "search_round": rnd,
                    "num_noises": branch,
                    "choice_of_metric": rule.choice_of_metric,
                    "generated_img": full_imgnames,
                    "flag_terminated": rnd == total_rounds,
                    "chains": s["chains"].chains,
                }
                if plan["refinement_performed"]:
                    datapoint["refined_prompt"] = plan["refined"]
                if plan["reflection_performed"]:
                    datapoint["reflections"] = plan["reflections"]
                r0.write(s["dirs"].append_metadata, datapoint)
                s["prev"] = full_imgnames
                s["pixels"] = dict(zip(full_imgnames, block_imgs))
                s["datapoint"] = datapoint
    return [s["datapoint"] for s in states]
