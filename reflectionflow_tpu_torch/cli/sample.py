"""Standalone corrector sampler on the PyTorch port.

Counterpart of `reflectionflow_tpu/cli/sample.py`: batch-runs the FLUX
Corrector over (bad image, prompt, reflection) eval items. The bad image
becomes a `cot` Condition at condition_size; CLIP pools the original prompt
while T5 encodes `prompt + " [Reflexion] " + reflection` (the prompt/prompt_2
tower split); the output is a [condition | good | corrected] side-by-side
sheet per item, named `{image_id}.png` or `result_{index}.png`.

Meta file: a JSON list or JSONL of items with `prompt`, `bad_image` (path),
optional `good_image`, and a reflection under one of `reflection_prompt` /
`instruction` / `reflection` / `edited_prompt_list`. Paths resolve against
--root_dir. Images are JPEG (baseline) or PNG, decoded by the port itself as
PIL decodes them, and resized with its copy of PIL's bicubic
(`train/data.py::resize`, bit for bit).

Usage:
  python -m reflectionflow_tpu_torch.cli.sample \\
      --pipeline_config_path configs/flux.1_dev_fake.json \\
      --meta_path pairs.json --output_dir samples/ [--root_dir DATA] \\
      [--image_guidance_scale 1.5] [--device cpu --synthetic_weights]
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from ..sampler.condition import Condition, cot_position_delta
from ..search.artifacts import load_image, save_image
from ..train.data import resize
from ..utils.timing import PhaseTimer
from .common import build_parser, load_config, load_pipeline, slice_rows


def _reflection_of(item: dict) -> str:
    for key in ("reflection_prompt", "instruction", "reflection"):
        if key in item:
            return item[key]
    if "edited_prompt_list" in item:
        return item["edited_prompt_list"][-1]
    raise ValueError(f"No reflection found in item: {sorted(item)}")


def _load_items(meta_path: str) -> list[dict]:
    """A JSON list (or one JSON object), else JSONL."""
    with open(meta_path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        return data if isinstance(data, list) else [data]
    except json.JSONDecodeError:
        return [json.loads(line) for line in text.splitlines() if line.strip()]


def _prep_pair(bad, good, target: int, cond: int, rng: random.Random):
    """bad resized onto good's grid, shorter edge to `target`, the same random
    crop on both, then bad down to the condition size -> (condition, good or
    None), (H, W, 3) uint8."""
    if good is not None:
        bad = resize(bad, (good.shape[1], good.shape[0]))
    h, w = bad.shape[:2]
    ratio = target / min(w, h)
    nw, nh = int(-(-w * ratio // 1)), int(-(-h * ratio // 1))  # ceil, as the JAX CLI
    bad = resize(bad, (nw, nh))
    good = resize(good, (nw, nh)) if good is not None else None
    if nw > target or nh > target:
        left = rng.randint(0, max(0, nw - target))
        top = rng.randint(0, max(0, nh - target))
        bad = bad[top:top + target, left:left + target]
        good = good[top:top + target, left:left + target] if good is not None else None
    cond_img = resize(np.ascontiguousarray(bad), (cond, cond))
    return cond_img, np.ascontiguousarray(good) if good is not None else None


def _fit(img: np.ndarray, size: int) -> np.ndarray:
    """Pad the condition panel to the sheet height (top-left aligned)."""
    out = np.zeros((size, size, 3), np.uint8)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def run_samples(pipe, items: list[dict], cfg, args) -> PhaseTimer:
    """Correct each item with `pipe` and write its sheet under cfg.output_dir.
    `args` carries seed, start_index, root_dir and image_guidance_scale; the
    crop and the noise of item idx are seeded by start_index + idx, so a
    resumed run redraws them the same."""
    pa = cfg.pipeline_args
    target, cond_size = pa.height, pa.condition_size
    os.makedirs(cfg.output_dir, exist_ok=True)
    timer = PhaseTimer()
    for idx, item in enumerate(items):
        rng = random.Random(args.seed * 1_000_003 + args.start_index + idx)
        bad = load_image(os.path.join(args.root_dir, item["bad_image"]))
        good = (load_image(os.path.join(args.root_dir, item["good_image"]))
                if item.get("good_image") else None)
        cond_np, good_np = _prep_pair(bad, good, target, cond_size, rng)
        condition = Condition("cot", cond_np, position_delta=cot_position_delta(cond_size))
        prompt = item["prompt"]
        with timer.span("generate"):
            result = pipe.generate(
                [prompt],
                prompts_2=[prompt + " [Reflexion] " + _reflection_of(item)],
                height=target, width=target,
                num_inference_steps=pa.num_inference_steps,
                guidance_scale=pa.guidance_scale,
                max_sequence_length=pa.max_sequence_length,
                seed=args.seed + args.start_index + idx,
                conditions=[condition],
                image_guidance_scale=args.image_guidance_scale,
            )[0]
        panels = [p for p in (_fit(cond_np, target), good_np, result) if p is not None]
        name = item.get("image_id", f"result_{args.start_index + idx}")
        save_image(os.path.join(cfg.output_dir, f"{name}.png"), np.concatenate(panels, axis=1))
    return timer


def main(argv=None):
    p = build_parser(__doc__)
    p.add_argument("--root_dir", type=str, default="", help="prefix for image paths in the meta file")
    p.add_argument("--image_guidance_scale", type=float, default=1.0)
    args = p.parse_args(argv)
    cfg = load_config(args)
    pa = cfg.pipeline_args
    if pa.condition_size > pa.height:
        raise SystemExit(
            f"condition_size ({pa.condition_size}) must not exceed height ({pa.height}): "
            "the condition panel is pasted into a height-sized sheet column")
    pipe = load_pipeline(cfg, args)
    items = slice_rows(_load_items(args.meta_path), args)
    print(run_samples(pipe, items, cfg, args).summary())


if __name__ == "__main__":
    main()
