"""Post-hoc NFE filtering: best-of-first-K selection for scaling curves.

Counterpart of `reflectionflow_tpu/search/nfe_filter.py`: read a prior run's
candidate images, score every image, and write the best image among the
first K candidates into `nfe{K}/` for K in {1, 2, 4, 8, 16, 32}, the GenEval
scaling-curve points.
"""

from __future__ import annotations

import glob
import os
import re

from ..verifiers.base import RankingRule, Verifier
from .artifacts import load_image, save_image

DEFAULT_NFES = (1, 2, 4, 8, 16, 32)


def _round_seed_key(path: str) -> tuple[int, int]:
    m = re.match(r"(\d+)_round@(\d+)\.png", os.path.basename(path))
    return (int(m.group(1)), int(m.group(2))) if m else (1 << 30, 0)


def run_nfe_filter(
    verifier: Verifier,
    rule: RankingRule,
    input_root: str,
    output_root: str,
    prompts: list[dict] | list[str],
    nfes: tuple[int, ...] = DEFAULT_NFES,
    images_subdir: str = "midimg",
    start_index: int = 0,
) -> dict[int, list[str]]:
    """Returns {K: [selected image path per prompt]} and writes nfe{K}/ dirs
    with one image per prompt named {prompt_index:05d}.png. `start_index`
    must match the search run that wrote the directories."""
    selections: dict[int, list[str]] = {k: [] for k in nfes}
    for offset, row in enumerate(prompts):
        idx = start_index + offset
        prompt = row["prompt"] if isinstance(row, dict) else row
        tag = row.get("tag") if isinstance(row, dict) else None
        prompt_dir = os.path.join(input_root, f"{idx:05d}")
        candidates = sorted(
            glob.glob(os.path.join(prompt_dir, images_subdir, "*_round@*.png")),
            key=_round_seed_key,
        )
        if not candidates:
            # stage-1 runs store candidates under samples/
            candidates = sorted(
                glob.glob(os.path.join(prompt_dir, "samples", "*_round@*.png")),
                key=_round_seed_key,
            )
        if not candidates:
            continue
        arrays = [load_image(p) for p in candidates]
        outputs = verifier.score(arrays, [prompt] * len(arrays), tag=tag)
        for k in nfes:
            pool = outputs[:k]
            best_local = min(range(len(pool)), key=lambda i: rule.key(pool[i]))
            best_path = candidates[best_local]
            selections[k].append(best_path)
            out_path = os.path.join(output_root, f"nfe{k}", f"{idx:05d}.png")
            save_image(out_path, arrays[best_local])
    return selections
