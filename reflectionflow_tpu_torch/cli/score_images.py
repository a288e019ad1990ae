"""Batch image scoring CLI with resume.

Counterpart of `reflectionflow_tpu/cli/score_images.py`: score a dataset of
(image, prompt) pairs with the Image-Verifier, one JSON object per image,
resuming by skipping the images already in the output file. The verifier is
built on `--device` (default cuda; without CUDA it raises unless
`--device cpu` is given). Images are PNG files (the port's decoder).

Input metadata jsonl rows: {"image": <path>, "prompt": <text>, ...}.
Output rows: the input row + {"VQ": <score>}.
"""

from __future__ import annotations

import argparse
import os

from ..search.artifacts import load_image
from ..utils.jsonl import append_jsonl, read_jsonl
from ..verifiers import load_verifier
from .common import add_device_arg, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--meta_path", type=str, required=True)
    p.add_argument("--output_json", type=str, required=True)
    p.add_argument("--verifier", type=str, default="qwen_rm")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rows = read_jsonl(args.meta_path)
    done: set[str] = set()
    if os.path.exists(args.output_json):
        done = {r["image"] for r in read_jsonl(args.output_json)}
        print(f"resuming: {len(done)} already scored")
    todo = [r for r in rows if r["image"] not in done]

    kw = {"device": device} if args.verifier in ("qwen_rm", "image_verifier") else {}
    verifier = load_verifier(args.verifier, model_path=args.model_path, **kw)
    for i in range(0, len(todo), args.batch_size):
        batch = todo[i : i + args.batch_size]
        images = [load_image(r["image"]) for r in batch]
        prompts = [r.get("prompt", "") for r in batch]
        if hasattr(verifier, "reward"):
            outs = verifier.reward(images, prompts)
        else:
            outs = [{"VQ": o["overall_score"]["score"] if isinstance(o.get("overall_score"), dict) else o.get("score")}
                    for o in verifier.score(images, prompts)]
        for row, out in zip(batch, outs):
            append_jsonl(args.output_json, {**row, **out})
        print(f"scored {min(i + args.batch_size, len(todo))}/{len(todo)}")


if __name__ == "__main__":
    main()
