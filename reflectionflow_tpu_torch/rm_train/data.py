"""Reward-model training data: GSB comparisons -> multimodal A/B batches.

Counterpart of `reflectionflow_tpu/rm_train/data.py`: each row pairs two
images for one prompt with a Good/Same/Bad label (and optionally MOS
scores); the collator builds each side's sequence with its vision pads and
right-pads both sides to a common length.

Rows: {"image_A": path or (H, W, 3) uint8, "image_B": ..., "prompt": str,
       "gsb": "G"|"S"|"B" or "chosen_label": int, "score_A"/"score_B": float}

Images are read by the port's decoders (`search/artifacts.py::load_image`:
JPEG and PNG, as PIL decodes them) and resized with the port's copy of PIL's
bicubic (`train/data.py::resize`, bit for bit); an image already at the
target size is not resized.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.qwen_vl.model import QwenVLModel, QwenVLSpecialTokens, get_rope_index
from ..models.qwen_vl.vision import image_to_patches, smart_resize
from .losses import convert_gsb_labels


def vision_train_geometry(vis_cfg, max_pixels: int = 448 * 448) -> tuple[int, tuple[int, int, int]]:
    """-> (square side in px, grid_thw) of the vision-training layout: every
    image resized to one square grid, so a batch's patches stack into one
    (B, Lp, pd) tensor and the tower runs once for the batch."""
    factor = vis_cfg.patch_size * vis_cfg.spatial_merge_size
    side = max(factor, int(math.sqrt(max_pixels)) // factor * factor)
    g = side // vis_cfg.patch_size
    return side, (1, g, g)


def build_side_sequence(model: QwenVLModel, image: np.ndarray, prompt: str, tokenizer=None,
                        max_pixels: int = 448 * 448, special_token_id: int | None = None,
                        prompt_template: str = "Rate the quality of this image for the caption: {prompt}",
                        fixed_square: bool = False) -> dict:
    """-> {"ids": (L,) int64, "image": the resized (H, W, 3) uint8} of one side:
    [vision_start, image_pad * n, vision_end, prompt tokens(, special)]."""
    from ..train.data import resize

    vis_cfg = model.vis_cfg
    factor = vis_cfg.patch_size * vis_cfg.spatial_merge_size
    H, W = image.shape[:2]
    if fixed_square:
        nh = nw = vision_train_geometry(vis_cfg, max_pixels)[0]
    else:
        nh, nw = smart_resize(H, W, factor=factor, max_pixels=max_pixels)
    img = resize(np.asarray(image), (nw, nh))
    _, (t, gh, gw) = image_to_patches(img, vis_cfg)
    n_img = t * (gh // vis_cfg.spatial_merge_size) * (gw // vis_cfg.spatial_merge_size)
    tokens = QwenVLSpecialTokens()
    text = prompt_template.format(prompt=prompt)
    if tokenizer is not None:
        body = tokenizer.encode(text, add_special_tokens=False)
    else:
        from ..utils.tokenizers import HashTokenizer

        ht = HashTokenizer(vocab_size=model.lm_cfg.vocab_size, append_eos=False)
        body = [int(x) for x in ht([text], max_length=48)["input_ids"][0] if x != 0]
    ids = [tokens.vision_start] + [tokens.image_pad] * n_img + [tokens.vision_end] + body
    if special_token_id is not None:
        ids.append(special_token_id)
    return {"ids": np.asarray(ids, np.int64), "image": img}


@torch.no_grad()
def collate_rm_batch(model: QwenVLModel, rows: list[dict], tokenizer=None, max_pixels: int = 448 * 448,
                     special_token_id: int | None = None, pad_token_id: int = 151643,
                     train_vision: bool = False) -> dict:
    """-> the batch of `rm_train.train.make_rm_train_step`, on the model's device:
    per side `embeds_*` (B, L, H) in the model's dtype, `pos_*` (3, B, L),
    `mask_*` (B, L) int32, `ids_*` (B, L) int64; `chosen_label` (B, 1) int32,
    `scores_A` / `scores_B` (B, 1) fp32.

    Default: the frozen tower's vision embeddings are written into each
    side's token embeddings here, one sequence at a time (images of one
    resolution share a grid). `train_vision`: every image goes to the one
    square grid of `vision_train_geometry`, the embeddings hold token rows
    only (the step's tower overwrites the image rows), and the raw patches
    ship as `patches_A` / `patches_B` (B, Lp, pd) fp32."""
    from ..search.artifacts import load_image

    dev = model.device
    sides = {"A": [], "B": []}
    labels, scores_A, scores_B = [], [], []
    for row in rows:
        for side in ("A", "B"):
            img = row.get(f"image_{side}")
            if isinstance(img, str):
                img = load_image(img)
            sides[side].append(build_side_sequence(model, img, row["prompt"], tokenizer, max_pixels,
                                                   special_token_id, fixed_square=train_vision))
        if "chosen_label" in row:
            labels.append(int(row["chosen_label"]))
        else:
            labels.append(convert_gsb_labels(row.get("gsb", "S")))
        scores_A.append(float(row.get("score_A", 0.0)))
        scores_B.append(float(row.get("score_B", 0.0)))

    batch = {}
    merge, tokens = model.vis_cfg.spatial_merge_size, model.tokens
    for side in ("A", "B"):
        seqs = sides[side]
        L = max(len(s["ids"]) for s in seqs)
        B = len(seqs)
        ids = np.full((B, L), pad_token_id, np.int64)
        mask = np.zeros((B, L), np.int32)
        pos = np.zeros((3, B, L), np.int64)
        embeds = torch.zeros((B, L, model.lm_cfg.hidden_size), dtype=model.dtype, device=dev)
        patches = []
        for b, s in enumerate(seqs):
            n = len(s["ids"])
            ids[b, :n] = s["ids"]
            mask[b, :n] = 1
            if train_vision:
                pats, grid = image_to_patches(s["image"], model.vis_cfg)
                patches.append(pats)
                emb = model.model.embed_tokens(torch.from_numpy(s["ids"]).to(dev))
                p = get_rope_index(s["ids"], [grid], merge, tokens.image_pad, video_pad_id=tokens.video_pad)
            else:
                emb, p = model.embed_sequence(s["ids"], [s["image"]])
                emb, p = emb[0], p[:, 0].cpu().numpy()
            embeds[b, :n] = emb
            pos[:, b, :n] = p
        batch[f"embeds_{side}"] = embeds
        batch[f"ids_{side}"] = torch.from_numpy(ids).to(dev)
        batch[f"mask_{side}"] = torch.from_numpy(mask).to(dev)
        batch[f"pos_{side}"] = torch.from_numpy(pos).to(dev)
        if train_vision:
            batch[f"patches_{side}"] = torch.from_numpy(np.stack(patches)).to(dev)
    batch["chosen_label"] = torch.tensor(labels, dtype=torch.int32, device=dev)[:, None]
    batch["scores_A"] = torch.tensor(scores_A, dtype=torch.float32, device=dev)[:, None]
    batch["scores_B"] = torch.tensor(scores_B, dtype=torch.float32, device=dev)[:, None]
    return batch


def convert_gsb_csv(csv_path: str, image_root: str = "") -> list[dict]:
    """A GSB csv (image_A/img_A, image_B/img_B, prompt/caption, gsb/label,
    score_A, score_B) -> rows, image paths under `image_root`."""
    import csv
    import os

    rows = []
    with open(csv_path) as f:
        for rec in csv.DictReader(f):
            rows.append({
                "image_A": os.path.join(image_root, rec.get("image_A", rec.get("img_A", ""))),
                "image_B": os.path.join(image_root, rec.get("image_B", rec.get("img_B", ""))),
                "prompt": rec.get("prompt", rec.get("caption", "")),
                "gsb": rec.get("gsb", rec.get("label", "S")),
                "score_A": float(rec.get("score_A", 0) or 0),
                "score_B": float(rec.get("score_B", 0) or 0),
            })
    return rows
