"""Reflection text generation with a KV cache.

Counterpart of `reflectionflow_tpu/models/qwen_vl/generate.py`: a round's
candidates decode as one left-padded batch (lengths rounded up to a multiple
of `_LEN_BUCKET` = 64, the pad slots masked through `cache["pad"]`); one
prefill fills the cache, then a token loop on the device, greedy or sampled,
with per-row EOS. The loop keeps every token on the device; it reads the done
flags on the host once every `_DONE_CHECK` steps to stop early, which changes
no output (a finished row records nothing more), where the JAX loop tests
them on the device every step.

The image resize is the port's copy of PIL's bicubic
(`train/data.py::resize`, bit for bit). Sampling (temperature >
0) draws from a `torch.Generator`, so sampled tokens differ from the JAX
package's `jax.random` draws; greedy decoding is the same function.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .lm import init_kv_cache, qwen_lm_apply
from .model import QwenVLModel, QwenVLSpecialTokens
from .vision import image_to_patches, qwen_vision_apply, smart_resize

_LEN_BUCKET = 64
_DONE_CHECK = 16


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def prefill(model: QwenVLModel, embeds: torch.Tensor, pos: torch.Tensor, cache: dict):
    """Fill the cache from position 0 -> (logits (B, L, V), cache)."""
    return qwen_lm_apply(model.model, model.lm_head, embeds, pos, kv_cache=cache)


@torch.no_grad()
def decode_tokens(model: QwenVLModel, cache: dict, last_logits: torch.Tensor, next_pos0: torch.Tensor, *,
                  max_new_tokens: int, eos_id: int, temperature: float = 0.0,
                  generator: torch.Generator | None = None):
    """Token loop -> (out_ids (B, max_new_tokens), lengths (B,)), on the device.
    Rows record tokens until their EOS; slots past a row's EOS hold 0 (trim by
    length, not by value)."""
    B = last_logits.shape[0]
    dev = last_logits.device
    out = torch.zeros((B, max_new_tokens), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B,), dtype=torch.long, device=dev)
    logits = last_logits
    for step in range(max_new_tokens):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        done = done | (tok == eos_id)
        out[:, step] = torch.where(done, 0, tok)
        lengths += (~done).long()
        if step == max_new_tokens - 1 or ((step + 1) % _DONE_CHECK == 0 and bool(done.all())):
            break
        emb = model.model.embed_tokens(tok)[:, None, :]
        pos = (next_pos0 + step)[None, :, None].expand(3, B, 1)
        logits, cache = qwen_lm_apply(model.model, model.lm_head, emb, pos, kv_cache=cache)
        logits = logits[:, -1]
    return out, lengths


def _maybe_fold_adapter(model: QwenVLModel, model_dir: str) -> QwenVLModel:
    """Fold a finetuned adapter (`lora.safetensors` beside the checkpoint, the
    `lora.save_lora_adapter` format) into the LM's weights at load."""
    adapter = os.path.join(model_dir, "lora.safetensors")
    if not os.path.exists(adapter):
        return model
    from ...lora.lora import fold_qwen_lora, load_lora_adapter

    fold_qwen_lora(model, load_lora_adapter(adapter))
    return model


@dataclass
class QwenVLGenerator:
    model: QwenVLModel
    tokenizer: object | None = None  # utils.bpe.Qwen2BPETokenizer when the snapshot has its files
    eos_token_id: int = 151645  # <|im_end|>
    max_len: int = 2048

    @classmethod
    def from_pretrained(cls, model_path: str | None, quantize: str | None = None,
                        quantize_min_size: int = 1 << 18, device_index: int | None = None,
                        device: str | torch.device | None = None, **kw) -> "QwenVLGenerator":
        """Load a local Qwen2.5-VL snapshot on `device` (default cuda; or
        `cuda:<device_index>`), fold a `lora.safetensors` beside it, and with
        quantize="int8" put the LM and vision block linears on W8A8."""
        if model_path is None:
            raise ValueError("local_qwen needs a model_path (reflection_args.model_path or "
                             "verifier_args.model_path), or build QwenVLGenerator on a QwenVLModel")
        from ...utils.device import placement, quantize_blocks
        from ...utils.hf_loader import load_qwen_vl

        model, tokenizer = load_qwen_vl(model_path, device=placement(device, device_index))
        model = _maybe_fold_adapter(model, model_path)
        if quantize == "int8":
            quantize_blocks(model.model.layers, quantize_min_size)
            quantize_blocks(model.visual.blocks, quantize_min_size)
        return cls(model=model, tokenizer=tokenizer, **kw)

    @torch.no_grad()
    def prepare_batch(self, sequences: list[tuple[np.ndarray, list[np.ndarray]]], max_new_tokens: int):
        """Left-padded embeddings, position ids, an empty cache and each row's
        first decode position. Same-grid single-image rows share one batched
        tower pass."""
        model = self.model
        B = len(sequences)
        precomp: list = [None] * B
        by_grid: dict = {}
        for b, (_ids, imgs) in enumerate(sequences):
            if len(imgs) == 1:
                patches, grid = image_to_patches(np.asarray(imgs[0]), model.vis_cfg)
                by_grid.setdefault(grid, []).append((b, patches))
        for grid, items in by_grid.items():
            if len(items) < 2:
                continue
            stack = torch.from_numpy(np.stack([p for _, p in items])).to(model.device, model.dtype)
            embs = qwen_vision_apply(model.visual, stack, grid)
            for (b, _), e in zip(items, embs):
                precomp[b] = ([e], [grid])
        rows = [model.embed_sequence(ids, imgs, precomputed=precomp[b])
                for b, (ids, imgs) in enumerate(sequences)]
        lens = [int(e.shape[1]) for e, _ in rows]
        Lmax = _round_up(max(lens), _LEN_BUCKET)
        embeds = torch.stack([torch.nn.functional.pad(e[0].to(model.dtype), (0, 0, Lmax - n, 0))
                              for (e, _), n in zip(rows, lens)])
        pos = np.zeros((3, B, Lmax), np.int64)
        pads = np.zeros((B,), np.int64)
        next_pos0 = np.zeros((B,), np.int64)
        for b, (_, p) in enumerate(rows):
            n = lens[b]
            p_host = p.cpu().numpy()
            pads[b] = Lmax - n
            pos[:, b, Lmax - n :] = p_host[:, 0, :]
            next_pos0[b] = int(p_host.max()) + 1
        cache = init_kv_cache(model.lm_cfg, B, Lmax + max_new_tokens, dtype=model.dtype, device=model.device)
        cache["pad"] = torch.from_numpy(pads).to(model.device)
        return embeds, torch.from_numpy(pos).to(model.device), cache, torch.from_numpy(next_pos0).to(model.device)

    @torch.no_grad()
    def decode_batch(self, sequences: list[tuple[np.ndarray, list[np.ndarray]]], max_new_tokens: int = 128,
                     temperature: float = 0.0, generator: torch.Generator | None = None) -> list[list[int]]:
        """Left-pad the sequences into one batch, prefill once and decode the
        batch together. Lengths may be ragged; vision grids may differ per row."""
        embeds, pos, cache, next_pos0 = self.prepare_batch(sequences, max_new_tokens)
        logits, cache = prefill(self.model, embeds, pos, cache)
        out, lengths = decode_tokens(self.model, cache, logits[:, -1], next_pos0, max_new_tokens=max_new_tokens,
                                     eos_id=self.eos_token_id, temperature=float(temperature),
                                     generator=generator)
        out, lengths = out.cpu().numpy(), lengths.cpu().numpy()
        return [out[b, : lengths[b]].tolist() for b in range(len(sequences))]

    def decode_ids(self, input_ids: np.ndarray, images: list[np.ndarray], max_new_tokens: int = 128,
                   temperature: float = 0.0, generator: torch.Generator | None = None) -> list[int]:
        """Greedy (or sampled) continuation of one multimodal sequence."""
        return self.decode_batch([(input_ids, images)], max_new_tokens=max_new_tokens, temperature=temperature,
                                 generator=generator)[0]

    def generate(self, images: list[np.ndarray], prompts: list[str], max_new_tokens: int = 128,
                 max_pixels: int = 448 * 448, system: str | None = None) -> list[str]:
        """One prefill + decode for a round's candidates: image + prompt -> text."""
        if self.tokenizer is None:
            raise ValueError("text generation requires a tokenizer (the snapshot has no tokenizer files)")
        from ...train.data import resize

        vis_cfg = self.model.vis_cfg
        factor = vis_cfg.patch_size * vis_cfg.spatial_merge_size
        seqs = []
        for img, prompt in zip(images, prompts):
            img = np.asarray(img)
            nh, nw = smart_resize(img.shape[0], img.shape[1], factor=factor, max_pixels=max_pixels)
            img = resize(img, (nw, nh))
            seqs.append((self._build_chat_ids(img, prompt, system=system), [img]))
        outs = self.decode_batch(seqs, max_new_tokens=max_new_tokens)
        return [self.tokenizer.decode(ids, skip_special_tokens=True).strip() for ids in outs]

    def _build_chat_ids(self, image: np.ndarray, prompt: str, system: str | None = None) -> np.ndarray:
        tok = self.tokenizer
        tokens = QwenVLSpecialTokens()
        _, (t, gh, gw) = image_to_patches(image, self.model.vis_cfg)
        merge = self.model.vis_cfg.spatial_merge_size
        n_img = t * (gh // merge) * (gw // merge)
        sys_ids = (tok.encode(f"<|im_start|>system\n{system}<|im_end|>\n", add_special_tokens=False)
                   if system else [])
        prefix = tok.encode("<|im_start|>user\n", add_special_tokens=False)
        suffix = tok.encode(f"{prompt}<|im_end|>\n<|im_start|>assistant\n", add_special_tokens=False)
        ids = sys_ids + prefix + [tokens.vision_start] + [tokens.image_pad] * n_img + [tokens.vision_end] + suffix
        return np.asarray(ids, np.int64)
