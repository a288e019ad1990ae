"""FluxPipeline: weights + tokenizers + the sampling loop.

Counterpart of `reflectionflow_tpu/sampler/pipeline.py::FluxPipeline`: text
encoding (T5 sequence + CLIP pooled), packed noise, the dynamic-shift
schedule, the Euler loop over the DiT, and the VAE decode, in bf16 or, after
`quantize`, in the W8A8 serving layout; with condition images, the
conditioned generate of the FLUX-Corrector (the cond stream reads
`cond_dit_params`, a LoRA-folded copy of the DiT from
`lora.make_dit_param_views`) and image CFG; and the bounded prompt-embedding
cache (`enable_prompt_cache`); `vae_tiling` encodes and decodes in tiles.
`from_pretrained` loads a local diffusers snapshot (`utils/hf_loader.py`).
`quantize` makes the W8A8 serving layout, with the NF4 profiles (packed NF4
MLPs, NF4 T5) when asked; the phase swap is on the ROADMAP's do-not-port list
(the card holds the int8 DiT and T5 together). `vcache` opts into the velocity
cache (`generate.vcache_kwargs`: static, TeaCache-dynamic, Taylor, residual
and module modes).

`mesh` (a `parallel.mesh.RankMesh`, set by `set_mesh`) serves one generate
call over a mesh of ranks, as the JAX `FluxPipeline.mesh` does: the batch's
candidates shard over "data" (every rank draws the whole batch's noise from
the seed and keeps its slice, and the images are gathered so that every rank
returns the whole batch), and the DiT's heads and MLP hidden over "model"
(`parallel/specs.py`). The quantized profiles run over "data" alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from ..config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
from ..models.flux.dit import FluxDiT
from ..models.flux.latents import draw_packed_noise, latent_tokens, unpack_latents
from ..models.flux.rope import make_image_ids, make_text_ids
from ..models.flux.text import CLIPTextEncoder, T5Encoder, clip_text_encode, t5_encode
from ..models.flux.vae import FluxVAE, vae_decode, vae_decode_tiled
from ..parallel.mesh import gather_candidates, shard_batch
from ..parallel.specs import shard_dit_params
from ..utils import threefry
from ..utils.tokenizers import load_tokenizer
from .condition import Condition, encode_conditions
from .generate import denoise, make_schedule, vcache_kwargs

# std of the normal init of each embedding table (the JAX package's recipe)
_EMBED_STD = {
    "shared": 1.0,
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias": 0.1,
    "text_model.embeddings.token_embedding": 0.02,
    "text_model.embeddings.position_embedding": 0.02,
    "model.embed_tokens": 0.02,  # Qwen2.5-VL, and NVILA's Qwen2 LM
    "vision_model.embeddings.position_embedding": 0.02,  # NVILA's SigLIP tower
}


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill `module`'s parameters in place with the JAX package's init recipe:
    linear and conv weights ~ N(0, 1/fan_in), zero biases, unit norm scales,
    and the per-table embedding stds of `_EMBED_STD`."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, _EMBED_STD[name], generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:  # QK-norm and T5 norm scales
            for p in m.parameters(recurse=False):
                p.fill_(1.0)
    return module


def _build(cls, cfg, dtype, device, generator):
    """Construct without allocating, then materialise in `dtype` on `device`
    and fill with random weights (no fp32 copy of a full-size model)."""
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to(dtype).to_empty(device=device)
    return random_init_(module, generator).eval().requires_grad_(False)


@dataclass
class FluxPipeline:
    dit_cfg: FluxDiTConfig
    vae_cfg: FluxVAEConfig
    t5_cfg: T5Config
    clip_cfg: CLIPTextConfig
    dit: FluxDiT
    vae: FluxVAE
    t5: T5Encoder
    clip: CLIPTextEncoder
    t5_tokenizer: Any
    clip_tokenizer: Any
    dtype: torch.dtype = torch.bfloat16
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    attn_impl: str = "xla"
    rope_layout: str = "pair"  # "split" after quantize() permutes q/k (ops.fuse)
    model_flags: dict = field(default_factory=dict)  # union_cond_attn / add_cond_attn
    cond_dit_params: FluxDiT | None = None  # LoRA-folded model the cond stream reads
    vae_tiling: bool = False  # diffusers enable_vae_tiling: 512 px tiles for encode and decode
    # opt-in velocity cache (PipelineArgs.vcache): {"interval": k} static schedule or
    # {"threshold": x} TeaCache-style dynamic skipping (generate.vcache_kwargs)
    vcache: dict | None = None
    # prompt-embedding cache, ((clip_prompt, t5_prompt), L) -> host (txt, pooled);
    # None until enable_prompt_cache()
    _embed_cache: dict | None = field(default=None, repr=False)
    _embed_cache_cap: int = 2048
    # parallel.mesh.RankMesh: candidates sharded over "data", the DiT over "model" (set_mesh)
    mesh: Any = None

    # -- construction -------------------------------------------------------

    @classmethod
    def random_init(
        cls,
        generator: torch.Generator,
        dit_cfg: FluxDiTConfig | None = None,
        vae_cfg: FluxVAEConfig | None = None,
        t5_cfg: T5Config | None = None,
        clip_cfg: CLIPTextConfig | None = None,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device | None = None,
        tokenizer_path: str | None = None,
    ) -> "FluxPipeline":
        """Random weights at the given configs (default FLUX.1-dev), made on
        `device` (default: the generator's) from `generator`."""
        dit_cfg = dit_cfg or FluxDiTConfig()
        vae_cfg = vae_cfg or FluxVAEConfig()
        t5_cfg = t5_cfg or T5Config()
        clip_cfg = clip_cfg or CLIPTextConfig()
        device = torch.device(device) if device is not None else generator.device
        return cls(
            dit_cfg=dit_cfg,
            vae_cfg=vae_cfg,
            t5_cfg=t5_cfg,
            clip_cfg=clip_cfg,
            dit=_build(FluxDiT, dit_cfg, dtype, device, generator),
            vae=_build(FluxVAE, vae_cfg, dtype, device, generator),
            t5=_build(T5Encoder, t5_cfg, dtype, device, generator),
            clip=_build(CLIPTextEncoder, clip_cfg, dtype, device, generator),
            t5_tokenizer=load_tokenizer(tokenizer_path, "t5", t5_cfg.vocab_size, 1),
            clip_tokenizer=load_tokenizer(tokenizer_path, "clip", clip_cfg.vocab_size,
                                          clip_cfg.eos_token_id),
            dtype=dtype,
            device=device,
        )

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = None) -> "FluxPipeline":
        """Load a local diffusers FLUX.1 snapshot (`utils.hf_loader`) on `device`:
        cuda by default; without CUDA that raises unless device="cpu"."""
        from ..utils.hf_loader import load_flux_pipeline

        return load_flux_pipeline(cls, model_dir, dtype=dtype, device=device)

    def to_device(self, device: str | torch.device) -> "FluxPipeline":
        """Move every model to `device` (a rank's own device under a mesh)."""
        device = torch.device(device)
        for name in ("dit", "vae", "t5", "clip", "cond_dit_params"):
            model = getattr(self, name)
            if model is not None:
                model.to(device)
        self.device = device
        return self

    def set_mesh(self, mesh) -> "FluxPipeline":
        """Serve over `mesh` (a `RankMesh`; every rank of it calls this, each
        holding the same weights: the same snapshot or seed, or
        `parallel.mesh.replicate_params` first). With a "model" axis of more
        than one rank, the DiT and the cond model are cut to this rank's shard
        (`parallel.specs.shard_dit_params`); call it before `quantize`, which
        then quantizes the cut model in the unfused layout. With a "seq" axis
        and `attn_impl` "ring" or "ring_pallas", call
        `ops.attention.set_ring_context(mesh, "seq")` too: every attention
        then runs over the ring of this rank's seq line (whose ranks take the
        same candidates). `mesh=None` serves unsharded again (a cut DiT stays
        cut)."""
        if mesh is not None and mesh.axis_size("model") > 1:
            shard_dit_params(self.dit, mesh)
            cond = self.cond_dit_params
            if cond is not None and cond is not self.dit:
                shard_dit_params(cond, mesh)
        self.mesh = mesh
        return self

    @torch.no_grad()
    def quantize(
        self,
        which: tuple[str, ...] = ("dit",),
        fuse_qkv: bool = True,
        int4: tuple[str, ...] = ("t5",),
        act_quant_exclude: tuple[str, ...] = (),
        weight_only: tuple[str, ...] = (),
        dit_int4_mlp: bool = False,
        min_size: int = 1 << 20,
        int4_group: int = 128,
    ) -> "FluxPipeline":
        """Quantize the big models in place on their device, as the JAX
        `FluxPipeline.quantize`: `which` models go int8 W8A8, `weight_only`
        ones int8 w8a16, `int4` ones (not in the other two) packed NF4 (w4a16,
        the plane packing, groups of 128). With `fuse_qkv` the DiT's q/k/v
        panels are fused and permuted to the split RoPE layout first
        (`ops.fuse`), the only layout the fused kernels (K2–K5, K8, K9)
        serve. A DiT cut over a "model" axis (`set_mesh`) keeps the unfused
        layout, as JAX does there: its W8A8 linears quantize their
        activations in plain PyTorch (ROW linears over the whole row, through
        a cross-rank amax) and K1 serves the attention; the codes are the
        whole model's (`parallel.specs`). `dit_int4_mlp` packs the DiT's MLP
        linears NF4 in groups of `int4_group` (the co-residency profile; the
        attention and modulation panels stay W8A8). `cond_dit_params`, when
        set, gets the same layout and, with "dit" in `which`, the same
        quantization (fold LoRA views into it before this call, as the JAX CLI
        does). Models: "dit" and "t5"."""
        from ..ops.fuse import fuse_dit_qkv, fuse_single_block_io, permute_rope_layout
        from ..ops.quant import quantize_dit_params, quantize_params_int4

        tp = getattr(self.dit, "tp_size", 1) > 1
        for name in (*which, *weight_only, *int4):
            if name not in ("dit", "t5"):
                raise ValueError(f"quantize: no quantizable model {name!r} (expected 'dit' or 't5')")
        # a latent_lora view is the DiT itself: transform it once
        cond = self.cond_dit_params if self.cond_dit_params is not self.dit else None
        if fuse_qkv and not tp and self.rope_layout != "split":
            for dit in (self.dit, cond):
                if dit is not None:
                    permute_rope_layout(fuse_single_block_io(fuse_dit_qkv(dit)))
            self.rope_layout = "split"
        # the fused serving names (out_mlp) and the unfused ones (mlp_in,
        # single_blocks/out/; the trailing slash keeps out_attn int8), as JAX
        int4_paths = (("img_mlp", "txt_mlp", "out_mlp", "mlp_in", "single_blocks/out/")
                      if dit_int4_mlp else ())
        dit_kw = dict(min_size=min_size, act_quant_exclude=act_quant_exclude, int4_group=int4_group,
                      int4_layout="plane")
        for name in which:
            quantize_dit_params(getattr(self, name), int4_paths=int4_paths if name == "dit" else (),
                                **dit_kw)
        if cond is not None and "dit" in which:
            quantize_dit_params(cond, int4_paths=int4_paths, **dit_kw)
        for name in weight_only:
            if name not in which:
                quantize_dit_params(getattr(self, name), min_size=min_size, act_quant=False)
        for name in int4:
            if name not in which and name not in weight_only:
                quantize_params_int4(getattr(self, name), min_size=min_size, layout="plane")
        return self

    def enable_prompt_cache(self) -> "FluxPipeline":
        """Cache prompt embeddings per ((clip_prompt, t5_prompt), L) with the
        text encoders resident: fixed-prompt loops encode each prompt once.
        Entries are host copies; the cache holds at most `_embed_cache_cap`
        of them (first in, first out)."""
        if self._embed_cache is None:
            self._embed_cache = {}
        return self

    # -- text ---------------------------------------------------------------

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str], max_sequence_length: int = 512,
                       prompts_2: Sequence[str] | None = None):
        """-> (txt (B, L, text_dim), pooled (B, pooled_dim)) on the device.
        `prompts_2` splits the towers as diffusers' prompt_2 does: CLIP pools
        `prompts`, T5 encodes `prompts_2`.

        With the prompt cache on, only the misses reach the encoders, as one
        batch in sorted order; a key this call reads is never evicted (the
        cache may then exceed its cap until a later call)."""
        if prompts_2 is not None and len(prompts_2) != len(prompts):
            raise ValueError(
                f"prompts_2 must pair 1:1 with prompts: got {len(prompts_2)} vs {len(prompts)}")
        pairs = list(zip(prompts, prompts_2 if prompts_2 is not None else prompts))
        cache = self._embed_cache
        if cache is None:
            return self._encode_raw(pairs, max_sequence_length)
        misses = sorted({pr for pr in pairs if (pr, max_sequence_length) not in cache})
        if misses:
            txt_m, pooled_m = (t.cpu() for t in self._encode_raw(misses, max_sequence_length))
            for i, pr in enumerate(misses):
                cache[(pr, max_sequence_length)] = (txt_m[i].clone(), pooled_m[i].clone())
            # refined-prompt loops mint new prompts every round: bound the cache
            needed = {(pr, max_sequence_length) for pr in pairs}
            while len(cache) > self._embed_cache_cap:
                victim = next((k for k in cache if k not in needed), None)
                if victim is None:
                    break
                cache.pop(victim)
        txt = torch.stack([cache[(pr, max_sequence_length)][0] for pr in pairs])
        pooled = torch.stack([cache[(pr, max_sequence_length)][1] for pr in pairs])
        return txt.to(self.device), pooled.to(self.device)

    def warm_prompt_cache(self, prompts: Sequence[str], max_sequence_length: int = 512,
                          batch: int = 16) -> None:
        """Encode every distinct prompt once, in batches of `batch`, so later
        `generate` calls read the cache."""
        uniq = sorted(set(prompts))
        for i in range(0, len(uniq), batch):
            self.encode_prompts(uniq[i : i + batch], max_sequence_length)

    def _encode_raw(self, pairs: Sequence[tuple[str, str]], max_sequence_length: int):
        """(clip_prompt, t5_prompt) pairs -> (txt, pooled) on the device."""
        t5_ids = self.t5_tokenizer([t for _, t in pairs], max_length=max_sequence_length)["input_ids"]
        txt = t5_encode(self.t5, torch.from_numpy(t5_ids).long().to(self.device))
        clip_ids = self.clip_tokenizer([c for c, _ in pairs],
                                       max_length=self.clip_cfg.max_position_embeddings)
        _, pooled = clip_text_encode(self.clip, torch.from_numpy(clip_ids["input_ids"]).long().to(self.device))
        return txt.to(self.dtype), pooled.to(self.dtype)

    # -- generation ---------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        prompts: Sequence[str],
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        max_sequence_length: int = 512,
        seed: int | None = 0,
        latents: torch.Tensor | np.ndarray | None = None,
        conditions: list[Condition] | None = None,
        condition_scale: float = 1.0,
        image_guidance_scale: float = 1.0,
        output_type: str = "np",
        txt: torch.Tensor | None = None,
        pooled: torch.Tensor | None = None,
        prompts_2: Sequence[str] | None = None,
    ):
        """Sample images: uint8 numpy (B, H, W, 3) for "np", the final packed
        latents for "latent". `latents` injection (packed (B, L, C)) bypasses
        seeding: same latents -> same images.

        `conditions` (one per prompt) add the cond stream: VAE-encoded
        condition tokens read through `cond_dit_params`, coupled to the main
        tokens by `model_flags` and log(`condition_scale`) when it is not 1.
        `image_guidance_scale` != 1 adds image CFG against black conditions."""
        if output_type not in ("np", "latent"):
            raise ValueError(f"output_type must be 'np' or 'latent', got {output_type!r}")
        B = len(prompts)
        down = self.vae_cfg.downscale
        ty, tx = latent_tokens(height, width, down)
        if latents is None:
            if seed is None:  # fresh entropy when the caller doesn't pin one
                import secrets

                seed = secrets.randbits(31)
            latents = draw_packed_noise(threefry.prng_key(seed), B, height, width,
                                        self.vae_cfg.latent_channels, self.dtype, vae_downscale=down,
                                        device=self.device)
        latents = torch.as_tensor(latents).to(self.device, self.dtype)
        mesh = self._data_mesh(B)
        if mesh is not None:  # this rank's candidates: the whole batch was drawn above
            prompts, prompts_2, latents, txt, pooled, conditions = shard_batch(
                (list(prompts), None if prompts_2 is None else list(prompts_2), latents, txt, pooled,
                 None if not conditions else list(conditions)), mesh)
        if txt is None or pooled is None:
            txt, pooled = self.encode_prompts(prompts, max_sequence_length, prompts_2=prompts_2)
        cond = cond_ids = cond_empty = None
        if conditions:
            cond, cond_ids = encode_conditions(conditions, self.vae, self.dtype, tiled=self.vae_tiling)
            if image_guidance_scale != 1.0:
                cond_empty, _ = encode_conditions(conditions, self.vae, self.dtype, empty=True,
                                                  tiled=self.vae_tiling)
        final = denoise(
            self.dit,
            latents,
            txt,
            pooled,
            torch.from_numpy(make_image_ids(ty, tx)).to(self.device),
            torch.from_numpy(make_text_ids(txt.shape[1])).to(self.device),
            make_schedule(num_inference_steps, ty * tx),
            guidance_scale,
            num_inference_steps,
            cond=cond,
            cond_ids=cond_ids,
            cond_empty=cond_empty,
            cond_dit_params=self.cond_dit_params if conditions else None,
            image_guidance_scale=image_guidance_scale,
            c_factor=None if condition_scale == 1.0 else float(condition_scale),
            union_cond_attn=self.model_flags.get("union_cond_attn", True),
            add_cond_attn=self.model_flags.get("add_cond_attn", False),
            attn_impl=self.attn_impl,
            rope_layout=self.rope_layout,
            **vcache_kwargs(self.vcache, num_inference_steps),
        )
        if output_type == "latent":
            return final if mesh is None else gather_candidates(final, mesh)
        images = self._decode_uint8(final, height, width)
        if mesh is not None:
            images = gather_candidates(images, mesh)
        return images.cpu().numpy()

    def _data_mesh(self, batch: int):
        """The mesh when this call shards its candidates over "data", else
        None. A "model" axis needs the DiT cut by `set_mesh`; a batch that
        the data axis does not divide warns and runs unsharded, as JAX does."""
        mesh = self.mesh
        if mesh is None:
            return None
        if mesh.axis_size("model") != getattr(self.dit, "tp_size", 1):
            raise ValueError(f"mesh {mesh.shape} has a model axis of {mesh.axis_size('model')}, the "
                             f"DiT is cut {getattr(self.dit, 'tp_size', 1)} ways: use set_mesh")
        d = mesh.axis_size("data")
        if d == 1:
            return None
        if batch % d:
            import warnings

            warnings.warn(f"batch {batch} not divisible by data axis {d}; running unsharded "
                          "(use parallel.mesh.pad_candidates)", stacklevel=3)
            return None
        return mesh

    @torch.no_grad()
    def decode_latents(self, final: torch.Tensor, height: int, width: int) -> np.ndarray:
        """Packed latents -> uint8 images (B, H, W, 3) on the host."""
        return self._decode_uint8(final, height, width).cpu().numpy()

    def _decode_uint8(self, final: torch.Tensor, height: int, width: int) -> torch.Tensor:
        grid = unpack_latents(final, *latent_tokens(height, width, self.vae_cfg.downscale))
        images = (vae_decode_tiled if self.vae_tiling else vae_decode)(self.vae, grid)
        return ((images.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
