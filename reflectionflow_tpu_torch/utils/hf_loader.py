"""Load published snapshots (local directories, no network) onto a device.

Counterpart of `reflectionflow_tpu/utils/hf_loader.py`:
  * FLUX.1 (diffusers layout): `transformer/`, `vae/`, `text_encoder/` (CLIP),
    `text_encoder_2/` (T5), `tokenizer/`, `tokenizer_2/`;
  * Qwen2.5-VL: flat safetensors shards, `config.json` and the tokenizer files;
  * NVILA (a VILA bundle): `llm/` (Qwen2 causal LM and its tokenizer),
    `vision_tower/` (SigLIP), `mm_projector/` and a root `config.json`.

The port's modules carry the diffusers / transformers parameter names, so a
snapshot needs no conversion: each module is built on the meta device,
materialised on the target device in the target dtype, and filled shard by
shard with `load_state_dict`, one shard in host memory at a time (a Qwen
checkpoint's adapter and reward-head files, `QWEN_SIDECARS`, are not
shards). A tensor
the module lacks, or one the snapshot lacks, raises; the only names dropped
are the ones that are not parameters of the module (`_IGNORED`: T5's tied
`encoder.embed_tokens.weight`, CLIP's `position_ids` buffer, SigLIP's
attention-pooling head, which no VILA tap reads, and a tied Qwen
`lm_head.weight`).
"""

from __future__ import annotations

import glob
import json
import os

import torch
from torch import nn

from ..config import (CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, NvilaConfig, QwenLMConfig, QwenVLVisionConfig,
                      SiglipVisionConfig, T5Config)
from .device import default_device
from .safetensors_io import load_file

# files beside a Qwen checkpoint that hold adapters and reward heads, not model weights
QWEN_SIDECARS = ("lora.safetensors", "rm_head.safetensors", "rm_lora.safetensors")
# snapshot names that are not parameters of the port's modules
_IGNORED = {
    "text_encoder_2": ("encoder.embed_tokens.weight",),  # T5: tied to shared.weight
    "text_encoder": ("text_model.embeddings.position_ids",),  # CLIP: an index buffer
    # transformers' SiglipVisionModel attention-pooling head: the VILA tap reads hidden states
    "vision_tower": tuple(f"vision_model.head.{n}" for n in (
        "probe", "attention.in_proj_weight", "attention.in_proj_bias", "attention.out_proj.weight",
        "attention.out_proj.bias", "layernorm.weight", "layernorm.bias", "mlp.fc1.weight", "mlp.fc1.bias",
        "mlp.fc2.weight", "mlp.fc2.bias")),
}


def safetensors_files(path: str, exclude: tuple[str, ...] = ()) -> list[str]:
    """The *.safetensors shards under `path` (JAX `load_safetensors_dir` reads
    them all at once; `load_module` reads them one at a time)."""
    files = sorted(f for f in glob.glob(os.path.join(path, "*.safetensors")) if os.path.basename(f) not in exclude)
    if not files:
        raise FileNotFoundError(f"no safetensors found under {path}")
    return files


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@torch.no_grad()
def load_module(build, path: str, dtype: torch.dtype, device: torch.device, rename=None,
                ignore: tuple[str, ...] = (), tied: dict[str, str] | None = None,
                exclude_files: tuple[str, ...] = ()) -> nn.Module:
    """The module `build()` makes, on `device` in `dtype`, with every tensor of
    the snapshot directory `path`, read one shard at a time. `rename` maps a
    snapshot name to the module's; `ignore` names are skipped; `tied`
    {alias: name} fills `name` from `alias` when the snapshot stores only the
    alias; `exclude_files` are file names that are not part of the model."""
    with torch.device("meta"):
        module = build()
    module = module.to(dtype).to_empty(device=device)
    kind = type(module).__name__
    expected = set(module.state_dict())
    loaded: set[str] = set()
    aliases: dict[str, torch.Tensor] = {}
    for f in safetensors_files(path, exclude_files):
        shard = {}
        for k, v in load_file(f).items():
            k = rename(k) if rename else k
            if tied and k in tied:
                aliases[tied[k]] = v
            if k in ignore:
                continue
            shard[k] = v
        extra = sorted(set(shard) - expected)
        if extra:
            raise KeyError(f"{f}: {len(extra)} tensors {kind} has no parameter for: {extra[:8]}")
        module.load_state_dict(shard, strict=False)
        loaded |= set(shard)
        del shard
    for name, v in aliases.items():
        if name not in loaded and name in expected:
            module.load_state_dict({name: v}, strict=False)
            loaded.add(name)
    missing = sorted(expected - loaded)
    if missing:
        raise KeyError(f"{path}: {len(missing)} {kind} tensors missing from the snapshot: {missing[:8]}")
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# FLUX
# ---------------------------------------------------------------------------


def flux_dit_config_from_json(cfg_json: dict) -> FluxDiTConfig:
    return FluxDiTConfig(
        in_channels=cfg_json.get("in_channels", 64),
        hidden_size=cfg_json.get("num_attention_heads", 24) * cfg_json.get("attention_head_dim", 128),
        num_heads=cfg_json.get("num_attention_heads", 24),
        head_dim=cfg_json.get("attention_head_dim", 128),
        num_double_blocks=cfg_json.get("num_layers", 19),
        num_single_blocks=cfg_json.get("num_single_layers", 38),
        text_dim=cfg_json.get("joint_attention_dim", 4096),
        pooled_dim=cfg_json.get("pooled_projection_dim", 768),
        axes_dims_rope=tuple(cfg_json.get("axes_dims_rope", (16, 56, 56))),
        guidance_embeds=cfg_json.get("guidance_embeds", True),
    )


def flux_configs_from_dir(model_dir: str):
    """-> (dit_cfg, vae_cfg, t5_cfg, clip_cfg) from the components' config.json files."""
    dit_cfg = flux_dit_config_from_json(_read_json(os.path.join(model_dir, "transformer", "config.json")))
    vae_json = _read_json(os.path.join(model_dir, "vae", "config.json"))
    vae_cfg = FluxVAEConfig(
        in_channels=vae_json.get("in_channels", 3),
        latent_channels=vae_json.get("latent_channels", 16),
        block_out_channels=tuple(vae_json.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=vae_json.get("layers_per_block", 2),
        norm_num_groups=vae_json.get("norm_num_groups", 32),
        scaling_factor=vae_json.get("scaling_factor", 0.3611),
        shift_factor=vae_json.get("shift_factor", 0.1159),
    )
    t5_json = _read_json(os.path.join(model_dir, "text_encoder_2", "config.json"))
    t5_cfg = T5Config(vocab_size=t5_json["vocab_size"], d_model=t5_json["d_model"], d_kv=t5_json["d_kv"],
                      d_ff=t5_json["d_ff"], num_layers=t5_json["num_layers"], num_heads=t5_json["num_heads"])
    clip_json = _read_json(os.path.join(model_dir, "text_encoder", "config.json"))
    clip_cfg = CLIPTextConfig(
        vocab_size=clip_json["vocab_size"],
        hidden_size=clip_json["hidden_size"],
        intermediate_size=clip_json["intermediate_size"],
        num_layers=clip_json["num_hidden_layers"],
        num_heads=clip_json["num_attention_heads"],
        max_position_embeddings=clip_json["max_position_embeddings"],
        eos_token_id=clip_json.get("eos_token_id", 2),
    )
    return dit_cfg, vae_cfg, t5_cfg, clip_cfg


def load_flux_pipeline(cls, model_dir: str, dtype=torch.bfloat16, device: torch.device | None = None):
    """A FluxPipeline (`cls`) from a local FLUX.1 snapshot directory, on
    `device` (default cuda)."""
    from ..models.flux.dit import FluxDiT
    from ..models.flux.text import CLIPTextEncoder, T5Encoder
    from ..models.flux.vae import FluxVAE
    from .tokenizers import load_tokenizer

    device = default_device(device)
    dit_cfg, vae_cfg, t5_cfg, clip_cfg = flux_configs_from_dir(model_dir)
    comp = lambda name: os.path.join(model_dir, name)  # noqa: E731
    return cls(
        dit_cfg=dit_cfg,
        vae_cfg=vae_cfg,
        t5_cfg=t5_cfg,
        clip_cfg=clip_cfg,
        dit=load_module(lambda: FluxDiT(dit_cfg), comp("transformer"), dtype, device),
        vae=load_module(lambda: FluxVAE(vae_cfg), comp("vae"), dtype, device),
        t5=load_module(lambda: T5Encoder(t5_cfg), comp("text_encoder_2"), dtype, device,
                       ignore=_IGNORED["text_encoder_2"], tied={"encoder.embed_tokens.weight": "shared.weight"}),
        clip=load_module(lambda: CLIPTextEncoder(clip_cfg), comp("text_encoder"), dtype, device,
                         ignore=_IGNORED["text_encoder"]),
        t5_tokenizer=load_tokenizer(comp("tokenizer_2"), "t5", t5_cfg.vocab_size, 1),
        clip_tokenizer=load_tokenizer(comp("tokenizer"), "clip", clip_cfg.vocab_size, clip_cfg.eos_token_id),
        dtype=dtype,
        device=device,
    )


# ---------------------------------------------------------------------------
# Qwen2.5-VL
# ---------------------------------------------------------------------------


def qwen_configs_from_json(cfg_json: dict) -> tuple[QwenLMConfig, QwenVLVisionConfig]:
    text = cfg_json.get("text_config", cfg_json)
    vis = cfg_json["vision_config"]
    lm_cfg = QwenLMConfig(
        vocab_size=text["vocab_size"],
        hidden_size=text["hidden_size"],
        intermediate_size=text["intermediate_size"],
        num_layers=text["num_hidden_layers"],
        num_heads=text["num_attention_heads"],
        num_kv_heads=text["num_key_value_heads"],
        head_dim=text["hidden_size"] // text["num_attention_heads"],
        rope_theta=text.get("rope_theta", 1000000.0),
        mrope_section=tuple(text.get("rope_scaling", {}).get("mrope_section", (16, 24, 24))),
        tie_word_embeddings=text.get("tie_word_embeddings", False),
    )
    vis_cfg = QwenVLVisionConfig(
        depth=vis["depth"],
        hidden_size=vis["hidden_size"],
        intermediate_size=vis["intermediate_size"],
        num_heads=vis["num_heads"],
        patch_size=vis["patch_size"],
        temporal_patch_size=vis["temporal_patch_size"],
        spatial_merge_size=vis["spatial_merge_size"],
        window_size=vis["window_size"],
        fullatt_block_indexes=tuple(vis["fullatt_block_indexes"]),
        out_hidden_size=vis["out_hidden_size"],
    )
    return lm_cfg, vis_cfg


def normalize_qwen_key(k: str) -> str:
    """transformers' newer layout (`model.language_model.*`, `model.visual.*`)
    -> the older one (`model.*`, `visual.*`) the modules carry (a copy of
    `reflectionflow_tpu/utils/hf_convert.py::_normalize_qwen_keys`)."""
    return k.replace("model.language_model.", "model.").replace("model.visual.", "visual.")


def load_qwen_vl(model_dir: str, dtype=torch.bfloat16, device: torch.device | None = None):
    """-> (QwenVLModel on `device` (default cuda), its Qwen2 tokenizer, or None
    when the snapshot has no tokenizer files)."""
    from ..models.qwen_vl.model import QwenVLModel
    from .bpe import Qwen2BPETokenizer, has_qwen2_files

    lm_cfg, vis_cfg = qwen_configs_from_json(_read_json(os.path.join(model_dir, "config.json")))
    model = load_module(lambda: QwenVLModel(lm_cfg, vis_cfg), model_dir, dtype, default_device(device),
                        rename=normalize_qwen_key,
                        ignore=("lm_head.weight",) if lm_cfg.tie_word_embeddings else (),
                        exclude_files=QWEN_SIDECARS)
    tokenizer = Qwen2BPETokenizer.from_dir(model_dir) if has_qwen2_files(model_dir) else None
    return model, tokenizer


# ---------------------------------------------------------------------------
# NVILA (a VILA bundle: llm/ + vision_tower/ + mm_projector/)
# ---------------------------------------------------------------------------

PROJECTOR_DOWNSAMPLE = {
    "mlp": 1,
    "mlp_downsample": 2,
    "mlp_downsample_2x2_fix": 2,
    "mlp_downsample_3x3": 3,
    "mlp_downsample_3x3_fix": 3,
}


def qwen2_lm_config_from_json(cfg_json: dict) -> QwenLMConfig:
    """A plain Qwen2 / Qwen2.5 causal-LM config (the `llm/` of a VILA bundle);
    1-D RoPE as an M-RoPE whose first section spans the frequency axis."""
    head_dim = cfg_json.get("head_dim") or cfg_json["hidden_size"] // cfg_json["num_attention_heads"]
    return QwenLMConfig(
        vocab_size=cfg_json["vocab_size"],
        hidden_size=cfg_json["hidden_size"],
        intermediate_size=cfg_json["intermediate_size"],
        num_layers=cfg_json["num_hidden_layers"],
        num_heads=cfg_json["num_attention_heads"],
        num_kv_heads=cfg_json["num_key_value_heads"],
        head_dim=head_dim,
        rope_theta=cfg_json.get("rope_theta", 1000000.0),
        rms_norm_eps=cfg_json.get("rms_norm_eps", 1e-6),
        mrope_section=(head_dim // 2, 0, 0),
        tie_word_embeddings=cfg_json.get("tie_word_embeddings", False),
    )


def siglip_config_from_json(cfg_json: dict) -> SiglipVisionConfig:
    v = cfg_json.get("vision_config", cfg_json)
    return SiglipVisionConfig(
        hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"],
        num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"],
        patch_size=v["patch_size"],
        image_size=v["image_size"],
        layer_norm_eps=v.get("layer_norm_eps", 1e-6),
    )


def projector_type(model_dir: str, root_cfg: dict) -> str:
    """`mm_projector/config.json`'s `mm_projector_type` (some releases nest it in
    a dict), else the root config's `mm_projector`, else "mlp_downsample_3x3_fix"."""
    proj_type = root_cfg.get("mm_projector", "mlp_downsample_3x3_fix")
    proj_cfg_path = os.path.join(model_dir, "mm_projector", "config.json")
    if os.path.exists(proj_cfg_path):
        proj_type = _read_json(proj_cfg_path).get("mm_projector_type", proj_type)
    if isinstance(proj_type, dict):
        proj_type = proj_type.get("mm_projector_type", "mlp_downsample_3x3_fix")
    return proj_type


def load_nvila(model_dir: str, dtype=torch.bfloat16, device: torch.device | None = None):
    """A VILA bundle directory -> `NvilaModel` on `device` (default cuda) with the
    bundle's Qwen2 tokenizer from `llm/` (None without tokenizer files).

    The projector's layout follows its type: `layers.{1,2,4}` (LayerNorm,
    Linear, Linear) for the downsample types, `layers.{0,2}` for plain "mlp";
    an unknown type raises ValueError. The tower's names may carry the
    `vision_model.` prefix or not; the tap is the root config's
    `mm_vision_select_layer` (default -2)."""
    from ..models.nvila.model import NvilaModel, NvilaProjector, Qwen2CausalLM
    from ..models.nvila.siglip import SiglipVisionModel
    from .bpe import Qwen2BPETokenizer, has_qwen2_files

    device = default_device(device)
    root_cfg_path = os.path.join(model_dir, "config.json")
    root_cfg = _read_json(root_cfg_path) if os.path.exists(root_cfg_path) else {}
    lm_dir, vis_dir, proj_dir = (os.path.join(model_dir, d) for d in ("llm", "vision_tower", "mm_projector"))
    lm_cfg = qwen2_lm_config_from_json(_read_json(os.path.join(lm_dir, "config.json")))
    vis_cfg = siglip_config_from_json(_read_json(os.path.join(vis_dir, "config.json")))
    proj_type = projector_type(model_dir, root_cfg)
    if proj_type not in PROJECTOR_DOWNSAMPLE:
        raise ValueError(f"unsupported mm_projector type: {proj_type!r}")
    cfg = NvilaConfig(select_layer=root_cfg.get("mm_vision_select_layer", -2),
                      downsample=PROJECTOR_DOWNSAMPLE[proj_type])
    norm = proj_type != "mlp"
    with torch.device("meta"):
        model = NvilaModel(vis_cfg, lm_cfg, cfg, norm=norm)
    model.vision_tower = load_module(
        lambda: SiglipVisionModel(vis_cfg), vis_dir, dtype, device,
        rename=lambda k: k if k.startswith("vision_model.") else "vision_model." + k,
        ignore=_IGNORED["vision_tower"])
    model.mm_projector = load_module(
        lambda: NvilaProjector(vis_cfg.hidden_size, lm_cfg.hidden_size, cfg.downsample, norm), proj_dir, dtype,
        device, rename=lambda k: k.removeprefix("mm_projector."))
    model.llm = load_module(lambda: Qwen2CausalLM(lm_cfg), lm_dir, dtype, device,
                            ignore=("lm_head.weight",) if lm_cfg.tie_word_embeddings else ())
    model.tokenizer = Qwen2BPETokenizer.from_dir(lm_dir) if has_qwen2_files(lm_dir) else None
    return model.eval()
