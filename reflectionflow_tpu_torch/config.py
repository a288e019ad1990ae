"""One typed config tree for the PyTorch port.

Counterpart of `reflectionflow_tpu/config.py`, with the same dataclasses,
defaults and JSON keys, so every file under `configs/` loads into both trees
to equal field values. The only difference is `DTYPE_MAP`, which maps the
reference's `torch_dtype` names to torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

DTYPE_MAP = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
    "fp32": torch.float32,
    "float32": torch.float32,
}


def _build(cls, data: dict):
    """Construct a dataclass from a dict, recursing into nested dataclasses
    and ignoring unknown keys (forward compat with reference configs)."""
    if data is None:
        return cls()
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            continue
        f = names[k]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            kwargs[k] = _build(f.type, v)
        else:
            kwargs[k] = v
    obj = cls(**kwargs)
    # recurse for dataclass fields given as dicts via default types
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(_FIELD_TYPES.get((cls, f.name))):
            setattr(obj, f.name, _build(_FIELD_TYPES[(cls, f.name)], v))
    return obj


_FIELD_TYPES: dict = {}


# ---------------------------------------------------------------------------
# Model architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FluxDiTConfig:
    """FLUX.1 DiT (rectified-flow MMDiT). Defaults = FLUX.1-dev scale."""

    in_channels: int = 64  # 16 latent ch x 2x2 packing
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    mlp_ratio: float = 4.0
    num_double_blocks: int = 19
    num_single_blocks: int = 38
    text_dim: int = 4096  # T5-XXL hidden
    pooled_dim: int = 768  # CLIP-L pooled
    axes_dims_rope: tuple[int, int, int] = (16, 56, 56)
    rope_theta: int = 10000
    guidance_embeds: bool = True  # FLUX.1-dev distilled guidance
    time_freq_dim: int = 256

    @property
    def mlp_hidden(self) -> int:
        return int(self.hidden_size * self.mlp_ratio)

    @staticmethod
    def tiny() -> "FluxDiTConfig":
        """Small config for tests: same topology, toy widths."""
        return FluxDiTConfig(
            in_channels=16,
            hidden_size=64,
            num_heads=4,
            head_dim=16,
            num_double_blocks=2,
            num_single_blocks=2,
            text_dim=32,
            pooled_dim=32,  # == CLIPTextConfig.tiny().hidden_size
            axes_dims_rope=(4, 6, 6),
            time_freq_dim=32,
        )


@dataclass(frozen=True)
class FluxVAEConfig:
    """FLUX AutoencoderKL. Defaults = FLUX.1 scale (16 latent channels)."""

    in_channels: int = 3
    latent_channels: int = 16
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def tiny() -> "FluxVAEConfig":
        return FluxVAEConfig(
            latent_channels=4,
            block_out_channels=(8, 16),
            layers_per_block=1,
            norm_num_groups=4,
            scaling_factor=1.0,
            shift_factor=0.0,
        )


@dataclass(frozen=True)
class T5Config:
    """T5 v1.1 encoder. Defaults = T5-XXL (FLUX text encoder 2)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP-L/14 text encoder (FLUX text encoder 1, pooled output only)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    eos_token_id: int = 49407

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=16, eos_token_id=2,
        )


@dataclass(frozen=True)
class QwenVLVisionConfig:
    """Qwen2.5-VL vision tower (window attention + 2D M-RoPE)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584  # LM hidden
    rms_norm_eps: float = 1e-6

    @staticmethod
    def tiny() -> "QwenVLVisionConfig":
        return QwenVLVisionConfig(
            depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
            patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
            window_size=8, fullatt_block_indexes=(1,), out_hidden_size=32,
        )


@dataclass(frozen=True)
class QwenLMConfig:
    """Qwen2.5 decoder LM. Defaults = Qwen2.5-VL-7B LM."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    mrope_section: tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = False

    @staticmethod
    def tiny() -> "QwenLMConfig":
        # head_dim = hidden/heads (HF convention); mrope sums to head_dim//2
        return QwenLMConfig(
            vocab_size=152000, hidden_size=32, intermediate_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=8, mrope_section=(1, 1, 2),
        )


@dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP vision tower (pre-LN ViT, no CLS token, learned positions).
    Defaults = SigLIP-SO400M-patch14-448, the NVILA tower."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 27
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 448
    layer_norm_eps: float = 1e-6

    @staticmethod
    def tiny() -> "SiglipVisionConfig":
        return SiglipVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=3, num_heads=4,
            patch_size=4, image_size=24,
        )


@dataclass(frozen=True)
class NvilaConfig:
    """NVILA/VILA glue: tower feature tap + token-compressing projector.

    `select_layer` follows LLaVA/VILA convention: hidden_states index into
    [embeddings, block_1, ..., block_N] (so -2 = output of block N-1, NO
    final post-layernorm). `downsample` is the projector's spatial token
    compression factor per side (VILA "mlp_downsample" = 2,
    "mlp_downsample_3x3_fix" = 3); the projector itself is
    LayerNorm(C*k^2) -> Linear -> GELU -> Linear."""

    select_layer: int = -2
    downsample: int = 3
    media_token: str = "<image>"


# transformers' `Dinov2Config` defaults: what a snapshot's backbone_config
# means by a key it leaves out
_DINOV2_JSON_DEFAULTS = {
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "mlp_ratio": 4,
    "hidden_act": "gelu", "layer_norm_eps": 1e-6, "image_size": 224, "patch_size": 14, "num_channels": 3,
    "qkv_bias": True, "layerscale_value": 1.0, "use_swiglu_ffn": False, "apply_layernorm": True,
    "reshape_hidden_states": True, "use_mask_token": True,
}


@dataclass(frozen=True)
class Dinov2Config:
    """DINOv2 backbone of Depth Anything (pre-LN ViT with a CLS token, learned
    positions interpolated to the input's grid, LayerScale). Defaults =
    depth-anything-small's backbone, the one transformers'
    `DepthAnythingConfig` builds when `backbone_config` is None.
    `out_indices` index [embeddings, layer_1, ..., layer_N]."""

    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4
    layer_norm_eps: float = 1e-6
    image_size: int = 518
    patch_size: int = 14
    num_channels: int = 3
    qkv_bias: bool = True
    layerscale_value: float = 1.0
    out_indices: tuple[int, ...] = (9, 10, 11, 12)
    apply_layernorm: bool = True
    use_mask_token: bool = True

    @staticmethod
    def from_json(d: dict) -> "Dinov2Config":
        """A snapshot's `backbone_config`, keys missing meaning transformers'
        `Dinov2Config` defaults; what the port does not run raises ValueError."""
        if d.get("model_type", "dinov2") != "dinov2":
            raise ValueError(f"Depth Anything backbone {d.get('model_type')!r}: the port runs DINOv2 only "
                             "(ROADMAP queue 1)")
        g = {**_DINOV2_JSON_DEFAULTS, **{k: v for k, v in d.items() if v is not None}}
        if g["hidden_act"] != "gelu" or g["use_swiglu_ffn"]:
            raise ValueError(f"a DINOv2 MLP of hidden_act {g['hidden_act']!r}, use_swiglu_ffn "
                             f"{g['use_swiglu_ffn']}: the port runs the GELU MLP (ROADMAP queue 1)")
        if g["reshape_hidden_states"]:
            raise ValueError("a DINOv2 backbone with reshape_hidden_states: Depth Anything's neck reads token "
                             "rows (ROADMAP queue 1)")
        n = g["num_hidden_layers"]
        stages = ["stem"] + [f"stage{i}" for i in range(1, n + 1)]
        # transformers' backbone keeps the stages named in out_features, in stage order
        if d.get("out_features") is not None:
            out = tuple(sorted({stages.index(s) for s in d["out_features"]}))
        elif d.get("out_indices") is not None:
            out = tuple(sorted({i % (n + 1) for i in d["out_indices"]}))
        else:
            out = (n,)
        return Dinov2Config(
            hidden_size=g["hidden_size"], num_layers=n, num_heads=g["num_attention_heads"],
            mlp_ratio=g["mlp_ratio"], layer_norm_eps=g["layer_norm_eps"], image_size=g["image_size"],
            patch_size=g["patch_size"], num_channels=g["num_channels"], qkv_bias=g["qkv_bias"],
            layerscale_value=g["layerscale_value"], out_indices=out,
            apply_layernorm=g["apply_layernorm"], use_mask_token=g["use_mask_token"])

    def to_json(self) -> dict:
        """transformers' `backbone_config` keys."""
        return {"model_type": "dinov2", "hidden_size": self.hidden_size, "num_hidden_layers": self.num_layers,
                "num_attention_heads": self.num_heads, "mlp_ratio": self.mlp_ratio, "hidden_act": "gelu",
                "layer_norm_eps": self.layer_norm_eps, "image_size": self.image_size,
                "patch_size": self.patch_size, "num_channels": self.num_channels, "qkv_bias": self.qkv_bias,
                "layerscale_value": self.layerscale_value, "use_swiglu_ffn": False,
                "out_indices": list(self.out_indices), "apply_layernorm": self.apply_layernorm,
                "reshape_hidden_states": False, "use_mask_token": self.use_mask_token}

    @staticmethod
    def tiny() -> "Dinov2Config":
        return Dinov2Config(hidden_size=32, num_layers=4, num_heads=4, out_indices=(1, 2, 3, 4))


@dataclass(frozen=True)
class DepthAnythingConfig:
    """Depth Anything (`DepthAnythingForDepthEstimation`): a DINOv2 backbone,
    the DPT neck (reassemble, 3x3 convs, feature fusion) and the depth head.
    Defaults = depth-anything-small (transformers' `DepthAnythingConfig()`);
    the V2 checkpoints share the class. "relative" ends the head in ReLU,
    "metric" in sigmoid x max_depth."""

    backbone: Dinov2Config = field(default_factory=Dinov2Config)
    patch_size: int = 14
    reassemble_hidden_size: int = 384
    reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple[int, ...] = (48, 96, 192, 384)
    fusion_hidden_size: int = 64
    head_in_index: int = -1
    head_hidden_size: int = 32
    depth_estimation_type: str = "relative"
    max_depth: float = 1.0

    def __post_init__(self):
        if self.depth_estimation_type not in ("relative", "metric"):
            raise ValueError(f"depth_estimation_type {self.depth_estimation_type!r}: 'relative' or 'metric'")
        if len(self.neck_hidden_sizes) != len(self.reassemble_factors) or \
                len(self.neck_hidden_sizes) != len(self.backbone.out_indices):
            raise ValueError("Depth Anything needs one backbone output, neck width and reassemble factor a stage")

    @staticmethod
    def from_json(d: dict) -> "DepthAnythingConfig":
        """A snapshot's `config.json`, keys missing meaning transformers'
        defaults. Another `model_type`, a backbone named rather than
        configured, or a timm backbone raises ValueError."""
        if d.get("model_type") != "depth_anything":
            raise ValueError(f"model_type {d.get('model_type')!r}: the port's depth preprocessor runs "
                             "'depth_anything' snapshots only (ROADMAP queue 1)")
        if d.get("use_timm_backbone") or (d.get("backbone") and d.get("backbone_config") is None):
            raise ValueError(f"a Depth Anything snapshot with backbone {d.get('backbone')!r}: the port needs "
                             "backbone_config (ROADMAP queue 1)")
        bb = d.get("backbone_config")
        default = DepthAnythingConfig()
        return DepthAnythingConfig(
            backbone=Dinov2Config() if bb is None else Dinov2Config.from_json(bb),
            patch_size=d.get("patch_size", 14),
            reassemble_hidden_size=d.get("reassemble_hidden_size", default.reassemble_hidden_size),
            reassemble_factors=tuple(d.get("reassemble_factors", default.reassemble_factors)),
            neck_hidden_sizes=tuple(d.get("neck_hidden_sizes", default.neck_hidden_sizes)),
            fusion_hidden_size=d.get("fusion_hidden_size", default.fusion_hidden_size),
            head_in_index=d.get("head_in_index", -1),
            head_hidden_size=d.get("head_hidden_size", default.head_hidden_size),
            depth_estimation_type=d.get("depth_estimation_type", "relative"),
            max_depth=d.get("max_depth") or 1.0)  # transformers: `max_depth if max_depth else 1`

    def to_json(self) -> dict:
        """transformers' `config.json` keys."""
        return {"architectures": ["DepthAnythingForDepthEstimation"], "model_type": "depth_anything",
                "backbone": None, "backbone_config": self.backbone.to_json(), "patch_size": self.patch_size,
                "reassemble_hidden_size": self.reassemble_hidden_size,
                "reassemble_factors": list(self.reassemble_factors), "neck_hidden_sizes": list(self.neck_hidden_sizes),
                "fusion_hidden_size": self.fusion_hidden_size, "head_in_index": self.head_in_index,
                "head_hidden_size": self.head_hidden_size, "depth_estimation_type": self.depth_estimation_type,
                "max_depth": self.max_depth, "torch_dtype": "float32"}

    @staticmethod
    def tiny(depth_estimation_type: str = "relative") -> "DepthAnythingConfig":
        return DepthAnythingConfig(backbone=Dinov2Config.tiny(), reassemble_hidden_size=32,
                                   neck_hidden_sizes=(8, 16, 24, 32), fusion_hidden_size=16, head_hidden_size=8,
                                   depth_estimation_type=depth_estimation_type,
                                   max_depth=20.0 if depth_estimation_type == "metric" else 1.0)


# ---------------------------------------------------------------------------
# TTS (search) configs — key names mirror the reference JSON schema
# ---------------------------------------------------------------------------


@dataclass
class PipelineArgs:
    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    max_sequence_length: int = 512
    condition_size: int = 512
    torch_dtype: str = "bf16"  # reference key name; maps through DTYPE_MAP
    lora_path: Optional[str] = None
    image_guidance_scale: float = 1.0
    # The port serves quantize="int8" (W8A8 DiT + w8a16 T5, or the NF4
    # profiles t5_quant="int4" / dit_quant="int8_int4mlp"), attn_impl,
    # vae_tiling and the velocity cache (vcache, sampler/generate.py).
    quantize: Optional[str] = None  # "int8": W8A8 DiT + quantized T5
    attn_impl: Optional[str] = None  # "xla" (plain) | "pallas" (K1) | "pallas_nr" (K9) | "pallas_int8" (K8)
    t5_quant: Optional[str] = None  # "int8" (w8a16) | "int4" (NF4), under quantize="int8"
    dit_quant: str = "int8"  # "int8" | "int8_int4mlp", under quantize="int8"
    vae_tiling: bool = False  # tiled VAE decode/encode
    vcache: Optional[dict] = None  # velocity cache schedule
    # XLA compilation cache dir of the JAX package; no meaning here
    compilation_cache: Optional[str] = None

    @property
    def dtype(self):
        return DTYPE_MAP[self.torch_dtype]


@dataclass
class SearchArgs:
    search_method: str = "random"
    search_branch: int = 2
    search_rounds: int = 16
    top_k: int = 1


@dataclass
class VerifierArgs:
    name: str = "fake"  # fake | fake_nvila | qwen_rm | nvila | nvila_jax | openai
    model_path: Optional[str] = None
    model_name: Optional[str] = None
    base_url: Optional[str] = None
    cache_dir: Optional[str] = None
    max_workers: int = 4
    max_new_tokens: Optional[int] = None
    choice_of_metric: str = "overall_score"
    quantize: Optional[str] = None
    device_index: Optional[int] = None  # place the verifier on another device
    # prompt-asset overrides (reference key names)
    verifier_prompt_relpath: str = "verifier_prompt.txt"
    refine_prompt_relpath: str = "refine_prompt.txt"
    reflexion_prompt_relpath: str = "reflexion_prompt.txt"


@dataclass
class ReflectionArgs:
    run_reflection: bool = True
    name: str = "fake"  # backend: fake | local_qwen | openai
    base_url: Optional[str] = None  # OpenAI-compatible endpoint (e.g. a local server)
    model_name: Optional[str] = None
    model_path: Optional[str] = None  # local_qwen weights
    quantize: Optional[str] = None
    device_index: Optional[int] = None  # place the reflection model on another device
    max_retries: int = 5
    retry_delay_s: float = 2.0
    # local_qwen message format — match a finetuned Reflection-Generator's
    # training-time input. Fields: {original_prompt} {current_prompt}
    # {prev_reflection} {evaluation}. None = reference-shaped default
    # (reflect.generator.DEFAULT_TEMPLATE / DEFAULT_SYSTEM); system_prompt=""
    # drops the system turn entirely.
    template: Optional[str] = None
    system_prompt: Optional[str] = None

    @property
    def backend(self) -> str:
        return self.name


@dataclass
class RefineArgs:
    run_refinement: bool = True
    name: str = "fake"
    base_url: Optional[str] = None
    model_name: Optional[str] = None
    choice_of_metric: str = "overall_score"
    max_new_tokens: Optional[int] = None

    @property
    def backend(self) -> str:
        return self.name


@dataclass
class ModelFlags:
    union_cond_attn: bool = True
    add_cond_attn: bool = False
    latent_lora: bool = False


@dataclass
class TTSConfig:
    pipeline_args: PipelineArgs = field(default_factory=PipelineArgs)
    search_args: SearchArgs = field(default_factory=SearchArgs)
    verifier_args: VerifierArgs = field(default_factory=VerifierArgs)
    refine_args: VerifierArgs = field(default_factory=VerifierArgs)  # refiner endpoint params
    reflection_args: ReflectionArgs = field(default_factory=ReflectionArgs)
    prompt_refiner_args: RefineArgs = field(default_factory=RefineArgs)
    model: ModelFlags = field(default_factory=ModelFlags)
    batch_size_for_img_gen: int = 8
    use_low_gpu_vram: bool = False  # accepted for config compat
    output_dir: str = "output"
    pretrained_model_name_or_path: str = "black-forest-labs/FLUX.1-dev"

    @staticmethod
    def load(path: str, overrides: dict[str, Any] | None = None) -> "TTSConfig":
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml

                data = yaml.safe_load(f)
            else:
                data = json.load(f)
        if overrides:
            data.update(overrides)
        return _build(TTSConfig, data)


_FIELD_TYPES.update(
    {
        (TTSConfig, "pipeline_args"): PipelineArgs,
        (TTSConfig, "search_args"): SearchArgs,
        (TTSConfig, "verifier_args"): VerifierArgs,
        (TTSConfig, "refine_args"): VerifierArgs,
        (TTSConfig, "reflection_args"): ReflectionArgs,
        (TTSConfig, "prompt_refiner_args"): RefineArgs,
        (TTSConfig, "model"): ModelFlags,
    }
)


# ---------------------------------------------------------------------------
# Training configs
# ---------------------------------------------------------------------------


@dataclass
class LoraArgs:
    r: int = 32
    alpha: int = 32
    init: str = "gaussian"
    # module-name suffixes receiving adapters
    target_suffixes: tuple[str, ...] = (
        "to_q", "to_k", "to_v", "to_out",
        "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
        "mlp_in", "mlp_out", "txt_mlp_in", "txt_mlp_out",
        "linear1_attn", "linear1_mlp", "linear2",
        "modulation", "txt_modulation",
    )


@dataclass
class OptimizerArgs:
    name: str = "prodigy"  # prodigy | adamw | sgd
    lr: float = 1.0
    weight_decay: float = 0.01
    grad_clip: float = 0.5
    grad_accum: int = 1


@dataclass
class DataArgs:
    shards: tuple[str, ...] = ()
    batch_size: int = 8
    target_size: int = 512
    condition_size: int = 512
    drop_text_prob: float = 0.1
    drop_image_prob: float = 0.1
    drop_reflection_prob: float = 0.2
    # stage-scheduled subset mixture: list of (step, {subset: ratio})
    training_stages: tuple = ()


@dataclass
class TrainConfig:
    lora: LoraArgs = field(default_factory=LoraArgs)
    optimizer: OptimizerArgs = field(default_factory=OptimizerArgs)
    data: DataArgs = field(default_factory=DataArgs)
    dtype: str = "bf16"
    max_steps: int = 16000
    save_interval: int = 2000
    sample_interval: int = 1000
    seed: int = 0
    # "pallas" at FLUX scale: the flash backward avoids per-layer 5632^2
    # fp32 logits (8.8x step speedup measured, tools/train_smoke_tpu.py);
    # "xla" remains the CPU-test default via tiny configs
    attn_impl: str = "xla"
    checkpoint_dir: str = "ckpt"
    mesh_shape: tuple[int, ...] = (-1,)  # data-parallel by default
    split_ratios: Optional[dict] = None  # {subset: [ratio per stage]}

    @staticmethod
    def load(path: str) -> "TrainConfig":
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml

                data = yaml.safe_load(f)
            else:
                data = json.load(f)
        if "train" in data and isinstance(data["train"], dict):
            return TrainConfig.from_reference_yaml(data)
        return _build(TrainConfig, data)

    @staticmethod
    def from_reference_yaml(data: dict) -> "TrainConfig":
        """Accept the upstream train_flux/config.yaml layout: top-level
        model_path/dtype, `train:` block with dataset/lora_config/optimizer
        subtrees."""
        train = data.get("train", {})
        dataset = train.get("dataset", {})
        lora_cfg = train.get("lora_config", {})
        opt = train.get("optimizer", {})
        opt_params = opt.get("params", {})
        stages = dataset.get("training_stages", ())
        split_ratios = dataset.get("split_ratios")
        cfg = TrainConfig(
            lora=LoraArgs(
                r=lora_cfg.get("r", 32),
                alpha=lora_cfg.get("lora_alpha", lora_cfg.get("alpha", 32)),
                init=("gaussian" if lora_cfg.get("init_lora_weights", "gaussian") == "gaussian" else "zeros"),
            ),
            optimizer=OptimizerArgs(
                name=str(opt.get("type", "prodigy")).lower(),
                lr=opt_params.get("lr", 1.0),
                weight_decay=opt_params.get("weight_decay", 0.01),
                grad_clip=train.get("gradient_clip_val", 0.5),
                grad_accum=train.get("accumulate_grad_batches", 1),
            ),
            data=DataArgs(
                shards=tuple([dataset["path"]] if isinstance(dataset.get("path"), str) else dataset.get("path", ())),
                batch_size=train.get("batch_size", 8),
                condition_size=dataset.get("condition_size", 512),
                target_size=dataset.get("target_size", 512),
                drop_text_prob=dataset.get("drop_text_prob", 0.1),
                drop_image_prob=dataset.get("drop_image_prob", 0.1),
                drop_reflection_prob=dataset.get("drop_reflection_prob", 0.2),
                training_stages=tuple(stages),
            ),
            dtype={"bfloat16": "bf16"}.get(data.get("dtype", "bf16"), data.get("dtype", "bf16")),
            max_steps=train.get("max_steps", -1) if train.get("max_steps", -1) > 0 else 16000,
            save_interval=train.get("save_interval", 2000),
            sample_interval=train.get("sample_interval", 1000),
            checkpoint_dir=train.get("save_path", "ckpt"),
        )
        if split_ratios:
            cfg.split_ratios = {k: list(v) for k, v in split_ratios.items()}
        return cfg


_FIELD_TYPES.update(
    {
        (TrainConfig, "lora"): LoraArgs,
        (TrainConfig, "optimizer"): OptimizerArgs,
        (TrainConfig, "data"): DataArgs,
    }
)
