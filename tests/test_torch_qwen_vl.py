"""The port's Qwen2.5-VL (`reflectionflow_tpu_torch/models/qwen_vl/`) against
the JAX package's at `QwenLMConfig.tiny()` / `QwenVLVisionConfig.tiny()`,
fp32, the same weights carried over by `utils/jax_bridge.py`: the LM with and
without an attention mask, the vision tower at a grid that is not a multiple
of the window, `embed_sequence` and `get_rope_index`, the cached decode
against a full forward, and `decode_batch`'s greedy ids over ragged rows with
two image grids. Each within 1e-4 of max |ref|. About 25 s on one core."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import QwenVLVisionConfig as JVisConfig
from reflectionflow_tpu.models.qwen_vl import lm as jlm
from reflectionflow_tpu.models.qwen_vl import vision as jvision
from reflectionflow_tpu.models.qwen_vl.generate import QwenVLGenerator as JGenerator
from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
from reflectionflow_tpu.models.qwen_vl.model import get_rope_index as j_get_rope_index
from reflectionflow_tpu_torch.config import QwenLMConfig, QwenVLVisionConfig
from reflectionflow_tpu_torch.models.qwen_vl import lm as plm
from reflectionflow_tpu_torch.models.qwen_vl import vision as pvision
from reflectionflow_tpu_torch.models.qwen_vl.generate import QwenVLGenerator
from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel, get_rope_index
from reflectionflow_tpu_torch.utils.jax_bridge import qwen_lm_state_dict, qwen_vision_state_dict

torch.set_num_threads(1)
REL = 1e-4
IMG, VSTART, VEND = 151655, 151652, 151653


def port_cfgs(jm):
    return (QwenLMConfig(**dataclasses.asdict(jm.lm_cfg)), QwenVLVisionConfig(**dataclasses.asdict(jm.vis_cfg)))


def bridge(jm) -> QwenVLModel:
    """The JAX model's weights in a port `QwenVLModel` (fp32, CPU)."""
    lm_cfg, vis_cfg = port_cfgs(jm)
    pm = QwenVLModel(lm_cfg, vis_cfg)
    sd = {**qwen_lm_state_dict(jax.tree.map(np.asarray, jm.lm_params), lm_cfg),
          **qwen_vision_state_dict(jax.tree.map(np.asarray, jm.vision_params), vis_cfg)}
    pm.load_state_dict(sd, strict=True)
    return pm.eval().requires_grad_(False)


def close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


@pytest.fixture(scope="module")
def models():
    jm = JModel.random_init(jax.random.PRNGKey(0), dtype=jnp.float32)
    return jm, bridge(jm)


@pytest.fixture(scope="module")
def window_models():
    """A window of 2 x 2 merge units (window_size 16 at patch 4, merge 2), so a
    grid of 3 units a side leaves truncated edge windows."""
    vis_cfg = dataclasses.replace(JVisConfig.tiny(), window_size=16, fullatt_block_indexes=(1,))
    jm = JModel.random_init(jax.random.PRNGKey(3), vis_cfg=vis_cfg, dtype=jnp.float32)
    return jm, bridge(jm)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_matches_jax(models, masked):
    jm, pm = models
    rng = np.random.default_rng(0)
    B, L, H = 2, 11, jm.lm_cfg.hidden_size
    emb = rng.standard_normal((B, L, H)).astype(np.float32)
    pos = np.cumsum(rng.integers(0, 2, (3, B, L)), axis=-1).astype(np.int64)
    mask = np.ones((B, L), np.int32)
    if masked:
        mask[1, :4] = 0  # a left-padded row
    m = mask if masked else None
    ref, _ = jlm.qwen_lm_apply(jm.lm_params, jm.lm_cfg, jnp.asarray(emb), jnp.asarray(pos),
                               attention_mask=None if m is None else jnp.asarray(m))
    got, _ = plm.qwen_lm_apply(pm.model, pm.lm_head, torch.from_numpy(emb), torch.from_numpy(pos),
                               attention_mask=None if m is None else torch.from_numpy(m))
    close(got, ref)
    hid_ref, _ = jlm.qwen_lm_apply(jm.lm_params, jm.lm_cfg, jnp.asarray(emb), jnp.asarray(pos), return_hidden=True)
    hid, _ = plm.qwen_lm_apply(pm.model, pm.lm_head, torch.from_numpy(emb), torch.from_numpy(pos),
                               return_hidden=True)
    close(hid, hid_ref)


@pytest.mark.parametrize("px", [(24, 24), (24, 16), (8, 8)])
def test_vision_tower_matches_jax_with_edge_windows(window_models, px):
    jm, pm = window_models
    img = np.random.default_rng(1).integers(0, 255, (*px, 3), dtype=np.uint8)
    patches, grid = jvision.image_to_patches(img, jm.vis_cfg)
    p_patches, p_grid = pvision.image_to_patches(img, pm.vis_cfg)
    assert p_grid == grid and np.array_equal(p_patches, patches)
    ref = jvision.qwen_vision_apply(jm.vision_params, jm.vis_cfg, jnp.asarray(patches), grid)
    got = pvision.qwen_vision_apply(pm.visual, torch.from_numpy(np.ascontiguousarray(patches)), grid)
    close(got, ref)
    # a same-grid batch is the per-image result, as the vmapped JAX batch
    both = pvision.qwen_vision_apply(pm.visual, torch.from_numpy(np.stack([patches, patches * 0.5])), grid)
    close(both[0], got, rel=1e-6)
    for a, b in zip(jvision.vision_geometry(jm.vis_cfg, *grid), pvision.vision_geometry(pm.vis_cfg, *grid)):
        assert np.array_equal(a, b)


def test_smart_resize_matches_jax():
    for hw in ((1024, 1024), (512, 300), (30, 2000), (20, 20), (4000, 3000)):
        assert pvision.smart_resize(*hw, max_pixels=448 * 448) == jvision.smart_resize(*hw, max_pixels=448 * 448)


def _ids(n_img_tokens, extra):
    return np.concatenate([[7], [VSTART], [IMG] * n_img_tokens, [VEND], [9] * extra, [11]]).astype(np.int64)


def test_embed_sequence_and_rope_index_match_jax(models):
    jm, pm = models
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8), rng.integers(0, 255, (24, 16, 3), dtype=np.uint8)]
    ids = np.concatenate([_ids(4, 3), [VSTART], [IMG] * 6, [VEND], [5, 6]]).astype(np.int64)
    e_ref, p_ref = jm.embed_sequence(ids, imgs)
    e, p = pm.embed_sequence(ids, imgs)
    close(e, e_ref)
    assert np.array_equal(p.numpy(), np.asarray(p_ref))
    assert np.array_equal(get_rope_index(ids, [(1, 4, 4), (1, 6, 4)], 2, IMG),
                          j_get_rope_index(ids, [(1, 4, 4), (1, 6, 4)], 2, IMG))
    # a clip of two temporal patches: the temporal stream scaled by int(seconds) * tokens_per_second
    ids_v = np.concatenate([_ids(4, 1), [VSTART], [151656] * 12, [VEND], [5]]).astype(np.int64)
    for spg in (1.5, [2.0], [0.5]):
        kw = dict(video_pad_id=151656, seconds_per_grid=spg)
        assert np.array_equal(get_rope_index(ids_v, [(1, 4, 4), (2, 6, 4)], 2, IMG, **kw),
                              j_get_rope_index(ids_v, [(1, 4, 4), (2, 6, 4)], 2, IMG, **kw))
    close(pm.forward_logits(ids, imgs), jm.forward_logits(ids, imgs))


def test_cached_decode_matches_full_forward(models):
    """Prefill of L left-padded positions through the cache, then two decode
    steps: each step's logits equal a full causal forward over the valid
    tokens (port), and the port's cached path equals the JAX cached path."""
    jm, pm = models
    rng = np.random.default_rng(4)
    H, L, pad = jm.lm_cfg.hidden_size, 9, 3
    emb = rng.standard_normal((1, L + 2, H)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L + 2)[None, None], (3, 1, L + 2)).copy()
    full, _ = plm.qwen_lm_apply(pm.model, pm.lm_head, torch.from_numpy(emb[:, pad:]), torch.from_numpy(pos[:, :, : L + 2 - pad]))
    padded = np.concatenate([np.zeros((1, pad, H), np.float32), emb[:, pad:L]], axis=1)
    ppos = np.concatenate([np.zeros((3, 1, pad), np.int64), pos[:, :, : L - pad]], axis=-1)
    cache = plm.init_kv_cache(pm.lm_cfg, 1, L + 4, dtype=torch.float32)
    cache["pad"] = torch.tensor([pad])
    jcache = jlm.init_kv_cache(jm.lm_cfg, 1, L + 4, dtype=jnp.float32)
    jcache["pad"] = jnp.asarray([pad])
    got, cache = plm.qwen_lm_apply(pm.model, pm.lm_head, torch.from_numpy(padded), torch.from_numpy(ppos), kv_cache=cache)
    ref, jcache = jlm.qwen_lm_apply(jm.lm_params, jm.lm_cfg, jnp.asarray(padded), jnp.asarray(ppos), kv_cache=jcache)
    close(got[:, pad:], ref[:, pad:])
    close(got[:, -1], full[:, L - pad - 1])
    for step in range(2):
        e = emb[:, L + step : L + step + 1]
        p = pos[:, :, L - pad + step : L - pad + step + 1]
        got, cache = plm.qwen_lm_apply(pm.model, pm.lm_head, torch.from_numpy(e), torch.from_numpy(p), kv_cache=cache)
        ref, jcache = jlm.qwen_lm_apply(jm.lm_params, jm.lm_cfg, jnp.asarray(e), jnp.asarray(p), kv_cache=jcache)
        close(got, ref)
        close(got[:, 0], full[:, L - pad + step])
    assert cache["len"] == L + 2


def test_decode_batch_greedy_ids_match_jax(models):
    """Ragged left-padded rows with two image grids (the JAX test's batch):
    the port's greedy ids are the JAX generator's, batched and per row."""
    jm, pm = models
    rng = np.random.default_rng(2)

    def seq(img_px, extra):
        img = rng.integers(0, 255, (img_px, img_px, 3), dtype=np.uint8)
        return _ids((img_px // 8) ** 2, extra), [img]

    seqs = [seq(16, 2), seq(16, 7), seq(24, 3)]
    ref = JGenerator(model=jm, tokenizer=None, eos_token_id=-1).decode_batch(seqs, max_new_tokens=6)
    gen = QwenVLGenerator(model=pm, tokenizer=None, eos_token_id=-1)
    assert gen.decode_batch(seqs, max_new_tokens=6) == ref
    assert [gen.decode_ids(*s, max_new_tokens=6) for s in seqs] == ref
    # an EOS ends a row: the JAX generator's lengths with the first greedy token as EOS
    eos = ref[0][0]
    assert QwenVLGenerator(model=pm, eos_token_id=eos).decode_batch(seqs, max_new_tokens=6) == \
        JGenerator(model=jm, tokenizer=None, eos_token_id=eos).decode_batch(seqs, max_new_tokens=6)
