"""The port's Qwen2.5-VL video path against the JAX package: the frame-count
policy and frame indices, the pixel budgets and their grids, the readers
(arrays, lists, `.npy` / `.npz`, PNG frame directories), temporal patching
(bitwise in fp32), the reward-model prompt templates, the model's 4-D input,
and `QwenRewardVerifier` scores of a clip and of a mixed image + clip batch
(1e-4 of max |ref|), on the tiny fp32 Qwen2.5-VL carried over by
`utils/jax_bridge.py`. About 20 s on one core."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.config import QwenVLVisionConfig as JVisCfg
from reflectionflow_tpu.models.qwen_vl import video as jvideo
from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
from reflectionflow_tpu.models.qwen_vl.reward import RewardHead as JHead
from reflectionflow_tpu.rm_train import prompt_template as jtemplate
from reflectionflow_tpu.verifiers.qwen_verifier import QwenRewardVerifier as JVerifier
from reflectionflow_tpu_torch.config import QwenVLVisionConfig
from reflectionflow_tpu_torch.models.qwen_vl import video
from reflectionflow_tpu_torch.models.qwen_vl.reward import RewardHead
from reflectionflow_tpu_torch.rm_train import prompt_template
from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

from test_torch_qwen_vl import bridge, close

torch.set_num_threads(1)


def clip(T=4, H=32, W=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3), dtype=np.uint8)


def test_budgets_match_jax():
    for name in ("VIDEO_MIN_PIXELS", "VIDEO_MAX_PIXELS", "VIDEO_TOTAL_PIXELS", "FRAME_FACTOR", "FPS",
                 "FPS_MIN_FRAMES", "FPS_MAX_FRAMES"):
        assert getattr(video, name) == getattr(jvideo, name), name


@pytest.mark.parametrize("total,fps_in", [(300, 30.0), (30, 30.0), (6, 1.0), (8, 2.0), (1000, 24.0), (17, 3.0)])
def test_frame_counts_and_indices_match_jax(total, fps_in):
    for kw in ({}, {"fps": 10.0}, {"nframes": 5}, {"nframes": 4}, {"min_frames": 2, "max_frames": 8}):
        try:
            want = jvideo.sample_frame_indices(total, fps_in, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                video.sample_frame_indices(total, fps_in, **kw)
            continue
        assert video.smart_nframes(total, fps_in, **kw) == jvideo.smart_nframes(total, fps_in, **kw)
        assert video.sample_frame_indices(total, fps_in, **kw) == want
    if total * 8 // fps_in >= 7:
        assert (video.sample_frame_indices(total, fps_in, sample_type="multi_pts")
                == jvideo.sample_frame_indices(total, fps_in, sample_type="multi_pts"))
    else:
        with pytest.raises(ValueError, match="too short"):
            video.sample_frame_indices(total, fps_in, sample_type="multi_pts")
    for bad in ({"nframes": 4, "fps": 2.0}, {"sample_type": "nope"}):
        with pytest.raises(ValueError):
            video.sample_frame_indices(total, fps_in, **bad)


@pytest.mark.parametrize("case", [
    dict(shape=(4, 28, 28), kw=dict(nframes=4, min_pixels=28 * 28)),  # no resize
    dict(shape=(4, 28, 28), kw=dict(nframes=4)),  # the min-pixel floor upscales
    dict(shape=(8, 560, 560), kw=dict(nframes=2, total_pixels=2 * 128 * 28 * 28, min_pixels=28 * 28)),
    dict(shape=(8, 560, 560), kw=dict(nframes=8, total_pixels=2 * 128 * 28 * 28, min_pixels=28 * 28)),
    dict(shape=(8, 448, 448), kw=dict(max_pixels=448 * 448)),  # the verifier's budget: 448 px stays
    dict(shape=(6, 100, 60), kw=dict(max_pixels=64 * 64, image_factor=8)),
])
def test_fetch_video_matches_jax(case):
    """The same frames and grid, bit for bit, resized or not (the port's copy
    of PIL's bicubic)."""
    frames = clip(*case["shape"], seed=1)
    want = jvideo.fetch_video(frames, **case["kw"])
    got = video.fetch_video(frames, **case["kw"])
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_readers_match_jax(tmp_path):
    from PIL import Image

    frames = clip(T=4, H=28, W=28)
    kw = dict(nframes=4, min_pixels=28 * 28)
    np.save(tmp_path / "clip.npy", frames)
    np.savez(tmp_path / "clip.npz", frames=frames)
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:03d}.png")
    for src in (frames, list(frames), str(tmp_path / "clip.npy"), "file://" + str(tmp_path / "clip.npz"), str(d),
                frames.astype(np.float32) / 255.0, frames.astype(np.float64)):
        got = video.fetch_video(src, **kw)
        np.testing.assert_array_equal(got, jvideo.fetch_video(src, **kw))
        np.testing.assert_array_equal(got, frames)
    with pytest.raises(ValueError, match="codec"):
        video.fetch_video(str(tmp_path / "clip.mp4"))
    with pytest.raises(ValueError, match="no image frames"):
        (tmp_path / "empty").mkdir()
        video.fetch_video(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="expected"):
        video.fetch_video(frames[0])
    with pytest.raises(TypeError):
        video.fetch_video(3)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5])
def test_video_to_patches_bitwise(T):
    cfg, jcfg = QwenVLVisionConfig.tiny(), JVisCfg.tiny()
    frames = clip(T=T, H=32, W=48, seed=T)
    p, grid = video.video_to_patches(frames, cfg)
    jp, jgrid = jvideo.video_to_patches(frames, jcfg)
    assert grid == jgrid == (-(-T // cfg.temporal_patch_size), 32 // cfg.patch_size, 48 // cfg.patch_size)
    assert p.dtype == np.float32
    np.testing.assert_array_equal(p, jp)


@pytest.mark.parametrize("template_type", ["none", "simple", "video_score", "detailed", "detailed_special", "bad"])
def test_prompt_templates_match_jax(template_type):
    for dims in (None, ["MQ"], ["VQ", "TA", "Overall"], ["custom"]):
        if template_type == "bad":
            with pytest.raises(ValueError, match="unknown template_type"):
                prompt_template.build_prompt("a cat runs", dims, template_type)
            continue
        assert (prompt_template.build_prompt("a cat runs", dims, template_type)
                == jtemplate.build_prompt("a cat runs", dims, template_type))
    assert prompt_template.DIMENSION_DESCRIPTIONS == jtemplate.DIMENSION_DESCRIPTIONS
    assert prompt_template.SPECIAL_TOKEN == jtemplate.SPECIAL_TOKEN


@pytest.fixture(scope="module")
def verifiers():
    jm = JModel.random_init(jax.random.PRNGKey(0), dtype=jnp.float32)
    jh = JHead.random_init(jax.random.PRNGKey(1), jm.lm_cfg.hidden_size, pooling="last")
    ph = RewardHead(w=torch.from_numpy(np.array(jh.w)), pooling=jh.pooling, special_token_id=jh.special_token_id)
    # 32 px frames under a 32 x 32 budget: no resize, so both packages see the same pixels
    return (JVerifier(model=jm, head=jh, max_pixels=32 * 32),
            QwenRewardVerifier(model=bridge(jm), head=ph, max_pixels=32 * 32), jm)


def test_model_takes_a_clip(verifiers):
    _, pv, jm = verifiers
    toks = pv.rm.model.tokens
    c = clip(T=4, H=32, W=32, seed=2)
    n = 2 * 4 * 4  # (4 / tp) x (32 / 4 / 2)^2 merged tokens
    ids = np.asarray([3, toks.vision_start] + [toks.video_pad] * n + [toks.vision_end, 9])
    close(pv.rm.model.forward_logits(ids, [c]), jm.forward_logits(ids, [c]))


def test_verifier_scores_a_clip(verifiers):
    jv, pv, _ = verifiers
    c = clip(T=4, H=32, W=32)
    ids, _, grid = pv._prepare_ids(c, "a rotating cube")
    jids, _, jgrid = jv._prepare_ids(c, "a rotating cube")
    assert grid == jgrid == (2, 8, 8)
    np.testing.assert_array_equal(ids, jids)
    assert (ids == pv.rm.model.tokens.video_pad).sum() == 2 * 4 * 4
    got = pv.reward([c], ["a rotating cube"])
    close([got[0]["VQ"]], [jv.reward([c], ["a rotating cube"])[0]["VQ"]])
    assert np.isfinite(got[0]["VQ"]) and got[0]["VQ"] != pv.reward([c[0]], ["a rotating cube"])[0]["VQ"]


def test_verifier_scores_a_mixed_batch(verifiers):
    jv, pv, _ = verifiers
    c, img = clip(T=4, H=32, W=32, seed=3), clip(T=1, H=32, W=32, seed=4)[0]
    got = pv.reward([img, c, img, clip(T=6, H=32, W=32, seed=5)], ["a", "b", "a", "c"])
    want = jv.reward([img, c, img, clip(T=6, H=32, W=32, seed=5)], ["a", "b", "a", "c"])
    close([g["VQ"] for g in got], [w["VQ"] for w in want])
    assert got[0]["VQ"] == got[2]["VQ"]
