"""ControlNet residual hooks and the canny / coloring / deblurring condition
preprocessors of the PyTorch port, against the JAX package.

ControlNet: the JAX package's `flux_dit_apply` with stacked residuals
(n_hooks, B, L_img, hidden) against `FluxDiT.forward` on the same perturbed
weights (`utils/jax_bridge.py`) and seeded numpy inputs, fp32, with and
without the cond stream, the port under "xla" and "pallas" (the plain
version of K1 on the CPU), JAX under "xla"; the output within atol 1e-4,
rtol 1e-4 (`test_torch_flux_dit.py`'s bound), and the gradient of a
weighted sum with respect to the residuals and the image input under
`remat` within the same bound.

Preprocessors: the JAX package calls OpenCV (`cv2.Canny(img, 100, 200)`,
`cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`, `cv2.GaussianBlur(img, (0, 0),
sigmaX=4)`); the port has its own numpy versions. Both packages' outputs on
seeded images and on the decoded `tests/data/torch_jpeg/` fixtures must be
equal, every pixel (bound 0). The greyscale rule is checked on every one of
the 2^24 colours.
"""

import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.sampler import condition as jcond
from reflectionflow_tpu_torch.sampler import condition as tcond

from test_torch_flux_dit import ATOL, _inputs, _models, _t

torch.set_num_threads(1)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
TY = TX = 4


def _controlnet_inputs(cfg, n_double, n_single, cond, seed=3):
    x = _inputs(cfg, seed)
    rng = np.random.default_rng(seed + 50)
    B, L = x["img"].shape[:2]
    x["controlnet_block_samples"] = 0.3 * rng.standard_normal((n_double, B, L, cfg.hidden_size),
                                                              dtype=np.float32)
    x["controlnet_single_block_samples"] = 0.3 * rng.standard_normal((n_single, B, L, cfg.hidden_size),
                                                                     dtype=np.float32)
    if cond:
        x["cond"] = rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32)
        x["cond_ids"] = jrope.make_image_ids(TY, TX, position_delta=(0, -TX))
    return x


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cond", [False, True], ids=["t2i", "cond"])
@pytest.mark.parametrize("hooks", [(2, 2), (1, 3)], ids=["hooks2x2", "hooks1x3"])
def test_controlnet_residuals_match_jax(hooks, cond, impl):
    """2 double and 3 single blocks: 2 double hooks serve one block each, 2
    single hooks blocks (0, 1) and (2,); 1 and 3 hooks serve all and one a
    block. The residuals reach the output (it moves by more than the bound)."""
    jcfg, params, dit = _models()
    x = _controlnet_inputs(jcfg, *hooks, cond)
    jparams = jax.tree.map(jnp.asarray, params)
    want = flux_dit_apply(jparams, jcfg, **{k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        got = dit(**{k: _t(v) for k, v in x.items()}, attn_impl=impl)
        plain = dit(**{k: _t(v) for k, v in x.items() if not k.startswith("controlnet")}, attn_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    assert float((got - plain).abs().max()) > 100 * ATOL


@pytest.mark.parametrize("cond", [False, True], ids=["t2i", "cond"])
def test_controlnet_remat_gradient_matches_jax(cond):
    """d sum(w * out) / d (residuals, image input) under remat, both packages."""
    jcfg, params, dit = _models()
    x = _controlnet_inputs(jcfg, 2, 2, cond, seed=5)
    w = np.random.default_rng(9).standard_normal((x["img"].shape[0], TY * TX, jcfg.in_channels),
                                                 dtype=np.float32)
    wrt = ("img", "controlnet_block_samples", "controlnet_single_block_samples")
    jparams = jax.tree.map(jnp.asarray, params)
    rest = {k: jnp.asarray(v) for k, v in x.items() if k not in wrt}

    def j_loss(img, dsmp, ssmp):
        out = flux_dit_apply(jparams, jcfg, img=img, controlnet_block_samples=dsmp,
                             controlnet_single_block_samples=ssmp, remat=True, **rest)
        return jnp.sum(out * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(x[k]) for k in wrt))
    leaves = [_t(x[k]).requires_grad_() for k in wrt]
    out = dit(**dict(zip(wrt, leaves)), **{k: _t(v) for k, v in x.items() if k not in wrt}, remat=True,
              attn_impl="pallas")
    got = torch.autograd.grad((out * _t(w)).sum(), leaves)
    for name, a, b in zip(wrt, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-4, err_msg=name)
        assert float(a.abs().max()) > 0


def test_controlnet_residuals_stay_out_of_module_mode():
    jcfg, _, dit = _models()
    x = {k: _t(v) for k, v in _controlnet_inputs(jcfg, 2, 2, False).items()}
    with pytest.raises(ValueError, match="module cache"):
        dit(**x, return_module_outs=True)


# ---------------------------------------------------------------------------
# the preprocessors
# ---------------------------------------------------------------------------


def _seeded_images():
    """Images with many edges, edges at the thresholds, channel ties and odd
    sizes (a border wider than the image for the 25-tap blur)."""
    imgs = {}
    for seed in range(3):
        rng = np.random.default_rng(seed)
        blocks = cv2.resize(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), (256, 192),
                            interpolation=cv2.INTER_NEAREST)
        imgs[f"blocks{seed}"] = blocks
        imgs[f"noisy_blocks{seed}"] = np.clip(blocks.astype(int) + rng.integers(-20, 21, blocks.shape),
                                              0, 255).astype(np.uint8)
        imgs[f"smooth{seed}"] = cv2.GaussianBlur(rng.integers(0, 256, (120, 200, 3), dtype=np.uint8),
                                                 (0, 0), 1)
        imgs[f"levels{seed}"] = (rng.integers(0, 4, (96, 128, 3)) * 25).astype(np.uint8)
        imgs[f"grey{seed}"] = np.repeat(rng.integers(0, 256, (64, 64, 1), dtype=np.uint8), 3, -1)
    rng = np.random.default_rng(7)
    for shape in ((5, 40, 3), (17, 9, 3), (1, 30, 3), (64, 80, 3)):
        imgs[f"noise{shape[0]}x{shape[1]}"] = rng.integers(0, 256, shape, dtype=np.uint8)
    return imgs


def _fixtures():
    out = {}
    for path in sorted(glob.glob(os.path.join(FIXTURES, "*.jpg"))):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        out[os.path.basename(path)] = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    assert len(out) >= 8
    return out


IMAGES = _seeded_images()


@pytest.mark.parametrize("name", ["canny", "coloring", "deblurring"])
@pytest.mark.parametrize("source", ["seeded", "fixtures"])
def test_preprocessors_match_the_jax_package_bit_for_bit(name, source):
    imgs = IMAGES if source == "seeded" else _fixtures()
    edges = 0
    for label, img in imgs.items():
        want = jcond.PREPROCESSORS[name](img)
        got = tcond.Condition(name, img).preprocess()
        assert got.dtype == np.uint8 and got.shape == want.shape == img.shape, label
        np.testing.assert_array_equal(got, want, err_msg=f"{name} on {label}")
        edges += int((got > 0).sum()) if name == "canny" else 0
    if name == "canny" and source == "seeded":
        assert edges > 10_000  # the images exercise the non-maximum test and the hysteresis


def test_grey_matches_opencv_on_every_colour():
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([r, g, b], -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(tcond.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("sigma", [0.8, 1.5, 4.0, 6.3])
def test_gaussian_blur_matches_opencv_at_other_sigmas(sigma):
    img = IMAGES["noisy_blocks1"]
    np.testing.assert_array_equal(tcond.gaussian_blur(img, sigma), cv2.GaussianBlur(img, (0, 0), sigmaX=sigma))
    grey = img[..., 0].copy()
    np.testing.assert_array_equal(tcond.gaussian_blur(grey, sigma), cv2.GaussianBlur(grey, (0, 0), sigmaX=sigma))


@pytest.mark.parametrize("thresholds", [(50, 150), (100, 200), (150, 100), (10, 30)])
def test_canny_matches_opencv_at_other_thresholds(thresholds):
    for label in ("noisy_blocks0", "smooth1", "levels2"):
        img = IMAGES[label]
        want = cv2.Canny(img, *thresholds)
        np.testing.assert_array_equal(tcond.canny_edges(img, *thresholds), want, err_msg=label)
        np.testing.assert_array_equal(tcond.canny_edges(img[..., 1].copy(), *thresholds),
                                      cv2.Canny(img[..., 1].copy(), *thresholds), err_msg=f"{label} grey")


def test_register_preprocessor_and_depth(monkeypatch):
    img = IMAGES["noise5x40"]
    tcond.register_preprocessor("flip", lambda x: x[:, ::-1])
    try:
        np.testing.assert_array_equal(tcond.Condition("flip", img).preprocess(), img[:, ::-1])
    finally:
        del tcond.PREPROCESSORS["flip"]
    assert set(tcond.PREPROCESSORS) == set(jcond.PREPROCESSORS)
    # depth reads a local snapshot (tests/test_torch_depth.py); the JAX default names a hub model
    monkeypatch.delenv("DEPTH_MODEL_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="local Depth Anything snapshot"):
        tcond.Condition("depth", img).preprocess()
