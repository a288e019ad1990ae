"""The port's `depth` condition preprocessor (`models/depth_anything/`,
`sampler/condition.py::_depth`) against transformers 4.57 on the same weights
and against the JAX package's `_depth`, which runs transformers'
depth-estimation pipeline, on the CPU.

A seeded tiny Depth Anything snapshot (DINOv2 width 32, 4 layers, the
published 518 px position grid) is written by transformers' `save_pretrained`
(`tests/data/torch_depth/make_fixture.py::write_snapshot`) with the published
DPTImageProcessor settings; `DEPTH_MODEL_DIR` points both packages at it.
Limits: the predicted depth within PRED_REL_TOL of max |reference|; the uint8
maps at most STEP_SHARE of pixels one step apart and none further (a pixel on
a step boundary of the truncation moves by one step for any rounding).
About 30 s of one core, most of it importing transformers.
"""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from reflectionflow_tpu_torch.config import DepthAnythingConfig, Dinov2Config
from reflectionflow_tpu_torch.models.depth_anything import (DepthAnythingForDepthEstimation, DepthProcessorConfig,
                                                            load_depth_anything, preprocess, resize_output_size,
                                                            save_depth_anything)
from reflectionflow_tpu_torch.sampler import condition as tcond
from reflectionflow_tpu_torch.train.data import decode_png

PRED_REL_TOL = 1e-5
STEP_SHARE = 1e-3
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_depth")

_spec = importlib.util.spec_from_file_location("torch_depth_fixture", os.path.join(FIXTURE, "make_fixture.py"))
fixture = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixture)

# (H, W): square below 518, rectangles whose sides round to different multiples of 14, one above 518
IMAGES = {"square_64": (64, 64), "rect_96x128": (96, 128), "rect_77x50": (77, 50), "large_600x540": (600, 540)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """(directory, transformers model) of the seeded tiny relative snapshot."""
    path = str(tmp_path_factory.mktemp("depth_snapshot"))
    return path, fixture.write_snapshot(path, seed=5)


@pytest.fixture(scope="module")
def port_model(snapshot):
    return load_depth_anything(snapshot[0], device="cpu")


def _close_maps(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: a pixel {diff.max()} steps apart"
    assert (diff > 0).mean() <= STEP_SHARE, f"{what}: {(diff > 0).mean():.2e} of pixels one step apart"


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape, what
    err = float((got - want).abs().max())
    assert err <= PRED_REL_TOL * float(want.abs().max()), f"{what}: max |diff| {err}"


def test_config_reader_matches_transformers():
    from transformers import DepthAnythingConfig as HFConfig

    assert DepthAnythingConfig.from_json(HFConfig().to_dict()) == DepthAnythingConfig()
    cfg = fixture.tiny_config("metric")
    got = DepthAnythingConfig.from_json(json.loads(cfg.to_json_string()))
    assert got == DepthAnythingConfig.tiny("metric")
    assert got.backbone == Dinov2Config.tiny()
    # the port writes what transformers reads back as the same configuration
    assert DepthAnythingConfig.from_json(HFConfig.from_dict(got.to_json()).to_dict()) == got
    with pytest.raises(ValueError, match="ROADMAP queue 1"):
        DepthAnythingConfig.from_json({"model_type": "dpt"})
    with pytest.raises(ValueError, match="backbone_config"):
        DepthAnythingConfig.from_json({"model_type": "depth_anything", "backbone": "facebook/dinov2-small"})
    with pytest.raises(ValueError, match="DINOv2"):
        DepthAnythingConfig.from_json({"model_type": "depth_anything", "backbone_config": {"model_type": "vit"}})
    with pytest.raises(ValueError, match="GELU MLP"):
        Dinov2Config.from_json({"model_type": "dinov2", "use_swiglu_ffn": True})


@pytest.mark.parametrize("hw", [(518, 518), (280, 378), (126, 98)])
def test_backbone_stages_match_transformers(snapshot, port_model, hw):
    """The four out_indices stages after the final LayerNorm, with the stored
    position grid (518 square) and interpolated ones."""
    _, hf = snapshot
    x = torch.from_numpy(np.random.default_rng(hw[0]).standard_normal((2, 3, *hw)).astype(np.float32))
    with torch.no_grad():
        want = hf.backbone(x).feature_maps
        got = port_model.backbone(x)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"stage {i}")


def test_neck_matches_transformers(snapshot, port_model):
    _, hf = snapshot
    gh, gw = 20, 27
    rng = np.random.default_rng(7)
    feats = [torch.from_numpy(rng.standard_normal((1, 1 + gh * gw, 32)).astype(np.float32)) for _ in range(4)]
    with torch.no_grad():
        want = hf.neck(feats, gh, gw)
        got = port_model.neck(feats, gh, gw)
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"fused map {i}")


@pytest.mark.parametrize("kind", ["relative", "metric"])
def test_head_matches_transformers(tmp_path, kind):
    """The head alone on the same fused maps, and the whole forward, in both
    forms (ReLU; sigmoid x max_depth)."""
    hf = fixture.write_snapshot(str(tmp_path), seed=11, depth_estimation_type=kind)
    port = load_depth_anything(str(tmp_path), device="cpu")
    assert port.cfg.depth_estimation_type == kind
    rng = np.random.default_rng(3)
    fused = [torch.from_numpy(rng.standard_normal((1, 16, 10 * s, 13 * s)).astype(np.float32)) for s in (1, 2, 4, 8)]
    x = torch.from_numpy(rng.standard_normal((1, 3, 140, 182)).astype(np.float32))
    with torch.no_grad():
        _close(port.head(fused, 10, 13), hf.head(fused, 10, 13), "head")
        want = hf(pixel_values=x).predicted_depth
        got = port(x)
    _close(got, want, "forward")
    if kind == "metric":
        assert float(got.max()) <= 20.0 and float(got.min()) >= 0.0


@pytest.mark.parametrize("hw", [(96, 128), (77, 50), (600, 540), (518, 518), (31, 500), (1000, 300), (7, 7)])
def test_processor_pixel_values_match_transformers(hw):
    """DPTImageProcessor's pixel values bit for bit: the resize rule, PIL's
    bicubic, the float64 rescale and the float32 normalization."""
    from PIL import Image
    from transformers import DPTImageProcessor

    img = fixture.seeded_image(*hw, hw[0] + hw[1])
    want = DPTImageProcessor(**fixture.PROCESSOR)(images=Image.fromarray(img), return_tensors="np").pixel_values[0]
    cfg = DepthProcessorConfig.from_json(DPTImageProcessor(**fixture.PROCESSOR).to_dict())
    assert cfg == DepthProcessorConfig()
    got = preprocess(img, cfg)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, *resize_output_size(*hw, cfg))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(IMAGES))
def test_depth_matches_jax_package(snapshot, monkeypatch, name):
    """`Condition("depth", img).preprocess()` in both packages with
    DEPTH_MODEL_DIR at the snapshot; the predicted depth against the
    pipeline's."""
    from PIL import Image
    from transformers import pipeline

    from reflectionflow_tpu.sampler import condition as jcond

    path, _ = snapshot
    monkeypatch.setenv("DEPTH_MODEL_DIR", path)
    monkeypatch.setenv("DEPTH_DEVICE", "cpu")
    img = fixture.seeded_image(*IMAGES[name], len(name))
    want = jcond.Condition("depth", img).preprocess()
    got = tcond.Condition("depth", img).preprocess()
    assert got.shape == img.shape
    _close_maps(got, want, name)
    pred = pipeline(task="depth-estimation", model=path)(Image.fromarray(img))["predicted_depth"]
    _close(tcond.depth_model().predict(img), pred, f"{name} predicted depth")


def test_committed_fixture_matches_jax_package(monkeypatch):
    """The committed snapshot, image and JAX map (chip_smoke phase 18 holds the
    card to them): the files are the manifest's, the port's map and a fresh
    run of the JAX `_depth` agree with the committed map."""
    from reflectionflow_tpu.sampler import condition as jcond

    manifest = json.load(open(os.path.join(FIXTURE, "manifest.json")))
    for name in fixture.FILES:
        with open(os.path.join(FIXTURE, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == manifest[name], name
    img = decode_png(open(os.path.join(FIXTURE, "image.png"), "rb").read())
    want = decode_png(open(os.path.join(FIXTURE, "depth.png"), "rb").read())
    assert img.shape == (*manifest["image_hw"], 3)
    monkeypatch.setenv("DEPTH_MODEL_DIR", FIXTURE)
    monkeypatch.setenv("DEPTH_DEVICE", "cpu")
    _close_maps(tcond.Condition("depth", img).preprocess(), want, "port")
    _close_maps(jcond.Condition("depth", img).preprocess(), want, "JAX")


def test_missing_directory_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("DEPTH_DEVICE", "cpu")
    img = np.zeros((16, 16, 3), np.uint8)
    monkeypatch.delenv("DEPTH_MODEL_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="DEPTH_MODEL_DIR='LiheYoung/depth-anything-small-hf'"):
        tcond.Condition("depth", img).preprocess()
    monkeypatch.setenv("DEPTH_MODEL_DIR", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="DEPTH_MODEL_DIR"):
        tcond.Condition("depth", img).preprocess()
    monkeypatch.setenv("DEPTH_MODEL_DIR", str(tmp_path))  # a directory without config.json
    with pytest.raises(FileNotFoundError, match="config.json"):
        tcond.Condition("depth", img).preprocess()


def test_default_device_is_cuda(snapshot, monkeypatch):
    """Without DEPTH_DEVICE the model goes to cuda, which raises here: nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device works")
    monkeypatch.setenv("DEPTH_MODEL_DIR", snapshot[0])
    monkeypatch.delenv("DEPTH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcond.Condition("depth", np.zeros((16, 16, 3), np.uint8)).preprocess()


def test_model_is_cached_per_path_and_device(snapshot, monkeypatch):
    monkeypatch.setenv("DEPTH_MODEL_DIR", snapshot[0])
    monkeypatch.setenv("DEPTH_DEVICE", "cpu")
    a = tcond.depth_model()
    assert tcond.depth_model(snapshot[0] + os.sep, "cpu") is a
    assert next(a.parameters()).device.type == "cpu" and next(a.parameters()).dtype == torch.float32


def test_random_init_round_trip_and_transformers_reads_it(tmp_path):
    """`random_init` -> `save_depth_anything` -> `load_depth_anything` is the
    same model, transformers' `from_pretrained` reads the snapshot to the
    same forward, and a tensor missing or left over raises."""
    from transformers import DepthAnythingForDepthEstimation as HFModel

    from reflectionflow_tpu_torch.utils.safetensors_io import load_file, save_file

    model = DepthAnythingForDepthEstimation.random_init(4, DepthAnythingConfig.tiny(), device="cpu")
    again = DepthAnythingForDepthEstimation.random_init(4, DepthAnythingConfig.tiny(), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))
    save_depth_anything(model, str(tmp_path))
    loaded = load_depth_anything(str(tmp_path), device="cpu")
    assert loaded.cfg == model.cfg and loaded.processor == model.processor
    sd = model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in loaded.state_dict().items())
    hf = HFModel.from_pretrained(str(tmp_path)).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 3, 98, 140)).astype(np.float32))
    with torch.no_grad():
        _close(model(x), hf(pixel_values=x).predicted_depth, "transformers on the port's snapshot")
    weights = load_file(str(tmp_path / "model.safetensors"))
    save_file({**weights, "head.extra": torch.zeros(1)}, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="head.extra"):
        load_depth_anything(str(tmp_path), device="cpu")
    del weights["head.conv3.bias"]
    save_file(weights, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="head.conv3.bias"):
        load_depth_anything(str(tmp_path), device="cpu")
