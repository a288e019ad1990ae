"""The PyTorch port's corrector training against the JAX package: the
rectified-flow loss and its adapter gradients, the optimizers, the loop with
checkpoint and resume, the GenRef data pipeline and the train CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from reflectionflow_tpu.config import TrainConfig as JTrainConfig
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.train import data as jdata
from reflectionflow_tpu.train.rectified_flow import make_optimizer as j_make_optimizer
from reflectionflow_tpu.train.rectified_flow import rf_loss as j_rf_loss
from reflectionflow_tpu_torch.config import TrainConfig
from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step, rf_loss
from reflectionflow_tpu_torch.train.train_loop import latest_checkpoint, train
from reflectionflow_tpu_torch.utils.jax_bridge import lora_from_jax, lora_to_jax

from test_torch_cond_dit import jax_lora
from test_torch_flux_dit import LT, TX, TY, _models, _t

torch.set_num_threads(1)
B = 2


def _batch(cfg, seed=41):
    rng = np.random.default_rng(seed)
    return {
        "x0": rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
        "cond": rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
        "txt": rng.standard_normal((B, LT, cfg.text_dim), dtype=np.float32),
        "pooled": rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
        "img_ids": jrope.make_image_ids(TY, TX),
        "txt_ids": jrope.make_text_ids(LT),
        "cond_ids": jrope.make_image_ids(TY, TX, position_delta=(0, -TX)),
    }


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rf_loss_and_grads_match_jax(impl):
    """Loss and adapter gradients of one rf_loss, with the JAX key's t and
    x1 injected into the port (tolerance of tests/test_train.py)."""
    jcfg, params, dit = _models()
    jl = jax_lora(params, r=2, alpha=2.0)
    batch = _batch(jcfg)
    key = jax.random.PRNGKey(3)
    k_t, k_noise = jax.random.split(key)
    t = np.asarray(jax.nn.sigmoid(jax.random.normal(k_t, (B,))))
    x1 = np.asarray(jax.random.normal(k_noise, batch["x0"].shape))
    (want_loss, _), want_g = jax.value_and_grad(j_rf_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, jl["adapters"]), jax.tree.map(jnp.asarray, params), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, key, alpha=2.0, r=2,
        attn_impl="pallas_interpret" if impl == "pallas" else "xla")
    lora = lora_from_jax(jl, dit)
    loss, metrics = rf_loss(lora["adapters"], dit, {k: _t(v) for k, v in batch.items()},
                            alpha=2.0, r=2, attn_impl=impl, t=_t(t), noise=_t(x1))
    names = [(n, k) for n, ab in lora["adapters"].items() for k in ("lora_A", "lora_B")]
    grads = torch.autograd.grad(loss, [lora["adapters"][n][k] for n, k in names], allow_unused=True)
    got = {n: {} for n in lora["adapters"]}
    for (n, k), g in zip(names, grads):
        got[n][k] = torch.zeros_like(lora["adapters"][n][k]) if g is None else g
    got_g = lora_to_jax({"_alpha": 2.0, "_r": 2, "adapters": got}, dit)["adapters"]
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-4, rtol=2e-3)
    assert abs(metrics["t_mean"].item() - t.mean()) < 1e-6
    for path, ab in want_g.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(got_g[path][k], np.asarray(ab[k]), atol=2e-4, rtol=2e-3,
                                       err_msg=f"{path} {k}")


@pytest.mark.parametrize("name,accum", [("prodigy", 1), ("prodigy", 2), ("adamw", 1), ("sgd", 2)])
def test_optimizers_match_optax(name, accum):
    """make_optimizer's chain (clip 0.5, then the optimizer, inside MultiSteps
    when accumulating) proposes the updates optax proposes, for 3 updates
    from the same parameters and gradients."""
    over = {"optimizer": {"name": name, "lr": {"prodigy": 1.0, "adamw": 1e-2, "sgd": 0.1}[name],
                          "weight_decay": 0.01, "grad_clip": 0.5, "grad_accum": accum}}
    j_opt = j_make_optimizer(_train_config(JTrainConfig, over))
    t_opt = make_optimizer(_train_config(TrainConfig, over))
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    j_state = j_opt.init([jnp.asarray(p) for p in params])
    t_state = t_opt.init([torch.from_numpy(p.copy()) for p in params])
    for _ in range(3 * accum):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        ju, j_state = j_opt.update([jnp.asarray(g) for g in grads], j_state,
                                   [jnp.asarray(p) for p in params])
        tu, t_state = t_opt.update([torch.from_numpy(g) for g in grads], t_state,
                                   [torch.from_numpy(p.copy()) for p in params])
        for a, b in zip(tu, ju):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
        params = [np.asarray(p) for p in optax.apply_updates([jnp.asarray(p) for p in params], ju)]
    assert any(np.abs(np.asarray(u)).max() > 0 for u in ju)


def _train_config(cls, over):
    cfg = cls()
    for k, v in over["optimizer"].items():
        setattr(cfg.optimizer, k, v)
    return cfg


def _tiny_pipeline():
    from reflectionflow_tpu_torch.cli.common import synthetic_pipeline

    return synthetic_pipeline(torch.device("cpu"))


def test_train_writes_metrics_and_resumes(tmp_path):
    shard = str(tmp_path / "genref_000.tar")
    tdata.write_synthetic_shard(shard, n=4, size=16)
    cfg = TrainConfig()
    cfg.data.batch_size, cfg.data.target_size, cfg.data.condition_size = 1, 16, 8
    cfg.max_steps, cfg.save_interval, cfg.checkpoint_dir = 2, 1, str(tmp_path / "ck")

    def dataset():
        return tdata.GenRefDataset(shards=[shard], batch_size=1, target_size=16, condition_size=8)

    pipe = _tiny_pipeline()
    out = train(pipe, cfg, dataset())
    assert latest_checkpoint(cfg.checkpoint_dir) == 2
    assert (tmp_path / "ck" / "1" / "state.pt").exists()
    B_after_2 = {n: ab["lora_B"].detach().clone() for n, ab in out["adapters"].items()}
    assert any(v.abs().sum() > 0 for v in B_after_2.values())
    cfg.max_steps = 3
    out = train(pipe, cfg, dataset())
    assert latest_checkpoint(cfg.checkpoint_dir) == 3
    rows = [json.loads(line) for line in (tmp_path / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == {"loss", "t_mean", "grad_norm", "step", "ema_loss", "step_time_s"}
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    # the resumed run started from the step-2 adapters and moved them
    assert any(not torch.equal(ab["lora_B"], B_after_2[n]) for n, ab in out["adapters"].items())


def test_train_step_rejects_untrainable_attention():
    _, _, dit = _models()
    with pytest.raises(ValueError, match="no backward pass"):
        make_train_step(dit, make_optimizer(TrainConfig()), attn_impl="pallas_int8")


def test_genref_dataset_matches_jax(tmp_path):
    """A JPEG shard written by the JAX package (PIL's encoder), read by both
    packages on their native tar route, at sizes that really resize (40 px
    sources, target 16, condition 8): the same pixels, prompts,
    descriptions, drops and subsets, batch for batch."""
    from reflectionflow_tpu.utils import native as jnative
    from reflectionflow_tpu_torch.utils import native as tnative

    shard = str(tmp_path / "genref_000.tar")
    jdata.write_synthetic_shard(shard, n=8, size=40)
    assert jnative.get_lib() is not None and jnative.tar_index(shard) is not None
    assert tnative.tar_index(shard) is not None
    fallbacks = tnative.fallbacks
    samples = list(tdata.iter_tar_samples(shard))
    assert len(samples) == 8 and samples[0].good.shape == (40, 40, 3)
    ratios = {"general": [0.5, 0.2], "editing": [0.5, 0.8]}
    kw = dict(shards=[shard], batch_size=3, target_size=16, condition_size=8, seed=5,
              drop_text_prob=0.3, drop_image_prob=0.3, drop_reflection_prob=0.3)
    j_ds = jdata.GenRefDataset(schedule=jdata.StageSchedule(ratios, [0, 4]), **kw)
    t_ds = tdata.GenRefDataset(schedule=tdata.StageSchedule(ratios, [0, 4]), **kw)
    j_it, t_it = iter(j_ds), iter(t_ds)
    for step in range(4):
        j_ds.set_step(step)
        t_ds.set_step(step)
        want, got = next(j_it), next(t_it)
        assert sorted(got) == sorted(want)
        assert got["image"].shape == (3, 16, 16, 3) and got["condition"].shape == (3, 8, 8, 3)
        for k in ("image", "condition"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("original_prompt", "description", "subset", "condition_type"):
            assert got[k] == want[k]
    assert t_ds.schedule.ratios_at(2) == j_ds.schedule.ratios_at(2)
    assert tnative.fallbacks == fallbacks


def test_resize_bound_against_pil():
    """PIL's bicubic `Image.resize`, bit for bit (the port's C++ copy of
    Pillow's fixed-point resampler); identity sizes are exact copies."""
    rng = np.random.default_rng(0)
    for (h, w), size in [((37, 53), (16, 16)), ((20, 20), (47, 31)), ((300, 200), (512, 341)),
                         ((512, 512), (333, 250))]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize(size))
        np.testing.assert_array_equal(tdata.resize(img, size), want)
    img = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    assert np.array_equal(tdata.resize(img, (7, 9)), img)


def test_png_and_jpeg_decoders_match_pil():
    """PIL writes adaptive scanline filters (Sub/Up/Average/Paeth); the PNG
    decoder undoes them exactly, for RGB, RGBA and grey. A baseline JPEG
    decodes to PIL's pixels."""
    import io

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:23, 0:31]
    smooth = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    for arr in (np.stack([smooth, smooth[::-1], 255 - smooth], -1),
                rng.integers(0, 256, (23, 31, 4), dtype=np.uint8), smooth):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        want = np.asarray(Image.fromarray(arr).convert("RGB"))
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), want)
    for arr in (smooth, np.stack([smooth, smooth[::-1], 255 - smooth], -1)):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG")
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), want)


def _site_pair(site):
    """(JAX function, port function) of one image -> resized-array site."""
    if site == "round":
        from reflectionflow_tpu.search import reflectionflow as jrf
        from reflectionflow_tpu_torch.search import reflectionflow as trf

        return (lambda img: jrf._resize(img, 24)), (lambda img: trf.resize(img, (24, 24)))
    if site == "nvila":
        from reflectionflow_tpu.models.nvila.model import preprocess_images as jprep
        from reflectionflow_tpu_torch.models.nvila.model import preprocess_images as tprep

        return (lambda img: jprep([img], 24)), (lambda img: tprep([img], 24))
    import dataclasses
    from types import SimpleNamespace

    from reflectionflow_tpu.config import QwenLMConfig as JLMConfig
    from reflectionflow_tpu.config import QwenVLVisionConfig as JVisConfig
    from reflectionflow_tpu.rm_train.data import build_side_sequence as jside
    from reflectionflow_tpu_torch.config import QwenLMConfig, QwenVLVisionConfig
    from reflectionflow_tpu_torch.rm_train.data import build_side_sequence as tside

    jl, jv = JLMConfig.tiny(), JVisConfig.tiny()
    jm = SimpleNamespace(lm_cfg=jl, vis_cfg=jv)
    tm = SimpleNamespace(lm_cfg=QwenLMConfig(**dataclasses.asdict(jl)),
                         vis_cfg=QwenVLVisionConfig(**dataclasses.asdict(jv)))
    side = dict(prompt="a red cube", max_pixels=32 * 32)

    def pair(fn, model):
        return lambda img: (lambda out: (out["image"], out["ids"]))(fn(model, img, **side))

    return pair(jside, jm), pair(tside, tm)


@pytest.mark.parametrize("site", ["round", "nvila", "rm_collate"])
def test_resize_sites_match_jax(site):
    """A non-square image that is not at any target size, through the round's
    condition resize, NVILA's preprocessing and the reward model's side
    builder: the same arrays as the JAX package's."""
    img = np.random.default_rng(7).integers(0, 256, (45, 61, 3), dtype=np.uint8)
    j, t = _site_pair(site)
    want, got = j(img), t(img)
    if site == "rm_collate":
        (want, want_ids), (got, ids) = want, got
        np.testing.assert_array_equal(ids, want_ids)
    assert got.shape == np.asarray(want).shape and got.shape[-3:-1] != img.shape[:2]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_train_cli_runs_on_cpu(tmp_path, monkeypatch):
    from reflectionflow_tpu_torch.cli.train import main

    cfg = {"max_steps": 1, "save_interval": 1, "checkpoint_dir": str(tmp_path / "ck"),
           "data": {"batch_size": 1, "target_size": 16, "condition_size": 8}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    args = ["--config", str(tmp_path / "cfg.json"), "--synthetic_data", "--synthetic_weights"]
    main(args + ["--device", "cpu"])
    assert latest_checkpoint(str(tmp_path / "ck")) == 1
    assert (tmp_path / "ck" / "synthetic_000.tar").exists()
    if not torch.cuda.is_available():  # the default device is cuda, with no fallback
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(args)
    # without --synthetic_weights: the snapshot in $FLUX_MODEL_DIR, here a directory without one
    monkeypatch.setenv("FLUX_MODEL_DIR", str(tmp_path / "no_snapshot"))
    with pytest.raises(FileNotFoundError, match="no_snapshot"):
        main(["--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
