"""The velocity cache of the PyTorch port against the JAX package.

Both packages hold the same tiny fp32 DiT (seeded numpy weights,
`test_torch_quant.numpy_models`) and take the same seeded numpy latents and
embeddings.
Every mode of `denoise` (static order 0/1/2, dynamic with and without the
TeaCache polynomial, Taylor dynamic, the pinned floor, residual static and
dynamic with the cond stream and image CFG, module static and dynamic) must
launch as many full forwards as JAX and end within 1e-4 of its latents; the
DiT's hooks (skip signal, residual decode, residual and module outputs,
glue-only forward) agree within 1e-5. Dynamic thresholds are held at least 4%
away from every accumulator value they are compared with (the margin is
recomputed from the port's recorded signals), so reduction-order noise cannot
flip a decision, and each dynamic case has steps where the two rows decide
differently. Masks, the schedule grammar and the validation errors match
JAX's exactly.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.models.flux.dit import flux_dit_apply
from reflectionflow_tpu.models.flux.dit import flux_mod_signal as j_signal
from reflectionflow_tpu.models.flux.dit import flux_residual_decode as j_decode
from reflectionflow_tpu.ops.quant import quantize_dit_params as j_quantize
from reflectionflow_tpu.sampler import generate as jgen
from reflectionflow_tpu.sampler.vcache_calibrate import TEACACHE_FLUX_POLY
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.cli.common import load_config, load_pipeline
from reflectionflow_tpu_torch.models.flux.dit import flux_mod_signal, flux_residual_decode
from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
from reflectionflow_tpu_torch.ops.quant import quantize_dit_params
from reflectionflow_tpu_torch.sampler import generate as tgen
from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

from test_torch_quant import numpy_models

torch.set_num_threads(1)
B, TY, TX, LT, LC, N = 2, 4, 4, 8, 4, 8
SEED = 11  # the weights' seed; the dynamic thresholds below were chosen on them
ATOL = 1e-4
MARGIN = 0.04

_MASK_A = (1, 0, 1, 0, 1, 0, 0, 1)
_MASK_B = (1, 1, 0, 1, 0, 0, 1, 0)  # order 2 has three points from step 4 on
MODES = {  # name -> (denoise keywords, conditioned with image CFG)
    "static_o0": ({"step_mask": _MASK_A}, False),
    "static_o1": ({"step_mask": _MASK_B, "vcache_order": 1}, False),
    "static_o2": ({"step_mask": _MASK_B, "vcache_order": 2}, False),
    "dynamic": ({"vcache_threshold": 1.4}, False),
    "dynamic_poly": ({"vcache_threshold": 0.6, "vcache_poly": TEACACHE_FLUX_POLY}, False),
    "dynamic_o1": ({"vcache_threshold": 1.4, "vcache_order": 1}, False),
    "pinned": ({"vcache": {"threshold": 1e9, "pin_n_full": 4}}, False),
    "residual_static_cfg": ({"step_mask": _MASK_A, "vcache_cached": "residual"}, True),
    "residual_dynamic_cfg": ({"vcache_threshold": 0.7, "vcache_cached": "residual"}, True),
    "module_static": ({"step_mask": _MASK_B, "vcache_cached": "module"}, False),
    "module_dynamic": ({"vcache_threshold": 1.4, "vcache_cached": "module"}, False),
}


@pytest.fixture(scope="module")
def setup():
    jcfg, params, dit = numpy_models(seed=SEED)
    rng = np.random.default_rng(3)
    x = dict(
        latents=rng.standard_normal((B, TY * TX, jcfg.in_channels), dtype=np.float32),
        txt=rng.standard_normal((B, LT, jcfg.text_dim), dtype=np.float32),
        pooled=rng.standard_normal((B, jcfg.pooled_dim), dtype=np.float32),
        img_ids=make_image_ids(TY, TX), txt_ids=make_text_ids(LT),
        sigmas=tgen.make_schedule(N, TY * TX).numpy(),
    )
    cfg_x = dict(cond=rng.standard_normal((B, LC, jcfg.in_channels), dtype=np.float32),
                 cond_ids=make_image_ids(2, 2, position_delta=(0, -2)),
                 cond_empty=np.zeros((B, LC, jcfg.in_channels), np.float32))
    return jcfg, jax.tree.map(jnp.asarray, params), dit, x, cfg_x


def _kwargs(kw):
    kw = dict(kw)
    if "vcache" in kw:
        kw.update(tgen.vcache_kwargs(kw.pop("vcache"), N))
    return kw


def _jax(setup, kw, cfg):
    jcfg, jp, _, x, cfg_x = setup
    kw = {k: jnp.asarray(np.asarray(v)) if k in ("step_mask", "vcache_force_mask") else v
          for k, v in _kwargs(kw).items()}
    if cfg:
        kw.update({k: jnp.asarray(v) for k, v in cfg_x.items()}, image_guidance_scale=1.5)
    lat, n = jgen.denoise(jp, jcfg, *(jnp.asarray(x[k]) for k in ("latents", "txt", "pooled", "img_ids",
                                                                    "txt_ids", "sigmas")),
                          jnp.asarray(3.5), N, return_vcache_stats=True, **kw)
    return np.asarray(lat), int(n)


def _port(setup, kw, cfg, monkeypatch=None):
    """(latents, n_full, recorded skip signals) of the port's denoise."""
    _, _, dit, x, cfg_x = setup
    kw = _kwargs(kw)
    if cfg:
        kw.update({k: torch.from_numpy(v) for k, v in cfg_x.items()}, image_guidance_scale=1.5)
    signals = []
    if monkeypatch is not None:
        real = tgen.flux_mod_signal

        def recorded(*a, **k):
            signals.append(real(*a, **k).float().numpy())
            return torch.from_numpy(signals[-1])
        monkeypatch.setattr(tgen, "flux_mod_signal", recorded)
    lat, n = tgen.denoise(dit, *(torch.from_numpy(x[k]) for k in ("latents", "txt", "pooled", "img_ids",
                                                                   "txt_ids")),
                          torch.from_numpy(x["sigmas"]), 3.5, N, attn_impl="pallas", return_vcache_stats=True,
                          **kw)
    return lat.numpy(), n, signals


def _decisions(signals, kw):
    """Replays the dynamic decision from recorded signals in float64: (the
    (steps, rows) full bits, the least |acc - threshold| / threshold on steps
    that were not forced)."""
    thr, poly = kw["vcache_threshold"], kw.get("vcache_poly")
    n = len(signals)
    forced = np.zeros(n, bool)
    forced[0] = forced[-1] = True
    if kw.get("vcache_force_mask") is not None:
        forced |= np.asarray(kw["vcache_force_mask"])
    prev, acc, bits, margin = np.zeros_like(signals[0], np.float64), 0.0, [], np.inf
    for i, s in enumerate(signals):
        rel = np.abs(s - prev).sum((1, 2)) / (np.abs(prev).sum((1, 2)) + 1e-8)
        prev = s.astype(np.float64)
        acc = acc + (np.polyval(np.asarray(poly, np.float64), rel) if poly else rel)
        if not forced[i]:
            margin = min(margin, float(np.min(np.abs(acc - thr) / thr)))
        bits.append((acc >= thr) | forced[i])
        acc = np.where(bits[-1], 0.0, acc)
    return np.asarray(bits), margin


@pytest.mark.parametrize("mode", list(MODES))
def test_denoise_modes_match_jax(setup, monkeypatch, mode):
    kw, cfg = MODES[mode]
    want, n_want = _jax(setup, kw, cfg)
    got, n_got, signals = _port(setup, kw, cfg, monkeypatch)
    assert n_got == n_want, (n_got, n_want)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    full = _kwargs(kw)
    if "vcache_threshold" in full and full["vcache_threshold"] < 1e8:
        bits, margin = _decisions(signals, full)
        assert margin >= MARGIN, margin
        assert (bits.any(1) & ~bits.all(1)).any(), "no step where the rows decide differently"
        assert n_got == int(bits.any(1).sum()) < N
    elif "step_mask" in full:
        assert n_got == int(np.sum(full["step_mask"]))
    else:  # the pinned floor alone, the signal computed every step
        assert n_got == 4 and len(signals) == N


def test_interval_one_is_the_dense_loop(setup):
    """Every step full through the cached path: bitwise the dense loop."""
    dense, n_dense, _ = _port(setup, {}, False)
    every, n_every, _ = _port(setup, {"vcache": {"interval": 1}}, False)
    assert n_dense == n_every == N
    np.testing.assert_array_equal(every, dense)


def _hook_inputs(setup, seed=5):
    jcfg, _, _, x, _ = setup
    rng = np.random.default_rng(seed)
    return dict(img=rng.standard_normal((B, TY * TX, jcfg.in_channels), dtype=np.float32),
                txt=x["txt"], pooled=x["pooled"], timestep=np.asarray([0.7, 0.3], np.float32),
                img_ids=x["img_ids"], txt_ids=x["txt_ids"], guidance=np.asarray([3.5, 3.5], np.float32))


def test_hooks_match_jax(setup):
    """`flux_mod_signal`, `flux_residual_decode`, `return_img_residual`,
    `return_module_outs` and a glue-only forward on JAX's module outputs."""
    jcfg, jp, dit, _, _ = setup
    h = _hook_inputs(setup)
    jx, tx = ({k: f(v) for k, v in h.items()} for f in (jnp.asarray, torch.from_numpy))

    def close(a, b):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-5)
    close(flux_mod_signal(dit, tx["img"], tx["pooled"], tx["timestep"], tx["guidance"]),
          j_signal(jp, jcfg, jx["img"], jx["pooled"], jx["timestep"], jx["guidance"]))
    fwd = {k: v for k, v in tx.items()}
    with torch.no_grad():
        out, resid = dit(**fwd, attn_impl="pallas", return_img_residual=True)
    j_out, j_resid = flux_dit_apply(jp, jcfg, **jx, return_img_residual=True)
    close(out, j_out)
    close(resid, j_resid)
    assert resid.shape == (B, TY * TX, jcfg.hidden_size)
    close(flux_residual_decode(dit, tx["img"], resid, tx["pooled"], tx["timestep"], tx["guidance"]),
          j_decode(jp, jcfg, jx["img"], j_resid, jx["pooled"], jx["timestep"], jx["guidance"]))

    with torch.no_grad():
        out, cache = dit(**fwd, attn_impl="pallas", return_module_outs=True)
    j_out, j_cache = flux_dit_apply(jp, jcfg, **jx, return_module_outs=True)
    close(out, j_out)
    for a, b in zip(cache["double"], j_cache["double"]):
        assert a.shape == b.shape
        close(a, b)
    close(cache["single"], j_cache["single"])
    # a skip step on JAX's own (perturbed) module outputs
    fc = jax.tree.map(lambda a: np.asarray(a) * 0.9 + 0.01, j_cache)
    with torch.no_grad():
        got = dit(**{**fwd, "timestep": torch.tensor([0.5, 0.2])}, attn_impl="pallas",
                  module_cache=jax.tree.map(torch.from_numpy, fc))
    close(got, flux_dit_apply(jp, jcfg, **{**jx, "timestep": jnp.asarray([0.5, 0.2])},
                              module_cache=jax.tree.map(jnp.asarray, fc)))


def test_module_mode_refusals(setup):
    """Module mode is plain t2i: the cond stream, `return_img_residual` and
    (a divergence: JAX drops it silently) `remat` raise."""
    _, _, dit, _, cfg_x = setup
    tx = {k: torch.from_numpy(v) for k, v in _hook_inputs(setup).items()}
    cond = {"cond": torch.from_numpy(cfg_x["cond"]), "cond_ids": torch.from_numpy(cfg_x["cond_ids"])}
    for kw in (cond, {"return_img_residual": True}, {"remat": True}):
        with pytest.raises(ValueError, match="module cache"):
            dit(**tx, return_module_outs=True, **kw)
    with pytest.raises(ValueError, match="module cache"):
        dit(**tx, module_cache={"double": [], "single": []}, remat=True)
    with pytest.raises(ValueError, match="module cache"):  # ControlNet residuals: plain t2i only
        dit(**tx, return_module_outs=True, controlnet_block_samples=tx["img"][None])


def test_dynamic_signal_on_the_w8a8_tree(setup):
    """The skip signal runs on int8 W8A8 linears, as JAX's
    `test_dynamic_signal_works_on_quantized_tree`: the forced steps only at a
    huge threshold, the same latents as JAX's W8A8 tree."""
    jcfg, jp, _, x, _ = setup
    _, _, dit = numpy_models(seed=SEED)
    quantize_dit_params(dit, min_size=64 * 64)
    jq = j_quantize(jp, min_size=64 * 64, act_quant=True)
    kw = {"vcache_threshold": 1e9, "vcache_warmup": 1, "vcache_tail": 1}
    lat, n = jgen.denoise(jq, jcfg, *(jnp.asarray(x[k]) for k in ("latents", "txt", "pooled", "img_ids",
                                                                    "txt_ids", "sigmas")),
                          jnp.asarray(3.5), N, return_vcache_stats=True, **kw)
    got, n_got = tgen.denoise(dit, *(torch.from_numpy(x[k]) for k in ("latents", "txt", "pooled", "img_ids",
                                                                       "txt_ids")),
                              torch.from_numpy(x["sigmas"]), 3.5, N, return_vcache_stats=True, **kw)
    assert n_got == int(n) == 2
    a, b = got.numpy().ravel().astype(np.float64), np.asarray(lat).ravel().astype(np.float64)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.9999


def _outcome(fn, *a, **k):
    try:
        out = fn(*a, **k)
    except (ValueError, AssertionError) as e:
        return type(e).__name__, str(e)
    if isinstance(out, dict):
        return {key: np.asarray(v).tolist() if key in ("step_mask", "vcache_force_mask") else v
                for key, v in out.items()}
    return np.asarray(out).tolist()


def test_step_and_pinned_masks_match_jax():
    for n in range(0, 11):
        for interval in range(0, 5):
            for warmup in range(-1, 4):
                for tail in range(-1, 3):
                    args = (n, interval, warmup, tail)
                    assert _outcome(tgen.make_step_mask, *args) == _outcome(jgen.make_step_mask, *args), args
        for k in range(-1, 13):
            assert _outcome(tgen.make_pinned_mask, n, k) == _outcome(jgen.make_pinned_mask, n, k), (n, k)


VCACHES = [None, {}, {"interval": 3}, {"interval": 2, "warmup": 2, "tail": 0, "order": 2},
           {"interval": 3, "residual": True}, {"interval": 3, "module": True},
           {"threshold": 0.6, "warmup": 1, "tail": 1, "poly": list(TEACACHE_FLUX_POLY), "residual": True},
           {"threshold": 0.35, "order": 1}, {"threshold": 0.5, "pin_n_full": 3},
           {"threshold": 0.5, "pin_n_full": 40}, {"threshold": 0.5, "module": True, "poly": []},
           # the errors
           {"interval": 2, "threshold": 0.5}, {"interval": 2, "pin_n_full": 3}, {"threshold": 0.0},
           {"threshold": -1}, {"threshold": 0.5, "pin_n_full": 0}, {"threshold": 0.5, "pin_n_full": 1},
           {"interval": 2, "residual": True, "module": True}, {"warmup": 2}, {"interval": 0}]


@pytest.mark.parametrize("steps", [1, 8, 30])
def test_vcache_kwargs_match_jax(steps):
    for vc in VCACHES:
        assert _outcome(tgen.vcache_kwargs, vc, steps) == _outcome(jgen.vcache_kwargs, vc, steps), vc


BAD = [{"step_mask": np.ones(N, bool), "vcache_threshold": 0.5},
       {"step_mask": np.ones(N, bool), "vcache_force_mask": np.ones(N, bool)},
       {"step_mask": np.ones(N - 1, bool)},
       {"vcache_threshold": 0.5, "vcache_order": 3},
       {"vcache_threshold": 0.5, "vcache_cached": "hidden"},
       {"vcache_threshold": 0.5, "vcache_cached": "residual", "vcache_order": 1},
       {"step_mask": np.ones(N, bool), "vcache_cached": "module", "vcache_order": 2},
       {"step_mask": np.ones(N, bool), "vcache_cached": "module", "cond": True}]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_denoise_validation_matches_jax(setup, case):
    jcfg, jp, dit, x, cfg_x = setup
    kw = dict(BAD[case])
    extra = {}
    if kw.pop("cond", False):
        extra = {"cond": cfg_x["cond"], "cond_ids": cfg_x["cond_ids"]}
    names = ("latents", "txt", "pooled", "img_ids", "txt_ids")
    j_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in {**kw, **extra}.items()}
    t_kw = {k: torch.from_numpy(v) if k in ("cond", "cond_ids") else v for k, v in {**kw, **extra}.items()}
    want = _outcome(jgen.denoise, jp, jcfg, *(jnp.asarray(x[k]) for k in names), jnp.asarray(x["sigmas"]),
                    jnp.asarray(3.5), N, **j_kw)
    got = _outcome(tgen.denoise, dit, *(torch.from_numpy(x[k]) for k in names), torch.from_numpy(x["sigmas"]),
                   3.5, N, **t_kw)
    assert isinstance(want, tuple) and isinstance(got, tuple)
    if want[0] == "ValueError":
        assert got == want
    else:  # a wrong mask length: JAX asserts, the port raises ValueError
        assert want[0] == "AssertionError" and got[0] == "ValueError" and "step_mask" in got[1]


def _tiny_pipe():
    return FluxPipeline.random_init(torch.Generator().manual_seed(0), *(
        c.tiny() for c in (tconfig.FluxDiTConfig, tconfig.FluxVAEConfig, tconfig.T5Config,
                           tconfig.CLIPTextConfig)), dtype=torch.float32)


def test_candidate_is_independent_of_its_batch(monkeypatch):
    """Per-candidate decisions: each candidate's image is the same alone and in
    a batch of 4 (JAX's `test_vcache_sharded_matches_unsharded` bound), at a
    threshold where the batch's rows decide differently (with margin)."""
    from reflectionflow_tpu_torch.models.flux.latents import latent_tokens

    pipe = _tiny_pipe()
    pipe.vcache = {"threshold": 0.68, "warmup": 1, "tail": 1}
    prompts = [f"prompt {i}" for i in range(4)]
    ty, tx = latent_tokens(16, 16, pipe.vae_cfg.downscale)
    lat = np.random.default_rng(0).standard_normal((4, ty * tx, 16), dtype=np.float32)
    kw = dict(height=16, width=16, num_inference_steps=8, max_sequence_length=8)
    signals = []
    real = tgen.flux_mod_signal

    def recorded(*a, **k):
        signals.append(real(*a, **k).float().numpy())
        return torch.from_numpy(signals[-1])
    monkeypatch.setattr(tgen, "flux_mod_signal", recorded)
    batch = pipe.generate(prompts, latents=lat, **kw)
    bits, margin = _decisions(signals[:8], tgen.vcache_kwargs(pipe.vcache, 8))
    assert (bits.any(1) & ~bits.all(1)).any() and margin >= 0.02, (bits, margin)
    alone = np.concatenate([pipe.generate(prompts[i:i + 1], latents=lat[i:i + 1], **kw) for i in range(4)])
    np.testing.assert_allclose(batch.astype(np.int32), alone.astype(np.int32), atol=1)


def _args(path, **kw):
    return Namespace(pipeline_config_path=str(path), output_dir=None, synthetic_weights=True, attn_impl=None,
                     quantize=None, phase_swap=False, act_quant_exclude=[], device="cpu", **kw)


def test_presets_load_and_serve(tmp_path, monkeypatch):
    """The teacache preset loads through `load_pipeline` with its schedule
    on the pipeline, and `tts_reflectionflow` runs rounds under it."""
    from reflectionflow_tpu_torch.cli import tts_reflectionflow

    preset = "configs/flux.1_dev_qwenscore_v5e_teacache.json"
    pipe = load_pipeline(load_config(_args(preset)), _args(preset))
    with open(preset) as f:
        assert pipe.vcache == json.load(f)["pipeline_args"]["vcache"]
    assert pipe.rope_layout == "split" and pipe._embed_cache is not None  # the int8 profile
    cfg = {"pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16, "condition_size": 8,
                             "max_sequence_length": 16, "num_inference_steps": 4, "vcache": pipe.vcache},
           "verifier_args": {"name": "fake"}, "search_args": {"search_branch": 2, "search_rounds": 2},
           "reflection_args": {"run_reflection": True, "name": "fake"},
           "prompt_refiner_args": {"run_refinement": True, "name": "fake"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "meta.jsonl").write_text(json.dumps({"prompt": "a red cube", "tag": "colors"}) + "\n")
    calls = []
    real = tgen.denoise

    def counted(*a, **k):
        calls.append(k.get("vcache_cached"))
        return real(*a, **k)
    monkeypatch.setattr("reflectionflow_tpu_torch.sampler.pipeline.denoise", counted)
    tts_reflectionflow.main(["--pipeline_config_path", str(tmp_path / "cfg.json"), "--meta_path",
                             str(tmp_path / "meta.jsonl"), "--output_dir", str(tmp_path / "out"),
                             "--synthetic_weights", "--device", "cpu", "--attn_impl", "pallas"])
    root = tmp_path / "out" / "00000"
    assert json.loads((root / "search_state.json").read_text())["round_done"] == 2
    assert len(list((root / "midimg").glob("*_round@*.png"))) == 6
    assert calls and set(calls) == {"residual"}
