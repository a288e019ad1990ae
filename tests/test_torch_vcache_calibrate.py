"""The velocity-cache calibration harness of the PyTorch port against the JAX
package: selection, the saved artifact and its refusals, the candidate grid,
the literature anchors (free-text citations aside: the port's are its own),
the teacache preset's polynomial, `run_schedule` on shared latents (n_full
equal, final latents within 1e-4), and the calibration CLI on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.sampler import vcache_calibrate as jcal
from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
from reflectionflow_tpu_torch.cli import vcache_calibrate as cal_cli
from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
from reflectionflow_tpu_torch.sampler import vcache_calibrate as tcal
from reflectionflow_tpu_torch.sampler.generate import make_schedule
from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

from test_torch_quant import numpy_models
from test_torch_vcache import _tiny_pipe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _row(name, speedup, err, drop=None):
    r = {"name": name, "vcache": {"interval": 2}, "n_full": 10,
         "speedup_est": speedup, "latent_rel_err": err, "latent_rel_err_max": err}
    if drop is not None:
        r["score_drop"] = drop
    return r


ROWS = [
    [_row("fast_bad_quality", 3.0, 0.1, drop=1.0), _row("fast_bad_latent", 3.0, 0.9, drop=0.0),
     _row("ok_slow", 1.5, 0.05, drop=0.1), _row("ok_fast", 2.5, 0.2, drop=0.2)],
    [_row("a", 2.0, 0.3, drop=0.0), _row("b", 2.0, 0.1, drop=0.0)],
    [_row("nv", 2.0, 0.1)],
    [_row("x", 9.0, 0.99, drop=9.0)],
    [],
]


def test_select_schedule_matches_jax():
    for rows in ROWS:
        for gates in ({}, {"eps_score": 0.05, "max_latent_rel_err": 0.15}, {"eps_score": 2.0,
                                                                             "max_latent_rel_err": 1.0}):
            assert tcal.select_schedule(rows, **gates) == jcal.select_schedule(rows, **gates), (rows, gates)


def _saved(mod, path, result, kind, verifier):
    try:
        mod.save_calibration(str(path), result, kind, verifier)
    except ValueError as e:
        return "ValueError", str(e)
    return mod.load_calibration(str(path))


def test_save_and_load_match_jax(tmp_path):
    """The artifact, byte for byte, and the refusals (an unknown tier; an
    unscored selection at the "real" tier)."""
    scored = {"results": [_row("ok", 2.0, 0.1, drop=0.05)], "selected": "ok", "selected_vcache": {"interval": 2}}
    scoreless = {"results": [_row("nv", 2.0, 0.1)], "selected": "nv", "selected_vcache": {"interval": 2}}
    failed = {"results": [], "selected": None, "selected_vcache": None}
    for i, (res, kind, ver) in enumerate([(scored, "real", "nvila_jax"), (scoreless, "real", None),
                                          (scoreless, "synthetic", None), (failed, "real", "qwen_rm"),
                                          (scored, "maybe", None)]):
        t, j = tmp_path / f"t{i}.json", tmp_path / f"j{i}.json"
        assert _saved(tcal, t, res, kind, ver) == _saved(jcal, j, res, kind, ver)
        if t.exists():
            assert t.read_bytes() == j.read_bytes()
    (tmp_path / "broken.json").write_text("{")
    for path in (tmp_path / "missing.json", tmp_path / "broken.json"):
        assert tcal.load_calibration(str(path)) is jcal.load_calibration(str(path)) is None


def test_candidates_and_constants_match_jax():
    assert tcal.default_candidates() == jcal.default_candidates()
    assert tcal.TEACACHE_FLUX_POLY == jcal.TEACACHE_FLUX_POLY
    assert tcal.TEACACHE_FLUX_THRESHOLDS == jcal.TEACACHE_FLUX_THRESHOLDS
    assert tcal.ANCHOR_PRECEDENCE == jcal.ANCHOR_PRECEDENCE and tcal.HEADLINE_ANCHOR == jcal.HEADLINE_ANCHOR
    for t in (0.25, 0.4, 0.6, 0.8, 1.0):
        assert tcal.teacache_flux_schedule(t) == jcal.teacache_flux_schedule(t)
    assert tcal.teacache_flux_schedule() == jcal.teacache_flux_schedule()
    assert set(tcal.LITERATURE_ANCHORS) == set(jcal.LITERATURE_ANCHORS)
    for name, a in tcal.LITERATURE_ANCHORS.items():
        b = jcal.LITERATURE_ANCHORS[name]
        assert {k: v for k, v in a.items() if k != "anchor"} == {k: v for k, v in b.items() if k != "anchor"}
        assert "arXiv" in a["anchor"]


def _no_text(cal):
    row = {k: v for k, v in cal["results"][0].items() if k != "quality_basis"}
    return {**cal, "results": [row]}


@pytest.mark.parametrize("steps", [8, 30])
def test_anchor_calibration_matches_jax(steps):
    for name in jcal.LITERATURE_ANCHORS:
        got, want = tcal.anchor_calibration(steps, name), jcal.anchor_calibration(steps, name)
        assert _no_text(got) == _no_text(want), name
        assert "arXiv" in got["results"][0]["quality_basis"]
    assert tcal.anchor_calibration(30)["selected"] == "teacache_flux_t0.6"


def test_teacache_poly_is_the_presets():
    with open(os.path.join(REPO, "configs", "flux.1_dev_qwenscore_v5e_teacache.json")) as f:
        vc = json.load(f)["pipeline_args"]["vcache"]
    assert tuple(vc["poly"]) == tcal.TEACACHE_FLUX_POLY
    assert vc == tcal.teacache_flux_schedule(vc["threshold"])


def test_run_schedule_matches_jax():
    """`run_schedule` on both packages' pipelines (the same tiny DiT) and the
    same latents: the dense trajectory and a Taylor schedule (every dynamic
    mode is held to JAX in `test_torch_vcache.py`)."""
    jcfg, params, dit = numpy_models(seed=2)
    jpipe = JaxFluxPipeline(dit_cfg=jcfg, vae_cfg=None, t5_cfg=None, clip_cfg=None, t5_tokenizer=None,
                            clip_tokenizer=None, params={"dit": jax.tree.map(jnp.asarray, params)})
    tpipe = FluxPipeline(dit_cfg=dit.cfg, vae_cfg=None, t5_cfg=None, clip_cfg=None, dit=dit, vae=None, t5=None,
                         clip=None, t5_tokenizer=None, clip_tokenizer=None, dtype=torch.float32)
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((2, 16, jcfg.in_channels), dtype=np.float32),
         rng.standard_normal((2, 8, jcfg.text_dim), dtype=np.float32),
         rng.standard_normal((2, jcfg.pooled_dim), dtype=np.float32), make_image_ids(4, 4), make_text_ids(8)]
    sigmas = make_schedule(6, 16)
    for vc in (None, {"interval": 3, "warmup": 2, "tail": 1, "order": 1}):
        want, n_want = jcal.run_schedule(jpipe, vc, *map(jnp.asarray, x), jnp.asarray(sigmas.numpy()), 6, 3.5)
        got, n_got = tcal.run_schedule(tpipe, vc, *map(torch.from_numpy, x), sigmas, 6, 3.5)
        assert n_got == n_want and n_got <= 6, vc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_calibrate_dense_is_exact_and_the_cli_writes_it(tmp_path, capsys):
    """The hermetic sweep: an interval-1 schedule is the dense trajectory
    exactly (error 0, score drop 0), a skipping one launches fewer forwards;
    then the CLI (--synthetic_weights --device cpu) writes its calibration to
    --out, which is required."""
    from reflectionflow_tpu_torch.verifiers import FakeVerifier

    cands = [{"name": "interval1", "vcache": {"interval": 1}},
             {"name": "interval3", "vcache": {"interval": 3, "warmup": 2, "tail": 1}}]
    res = tcal.calibrate(_tiny_pipe(), ["a cat", "a dog"], verifier=FakeVerifier(), height=16, width=16,
                         num_steps=6, candidates=cands, eps_score=10.0, max_latent_rel_err=1.0)
    by = {r["name"]: r for r in res["results"]}
    assert by["interval1"]["n_full"] == 6 and by["interval1"]["latent_rel_err"] == 0.0
    assert by["interval1"]["score_drop"] == 0.0
    assert by["interval3"]["n_full"] == 4 and by["interval3"]["latent_rel_err"] > 0.0
    assert res["selected"] == "interval3" and res["dense"]["n_full"] == 6

    with pytest.raises(SystemExit):
        cal_cli.build_parser().parse_args(["--synthetic_weights"])
    out = tmp_path / "cal.json"
    cal_cli.main(["--synthetic_weights", "--device", "cpu", "--prompts", "2", "--steps", "4", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    assert printed["out"] == str(out) and saved["weights_kind"] == "synthetic" and saved["verifier"] == "fake"
    assert saved["dense"]["n_full"] == 4 and saved["settings"]["num_steps"] == 4
    assert [r["name"] for r in saved["results"]] == [c["name"] for c in tcal.default_candidates()]
    assert all(1 <= r["n_full"] <= 4 and "score_drop" in r for r in saved["results"])
    assert saved["selected"] == (tcal.select_schedule(saved["results"]) or {}).get("name")
