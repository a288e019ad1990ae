"""The port's search loops against the JAX package: artifact identity.

`run_reflectionflow_prompt` / `run_reflectionflow_block`,
`run_noise_prompt_scaling` and `run_nfe_filter` run in both packages with the
same fake verifier, reflector and refiner and a deterministic numpy stub
pipeline whose images come from sha256 of (prompt, position in the call),
never from the latents: the same seed gives other latents in the two
packages (ROADMAP item 24). The directory trees, PNG names and decoded
pixels, every JSONL row and `search_state.json` (output root normalised) and
the recorded generate calls must be equal; the condition images within 1
level (the port's PIL-order resize against PIL's). Then the loops on the
real tiny port pipeline, under "xla" and "pallas" (K1's plain version with
the cond stream), finish with the artifacts `tests/test_search.py` asserts.
"""

import dataclasses
import glob
import hashlib
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu import config as jconfig
from reflectionflow_tpu.reflect import FakeReflector as JFakeReflector
from reflectionflow_tpu.reflect import FakeRefiner as JFakeRefiner
from reflectionflow_tpu.search import nfe_filter as jnfe
from reflectionflow_tpu.search import noise_prompt_scaling as jnps
from reflectionflow_tpu.search import reflectionflow as jrf
from reflectionflow_tpu.verifiers import FakeNvilaVerifier as JFakeNvila
from reflectionflow_tpu.verifiers import FakeVerifier as JFakeVerifier
from reflectionflow_tpu.verifiers.base import RankingRule as JRankingRule
from reflectionflow_tpu_torch import config as tconfig
from reflectionflow_tpu_torch.reflect import FakeReflector, FakeRefiner
from reflectionflow_tpu_torch.search import nfe_filter as tnfe
from reflectionflow_tpu_torch.search import noise_prompt_scaling as tnps
from reflectionflow_tpu_torch.search import reflectionflow as trf
from reflectionflow_tpu_torch.search.artifacts import load_image
from reflectionflow_tpu_torch.verifiers import FakeNvilaVerifier, FakeVerifier
from reflectionflow_tpu_torch.verifiers.base import RankingRule

torch.set_num_threads(1)

PORT = SimpleNamespace(config=tconfig, rf=trf, nps=tnps, nfe=tnfe, Verifier=FakeVerifier,
                       Nvila=FakeNvilaVerifier, Reflector=FakeReflector, Refiner=FakeRefiner,
                       Rule=RankingRule, dtype=torch.float32, device=torch.device("cpu"))
JAX = SimpleNamespace(config=jconfig, rf=jrf, nps=jnps, nfe=jnfe, Verifier=JFakeVerifier,
                      Nvila=JFakeNvila, Reflector=JFakeReflector, Refiner=JFakeRefiner,
                      Rule=JRankingRule, dtype=jnp.float32, device=None)


def _stub_image(prompt: str, position: int, height: int, width: int) -> np.ndarray:
    digest = hashlib.sha256(f"{prompt}\x00{position}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    return rng.integers(0, 256, (height, width, 3), dtype=np.uint8)


class StubPipeline:
    """What the loops read of a pipeline, with images that ignore the latents."""

    def __init__(self, pkg):
        self.vae_cfg = SimpleNamespace(latent_channels=16, downscale=8)
        self.dtype, self.device = pkg.dtype, pkg.device
        self.calls = []

    def generate(self, prompts, height, width, latents=None, conditions=None, output_type=None, **kw):
        assert tuple(latents.shape) == (len(prompts), (height // 16) * (width // 16), 64)
        conditions = conditions or []
        self.calls.append({
            "prompts": list(prompts), "hw": (height, width), "kw": kw,
            "deltas": [tuple(c.position_delta) for c in conditions],
            "types": [c.condition_type for c in conditions],
            "cond_images": [np.asarray(c.image) for c in conditions],
        })
        return np.stack([_stub_image(p, i, height, width) for i, p in enumerate(prompts)])


def _cfg(pkg, rounds=2, branch=2, micro=8, reflect=True, refine=True):
    cfg = pkg.config.TTSConfig()
    pa = cfg.pipeline_args
    pa.height = pa.width = 16
    pa.num_inference_steps, pa.condition_size = 2, 8
    cfg.search_args.search_rounds, cfg.search_args.search_branch = rounds, branch
    cfg.batch_size_for_img_gen = micro
    cfg.reflection_args.run_reflection = reflect
    cfg.prompt_refiner_args.run_refinement = refine
    return cfg


def _tree(root):
    """{relative path: decoded pixels (PNG) or text with the root replaced}."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".png"):
                out[rel] = load_image(path)
            else:
                with open(path) as fh:
                    out[rel] = fh.read().replace(str(root), "<ROOT>")
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(ta[rel], tb[rel], err_msg=rel)
        else:
            assert ta[rel] == tb[rel], rel
    return ta


def _assert_same_calls(ca, cb):
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert {k: x[k] for k in ("prompts", "hw", "kw", "deltas", "types")} == \
            {k: y[k] for k in ("prompts", "hw", "kw", "deltas", "types")}
        for ia, ib in zip(x["cond_images"], y["cond_images"]):
            assert ia.shape == ib.shape and ia.dtype == ib.dtype == np.uint8
            assert np.abs(ia.astype(np.int16) - ib.astype(np.int16)).max() <= 1


def _normalise(obj, root):
    return json.loads(json.dumps(obj).replace(str(root), "<ROOT>"))


MODES = {
    # name: (prompt rows, start index, cfg kwargs, nvila verifier, stage-1 round 0, block API)
    "prompt": ([{"prompt": "a blue sphere", "tag": "counting"}], 3, {}, False, False, False),
    "block": ([{"prompt": "a red cube", "tag": "colors"}, {"prompt": "a dog", "tag": "single_object"}],
              1, {"micro": 3}, False, False, True),
    "block_nvila_refine_only": ([{"prompt": "p0", "tag": None}, {"prompt": "p1", "tag": "position"}],
                                0, {"reflect": False}, True, False, True),
    "stage1_reflect_only": ([{"prompt": "q0", "tag": None}, {"prompt": "q1", "tag": None}], 0,
                            {"refine": False, "micro": 2}, False, True, True),
}


def _run_mode(pkg, mode, root):
    rows, start, kw, nvila, stage1, block = MODES[mode]
    cfg = _cfg(pkg, **kw)
    pipe = StubPipeline(pkg)
    verifier = pkg.Nvila() if nvila else pkg.Verifier()
    reflector = pkg.Reflector() if cfg.reflection_args.run_reflection else None
    refiner = pkg.Refiner() if cfg.prompt_refiner_args.run_refinement else None
    out = os.path.join(root, "rf")
    round0_fn = None
    if stage1:
        pkg.nps.run_noise_prompt_scaling(pipe, verifier, pkg.Refiner(), _cfg(pkg), rows,
                                         os.path.join(root, "stage1"), start_index=start, run_seed=5)

        def round0_fn(idx):
            return sorted(glob.glob(os.path.join(root, "stage1", f"{idx:05d}", "samples", "*.png"))) or None
    if block:
        dps = pkg.rf.run_reflectionflow_block(pipe, verifier, reflector, refiner, cfg, rows, out,
                                              start_index=start, round0_images_fn=round0_fn, run_seed=2)
    else:
        dps = [pkg.rf.run_reflectionflow_prompt(
            pipe, verifier, reflector, refiner, cfg, prompt_index=start,
            original_prompt=rows[0]["prompt"], tag=rows[0]["tag"], output_root=out, run_seed=2)]
    return dps, pipe.calls


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reflectionflow_artifacts_match_jax(mode, tmp_path):
    jdps, jcalls = _run_mode(JAX, mode, str(tmp_path / "jax"))
    tdps, tcalls = _run_mode(PORT, mode, str(tmp_path / "torch"))
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    _assert_same_calls(jcalls, tcalls)
    assert _normalise(tdps, tmp_path / "torch") == _normalise(jdps, tmp_path / "jax")
    rows, start, kw, *_ = MODES[mode]
    for i in range(len(rows)):
        root = f"rf/{start + i:05d}"
        assert json.loads(tree[f"{root}/search_state.json"])["round_done"] == 2
        assert len(tree[f"{root}/metadata.jsonl"].splitlines()) == 2
        assert f"{root}/samples_best/00000.png" in tree
    reflected = [c for c in tcalls if c["deltas"]]
    assert reflected and all(c["deltas"] == [(0, -8 // 16)] * len(c["prompts"]) for c in reflected)
    if kw.get("reflect", True):
        assert all(" [Reflexion]: " in p for c in reflected for p in c["prompts"])

    # a finished run again is a no-op: no generate call, no PNG rewritten
    out = tmp_path / "torch" / "rf"
    mtimes = {p: os.path.getmtime(p) for p in glob.glob(str(out / "*" / "*" / "*.png"))}
    rows, start, kw, nvila, *_ = MODES[mode]
    pipe = StubPipeline(PORT)
    dps = trf.run_reflectionflow_block(
        pipe, FakeNvilaVerifier() if nvila else FakeVerifier(), FakeReflector(), FakeRefiner(),
        _cfg(PORT, **kw), rows, str(out), start_index=start, run_seed=2)
    assert pipe.calls == []
    assert mtimes == {p: os.path.getmtime(p) for p in glob.glob(str(out / "*" / "*" / "*.png"))}
    assert dps == tdps


def test_block_midrun_resume_matches_jax(tmp_path):
    """A run killed after round 1 resumes at round 2 from round 1's images, in
    both packages alike (mirrors test_reflectionflow_block.py)."""
    rows = [{"prompt": "q", "tag": None}, {"prompt": "r", "tag": "colors"}]
    results = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        out = str(tmp_path / name)
        pipe = StubPipeline(pkg)
        for rounds in (1, 2):
            dps = pkg.rf.run_reflectionflow_block(pipe, pkg.Verifier(), pkg.Reflector(), pkg.Refiner(),
                                                  _cfg(pkg, rounds=rounds), rows, out, run_seed=1)
        results[name] = (dps, pipe.calls)
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    _assert_same_calls(results["jax"][1], results["torch"][1])
    dps = results["torch"][0]
    assert _normalise(dps, tmp_path / "torch") == _normalise(results["jax"][0], tmp_path / "jax")
    for dp in dps:
        chains = dp["chains"]
        assert sorted(len(c["images"]) for c in chains.values()) == [2, 2]
        assert all("1_round@" in c["images"][0] and "2_round@" in c["images"][1] for c in chains.values())
    # bootstrap + round 1 in the first run, round 2 in the second
    assert len(results["torch"][1]) == 3


def test_noise_prompt_scaling_and_nfe_filter_match_jax(tmp_path):
    rows = [{"prompt": "a tiny boat", "tag": "colors"}, {"prompt": "x", "tag": None},
            {"prompt": "y", "tag": "counting"}]
    calls = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        root = tmp_path / name
        pipe = StubPipeline(pkg)
        cfg = _cfg(pkg, rounds=3, micro=4)
        pkg.nps.run_noise_prompt_scaling(pipe, pkg.Verifier(), pkg.Refiner(), cfg, rows, str(root / "nps"),
                                         start_index=2, run_seed=4)
        calls[name] = pipe.calls
        bright = pkg.Verifier(quality_fn=lambda img, p: float(img.mean()))
        sel = pkg.nfe.run_nfe_filter(bright, pkg.Rule(), str(root / "nps"), str(root / "nfe"), rows,
                                     nfes=(1, 2, 4, 8), images_subdir="midimg", start_index=2)
        calls[name + "_sel"] = _normalise(sel, root)
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    _assert_same_calls(calls["jax"], calls["torch"])
    assert calls["torch_sel"] == calls["jax_sel"]
    assert sum(rel.startswith("nps/") and rel.endswith(".png") for rel in tree) == 3 * 3 * 2
    assert sorted(rel for rel in tree if rel.startswith("nfe/")) == [
        f"nfe/nfe{k}/{i:05d}.png" for k in (1, 2, 4, 8) for i in (2, 3, 4)]
    meta = [json.loads(line) for line in tree["nps/00002/metadata.jsonl"].splitlines()]
    assert meta[1]["current_prompts"][0] == "a tiny boat, highly detailed"
    # blocks of batch_size_for_img_gen // branch = 2 prompts, every round of a block in turn
    assert [len(c["prompts"]) for c in calls["torch"]] == [4, 4, 4, 2, 2, 2]


# ---------------------------------------------------------------------------
# the loops on the real tiny port pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pipe():
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    return FluxPipeline.random_init(
        torch.Generator().manual_seed(0), tconfig.FluxDiTConfig.tiny(), tconfig.FluxVAEConfig.tiny(),
        tconfig.T5Config.tiny(), tconfig.CLIPTextConfig.tiny(), dtype=torch.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loops_end_to_end_on_the_tiny_pipeline(tiny_pipe, impl, tmp_path):
    pipe = dataclasses.replace(tiny_pipe, attn_impl=impl)
    cfg = _cfg(PORT)
    dp = trf.run_reflectionflow_prompt(pipe, FakeVerifier(), FakeReflector(), FakeRefiner(), cfg,
                                       prompt_index=0, original_prompt="a blue sphere", tag=None,
                                       output_root=str(tmp_path / "rf"), run_seed=0)
    root = tmp_path / "rf" / "00000"
    assert dp["flag_terminated"] and len(dp["generated_img"]) == 2 and len(dp["chains"]) == 2
    assert (root / "samples_best" / "00000.png").exists()
    assert len(list((root / "samples_lastround").glob("*.png"))) == 2
    assert len(list((root / "samples_path_bestround").glob("*.png"))) == 2
    assert len(list((root / "midimg").glob("*.png"))) == 6
    assert (root / "best_img_detailedscore.jsonl").exists() and (root / "best_img_meta.jsonl").exists()
    assert all("[Reflexion]" not in p for p in dp["refined_prompt"]) and all(dp["reflections"])
    assert load_image(str(root / "samples_best" / "00000.png")).shape == (16, 16, 3)
    mtimes = {p: os.path.getmtime(p) for p in glob.glob(str(root / "midimg" / "*.png"))}
    trf.run_reflectionflow_prompt(pipe, FakeVerifier(), FakeReflector(), FakeRefiner(), cfg,
                                  prompt_index=0, original_prompt="a blue sphere", tag=None,
                                  output_root=str(tmp_path / "rf"), run_seed=0)
    assert mtimes == {p: os.path.getmtime(p) for p in glob.glob(str(root / "midimg" / "*.png"))}

    tnps.run_noise_prompt_scaling(pipe, FakeVerifier(), FakeRefiner(), cfg, ["a tiny boat"],
                                  str(tmp_path / "nps"), run_seed=0)
    assert len(glob.glob(str(tmp_path / "nps" / "00000" / "samples" / "*.png"))) == 4
    meta = [json.loads(line) for line in open(tmp_path / "nps" / "00000" / "metadata.jsonl")]
    assert meta[1]["current_prompts"][0].startswith("a tiny boat") and meta[1]["current_prompts"][0] != "a tiny boat"

    bright = FakeVerifier(quality_fn=lambda img, p: float(img.mean()))
    sel = tnfe.run_nfe_filter(bright, RankingRule(), str(tmp_path / "nps"), str(tmp_path / "curve"),
                              ["a tiny boat"], nfes=(1, 2, 4), images_subdir="samples")
    assert len(sel[1]) == len(sel[2]) == len(sel[4]) == 1
    assert (tmp_path / "curve" / "nfe4" / "00000.png").exists()
    assert load_image(sel[4][0]).mean() >= load_image(sel[1][0]).mean()
