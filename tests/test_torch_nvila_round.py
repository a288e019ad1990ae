"""The NVILA preset's round on the CPU, in both packages:
`configs/flux.1_dev_nvilascore.json` loads unchanged, the port's
`build_verifier` makes its `nvila_jax` verifier (int8) from a tiny VILA bundle,
and one block of `run_reflectionflow_block` runs through the numpy stub
pipeline of `test_torch_reflectionflow.py` with the bundle's NVILA as the
verifier (JAX loads it, the port takes the bridged weights and its own BPE
tokenizer): the same generate calls, selected chains and artifact tree. Then
`run_nfe_filter` with those verifiers over the round's `midimg/` writes the
same `nfe{K}/` in both, and the port's `verifier_filter` CLI runs the preset
on the bundle. About 20 s on one core."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.utils.hf_loader import load_nvila as j_load_nvila
from reflectionflow_tpu.verifiers.nvila import NvilaJaxVerifier as JNvilaVerifier
from reflectionflow_tpu_torch.cli import verifier_filter
from reflectionflow_tpu_torch.cli.common import build_verifier
from reflectionflow_tpu_torch.utils.bpe import Qwen2BPETokenizer
from reflectionflow_tpu_torch.utils.jax_bridge import nvila_from_jax
from reflectionflow_tpu_torch.verifiers.nvila import NvilaJaxVerifier

from test_torch_nvila import _write_bundle
from test_torch_reflectionflow import JAX, PORT, StubPipeline, _assert_same_calls, _normalise, _tree

torch.set_num_threads(1)
PRESET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "flux.1_dev_nvilascore.json")
PX = 32  # the stub images and the bundle's tower: 32 px, so neither package resizes
ROWS = [{"prompt": "a red cube on a table", "tag": "colors"}, {"prompt": "two dogs", "tag": "counting"}]


def _preset(pkg, bundle):
    """The preset as the file says, cut as the round phases cut it: 32 px images
    with a 16 px condition, 2 steps, 2 rounds."""
    cfg = pkg.config.TTSConfig.load(PRESET)
    pa = cfg.pipeline_args
    assert (cfg.verifier_args.name, cfg.verifier_args.quantize, pa.quantize, pa.attn_impl,
            cfg.batch_size_for_img_gen, cfg.search_args.search_branch) == ("nvila_jax", "int8", "int8", "pallas", 1, 2)
    cfg.verifier_args.model_path = bundle
    pa.height = pa.width = PX
    pa.condition_size, pa.num_inference_steps, cfg.search_args.search_rounds = PX // 2, 2, 2
    return cfg


def _same(a, b, rel=1e-4):
    """Equal JSON values; floats (the verifier's logits) within `rel` of the larger."""
    if isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-30), (a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], rel)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, rel)
    else:
        assert a == b


def _assert_same_tree(a, b):
    """The same files and PNG pixels; the JSON rows equal but for the NVILA
    scores they carry, held at 1e-4 (the two packages' fp32 logits); other
    lines equal."""
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(ta[rel], tb[rel], err_msg=rel)
        else:
            la, lb = ta[rel].splitlines(), tb[rel].splitlines()
            assert len(la) == len(lb), rel
            for x, y in zip(la, lb):
                if x.startswith(("{", "[")):
                    _same(json.loads(x), json.loads(y))
                else:  # the "reflections1: [...]" lines of best_img_meta.jsonl
                    assert x == y, rel
    return ta


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return _write_bundle(str(tmp_path_factory.mktemp("nvila") / "bundle"), seed=21, image_size=PX)


@pytest.fixture(scope="module")
def verifiers(bundle):
    jm = j_load_nvila(bundle, dtype=jnp.float32)
    pm = nvila_from_jax(jm)
    pm.tokenizer = Qwen2BPETokenizer.from_dir(os.path.join(bundle, "llm"))
    return JNvilaVerifier(model=jm), NvilaJaxVerifier(model=pm)


def test_preset_builds_the_port_verifier(bundle, monkeypatch):
    from reflectionflow_tpu_torch.utils import device as udevice

    quantized = []  # at tiny widths the default min size keeps every linear float: record the calls
    monkeypatch.setattr(udevice, "quantize_blocks", lambda blocks, n: quantized.append((len(blocks), n)))
    v = build_verifier(_preset(PORT, bundle), device="cpu")
    assert isinstance(v, NvilaJaxVerifier) and v.output_kind == "yes_no"
    assert v.model.device == torch.device("cpu") and v.model.llm.model.embed_tokens.weight.dtype == torch.bfloat16
    assert quantized == [(2, 1 << 18), (3, 1 << 18)]  # the LM's blocks, then the tower's
    out = v.score([np.zeros((PX, PX, 3), np.uint8)], ["a red cube"])
    assert out[0]["label"] in ("yes", "no") and np.isfinite(out[0]["score"])


@pytest.mark.parametrize("name", ["nvila", "nvila_jax"])
def test_build_verifier_forwards_what_jax_forwards(name, monkeypatch):
    """The preset renamed to either NVILA verifier, with every verifier arg set:
    the port's `build_verifier` passes the loader what JAX's passes, plus the
    device (`nvila` neither quantizes nor takes device_index)."""
    from reflectionflow_tpu.cli import common as jcommon
    from reflectionflow_tpu_torch.cli import common as pcommon

    seen = {}
    for key, mod in (("jax", jcommon), ("torch", pcommon)):
        monkeypatch.setattr(mod, "load_verifier", lambda n, _k=key, **kw: seen.setdefault(_k, (n, kw)))
        cfg = (JAX if key == "jax" else PORT).config.TTSConfig.load(PRESET)
        va = cfg.verifier_args
        va.name, va.model_path, va.model_name, va.cache_dir, va.device_index = name, "b", "org/m", "c", 1
        (jcommon.build_verifier(cfg) if key == "jax" else pcommon.build_verifier(cfg, device="cpu"))
    jname, jkw = seen["jax"]
    pname, pkw = seen["torch"]
    assert pname == jname == name and pkw == {**jkw, "device": "cpu"}
    assert ("quantize" in pkw) == (name == "nvila_jax")


def test_preset_round_and_filter_match_jax(bundle, verifiers, tmp_path):
    from reflectionflow_tpu.search import nfe_filter as jnfe

    results = {}
    for name, pkg, verifier in (("jax", JAX, verifiers[0]), ("torch", PORT, verifiers[1])):
        cfg = _preset(pkg, bundle)
        pipe = StubPipeline(pkg)
        out = str(tmp_path / name / "rf")
        dps = pkg.rf.run_reflectionflow_block(pipe, verifier, pkg.Reflector(), pkg.Refiner(), cfg, ROWS, out,
                                              run_seed=3)
        rule = pkg.Rule(kind=verifier.output_kind, choice_of_metric=cfg.verifier_args.choice_of_metric)
        sel = pkg.nfe.run_nfe_filter(verifier, rule, out, str(tmp_path / name / "nfe"), ROWS, nfes=(1, 2, 4))
        results[name] = (dps, pipe.calls, _normalise(sel, tmp_path / name))
        assert pkg.nfe is (jnfe if name == "jax" else PORT.nfe)
    tree = _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    _assert_same_calls(results["jax"][1], results["torch"][1])
    _same(_normalise(results["torch"][0], tmp_path / "torch"), _normalise(results["jax"][0], tmp_path / "jax"))
    assert results["torch"][2] == results["jax"][2]
    # micro-batches of 1: round 0 is 2 t2i calls a prompt, each round 2 conditioned calls a prompt
    calls = results["torch"][1]
    assert [len(c["prompts"]) for c in calls] == [1] * len(calls) and len(calls) == 4 * 3
    assert sorted(r for r in tree if r.startswith("nfe/")) == [f"nfe/nfe{k}/{i:05d}.png" for k in (1, 2, 4)
                                                              for i in range(2)]
    for i in range(2):
        assert json.loads(tree[f"rf/{i:05d}/search_state.json"])["round_done"] == 2
        scores = [json.loads(line) for line in tree[f"rf/{i:05d}/metadata.jsonl"].splitlines()]
        assert len(scores) == 2
    # the verifier_filter CLI of the port on the preset (a copy naming the bundle) writes the nfe dirs
    cfg_path = tmp_path / "preset.json"
    with open(PRESET) as f:
        preset = json.load(f)
    preset["verifier_args"]["model_path"] = bundle
    cfg_path.write_text(json.dumps(preset))
    meta = tmp_path / "meta.jsonl"
    meta.write_text("".join(json.dumps(r) + "\n" for r in ROWS))
    verifier_filter.main(["--pipeline_config_path", str(cfg_path), "--meta_path", str(meta), "--imgpath",
                          str(tmp_path / "torch" / "rf"), "--output_dir", str(tmp_path / "cli"), "--nfes", "1", "2",
                          "--device", "cpu"])
    assert sorted(os.path.relpath(p, tmp_path / "cli") for p in glob.glob(str(tmp_path / "cli" / "*" / "*.png"))) \
        == [f"nfe{k}/{i:05d}.png" for k in (1, 2) for i in range(2)]
