"""The port's search CLIs (`tts_reflectionflow`, `tts_t2i_noise_prompt_scaling`,
`verifier_filter`) on the tiny fp32 `--synthetic_weights` pipeline on the
CPU: they finish with the JAX package's artifact tree, resume as a no-op,
raise without CUDA unless `--device cpu` is given, and the model backends
raise for what they lack before any output is written: `nvila` a local hub
snapshot, `nvila_jax` and the Qwen backends a model_path."""

import contextlib
import glob
import io
import json

import pytest
import torch

from reflectionflow_tpu_torch.cli import tts_reflectionflow, tts_t2i_noise_prompt_scaling, verifier_filter
from reflectionflow_tpu_torch.cli.common import build_parser, load_config, load_pipeline

torch.set_num_threads(1)
CFG = {"pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16, "condition_size": 8,
                         "max_sequence_length": 16, "num_inference_steps": 2},
       "verifier_args": {"name": "fake"},
       "search_args": {"search_branch": 2, "search_rounds": 2},
       "reflection_args": {"run_reflection": True, "name": "fake"},
       "prompt_refiner_args": {"run_refinement": True, "name": "fake"}}
ROWS = [{"prompt": "a red cube", "tag": "colors"}, {"prompt": "a dog", "tag": "single_object"}]


def _setup(tmp_path, **over):
    cfg = json.loads(json.dumps(CFG))
    for key, value in over.items():
        cfg[key].update(value)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in ROWS))
    return ["--pipeline_config_path", str(tmp_path / "cfg.json"), "--meta_path", str(tmp_path / "meta.jsonl")]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("blocks", [[], ["--prompt_block", "2"], ["--parallel_blocks", "2"]])
def test_reflectionflow_cli_on_cpu(tmp_path, blocks):
    argv = _setup(tmp_path) + ["--output_dir", str(tmp_path / "out"), "--synthetic_weights",
                               "--device", "cpu", "--attn_impl", "pallas", *blocks]
    text = _run(tts_reflectionflow.main, argv)
    assert "p50 reflection-round latency:" in text and "candidates/sec/chip" in text
    for i in range(len(ROWS)):
        root = tmp_path / "out" / f"{i:05d}"
        assert len(list((root / "midimg").glob("*_round@*.png"))) == 6
        assert len(list((root / "samples_lastround").glob("*.png"))) == 2
        assert len(list((root / "samples_path_bestround").glob("*.png"))) == 2
        assert (root / "samples_best" / "00000.png").exists()
        assert json.loads((root / "search_state.json").read_text())["round_done"] == 2
        rows = [json.loads(line) for line in (root / "best_img_detailedscore.jsonl").read_text().splitlines()]
        assert list(rows[0]["evaluation"][0]) == (
            ["color_fidelity", "contrast_effectiveness", "multi_object_consistency", "overall_score"] if i == 0
            else ["object_completeness", "detectability", "occlusion_handling", "overall_score"])
    assert _run(tts_reflectionflow.main, argv).splitlines()[0] == "{}"  # resume: nothing left to run

    # the NFE curve over that run's candidates
    text = _run(verifier_filter.main, _setup(tmp_path) + [
        "--imgpath", str(tmp_path / "out"), "--output_dir", str(tmp_path / "curve"), "--nfes", "1", "2", "4",
        "--device", "cpu"])
    assert "nfe4: 2 selections" in text
    assert sorted(p.split("curve/")[1] for p in glob.glob(str(tmp_path / "curve" / "*" / "*.png"))) == [
        f"nfe{k}/{i:05d}.png" for k in (1, 2, 4) for i in range(2)]


def test_noise_prompt_scaling_cli_on_cpu(tmp_path):
    argv = _setup(tmp_path) + ["--output_dir", str(tmp_path / "out"), "--synthetic_weights", "--device", "cpu",
                               "--quantize", "int8"]
    text = _run(tts_t2i_noise_prompt_scaling.main, argv)
    assert "candidates/sec/chip" in text
    for i in range(len(ROWS)):
        assert len(glob.glob(str(tmp_path / "out" / f"{i:05d}" / "samples" / "*.png"))) == 4
        meta = [json.loads(line) for line in open(tmp_path / "out" / f"{i:05d}" / "metadata.jsonl")]
        assert meta[1]["current_prompts"] == [ROWS[i]["prompt"] + ", highly detailed"] * 2


def test_int8_profile_turns_the_prompt_cache_on(tmp_path):
    base = _setup(tmp_path) + ["--synthetic_weights", "--device", "cpu"]
    for flags, cached in (([], False), (["--quantize", "int8"], True)):
        args = build_parser("x").parse_args(base + flags)
        pipe = load_pipeline(load_config(args), args, rewrites_prompts=True)
        assert (pipe._embed_cache is not None) == cached


def test_clis_need_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    argv = _setup(tmp_path) + ["--output_dir", str(tmp_path / "out"), "--synthetic_weights"]
    for main in (tts_reflectionflow.main, tts_t2i_noise_prompt_scaling.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(argv)
    with pytest.raises(RuntimeError, match="--device cpu"):
        verifier_filter.main(argv + ["--imgpath", str(tmp_path)])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("section,name", [("verifier_args", "qwen_rm"), ("verifier_args", "nvila"),
                                          ("verifier_args", "nvila_jax"), ("reflection_args", "local_qwen")])
def test_model_backends_raise_naming_item_17(tmp_path, monkeypatch, section, name):
    """The model backends of item 17 raise for what they lack: `nvila` a local
    snapshot (it never downloads), `nvila_jax`, qwen_rm and local_qwen the
    model_path."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    argv = _setup(tmp_path, **{section: {"name": name}}) + [
        "--output_dir", str(tmp_path / "out"), "--synthetic_weights", "--device", "cpu"]
    mains = [tts_reflectionflow.main]
    if section == "verifier_args":
        mains += [tts_t2i_noise_prompt_scaling.main,
                  lambda a: verifier_filter.main(a + ["--imgpath", str(tmp_path)])]
    error, match = (FileNotFoundError, "never downloads") if name == "nvila" else (ValueError, "model_path")
    for main in mains:
        with pytest.raises(error, match=match):
            main(argv)
    assert not (tmp_path / "out").exists()

