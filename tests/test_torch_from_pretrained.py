"""`FluxPipeline.from_pretrained` of the port against the JAX package's on the
hermetic tiny diffusers snapshot (`tests/snapshot_fixture.py`): equal
configs, every parameter equal to the JAX tree carried over by the bridge,
`generate` from the same latents within 1e-4 of max |ref|; the CLIP
tokenizer branch against the JAX `load_tokenizer`; the CUDA default without
a fallback; and the sample and train CLIs on the snapshot without
`--synthetic_weights`. About 25 s on one core."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
from reflectionflow_tpu.utils.tokenizers import load_tokenizer as j_load_tokenizer
from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
from reflectionflow_tpu_torch.utils import jax_bridge
from reflectionflow_tpu_torch.utils.hf_loader import load_module
from reflectionflow_tpu_torch.utils.tokenizers import load_tokenizer

from snapshot_fixture import write_tiny_flux_snapshot

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flux_snapshot"))
    write_tiny_flux_snapshot(root)
    return root


@pytest.fixture(scope="module")
def pipes(snapshot):
    return (JaxFluxPipeline.from_pretrained(snapshot, dtype=jnp.float32),
            FluxPipeline.from_pretrained(snapshot, dtype=torch.float32, device="cpu"))


def test_configs_and_every_parameter_match_jax(pipes):
    jpipe, tpipe = pipes
    for name in ("dit_cfg", "vae_cfg", "t5_cfg", "clip_cfg"):
        assert dataclasses.asdict(getattr(tpipe, name)) == dataclasses.asdict(getattr(jpipe, name))
    p = jax.tree.map(np.asarray, jpipe.params)
    bridged = {"dit": jax_bridge.dit_state_dict(p["dit"], jpipe.dit_cfg), "vae": jax_bridge.vae_state_dict(p["vae"]),
               "t5": jax_bridge.t5_state_dict(p["t5"], jpipe.t5_cfg),
               "clip": jax_bridge.clip_state_dict(p["clip"], jpipe.clip_cfg)}
    for name, want in bridged.items():
        got = getattr(tpipe, name).state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            assert torch.equal(got[k], v), (name, k)
    assert tpipe.device == torch.device("cpu") and tpipe.dtype == torch.float32


def test_generate_from_the_same_latents_matches_jax(pipes):
    jpipe, tpipe = pipes
    lat = np.random.default_rng(3).standard_normal((2, 64, tpipe.dit_cfg.in_channels), dtype=np.float32)
    kw = dict(height=32, width=32, num_inference_steps=2, max_sequence_length=8)
    prompts = ["a red cube", "two dogs"]
    want = jpipe.generate(prompts, latents=jnp.asarray(lat), output_type="latent", **kw)
    got = tpipe.generate(prompts, latents=lat, output_type="latent", **kw)
    want, got = np.asarray(want), got.numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    img_want = jpipe.generate(prompts, latents=jnp.asarray(lat), **kw)
    assert np.abs(tpipe.generate(prompts, latents=lat, **kw).astype(int) - img_want.astype(int)).max() <= 1


def test_snapshot_tensors_missing_or_left_over_raise(snapshot, tmp_path):
    from reflectionflow_tpu_torch.config import FluxVAEConfig
    from reflectionflow_tpu_torch.models.flux.vae import FluxVAE
    from reflectionflow_tpu_torch.utils.hf_loader import flux_configs_from_dir
    from reflectionflow_tpu_torch.utils.safetensors_io import load_file, save_file

    vae_cfg = flux_configs_from_dir(snapshot)[1]
    sd = load_file(os.path.join(snapshot, "vae", "model.safetensors"))
    for name, tensors in (("missing", dict(list(sd.items())[1:])), ("extra", {**sd, "decoder.extra.weight": sd[next(iter(sd))]})):
        save_file(tensors, str(tmp_path / name / "model.safetensors"))
        with pytest.raises(KeyError, match="missing from the snapshot" if name == "missing" else "no parameter"):
            load_module(lambda: FluxVAE(vae_cfg), str(tmp_path / name), torch.float32, torch.device("cpu"))
    assert isinstance(vae_cfg, FluxVAEConfig)


def test_from_pretrained_defaults_to_cuda_without_fallback(snapshot):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FluxPipeline.from_pretrained(snapshot)


def test_clip_tokenizer_dir_matches_the_jax_loader(tmp_path):
    """A snapshot's `tokenizer/` (vocab.json + merges.txt): the port's pure-Python
    BPE gives the ids and mask that JAX's transformers tokenizer gives."""
    from reflectionflow_tpu_torch.utils import bpe

    chars = list(bpe.bytes_to_unicode().values())
    merges = [("a", "b"), ("c", "d</w>"), ("ab", "cd</w>"), ("r", "e"), ("re", "d</w>")]
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
    path = tmp_path / "tokenizer"
    path.mkdir()
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    texts = ["abcd red", "A RED, abcd!", "x" * 30]
    want = j_load_tokenizer(str(path), "clip", len(tokens), 49407)(texts, max_length=12)
    tok = load_tokenizer(str(path), "clip", len(tokens), 49407)
    assert isinstance(tok, bpe.CLIPBPETokenizer)
    got = tok(texts, max_length=12)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def _cfg(tmp_path, snapshot):
    cfg = {"pretrained_model_name_or_path": snapshot,
           "pipeline_args": {"torch_dtype": "fp32", "height": 16, "width": 16, "condition_size": 8,
                             "max_sequence_length": 8, "num_inference_steps": 2}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    return str(tmp_path / "cfg.json")


def test_sample_cli_loads_the_snapshot(tmp_path, snapshot):
    from reflectionflow_tpu_torch.cli import sample
    from reflectionflow_tpu_torch.search.artifacts import save_image

    save_image(str(tmp_path / "img" / "bad.png"), np.zeros((16, 16, 3), np.uint8))
    (tmp_path / "meta.json").write_text(json.dumps([{"prompt": "a cube", "bad_image": "bad.png",
                                                     "reflection": "make it red"}]))
    sample.main(["--pipeline_config_path", _cfg(tmp_path, snapshot), "--meta_path", str(tmp_path / "meta.json"),
                 "--root_dir", str(tmp_path / "img"), "--output_dir", str(tmp_path / "out"), "--device", "cpu",
                 "--attn_impl", "pallas"])
    assert os.listdir(tmp_path / "out") == ["result_0.png"]


def test_train_cli_loads_the_snapshot(tmp_path, snapshot, monkeypatch):
    from reflectionflow_tpu_torch.cli.train import main

    cfg = {"max_steps": 1, "save_interval": 1, "checkpoint_dir": str(tmp_path / "ck"),
           "data": {"batch_size": 1, "target_size": 16, "condition_size": 8}}
    (tmp_path / "train.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("FLUX_MODEL_DIR", snapshot)
    main(["--config", str(tmp_path / "train.json"), "--synthetic_data", "--device", "cpu"])
    assert (tmp_path / "ck" / "latest").exists()
