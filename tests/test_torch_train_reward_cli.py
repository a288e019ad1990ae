"""The port's reward-model CLI (`reflectionflow_tpu_torch/cli/train_reward.py`)
against the JAX package's (`reflectionflow_tpu/cli/train_reward.py`) on the
same PNG rows, `--synthetic_weights`, `--device cpu`: both start from the
JAX CLI's tiny model and trainable (carried over by `utils/jax_bridge.py`
through the port CLI's `build_model` / `init_trainable`), train 3 steps with
a checkpoint after each, evaluate the held-out pairs and write `final_model`;
then each resumes from its own `checkpoint-2`. The same `metrics.jsonl`
keys and steps, losses within rtol 1e-3, the same held-out accuracy, the same
checkpoint files (the optimizer state aside: `opt_state.pt` here,
`opt_state.npz` in JAX) and `model_config.json` values. Also: JAX
`tests/test_rm_train.py`'s two CLI checks on the port (the final model
scores through `QwenRewardVerifier`; `--vision_lora` saves trained tower
adapters), `load_rows` over csv / jsonl / json, and the refusals
(cuda without CUDA); `--fsdp_devices 2` over two gloo ranks against one
device (losses rtol 1e-5) and a world of another size. About 50 s on one
core."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.cli import train_reward as jcli
from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
from reflectionflow_tpu.rm_train.train import rm_lora_init, rm_vision_lora_init
from reflectionflow_tpu_torch.cli import train_reward as pcli
from reflectionflow_tpu_torch.rm_train.train import load_rm_checkpoint
from reflectionflow_tpu_torch.search.artifacts import save_image
from reflectionflow_tpu_torch.utils.jax_bridge import rm_trainable_from_jax
from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

from test_torch_qwen_vl import bridge

torch.set_num_threads(1)
SEED = 0


def _write_rows(root, n, px, gsb=("G", "B", "S")):
    """n comparison rows of random PNG pairs at `px`; image paths relative to `root`."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        for side in "ab":
            save_image(str(root / f"{side}{i}.png"), rng.integers(0, 255, (px, px, 3), dtype=np.uint8))
        rows.append({"image_A": f"a{i}.png", "image_B": f"b{i}.png", "prompt": f"prompt {i}",
                     "gsb": gsb[i % len(gsb)], "score_A": 4.0, "score_B": 3.0})
    meta = root / "meta.jsonl"
    meta.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(meta)


def _jax_cli_trainable(jm, r, alpha, vision=False, output_dim=1):
    """What the JAX CLI's main builds (`cli/train_reward.py:153-163`)."""
    key = jax.random.PRNGKey(SEED)
    H = jm.lm_cfg.hidden_size
    t = {"lora": rm_lora_init(key, jm.lm_params, r=r, alpha=alpha)["adapters"],
         "rm_head": jax.random.normal(jax.random.fold_in(key, 1), (H, output_dim)) * 0.02,
         "special": jax.random.normal(jax.random.fold_in(key, 2), (H,)) * 0.02}
    if vision:
        t["vision_lora"] = rm_vision_lora_init(jax.random.fold_in(key, 3), jm.vision_params, r=r, alpha=alpha)["adapters"]
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def jmodel():
    return JModel.random_init(jax.random.PRNGKey(SEED), dtype=jnp.float32)


@pytest.fixture
def from_jax(monkeypatch, jmodel):
    """The port CLI on the JAX CLI's model and trainable."""
    monkeypatch.setattr(pcli, "build_model", lambda args, device: (bridge(jmodel), None))

    def init(model, args, device):
        return rm_trainable_from_jax(_jax_cli_trainable(jmodel, args.lora_r, args.lora_alpha, args.vision_lora,
                                                        args.output_dim), model)

    monkeypatch.setattr(pcli, "init_trainable", init)


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _files(out):
    return {d: sorted(os.listdir(os.path.join(out, d))) for d in sorted(os.listdir(out)) if d != "metrics.jsonl"}


def test_cli_matches_jax_cli_with_resume(tmp_path, from_jax):
    (tmp_path / "imgs").mkdir()
    meta = _write_rows(tmp_path / "imgs", 6, 56)
    flags = ["--meta_data", meta, "--data_dir", str(tmp_path / "imgs"), "--synthetic_weights",
             "--per_device_train_batch_size", "2", "--num_train_epochs", "1.5", "--save_epochs", "0.5",
             "--eval_fraction", "0.34", "--max_pixels", "4096", "--lora_r", "2", "--loss_type", "btt",
             "--learning_rate", "1e-3"]
    runs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        final = main(flags + ["--output_dir", out] + extra)
        resumed = str(tmp_path / f"{name}_resumed")
        main(flags + ["--output_dir", resumed, "--resume_from", os.path.join(out, "checkpoint-2")] + extra)
        runs[name] = (out, final, resumed)
    (j_out, j_final, j_res), (p_out, p_final, p_res) = runs["jax"], runs["port"]
    for j_dir, p_dir, steps in ((j_out, p_out, [1, 2, 3]), (j_res, p_res, [3])):
        jm, pm = _metrics(j_dir), _metrics(p_dir)
        assert [sorted(m) for m in pm] == [sorted(m) for m in jm]
        assert [m["step"] for m in pm if "step" in m] == steps
        np.testing.assert_allclose([m["loss"] for m in pm if "loss" in m], [m["loss"] for m in jm if "loss" in m],
                                   rtol=1e-3)
        assert pm[-1]["eval_pairwise_accuracy"] == jm[-1]["eval_pairwise_accuracy"]
        want = {d: [f.replace("opt_state.npz", "opt_state.pt") for f in fs] for d, fs in _files(j_dir).items()}
        assert _files(p_dir) == want
    with open(os.path.join(j_final, "model_config.json")) as f:
        j_cfg = json.load(f)
    with open(os.path.join(p_final, "model_config.json")) as f:
        p_cfg = json.load(f)
    assert set(p_cfg) == set(j_cfg)
    for k, v in j_cfg.items():
        if k in ("VQ_mean", "VQ_std"):
            np.testing.assert_allclose(p_cfg[k], v, rtol=1e-3)
        else:
            assert p_cfg[k] == v, k
    j_back, p_back = jax.tree.map(np.asarray, load_rm_checkpoint(j_final)[0]), load_rm_checkpoint(p_final)[0]
    assert jax.tree.structure(j_back) == jax.tree.structure(jax.tree.map(lambda t: 0, p_back))


def test_cli_final_model_scores(tmp_path):
    """JAX `test_train_reward_cli_end_to_end` on the port: GSB rows -> train
    -> `final_model` (special pooling) that `QwenRewardVerifier` reads and
    scores with; metrics hold losses and the held-out accuracy."""
    meta = _write_rows(tmp_path, 6, 32)
    out = str(tmp_path / "rm_out")
    final = pcli.main(["--meta_data", meta, "--data_dir", str(tmp_path), "--output_dir", out, "--synthetic_weights",
                       "--per_device_train_batch_size", "2", "--num_train_epochs", "1", "--eval_fraction", "0.34",
                       "--max_pixels", "1024", "--lora_r", "2", "--loss_type", "btt", "--device", "cpu"])
    for name in ("model_config.json", "rm_head.safetensors", "rm_lora.safetensors"):
        assert os.path.exists(os.path.join(final, name))
    with open(os.path.join(final, "model_config.json")) as f:
        assert json.load(f)["logits_processing"] == "special"
    metrics = _metrics(out)
    assert any("loss" in m for m in metrics) and any("eval_pairwise_accuracy" in m for m in metrics)
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel

    model = QwenVLModel.random_init(torch.Generator().manual_seed(SEED))  # the CLI's synthetic base
    verifier = QwenRewardVerifier(model=model, model_path=final, max_pixels=1024)
    img = np.random.default_rng(0).integers(0, 255, (32, 32, 3), dtype=np.uint8)
    assert np.isfinite(verifier.reward([img], ["a test prompt"])[0]["VQ"])


def test_cli_vision_lora(tmp_path):
    """JAX `test_train_reward_cli_vision_lora` on the port: the final
    checkpoint carries `vision.*` adapters whose B factors moved off zero."""
    meta = _write_rows(tmp_path, 4, 24, gsb=("G",))
    final = pcli.main(["--meta_data", meta, "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
                       "--synthetic_weights", "--per_device_train_batch_size", "2", "--num_train_epochs", "1",
                       "--eval_fraction", "0.25", "--max_pixels", "256", "--lora_r", "2", "--loss_type", "bt",
                       "--vision_lora", "--vision_lr", "1e-3", "--device", "cpu"])
    restored, _ = load_rm_checkpoint(final)
    assert restored.get("vision_lora"), "vision adapters missing from the checkpoint"
    assert any(p.startswith("merger/") for p in restored["vision_lora"])
    assert max(float(ab["B"].abs().max()) for ab in restored["vision_lora"].values()) > 0.0


def test_load_rows_matches_jax(tmp_path):
    """csv (with the image root), jsonl and json rows, `--data_dir` prefixes."""
    rows = [{"image_A": "a.png", "image_B": "b.png", "prompt": "a cat", "gsb": "G"},
            {"image_A": "c.png", "image_B": "d.png", "prompt": "a dog", "chosen_label": -1}]
    (tmp_path / "m.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    (tmp_path / "m.json").write_text(json.dumps(rows))
    (tmp_path / "m.csv").write_text("image_A,image_B,prompt,gsb\na.png,b.png,a cat,B\n")
    for name in ("m.jsonl", "m.json", "m.csv"):
        for root in ("", "/data"):
            assert pcli.load_rows(str(tmp_path / name), root) == jcli.load_rows(str(tmp_path / name), root)
    assert pcli.load_rows(str(tmp_path / "m.json"), "/data")[1]["image_B"] == "/data/d.png"
    labels = np.asarray([1, -1, 0, 1])
    for rA, rB in (([1.0, 0.0, 3.0, 0.5], [0.0, 1.0, 0.0, 2.0]), ([0.0] * 4, [1.0] * 4)):
        assert pcli.pairwise_accuracy(np.asarray(rA), np.asarray(rB), labels) == \
            jcli.pairwise_accuracy(np.asarray(rA), np.asarray(rB), labels)


def test_cli_refusals(tmp_path):
    """The refusals, and `--fsdp_devices 2 --device cpu` (it raised before
    the training slice): the CLI spawns two gloo ranks that train the
    FSDP-sharded base on the global batch of 2 and rank 0 writes; its losses
    are the one-device run's (rtol 1e-5). Inside a process group of another
    size the flag raises ValueError."""
    import torch.distributed as dist

    from reflectionflow_tpu_torch.parallel.dryrun import file_init

    meta = _write_rows(tmp_path, 4, 16)
    base = ["--meta_data", meta, "--output_dir", str(tmp_path / "out"), "--synthetic_weights"]
    train = ["--meta_data", meta, "--data_dir", str(tmp_path), "--synthetic_weights",
             "--per_device_train_batch_size", "2", "--lora_r", "2",
             "--eval_fraction", "0", "--max_pixels", "256", "--device", "cpu"]
    losses = {}
    for label, extra in (("one", []), ("fsdp", ["--fsdp_devices", "2"])):
        out = tmp_path / label
        final = pcli.main(train + ["--output_dir", str(out)] + extra)
        assert os.path.exists(os.path.join(final, "rm_lora.safetensors"))
        losses[label] = [json.loads(line)["loss"] for line in open(out / "metrics.jsonl")]
    assert len(losses["one"]) == 2
    np.testing.assert_allclose(losses["fsdp"], losses["one"], rtol=1e-5)
    dist.init_process_group("gloo", init_method=file_init(str(tmp_path)), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="process group has 1 ranks"):
            pcli.main(base + ["--fsdp_devices", "2", "--device", "cpu"])
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            pcli.main(base)  # the default device is cuda; no CPU fallback
    with pytest.raises(ValueError, match="synthetic_weights"):
        pcli.main(["--meta_data", meta, "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")
