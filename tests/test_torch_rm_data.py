"""The port's reward-model data (`reflectionflow_tpu_torch/rm_train/data.py`)
against the JAX package's, on the tiny Qwen2.5-VL carried over by
`utils/jax_bridge.py`: `collate_rm_batch` in both layouts (ids, mask,
positions and labels exact; embeddings and patches within 1e-5), rows read
from PNG files and given as arrays, `build_side_sequence` with and without
the special token, `vision_train_geometry`, `convert_gsb_csv`, the JSONL
helpers `iter_jsonl` and `load_geneval_metadata`, the prompt templates, and
JAX `tests/test_rm_data.py`'s collate-then-step check on the port. Images
are mostly fed at their target size; `tests/test_torch_train.py::
test_resize_sites_match_jax` holds the side builder's resize to JAX's
(PIL's) bit for bit. About 20 s on one core."""

import json

import numpy as np
import pytest
import torch

from reflectionflow_tpu.rm_train import data as jdata
from reflectionflow_tpu.rm_train import prompt_template as jtemplate
from reflectionflow_tpu.search.artifacts import load_geneval_metadata as j_load_geneval_metadata
from reflectionflow_tpu.utils.jsonl import iter_jsonl as j_iter_jsonl
from reflectionflow_tpu_torch.rm_train import data as pdata
from reflectionflow_tpu_torch.rm_train import prompt_template as ptemplate
from reflectionflow_tpu_torch.rm_train import train as ptrain
from reflectionflow_tpu_torch.search.artifacts import load_geneval_metadata, save_image
from reflectionflow_tpu_torch.utils import threefry
from reflectionflow_tpu_torch.utils.jsonl import iter_jsonl

from test_torch_qwen_vl import bridge
from test_torch_rm_train import tiny_jax_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jm = tiny_jax_model()
    return jm, bridge(jm)


def _rows(tmp_path, sizes_A, sizes_B, as_files: bool, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i, (pa, pb) in enumerate(zip(sizes_A, sizes_B)):
        row = {"prompt": "a photo of " + "a red cube " * (i + 1), "score_A": 4.5 - i, "score_B": 2.0 + i}
        for side, px in (("A", pa), ("B", pb)):
            img = rng.integers(0, 255, (px, px, 3), dtype=np.uint8)
            if as_files:
                path = str(tmp_path / f"{side}{i}.png")
                save_image(path, img)
                img = path
            row[f"image_{side}"] = img
        row.update({"gsb": ["G", "B", "S"][i % 3]} if i < 3 else {"chosen_label": 22})
        rows.append(row)
    return rows


def _assert_batches_equal(got, want):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        w, g = np.asarray(w), got[k].cpu().numpy()
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k.startswith(("embeds_", "patches_")):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("as_files", [True, False], ids=["png", "arrays"])
def test_collate_default_layout_matches_jax(models, tmp_path, as_files):
    """Vision embeddings from the frozen tower written into each side's token
    rows; sides of different lengths (56 and 64 px images, prompts of 1-4
    phrases) right-padded with id 151643; GSB labels and an explicit invalid
    chosen_label."""
    jm, pm = models
    rows = _rows(tmp_path, [56, 56, 64, 56], [64, 56, 56, 56], as_files)
    want = jdata.collate_rm_batch(jm, rows, max_pixels=64 * 64, special_token_id=9)
    got = pdata.collate_rm_batch(pm, rows, max_pixels=64 * 64, special_token_id=9)
    _assert_batches_equal(got, want)
    assert got["chosen_label"][:, 0].tolist() == [1, -1, 0, 22]
    assert (got["ids_A"] == 151643).any() and got["mask_A"].dtype == torch.int32


def test_collate_vision_layout_matches_jax(models, tmp_path):
    """`train_vision`: one square grid for every image (max_pixels 256: 16 px),
    token rows only in the embeddings, raw patches (B, 16, 96)."""
    jm, pm = models
    rows = _rows(tmp_path, [16, 16, 16], [16, 16, 16], True, seed=1)
    want = jdata.collate_rm_batch(jm, rows, max_pixels=256, special_token_id=9, train_vision=True)
    got = pdata.collate_rm_batch(pm, rows, max_pixels=256, special_token_id=9, train_vision=True)
    _assert_batches_equal(got, want)
    assert got["patches_A"].shape == (3, 16, 96)
    assert pdata.vision_train_geometry(pm.vis_cfg, 256) == jdata.vision_train_geometry(jm.vis_cfg, 256) == (16, (1, 4, 4))


@pytest.mark.parametrize("max_pixels", [256, 448 * 448, 1000, 64])
def test_vision_train_geometry_matches_jax(models, max_pixels):
    jm, pm = models
    from reflectionflow_tpu_torch.config import QwenVLVisionConfig

    full = QwenVLVisionConfig()
    assert pdata.vision_train_geometry(pm.vis_cfg, max_pixels) == jdata.vision_train_geometry(jm.vis_cfg, max_pixels)
    assert pdata.vision_train_geometry(full, 448 * 448) == (448, (1, 32, 32))


@pytest.mark.parametrize("special", [9, None])
def test_build_side_sequence_matches_jax(models, special):
    jm, pm = models
    img = np.random.default_rng(2).integers(0, 255, (56, 56, 3), dtype=np.uint8)
    for fixed in (False, True):
        want = jdata.build_side_sequence(jm, img, "two dogs on a red sofa", None, 56 * 56, special, fixed_square=fixed)
        got = pdata.build_side_sequence(pm, img, "two dogs on a red sofa", None, 56 * 56, special, fixed_square=fixed)
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["image"], want["image"])
        assert (got["ids"][-1] == special) == (special is not None)


def test_convert_gsb_csv_matches_jax(tmp_path):
    """JAX `test_convert_gsb_csv`, and the alternative column names."""
    csv_path = tmp_path / "gsb.csv"
    csv_path.write_text("image_A,image_B,prompt,gsb,score_A,score_B\n"
                        "a.png,b.png,a cat,G,4.5,2.0\n"
                        "c.png,d.png,a dog,S,,\n")
    alt = tmp_path / "alt.csv"
    alt.write_text("img_A,img_B,caption,label\nx.png,y.png,a fox,B\n")
    for path in (csv_path, alt):
        assert pdata.convert_gsb_csv(str(path), image_root="/imgs") == jdata.convert_gsb_csv(str(path), image_root="/imgs")
    rows = pdata.convert_gsb_csv(str(csv_path), image_root="/imgs")
    assert rows[0]["image_A"] == "/imgs/a.png"
    assert rows[0]["gsb"] == "G" and rows[0]["score_A"] == 4.5
    assert rows[1]["gsb"] == "S" and rows[1]["score_A"] == 0.0


def test_jsonl_helpers_match_jax(tmp_path):
    """`utils/jsonl.py::iter_jsonl` and `search/artifacts.py::load_geneval_metadata`:
    blank lines skipped, non-ASCII kept, the [start:end] slice."""
    path = tmp_path / "meta.jsonl"
    rows = [{"prompt": f"a photo of {i} cats", "tag": "counting", "note": "ü"} for i in range(5)]
    path.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in rows[:3]) + "\n\n  \n"
                    + "\n".join(json.dumps(r) for r in rows[3:]) + "\n", encoding="utf-8")
    it = iter_jsonl(path)
    assert next(it) == rows[0] and list(it) == list(j_iter_jsonl(path))[1:] == rows[1:]
    for start, end in ((0, None), (1, 3), (2, 99), (4, 2)):
        assert load_geneval_metadata(str(path), start, end) == j_load_geneval_metadata(str(path), start, end)
    assert load_geneval_metadata(str(path), 1, 3) == rows[1:3]


def test_prompt_template_matches_jax():
    """JAX `test_prompt_template`, and every template type against JAX's text."""
    assert ptemplate.build_prompt("a cat", template_type="none") == "a cat"
    detailed = ptemplate.build_prompt("a cat", dims=["VQ", "TA"], template_type="detailed")
    assert "VQ" in detailed and "a cat" in detailed
    assert ptemplate.build_prompt("a cat", template_type="detailed_special").endswith(ptemplate.SPECIAL_TOKEN)
    assert ptemplate.SPECIAL_TOKEN == jtemplate.SPECIAL_TOKEN
    for kind in ("none", "simple", "video_score", "detailed", "detailed_special"):
        for dims in (None, ["VQ", "TA"]):
            assert ptemplate.build_prompt("a cat", dims, kind) == jtemplate.build_prompt("a cat", dims, kind)


def test_collate_and_step(models):
    """JAX `test_collate_and_step` on the port: the default layout's batch goes
    straight into the train step and gives a finite loss; G/B labels map to
    1/-1."""
    _, pm = models
    rng = np.random.default_rng(0)
    rows = [{"image_A": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8),
             "image_B": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8),
             "prompt": f"prompt {i}", "gsb": "G" if i % 2 == 0 else "B", "score_A": 4.0, "score_B": 2.0}
            for i in range(2)]
    batch = pdata.collate_rm_batch(pm, rows, special_token_id=9)
    assert batch["embeds_A"].shape[0] == 2 and batch["ids_A"].shape == batch["mask_A"].shape
    assert batch["chosen_label"][:, 0].tolist() == [1, -1]
    gen = torch.Generator().manual_seed(1)
    H = pm.lm_cfg.hidden_size
    trainable = {"lora": ptrain.rm_lora_init(threefry.prng_key(1), pm.model, r=2, alpha=2)["adapters"],
                 "rm_head": torch.randn((H, 1), generator=gen) * 0.1, "special": torch.zeros(H)}
    opt = ptrain.make_rm_optimizer(lr=1e-3)
    step = ptrain.make_rm_train_step(pm.model, opt, loss_type="bt", pooling="special", special_token_id=9, r=2, alpha=2)
    _, _, aux = step(trainable, opt.init(trainable), batch)
    assert np.isfinite(float(aux["loss"]))
