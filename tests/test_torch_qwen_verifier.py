"""The port's Qwen2.5-VL verifier and reflector against the JAX package, on
tiny fp32 models carried over by `utils/jax_bridge.py`:
`QwenRewardVerifier` scores (the `rm_lora` fold and the special-embedding row
of a reward checkpoint included; `quantize="int8"` against the JAX verifier's
int8 path), `LocalQwenReflector` texts with the JAX tests' stub tokenizer,
`load_qwen_vl` on a tiny Qwen snapshot this file writes, LoRA adapter files
written by each package and read by the other, the CLI builders, and
`score_images`. About 40 s on one core."""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.lora import lora as jlora
from reflectionflow_tpu.models.qwen_vl.generate import QwenVLGenerator as JGenerator
from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
from reflectionflow_tpu.models.qwen_vl.reward import RewardHead as JHead
from reflectionflow_tpu.reflect.generator import LocalQwenReflector as JReflector
from reflectionflow_tpu.rm_train.train import rm_lora_init, save_rm_checkpoint
from reflectionflow_tpu.utils.hf_loader import load_qwen_vl as j_load_qwen_vl
from reflectionflow_tpu.verifiers.qwen_verifier import QwenRewardVerifier as JVerifier
from reflectionflow_tpu_torch.lora import lora as tlora
from reflectionflow_tpu_torch.models.qwen_vl.generate import QwenVLGenerator
from reflectionflow_tpu_torch.models.qwen_vl.reward import RewardHead
from reflectionflow_tpu_torch.ops.quant import QuantLinear
from reflectionflow_tpu_torch.reflect.generator import LocalQwenReflector, load_reflector
from reflectionflow_tpu_torch.utils.hf_loader import load_qwen_vl
from reflectionflow_tpu_torch.utils.jax_bridge import qwen_lm_state_dict, qwen_vision_state_dict
from reflectionflow_tpu_torch.utils.safetensors_io import save_file
from reflectionflow_tpu_torch.verifiers import load_verifier
from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

from test_torch_qwen_vl import bridge

torch.set_num_threads(1)
REL = 1e-4


class _StubTokenizer:  # the JAX generate tests' stub
    def encode(self, text, add_special_tokens=False):
        return [5 + (ord(c) % 50) for c in text[:8]]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _jmodel(seed=0):
    return JModel.random_init(jax.random.PRNGKey(seed), dtype=jnp.float32)


def _head(jm, key=1, **kw):
    jh = JHead.random_init(jax.random.PRNGKey(key), jm.lm_cfg.hidden_size, **kw)
    return jh, RewardHead(w=torch.from_numpy(np.array(jh.w)), pooling=jh.pooling,
                          special_token_id=jh.special_token_id)


def _images(n, px=56, seed=0):
    """56 px: Qwen's smart_resize leaves it as it is (patch 4, merge 2, min 56^2)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (px, px, 3), dtype=np.uint8) for _ in range(n)]


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30), (got, ref)


@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_verifier_scores_match_jax(pooling):
    jm = _jmodel()
    pm = bridge(jm)
    jh, ph = _head(jm, pooling=pooling)
    jh.vq_mean, jh.vq_std = ph.vq_mean, ph.vq_std = 0.5, 2.0
    imgs = _images(3) + _images(1, px=64, seed=1)  # two groups: two grids
    prompts = ["a red cube", "a red cube", "two dogs", "a cat"]
    jv, pv = JVerifier(model=jm, head=jh, max_pixels=64 * 64), QwenRewardVerifier(model=pm, head=ph, max_pixels=64 * 64)
    _close(pv.raw_scores(imgs, prompts), jv.raw_scores(imgs, prompts))
    want = jv.score(imgs, prompts)
    got = pv.score(imgs, prompts)
    _close([g["VQ"] for g in got], [w["VQ"] for w in want])
    assert [g["overall_score"]["explanation"] for g in got] == ["qwen_rm VQ"] * 4


def _rm_checkpoint(path, jm, special_id=77):
    rng = np.random.default_rng(5)
    lora = rm_lora_init(jax.random.PRNGKey(2), jm.lm_params, r=2, alpha=4.0)
    lora["adapters"] = {p: {"A": np.asarray(ab["A"]), "B": rng.normal(0, 0.1, np.shape(ab["B"])).astype(np.float32)}
                        for p, ab in lora["adapters"].items()}
    trainable = {"lora": lora["adapters"], "rm_head": rng.normal(size=(jm.lm_cfg.hidden_size, 1)).astype(np.float32),
                 "special": rng.normal(size=(jm.lm_cfg.hidden_size,)).astype(np.float32)}
    save_rm_checkpoint(str(path), trainable, pooling="special", special_token_id=special_id, vq_mean=0.1, vq_std=1.5,
                       lora_alpha=4.0, lora_r=2)
    return trainable


def test_verifier_checkpoint_reconstruction_matches_jax(tmp_path):
    """rm_head + model_config + rm_lora: the LoRA fold and the `<|VQ_reward|>` row."""
    jm = _jmodel()
    pm = bridge(jm)
    _rm_checkpoint(tmp_path, jm)
    jv = JVerifier(model_path=str(tmp_path), model=jm, max_pixels=56 * 56)
    pv = QwenRewardVerifier(model_path=str(tmp_path), model=pm, max_pixels=56 * 56)
    assert pv.rm.head.pooling == "special" and pv.rm.head.special_token_id == 77
    # the folded weights and the installed row: bit for bit what the JAX verifier holds
    want = {**qwen_lm_state_dict(jax.tree.map(np.asarray, jv.rm.model.lm_params), pm.lm_cfg)}
    got = pv.rm.model.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    imgs, prompts = _images(2), ["a red cube", "a dog"]
    ids, _, _ = pv._prepare_ids(imgs[0], prompts[0])
    assert ids[-1] == 77
    _close(pv.raw_scores(imgs, prompts), jv.raw_scores(imgs, prompts))
    _close([r["VQ"] for r in pv.reward(imgs, prompts)], [r["VQ"] for r in jv.reward(imgs, prompts)])


_LM_LINEARS = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
               "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}
_VIS_LINEARS = {"qkv": "attn.qkv", "proj": "attn.proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
                "down": "mlp.down_proj"}


def test_verifier_int8_matches_jax_int8():
    """quantize="int8" against the JAX verifier's own int8 path on the same model.

    At min size 2048 the tiny blocks' q/o/qkv/proj/MLP linears go W8A8 and
    k/v (1024 stacked) stay float, in both packages. Every block linear is
    held bit for bit: which ones are quantized, w_q and w_scale, and the W8A8
    product of one fp32 input. The scores are held to the JAX int8 scores
    within 3e-2 of max |ref|, not tighter: at min size 16, a 3e-7 relative
    change of the norm weights moves the port's own int8 scores by 1.6e-2 of
    max |ref| (an activation within fp32 noise of a k + 1/2 rounds the other
    way; the fp32 scores move 1.2e-6), and the two packages' fp32 activations
    differ by about as much. On this test's inputs the gap is 1.6e-2. The JAX
    test's fp32-regime bound stays beside it."""
    from reflectionflow_tpu.models.flux.dit import linear as jlinear

    jm = _jmodel()
    jh, ph = _head(jm)
    imgs = _images(3) + _images(1, px=64, seed=1)
    prompts = ["a prompt", "a red cube", "two dogs", "a cat"]
    f32 = JVerifier(model=jm, head=jh, max_pixels=64 * 64).raw_scores(imgs, prompts)
    pv = QwenRewardVerifier(model=bridge(jm), head=ph, max_pixels=64 * 64, quantize="int8", quantize_min_size=2048)
    jv = JVerifier(model=jm, head=jh, max_pixels=64 * 64, quantize="int8", quantize_min_size=2048)  # quantizes jm
    rng = np.random.default_rng(3)
    quantized = set()
    for jblocks, pblocks, names in ((jv.rm.model.lm_params["blocks"], pv.rm.model.model.layers, _LM_LINEARS),
                                    (jv.rm.model.vision_params["blocks"], pv.rm.model.visual.blocks, _VIS_LINEARS)):
        for i, pb in enumerate(pblocks):
            for jn, pn in names.items():
                jp, lin = {k: v[i] for k, v in jblocks[jn].items()}, pb.get_submodule(pn)
                assert isinstance(lin, QuantLinear) == ("w_q" in jp), (jn, pn)
                if "w_q" not in jp:
                    continue
                quantized.add(jn)
                assert lin.act_quant and "act_q" in jp
                np.testing.assert_array_equal(lin.w_q.numpy(), np.asarray(jp["w_q"]).T)
                np.testing.assert_array_equal(lin.w_scale.numpy(), np.asarray(jp["w_scale"]).reshape(-1))
                x = rng.normal(size=(5, lin.w_q.shape[1])).astype(np.float32)
                with torch.no_grad():
                    got = lin(torch.from_numpy(x)).numpy()
                np.testing.assert_array_equal(got, np.asarray(jlinear(jp, jnp.asarray(x))))
    assert quantized == {"q", "o", "qkv", "proj", "gate", "up", "down"}
    ref, out = jv.raw_scores(imgs, prompts), pv.raw_scores(imgs, prompts)
    ref, out, f32 = (np.asarray(s, np.float64) for s in (ref, out, f32))
    assert np.isfinite(out).all()
    _close(out, ref, rel=3e-2)
    assert (np.abs(out - f32) < np.maximum(1.0, np.abs(f32))).all(), (out, f32)


def test_reflector_texts_match_jax():
    jm = _jmodel()
    pm = bridge(jm)
    jr = JReflector(JGenerator(model=jm, tokenizer=_StubTokenizer(), eos_token_id=-1), max_new_tokens=5,
                    template="fix {original_prompt} ({current_prompt}) {prev_reflection} {evaluation}")
    pr = load_reflector("local_qwen", model=QwenVLGenerator(model=pm, tokenizer=_StubTokenizer(), eos_token_id=-1),
                        max_new_tokens=5, template=jr.template)
    assert isinstance(pr, LocalQwenReflector) and pr.system == jr.system
    imgs = _images(2) + _images(1, px=40, seed=3)  # 40 px: resized to 56 by smart_resize
    args = (["a cube", "a dog", "a cat"], ["a red cube", "a dog", "a cat!"])
    kw = dict(prev_reflections=["", "more", "x"], evaluations=['{"s": 1}', "", ""])
    want = jr.generate(imgs, *args, **kw)
    assert pr.generate(imgs, *args, **kw) == want and all(want)
    with pytest.raises(ValueError, match="images has 2 entries"):
        pr.generate(imgs[:2], *args)
    with pytest.raises(KeyError):
        LocalQwenReflector(pr.model, template="{nope}")


def _write_qwen_snapshot(root, jm, shards=2):
    """A Qwen2.5-VL snapshot of `jm`'s weights: transformers' newer key layout
    (model.language_model.*, model.visual.*) in `shards` files, config.json and
    a byte-level Qwen2 tokenizer (no merges) with the chat special tokens."""
    from transformers import Qwen2TokenizerFast

    from reflectionflow_tpu_torch.utils.bpe import bytes_to_unicode

    lm, vis = jm.lm_cfg, jm.vis_cfg
    sd = {**qwen_lm_state_dict(jax.tree.map(np.asarray, jm.lm_params), lm),
          **qwen_vision_state_dict(jax.tree.map(np.asarray, jm.vision_params), vis)}
    sd = {k.replace("model.", "model.language_model.", 1).replace("visual.", "model.visual.", 1): v
          for k, v in sd.items()}
    names = sorted(sd)
    for i in range(shards):
        save_file({k: sd[k] for k in names[i::shards]}, os.path.join(root, f"model-0000{i + 1}.safetensors"))
    cfg = {"vocab_size": lm.vocab_size, "hidden_size": lm.hidden_size, "intermediate_size": lm.intermediate_size,
           "num_hidden_layers": lm.num_layers, "num_attention_heads": lm.num_heads,
           "num_key_value_heads": lm.num_kv_heads, "rope_theta": lm.rope_theta,
           "rope_scaling": {"type": "mrope", "mrope_section": list(lm.mrope_section)},
           "tie_word_embeddings": lm.tie_word_embeddings,
           "vision_config": {"depth": vis.depth, "hidden_size": vis.hidden_size,
                             "intermediate_size": vis.intermediate_size, "num_heads": vis.num_heads,
                             "patch_size": vis.patch_size, "temporal_patch_size": vis.temporal_patch_size,
                             "spatial_merge_size": vis.spatial_merge_size, "window_size": vis.window_size,
                             "fullatt_block_indexes": list(vis.fullatt_block_indexes),
                             "out_hidden_size": vis.out_hidden_size}}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = Qwen2TokenizerFast(vocab_file=os.path.join(root, "vocab.json"), merges_file=os.path.join(root, "merges.txt"))
    tok.add_special_tokens({"additional_special_tokens": ["<|im_start|>", "<|im_end|>", "<|vision_start|>",
                                                          "<|vision_end|>", "<|image_pad|>"]})
    tok.save_pretrained(root)


def test_load_qwen_vl_snapshot_matches_jax(tmp_path):
    jm = _jmodel(seed=4)
    _write_qwen_snapshot(str(tmp_path), jm)
    jm2, jtok = j_load_qwen_vl(str(tmp_path), dtype=jnp.float32)
    pm, ptok = load_qwen_vl(str(tmp_path), dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(pm.lm_cfg) == dataclasses.asdict(jm2.lm_cfg)
    assert dataclasses.asdict(pm.vis_cfg) == dataclasses.asdict(jm2.vis_cfg)
    want = {**qwen_lm_state_dict(jax.tree.map(np.asarray, jm2.lm_params), pm.lm_cfg),
            **qwen_vision_state_dict(jax.tree.map(np.asarray, jm2.vision_params), pm.vis_cfg)}
    got = pm.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    text = "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>Rate it's 42 ÄÖ<|im_end|>\n"
    assert ptok.encode(text, add_special_tokens=False) == jtok.encode(text, add_special_tokens=False)
    ids = ptok.encode(text)
    assert ptok.decode(ids) == jtok.decode(ids, skip_special_tokens=True)
    img = _images(1)
    _close(pm.forward_logits(np.asarray([3, 151652] + [151655] * 49 + [151653, 9]), img),
           jm2.forward_logits(np.asarray([3, 151652] + [151655] * 49 + [151653, 9]), img))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_qwen_vl(str(tmp_path))


def test_lora_adapter_files_cross_read_and_fold(tmp_path):
    """An adapter file written by either package reads back in the other, and the
    generator folds `lora.safetensors` beside a snapshot as JAX does."""
    jm = _jmodel(seed=6)
    lora = jlora.lora_init(jax.random.PRNGKey(7), jm.lm_params, r=2, alpha=4.0,
                           targets=("blocks/q/w", "blocks/down/w", "lm_head/w"))
    rng = np.random.default_rng(8)
    lora["adapters"] = {p: {"A": np.asarray(ab["A"]), "B": rng.normal(0, 0.1, np.shape(ab["B"])).astype(np.float32)}
                        for p, ab in lora["adapters"].items()}
    jlora.save_lora_adapter(str(tmp_path / "jax.safetensors"), lora)
    tlora.save_lora_adapter(str(tmp_path / "torch.safetensors"), lora)
    for back in (tlora.load_lora_adapter(str(tmp_path / "jax.safetensors")),
                 jlora.load_lora_adapter(str(tmp_path / "torch.safetensors"))):
        assert (back["_alpha"], back["_r"]) == (4.0, 2.0) and set(back["adapters"]) == set(lora["adapters"])
        for p, ab in lora["adapters"].items():
            for w in ("A", "B"):
                np.testing.assert_array_equal(np.asarray(back["adapters"][p][w]), ab[w])

    snap = tmp_path / "snap"
    _write_qwen_snapshot(str(snap), jm, shards=1)
    tlora.save_lora_adapter(str(snap / "lora.safetensors"), lora)
    gen = QwenVLGenerator.from_pretrained(str(snap), device="cpu")
    jgen = JGenerator.from_pretrained(str(snap))
    want = {**qwen_lm_state_dict(jax.tree.map(np.asarray, jgen.model.lm_params), gen.model.lm_cfg)}
    got = gen.model.state_dict()
    for k, v in want.items():  # bf16 both: the fp32 delta rounded, then added in bf16
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    base = load_qwen_vl(str(snap), device="cpu")[0].state_dict()
    assert not torch.equal(got["model.layers.0.self_attn.q_proj.weight"], base["model.layers.0.self_attn.q_proj.weight"])


def test_cli_builders_wire_the_qwen_models(tmp_path, monkeypatch):
    from reflectionflow_tpu_torch.cli.common import build_reflector, build_verifier
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.utils import device as udevice

    quantized = []  # at tiny widths the default min size keeps every linear float: record the calls
    monkeypatch.setattr(udevice, "quantize_blocks", lambda blocks, n: quantized.append((len(blocks), n)))

    jm = _jmodel()
    _write_qwen_snapshot(str(tmp_path), jm, shards=1)
    _rm_checkpoint(tmp_path, jm)
    cfg = TTSConfig.load(_cfg_file(tmp_path, {
        "verifier_args": {"name": "qwen_rm", "model_path": str(tmp_path), "quantize": "int8"},
        "reflection_args": {"name": "local_qwen", "template": "T {original_prompt}", "system_prompt": ""}}))
    v = build_verifier(cfg, device="cpu")
    assert isinstance(v, QwenRewardVerifier) and v.tokenizer is not None
    assert quantized == [(2, 1 << 18), (2, 1 << 18)]  # the LM's and the tower's blocks
    r = build_reflector(cfg, device="cpu")
    assert isinstance(r, LocalQwenReflector) and r.template == "T {original_prompt}" and r.system == ""
    assert r.model.model.device == torch.device("cpu") and r.model.tokenizer is not None
    out = r.generate(_images(1), ["a cube"], ["a cube"], max_new_tokens=3)
    assert len(out) == 1 and isinstance(out[0], str)
    cfg.verifier_args.model_path = None
    with pytest.raises(ValueError, match="model_path"):
        build_verifier(cfg, device="cpu")
    with pytest.raises(ValueError, match="model_path"):
        build_reflector(cfg, device="cpu")
    with pytest.raises(ValueError, match="model_path"):  # as the JAX nvila_jax refuses
        load_verifier("nvila_jax")


def _cfg_file(tmp_path, cfg):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_score_images_cli_matches_jax(tmp_path):
    """Both CLIs load the snapshot in bf16 (their default), so the scores agree to
    bf16's rounding: within 5e-2 of max |ref| (the fp32 tests above hold 1e-4)."""
    from reflectionflow_tpu.cli import score_images as jscore
    from reflectionflow_tpu_torch.cli import score_images as tscore
    from reflectionflow_tpu_torch.search.artifacts import save_image

    jm = _jmodel()
    _write_qwen_snapshot(str(tmp_path), jm, shards=1)
    _rm_checkpoint(tmp_path, jm)
    rows = []
    for i, img in enumerate(_images(3, seed=9)):
        save_image(str(tmp_path / f"{i}.png"), img)
        rows.append({"image": str(tmp_path / f"{i}.png"), "prompt": f"prompt {i}"})
    (tmp_path / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    common = ["--meta_path", str(tmp_path / "meta.jsonl"), "--model_path", str(tmp_path), "--batch_size", "2"]
    jscore.main(common + ["--output_json", str(tmp_path / "jax.jsonl")])
    tscore.main(common + ["--output_json", str(tmp_path / "torch.jsonl"), "--device", "cpu"])
    want = [json.loads(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in (tmp_path / "torch.jsonl").read_text().splitlines()]
    assert [g["image"] for g in got] == [w["image"] for w in want]
    _close([g["VQ"] for g in got], [w["VQ"] for w in want], rel=5e-2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # a second run resumes: nothing left to score
        tscore.main(common + ["--output_json", str(tmp_path / "torch.jsonl"), "--device", "cpu"])
    assert "resuming: 3 already scored" in out.getvalue()
    assert len((tmp_path / "torch.jsonl").read_text().splitlines()) == 3
