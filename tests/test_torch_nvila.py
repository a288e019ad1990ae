"""The port's NVILA verifier against the JAX package, on tiny fp32 models
carried over by `utils/jax_bridge.py` (`siglip_state_dict`,
`nvila_projector_state_dict`, `nvila_from_jax`): the SigLIP tower at every
tap, VILA's flat_square downsample, the projector, first-token logits of a
left-padded batch, `load_nvila` on a VILA bundle this file writes (both
packages read the same directory: JAX with transformers' AutoTokenizer, the
port with its BPE), `nvila_jax` under int8 against JAX's int8 path, `nvila`
from a hub-cache snapshot, and the yes/no ranking of the outputs. About 40 s
on one core."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu import config as jconfig
from reflectionflow_tpu.models.nvila.model import NvilaModel as JNvila
from reflectionflow_tpu.models.nvila.model import downsample_tokens as j_downsample
from reflectionflow_tpu.models.nvila.model import projector_apply as j_projector
from reflectionflow_tpu.models.nvila.siglip import siglip_apply as j_siglip
from reflectionflow_tpu.models.nvila.siglip import siglip_init
from reflectionflow_tpu.models.qwen_vl.lm import qwen_lm_init
from reflectionflow_tpu.utils.device import quantize_blocks as j_quantize_blocks
from reflectionflow_tpu.verifiers.nvila import NvilaJaxVerifier as JNvilaVerifier
from reflectionflow_tpu_torch.config import SiglipVisionConfig
from reflectionflow_tpu_torch.models.nvila.model import NvilaProjector, downsample_tokens
from reflectionflow_tpu_torch.models.nvila.siglip import SiglipVisionModel, siglip_apply
from reflectionflow_tpu_torch.ops.quant import QuantLinear
from reflectionflow_tpu_torch.utils.hf_loader import load_nvila
from reflectionflow_tpu_torch.utils.jax_bridge import nvila_from_jax, nvila_projector_state_dict, siglip_state_dict
from reflectionflow_tpu_torch.verifiers import load_verifier
from reflectionflow_tpu_torch.verifiers.base import RankingRule, select_topk
from reflectionflow_tpu_torch.verifiers.nvila import NvilaJaxVerifier, NvilaVerifier

torch.set_num_threads(1)
REL = 1e-4


class StubTokenizer:
    """The JAX NVILA tests' character tokenizer (ids 5..64)."""

    def encode(self, text, add_special_tokens=False):
        return [5 + (ord(c) % 60) for c in text]


def close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


def lm_cfg():
    """The 2-layer Qwen2 LM of `tools/nvila_bench_tpu.py`'s tiny mode."""
    return jconfig.QwenLMConfig(vocab_size=150001, hidden_size=64, intermediate_size=128, num_layers=2,
                                num_heads=4, num_kv_heads=2, head_dim=16, mrope_section=(8, 0, 0),
                                tie_word_embeddings=True)


def _perturb(tree, rng, scale=0.05):
    """Every leaf moved by N(0, scale^2): biases and norms away from 0 and 1."""
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, scale, np.shape(a)).astype(np.float32), tree)


def _projector(rng, c_in, hidden, norm=True):
    p = {"fc1": {"w": rng.normal(0, c_in ** -0.5, (c_in, hidden)).astype(np.float32),
                 "b": rng.normal(0, 0.05, hidden).astype(np.float32)},
         "fc2": {"w": rng.normal(0, hidden ** -0.5, (hidden, hidden)).astype(np.float32),
                 "b": rng.normal(0, 0.05, hidden).astype(np.float32)}}
    if norm:
        p["ln"] = {"scale": (1 + rng.normal(0, 0.1, c_in)).astype(np.float32),
                   "bias": rng.normal(0, 0.1, c_in).astype(np.float32)}
    return p


def jax_nvila(seed=0, k=2, norm=True, tokenizer=None):
    rng = np.random.default_rng(seed)
    vis_cfg, lcfg = jconfig.SiglipVisionConfig.tiny(), lm_cfg()
    vis = _perturb(siglip_init(jax.random.PRNGKey(seed), vis_cfg), rng)
    lm = _perturb(qwen_lm_init(jax.random.PRNGKey(seed + 1), lcfg), rng)
    proj = _projector(rng, vis_cfg.hidden_size * k * k, lcfg.hidden_size, norm)
    return JNvila(vis_params=vis, proj_params=proj, lm_params=lm, vis_cfg=vis_cfg, lm_cfg=lcfg,
                  cfg=jconfig.NvilaConfig(select_layer=-2, downsample=k), tokenizer=tokenizer or StubTokenizer())


def images(n, seed=3, px=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (px, px, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("select_layer", [0, -1, -2])
def test_siglip_tower_matches_jax(select_layer):
    cfg = SiglipVisionConfig.tiny()
    params = _perturb(siglip_init(jax.random.PRNGKey(0), jconfig.SiglipVisionConfig.tiny()),
                      np.random.default_rng(0))
    tower = SiglipVisionModel(cfg)
    tower.load_state_dict(siglip_state_dict(params, cfg), strict=True)
    pixels = np.random.default_rng(1).standard_normal((2, 24, 24, 3)).astype(np.float32)
    want = j_siglip(params, jconfig.SiglipVisionConfig.tiny(), jnp.asarray(pixels), select_layer=select_layer)
    with torch.no_grad():
        got = siglip_apply(tower, torch.from_numpy(pixels), select_layer=select_layer)
    close(got.numpy(), np.asarray(want), rel=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        siglip_apply(tower, torch.from_numpy(pixels), select_layer=-5)


@pytest.mark.parametrize("grid", [3, 4, 5, 6])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_downsample_tokens_bitwise(grid, k):
    tokens = np.random.default_rng(grid * 10 + k).standard_normal((2, grid * grid, 5)).astype(np.float32)
    want = np.asarray(j_downsample(jnp.asarray(tokens), k))
    got = downsample_tokens(torch.from_numpy(tokens), k).numpy()
    assert got.shape == want.shape == (2, (-(-grid // k)) ** 2, 5 * k * k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm", [True, False])
def test_projector_matches_jax(norm):
    k, c = (2, 8) if norm else (1, 8)
    params = _projector(np.random.default_rng(4), c * k * k, 16, norm)
    proj = NvilaProjector(c, 16, k, norm=norm)
    proj.load_state_dict(nvila_projector_state_dict(params), strict=True)
    assert sorted({n.split(".")[1] for n in proj.state_dict()}) == (["1", "2", "4"] if norm else ["0", "2"])
    tokens = np.random.default_rng(5).standard_normal((2, 36, c)).astype(np.float32)
    with torch.no_grad():
        got = proj(torch.from_numpy(tokens)).numpy()
    close(got, np.asarray(j_projector(params, jnp.asarray(tokens), k)))


@pytest.mark.parametrize("template", [None, "{prompt}\n<image>\nAnswer yes or no."])
def test_first_token_logits_match_jax(template):
    """Prompts of unequal lengths: with the chatml template the post-text is
    right-padded; with the prompt before the media token the pre-text is
    left-padded and the positions shift back by each row's pad count."""
    jm = jax_nvila()
    if template:
        jm.template = template
    pm = nvila_from_jax(jm)
    imgs = images(3) + images(1, seed=4, px=40)  # 40 px: resized to 24
    prompts = ["a red cube", "two dogs on a beach at sunset", "x", "a cat"]
    pre, post = zip(*(map(len, pm._encode(pm.template.format(prompt=p))) for p in prompts))
    assert len(set(pre if template else post)) > 1
    want = jm.first_token_logits(imgs[:3], prompts[:3])
    got = pm.first_token_logits(imgs[:3], prompts[:3])
    assert got.shape == (3, 150001) and got.dtype == np.float32
    close(got, want)
    # a resized image: the port's bicubic gives PIL's pixels, so the logits hold the same bound
    close(pm.first_token_logits(imgs[3:], prompts[3:]), jm.first_token_logits(imgs[3:], prompts[3:]))


def _write_bundle(root, seed=7, proj_type="mlp_downsample", tower_prefix=True, image_size=24):
    """A tiny VILA bundle written by transformers (llm/ with a byte-level Qwen2
    tokenizer, vision_tower/) and safetensors (mm_projector/)."""
    from safetensors.numpy import save_file
    from transformers import Qwen2Config, Qwen2ForCausalLM, Qwen2TokenizerFast, SiglipVisionModel
    from transformers import SiglipVisionConfig as HFSiglipConfig

    from reflectionflow_tpu_torch.utils.bpe import bytes_to_unicode

    torch.manual_seed(seed)
    lc = lm_cfg()
    lm = Qwen2ForCausalLM(Qwen2Config(vocab_size=lc.vocab_size, hidden_size=lc.hidden_size,
                                      intermediate_size=lc.intermediate_size, num_hidden_layers=lc.num_layers,
                                      num_attention_heads=lc.num_heads, num_key_value_heads=lc.num_kv_heads,
                                      rope_theta=lc.rope_theta, tie_word_embeddings=True))
    vc = dataclasses.replace(jconfig.SiglipVisionConfig.tiny(), image_size=image_size)
    tower = SiglipVisionModel(HFSiglipConfig(hidden_size=vc.hidden_size, intermediate_size=vc.intermediate_size,
                                             num_hidden_layers=vc.num_layers, num_attention_heads=vc.num_heads,
                                             patch_size=vc.patch_size, image_size=vc.image_size))
    for sub in ("llm", "vision_tower", "mm_projector"):
        os.makedirs(os.path.join(root, sub))
    lm.save_pretrained(os.path.join(root, "llm"), safe_serialization=True)
    vocab = {c: i for i, c in enumerate(bytes_to_unicode().values())}
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = Qwen2TokenizerFast(vocab_file=os.path.join(root, "vocab.json"), merges_file=os.path.join(root, "merges.txt"))
    tok.add_special_tokens({"additional_special_tokens": ["<|im_start|>", "<|im_end|>"]})
    tok.save_pretrained(os.path.join(root, "llm"))
    if tower_prefix:
        tower.save_pretrained(os.path.join(root, "vision_tower"), safe_serialization=True)
    else:  # a tower saved without the `vision_model.` prefix
        from safetensors.torch import save_file as save_torch

        sd = {k.removeprefix("vision_model."): v.contiguous() for k, v in tower.state_dict().items()}
        save_torch(sd, os.path.join(root, "vision_tower", "model.safetensors"))
        tower.config.to_json_file(os.path.join(root, "vision_tower", "config.json"))
    k = {"mlp": 1, "mlp_downsample": 2}[proj_type]
    rng = np.random.default_rng(seed)
    p = _projector(rng, vc.hidden_size * k * k, lc.hidden_size, norm=proj_type != "mlp")
    names = {"ln": "layers.1", "fc1": "layers.2", "fc2": "layers.4"} if "ln" in p else \
        {"fc1": "layers.0", "fc2": "layers.2"}
    sd = {}
    for ours, theirs in names.items():
        w = p[ours]["scale"] if ours == "ln" else p[ours]["w"].T
        sd[f"{theirs}.weight"] = np.ascontiguousarray(w)
        sd[f"{theirs}.bias"] = p[ours]["bias" if ours == "ln" else "b"]
    save_file(sd, os.path.join(root, "mm_projector", "model.safetensors"))
    with open(os.path.join(root, "mm_projector", "config.json"), "w") as f:
        json.dump({"mm_projector_type": {"mm_projector_type": proj_type}}, f)  # the nested form
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"mm_vision_select_layer": -2}, f)
    return root


@pytest.mark.parametrize("proj_type,tower_prefix", [("mlp_downsample", True), ("mlp", False)])
def test_load_nvila_bundle_matches_jax(tmp_path, proj_type, tower_prefix):
    from reflectionflow_tpu.utils.hf_loader import load_nvila as j_load_nvila

    root = _write_bundle(str(tmp_path / "bundle"), proj_type=proj_type, tower_prefix=tower_prefix)
    jm = j_load_nvila(root, dtype=jnp.float32)
    pm = load_nvila(root, dtype=torch.float32, device="cpu")
    assert (pm.cfg.select_layer, pm.cfg.downsample) == (jm.cfg.select_layer, jm.cfg.downsample)
    assert pm.llm.lm_head is None and pm.lm_cfg.mrope_section == (8, 0, 0)
    # every tensor is the JAX tree's, bit for bit
    want = nvila_from_jax(jm).state_dict()
    got = pm.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    text = pm.template.format(prompt="Does this image show a red cube? Answer yes or no.")
    for part in text.partition("<image>")[::2]:
        assert pm.tokenizer.encode(part) == jm.tokenizer.encode(part, add_special_tokens=False)
    imgs, prompts = images(2, seed=8), ["a red cube", "two dogs on a beach"]
    close(pm.first_token_logits(imgs, prompts), jm.first_token_logits(imgs, prompts))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load_nvila(root)


def test_load_nvila_refuses_what_it_cannot_load(tmp_path):
    root = _write_bundle(str(tmp_path / "b"))
    with open(os.path.join(root, "mm_projector", "config.json"), "w") as f:
        json.dump({"mm_projector_type": "linear_fancy"}, f)
    with pytest.raises(ValueError, match="unsupported mm_projector type"):
        load_nvila(root, device="cpu")
    with open(os.path.join(root, "mm_projector", "config.json"), "w") as f:
        json.dump({"mm_projector_type": "mlp"}, f)  # the files hold the downsample layout
    with pytest.raises(KeyError, match="no parameter for"):
        load_nvila(root, device="cpu")


def test_nvila_jax_verifier_matches_jax():
    jm = jax_nvila(seed=2)
    pv = load_verifier("nvila_jax", model=nvila_from_jax(jm))
    jv = JNvilaVerifier(model=jm)
    assert pv.output_kind == "yes_no" and (pv.yes_id, pv.no_id) == (jv.yes_id, jv.no_id)
    imgs, prompts = images(3, seed=9), ["a", "a red cube on a table", "two dogs"]
    got, want = pv.score(imgs, prompts), jv.score(imgs, prompts)
    assert [g["label"] for g in got] == [w["label"] for w in want]
    close([g["score"] for g in got], [w["score"] for w in want])


def test_nvila_jax_int8_matches_jax_int8():
    """quantize="int8" against JAX's int8 recipe (`utils.device.quantize_blocks`
    on the tower's and the LM's blocks, what its `nvila_jax` applies at load) on
    the same fp32 model. At min size 4097 the LM's q/o and MLP linears and the
    tower's MLP go W8A8, and the LM's k/v (2 x 64 x 32 stacked) and the
    tower's attention (3 x 32 x 32) stay float, in both packages; each linear
    is held bit for bit (which are quantized, w_q, w_scale). The logits are
    held at 1e-4 of max |ref| (measured: 4.8e-7; no activation on these
    inputs rounds the other way, which moves the Qwen verifier's int8 scores
    1.6e-2), and within 0.1 of max |ref| of the fp32 logits (measured 3.0e-2)."""
    jm = jax_nvila(seed=5)
    pm = nvila_from_jax(jm)
    jq = JNvila(vis_params=j_quantize_blocks(jm.vis_params, 4097), proj_params=jm.proj_params,
                lm_params=j_quantize_blocks(jm.lm_params, 4097), vis_cfg=jm.vis_cfg, lm_cfg=jm.lm_cfg,
                cfg=jm.cfg, tokenizer=jm.tokenizer)
    pv = NvilaJaxVerifier(model=pm, quantize="int8", quantize_min_size=4097)
    quantized = set()
    for family, jblocks, pblocks, names in (
            ("lm", jq.lm_params["blocks"], pm.llm.model.layers,
             {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.o_proj",
              "gate": "mlp.gate_proj", "up": "mlp.up_proj", "down": "mlp.down_proj"}),
            ("tower", jq.vis_params["blocks"], pm.vision_tower.vision_model.encoder.layers,
             {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj", "o": "self_attn.out_proj",
              "fc1": "mlp.fc1", "fc2": "mlp.fc2"})):
        for i, pb in enumerate(pblocks):
            for jn, pn in names.items():
                jp, lin = {k: v[i] for k, v in jblocks[jn].items()}, pb.get_submodule(pn)
                assert isinstance(lin, QuantLinear) == ("w_q" in jp), (jn, pn)
                if "w_q" in jp:
                    quantized.add((family, jn))
                    np.testing.assert_array_equal(lin.w_q.numpy(), np.asarray(jp["w_q"]).T)
                    np.testing.assert_array_equal(lin.w_scale.numpy(), np.asarray(jp["w_scale"]).reshape(-1))
    assert quantized == {("lm", n) for n in ("q", "o", "gate", "up", "down")} | {("tower", "fc1"), ("tower", "fc2")}
    imgs, prompts = images(2, seed=11), ["a red cube", "a dog"]
    want = jq.first_token_logits(imgs, prompts)
    got = pv.model.first_token_logits(imgs, prompts)
    assert np.isfinite(got).all()
    close(got, want)
    fp32 = jm.first_token_logits(imgs, prompts)
    assert np.abs(got - fp32).max() <= 0.1 * np.abs(fp32).max()


def _hub_layout(cache, model_name, bundle, rev="0123abcd"):
    repo = os.path.join(cache, "models--" + model_name.replace("/", "--"))
    os.makedirs(os.path.join(repo, "snapshots"))
    os.makedirs(os.path.join(repo, "refs"))
    os.rename(bundle, os.path.join(repo, "snapshots", rev))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev)
    return os.path.join(repo, "snapshots", rev)


def test_nvila_resolves_the_hub_cache_and_never_fetches(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="never downloads"):
        load_verifier("nvila", device="cpu")
    with pytest.raises(ValueError, match="model_path"):
        load_verifier("nvila_jax", device="cpu")
    snap = _hub_layout(str(tmp_path / "hub"), "org/tiny-nvila", _write_bundle(str(tmp_path / "b"), seed=3))
    v = load_verifier("nvila", model_name="org/tiny-nvila", cache_dir=str(tmp_path / "hub"), device="cpu")
    assert isinstance(v, NvilaVerifier) and v.name == "nvila" and v.output_kind == "yes_no"
    assert isinstance(load_verifier("nvila", model_name=snap, device="cpu"), NvilaVerifier)  # a directory as it is
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert isinstance(load_verifier("nvila", model_name="org/tiny-nvila", device="cpu"), NvilaVerifier)
    # the reference's label: "yes" only when the greedy first token is "yes"
    imgs, prompts = images(3, seed=12), ["p1", "p2", "a longer prompt"]
    logits = v.model.first_token_logits(imgs, prompts)
    out = v.score(imgs, prompts)
    for row, o in zip(logits, out):
        yes = int(np.argmax(row)) == v.yes_id
        assert o == {"label": "yes" if yes else "no", "score": float(row[v.yes_id if yes else v.no_id])}


def test_ranking_rule_orders_nvila_outputs():
    jm = jax_nvila(seed=6)
    v = NvilaJaxVerifier(model=nvila_from_jax(jm))
    imgs = images(4, seed=13)
    out = v.score(imgs, ["a", "b", "c", "d"])
    # force both labels into the list: the rule ranks yes (logit desc) before no (logit asc)
    out = out + [{"label": "yes", "score": 9.0}, {"label": "no", "score": -3.0}, {"label": "no", "score": 5.0}]
    order = select_topk(out, len(out), RankingRule(kind=v.output_kind))
    yes = sorted((i for i, o in enumerate(out) if o["label"] == "yes"), key=lambda i: -out[i]["score"])
    no = sorted((i for i, o in enumerate(out) if o["label"] == "no"), key=lambda i: out[i]["score"])
    assert order == yes + no
    from reflectionflow_tpu.verifiers.base import RankingRule as JRule
    from reflectionflow_tpu.verifiers.base import select_topk as j_select

    assert order == j_select(out, len(out), JRule(kind="yes_no"))
