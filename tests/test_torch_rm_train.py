"""The port's reward-model trainer (`reflectionflow_tpu_torch/rm_train/`)
against the JAX package's (`reflectionflow_tpu/rm_train/`), fp32 on the CPU:
the losses (every loss_type, rtol 1e-5), accuracy and GSB labels (exact),
`rm_forward_rewards` (rtol 1e-4), the gradient of every trainable group
through a float, int8 and NF4 base with the vision adapters in the step
(within 1e-4 of each group's max |g|), two optimizer steps, the quantized
base's layers (bitwise JAX's tree, weight-only), the checkpoint read by the
other package's `load_rm_checkpoint` and `QwenRewardVerifier` both ways,
the optimizer state, and the JAX tests' own checks (`tests/test_rm_train.py`)
on the port. The gradient and step tests use a small Qwen (width 256, 2
layers, 2 vision blocks, vocab 512) whose linears all pack NF4 in the plane
layout (contractions of 256 and 512); the tiny config's fall back to int8.
Weights and trainables come from JAX (numpy seeds) through
`utils/jax_bridge.py`. About 70 s on one core."""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from reflectionflow_tpu.config import QwenLMConfig as JLMConfig
from reflectionflow_tpu.config import QwenVLVisionConfig as JVisConfig
from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
from reflectionflow_tpu.models.qwen_vl.model import get_rope_index
from reflectionflow_tpu.rm_train import losses as jlosses
from reflectionflow_tpu.rm_train import train as jtrain
from reflectionflow_tpu.verifiers.qwen_verifier import QwenRewardVerifier as JVerifier
from reflectionflow_tpu_torch.config import QwenLMConfig, QwenVLVisionConfig
from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel
from reflectionflow_tpu_torch.ops.quant import NF4Linear, QuantLinear
from reflectionflow_tpu_torch.rm_train import losses as plosses
from reflectionflow_tpu_torch.rm_train import train as ptrain
from reflectionflow_tpu_torch.train.optim import flatten_tree
from reflectionflow_tpu_torch.utils import threefry
from reflectionflow_tpu_torch.utils.jax_bridge import (qwen_lm_state_dict, qwen_vision_state_dict,
                                                       rm_trainable_from_jax, rm_trainable_to_jax)
from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

from test_torch_qwen_vl import bridge

torch.set_num_threads(1)
LOSS_TYPES = ["bt", "margin", "constant_margin", "scaled", "reg", "btt"]
LM = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
          head_dim=64, mrope_section=(8, 12, 12))
VIS = dict(depth=2, hidden_size=256, intermediate_size=512, num_heads=4, patch_size=4, temporal_patch_size=2,
           spatial_merge_size=2, window_size=16, fullatt_block_indexes=(1,), out_hidden_size=256)
R, ALPHA = 4, 8.0
SP, IMG_ID, PAD_ID = 511, 500, 0  # special token, the image rows' id, the pad id (all in the small vocab)
GRID = (1, 8, 8)  # 64 patches, 16 merged image rows
N_IMG = 16
GRAD_REL = 1e-4


def qwen_trees(lm_cfg, vis_cfg, seed=0):
    """`qwen_lm_init` / `qwen_vision_init`'s trees (linears N(0, 1/fan_in),
    zero biases, unit norms, embeddings N(0, 0.02^2)) drawn with numpy, which
    spares the JAX initialisers' compile; fp32 JAX arrays."""
    rng = np.random.default_rng(seed)

    def lin(n, d_in, d_out, bias=True):
        p = {"w": (rng.standard_normal((n, d_in, d_out)) * d_in ** -0.5).astype(np.float32)}
        if bias:
            p["b"] = np.zeros((n, d_out), np.float32)
        return p

    def ones(*shape):
        return {"scale": np.ones(shape, np.float32)}

    N, H, I = lm_cfg.num_layers, lm_cfg.hidden_size, lm_cfg.intermediate_size
    q, kv = lm_cfg.num_heads * lm_cfg.head_dim, lm_cfg.num_kv_heads * lm_cfg.head_dim
    lm = {"embed": (rng.standard_normal((lm_cfg.vocab_size, H)) * 0.02).astype(np.float32),
          "blocks": {"ln1": ones(N, H), "q": lin(N, H, q), "k": lin(N, H, kv), "v": lin(N, H, kv),
                     "o": lin(N, q, H, False), "ln2": ones(N, H), "gate": lin(N, H, I, False),
                     "up": lin(N, H, I, False), "down": lin(N, I, H, False)},
          "final_ln": ones(H)}
    if not lm_cfg.tie_word_embeddings:
        lm["lm_head"] = {k: v[0] for k, v in lin(1, H, lm_cfg.vocab_size, False).items()}
    V, C, VI = vis_cfg.depth, vis_cfg.hidden_size, vis_cfg.intermediate_size
    merged = C * vis_cfg.spatial_merge_size ** 2
    pd = 3 * vis_cfg.temporal_patch_size * vis_cfg.patch_size ** 2
    one = lambda d_in, d_out: {k: v[0] for k, v in lin(1, d_in, d_out).items()}  # noqa: E731
    vis = {"patch_embed": {"w": one(pd, C)["w"]},
           "blocks": {"ln1": ones(V, C), "qkv": lin(V, C, 3 * C), "proj": lin(V, C, C), "ln2": ones(V, C),
                      "gate": lin(V, C, VI), "up": lin(V, C, VI), "down": lin(V, VI, C)},
           "merger": {"ln_q": ones(C), "fc1": one(merged, merged), "fc2": one(merged, vis_cfg.out_hidden_size)}}
    return jax.tree.map(jnp.asarray, lm), jax.tree.map(jnp.asarray, vis)


def _jcfgs():
    return JLMConfig(**LM), JVisConfig(**VIS)


@pytest.fixture(scope="module")
def small():
    """The small Qwen's JAX trees (numpy) and configs."""
    jlm_cfg, jvis_cfg = _jcfgs()
    jlm, jvis = jax.tree.map(np.asarray, qwen_trees(jlm_cfg, jvis_cfg))
    return jlm, jvis, jlm_cfg, jvis_cfg


def tiny_jax_model(seed=0) -> JModel:
    """A JAX `QwenVLModel` at the tiny configs on `qwen_trees` weights."""
    lm_cfg, vis_cfg = JLMConfig.tiny(), JVisConfig.tiny()
    return JModel(*qwen_trees(lm_cfg, vis_cfg, seed), lm_cfg, vis_cfg, dtype=jnp.float32)


@pytest.fixture(scope="module")
def tiny_jm():
    return tiny_jax_model()


def _own_copy(jm):
    """A copy of the JAX model whose parameter dicts a verifier may replace."""
    out = copy.copy(jm)
    out.lm_params, out.vision_params = dict(jm.lm_params), dict(jm.vision_params)
    return out


def _port_model(small) -> QwenVLModel:
    """A fresh port model on the small Qwen's weights (the quantizing tests change it in place)."""
    jlm, jvis, _, _ = small
    lm_cfg, vis_cfg = QwenLMConfig(**LM), QwenVLVisionConfig(**VIS)
    pm = QwenVLModel(lm_cfg, vis_cfg)
    pm.load_state_dict({**qwen_lm_state_dict(jlm, lm_cfg), **qwen_vision_state_dict(jvis, vis_cfg)}, strict=True)
    return pm.eval().requires_grad_(False)


def _side(embed, seed):
    """One side of B=2 pairs: [501, image rows, 502, text, special], row 1
    two tokens shorter and right-padded; (B, L, H) embeds, M-RoPE positions
    over the image grid, raw patches."""
    rng = np.random.default_rng(seed)
    n_txt = 6
    L = 1 + N_IMG + 1 + n_txt + 1
    ids = np.full((2, L), PAD_ID, np.int64)
    mask = np.zeros((2, L), np.int32)
    pos = np.zeros((3, 2, L), np.int64)
    for b, n_t in enumerate((n_txt, n_txt - 2)):
        row = [501] + [IMG_ID] * N_IMG + [502] + list(rng.integers(2, 400, n_t)) + [SP]
        ids[b, : len(row)] = row
        mask[b, : len(row)] = 1
        pos[:, b, : len(row)] = get_rope_index(np.asarray(row), [GRID], 2, IMG_ID)
    embeds = (embed[ids] * mask[:, :, None]).astype(np.float32)
    patches = rng.normal(size=(2, 64, 96)).astype(np.float32)
    return {"embeds": embeds, "ids": ids, "mask": mask, "pos": pos, "patches": patches}


def _batch(embed, seed=0, labels=((1,), (-1,))):
    rng = np.random.default_rng(seed + 100)
    batch = {}
    for s, sd in (("A", seed), ("B", seed + 1)):
        for k, v in _side(embed, sd).items():
            batch[f"{k}_{s}"] = v
    batch["scores_A"] = rng.uniform(1, 5, (2, 1)).astype(np.float32)
    batch["scores_B"] = rng.uniform(1, 5, (2, 1)).astype(np.float32)
    batch["chosen_label"] = np.asarray(labels, np.int32)
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_port(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_trainable(jlm, jvis, seed=0, vision=True):
    """A trainable with non-zero B factors, so every adapter tensor has a gradient."""
    rng = np.random.default_rng(seed)

    def adapters(tree, init):
        lora = init(jax.random.PRNGKey(seed), tree, r=R, alpha=ALPHA)["adapters"]
        return {p: {"A": np.asarray(ab["A"]), "B": rng.normal(0, 0.05, np.shape(ab["B"])).astype(np.float32)}
                for p, ab in lora.items()}

    H = LM["hidden_size"]
    t = {"lora": adapters(jlm, jtrain.rm_lora_init),
         "rm_head": rng.normal(0, 0.1, (H, 1)).astype(np.float32),
         "special": rng.normal(0, 0.02, (H,)).astype(np.float32)}
    if vision:
        t["vision_lora"] = adapters(jvis, jtrain.rm_vision_lora_init)
    return t


def _jax_loss(trainable, batch, lm, vis, lm_cfg, vis_cfg, loss_type, vision):
    def side(s):
        emb = batch[f"embeds_{s}"]
        if vision:
            emb = jtrain.apply_vision_lora_embeds(trainable, vis, vis_cfg, emb, batch[f"patches_{s}"], GRID,
                                                  ALPHA, R)
        return jtrain.rm_forward_rewards(trainable, lm, lm_cfg, emb, batch[f"pos_{s}"], batch[f"mask_{s}"],
                                         batch[f"ids_{s}"], "special", SP, ALPHA, R)

    rA, rB = side("A"), side("B")
    loss = jlosses.reward_loss(rA, rB, batch["scores_A"], batch["scores_B"], batch["chosen_label"], loss_type)
    return loss, (rA, rB)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    """jit(value_and_grad) of the btt loss with the vision adapters: one
    compile per base layout, shared by the gradient and the two-step tests."""
    lm_cfg, vis_cfg = _jcfgs()
    return jax.jit(jax.value_and_grad(functools.partial(_jax_loss, lm_cfg=lm_cfg, vis_cfg=vis_cfg, loss_type="btt",
                                                        vision=True), has_aux=True))


def _port_loss(trainable, batch, model, loss_type, vision):
    def side(s):
        emb = batch[f"embeds_{s}"]
        if vision:
            emb = ptrain.apply_vision_lora_embeds(trainable, model.visual, emb, batch[f"patches_{s}"], GRID,
                                                  ALPHA, R)
        return ptrain.rm_forward_rewards(trainable, model.model, emb, batch[f"pos_{s}"], batch[f"mask_{s}"],
                                         batch[f"ids_{s}"], "special", SP, ALPHA, R)

    rA, rB = side("A"), side("B")
    return plosses.reward_loss(rA, rB, batch["scores_A"], batch["scores_B"], batch["chosen_label"], loss_type), (rA, rB)


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rel, err


# ---------------------------------------------------------------- losses


def test_convert_chosen_rejected():
    rA, rB, label = [[1.0], [5.0], [2.0]], [[3.0], [4.0], [6.0]], [[1], [-1], [22]]
    want = jlosses.convert_A_B_to_chosen_rejected(*(jnp.asarray(x) for x in (rA, rB, rA, rB, label)))
    got = plosses.convert_A_B_to_chosen_rejected(*(torch.tensor(x) for x in (rA, rB, rA, rB, label)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][:, 0].numpy(), [1.0, 4.0, 6.0])
    np.testing.assert_array_equal(got[4][:, 0].numpy(), [1, 1, 0])


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_losses_match_jax(loss_type):
    """Each loss and its gradient in fp32 against JAX's (rtol 1e-5), over
    chosen, rejected, tied and invalid pairs and two dimensions; the JAX
    test's ordering check for bt."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=(6, 2)).astype(np.float32) for _ in range(2)]
    arrs += [rng.uniform(1, 5, (6, 2)).astype(np.float32) for _ in range(2)]
    arrs[3][0, 0] = 0.0  # a missing score (reg masks it)
    label = np.asarray([[1, -1], [-1, 0], [0, 1], [1, 22], [22, -1], [1, 1]], np.int32)
    jfn = functools.partial(jlosses.reward_loss, loss_type=loss_type)
    want, jgrads = jax.value_and_grad(jfn, argnums=(0, 1))(*(jnp.asarray(a) for a in arrs), jnp.asarray(label))
    ts = [torch.tensor(a, requires_grad=i < 2) for i, a in enumerate(arrs)]
    got = plosses.reward_loss(*ts, torch.from_numpy(label), loss_type)
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, g in zip(ts[:2], jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)
    if loss_type == "bt":
        ones = torch.ones((2, 1), dtype=torch.int32)
        good = plosses.reward_loss(torch.full((2, 1), 5.0), torch.zeros((2, 1)), ts[2][:2, :1], ts[3][:2, :1], ones)
        bad = plosses.reward_loss(torch.zeros((2, 1)), torch.full((2, 1), 5.0), ts[2][:2, :1], ts[3][:2, :1], ones)
        assert float(good) < float(bad)


def test_unknown_loss_type_raises():
    x = torch.zeros((1, 1))
    with pytest.raises(NotImplementedError):
        plosses.reward_loss(x, x, x, x, torch.ones((1, 1), dtype=torch.int32), "hinge")


def test_pairwise_accuracy_and_gsb_labels():
    rng = np.random.default_rng(3)
    rA, rB = rng.normal(size=(9, 2)).astype(np.float32), rng.normal(size=(9, 2)).astype(np.float32)
    label = rng.choice([1, -1, 0, 22], size=(9, 2)).astype(np.int32)
    label[:, 1] = 0  # a dimension with no untied pair: 0 / max(0, 1)
    want = np.asarray(jlosses.pairwise_accuracy(jnp.asarray(rA), jnp.asarray(rB), jnp.asarray(label)))
    got = plosses.pairwise_accuracy(torch.from_numpy(rA), torch.from_numpy(rB), torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(got, want)
    # the JAX test's case: the tied third pair is excluded
    acc = plosses.pairwise_accuracy(torch.tensor([[2.0], [1.0], [9.0]]), torch.tensor([[1.0], [2.0], [0.0]]),
                                    torch.tensor([[1], [1], [0]]))
    assert float(acc[0]) == 0.5
    for gsb in ("G", "A", "good", "B", "bad", "S", "same", "x", "", "g"):
        assert plosses.convert_gsb_labels(gsb) == jlosses.convert_gsb_labels(gsb)


# ---------------------------------------------------------------- the forward and its gradients


@pytest.mark.parametrize("pooling", ["special", "last", "mean"])
def test_rm_forward_rewards_match_jax(small, pooling):
    jlm, jvis, jlm_cfg, jvis_cfg = small
    pm = _port_model(small)
    jt = _jax_trainable(jlm, jvis, seed=1, vision=False)
    side = _side(jlm["embed"], 7)
    want = jtrain.rm_forward_rewards(jt, jlm, jlm_cfg, *(jnp.asarray(side[k]) for k in ("embeds", "pos", "mask", "ids")),
                                     pooling, SP, ALPHA, R)
    pt = rm_trainable_from_jax(jt)
    with torch.no_grad():
        got = ptrain.rm_forward_rewards(pt, pm.model, *(torch.from_numpy(side[k]) for k in ("embeds", "pos", "mask", "ids")),
                                        pooling, SP, ALPHA, R)
    _close(got.numpy(), np.asarray(want), 1e-4)


def test_apply_vision_lora_embeds_matches_jax(small):
    jlm, jvis, _, jvis_cfg = small
    pm = _port_model(small)
    jt = _jax_trainable(jlm, jvis, seed=2)
    side = _side(jlm["embed"], 3)
    fn = jax.jit(lambda t, v, e, p: jtrain.apply_vision_lora_embeds(t, v, jvis_cfg, e, p, GRID, ALPHA, R))
    want = fn(jt, jvis, jnp.asarray(side["embeds"]), jnp.asarray(side["patches"]))
    with torch.no_grad():
        got = ptrain.apply_vision_lora_embeds(rm_trainable_from_jax(jt), pm.visual, torch.from_numpy(side["embeds"]),
                                              torch.from_numpy(side["patches"]), GRID, ALPHA, R)
    _close(got.numpy(), np.asarray(want), 1e-4)
    np.testing.assert_array_equal(got[:, N_IMG + 1:].numpy(), side["embeds"][:, N_IMG + 1:])  # the token rows kept


def _grad_tree(trainable, grads: dict) -> dict:
    """{flat path: grad} -> the trainable's nested layout."""
    out = {}
    for path, g in grads.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = g
    return out


@pytest.mark.parametrize("base", ["int8", "nf4"])
def test_gradients_match_jax(small, base):
    """One loss (btt, vision adapters in the step) and the gradient of every
    trainable group: JAX by jax.grad over `quantize_rm_base`'s tree, the port
    by autograd over `quantize_rm_base`'s modules; each group within 1e-4 of
    its max |g|. Every group's gradient is non-zero: it crosses the
    quantized blocks. (The float base's forward is
    `test_rm_forward_rewards_match_jax`; its training, the tests below.)"""
    jlm, jvis, jlm_cfg, jvis_cfg = small
    pm = _port_model(small)
    qlm, qvis = jtrain.quantize_rm_base(jlm, base, 16), jtrain.quantize_rm_base(jvis, base, 16)
    ptrain.quantize_rm_base(pm.model, base, 16)
    ptrain.quantize_rm_base(pm.visual, base, 16)
    jt = _jax_trainable(jlm, jvis, seed=4)
    batch = _batch(jlm["embed"], seed=5)
    (want, _), jgrads = _jax_value_and_grad()(jt, _to_jax(batch), qlm, qvis)

    pt = rm_trainable_from_jax(jt)
    flat = flatten_tree(pt)
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = _port_loss(pt, _to_port(batch), pm, "btt", True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)  # the rewards' tolerance
    got = rm_trainable_to_jax(_grad_tree(pt, dict(zip(flat, grads))))
    jgrads = jax.tree.map(np.asarray, jgrads)
    for group in ("lora", "vision_lora", "rm_head", "special"):
        g, w = np.concatenate([x.ravel() for x in jax.tree.leaves(got[group])]), \
            np.concatenate([x.ravel() for x in jax.tree.leaves(jgrads[group])])
        assert np.abs(w).max() > 0, group
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), (group, np.abs(g - w).max(), np.abs(w).max())


def test_two_optimizer_steps_match_jax(small):
    """The port's `make_rm_train_step` and `make_rm_optimizer` (five groups at
    five learning rates, weight decay) on an int8 base, two steps from the same
    state, against what JAX's `make_rm_train_step` jits: the loss's jax.grad,
    `make_rm_optimizer`'s update, `optax.apply_updates`. Adam's first steps
    move each value by about lr in the sign of its gradient, so a value whose
    gradient is within rounding of 0 may move the other way: each value within
    2 lr x steps of JAX's, and 99.9% of them within 1e-3 lr."""
    import optax

    jlm, jvis, jlm_cfg, jvis_cfg = small
    lrs = dict(lr=1e-3, head_lr=2e-3, special_lr=3e-3, vision_lr=5e-4, merger_lr=4e-3)
    jt = _jax_trainable(jlm, jvis, seed=6)
    batch = _batch(jlm["embed"], seed=8)
    jopt = jtrain.make_rm_optimizer(**lrs, weight_decay=1e-2)
    qlm, qvis = jtrain.quantize_rm_base(jlm, "int8", 16), jtrain.quantize_rm_base(jvis, "int8", 16)

    def jstep(trainable, state, batch):
        (loss, (rA, _)), grads = _jax_value_and_grad()(trainable, batch, qlm, qvis)
        updates, state = jopt.update(grads, state, trainable)
        return optax.apply_updates(trainable, updates), state, {"loss": loss, "rewards_A": rA}

    pm = _port_model(small)
    popt = ptrain.make_rm_optimizer(**lrs, weight_decay=1e-2)
    pstep = ptrain.make_rm_train_step(pm.model, popt, loss_type="btt", pooling="special", special_token_id=SP,
                                      alpha=ALPHA, r=R, tower=pm.visual, grid_thw=GRID, quantize_base="int8",
                                      quantize_min_size=16)
    jtr, jstate = jax.tree.map(jnp.asarray, jt), jopt.init(jt)
    ptr = rm_trainable_from_jax(jt)
    pstate = popt.init(ptr)
    for _ in range(2):
        jtr, jstate, jaux = jstep(jtr, jstate, _to_jax(batch))
        ptr, pstate, paux = pstep(ptr, pstate, _to_port(batch))
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]), rtol=1e-4)
        _close(paux["rewards_A"].numpy(), np.asarray(jaux["rewards_A"]), 1e-3)
    got, want = rm_trainable_to_jax(ptr), jax.tree.map(np.asarray, jtr)
    for group, lr in (("lora", 1e-3), ("rm_head", 2e-3), ("special", 3e-3), ("vision_lora", 4e-3)):
        g = np.concatenate([x.ravel() for x in jax.tree.leaves(got[group])])
        w = np.concatenate([x.ravel() for x in jax.tree.leaves(want[group])])
        d = np.abs(g - w)
        assert d.max() <= 2 * lr * 2, (group, d.max())
        assert np.quantile(d, 0.999) <= 1e-3 * lr, (group, np.quantile(d, 0.999))
    before = rm_trainable_to_jax(rm_trainable_from_jax(jt))
    for p, ab in got["vision_lora"].items():  # merger adapters moved at merger_lr, the blocks' at vision_lr
        step = np.abs(ab["A"] - before["vision_lora"][p]["A"]).max()
        assert step <= 2 * (4e-3 if p.startswith("merger/") else 5e-4) * 1.01, (p, step)


# ---------------------------------------------------------------- the quantized base


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantize_rm_base_matches_jax_tree(small, mode, tiny_jm):
    """Every block linear of the LM and the tower is swapped, weight-only
    (no QuantLinear quantizes its activation), holding what JAX's
    `quantize_rm_base` tree holds (NF4: the plane packing, codes and scales
    bitwise); embeddings, norms, the patch embedding and the merger stay
    float. Tiny widths fall down the packing chain to int8 w8a16, as in JAX;
    `min_size` counts the weight stacked over the blocks; another mode raises."""
    jlm, jvis, _, _ = small
    pm = _port_model(small)
    for module, tree, blocks in ((pm.model, jlm, "layers"), (pm.visual, jvis, "blocks")):
        ptrain.quantize_rm_base(module, mode, 16)
        jq = jax.tree.map(np.asarray, jtrain.quantize_rm_base(tree, mode, 16)["blocks"])
        for i, block in enumerate(getattr(module, blocks)):
            for name, m in block.named_modules():
                assert not isinstance(m, nn.Linear), f"{blocks}.{i}.{name} left float"
                if not isinstance(m, (QuantLinear, NF4Linear)):
                    continue
                short = name.split(".")[-1].removesuffix("_proj")
                node = {k: v[i] for k, v in jq[short].items()}
                if mode == "int8":
                    assert isinstance(m, QuantLinear) and not m.act_quant
                    np.testing.assert_array_equal(m.w_q.numpy().T, node["w_q"])
                    np.testing.assert_allclose(m.w_scale.numpy(), node["w_scale"].reshape(-1), rtol=1e-6)
                else:
                    assert isinstance(m, NF4Linear) and m.layout == "plane"
                    np.testing.assert_array_equal(m.w_packed.numpy(), node["w_p4p"])
                    np.testing.assert_array_equal(m.w_scale4.numpy(), node["w_scale4"])
    assert all(isinstance(m, nn.Linear) for m in pm.visual.merger.mlp if not isinstance(m, nn.GELU))
    assert isinstance(pm.model.embed_tokens, nn.Embedding)

    tiny = bridge(tiny_jm)
    ptrain.quantize_rm_base(tiny.model, mode, 16)
    kinds = {type(m) for m in tiny.model.layers.modules() if isinstance(m, (nn.Linear, QuantLinear, NF4Linear))}
    assert kinds == {QuantLinear}, kinds  # contractions of 32 and 64: no NF4 group fits
    assert not any(m.act_quant for m in tiny.model.layers.modules() if isinstance(m, QuantLinear))

    # min_size over the stacked blocks: a (64 x 32) k_proj x 2 layers = 4096 elements
    edge = _port_model(small)
    ptrain.quantize_rm_base(edge.model, mode, 256 * 128 * 2 + 1)
    assert isinstance(edge.model.layers[0].self_attn.k_proj, nn.Linear)  # 256 x 128 x 2 < min_size
    assert not isinstance(edge.model.layers[0].self_attn.q_proj, nn.Linear)
    with pytest.raises(ValueError):
        ptrain.quantize_rm_base(edge.model, "fp8")
    with pytest.raises(ValueError):
        ptrain.make_rm_train_step(edge.model, ptrain.make_rm_optimizer(), quantize_base="fp8")


def test_mesh_raises_naming_slice_7b(small, tmp_path):
    """`make_rm_train_step(mesh=)` trains (it raised before the training
    slice): two gloo ranks, the NF4 base sharded FSDP over "data" (every
    packed code and scale gathered on use), one pair a rank, against the
    same step unsharded on one rank: every trainable within 1e-4 of its max
    |value|, bitwise equal on both ranks, the loss rtol 1e-5, the global
    batch's rewards, and each rank holding about half of the base."""
    from reflectionflow_tpu_torch.parallel import distributed
    from reflectionflow_tpu_torch.parallel.dryrun import file_init

    import torch_mesh_train_ranks

    jlm, jvis, _, _ = small
    lm_cfg, vis_cfg = QwenLMConfig(**LM), QwenVLVisionConfig(**VIS)
    pt = rm_trainable_from_jax(_jax_trainable(jlm, jvis, seed=5))
    case = {"lm_cfg": LM, "vis_cfg": VIS,
            "qwen": {k: v.numpy() for k, v in {**qwen_lm_state_dict(jlm, lm_cfg),
                                                 **qwen_vision_state_dict(jvis, vis_cfg)}.items()},
            "trainable": {k: ({n: {kk: t.detach().numpy() for kk, t in ab.items()} for n, ab in v.items()}
                              if isinstance(v, dict) else v.detach().numpy()) for k, v in pt.items()},
            "batch": _batch(jlm["embed"], seed=6), "lr": 1e-2, "vision_lr": 1e-3, "sp": SP, "alpha": ALPHA,
            "r": R, "grid": GRID, "quantize_base": "nf4"}
    path = str(tmp_path / "case.pt")
    torch.save({"fsdp": case, "one": case, "checks": [("fsdp", "rm", True), ("one", "rm", False)]}, path)
    ranks = distributed.launch(torch_mesh_train_ranks.run_world, 2, args=(path,), device="cpu",
                               init_method=file_init(str(tmp_path)), timeout=300)
    want = ranks[0]["one"]
    for r in ranks:
        got = r["fsdp"]
        for k, v in got["trainable"].items():
            np.testing.assert_array_equal(v, ranks[0]["fsdp"]["trainable"][k])
            _close(v, want["trainable"][k], GRAD_REL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["rewards_A"], want["rewards_A"], rtol=1e-5)
        held, whole = got["bytes"]
        assert held < 0.55 * whole and got["counts"]["all_gather_dim"] > 0


# ---------------------------------------------------------------- the JAX tests' checks on the port


def _tiny_trainable(pm, vision=False, seed=1):
    gen = torch.Generator().manual_seed(seed)
    H = pm.lm_cfg.hidden_size
    t = {"lora": ptrain.rm_lora_init(threefry.prng_key(seed), pm.model, r=2, alpha=2)["adapters"],
         "rm_head": torch.randn((H, 1), generator=gen) * 0.1,
         "special": torch.randn((H,), generator=gen) * 0.02}
    if vision:
        t["vision_lora"] = ptrain.rm_vision_lora_init(threefry.fold_in(threefry.prng_key(seed), 3), pm.visual,
                                                      r=2, alpha=2)["adapters"]
    return t


def _snapshot(trainable):
    return {k: v.detach().clone() for k, v in flatten_tree(trainable).items()}


def test_rm_train_step_learns(tiny_jm):
    """JAX `test_rm_train_step_learns` on the port: A always chosen; the loss
    falls over 8 steps and A's rewards end above B's."""
    pm = bridge(tiny_jm)
    trainable = _tiny_trainable(pm)
    opt = ptrain.make_rm_optimizer(lr=1e-2, head_lr=5e-2)
    state = opt.init(trainable)
    step = ptrain.make_rm_train_step(pm.model, opt, loss_type="bt", pooling="special", special_token_id=9,
                                     r=2, alpha=2)
    B, L, H = 2, 6, pm.lm_cfg.hidden_size
    rng = np.random.default_rng(0)
    ids = np.full((B, L), 5, np.int64)
    ids[:, -1] = 9
    emb = pm.model.embed_tokens.weight.detach().numpy()[ids]
    batch = {"embeds_A": torch.from_numpy((emb + rng.normal(size=(B, L, H)) * 0.1).astype(np.float32)),
             "embeds_B": torch.from_numpy((emb - rng.normal(size=(B, L, H)) * 0.1).astype(np.float32)),
             **{f"pos_{s}": torch.arange(L).expand(3, B, L) for s in "AB"},
             **{f"mask_{s}": torch.ones((B, L), dtype=torch.int32) for s in "AB"},
             **{f"ids_{s}": torch.from_numpy(ids) for s in "AB"},
             "scores_A": torch.full((B, 1), 4.0), "scores_B": torch.full((B, 1), 2.0),
             "chosen_label": torch.ones((B, 1), dtype=torch.int32)}
    losses = []
    for _ in range(8):
        trainable, state, aux = step(trainable, state, batch)
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses
    assert float(aux["rewards_A"].mean()) > float(aux["rewards_B"].mean())


@pytest.fixture(scope="module")
def tiny_vision_batch(tiny_jm):
    """JAX `_tiny_vl_rows_and_batch` on the port: B=2 pairs of 16 px images
    collated in the vision-training layout (max_pixels 256: the 16 px grid)."""
    from reflectionflow_tpu_torch.rm_train.data import collate_rm_batch

    pm = bridge(tiny_jm)
    rng = np.random.default_rng(0)
    rows = [{"image_A": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8),
             "image_B": rng.integers(0, 255, (16, 16, 3), dtype=np.uint8),
             "prompt": f"p{i}", "gsb": "G", "score_A": 4.0, "score_B": 2.0} for i in range(2)]
    return collate_rm_batch(pm, rows, max_pixels=256, special_token_id=9, train_vision=True)


def test_rm_vision_lora_trains_tower_adapters(tiny_vision_batch, tiny_jm):
    """JAX `test_rm_vision_lora_trains_tower_adapters` on the port: the tower
    adapters move under vision_lr, the loss falls; vision_lr=0 freezes the
    vision group exactly while the LM adapters move."""
    from reflectionflow_tpu_torch.rm_train.data import vision_train_geometry

    batch = tiny_vision_batch
    assert batch["patches_A"].dim() == 3

    def build(vision_lr):
        pm = bridge(tiny_jm)
        grid = vision_train_geometry(pm.vis_cfg, 256)[1]
        trainable = _tiny_trainable(pm, vision=True)
        opt = ptrain.make_rm_optimizer(lr=1e-2, vision_lr=vision_lr)
        step = ptrain.make_rm_train_step(pm.model, opt, loss_type="bt", pooling="special", special_token_id=9,
                                         r=2, alpha=2, tower=pm.visual, grid_thw=grid)
        return trainable, opt.init(trainable), step

    trainable, state, step = build(1e-2)
    assert any(p.startswith("merger.") for p in trainable["vision_lora"])
    assert any(p.endswith("attn.qkv") for p in trainable["vision_lora"])
    before = _snapshot(trainable)
    losses = []
    for _ in range(4):
        trainable, state, aux = step(trainable, state, batch)
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], losses
    after = flatten_tree(trainable)
    assert max(float((after[k].detach() - v).abs().max()) for k, v in before.items() if k.startswith("vision_lora/")) > 0

    trainable, state, step = build(0.0)
    before = _snapshot(trainable)
    trainable, state, _ = step(trainable, state, batch)
    after = flatten_tree(trainable)
    for k, v in before.items():
        if k.startswith("vision_lora/"):
            torch.testing.assert_close(after[k], v, rtol=0, atol=0)
    assert max(float((after[k].detach() - v).abs().max()) for k, v in before.items() if k.startswith("lora/")) > 0


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_rm_quantized_base_trains(tiny_vision_batch, mode, tiny_jm):
    """JAX `test_rm_quantized_base_trains` on the port: on a weight-only
    quantized base every group moves (LM and vision adapters, head, special
    row) and the loss falls over 6 steps."""
    from reflectionflow_tpu_torch.rm_train.data import vision_train_geometry

    pm = bridge(tiny_jm)
    trainable = _tiny_trainable(pm, vision=True)
    opt = ptrain.make_rm_optimizer(lr=1e-2)
    state = opt.init(trainable)
    step = ptrain.make_rm_train_step(pm.model, opt, loss_type="bt", pooling="special", special_token_id=9, r=2,
                                     alpha=2, tower=pm.visual, grid_thw=vision_train_geometry(pm.vis_cfg, 256)[1],
                                     quantize_base=mode, quantize_min_size=16)
    assert not any(isinstance(m, nn.Linear) for m in [*pm.model.layers.modules(), *pm.visual.blocks.modules()])
    before = _snapshot(trainable)
    losses = []
    for _ in range(6):
        trainable, state, aux = step(trainable, state, tiny_vision_batch)
        losses.append(float(aux["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    after = flatten_tree(trainable)
    for group in ("lora/", "vision_lora/", "rm_head", "special"):
        assert max(float((after[k].detach() - v).abs().max()) for k, v in before.items() if k.startswith(group)) > 0, group


# ---------------------------------------------------------------- checkpoints and optimizer state


def _tiny_checkpoint_trainable(jm, seed):
    """A JAX-layout trainable on the tiny model, every tensor random."""
    rng = np.random.default_rng(seed)
    lora = jtrain.rm_lora_init(jax.random.PRNGKey(seed), jm.lm_params, r=2, alpha=4.0)["adapters"]
    vlora = jtrain.rm_vision_lora_init(jax.random.PRNGKey(seed + 1), jm.vision_params, r=2, alpha=4.0)["adapters"]

    def rand(tree):
        return {p: {k: rng.normal(0, 0.1, np.shape(v)).astype(np.float32) for k, v in ab.items()}
                for p, ab in tree.items()}

    H = jm.lm_cfg.hidden_size
    return {"lora": rand(lora), "rm_head": rng.normal(size=(H, 1)).astype(np.float32),
            "special": rng.normal(size=(H,)).astype(np.float32), "vision_lora": rand(vlora)}


def test_checkpoint_cross_reads_both_ways(tmp_path, tiny_jm):
    """A port-written checkpoint loads in JAX's `load_rm_checkpoint` bitwise and
    scores in JAX's `QwenRewardVerifier` as the port's verifier scores it
    (rtol 1e-4), and the reverse; the files, `model_config.json` and every
    tensor name are the same; `special` pooling reaches the special id."""
    from reflectionflow_tpu.rm_train.train import load_rm_checkpoint as j_load, save_rm_checkpoint as j_save
    from reflectionflow_tpu_torch.rm_train.train import load_rm_checkpoint as p_load

    jm = tiny_jm
    jt = _tiny_checkpoint_trainable(jm, 3)
    kw = dict(pooling="special", special_token_id=77, vq_mean=0.2, vq_std=1.5, lora_alpha=4.0, lora_r=2)
    pm = bridge(jm)
    ptrain.save_rm_checkpoint(str(tmp_path / "port"), rm_trainable_from_jax(jt, pm), **kw)
    j_save(str(tmp_path / "jax"), jt, **kw)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert (tmp_path / "port/model_config.json").read_text() == (tmp_path / "jax/model_config.json").read_text()
    for name in ("port", "jax"):
        back_j, cfg_j = j_load(str(tmp_path / name))
        back_p, cfg_p = p_load(str(tmp_path / name))
        assert cfg_j == cfg_p == json.loads((tmp_path / "jax/model_config.json").read_text())
        for got in (jax.tree.map(np.asarray, back_j), jax.tree.map(lambda t: t.numpy(), back_p)):
            assert jax.tree.structure(got) == jax.tree.structure(jt)
            jax.tree.map(np.testing.assert_array_equal, got, jt)
    imgs = [np.random.default_rng(i).integers(0, 255, (56, 56, 3), dtype=np.uint8) for i in range(2)]
    prompts = ["a red cube", "a dog"]
    # the two checkpoints hold the same tensors (above): JAX's verifier on the port's,
    # the port's verifier on JAX's
    jv = JVerifier(model_path=str(tmp_path / "port"), model=_own_copy(jm), max_pixels=56 * 56)
    pv = QwenRewardVerifier(model_path=str(tmp_path / "jax"), model=bridge(jm), max_pixels=56 * 56)
    _close(pv.raw_scores(imgs, prompts), jv.raw_scores(imgs, prompts), 1e-4)


def test_checkpoint_roundtrip_and_vision_lora(tmp_path, tiny_jm):
    """JAX `test_rm_checkpoint_vision_lora_roundtrip` / `test_rm_checkpoint_roundtrip`
    on the port: save -> load -> the port's trainable back, bitwise."""
    pm = bridge(tiny_jm)
    trainable = _tiny_trainable(pm, vision=True)
    ptrain.save_rm_checkpoint(str(tmp_path / "ckpt"), trainable, "special", 9, vq_mean=0.2, vq_std=1.5)
    back, cfg = ptrain.load_rm_checkpoint(str(tmp_path / "ckpt"))
    assert cfg["VQ_mean"] == 0.2 and cfg["special_token_id"] == 9 and cfg["output_dim"] == 1
    want = rm_trainable_to_jax(trainable)
    assert set(back["vision_lora"]) == set(want["vision_lora"]) and any(p.startswith("merger/") for p in back["vision_lora"])
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(lambda t: t.numpy(), back), want)


def test_rm_opt_state_roundtrip(tmp_path, tiny_jm):
    """JAX `test_rm_opt_state_roundtrip` on the port: a state after one
    update comes back exactly; a missing file gives the template itself; a
    state saved for other trainable tensors raises."""
    pm = bridge(tiny_jm)
    trainable = _tiny_trainable(pm)
    opt = ptrain.make_rm_optimizer(lr=1e-3)
    state = opt.init(trainable)
    flat = flatten_tree(trainable)
    _, state = opt.update({k: torch.ones_like(v) for k, v in flat.items()}, state, trainable)
    ptrain.save_rm_opt_state(str(tmp_path), state, trainable)
    restored = ptrain.load_rm_opt_state(str(tmp_path), opt.init(trainable), trainable)
    assert restored["lora"]["count"] == 1
    for k in state:
        for a, b in zip(restored[k]["mu"] + restored[k]["nu"], state[k]["mu"] + state[k]["nu"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    fresh = opt.init(trainable)
    assert ptrain.load_rm_opt_state(str(tmp_path / "nope"), fresh, trainable) is fresh
    other = _tiny_trainable(pm, vision=True)
    with pytest.raises(ValueError):
        ptrain.load_rm_opt_state(str(tmp_path), opt.init(other), other)


def test_trainable_bridge_roundtrip(small):
    """`rm_trainable_from_jax` / `_to_jax` invert each other, and the port's
    adapters sit on the modules JAX's tree paths name (A (N, in, r) -> lora_A (r, in))."""
    jlm, jvis, _, _ = small
    jt = _jax_trainable(jlm, jvis, seed=9)
    pt = rm_trainable_from_jax(jt)
    jax.tree.map(np.testing.assert_array_equal, rm_trainable_to_jax(pt), jt)
    a = pt["lora"]["layers.1.mlp.down_proj"]["lora_A"]
    np.testing.assert_array_equal(a.detach().numpy(), jt["lora"]["blocks/down/w"]["A"][1].T)
    b = pt["vision_lora"]["merger.mlp.2"]["lora_B"]
    np.testing.assert_array_equal(b.detach().numpy(), jt["vision_lora"]["merger/fc2/w"]["B"].T)
    pm = _port_model(small)
    names = set(ptrain.rm_lora_init(threefry.prng_key(0), pm.model, r=R)["adapters"])
    assert names == set(pt["lora"])
    names = set(ptrain.rm_vision_lora_init(threefry.prng_key(0), pm.visual, r=R)["adapters"])
    assert names == set(pt["vision_lora"])
