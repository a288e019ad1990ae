"""Training over a mesh of ranks, and quantized serving under tensor
parallelism, in the port against the JAX package's meshes.

The port runs one process per rank under `torch.distributed`: gloo ranks on
the CPU, one launch a world (`torch_mesh_train_ranks.run_world`), with a file
rendezvous under the test's temporary directory. The JAX side runs on the
conftest's 8 virtual CPU devices, with the same seeded numpy weights.

  * the corrector step (`make_train_step(mesh=)`) on data 2, model 2 and
    data 2 x model 2, against JAX's `make_train_step(mesh=Mesh(dp x tp))`
    with the DiT cut by its `shard_dit_params` and replicated adapters:
    JAX's t and noise are handed to the port; sgd (lr 0.5, the default
    clip) so that the update carries the gradient; adapters after the step
    within rtol 1e-4 (atol 1e-6) in fp32, loss and gradient norm rtol 1e-5,
    bitwise equal on every rank;
  * the reward-model step FSDP over data 2 with the vision adapters
    (`make_rm_train_step(mesh=)`), against JAX's on a 2-device "data" mesh:
    every trainable within 1e-4 of its max |value|, the loss rtol 1e-5;
  * W8A8 under model 2 (`FluxPipeline.quantize` after `set_mesh`) against
    the JAX package's W8A8 forward on the unfused `pair` layout that its
    `quantize` keeps under a model mesh: the int8 codes bitwise and the
    scales rtol 1e-6 on each rank's cut, the forward cosine >= 0.9999 (int8
    activation rounding flips where the two frameworks' sums differ in the
    last bit, as `test_torch_serving_dit.py`); NF4 MLPs (the other linears
    weight-only int8, so that no activation rounding flips) under model 2
    against the unsharded port (atol 1e-5: partial sums in another order),
    and a cut that splits an NF4 group raises;
  * `fsdp_param_spec` against JAX's on a list of shapes;
  * the dryrun halves (`parallel.dryrun.dryrun_multichip`) and the train CLI
    over two ranks.

About 110 s wall (a core for the test, one a rank while they run): two
launches of the port's ranks, JAX's three mesh steps in module-scoped
fixtures, the dryrun's launch of four ranks, the CLI's of two.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from reflectionflow_tpu.config import TrainConfig as JTrainConfig
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.models.flux.dit import flux_dit_apply, flux_dit_init
from reflectionflow_tpu.ops.quant import quantize_dit_params as jax_quantize_dit_params
from reflectionflow_tpu.parallel.specs import fsdp_param_spec as jax_fsdp_param_spec
from reflectionflow_tpu.parallel.specs import shard_dit_params as jax_shard_dit_params
from reflectionflow_tpu.rm_train import train as jtrain
from reflectionflow_tpu.train.rectified_flow import make_optimizer as j_make_optimizer
from reflectionflow_tpu.train.rectified_flow import make_train_step as j_make_train_step
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.parallel import distributed
from reflectionflow_tpu_torch.parallel.dryrun import dryrun_multichip, file_init
from reflectionflow_tpu_torch.parallel.specs import fsdp_param_spec
from reflectionflow_tpu_torch.utils import jax_bridge
from reflectionflow_tpu_torch.utils.jax_bridge import (dit_state_dict, lora_from_jax, lora_to_jax, qwen_lm_state_dict,
                                                       qwen_vision_state_dict, rm_trainable_from_jax,
                                                       rm_trainable_to_jax)

import torch_mesh_train_ranks
from test_torch_cond_dit import jax_lora
from test_torch_flux_dit import _cfg, perturbed
from test_torch_quant import numpy_models
from test_torch_rm_train import ALPHA, GRID, LM, R, SP, VIS, _batch, _jax_trainable, _jcfgs, qwen_trees

torch.set_num_threads(1)
B, TY, TX, LT, CTY = 4, 4, 4, 8, 2
LR, R_DIT, ALPHA_DIT = 0.5, 4, 8.0
NF4_KW = dict(dit_int4_mlp=True, int4_group=16, act_quant_exclude=("",))  # the rest weight-only
TRAIN_MESHES = {"data2": (2, 1), "model2": (1, 2), "data2_model2": (2, 2)}


def _train_batch(cfg, seed=41):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((B, TY * TX, cfg.in_channels), dtype=np.float32),
            "cond": rng.standard_normal((B, CTY * CTY, cfg.in_channels), dtype=np.float32),
            "txt": rng.standard_normal((B, LT, cfg.text_dim), dtype=np.float32),
            "pooled": rng.standard_normal((B, cfg.pooled_dim), dtype=np.float32),
            "img_ids": jrope.make_image_ids(TY, TX), "txt_ids": jrope.make_text_ids(LT),
            "cond_ids": jrope.make_image_ids(CTY, CTY, position_delta=(0, -CTY))}


@functools.cache
def _train_case():
    """The JAX DiT, its port, the adapters (non-zero B), the global batch and
    the key's t and noise. Both block families even: JAX's `dit_param_spec`
    gives a stacked (N, out) bias the flat spec, which cuts the block axis."""
    jcfg, tcfg = _cfg(num_single_blocks=2)
    params = perturbed(flux_dit_init(jax.random.PRNGKey(0), jcfg), seed=1)
    dit = FluxDiT(tcfg)
    dit.load_state_dict(dit_state_dict(params, jcfg))
    dit.eval()
    jl = jax_lora(params, r=R_DIT, alpha=ALPHA_DIT)
    batch = _train_batch(jcfg)
    key = jax.random.PRNGKey(5)
    k_t, k_noise = jax.random.split(key)
    t = np.asarray(jax.nn.sigmoid(jax.random.normal(k_t, (B,))))
    noise = np.asarray(jax.random.normal(k_noise, batch["x0"].shape))
    return jcfg, params, dit, jl, batch, key, t, noise


def _jax_tcfg():
    tcfg = JTrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr = "sgd", LR
    return tcfg


@functools.cache
def _jax_train_step(dp, tp):
    """JAX's step on a (dp, tp) data x model mesh: adapters (numpy) and metrics."""
    jcfg, params, _, jl, batch, key, _, _ = _train_case()
    mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))
    with mesh:
        sharded = jax_shard_dit_params(jax.tree.map(jnp.asarray, params), mesh)
        adapters = jax.tree.map(jnp.asarray, jl["adapters"])
        optimizer = j_make_optimizer(_jax_tcfg())
        step = j_make_train_step(sharded, jcfg, optimizer, alpha=ALPHA_DIT, r=R_DIT, mesh=mesh)
        adapters, _, metrics = step(adapters, optimizer.init(adapters),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return jax.tree.map(np.asarray, adapters), {k: float(v) for k, v in metrics.items()}


def _train_data():
    jcfg, params, dit, jl, batch, _, t, noise = _train_case()
    lora = lora_from_jax(jl, dit)
    return {"cfg": {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__},
            "dit": {k: v.numpy() for k, v in dit.state_dict().items()},
            "adapters": {n: {k: v.detach().numpy() for k, v in ab.items()} for n, ab in lora["adapters"].items()},
            "batch": batch, "t": t, "noise": noise, "lr": LR, "alpha": ALPHA_DIT, "r": R_DIT}


@functools.cache
def _rm_case():
    jlm_cfg, jvis_cfg = _jcfgs()
    jlm, jvis = jax.tree.map(np.asarray, qwen_trees(jlm_cfg, jvis_cfg))
    return jlm, jvis, jlm_cfg, jvis_cfg, _jax_trainable(jlm, jvis, seed=3), _batch(jlm["embed"], seed=4)


@functools.cache
def _jax_rm_step():
    """JAX's reward step FSDP over a 2-device "data" mesh (a pair a device)."""
    jlm, jvis, jlm_cfg, jvis_cfg, jt, batch = _rm_case()
    opt = jtrain.make_rm_optimizer(lr=1e-2, vision_lr=1e-3)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    step = jtrain.make_rm_train_step(jax.tree.map(jnp.asarray, jlm), jlm_cfg, opt, loss_type="btt",
                                     pooling="special", special_token_id=SP, alpha=ALPHA, r=R,
                                     vision_params=jax.tree.map(jnp.asarray, jvis), vis_cfg=jvis_cfg,
                                     grid_thw=GRID, mesh=mesh)
    trainable = jax.tree.map(jnp.asarray, jt)
    trainable, _, aux = step(trainable, opt.init(trainable), {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, trainable), float(aux["loss"])


def _rm_data():
    jlm, jvis, jlm_cfg, jvis_cfg, jt, batch = _rm_case()
    from reflectionflow_tpu_torch.config import QwenLMConfig, QwenVLVisionConfig

    lm_cfg, vis_cfg = QwenLMConfig(**LM), QwenVLVisionConfig(**VIS)
    trainable = rm_trainable_from_jax(jt)
    return {"lm_cfg": LM, "vis_cfg": VIS,
            "qwen": {k: v.numpy() for k, v in {**qwen_lm_state_dict(jlm, lm_cfg),
                                                 **qwen_vision_state_dict(jvis, vis_cfg)}.items()},
            "trainable": {k: ({n: {kk: t.detach().numpy() for kk, t in ab.items()} for n, ab in v.items()}
                              if isinstance(v, dict) else v.detach().numpy()) for k, v in trainable.items()},
            "batch": batch, "lr": 1e-2, "vision_lr": 1e-3, "sp": SP, "alpha": ALPHA, "r": R, "grid": GRID}


@functools.cache
def _quant_case():
    """The W8A8 DiT (2 heads, MLP 256, every linear quantized at min_size 16)
    in both packages: JAX's quantized tree on the unfused layout, its forward,
    and the inputs."""
    jcfg, tree, dit = numpy_models(seed=2)
    qtree = jax_quantize_dit_params(jax.tree.map(jnp.asarray, tree), min_size=16)
    rng = np.random.default_rng(8)
    inputs = {"img": rng.standard_normal((2, TY * TX, jcfg.in_channels), dtype=np.float32),
              "txt": rng.standard_normal((2, LT, jcfg.text_dim), dtype=np.float32),
              "pooled": rng.standard_normal((2, jcfg.pooled_dim), dtype=np.float32),
              "timestep": np.asarray([0.7, 0.3], np.float32), "img_ids": jrope.make_image_ids(TY, TX),
              "txt_ids": jrope.make_text_ids(LT), "guidance": np.asarray([3.5, 3.5], np.float32)}
    want = np.asarray(flux_dit_apply(qtree, jcfg, **{k: jnp.asarray(v) for k, v in inputs.items()}))
    return jcfg, jax.tree.map(np.asarray, qtree), dit, inputs, want


def _quant_data(**quantize_kw):
    jcfg, _, dit, inputs, _ = _quant_case()
    return {"cfg": {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__},
            "dit": {k: v.numpy() for k, v in dit.state_dict().items()}, "inputs": inputs,
            "quantize_kw": quantize_kw}


def _launch(root, world, data, checks):
    path = str(root / f"data{world}.pt")
    torch.save({**data, "checks": checks}, path)
    return distributed.launch(torch_mesh_train_ranks.run_world, world, args=(path,), device="cpu",
                              init_method=file_init(str(root)), timeout=300)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both launches: world 2 (data 2 and model 2 steps, the FSDP reward step,
    W8A8 and NF4 under model 2, an NF4 cut that splits a group) and world 4
    (the data 2 x model 2 step)."""
    root = tmp_path_factory.mktemp("mesh_train")
    train = _train_data()
    nf4 = dict(_quant_data(), bad_group=48)  # the MLP's rank cut at 128 splits groups of 48
    data = {"data2": train, "model2": train, "rm": _rm_data(), "w8a8": _quant_data(),
            "nf4": _quant_data(**NF4_KW), "nf4_split": nf4}
    checks = [("data2", "train", (2, 1)), ("model2", "train", (1, 2)), ("rm", "rm", True),
              ("w8a8", "tp_quant", None), ("nf4", "tp_quant", None), ("nf4_split", "nf4_split", None)]
    out = {2: _launch(root, 2, data, checks)}
    out[4] = _launch(root, 4, {"data2_model2": train}, [("data2_model2", "train", (2, 2))])
    return out


@pytest.mark.parametrize("name", list(TRAIN_MESHES))
def test_mesh_train_step_matches_jax(ranks, name):
    _, _, dit, _, _, _, _, _ = _train_case()
    want, want_metrics = _jax_train_step(*TRAIN_MESHES[name])
    results = ranks[4 if name == "data2_model2" else 2]
    first = results[0][name]
    for r in results:
        got = r[name]
        assert got["heads"] == 2 // TRAIN_MESHES[name][1]
        for n, ab in got["adapters"].items():  # the same update on every rank, bit for bit
            for k, v in ab.items():
                np.testing.assert_array_equal(v, first["adapters"][n][k])
        assert got["counts"]["grad_all_reduce"] == 1
    lora = {"_alpha": ALPHA_DIT, "_r": R_DIT, "adapters": {n: {k: torch.from_numpy(v) for k, v in ab.items()}
                                                           for n, ab in first["adapters"].items()}}
    got = lora_to_jax(lora, dit)["adapters"]
    moved = 0.0
    for path, ab in want.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(got[path][k], ab[k], rtol=1e-4, atol=1e-6, err_msg=f"{path} {k}")
            moved = max(moved, float(np.abs(ab[k] - np.asarray(_train_case()[3]["adapters"][path][k])).max()))
    assert moved > 1e-3  # the step moved the adapters
    for k in ("loss", "grad_norm", "t_mean"):
        np.testing.assert_allclose(first["metrics"][k], want_metrics[k], rtol=1e-5)


def test_fsdp_reward_step_matches_jax(ranks):
    want, want_loss = _jax_rm_step()
    results = [r["rm"] for r in ranks[2]]
    for r in results[1:]:
        for k, v in r["trainable"].items():
            np.testing.assert_array_equal(v, results[0]["trainable"][k])
    got = results[0]
    nested = {}
    for path, v in got["trainable"].items():
        group, *rest = path.split("/")
        if rest:
            nested.setdefault(group, {}).setdefault(rest[0], {})[rest[1]] = torch.from_numpy(v)
        else:
            nested[group] = torch.from_numpy(v)
    got_j = jax.tree.map(np.asarray, rm_trainable_to_jax(nested))
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    for leaf_got, leaf_want in zip(jax.tree.leaves(got_j), jax.tree.leaves(want)):
        err = np.abs(leaf_got - leaf_want).max() / max(np.abs(leaf_want).max(), 1e-30)
        assert err <= 1e-4, err
    held, whole = got["bytes"]
    assert held < 0.55 * whole  # each rank keeps about half of the frozen base
    assert got["counts"]["all_gather_dim"] > 0 and got["counts"]["grad_all_reduce"] == 1
    assert got["rewards_A"].shape == (2, 1)  # the global batch's rewards


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))


def test_w8a8_under_tp_matches_jax_codes_and_forward(ranks):
    jcfg, qtree, dit, _, want = _quant_case()
    n_row = jcfg.num_double_blocks * 4 + jcfg.num_single_blocks
    for r in ranks[2]:
        got = r["w8a8"]
        assert got["rope_layout"] == "pair"  # the unfused layout, as JAX keeps under a model mesh
        assert _cosine(got["out"], want) >= 0.9999
        kinds = set()
        for name, c in got["codes"].items():
            path, idx, _ = dit.jax_path(name)
            node = jax_bridge._node(qtree, path, idx)
            w_q, scale = node["w_q"], node["w_scale"].reshape(-1)  # JAX (in, out)
            if c["cut"] == "col":
                w_q, scale = w_q[:, c["index"]], scale[c["index"]]
            elif c["cut"] in ("row",):
                w_q = w_q[c["index"]]
            np.testing.assert_array_equal(c["w_q"].T, w_q, err_msg=name)
            np.testing.assert_allclose(c["w_scale"], scale, rtol=1e-6, err_msg=name)
            assert c["act_quant"] == ("act_q" in node)
            kinds.add(c["cut"])
        assert kinds == {None, "col", "row"}
        # each row-cut W8A8 linear: one amax and one int32 sum a forward
        assert got["counts"]["all_reduce_max"] == got["counts"]["all_reduce_sum"] == n_row
    np.testing.assert_array_equal(ranks[2][0]["w8a8"]["out"], ranks[2][1]["w8a8"]["out"])


def test_nf4_under_tp_matches_the_unsharded_port(ranks):
    from reflectionflow_tpu_torch.parallel.dryrun import tiny_pipeline

    _, _, dit, inputs, _ = _quant_case()
    pipe = tiny_pipeline("cpu")
    pipe.dit = copy.deepcopy(dit)
    pipe.quantize(which=("dit",), int4=(), min_size=16, fuse_qkv=False, **NF4_KW)
    with torch.no_grad():
        want = pipe.dit(**{k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}, attn_impl="pallas")
    for r in ranks[2]:
        got = r["nf4"]
        np.testing.assert_allclose(got["out"], want.numpy(), atol=1e-5)
        assert {c["cut"] for c in got["codes"].values() if c["kind"] == "nf4"} == {"col", "row"}
        assert "splits NF4 groups of 48" in r["nf4_split"]


@pytest.mark.parametrize("shape", [(), (7,), (8,), (3, 5), (4, 6), (6, 4), (8, 8), (2, 12, 12), (3, 7, 9),
                                   (5, 2, 10), (1, 4096, 11008), (152064, 3584), (16,) * 3])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_fsdp_param_spec_matches_jax(shape, n):
    spec = tuple(jax_fsdp_param_spec(shape, n))
    want = next((d for d, ax in enumerate(spec) if ax == "data"), None)
    assert fsdp_param_spec(shape, n) == want


def test_dryrun_multichip_runs_every_half(tmp_path):
    out = dryrun_multichip(4, device="cpu", workdir=str(tmp_path))
    assert out["mesh"] == (2, 2)
    assert out["train"]["adapter_max_abs_diff"] <= 1e-5 and np.isfinite(out["train"]["loss"])
    assert out["rm_train"]["trainable_max_abs_diff"] <= 1e-5
    assert out["rm_train"]["lm_bytes"] < 0.3 * out["rm_train"]["lm_bytes_whole"]
    assert out["ring"]["max_abs_diff"] <= 2e-4 and out["search_block"]["identical"]
    for half in ("loss=", "denoise=", "search_block=", "ring_sp=", "rm_train="):
        assert half in out["summary"]


def test_train_cli_over_two_ranks(tmp_path):
    """`cli.train` with `mesh_shape` (2,): two spawned gloo ranks, a synthetic
    shard each, the global batch of 2 split one a rank; rank 0 writes one
    metrics row a step and the checkpoint."""
    from reflectionflow_tpu_torch.cli import train as train_cli

    cfg = {"max_steps": 2, "save_interval": 2, "checkpoint_dir": str(tmp_path / "ckpt"), "mesh_shape": [2],
           "data": {"batch_size": 2, "target_size": 16, "condition_size": 8}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    metrics = train_cli.main(["--config", str(tmp_path / "cfg.json"), "--synthetic_data", "--synthetic_weights",
                              "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [0, 1]
    assert (tmp_path / "ckpt" / "2" / "state.pt").exists()
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("synthetic_*.tar")) == ["synthetic_000.tar",
                                                                                   "synthetic_001.tar"]
