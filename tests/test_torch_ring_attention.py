"""Ring attention (sequence parallel) of the PyTorch port against the JAX package.

The JAX ring runs on a `jax.sharding.Mesh` of the first p CPU devices (axis
"seq"), its Pallas chunks in interpret mode; the port's mesh is p copies of
`torch.device("cpu")`, where the chunk wrappers run the plain versions of
K7a/K7b/K7c. Inputs are seeded numpy arrays handed to both; fp32 throughout.
Bounds: chunk outputs and ring forwards 3e-5 (the JAX ring test's forward
bound); ring gradients 2e-5 (the JAX test holds its own ring to dense
autodiff at 5e-4; port and JAX agree far closer); a 2-step denoise 2e-4 (the
JAX ring-denoise test's bound); rf_loss at its own test's atol 2e-4, rtol 2e-3.
The kernels themselves are checked on the card by `chip_smoke.py`.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from reflectionflow_tpu.lora import lora as jlora
from reflectionflow_tpu.models.flux import rope as jrope
from reflectionflow_tpu.ops import attention as jattention
from reflectionflow_tpu.ops.pallas_attention import flash_chunk_bwd as j_chunk_bwd
from reflectionflow_tpu.ops.pallas_attention import flash_chunk_fwd as j_chunk_fwd
from reflectionflow_tpu.ops.ring_attention import ring_attention as j_ring_attention
from reflectionflow_tpu.sampler.generate import denoise as jax_denoise
from reflectionflow_tpu.train.rectified_flow import rf_loss as j_rf_loss
from reflectionflow_tpu_torch.config import TrainConfig
from reflectionflow_tpu_torch.lora import lora as tlora
from reflectionflow_tpu_torch.ops import attention as tattention
from reflectionflow_tpu_torch.ops.flash_attention import (flash_attention_ref, flash_chunk_bwd,
                                                          flash_chunk_fwd)
from reflectionflow_tpu_torch.ops.ring_attention import ring_attention
from reflectionflow_tpu_torch.parallel.mesh import Mesh, make_mesh
from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule
from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step, rf_loss
from reflectionflow_tpu_torch.utils.jax_bridge import lora_from_jax, lora_to_jax

from test_torch_cond_dit import jax_lora
from test_torch_flux_dit import _models, _t

torch.set_num_threads(1)
FWD_TOL, GRAD_TOL = 3e-5, 2e-5
CROSS = {"none": 0.0, "mask": -1e30, "c_factor": math.log(2.0)}  # cross bias of each form


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _meshes(p):
    """(JAX mesh of the first p CPU devices, the port's mesh of p CPU copies), axis "seq"."""
    jmesh = JMesh(np.asarray(jax.devices()[:p]), ("seq",))
    return jmesh, make_mesh((p,), ("seq",), devices=[torch.device("cpu")] * p)


def _shard(jmesh, *xs):
    spec = NamedSharding(jmesh, P(None, "seq"))
    return tuple(jax.device_put(jnp.asarray(x), spec) for x in xs)


def _modifiers(form, L, cond_len):
    """(main_len, cross_bias) of a cross form, as the DiT gives them."""
    if form == "none":
        return None, 0.0
    return L - cond_len, CROSS[form]


# ---------------------------------------------------------------------------
# chunk level: the plain versions of K7a/K7b/K7c against the Pallas chunk
# entries at ring-global offsets
# ---------------------------------------------------------------------------


def visible_rows(Lc, q_off, k_off, main_len, cross_bias):
    """(Lc,) bool: the chunk's query rows that see at least one key. Under the
    -1e30 mask a query chunk can meet a K/V shard that lies wholly across
    the cond boundary; such a row's partial is implementation-defined (each
    kernel weighs its padding differently) and carries lse <= -1e29, so the
    ring's merge gives it weight 0 and the backward's p = exp(s - global lse)
    is 0 there."""
    if main_len is None or cross_bias > -1e29:
        return np.ones(Lc, bool)
    q_cond = np.arange(q_off, q_off + Lc) >= main_len
    k_cond = np.arange(k_off, k_off + Lc) >= main_len
    return (q_cond[:, None] == k_cond[None, :]).any(1)


@pytest.mark.parametrize("form", ["none", "mask", "c_factor"])
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (80, 0), (40, 120)])
def test_chunk_fwd_bwd_match_pallas_interpret(q_off, k_off, form):
    """A 40-row chunk (a ragged tail of the TPU kernel's block) of a
    160-token sequence whose cond segment starts at 100: chunks wholly on one
    side and one that straddles the boundary. The backward takes the
    ring-global lse and delta rows of the whole sequence."""
    L, Lc, main_len = 160, 40, 100
    cross_bias = CROSS[form]
    ml = None if form == "none" else main_len
    q, k, v, g = (_rand(s, 2, L, 2, 16) for s in range(4))
    qc, gc = q[:, q_off:q_off + Lc], g[:, q_off:q_off + Lc]
    kc, vc = k[:, k_off:k_off + Lc], v[:, k_off:k_off + Lc]
    kw = dict(main_len=ml, cross_bias=cross_bias, q_offset=q_off, k_offset=k_off)
    want_out, want_lse = j_chunk_fwd(*map(jnp.asarray, (qc, kc, vc)), interpret=True, **kw)
    out, lse = flash_chunk_fwd(*map(torch.from_numpy, (qc, kc, vc)), **kw)
    assert out.dtype == torch.float32 and lse.shape == (2, 2, Lc)
    want_lse = np.asarray(want_lse)[..., 0].transpose(0, 2, 1)
    rows = visible_rows(Lc, q_off, k_off, ml, cross_bias)
    np.testing.assert_allclose(out.numpy()[:, rows], np.asarray(want_out)[:, rows], atol=FWD_TOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy()[..., rows], want_lse[..., rows], atol=FWD_TOL, rtol=0)
    assert (lse.numpy()[..., ~rows] <= -1e29).all() and np.isfinite(out.numpy()).all()

    # the global rows, from the port's dense attention over the whole sequence
    full_out, full_lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), ml, cross_bias)
    delta = (torch.from_numpy(g) * full_out).sum(-1).transpose(1, 2)  # (B, H, L)
    g_lse, g_delta = (x[..., q_off:q_off + Lc].contiguous() for x in (full_lse, delta))
    want = j_chunk_bwd(*map(jnp.asarray, (qc, kc, vc, gc)),
                       *(jnp.asarray(x.numpy().transpose(0, 2, 1)[..., None]) for x in (g_lse, g_delta)),
                       interpret=True, **kw)
    got = flash_chunk_bwd(*map(torch.from_numpy, (qc, kc, vc, gc)), g_lse, g_delta, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_TOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def _ring_pair(p, impl, form, B=2, L=64, H=2, D=16, cond_len=16, seed=0):
    """Port and JAX ring outputs and (q, k, v) gradients of sum((out - tgt)^2)."""
    q, k, v = (_rand(seed + i, B, L, H, D) for i in range(3))
    tgt = _rand(seed + 3, B, L, H, D)
    main_len, cross_bias = _modifiers(form, L, cond_len)
    jmesh, mesh = _meshes(p)

    def j_loss(q, k, v):
        out = j_ring_attention(q, k, v, jmesh, axis="seq", impl=impl, interpret=impl == "pallas",
                               main_len=main_len, cross_bias=cross_bias)
        return jnp.sum((out - tgt) ** 2), out

    # jit: eager shard_map dispatch costs ~10x the compile at these sizes
    (_, want_out), want_g = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        *_shard(jmesh, q, k, v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_attention(tq, tk, tv, mesh, axis="seq", impl=impl, main_len=main_len,
                         cross_bias=cross_bias)
    got_g = torch.autograd.grad(((out - torch.from_numpy(tgt)) ** 2).sum(), (tq, tk, tv))
    return (out.detach().numpy(), [g.numpy() for g in got_g]), \
        (np.asarray(want_out), [np.asarray(g) for g in want_g])


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_forward_and_gradients_match_jax(p, impl):
    (out, grads), (want_out, want_grads) = _ring_pair(p, impl, "none")
    assert out.shape == (2, 64, 2, 16)
    np.testing.assert_allclose(out, want_out, atol=FWD_TOL, rtol=0)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("modifier", ["mask", "c_factor"])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_cond_modifiers_match_jax(p, modifier, impl):
    """union_cond_attn=False (-1e30) and c_factor (log 2) on the cross blocks:
    the last 24 tokens of 64 are cond, so at p = 4 the boundary falls inside
    a chunk and at p = 2 on a chunk edge."""
    (out, grads), (want_out, want_grads) = _ring_pair(p, impl, modifier, cond_len=24, seed=5)
    np.testing.assert_allclose(out, want_out, atol=FWD_TOL, rtol=0)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")


def test_ring_is_held_by_dense_attention():
    """The port's ring equals its own dense attention with the dense bias, on
    a mesh whose axis is not the first."""
    q, k, v = (torch.from_numpy(_rand(20 + i, 1, 48, 2, 8)) for i in range(3))
    mesh = make_mesh((1, 3), ("data", "seq"), devices=[torch.device("cpu")] * 3)
    bias = tattention.cond_attention_bias(48, 12, union_cond_attn=False)
    want = tattention.sdpa(q, k, v, bias=bias)
    got = ring_attention(q, k, v, mesh, axis="seq", impl="pallas", main_len=36, cross_bias=-1e30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL, rtol=0)


def test_joint_attention_ring_dispatch():
    """impl="ring" / "ring_pallas" on the public entry: the stream split and
    values of the JAX entry (structural mask included); a dense bias raises
    NotImplementedError, a missing ring context ValueError."""
    q, k, v = (_rand(30 + i, 1, 48, 2, 8) for i in range(3))
    jmesh, mesh = _meshes(4)

    def streams(x, conv):
        return [conv(x[:, :16]), conv(x[:, 16:40]), conv(x[:, 40:])]

    tstreams = [streams(x, torch.from_numpy) for x in (q, k, v)]
    jstreams = [streams(x, jnp.asarray) for x in (q, k, v)]
    jattention.set_ring_context(jmesh, axis="seq")
    tattention.set_ring_context(mesh, axis="seq")
    try:
        for impl, jimpl in (("ring", "ring"), ("ring_pallas", "ring_pallas_interpret")):
            for kw in ({}, {"cond_len": 8, "cross_bias": -1e30}):
                want = jax.jit(functools.partial(jattention.joint_attention, impl=jimpl, **kw))(
                    *jstreams)
                got = tattention.joint_attention(*tstreams, impl=impl, **kw)
                assert [g.shape[1] for g in got] == [16, 24, 8]
                for a, b in zip(got, want):
                    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=FWD_TOL, rtol=0)
        with pytest.raises(NotImplementedError, match="structural"):
            tattention.joint_attention(*tstreams, impl="ring",
                                       bias=tattention.cond_attention_bias(48, 8, False))
    finally:
        jattention.set_ring_context(None)
        tattention.set_ring_context(None)
    with pytest.raises(ValueError, match="set_ring_context"):
        tattention.joint_attention(*tstreams, impl="ring_pallas")


# ---------------------------------------------------------------------------
# the slice: conditioned denoise and training under ring
# ---------------------------------------------------------------------------

TY, TX, LT = 4, 4, 8  # joint sequence 8 + 16 + 16 = 40: 20 tokens a shard at p = 2, 10 at p = 4


def _denoise_inputs(cfg, seed=51):
    rng = np.random.default_rng(seed)
    return dict(lat=rng.standard_normal((1, TY * TX, cfg.in_channels), dtype=np.float32),
                txt=rng.standard_normal((1, LT, cfg.text_dim), dtype=np.float32),
                pooled=rng.standard_normal((1, cfg.pooled_dim), dtype=np.float32),
                img_ids=jrope.make_image_ids(TY, TX), txt_ids=jrope.make_text_ids(LT),
                cond=rng.standard_normal((1, TY * TX, cfg.in_channels), dtype=np.float32),
                cond_ids=jrope.make_image_ids(TY, TX, position_delta=(0, -TX)))


@pytest.mark.parametrize("union_cond_attn", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_conditioned_denoise_under_ring_matches_jax(impl, union_cond_attn):
    """Two Euler steps with the cond stream read through a LoRA view, at p = 2
    (union on) and p = 4 (union off: the structural mask's offsets are live),
    against the JAX denoise under the same ring impl."""
    p = 2 if union_cond_attn else 4
    jcfg, params, dit = _models()
    jl = jax_lora(params)
    jparams = jax.tree.map(jnp.asarray, params)
    x = _denoise_inputs(jcfg)
    sigmas = make_schedule(2, TY * TX)
    order = ("lat", "txt", "pooled", "img_ids", "txt_ids")
    jmesh, mesh = _meshes(p)
    jattention.set_ring_context(jmesh, axis="seq")
    tattention.set_ring_context(mesh, axis="seq")
    try:
        want = jax_denoise(jparams, jcfg, *(jnp.asarray(x[k]) for k in order),
                           jnp.asarray(sigmas.numpy()), jnp.asarray(3.5), 2,
                           cond=jnp.asarray(x["cond"]), cond_ids=jnp.asarray(x["cond_ids"]),
                           cond_dit_params=jlora.attach_lora(jparams, jax.tree.map(jnp.asarray, jl)),
                           union_cond_attn=union_cond_attn,
                           attn_impl="ring" if impl == "ring" else "ring_pallas_interpret")
        got = denoise(dit, *(_t(x[k]) for k in order), sigmas, 3.5, 2, cond=_t(x["cond"]),
                      cond_ids=_t(x["cond_ids"]),
                      cond_dit_params=tlora.attach_lora(dit, lora_from_jax(jl, dit)),
                      union_cond_attn=union_cond_attn, attn_impl=impl)
    finally:
        jattention.set_ring_context(None)
        tattention.set_ring_context(None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def _train_batch(cfg, seed=61):
    x = _denoise_inputs(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return {"x0": rng.standard_normal((2, TY * TX, cfg.in_channels), dtype=np.float32),
            "cond": rng.standard_normal((2, TY * TX, cfg.in_channels), dtype=np.float32),
            "txt": np.concatenate([x["txt"]] * 2), "pooled": np.concatenate([x["pooled"]] * 2),
            "img_ids": x["img_ids"], "txt_ids": x["txt_ids"], "cond_ids": x["cond_ids"]}


@pytest.mark.parametrize("union_cond_attn", [True, False])
def test_rf_loss_under_ring_pallas_matches_jax(union_cond_attn):
    """Loss and adapter gradients of one rf_loss under "ring_pallas" at p = 2,
    with the JAX key's t and x1 injected. Union off puts live offsets in the
    forward and the backward; add_cond_attn then carries the cond stream (the
    only one the adapters act on) into the image stream, which the mask would
    otherwise cut off the loss (every adapter gradient 0)."""
    jcfg, params, dit = _models()
    jl = jax_lora(params, r=2, alpha=2.0)
    batch = _train_batch(jcfg)
    flags = {"union_cond_attn": union_cond_attn, "add_cond_attn": not union_cond_attn}
    key = jax.random.PRNGKey(7)
    k_t, k_noise = jax.random.split(key)
    t = np.asarray(jax.nn.sigmoid(jax.random.normal(k_t, (2,))))
    x1 = np.asarray(jax.random.normal(k_noise, batch["x0"].shape))
    jmesh, mesh = _meshes(2)
    jattention.set_ring_context(jmesh, axis="seq")
    tattention.set_ring_context(mesh, axis="seq")
    try:
        loss_fn = functools.partial(j_rf_loss, dit_cfg=jcfg, alpha=2.0, r=2, model_flags=flags,
                                    attn_impl="ring_pallas_interpret")
        (want_loss, _), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, jl["adapters"]), jax.tree.map(jnp.asarray, params),
            batch={k: jnp.asarray(v) for k, v in batch.items()}, key=key)
        lora = lora_from_jax(jl, dit)
        loss, _ = rf_loss(lora["adapters"], dit, {k: _t(v) for k, v in batch.items()}, alpha=2.0,
                          r=2, model_flags=flags, attn_impl="ring_pallas", t=_t(t), noise=_t(x1))
        names = [(n, k) for n, ab in lora["adapters"].items() for k in ("lora_A", "lora_B")]
        grads = torch.autograd.grad(loss, [lora["adapters"][n][k] for n, k in names],
                                    allow_unused=True)
    finally:
        jattention.set_ring_context(None)
        tattention.set_ring_context(None)
    got = {n: {} for n in lora["adapters"]}
    for (n, k), g in zip(names, grads):
        got[n][k] = torch.zeros_like(lora["adapters"][n][k]) if g is None else g
    got_g = lora_to_jax({"_alpha": 2.0, "_r": 2, "adapters": got}, dit)["adapters"]
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-4, rtol=2e-3)
    assert max(float(np.abs(np.asarray(ab["B"])).max()) for ab in want_g.values()) > 0
    for path, ab in want_g.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(got_g[path][k], np.asarray(ab[k]), atol=2e-4, rtol=2e-3,
                                       err_msg=f"{path} {k}")


def test_train_step_runs_under_ring_pallas():
    """One make_train_step step under "ring_pallas" at p = 4: finite loss,
    gradients through the ring, moved adapters."""
    jcfg, params, dit = _models()
    lora = lora_from_jax(jax_lora(params, r=2, alpha=2.0), dit)
    adapters = lora["adapters"]
    before = {n: ab["lora_A"].detach().clone() for n, ab in adapters.items()}
    cfg = TrainConfig()
    cfg.optimizer.name, cfg.optimizer.lr = "sgd", 1e-2
    opt = make_optimizer(cfg)
    opt_state = opt.init(tlora.lora_parameters(lora))
    tattention.set_ring_context(make_mesh((4,), ("seq",), devices=[torch.device("cpu")] * 4))
    try:
        step = make_train_step(dit, opt, alpha=2.0, r=2, attn_impl="ring_pallas")
        batch = {k: _t(v) for k, v in _train_batch(jcfg, seed=71).items()}
        adapters, opt_state, metrics = step(adapters, opt_state, batch,
                                            torch.Generator().manual_seed(0))
    finally:
        tattention.set_ring_context(None)
    assert math.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert any(not torch.equal(ab["lora_A"], before[n]) for n, ab in adapters.items())


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_shape_axes_and_repeated_devices():
    cpu = torch.device("cpu")
    mesh = make_mesh((2, 2), ("data", "seq"), devices=[cpu] * 4)
    assert mesh.shape == {"data": 2, "seq": 2} and mesh.axis_names == ("data", "seq")
    assert mesh.devices.shape == (2, 2) and all(d == cpu for d in mesh.devices.flat)
    assert mesh.axis_devices("seq") == [cpu, cpu]
    assert make_mesh((-1,), ("seq",), devices=["cpu"] * 3).shape == {"seq": 3}
    assert make_mesh(None, devices=[cpu] * 2).shape == {"data": 2}
    assert Mesh(np.asarray([[cpu, cpu, cpu]], dtype=object), ("a", "b")).shape == {"a": 1, "b": 3}
    with pytest.raises(ValueError):
        make_mesh((3,), ("seq",), devices=[cpu] * 2)
    if torch.cuda.device_count() == 0:  # never the CPU unless asked for
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_ring_size_must_divide_the_sequence():
    x = torch.zeros((1, 30, 1, 8))
    with pytest.raises(ValueError, match="must divide"):
        ring_attention(x, x, x, make_mesh((4,), ("seq",), devices=["cpu"] * 4), axis="seq")
