"""Ring attention across ranks (sequence parallelism over a `RankMesh`) in the
port against the JAX package's ring and the port's one-process ring.

The port runs one process per rank under `torch.distributed`: gloo ranks on
the CPU, one launch a world (`torch_ring_ranks.run_world`) with a file
rendezvous under the test's temporary directory; the chunks run the plain
versions of K7a/K7b/K7c ("pallas") or dense chunks ("xla"), and a rotation
is `collectives.ring_shift`. The JAX side runs on the conftest's 8 virtual
CPU devices with the same seeded numpy inputs, its Pallas chunks in
interpret mode. fp32 throughout. Bounds:

  * `ring_attention` on ("seq",) = 2, forward 3e-5 and gradients 2e-5 of
    JAX's ring (`test_torch_ring_attention.py`'s bounds), both impls and
    the three cross forms; output and gradients bitwise equal to the port's
    one-process ring of 2 slots, here and on (data 2, seq 2) and (model 2,
    seq 2);
  * the 2-step conditioned denoise (`union_cond_attn=False`) under "ring"
    and "ring_pallas" on ("seq",) = 2, and under "ring" with the DiT cut
    over (model 2, seq 2): 2e-4 of JAX's (its ring-denoise bound);
  * one corrector step under "ring_pallas" on (data 2, seq 2) against JAX's
    step on the same mesh: adapters rtol 1e-4 (atol 1e-6), loss and
    gradient norm rtol 1e-5 (`test_torch_mesh_train.py`'s bounds); and
    bitwise equal to the data-only step (data 2 with the one-process ring),
    which shows that `reduce_gradients` leaves "seq" out of its sum;
  * serving: the tiny pipeline's `generate` over a ("seq",) mesh within
    1e-5 of "xla" on the rank, bitwise equal across the ranks, and the
    TeaCache schedule's n_full under the ring equal on every rank;
  * a rank that raises, or stalls, while its peer waits in the ring ends
    the launch with an error.

About 90 s wall: the two launches (2 and 4 ranks) and JAX's references in
module-scoped fixtures.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from reflectionflow_tpu.ops import attention as jattention
from reflectionflow_tpu.ops.ring_attention import ring_attention as j_ring_attention
from reflectionflow_tpu.parallel.specs import shard_dit_params as jax_shard_dit_params
from reflectionflow_tpu.sampler.generate import denoise as jax_denoise
from reflectionflow_tpu.train.rectified_flow import make_optimizer as j_make_optimizer
from reflectionflow_tpu.train.rectified_flow import make_train_step as j_make_train_step
from reflectionflow_tpu_torch.parallel import distributed
from reflectionflow_tpu_torch.parallel.dryrun import file_init
from reflectionflow_tpu_torch.sampler.generate import make_schedule
from reflectionflow_tpu_torch.utils.jax_bridge import lora_to_jax

import torch_ring_ranks
from test_torch_mesh_train import ALPHA_DIT, R_DIT, _jax_tcfg, _train_case, _train_data
from test_torch_ring_attention import _denoise_inputs

torch.set_num_threads(1)
FWD_TOL, GRAD_TOL, DENOISE_TOL = 3e-5, 2e-5, 2e-4
B, L, H, D, MAIN_LEN = 2, 64, 2, 16, 40  # the cond boundary inside the second chunk at p = 2
CROSS = {"none": 0.0, "mask": -1e30, "c_factor": math.log(2.0)}
CASES = [(impl, None if form == "none" else MAIN_LEN, cb) for impl in ("xla", "pallas")
         for form, cb in CROSS.items()]
GEN_KW = dict(height=16, width=16, num_inference_steps=2, max_sequence_length=16)  # 16 + 16 tokens
PROMPTS = ["a red cube", "two dogs"]
VC_STEPS = 6


def _attn_inputs():
    rng = np.random.default_rng(0)
    return {n: rng.standard_normal((B, L, H, D), dtype=np.float32) for n in "qkvg"}


def _case_id(case):
    impl, main_len, cb = case
    return f"{impl}-{next(f for f, c in CROSS.items() if c == cb)}"


@functools.cache
def _jax_ring(case):
    """JAX's ring on a 2-device "seq" mesh: the output and the gradients of
    sum(out * g)."""
    impl, main_len, cb = case
    x = _attn_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    spec = NamedSharding(mesh, P(None, "seq"))

    def loss(q, k, v):
        out = j_ring_attention(q, k, v, mesh, axis="seq", impl=impl, interpret=impl == "pallas",
                               main_len=main_len, cross_bias=cb)
        return jnp.sum(out * x["g"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jax.device_put(jnp.asarray(x[n]), spec) for n in "qkv"))
    return np.asarray(out), [np.asarray(a) for a in grads]


def _denoise_data():
    jcfg = _train_case()[0]
    x = _denoise_inputs(jcfg)
    x["sigmas"] = make_schedule(2, x["lat"].shape[1]).numpy()
    return x


@functools.cache
def _jax_denoise(shape, names, impl):
    """JAX's 2-step conditioned denoise under its ring over "seq" (the DiT cut
    over "model" by its `shard_dit_params` when the mesh has that axis)."""
    jcfg, params = _train_case()[:2]
    x = _denoise_data()
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)
    jattention.set_ring_context(mesh, axis="seq")
    try:
        with mesh:
            tree = jax.tree.map(jnp.asarray, params)
            if "model" in names:
                tree = jax_shard_dit_params(tree, mesh)
            out = jax_denoise(tree, jcfg, *(jnp.asarray(x[k]) for k in ("lat", "txt", "pooled", "img_ids",
                                                                         "txt_ids", "sigmas")),
                              jnp.asarray(3.5), 2, cond=jnp.asarray(x["cond"]), cond_ids=jnp.asarray(x["cond_ids"]),
                              union_cond_attn=False, attn_impl=impl)
            return np.asarray(out)
    finally:
        jattention.set_ring_context(None)


@functools.cache
def _jax_train_step():
    """JAX's step under its interpret-mode ring on a (data 2, seq 2) mesh."""
    jcfg, params, _, jl, batch, key, _, _ = _train_case()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "seq"))
    jattention.set_ring_context(mesh, axis="seq")
    try:
        with mesh:
            adapters = jax.tree.map(jnp.asarray, jl["adapters"])
            optimizer = j_make_optimizer(_jax_tcfg())
            step = j_make_train_step(jax.tree.map(jnp.asarray, params), jcfg, optimizer, alpha=ALPHA_DIT, r=R_DIT,
                                     mesh=mesh, attn_impl="ring_pallas_interpret")
            adapters, _, metrics = step(adapters, optimizer.init(adapters),
                                        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    finally:
        jattention.set_ring_context(None)
    return jax.tree.map(np.asarray, adapters), {k: float(v) for k, v in metrics.items()}


def _launch(root, world, data, checks, timeout=300):
    path = str(root / f"data{world}_{len(checks)}.pt")
    torch.save({**data, "checks": checks}, path)
    return distributed.launch(torch_ring_ranks.run_world, world, args=(path,), device="cpu",
                              init_method=file_init(str(root)), timeout=timeout)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two launches: world 2 (the ring on ("seq",) 2, its denoise, the
    data-only step with the one-process ring, serving) and world 4 (the ring
    on (data 2, seq 2) and (model 2, seq 2), the (data 2, seq 2) step, the
    (model 2, seq 2) denoise)."""
    root = tmp_path_factory.mktemp("ring_ranks")
    rng = np.random.default_rng(4)
    data = dict(_train_data(), attn=_attn_inputs(), denoise=_denoise_data(), prompts=PROMPTS,
                generate_kw=GEN_KW, gen_latents=rng.standard_normal((2, 16, 16), dtype=np.float32),
                vcache_sigmas=make_schedule(VC_STEPS, 16).numpy())
    seq2 = ((2,), ("seq",))
    out = {2: _launch(root, 2, data, [
        ("attn", "attention", (*seq2, CASES)),
        ("denoise_ring", "denoise", (*seq2, "ring")),
        ("denoise_ring_pallas", "denoise", (*seq2, "ring_pallas")),
        ("train_data2", "train", ((2,), ("data",), 2)),
        ("serve", "serve", None)])}
    one = [CASES[4]]  # "pallas" under the -1e30 mask
    out[4] = _launch(root, 4, data, [
        ("attn_data_seq", "attention", ((2, 2), ("data", "seq"), one)),
        ("attn_model_seq", "attention", ((2, 2), ("model", "seq"), one)),
        ("train_data_seq", "train", ((2, 2), ("data", "seq"), 0)),
        ("denoise_model_seq", "denoise", ((2, 2), ("model", "seq"), "ring"))])
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_rank_ring_matches_jax_and_the_one_process_ring(ranks, case):
    want, want_grads = _jax_ring(case)
    for r in ranks[2]:
        got = r["attn"][case]
        np.testing.assert_allclose(got["out"], want, atol=FWD_TOL, rtol=0)
        for name, a, b in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0, err_msg=f"d{name}")
        assert got["bitwise"]  # the same chunks, kernels and merge order as the one-process ring
        assert got["ring_shift"] == 3  # p - 1 shifts forward, p backward (dK/dV home)
        np.testing.assert_array_equal(got["out"], ranks[2][0]["attn"][case]["out"])


@pytest.mark.parametrize("name", ["attn_data_seq", "attn_model_seq"])
def test_rank_ring_on_two_axes_is_the_one_process_ring(ranks, name):
    """Each seq line of a 2 x 2 mesh runs its own ring, bitwise the
    one-process ring's and JAX's within the bounds."""
    case = CASES[4]
    want, want_grads = _jax_ring(case)
    for r in ranks[4]:
        got = r[name][case]
        assert got["bitwise"] and got["ring_shift"] == 3
        np.testing.assert_allclose(got["out"], want, atol=FWD_TOL, rtol=0)
        for a, b in zip(got["grads"], want_grads):
            np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_conditioned_denoise_over_the_rank_ring_matches_jax(ranks, impl):
    want = _jax_denoise((2,), ("seq",), "ring" if impl == "ring" else "ring_pallas_interpret")
    for r in ranks[2]:
        got = r[f"denoise_{impl}"]
        np.testing.assert_allclose(got["latents"], want, atol=DENOISE_TOL, rtol=0)
        np.testing.assert_array_equal(got["latents"], got["one_process"])
        assert got["counts"]["ring_shift"] > 0 and got["counts"]["host_copies"] == 0


def test_denoise_on_model_by_seq_matches_jax(ranks):
    """(model 2, seq 2): each rank's ring runs over its TP-cut heads (one of
    two), the function JAX's one program computes."""
    want = _jax_denoise((2, 2), ("model", "seq"), "ring")
    for r in ranks[4]:
        got = r["denoise_model_seq"]
        np.testing.assert_allclose(got["latents"], want, atol=DENOISE_TOL, rtol=0)
        np.testing.assert_array_equal(got["latents"], ranks[4][0]["denoise_model_seq"]["latents"])
        assert got["counts"]["all_reduce_sum"] > 0 and got["counts"]["ring_shift"] > 0


def test_train_step_on_data_by_seq_matches_jax(ranks):
    _, _, dit, jl, _, _, _, _ = _train_case()
    want, want_metrics = _jax_train_step()
    results = [r["train_data_seq"] for r in ranks[4]]
    for got in results:  # the same update on every rank, bit for bit
        for n, ab in got["adapters"].items():
            for k, v in ab.items():
                np.testing.assert_array_equal(v, results[0]["adapters"][n][k])
        assert got["counts"]["grad_all_reduce"] == 1 and got["counts"]["ring_shift"] > 0
    first = results[0]
    lora = {"_alpha": ALPHA_DIT, "_r": R_DIT, "adapters": {n: {k: torch.from_numpy(v) for k, v in ab.items()}
                                                           for n, ab in first["adapters"].items()}}
    got = lora_to_jax(lora, dit)["adapters"]
    moved = 0.0
    for path, ab in want.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(got[path][k], ab[k], rtol=1e-4, atol=1e-6, err_msg=f"{path} {k}")
            moved = max(moved, float(np.abs(ab[k] - np.asarray(jl["adapters"][path][k])).max()))
    assert moved > 1e-3
    for k in ("loss", "grad_norm", "t_mean"):
        np.testing.assert_allclose(first["metrics"][k], want_metrics[k], rtol=1e-5)


def test_reduce_gradients_leaves_seq_out(ranks):
    """The (data 2, seq 2) step equals the data-only step (data 2, the
    one-process ring of 2 slots) bit for bit: "seq" enters neither the
    gradient sum nor its scale (an all-reduce over the world would give each
    gradient twice)."""
    want = ranks[2][0]["train_data2"]
    for r in ranks[4]:
        got = r["train_data_seq"]
        for n, ab in want["adapters"].items():
            for k, v in ab.items():
                np.testing.assert_array_equal(got["adapters"][n][k], v, err_msg=f"{n} {k}")
        assert got["metrics"] == want["metrics"]


def test_serving_over_a_seq_mesh(ranks):
    results = [r["serve"] for r in ranks[2]]
    for got in results:
        np.testing.assert_allclose(got["ring"], got["dense"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got["ring"], results[0]["ring"])
        assert got["counts"]["ring_shift"] > 0 and got["counts"]["all_gather_batch"] == 0
        lat, n_full = got["vcache_ring"]
        want_lat, want_n = got["vcache_xla"]
        np.testing.assert_allclose(lat, want_lat, atol=1e-5, rtol=0)
        assert n_full == want_n == results[0]["vcache_ring"][1] and 0 < n_full


@pytest.mark.parametrize("how", ["raise", "stall"])
def test_a_failing_or_stalled_rank_ends_the_ring_launch(tmp_path, how):
    data = {"attn": _attn_inputs()}
    with pytest.raises(RuntimeError, match="rank 1 gives up|gave no result|failed"):
        _launch(tmp_path, 2, data, [("fail", "fail", how)], timeout=20)
