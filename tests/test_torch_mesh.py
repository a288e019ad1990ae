"""The port's serving over a mesh of ranks against the JAX package's mesh.

The port runs one process per device under `torch.distributed`: here gloo
ranks on the CPU, spawned once per world size (a module-scoped launch that
runs every check; the ranks' side is `torch_mesh_ranks.py`), with a file
rendezvous under the test's temporary directory. The JAX side runs on its 8
virtual CPU devices. Weights cross through `utils/jax_bridge.py`; the two
packages draw different noise from one seed, so images are compared through
injected latents, and the seeded path against the unsharded port.

Limits: the TP forward fp32 atol 1e-5 (a sum across ranks in another order);
sharded latents atol 1e-5 against the unsharded port and 1e-4 against JAX's
sharded generate (2 steps; JAX generates from the port's text states, so
only the DiT and the sampler cross), images uint8 atol 1; the sharded
reflection block's artifacts identical to the unsharded run's
(`parallel.dryrun.search_block_check`).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from reflectionflow_tpu.config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
from reflectionflow_tpu.models.flux.dit import flux_dit_apply, flux_dit_init
from reflectionflow_tpu.models.flux.rope import make_image_ids, make_text_ids
from reflectionflow_tpu.parallel.mesh import replicate_params as jax_replicate
from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
from reflectionflow_tpu.parallel.specs import dit_param_spec as jax_dit_param_spec
from reflectionflow_tpu.parallel.specs import shard_dit_params as jax_shard_dit_params
from reflectionflow_tpu_torch.config import FluxDiTConfig as TFluxDiTConfig
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.parallel import distributed
from reflectionflow_tpu_torch.parallel.dryrun import file_init
from reflectionflow_tpu_torch.parallel.specs import dit_param_spec
from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule
from reflectionflow_tpu_torch.utils.jax_bridge import dit_state_dict

import torch_mesh_ranks
from test_torch_flux_dit import perturbed

torch.set_num_threads(1)
CFG = FluxDiTConfig.tiny()  # 4 heads: 2 a rank on the model axis
PROMPTS = ["a red cube", "two dogs", "a blue bench", "three cats"]
GEN_KW = dict(height=16, width=16, num_inference_steps=2, max_sequence_length=16)
TY = TX = 4
VC_STEPS = 6


def _tp_inputs(seed=3):
    rng = np.random.default_rng(seed)
    B, Lt = 4, 8
    x = dict(img=rng.standard_normal((B, TY * TX, CFG.in_channels), dtype=np.float32),
             txt=rng.standard_normal((B, Lt, CFG.text_dim), dtype=np.float32),
             pooled=rng.standard_normal((B, CFG.pooled_dim), dtype=np.float32),
             timestep=np.asarray([0.5, 0.7, 0.2, 0.9], np.float32),
             img_ids=make_image_ids(TY, TX), txt_ids=make_text_ids(Lt),
             guidance=np.full((B,), 3.5, np.float32))
    cond = dict(x, cond=rng.standard_normal((B, 4, CFG.in_channels), dtype=np.float32),
                cond_ids=make_image_ids(2, 2, position_delta=(0, -2)))
    return {"plain": x, "cond": cond, "cond_view": cond}


def _vcache_inputs(seed=5):
    rng = np.random.default_rng(seed)
    return dict(lat=rng.standard_normal((2, TY * TX, CFG.in_channels), dtype=np.float32),
                txt=rng.standard_normal((2, 8, CFG.text_dim), dtype=np.float32),
                pooled=rng.standard_normal((2, CFG.pooled_dim), dtype=np.float32),
                img_ids=make_image_ids(TY, TX), txt_ids=make_text_ids(8))


def _unsharded_vcache(dit, threshold):
    v = {k: torch.from_numpy(a) for k, a in _vcache_inputs().items()}
    kw = _vcache_kw(threshold)
    return denoise(dit, v.pop("lat"), v.pop("txt"), v.pop("pooled"), **v, **kw,
                   return_vcache_stats=True)


def _vcache_kw(threshold):
    return dict(sigmas=make_schedule(VC_STEPS, TY * TX), guidance_scale=3.5, num_steps=VC_STEPS,
                vcache_threshold=threshold, vcache_cached="residual")


def _pipelines(params):
    """The port's tiny pipeline with the DiT of `params` (its T5, CLIP and
    VAE from the port's seed, as on every rank) and JAX's with the same DiT
    alone: JAX generates latents from the port's text states."""
    from reflectionflow_tpu_torch.parallel.dryrun import tiny_pipeline

    tpipe = tiny_pipeline("cpu")
    tpipe.dit.load_state_dict(dit_state_dict(params, CFG))
    tpipe.attn_impl = "pallas"
    jpipe = JaxFluxPipeline(CFG, FluxVAEConfig.tiny(), T5Config.tiny(), CLIPTextConfig.tiny(),
                            params={"dit": jax.tree.map(jnp.asarray, params)}, t5_tokenizer=None,
                            clip_tokenizer=None, dtype=jnp.float32)
    return jpipe, tpipe


@functools.cache
def _jax_tp_forward(variant):
    """JAX `flux_dit_apply` with `shard_dit_params` on a (4, 2) mesh; the
    "cond_view" variant's cond stream reads other weights (`cond_params`)."""
    x = {k: jnp.asarray(v) for k, v in _tp_inputs()[variant].items()}
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    with mesh:
        params, cond = (jax_shard_dit_params(jax.tree.map(jnp.asarray, _jax_params(seed)), mesh)
                        for seed in (1, 2))
        return np.asarray(flux_dit_apply(params, CFG, **x,
                                          cond_params=cond if variant == "cond_view" else None))


@functools.cache
def _jax_params(seed=1):
    return perturbed(flux_dit_init(jax.random.PRNGKey(0), CFG), seed=seed)


def _port_dit(params):
    dit = FluxDiT(TFluxDiTConfig(**dataclasses.asdict(CFG))).eval().requires_grad_(False)
    dit.load_state_dict(dit_state_dict(params, CFG))
    return dit


def _pick_threshold(dit):
    """A threshold whose schedule skips some steps and keeps the same n_full
    5% either side (far from every accumulator value)."""
    for t in np.geomspace(0.02, 2.0, 25):
        n = [_unsharded_vcache(dit, t * f)[1] for f in (0.95, 1.0, 1.05)]
        if len(set(n)) == 1 and 1 < n[0] < VC_STEPS:
            return float(t)
    raise AssertionError("no threshold with skipped steps")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX references, the unsharded port, and the ranks' results at worlds 2
    and 4 (one launch each)."""
    root = tmp_path_factory.mktemp("mesh")
    params = _jax_params()
    dit = _port_dit(params)
    jpipe, tpipe = _pipelines(params)
    lat = np.random.default_rng(9).standard_normal((len(PROMPTS), 16, 16), dtype=np.float32)
    threshold = _pick_threshold(dit)
    data = {
        "tp_dit": dit.state_dict(), "tp_cond_dit": _port_dit(_jax_params(2)).state_dict(),
        "tp_inputs": _tp_inputs(),
        "prompts": PROMPTS, "generate_kw": GEN_KW, "gen_latents": lat,
        "vcache_inputs": _vcache_inputs(), "vcache_kw": _vcache_kw(threshold),
    }
    data_path = str(root / "data.pt")
    torch.save(data, data_path)
    ranks = {}
    for world in (2, 4):
        out = root / f"w{world}"
        out.mkdir()
        ranks[world] = distributed.launch(torch_mesh_ranks.run_checks, world,
                                          args=(data_path, str(out)), device="cpu",
                                          init_method=file_init(str(root)), timeout=300)
    # JAX's candidate-sharded generate (4 devices on "data"): the same latents and text states
    txt, pooled = (jnp.asarray(t.numpy()) for t in tpipe.encode_prompts(PROMPTS, GEN_KW["max_sequence_length"]))
    jpipe.mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    jpipe.params = jax_replicate(jpipe.params, jpipe.mesh)
    jax_sharded = np.asarray(jpipe.generate(PROMPTS, latents=jnp.asarray(lat), txt=txt, pooled=pooled,
                                            output_type="latent", **GEN_KW))
    return dict(params=params, dit=dit, tpipe=tpipe, lat=lat, threshold=threshold, ranks=ranks,
                jax_sharded=jax_sharded)


def test_specs_shard_the_dims_jax_shards():
    """Each DiT parameter's cut dim is JAX `dit_param_spec`'s on its tree path,
    (in, out) read as torch's (out, in); the single block's proj_out is the
    one divergence (cut on its input; JAX keeps single_blocks/out whole)."""
    dit = FluxDiT(TFluxDiTConfig(**dataclasses.asdict(CFG)))
    n_cut = 0
    for name, p in dit.named_parameters():
        module, _, kind = name.rpartition(".")
        path, index, _ = dit.jax_path(module)
        leaf = "w" if kind == "weight" else "b"
        stacked = index is not None
        spec = jax_dit_param_spec(f"{path}/{leaf}", (3 if leaf == "w" else 2) if stacked else p.dim())
        dims = [d - stacked for d, ax in enumerate(spec) if ax == "model"]
        want = None if not dims else ({0: 1, 1: 0}[dims[0]] if leaf == "w" else 0)
        if path == "single_blocks/out" and leaf == "w":
            assert want is None and dit_param_spec(name) == 1
            continue
        assert dit_param_spec(name) == want, (name, path, spec)
        n_cut += want is not None
    # q, k, v, txt q/k/v, two fc1 (+ biases) and four ROW weights a double block;
    # q, k, v and mlp_in (+ biases) a single block
    assert n_cut == CFG.num_double_blocks * (8 * 2 + 4) + CFG.num_single_blocks * 4 * 2


@pytest.mark.parametrize("world", [2, 4], ids=["data1_model2", "data2_model2"])
@pytest.mark.parametrize("variant", ["plain", "cond", "cond_view"])
def test_tp_forward_matches_jax_tp_forward(setup, world, variant):
    want = _jax_tp_forward(variant)
    # a sum after each ROW linear: to_out, to_add_out, ff.net.2, ff_context.net.2 and the
    # single block's proj_out; the cond stream adds its to_out, ff.net.2 and proj_out
    cond = variant != "plain"
    sums = CFG.num_double_blocks * (4 + 2 * cond) + CFG.num_single_blocks * (1 + cond)
    for r in setup["ranks"][world]:
        np.testing.assert_allclose(r[f"tp_{variant}"], want, atol=1e-5)
        assert r["tp_head_count"] == CFG.num_heads // 2
        assert r[f"tp_all_reduces_{variant}"] == sums
    full = sum(p.numel() for p in setup["dit"].parameters())
    assert setup["ranks"][world][0]["tp_param_numel"] < full


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_generate_matches_unsharded_port_and_jax(setup, world):
    tpipe, lat = setup["tpipe"], setup["lat"]
    ranks = setup["ranks"][world]
    base_lat = tpipe.generate(PROMPTS, latents=lat, **GEN_KW)
    base_seed = tpipe.generate(PROMPTS, seed=7, **GEN_KW)
    want = setup["jax_sharded"]
    final = tpipe.generate(PROMPTS, latents=lat, output_type="latent", **GEN_KW).numpy()
    np.testing.assert_allclose(final, want, atol=1e-4)
    for r in ranks:  # every rank returns the whole batch
        assert r["gen_latents"].shape == (len(PROMPTS), 16, 16, 3)
        for got, ref in ((r["gen_latents"], base_lat), (r["gen_seed"], base_seed)):
            assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
        np.testing.assert_allclose(r["gen_latent_out"], final, atol=1e-5)
        np.testing.assert_allclose(r["gen_latent_out"], want, atol=1e-4)
        # replicate_params: a broadcast a tensor; then one gather a generate call, nothing else
        assert r["replicate_broadcasts"] == r["replicate_params"]
        assert r["gen_counts"] == {"all_reduce_sum": 0, "all_reduce_max": 0, "all_gather_batch": 3,
                                   "all_gather_dim": 0, "broadcast": 0, "broadcast_object": 0,
                                   "grad_all_reduce": 0, "ring_shift": 0, "ring_shift_bytes": 0,
                                   "host_copies": 0}


def test_reflectionflow_block_on_a_data4_mesh(setup):
    """Artifacts (files, names, selections, JSONL) identical to the unsharded
    run's, the images byte for byte."""
    search = setup["ranks"][4][0]["search"]
    assert search["identical"] and search["png_max_diff"] == 0 and search["files"] >= 40
    assert all(r["search"] is None for r in setup["ranks"][4][1:])


def test_dynamic_vcache_under_tp_decides_once_per_group(setup):
    want, n_want = _unsharded_vcache(setup["dit"], setup["threshold"])
    outs = [r["vcache"] for r in setup["ranks"][2]]
    assert 1 < n_want < VC_STEPS
    for lat, n_full, broadcasts in outs:
        assert n_full == n_want
        assert broadcasts == VC_STEPS  # the step decision, from the model group's first rank
        np.testing.assert_allclose(lat, want.numpy(), atol=1e-5)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


def test_mesh_denoise_on_data_by_model(setup):
    """The serving half of the multichip dryrun on a 2 x 2 mesh: a skipped
    step at vcache_order 2 and the TeaCache schedule, against unsharded."""
    for r in setup["ranks"][4][0]["denoise"].values():
        assert r["max_abs_diff"] <= 1e-5 and r["n_full"] == r["n_full_unsharded"]


def test_quantize_under_a_model_axis_raises(setup):
    """Quantize under a model axis serves (it raised before the training
    slice): W8A8 on the cut DiT in the unfused layout, as JAX keeps it under a
    model mesh, equal to the one-rank W8A8 run of that layout (the row-cut
    linears' int32 sums are exact), with one amax and one sum a row-cut
    linear, and near the fused serving profile (another scale per
    out-projection: cosine >= 0.999)."""
    ref = _pipelines(setup["params"])[1]
    ref.quantize(min_size=16, fuse_qkv=False)
    kw = dict(latents=setup["lat"], output_type="latent", **GEN_KW)
    want = ref.generate(PROMPTS, **kw).numpy()
    fused = _pipelines(setup["params"])[1]
    fused.quantize(min_size=16)
    served = fused.generate(PROMPTS, **kw).numpy()
    rows = GEN_KW["num_inference_steps"] * (CFG.num_double_blocks * 4 + CFG.num_single_blocks)
    for r in setup["ranks"][2]:
        assert r["quantized_tp_layout"] == "pair"
        np.testing.assert_allclose(r["quantized_tp"], want, atol=1e-5)
        a, b = r["quantized_tp"].ravel(), served.ravel()
        assert float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)) >= 0.999
        counts = r["quantized_tp_counts"]
        assert counts["all_reduce_max"] == counts["all_reduce_sum"] == rows


def test_a_failing_rank_ends_the_launch(tmp_path):
    with pytest.raises(RuntimeError, match="failed"):
        distributed.launch(torch_mesh_ranks.fail, 2, device="cpu", init_method=file_init(str(tmp_path)),
                           timeout=120)


def test_cpu_mesh_needs_no_cuda_and_cuda_ranks_need_it():
    assert distributed.resolve_rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():  # never the CPU unless asked for
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.resolve_rank_device(None)
    assert os.path.basename(file_init("/x")).startswith("rdzv-")
