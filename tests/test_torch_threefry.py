"""The port's `jax.random` (`utils/threefry.py`) against JAX 0.9 on the CPU,
and every seeded draw of the port against the JAX package's from the same
seed, with no noise passed in by hand.

Keys (PRNGKey, split into 2 and 4, fold_in, chains of three) and bits and
uniforms in float32 and bfloat16 are JAX's bit for bit. Normals are within
4 fp32 ulps (the largest difference measured over these cases and 2^18
draws is 3 ulps: torch's log1p and XLA's differ in their last bit); in
bfloat16 they are equal. The committed fixtures of `tests/data/torch_prng/`
are held to live JAX here, and to the port here and on the card
(`chip_smoke.py`). Seeded parity: `FluxPipeline.generate(seed=)` and
`seeds_to_latents`, one `train` step from `cfg.seed` (LoRA init, t, noise,
loss and adapters), the reward trainer's heads from `--seed`, and Qwen's
sampled tokens at temperature > 0. About 54 s on one core, most of it the
JAX side's compiles (a third of it JAX's train step)."""

import hashlib
import json
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reflectionflow_tpu.search import seeds as jseeds
from reflectionflow_tpu_torch.search import seeds as tseeds
from reflectionflow_tpu_torch.utils import threefry

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_prng")
with open(os.path.join(DATA, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NORMALS = np.load(os.path.join(DATA, "normals.npz"))
SEEDS = [0, 1, 42, 2**31 - 2]
NORMAL_ULPS = 4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _raw(a) -> np.ndarray:
    a = np.asarray(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)) \
        if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in units in the last place between two float arrays
    given as raw words (sign-magnitude mapped to a monotone integer line)."""
    bits = 8 * a.dtype.itemsize
    sign = np.int64(1) << (bits - 1)

    def line(x):
        x = x.astype(np.int64)
        return np.where(x & sign, -(x & (sign - 1)), x)

    return int(np.abs(line(a) - line(b)).max()) if a.size else 0


def _chain(key, chain, split, fold_in):
    for step in chain:
        op, arg = step.split(":")
        key = fold_in(key, int(arg)) if op == "fold_in" else split(key, int(op[len("split"):]))[int(arg)]
    return key


# ---------------------------------------------------------------- keys and draws


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_and_chains_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert tk == threefry.as_key(np.asarray(jk))
    for num in (2, 4):
        assert [threefry.as_key(k) for k in np.asarray(jax.random.split(jk, num))] == threefry.split(tk, num)
    assert threefry.fold_in(tk, 3) == threefry.as_key(np.asarray(jax.random.fold_in(jk, 3)))
    chain = ["split4:3", "fold_in:7", "split2:0"]
    assert _chain(tk, chain, threefry.split, threefry.fold_in) == threefry.as_key(np.asarray(
        _chain(jk, chain, jax.random.split, jax.random.fold_in)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_normal_match_jax(seed, dtype):
    """Shapes of 1, odd lengths and (for the largest seed) over 2^17 elements."""
    tdt, jdt = DTYPES[dtype]
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    tkey = threefry.as_key(np.asarray(key))
    for shape in ((1,), (129,), (3, 5, 7)) + (((1 << 17) + 3,) if seed == SEEDS[-1] else ()):
        shp = (shape,) if isinstance(shape, int) else shape
        np.testing.assert_array_equal(threefry.random_bits(tkey, shape).numpy().astype(np.uint32),
                                      np.asarray(jax.random.bits(key, shp)))
        np.testing.assert_array_equal(_raw(threefry.uniform(tkey, shape, tdt)),
                                      _raw(jax.random.uniform(key, shp, jdt)))
        got, want = _raw(threefry.normal(tkey, shape, tdt)), _raw(jax.random.normal(key, shp, jdt))
        assert _ulps(got, want) <= (NORMAL_ULPS if dtype == "float32" else 0)


def test_uniform_range_and_16_bit_words_match_jax():
    key = jax.random.PRNGKey(11)
    tkey = threefry.prng_key(11)
    np.testing.assert_array_equal(_raw(threefry.uniform(tkey, (1000,), minval=-3.0, maxval=5.0)),
                                  _raw(jax.random.uniform(key, (1000,), minval=-3.0, maxval=5.0)))
    np.testing.assert_array_equal(threefry.random_bits(tkey, (33,), 16).numpy().astype(np.uint16),
                                  np.asarray(jax.random.bits(key, (33,), jnp.uint16)))


@pytest.mark.parametrize("seed", [0, 42])
def test_gumbel_and_categorical_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = threefry.prng_key(seed)
    g = threefry.gumbel(tkey, (4096,)).numpy()
    np.testing.assert_allclose(g, np.asarray(jax.random.gumbel(key, (4096,))), rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(seed).standard_normal((6, 301)).astype(np.float32) * 3
    np.testing.assert_array_equal(threefry.categorical(tkey, torch.from_numpy(logits)).numpy(),
                                  np.asarray(jax.random.categorical(key, jnp.asarray(logits))))


# ---------------------------------------------------------------- the committed fixtures


@pytest.mark.parametrize("name", sorted(MANIFEST["cases"]))
def test_fixtures_are_live_jax(name):
    case = MANIFEST["cases"][name]
    key = _chain(jax.random.PRNGKey(case["seed"]), case["chain"], jax.random.split, jax.random.fold_in)
    shape, jdt = tuple(case["shape"]), DTYPES[case["dtype"]][1]
    assert [int(w) for w in np.asarray(key)] == case["key"]
    assert _sha(np.asarray(jax.random.bits(key, shape))) == case["bits_sha256"]
    assert _sha(_raw(jax.random.uniform(key, shape, jdt))) == case["uniform_sha256"]
    normal = _raw(jax.random.normal(key, shape, jdt))
    assert _sha(normal) == case["normal_sha256"]
    np.testing.assert_array_equal(NORMALS[name], normal)


@pytest.mark.parametrize("name", sorted(MANIFEST["cases"]))
def test_port_matches_fixtures(name):
    case = MANIFEST["cases"][name]
    key = _chain(threefry.prng_key(case["seed"]), case["chain"], threefry.split, threefry.fold_in)
    shape, tdt = tuple(case["shape"]), DTYPES[case["dtype"]][0]
    assert list(key) == case["key"]
    assert _sha(threefry.random_bits(key, shape).numpy().astype(np.uint32)) == case["bits_sha256"]
    assert _sha(_raw(threefry.uniform(key, shape, tdt))) == case["uniform_sha256"]
    assert _ulps(_raw(threefry.normal(key, shape, tdt)), NORMALS[name]) <= NORMAL_ULPS


def test_latent_fixture_is_live_jax_and_the_port():
    """A 1024 px FLUX candidate's packed bf16 latent: the fixture is JAX's;
    the port's differs in at most 1e-4 of its elements, by one bf16 ulp."""
    from reflectionflow_tpu.models.flux.latents import draw_packed_noise as j_draw
    from reflectionflow_tpu_torch.models.flux.latents import draw_packed_noise

    lat = MANIFEST["latent"]
    want = NORMALS["latent"]
    jgot = _raw(j_draw(jax.random.PRNGKey(lat["seed"]), 1, lat["height"], lat["width"], lat["channels"],
                       jnp.bfloat16))
    assert _sha(jgot) == lat["sha256"] and _sha(want) == lat["sha256"]
    got = _raw(draw_packed_noise(threefry.prng_key(lat["seed"]), 1, lat["height"], lat["width"],
                                 lat["channels"], torch.bfloat16, device="cpu"))
    assert got.shape == want.shape == (1, 4096, 64)
    diff = got != want
    assert diff.mean() <= 1e-4
    assert _ulps(got, want) <= 1


def test_seeds_to_latents_match_jax():
    seeds = tseeds.candidate_seeds(3, 1, 2, 3)
    assert seeds == jseeds.candidate_seeds(3, 1, 2, 3)
    got = tseeds.seeds_to_latents(seeds, 64, 48, 16, torch.float32, 8, "cpu")
    want = jseeds.seeds_to_latents(seeds, 64, 48, 16, jnp.float32, 8)
    assert _ulps(_raw(got), _raw(want)) <= NORMAL_ULPS


# ---------------------------------------------------------------- seeded parity


@pytest.fixture(scope="module")
def pipelines():
    """Tiny fp32 pipelines of both packages on the same weights: the port's
    random init, carried to the JAX package by its own checkpoint converters
    (much quicker here than the JAX random init)."""
    import dataclasses

    from reflectionflow_tpu.config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
    from reflectionflow_tpu.sampler.pipeline import FluxPipeline as JaxFluxPipeline
    from reflectionflow_tpu.utils import hf_convert
    from reflectionflow_tpu.utils.tokenizers import load_tokenizer
    from reflectionflow_tpu_torch import config as tconfig
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    cfgs = (FluxDiTConfig.tiny(), FluxVAEConfig.tiny(), T5Config.tiny(), CLIPTextConfig.tiny())
    tpipe = FluxPipeline.random_init(torch.Generator().manual_seed(0), *(
        cls(**dataclasses.asdict(c)) for cls, c in zip(
            (tconfig.FluxDiTConfig, tconfig.FluxVAEConfig, tconfig.T5Config, tconfig.CLIPTextConfig), cfgs)),
        dtype=torch.float32)
    tpipe.attn_impl = "xla"

    def sd(m):
        return {k: v.detach().numpy() for k, v in m.state_dict().items()}

    params = {"dit": hf_convert.convert_flux_dit_state(sd(tpipe.dit), cfgs[0]),
              "vae": hf_convert.convert_flux_vae_state(sd(tpipe.vae), cfgs[1]),
              "t5": hf_convert.convert_t5_state(sd(tpipe.t5), cfgs[2]),
              "clip": hf_convert.convert_clip_text_state(sd(tpipe.clip), cfgs[3])}
    jpipe = JaxFluxPipeline(*cfgs, params=jax.tree.map(jnp.asarray, params),
                            t5_tokenizer=load_tokenizer(None, "t5", cfgs[2].vocab_size, 1),
                            clip_tokenizer=load_tokenizer(None, "clip", cfgs[3].vocab_size, cfgs[3].eos_token_id),
                            dtype=jnp.float32)
    return jpipe, tpipe


def test_seeded_generate_matches_jax(pipelines):
    """No latents passed in: the seed draws the JAX package's noise, and the
    images agree within the injected-latent parity bound (1 in uint8)."""
    jpipe, tpipe = pipelines
    prompts = ["a photo of a red cube", "two dogs on a bench"]
    kw = dict(height=32, width=32, num_inference_steps=2, max_sequence_length=16, seed=5)
    want = jpipe.generate(prompts, **kw)
    got = tpipe.generate(prompts, **kw)
    assert got.shape == want.shape == (2, 32, 32, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    want_lat = np.asarray(jpipe.generate(prompts, output_type="latent", **kw))
    got_lat = tpipe.generate(prompts, output_type="latent", **kw).numpy()
    np.testing.assert_allclose(got_lat, want_lat, atol=1e-4, rtol=1e-4)


def test_train_step_from_seed_matches_jax(pipelines, tmp_path):
    """One `train` step of both packages from `cfg.seed` on the same shard:
    the same LoRA init, t (the step's t_mean) and noise, so the loss and the
    adapters agree within the rf_loss parity tolerance (atol 2e-4, rtol 2e-3)."""
    from reflectionflow_tpu.config import TrainConfig as JTrainConfig
    from reflectionflow_tpu.lora import lora as jlora
    from reflectionflow_tpu.train import data as jdata
    from reflectionflow_tpu.train.train_loop import train as jtrain
    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora import lora as tlora
    from reflectionflow_tpu_torch.train import data as tdata
    from reflectionflow_tpu_torch.train.train_loop import train
    from reflectionflow_tpu_torch.utils.jax_bridge import lora_from_jax, lora_to_jax

    jpipe, tpipe = pipelines
    shard = str(tmp_path / "genref_000.tar")
    jdata.write_synthetic_shard(shard, n=2, size=16)
    cfgs = []
    for cls, sub in ((JTrainConfig, "jax"), (TrainConfig, "torch")):
        cfg = cls()
        cfg.seed, cfg.max_steps, cfg.save_interval = 13, 1, 1
        cfg.lora.r, cfg.lora.alpha = 2, 2.0
        cfg.data.batch_size, cfg.data.target_size, cfg.data.condition_size = 2, 16, 16
        cfg.checkpoint_dir = str(tmp_path / sub)
        cfgs.append(cfg)
    kw = dict(shards=[shard], batch_size=2, target_size=16, condition_size=16, seed=1)
    jout = jtrain(jpipe, cfgs[0], jdata.GenRefDataset(**kw))
    tout = train(tpipe, cfgs[1], tdata.GenRefDataset(**kw))

    k_init = jax.random.split(jax.random.PRNGKey(13))[0]
    init_want = jlora.lora_init(k_init, jpipe.params["dit"], r=2, alpha=2.0)
    init_got = lora_to_jax(tlora.lora_init(threefry.split(threefry.prng_key(13))[0], tpipe.dit, r=2, alpha=2.0),
                           tpipe.dit)
    for path, ab in init_want["adapters"].items():
        np.testing.assert_allclose(init_got["adapters"][path]["A"], np.asarray(ab["A"]), rtol=5e-7, atol=1e-7)

    assert abs(tout["metrics"]["t_mean"] - float(jout["metrics"]["t_mean"])) < 1e-6
    np.testing.assert_allclose(tout["metrics"]["loss"], float(jout["metrics"]["loss"]), atol=2e-4, rtol=2e-3)
    want = lora_from_jax(jax.tree.map(np.asarray, {"_alpha": 2.0, "_r": 2, "adapters": jout["adapters"]}),
                         tpipe.dit)["adapters"]
    for name, ab in want.items():
        for k in ("lora_A", "lora_B"):
            np.testing.assert_allclose(tout["adapters"][name][k].detach().numpy(), ab[k].detach().numpy(),
                                       atol=2e-4, rtol=2e-3, err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def qwen():
    """A tiny Qwen2.5-VL in both packages on the same weights: the port's
    random init, carried to the JAX package by its checkpoint converters."""
    import dataclasses

    from reflectionflow_tpu.config import QwenLMConfig, QwenVLVisionConfig
    from reflectionflow_tpu.models.qwen_vl.model import QwenVLModel as JModel
    from reflectionflow_tpu.utils import hf_convert
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel

    pm = QwenVLModel.random_init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    sd = {k: v.detach().numpy() for k, v in pm.state_dict().items()}
    lm_cfg = QwenLMConfig(**dataclasses.asdict(pm.lm_cfg))
    vis_cfg = QwenVLVisionConfig(**dataclasses.asdict(pm.vis_cfg))
    jm = JModel(jax.tree.map(jnp.asarray, hf_convert.convert_qwen_lm_state(sd, lm_cfg)),
                jax.tree.map(jnp.asarray, hf_convert.convert_qwen_vision_state(sd, vis_cfg)), lm_cfg, vis_cfg,
                dtype=jnp.float32)
    return jm, pm.eval().requires_grad_(False)


@pytest.mark.parametrize("vision", [False, True], ids=["lm", "lm_and_tower"])
def test_reward_heads_from_seed_match_jax(qwen, vision):
    """The train_reward CLI's trainables from `--seed`: the LM (and tower)
    adapters, rm_head and the special row the JAX CLI draws."""
    from reflectionflow_tpu_torch.cli import train_reward as pcli
    from reflectionflow_tpu_torch.utils.jax_bridge import rm_trainable_to_jax

    from test_torch_train_reward_cli import SEED, _jax_cli_trainable

    jm, pm = qwen
    args = Namespace(seed=SEED, lora_r=2, lora_alpha=4.0, vision_lora=vision, output_dim=1)
    got = rm_trainable_to_jax(pcli.init_trainable(pm, args, torch.device("cpu")))
    want = _jax_cli_trainable(jm, 2, 4.0, vision)
    assert sorted(got) == sorted(want)
    for key in ("rm_head", "special"):
        assert _ulps(_raw(torch.from_numpy(got[key])), _raw(want[key])) <= NORMAL_ULPS, key
    for key in [k for k in got if k.endswith("lora")]:
        assert sorted(got[key]) == sorted(want[key])
        for path, ab in want[key].items():
            np.testing.assert_allclose(got[key][path]["A"], ab["A"], rtol=5e-7, atol=1e-7, err_msg=path)
            np.testing.assert_array_equal(got[key][path]["B"], ab["B"])


def test_qwen_sampled_tokens_match_jax(qwen):
    """Sampled decode at temperature 0.9: the JAX generator's tokens from its
    default key and from a given one."""
    from reflectionflow_tpu.models.qwen_vl.generate import QwenVLGenerator as JGenerator
    from reflectionflow_tpu_torch.models.qwen_vl.generate import QwenVLGenerator

    from test_torch_qwen_vl import _ids

    jm, pm = qwen
    rng = np.random.default_rng(4)
    seqs = [(_ids(4, 2), [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)]),
            (_ids(4, 5), [rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)])]
    jgen = JGenerator(model=jm, tokenizer=None, eos_token_id=-1)
    pgen = QwenVLGenerator(model=pm, tokenizer=None, eos_token_id=-1)
    want = jgen.decode_batch(seqs, max_new_tokens=8, temperature=0.9)
    assert pgen.decode_batch(seqs, max_new_tokens=8, temperature=0.9) == want
    assert want != jgen.decode_batch(seqs, max_new_tokens=8)  # the draw mattered
    key = jax.random.PRNGKey(21)
    assert pgen.decode_batch(seqs, max_new_tokens=8, temperature=0.9, key=threefry.prng_key(21)) == \
        jgen.decode_batch(seqs, max_new_tokens=8, temperature=0.9, key=key)
