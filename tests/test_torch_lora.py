"""The PyTorch port's LoRA module and safetensors IO against the JAX package."""

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file

from reflectionflow_tpu.lora import lora as jlora
from reflectionflow_tpu_torch.lora import lora as tlora
from reflectionflow_tpu_torch.train.train_loop import export_diffusers_lora
from reflectionflow_tpu_torch.utils import safetensors_io
from reflectionflow_tpu_torch.utils.jax_bridge import lora_from_jax, lora_to_jax

from test_torch_cond_dit import cond_inputs, jax_lora
from test_torch_flux_dit import _models, _t

torch.set_num_threads(1)


def _assert_adapters_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for path in a:
        for k in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(a[path][k]), np.asarray(b[path][k]), err_msg=path)


def test_lora_init_targets_match_jax():
    """Same adapted linears as the JAX corrector target set, same shapes;
    A ~ N(0, 1/r^2), B = 0, fp32 trainable, base weights frozen and untouched."""
    jcfg, params, dit = _models()
    dit.requires_grad_(False)
    want = jlora.lora_init(jax.random.PRNGKey(0), params, r=4, alpha=8.0)
    got = tlora.lora_init(torch.Generator().manual_seed(0), dit, r=4, alpha=8.0)
    back = lora_to_jax(got, dit)
    assert sorted(back["adapters"]) == sorted(want["adapters"])
    for path, ab in want["adapters"].items():
        assert back["adapters"][path]["A"].shape == ab["A"].shape
        assert back["adapters"][path]["B"].shape == ab["B"].shape
    assert tlora.lora_param_count(got) == jlora.lora_param_count(want)
    params_t = tlora.lora_parameters(got)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params_t)
    assert all(not p.requires_grad for p in dit.parameters())
    assert all(torch.count_nonzero(ab["lora_B"]) == 0 for ab in got["adapters"].values())
    A = torch.cat([ab["lora_A"].flatten() for ab in got["adapters"].values()])
    assert abs(A.std().item() - 0.25) < 0.02


def test_bridge_round_trips_lora():
    _, params, dit = _models()
    jl = jax_lora(params)
    _assert_adapters_equal(lora_to_jax(lora_from_jax(jl, dit), dit)["adapters"], jl["adapters"])


@pytest.mark.parametrize("latent_lora", [False, True])
def test_attach_equals_fold(latent_lora):
    """The low-rank view and the folded copy give the same forward; folding
    leaves the base model as it was; the views follow make_dit_param_views."""
    jcfg, params, dit = _models()
    lora = lora_from_jax(jax_lora(params), dit)
    x = {k: _t(v) for k, v in cond_inputs(jcfg, seed=31).items()}
    before = {k: v.clone() for k, v in dit.state_dict().items()}
    main, cond = tlora.make_dit_param_views(dit, lora, latent_lora=latent_lora)
    assert (main is cond) == latent_lora and (main is dit) != latent_lora
    view = tlora.attach_lora(dit, lora)
    with torch.no_grad():
        want = main(**x, cond_params=cond)
        got = (view if latent_lora else dit)(**x, cond_params=view)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert all(torch.equal(v, dit.state_dict()[k]) for k, v in before.items())
    assert tlora.make_dit_param_views(dit, None) == (dit, None)


def test_export_is_read_back_by_jax(tmp_path):
    """`export_diffusers_lora` writes the diffusers keys that JAX's
    convert_diffusers_lora reads (through safetensors.numpy) into the same
    adapters; the port's own convert_diffusers_lora reads them back too."""
    _, params, dit = _models()
    lora = lora_from_jax(jax_lora(params), dit)
    path = str(tmp_path / "lora.safetensors")
    export_diffusers_lora(lora["adapters"], path)
    sd = np_load_file(path)
    assert "transformer.single_transformer_blocks.2.proj_out.lora_A.weight" in sd
    cfg = dit.cfg
    back = jlora.convert_diffusers_lora(sd, cfg.num_double_blocks, cfg.num_single_blocks, alpha=8.0)
    _assert_adapters_equal(back["adapters"], lora_to_jax(lora, dit)["adapters"])
    mine = tlora.convert_diffusers_lora(safetensors_io.load_file(path), alpha=8.0)
    assert mine["_r"] == 4 and mine["_alpha"] == 8.0
    for name, ab in lora["adapters"].items():
        for k in ("lora_A", "lora_B"):
            assert torch.equal(mine["adapters"][name][k], ab[k].detach())


def test_safetensors_reader_reads_the_library_writer(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b.weight": rng.integers(-100, 100, (7,)).astype(np.int64),
               "c": rng.standard_normal((2, 2, 2)).astype(np.float16),
               "d": rng.integers(0, 255, (4,)).astype(np.uint8),
               "empty": np.zeros((0, 3), np.float32)}
    path = tmp_path / "x.safetensors"
    np_save_file(tensors, str(path), metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].numpy().dtype == v.dtype


def test_safetensors_writer_is_read_by_the_library(tmp_path):
    t = {"x": torch.arange(12, dtype=torch.float32).reshape(3, 4).t(),  # non-contiguous
         "bf": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
         "i": torch.tensor([1, 2, 3], dtype=torch.int32)}
    path = tmp_path / "y.safetensors"
    safetensors_io.save_file(t, path, metadata={"format": "pt"})
    back = safetensors_io.load_file(path)
    for k, v in t.items():
        assert torch.equal(back[k], v)
    sub = tmp_path / "z.safetensors"  # numpy has no bf16: the library reads the rest
    safetensors_io.save_file({"x": t["x"], "i": t["i"]}, sub)
    got = np_load_file(str(sub))
    np.testing.assert_array_equal(got["x"], t["x"].numpy())
    np.testing.assert_array_equal(got["i"], t["i"].numpy())
