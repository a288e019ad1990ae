"""The rank side of `test_torch_mesh.py`: what each spawned rank runs.

Imports torch and the port only (spawned ranks import this module by name),
so the ranks start without JAX. `run_checks` runs every check of one launch
and returns this rank's results; the test module holds them against the JAX
package and the unsharded port.
"""

import numpy as np
import torch
import torch.distributed as dist

from reflectionflow_tpu_torch.config import FluxDiTConfig
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.parallel import collectives
from reflectionflow_tpu_torch.parallel.dryrun import mesh_denoise_check, search_block_check, tiny_pipeline
from reflectionflow_tpu_torch.parallel.mesh import gather_candidates, make_mesh, replicate_params, shard_batch
from reflectionflow_tpu_torch.parallel.specs import shard_dit_params
from reflectionflow_tpu_torch.sampler.generate import denoise

BATCH_KEYS = ("img", "txt", "pooled", "timestep", "guidance", "cond")


def load_pipeline(device, dit_weights):
    """The tiny pipeline (T5, CLIP and VAE from its seed) with the test's DiT,
    moved to this rank's device."""
    pipe = tiny_pipeline("cpu")
    pipe.dit.load_state_dict(dit_weights)
    return pipe.to_device(device)


def tp_dit(weights, mesh):
    dit = FluxDiT(FluxDiTConfig.tiny()).eval().requires_grad_(False)
    dit.load_state_dict(weights)
    return shard_dit_params(dit, mesh)


def run_checks(device, data_path, out_root):
    torch.set_num_threads(1)
    data = torch.load(data_path, weights_only=False)
    world = dist.get_world_size()
    res = {"rank": dist.get_rank()}

    # TP forward on a (world / 2) x 2 data x model mesh, with and without the cond stream
    mesh = make_mesh((world // 2, 2), ("data", "model"))
    dit = tp_dit(data["tp_dit"], mesh)
    res["tp_head_count"] = dit.transformer_blocks[0].cfg.num_heads
    res["tp_param_numel"] = sum(p.numel() for p in dit.parameters())
    cond_view = tp_dit(data["tp_cond_dit"], mesh)  # a separate cond model (a folded LoRA view)
    for name, x in data["tp_inputs"].items():
        x = {k: torch.from_numpy(v) for k, v in x.items()}
        x.update(shard_batch({k: x[k] for k in BATCH_KEYS if k in x}, mesh))
        collectives.reset_counts()
        with torch.no_grad():
            out = dit(**x, attn_impl="pallas", cond_params=cond_view if name == "cond_view" else None)
        res[f"tp_all_reduces_{name}"] = collectives.COUNTS["all_reduce_sum"]
        res[f"tp_{name}"] = gather_candidates(out, mesh).numpy()

    # candidate-sharded generate over a data mesh of every rank
    dmesh = make_mesh((world,), ("data",))
    pipe = load_pipeline(device, data["tp_dit"])
    pipe.attn_impl = "pallas"
    if dist.get_rank() != 0:  # replicate_params gives every rank rank 0's weights back
        with torch.no_grad():
            pipe.dit.proj_out.weight.add_(1.0)
            pipe.vae.decoder.conv_out.weight.add_(1.0)
    collectives.reset_counts()
    replicate_params(pipe.dit, dmesh)
    replicate_params(pipe.vae, dmesh)
    res["replicate_broadcasts"] = collectives.COUNTS["broadcast"]
    res["replicate_params"] = sum(1 for m in (pipe.dit, pipe.vae) for _ in (*m.parameters(), *m.buffers()))
    pipe.set_mesh(dmesh)
    kw = data["generate_kw"]
    collectives.reset_counts()
    res["gen_latents"] = pipe.generate(data["prompts"], latents=data["gen_latents"], **kw)
    res["gen_seed"] = pipe.generate(data["prompts"], seed=7, **kw)
    res["gen_latent_out"] = pipe.generate(data["prompts"], latents=data["gen_latents"],
                                          output_type="latent", **kw).numpy()
    res["gen_counts"] = dict(collectives.COUNTS)

    if world == 2:
        # the dynamic velocity cache under TP: one decision per model group
        tmesh = make_mesh((1, 2), ("data", "model"))
        dit = tp_dit(data["tp_dit"], tmesh)
        v = {k: torch.from_numpy(a) for k, a in data["vcache_inputs"].items()}
        collectives.reset_counts()
        lat, n_full = denoise(dit, v.pop("lat"), v.pop("txt"), v.pop("pooled"), **v,
                              **data["vcache_kw"], return_vcache_stats=True)
        res["vcache"] = (lat.numpy(), n_full, collectives.COUNTS["broadcast"])
        # W8A8 under the model axis: quantize the cut DiT (every linear at min_size 16) and serve
        qpipe = load_pipeline(device, data["tp_dit"])
        qpipe.attn_impl = "pallas"
        qpipe.set_mesh(tmesh)
        qpipe.quantize(min_size=16)
        collectives.reset_counts()
        res["quantized_tp"] = qpipe.generate(data["prompts"], latents=data["gen_latents"],
                                             output_type="latent", **kw).numpy()
        res["quantized_tp_counts"] = dict(collectives.COUNTS)
        res["quantized_tp_layout"] = qpipe.rope_layout
    if world == 4:
        res["search"] = search_block_check(pipe, dmesh, out_root)
        res["denoise"] = mesh_denoise_check(device, mesh)
    res["counts"] = dict(collectives.COUNTS)
    return res


def fail(device):
    """A rank that raises while its peer waits in a collective."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    collectives.all_reduce_sum(torch.zeros(1))
    return np.zeros(1)
