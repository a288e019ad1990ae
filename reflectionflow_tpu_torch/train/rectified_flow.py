"""Rectified-flow LoRA training of the FLUX-Corrector.

Counterpart of `reflectionflow_tpu/train/rectified_flow.py`:
  * x_0 = VAE-encoded good image (packed tokens), x_1 ~ N(0, I);
  * t = sigmoid(N(0, 1)) per sample; x_t = (1 - t) x_0 + t x_1;
  * the condition stream is the VAE-encoded bad image with its position delta,
    at cond timestep 0; T5 encodes the description ("{prompt} [Reflexion]
    {reflection}"), CLIP pools the original prompt; guidance = 1.0;
  * loss = MSE(v_pred, x_1 - x_0) in fp32.

The base DiT is frozen; the fp32 LoRA adapters are the only trainable
tensors. They are attached as low-rank adds (`lora.attach_lora`), which the
condition stream reads (and the image stream too with `latent_lora=True`);
every block is recomputed in the backward pass. With attn_impl="pallas" the
attention runs K1 forward and K6a/K6b backward; "ring" / "ring_pallas" run
sequence-parallel ring attention (`ops.ring_attention`, K7a forward and
K7b/K7c backward under "ring_pallas") over the mesh that
`ops.attention.set_ring_context` names.

Over a mesh of ranks (`make_train_step(mesh=)`, a `parallel.mesh.RankMesh`)
each rank passes its slice over "data" of the global batch, the slice JAX's
`P("data")` sharding constraint gives its devices; `t` and the noise are
drawn for the whole global batch from the one generator on every rank, then
sliced, so the step is the one-device step on the global batch. A DiT cut
over "model" (`parallel.specs.shard_dit_params`) runs its heads' share, K1
and K6 at H / tp heads. The gradients, and the loss, are all-reduced in one bucket
(`collectives.reduce_gradients`: a mean over "data", a sum over "model" of
the adapters of cut linears) before the optimizer's global-norm clip, as
XLA's all-reduce precedes optax's clip; every rank then applies the same
update to the same adapters. With a "seq" axis and a ring impl
(`set_ring_context(mesh, "seq")`), the ranks of a seq line pass the same
slice and each runs its chunk of every attention (K7a, K7b/K7c under
"ring_pallas"); the ring joins the results over the line, so those ranks
hold the same gradients and the bucket reduces over "data" and "model"
only.
"""

from __future__ import annotations

from typing import Any

import torch

from ..lora.lora import attach_lora, lora_parameters
from ..models.flux.latents import pack_latents
from ..models.flux.rope import make_image_ids, make_text_ids
from ..models.flux.vae import vae_encode
from ..parallel.collectives import reduce_gradients
from ..parallel.mesh import candidate_sharding
from . import optim

TRAINABLE_ATTN = ("xla", "pallas", "ring", "ring_pallas")


def rf_loss(adapters: dict, dit, batch: dict, generator: torch.Generator | None = None,
            alpha: float = 32.0, r: int = 32, latent_lora: bool = False,
            model_flags: dict | None = None, attn_impl: str = "xla",
            t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
    """-> (loss, metrics) for batch {x0 (B, L, C), cond (B, Lc, C), txt (B, Lt,
    D), pooled (B, P), img_ids (L, 3), txt_ids (Lt, 3), cond_ids (Lc, 3)}.

    `t` (B,) and `noise` (the shape of x0) are drawn from `generator` unless
    given (tests pass the JAX package's draws)."""
    model_flags = model_flags or {}
    x0 = batch["x0"].float()
    B = x0.shape[0]
    if t is None:
        t = torch.sigmoid(torch.randn((B,), generator=generator, device=generator.device))
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=generator.device)
    t, x1 = t.to(x0.device, torch.float32), noise.to(x0.device, torch.float32)
    x_t = ((1.0 - t[:, None, None]) * x0 + t[:, None, None] * x1).to(batch["x0"].dtype)

    # per-layer low-rank adds: W + AB is never materialised
    attached = attach_lora(dit, {"_alpha": alpha, "_r": r, "adapters": adapters})
    main = attached if latent_lora else dit
    guidance = torch.ones((B,), dtype=x_t.dtype, device=x_t.device) \
        if dit.cfg.guidance_embeds else None
    pred = main(
        x_t, batch["txt"], batch["pooled"], t, batch["img_ids"], batch["txt_ids"],
        guidance=guidance, cond=batch["cond"], cond_ids=batch["cond_ids"], cond_params=attached,
        union_cond_attn=model_flags.get("union_cond_attn", True),
        add_cond_attn=model_flags.get("add_cond_attn", False),
        attn_impl=attn_impl, remat=True,
    )
    target = (x1 - x0).float()
    loss = torch.mean((pred.float() - target) ** 2)
    return loss, {"loss": loss.detach(), "t_mean": t.mean()}


def make_train_step(dit, optimizer, alpha: float = 32.0, r: int = 32, latent_lora: bool = False,
                    model_flags: dict | None = None, attn_impl: str = "xla", mesh=None):
    """-> `step(adapters, opt_state, batch, generator) -> (adapters, opt_state,
    metrics)`: loss and adapter gradients, the gradient norm before clipping,
    and the optimizer update applied to the adapters in place. `optimizer`
    must be the transformation whose `init` made `opt_state`
    (`make_optimizer`).

    `mesh` (a `RankMesh`; every rank calls the step): `batch` is this rank's
    slice over "data" of the global batch (`parallel.mesh.shard_batch` of its
    batch-leading tensors); `t` and `noise`, drawn or given, cover the global
    batch. The metrics are the global batch's."""
    if attn_impl not in TRAINABLE_ATTN:
        raise ValueError(f"attn_impl={attn_impl!r} has no backward pass in the port; training "
                         f"supports {TRAINABLE_ATTN}")
    sharded = mesh is not None and mesh.size > 1
    modules = dict(dit.named_modules())

    def draw(x0, generator, t, noise):
        """The global batch's t, and this rank's rows of t and the noise."""
        B = x0.shape[0] * mesh.axis_size("data")
        if t is None:
            t = torch.sigmoid(torch.randn((B,), generator=generator, device=generator.device))
        if noise is None:
            noise = torch.randn((B, *x0.shape[1:]), generator=generator, device=generator.device)
        rows = candidate_sharding(mesh, B)
        return t, t[rows], noise[rows]

    def step(adapters, opt_state, batch, generator=None, t=None, noise=None):
        params = lora_parameters({"adapters": adapters})
        t_all = t
        if sharded:
            t_all, t, noise = draw(batch["x0"], generator, t, noise)
        loss, metrics = rf_loss(adapters, dit, batch, generator, alpha=alpha, r=r,
                                latent_lora=latent_lora, model_flags=model_flags,
                                attn_impl=attn_impl, t=t, noise=noise)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        if sharded:
            partial = [hasattr(modules[name], "tp_cut") for name in adapters for _ in (0, 1)]
            grads, (loss,) = reduce_gradients(grads, partial, mesh, [loss.detach()])
            metrics = {"loss": loss, "t_mean": t_all.to(loss.device).mean()}
        gnorm = optim.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        optim.apply_updates(params, updates)
        return adapters, opt_state, dict(metrics, grad_norm=gnorm)

    return step


@torch.no_grad()
def prepare_batch_tensors(pipeline, batch: dict[str, Any], position_delta: tuple[int, int]):
    """Collated raw samples -> device tensors for `rf_loss`.

    batch: {"image": (B, H, W, 3) float in [-1, 1], "condition": (B, Hc, Wc,
    3), "original_prompt": [str], "description": [str]} (`train.data`)."""
    dev, dtype = pipeline.device, pipeline.dtype
    x0_grid = vae_encode(pipeline.vae, torch.as_tensor(batch["image"]).to(dev, dtype))
    cond_grid = vae_encode(pipeline.vae, torch.as_tensor(batch["condition"]).to(dev, dtype))
    # CLIP pools the original prompt; T5 encodes the description
    txt, pooled = pipeline.encode_prompts(list(batch["original_prompt"]), 512,
                                          prompts_2=list(batch["description"]))
    img_ids = make_image_ids(x0_grid.shape[1] // 2, x0_grid.shape[2] // 2)
    cond_ids = make_image_ids(cond_grid.shape[1] // 2, cond_grid.shape[2] // 2,
                              position_delta=position_delta)
    return {
        "x0": pack_latents(x0_grid).to(dtype),
        "cond": pack_latents(cond_grid).to(dtype),
        "txt": txt.to(dtype),
        "pooled": pooled.to(dtype),
        "img_ids": torch.from_numpy(img_ids).to(dev),
        "txt_ids": torch.from_numpy(make_text_ids(txt.shape[1])).to(dev),
        "cond_ids": torch.from_numpy(cond_ids).to(dev),
    }


def make_optimizer(cfg):
    """The optimizer with gradient clipping chained before it and gradient
    accumulation around both (`TrainConfig.optimizer`)."""
    o = cfg.optimizer
    if o.name == "prodigy":
        base = optim.prodigy(learning_rate=o.lr, weight_decay=o.weight_decay, safeguard_warmup=True)
    elif o.name == "adamw":
        base = optim.adamw(o.lr, weight_decay=o.weight_decay)
    elif o.name == "sgd":
        base = optim.sgd(o.lr)
    else:
        raise ValueError(f"unknown optimizer {o.name}")
    if o.grad_clip and o.grad_clip > 0:
        base = optim.chain(optim.clip_by_global_norm(o.grad_clip), base)
    if o.grad_accum and o.grad_accum > 1:
        base = optim.MultiSteps(base, every_k_schedule=o.grad_accum)
    return base
