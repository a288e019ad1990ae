"""The rank side of `test_torch_ring_ranks.py`: what each spawned rank runs.

Imports torch and the port only (spawned ranks import this module by name),
so the ranks start without JAX. `run_world` runs the checks a data file
names and returns this rank's results as numpy arrays; the test module holds
them against the JAX package and against the port's one-process ring.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from reflectionflow_tpu_torch.config import FluxDiTConfig, TrainConfig
from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
from reflectionflow_tpu_torch.ops.attention import set_ring_context
from reflectionflow_tpu_torch.ops.ring_attention import ring_attention
from reflectionflow_tpu_torch.parallel import collectives
from reflectionflow_tpu_torch.parallel.mesh import make_mesh, shard_batch
from reflectionflow_tpu_torch.parallel.specs import shard_dit_params
from reflectionflow_tpu_torch.sampler.generate import denoise, vcache_kwargs
from reflectionflow_tpu_torch.sampler.vcache_calibrate import teacache_flux_schedule
from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _one_process_ring(p):
    return make_mesh((p,), ("seq",), devices=[CPU] * p)


def attention(data: dict, arg) -> dict:
    """`ring_attention` on the "seq" axis of a mesh of `shape` and `names`,
    for each (impl, cross form): the output, the gradients of sum(out * g),
    the ring shifts of the call, and whether output and gradients equal the
    one-process ring's on the same inputs bit for bit."""
    shape, names, cases = arg
    mesh = make_mesh(shape, names)
    p = mesh.axis_size("seq")
    x = data["attn"]
    q, k, v, g = (_t(x[n]) for n in "qkvg")
    out = {}
    for impl, main_len, cross in cases:
        def run(on):
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ring_attention(*xs, on, "seq", impl, main_len, cross)
            return o.detach(), torch.autograd.grad(o, xs, g)

        collectives.reset_counts()
        got, grads = run(mesh)
        shifts = collectives.COUNTS["ring_shift"]
        want, want_grads = run(_one_process_ring(p))
        out[(impl, main_len, cross)] = {
            "out": got.numpy(), "grads": [a.numpy() for a in grads], "ring_shift": shifts,
            "bitwise": bool(torch.equal(got, want)) and all(torch.equal(a, b) for a, b in zip(grads, want_grads))}
    return out


def _dit(data: dict) -> FluxDiT:
    dit = FluxDiT(FluxDiTConfig(**data["cfg"])).eval().requires_grad_(False)
    dit.load_state_dict({k: _t(v) for k, v in data["dit"].items()})
    return dit


def ring_denoise(data: dict, arg) -> dict:
    """The 2-step conditioned denoise (`union_cond_attn=False`) under `impl`
    with the ring over the "seq" axis of a mesh of `shape` and `names` (the
    DiT cut over "model" when the mesh has it), and, without a "model" axis,
    the same under the one-process ring of as many slots."""
    shape, names, impl = arg
    mesh = make_mesh(shape, names)
    dit = _dit(data)
    x = {k: _t(v) for k, v in data["denoise"].items()}
    args = [x.pop(k) for k in ("lat", "txt", "pooled", "img_ids", "txt_ids", "sigmas")]

    def run(on):
        set_ring_context(on, "seq")
        try:
            return denoise(dit, *args, 3.5, 2, **x, union_cond_attn=False, attn_impl=impl)
        finally:
            set_ring_context(None)

    res = {}
    if mesh.axis_size("model") == 1:
        res["one_process"] = run(_one_process_ring(mesh.axis_size("seq"))).numpy()
    else:
        shard_dit_params(dit, mesh)
    collectives.reset_counts()
    res["latents"] = run(mesh).numpy()
    res["counts"] = dict(collectives.COUNTS)
    return res


def train_step(data: dict, arg) -> dict:
    """One corrector step (sgd, the default clip) under "ring_pallas" from the
    test's DiT, adapters, t and noise: over a (data, seq) mesh of ranks with
    the rank ring, or (`one_process`) over a ("data",) mesh of ranks with the
    one-process ring of `p` slots; each rank passes its data slice."""
    shape, names, one_process = arg
    mesh = make_mesh(shape, names)
    ring = _one_process_ring(one_process) if one_process else mesh
    dit = _dit(data)
    adapters = {n: {k: torch.nn.Parameter(_t(v)) for k, v in ab.items()} for n, ab in data["adapters"].items()}
    tcfg = TrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr = "sgd", data["lr"]
    optimizer = make_optimizer(tcfg)
    state = optimizer.init([t for ab in adapters.values() for t in ab.values()])
    step = make_train_step(dit, optimizer, alpha=data["alpha"], r=data["r"], attn_impl="ring_pallas", mesh=mesh)
    batch = {k: _t(v) for k, v in data["batch"].items()}
    batch.update(shard_batch({k: batch[k] for k in ("x0", "cond", "txt", "pooled")}, mesh))
    set_ring_context(ring, "seq")
    collectives.reset_counts()
    try:
        adapters, _, metrics = step(adapters, state, batch, t=_t(data["t"]), noise=_t(data["noise"]))
    finally:
        set_ring_context(None)
    return {"adapters": {n: {k: v.detach().numpy().copy() for k, v in ab.items()} for n, ab in adapters.items()},
            "metrics": {k: float(v) for k, v in metrics.items()}, "counts": dict(collectives.COUNTS)}


def serve(data: dict, arg) -> dict:
    """The tiny pipeline served over a ("seq",) mesh of every rank
    (`set_mesh`, `set_ring_context`, attn_impl "ring"): `generate` from the
    test's latents, against the same call under "xla" on this rank; and the
    TeaCache schedule's dynamic denoise under the ring, with its n_full,
    against "xla"'s."""
    from reflectionflow_tpu_torch.parallel.dryrun import tiny_pipeline

    mesh = make_mesh((dist.get_world_size(),), ("seq",))
    pipe = tiny_pipeline("cpu")
    kw = data["generate_kw"]
    res = {}
    pipe.attn_impl = "xla"
    res["dense"] = pipe.generate(data["prompts"], latents=data["gen_latents"], output_type="latent", **kw).numpy()
    pipe.set_mesh(mesh)
    pipe.attn_impl = "ring"
    set_ring_context(mesh, "seq")
    collectives.reset_counts()
    try:
        res["ring"] = pipe.generate(data["prompts"], latents=data["gen_latents"], output_type="latent", **kw).numpy()
        res["counts"] = dict(collectives.COUNTS)
        dit = _dit(data)
        x = {k: _t(v) for k, v in data["denoise"].items()}
        args = [x.pop(k) for k in ("lat", "txt", "pooled", "img_ids", "txt_ids", "sigmas")]
        x.pop("cond"), x.pop("cond_ids")
        args[-1] = _t(data["vcache_sigmas"])
        steps = len(args[-1]) - 1
        vc = vcache_kwargs(teacache_flux_schedule(), steps)
        for impl in ("xla", "ring"):
            lat, n_full = denoise(dit, *args, 3.5, steps, **x, **vc, attn_impl=impl, return_vcache_stats=True)
            res[f"vcache_{impl}"] = (lat.numpy(), int(n_full))
    finally:
        set_ring_context(None)
    return res


def fail_in_ring(data: dict, arg) -> None:
    """Rank 1 raises (`arg` "raise") or stalls (`arg` "stall") while rank 0
    waits in the ring's first shift."""
    if dist.get_rank() == 1:
        if arg == "raise":
            raise ValueError("rank 1 gives up before the ring")
        time.sleep(120)
    attention(data, ((2,), ("seq",), [("pallas", None, 0.0)]))


def run_world(device, data_path: str) -> dict:
    """Every check of one launch, by the names in the data file's "checks"."""
    torch.set_num_threads(1)
    data = torch.load(data_path, weights_only=False)
    out = {"rank": dist.get_rank()}
    for name, kind, arg in data["checks"]:
        fn = {"attention": attention, "denoise": ring_denoise, "train": train_step, "serve": serve,
              "fail": fail_in_ring}[kind]
        out[name] = fn(data, arg)
    return out
