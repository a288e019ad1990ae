"""Dryruns over a mesh of ranks, with tiny fp32 weights.

Counterpart of `__graft_entry__.py`'s `dryrun_multichip` (:60: the corrector
training step on a data x model mesh with the DiT cut for TP and replicated
r=4 adapters; the conditioned denoise with a skipped step at
`vcache_order=2` and the TeaCache schedule, :147-171; `_dryrun_search_block`
:290; `_dryrun_ring_denoise` :205, over a ring of every rank; and
`_dryrun_rm_train_step` :246, FSDP over "data" with the vision adapters)
and `dryrun_multihost` (:354, its worker :426-475: a cross-process sum and
prompt-sharded `run_noise_scaling` whose artifacts equal a one-process
run's).

Each dryrun spawns its ranks with `distributed.launch` (one process per
device; by default `"cuda"` with NCCL, rank i on cuda:i; `device="cpu"`
with gloo, as the tests run them; or `"cuda:0"` with gloo for several
ranks on one card) and raises on a mismatch. Where the
JAX dryruns only check that values are finite, these also hold the sharded
results against the unsharded ones.

    python -c "from reflectionflow_tpu_torch.parallel.dryrun import dryrun_multihost; \\
               print(dryrun_multihost(2, device='cpu'))"
"""

from __future__ import annotations

import copy
import glob
import hashlib
import os
import tempfile
import uuid

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .distributed import launch
from .mesh import gather_candidates, make_mesh, shard_batch
from ..utils import threefry
from .specs import shard_dit_params

ROWS = [{"prompt": f"p{i}", "tag": None} for i in range(4)]


def file_init(root: str) -> str:
    """A fresh file rendezvous under `root`."""
    return f"file://{os.path.join(os.path.abspath(root), 'rdzv-' + uuid.uuid4().hex)}"


def tiny_pipeline(device):
    """The tiny fp32 pipeline of the tests and the CLIs' --synthetic_weights,
    made from seed 0 on `device` (the same weights on every rank)."""
    from ..config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config
    from ..sampler.pipeline import FluxPipeline

    device = torch.device(device)
    return FluxPipeline.random_init(
        torch.Generator(device=device).manual_seed(0), dit_cfg=FluxDiTConfig.tiny(),
        vae_cfg=FluxVAEConfig.tiny(), t5_cfg=T5Config.tiny(), clip_cfg=CLIPTextConfig.tiny(),
        dtype=torch.float32, device=device)


def tiny_tts_cfg(micro: int = 8):
    """16 px, 2 steps, an 8 px condition, 2 rounds of 2 candidates: the JAX
    dryruns' search config, with generate calls of at most `micro`
    candidates."""
    from ..config import TTSConfig

    cfg = TTSConfig()
    cfg.batch_size_for_img_gen = micro
    cfg.pipeline_args.height = cfg.pipeline_args.width = 16
    cfg.pipeline_args.num_inference_steps = 2
    cfg.pipeline_args.condition_size = 8
    cfg.search_args.search_rounds = cfg.search_args.search_branch = 2
    return cfg


def tree_digest(root: str) -> dict[str, str]:
    """relative path -> sha256 of every file under `root`."""
    digest = {}
    for dirpath, _dirs, files in os.walk(root):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            with open(path, "rb") as f:
                digest[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return digest


def compare_trees(ref_root: str, got_root: str) -> dict:
    """Raise unless both trees hold the same files, the PNGs byte for byte
    and the others (JSON, JSONL: names, seeds, selections; each tree's root
    in the paths they hold read as one name) equal; the error names the
    PNGs' max |pixel diff|. Returns the file count, that diff and whether
    every PNG matched."""
    from ..search.artifacts import load_image

    ref, got = tree_digest(ref_root), tree_digest(got_root)
    if not ref:
        raise AssertionError(f"{ref_root} holds no artifact")
    if set(ref) != set(got):
        raise AssertionError(f"artifact sets differ: only in the reference "
                             f"{sorted(set(ref) - set(got))[:5]}, only in the run "
                             f"{sorted(set(got) - set(ref))[:5]}")

    def text(root, k):
        with open(os.path.join(root, k)) as f:
            return f.read().replace(root, "<root>")

    differ = sorted(k for k in ref if ref[k] != got[k])
    pngs = [k for k in differ if k.endswith(".png")]
    bad = [k for k in differ if not k.endswith(".png") and text(ref_root, k) != text(got_root, k)]
    diff = 0
    for k in pngs:
        a, b = (load_image(os.path.join(r, k)).astype(np.int16) for r in (ref_root, got_root))
        diff = max(diff, int(np.abs(a - b).max()))
    if bad or pngs:
        raise AssertionError(f"artifacts differ: {(bad + pngs)[:10]}; PNG max |pixel diff| {diff}")
    return {"files": len(ref), "png_max_diff": diff, "identical": not pngs}


# -- the search block on a data mesh (JAX `_dryrun_search_block` :290) --------


def search_block_check(pipe, mesh, out_root: str) -> dict:
    """Run `run_reflectionflow_block` (the fake models, `tiny_tts_cfg()`,
    `ROWS`) unsharded on rank 0 alone, then on every rank with
    `pipe.mesh = mesh`; rank 0 holds the two artifact trees against each
    other (`compare_trees`). Called on every rank of the mesh; returns rank
    0's comparison (None elsewhere).

    The unsharded run generates in micro-batches of one data slice, so each
    candidate meets the same shapes in both runs: a matmul's last bit may
    depend on its batch, and the fake verifier's hash of the pixels turns any
    flipped pixel into another selection."""
    from ..reflect import FakeReflector, FakeRefiner
    from ..search.reflectionflow import run_reflectionflow_block
    from ..verifiers import FakeVerifier

    cfg = tiny_tts_cfg()
    models = (FakeVerifier(), FakeReflector(), FakeRefiner())
    base, sharded = os.path.join(out_root, "base"), os.path.join(out_root, "mesh")
    base_cfg = copy.deepcopy(cfg)
    base_cfg.batch_size_for_img_gen = max(1, cfg.batch_size_for_img_gen // mesh.axis_size("data"))
    saved, pipe.mesh = pipe.mesh, None
    try:
        if mesh.rank == 0:
            run_reflectionflow_block(pipe, *models, base_cfg, ROWS, base, run_seed=5)
        dist.barrier()
        pipe.mesh = mesh
        run_reflectionflow_block(pipe, *models, cfg, ROWS, sharded, run_seed=5)
    finally:
        pipe.mesh = saved
    if mesh.rank != 0:
        return None
    out = compare_trees(base, sharded)
    for i in range(len(ROWS)):
        names = sorted(glob.glob(os.path.join(sharded, f"{i:05d}", "midimg", "*.png")))
        if len(names) < 2 * cfg.search_args.search_branch:
            raise AssertionError(f"prompt {i}: {len(names)} midimg candidates")
    return out


# -- the training step on a data x model mesh (JAX :60-146) ------------------


def train_step_check(device, mesh) -> dict:
    """One corrector training step of the tiny DiT cut over the mesh's
    "model" axis, with replicated r=4 adapters (non-zero B, so every adapter
    moves) and B = 2 per data slice (each rank passes its slice), against the
    same step unsharded on this rank (the global batch): the loss, and the
    adapters' max |diff|."""
    from ..config import FluxDiTConfig, TrainConfig
    from ..lora.lora import lora_init, lora_parameters
    from ..models.flux.dit import FluxDiT
    from ..models.flux.rope import make_image_ids, make_text_ids
    from ..sampler.pipeline import _build
    from ..train.rectified_flow import make_optimizer, make_train_step

    cfg = FluxDiTConfig.tiny()
    tcfg = TrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr = "sgd", 0.5

    def fresh():
        dit = _build(FluxDiT, cfg, torch.float32, device, torch.Generator(device=device).manual_seed(0))
        return dit.requires_grad_(False)

    B, ty, tx, cty, Lt = 2 * mesh.axis_size("data"), 4, 4, 2, 8
    gen = torch.Generator().manual_seed(2)
    batch = {k: torch.randn(shape, generator=gen).to(device) for k, shape in (
        ("x0", (B, ty * tx, cfg.in_channels)), ("cond", (B, cty * cty, cfg.in_channels)),
        ("txt", (B, Lt, cfg.text_dim)), ("pooled", (B, cfg.pooled_dim)))}
    batch.update(img_ids=torch.from_numpy(make_image_ids(ty, tx)).to(device),
                 txt_ids=torch.from_numpy(make_text_ids(Lt)).to(device),
                 cond_ids=torch.from_numpy(make_image_ids(cty, cty, position_delta=(0, -cty))).to(device))

    def run(dit, on):
        lora = lora_init(threefry.prng_key(1), dit, r=4, alpha=4)
        with torch.no_grad():
            noise = torch.Generator(device=device).manual_seed(3)
            for ab in lora["adapters"].values():
                ab["lora_B"].normal_(0.0, 0.05, generator=noise)
        optimizer = make_optimizer(tcfg)
        state = optimizer.init(lora_parameters(lora))
        step = make_train_step(dit, optimizer, alpha=4, r=4, mesh=on)
        mine = dict(batch, **shard_batch({k: batch[k] for k in ("x0", "cond", "txt", "pooled")}, on)) \
            if on is not None else batch
        adapters, _, metrics = step(lora["adapters"], state, mine, threefry.prng_key(6))
        return adapters, float(metrics["loss"])

    want, want_loss = run(fresh(), None)
    dit = shard_dit_params(fresh(), mesh)
    got, loss = run(dit, mesh)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the mesh training step: {loss}")
    diff = max(float((got[n][k] - want[n][k]).detach().abs().max()) for n in want for k in ("lora_A", "lora_B"))
    return {"loss": loss, "loss_unsharded": want_loss, "adapter_max_abs_diff": diff}


# -- the reward-model step, FSDP over "data" (JAX `_dryrun_rm_train_step` :246)


def rm_train_step_check(device, mesh) -> dict:
    """One reward-model step of the tiny Qwen2.5-VL with its frozen LM and
    tower sharded FSDP over "data" (one pair a rank), the LM and vision
    adapters, the head and the special row trained, against the same step
    on this rank's whole model: the loss and the trainables' max |diff|, and
    the LM's bytes on this rank against the whole's."""
    from ..models.qwen_vl.model import QwenVLModel
    from ..rm_train import train as rt
    from ..rm_train.data import collate_rm_batch, vision_train_geometry
    from ..train.optim import flatten_tree
    from .specs import fsdp_local_bytes

    rng = np.random.default_rng(0)
    rows = [{"image_A": rng.integers(0, 255, (24, 24, 3), dtype=np.uint8),
             "image_B": rng.integers(0, 255, (24, 24, 3), dtype=np.uint8),
             "prompt": f"p{i}", "gsb": "G", "score_A": 4.0, "score_B": 2.0}
            for i in range(mesh.axis_size("data"))]

    def run(on):
        model = QwenVLModel.random_init(torch.Generator(device=device).manual_seed(0), dtype=torch.float32,
                                        device=device)
        batch = collate_rm_batch(model, rows, max_pixels=256, special_token_id=9, train_vision=True)
        key = threefry.prng_key(1)
        H = model.lm_cfg.hidden_size
        trainable = {"lora": rt.rm_lora_init(key, model.model, r=2, alpha=2)["adapters"],
                     "rm_head": threefry.normal(threefry.fold_in(key, 1), (H, 1), device=device) * 0.1,
                     "special": threefry.normal(threefry.fold_in(key, 2), (H,), device=device) * 0.02,
                     "vision_lora": rt.rm_vision_lora_init(threefry.fold_in(key, 3), model.visual, r=2,
                                                           alpha=2)["adapters"]}
        opt = rt.make_rm_optimizer(lr=1e-2, vision_lr=1e-3)
        whole = fsdp_local_bytes(model.model)
        step = rt.make_rm_train_step(model.model, opt, loss_type="btt", pooling="special", special_token_id=9,
                                     r=2, alpha=2, tower=model.visual,
                                     grid_thw=vision_train_geometry(model.vis_cfg, 256)[1], mesh=on)
        trainable, _, aux = step(trainable, opt.init(trainable), batch)
        return flatten_tree(trainable), float(aux["loss"]), whole, fsdp_local_bytes(model.model)

    want, want_loss, _, _ = run(None)
    got, loss, whole, mine = run(mesh)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite reward-model loss on the mesh: {loss}")
    diff = max(float((got[k] - want[k]).detach().abs().max()) for k in want)
    return {"loss": loss, "loss_unsharded": want_loss, "trainable_max_abs_diff": diff,
            "lm_bytes": mine, "lm_bytes_whole": whole}


# -- the ring denoise over a ring of ranks (JAX `_dryrun_ring_denoise` :205) -


def ring_denoise_check(device, mesh) -> dict:
    """The conditioned denoise with the structural cond mask
    (`union_cond_attn=False`) under ring attention over the "seq" axis of
    `mesh` (a `RankMesh`; every rank of it calls this), against the dense
    "xla" denoise on this rank: the max |diff| (JAX holds it within 2e-4)."""
    from ..config import FluxDiTConfig
    from ..models.flux.dit import FluxDiT
    from ..models.flux.rope import make_image_ids, make_text_ids
    from ..ops.attention import set_ring_context
    from ..sampler.generate import denoise, make_schedule
    from ..sampler.pipeline import _build

    cfg = FluxDiTConfig(in_channels=4, hidden_size=32, num_heads=2, head_dim=16, mlp_ratio=2.0,
                        num_double_blocks=1, num_single_blocks=1, text_dim=16, pooled_dim=8,
                        axes_dims_rope=(4, 6, 6), time_freq_dim=16)
    dit = _build(FluxDiT, cfg, torch.float32, device, torch.Generator(device=device).manual_seed(0))
    B, Lt, ty, tx, cty, ctx = 1, 8, 4, 4, 2, 4  # joint sequence 8 + 16 + 8 = 32
    gen = torch.Generator().manual_seed(1)
    lat, txt, pooled, cond = (torch.randn(shape, generator=gen).to(device) for shape in (
        (B, ty * tx, cfg.in_channels), (B, Lt, cfg.text_dim), (B, cfg.pooled_dim),
        (B, cty * ctx, cfg.in_channels)))
    kw = dict(img_ids=torch.from_numpy(make_image_ids(ty, tx)).to(device),
              txt_ids=torch.from_numpy(make_text_ids(Lt)).to(device), sigmas=make_schedule(2, ty * tx),
              guidance_scale=3.5, num_steps=2, cond=cond,
              cond_ids=torch.from_numpy(make_image_ids(cty, ctx, position_delta=(0, -ctx))).to(device),
              union_cond_attn=False)
    ref = denoise(dit, lat, txt, pooled, attn_impl="xla", **kw)
    set_ring_context(mesh, "seq")
    shifts = collectives.COUNTS["ring_shift"]
    try:
        out = denoise(dit, lat, txt, pooled, attn_impl="ring", **kw)
    finally:
        set_ring_context(None)
    diff = float((out - ref).abs().max())
    if diff > 2e-4:
        raise AssertionError(f"ring denoise differs from the dense one by {diff}")
    return {"ranks": mesh.axis_size("seq"), "max_abs_diff": diff,
            "ring_shifts": collectives.COUNTS["ring_shift"] - shifts}


# -- the conditioned denoise on a data x model mesh (JAX :147-171) -----------


def mesh_denoise_check(device, mesh) -> dict:
    """The tiny DiT's conditioned denoise, B = 2 per data slice, 4 steps: with
    a skipped step after two full ones at `vcache_order=2`, and under the
    TeaCache schedule (dynamic threshold, residual cache), sharded over the
    mesh (candidates over "data", heads over "model") against the same calls
    unsharded on this rank. Returns the max |diff| and each run's n_full."""
    from ..config import FluxDiTConfig
    from ..models.flux.dit import FluxDiT
    from ..models.flux.rope import make_image_ids, make_text_ids
    from ..sampler.generate import denoise, make_schedule, vcache_kwargs
    from ..sampler.pipeline import _build
    from ..sampler.vcache_calibrate import teacache_flux_schedule

    cfg = FluxDiTConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    dit = _build(FluxDiT, cfg, torch.float32, device, torch.Generator(device=device).manual_seed(0))
    B = 2 * mesh.axis_size("data")
    ty = tx = 4
    Lt, cty = 8, 2
    x = {k: torch.randn(shape, generator=gen).to(device) for k, shape in (
        ("lat", (B, ty * tx, cfg.in_channels)), ("cond", (B, cty * cty, cfg.in_channels)),
        ("txt", (B, Lt, cfg.text_dim)), ("pooled", (B, cfg.pooled_dim)))}
    common = dict(img_ids=torch.from_numpy(make_image_ids(ty, tx)).to(device),
                  txt_ids=torch.from_numpy(make_text_ids(Lt)).to(device),
                  sigmas=make_schedule(4, ty * tx), guidance_scale=3.5, num_steps=4,
                  cond_ids=torch.from_numpy(make_image_ids(cty, cty, position_delta=(0, -cty))).to(device),
                  return_vcache_stats=True)
    modes = {"taylor2": dict(step_mask=np.array([True, True, False, True]), vcache_order=2),
             "teacache": vcache_kwargs(teacache_flux_schedule(), 4)}

    def run(dit, x, kw):
        return denoise(dit, x["lat"], x["txt"], x["pooled"], cond=x["cond"], **common, **kw)

    ref = {name: run(dit, x, kw) for name, kw in modes.items()}
    shard_dit_params(dit, mesh)
    mine = shard_batch(x, mesh)
    out = {}
    for name, kw in modes.items():
        lat, n_full = run(dit, mine, kw)
        lat = gather_candidates(lat, mesh)
        if not torch.isfinite(lat).all():
            raise AssertionError(f"{name}: non-finite sharded denoise")
        out[name] = {"max_abs_diff": float((lat - ref[name][0]).abs().max()), "n_full": n_full,
                     "n_full_unsharded": ref[name][1]}
    return out


def _multichip_rank(device, shape, out_root):
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    train = train_step_check(device, mesh)
    denoise = mesh_denoise_check(device, mesh)
    data_mesh = make_mesh((dist.get_world_size(),), ("data",))
    search = search_block_check(tiny_pipeline(device), data_mesh, out_root)
    rm = rm_train_step_check(device, data_mesh)
    ring = ring_denoise_check(device, make_mesh((dist.get_world_size(),), ("seq",)))
    return {"train": train, "denoise": denoise, "search_block": search, "rm_train": rm, "ring": ring,
            "counts": dict(collectives.COUNTS)}


def dryrun_multichip(world_size: int = 4, *, device="cuda", backend: str | None = None,
                     workdir: str | None = None) -> dict:
    """The JAX `dryrun_multichip` on `world_size` ranks: a (world/2, 2) data x
    model mesh (tensor parallelism needs an even world; an odd world runs
    data alone) for the training step and the denoise check, a data mesh of
    every rank for the search block and the FSDP reward-model step, and a
    ("seq",) ring of every rank for the ring denoise (its joint sequence of
    32 tokens must divide by the world). Raises on a mismatch (the training
    step: adapters 1e-5 from the unsharded step's; the denoise: a max |diff|
    above 1e-4 or another n_full; the reward step: trainables 1e-5 from the
    unsharded's; the ring denoise: 2e-4 from the dense one); the result's
    "summary" names each half, as JAX's line does."""
    tp = 2 if world_size % 2 == 0 else 1
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        results = launch(_multichip_rank, world_size, args=((world_size // tp, tp), td),
                         backend=backend, device=device, init_method=file_init(td))
    r0 = results[0]
    for name, r in r0["denoise"].items():
        if r["max_abs_diff"] > 1e-4 or r["n_full"] != r["n_full_unsharded"]:
            raise AssertionError(f"sharded denoise {name} differs from the unsharded one: {r}")
    if r0["train"]["adapter_max_abs_diff"] > 1e-5:
        raise AssertionError(f"the mesh training step differs from the unsharded one: {r0['train']}")
    if r0["rm_train"]["trainable_max_abs_diff"] > 1e-5:
        raise AssertionError(f"the FSDP reward-model step differs from the unsharded one: {r0['rm_train']}")
    ring = r0["ring"]
    mesh = (world_size // tp, tp)
    summary = (f"dryrun_multichip ok: mesh=({mesh[0]}x{mesh[1]}) loss={r0['train']['loss']:.4f} "
               f"denoise={sorted(r0['denoise'])} search_block={r0['search_block']['files']} files identical "
               f"ring_sp=masked-denoise-matches-dense({ring['ranks']}ranks) "
               f"rm_train=fsdp-vision-lora-step({world_size}ranks,loss={r0['rm_train']['loss']:.3f})")
    return {"mesh": mesh, **r0, "summary": summary}


# -- prompt-sharded noise scaling across processes (JAX :354-475) ------------


def _multihost_rank(device, out_dir):
    from ..search.noise_scaling import run_noise_scaling

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    # each rank contributes its own slice of arange(world): the sum is world*(world-1)/2
    part = torch.tensor([float(rank)], device=device)
    total = float(collectives.all_reduce_sum(part).item())
    if total != world * (world - 1) / 2:
        raise AssertionError(f"all_reduce_sum gave {total} on rank {rank} of {world}")
    pipe = tiny_pipeline(device)
    lo, hi = rank * len(ROWS) // world, (rank + 1) * len(ROWS) // world
    # candidate seeds are pure functions of the global prompt index; one
    # prompt's candidates a generate call, so every world meets the same shapes
    cfg = tiny_tts_cfg(micro=2)
    run_noise_scaling(pipe, cfg, ROWS[lo:hi], out_dir, start_index=lo, run_seed=5)
    return {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(device),
            "sum": total, "prompts": [lo, hi], "counts": dict(collectives.COUNTS)}


def dryrun_multihost(n_processes: int = 2, *, device="cuda", backend: str | None = None,
                     workdir: str | None = None, reference: str | None = None) -> dict:
    """`n_processes` ranks, each with its own process group membership: one
    cross-rank `all_reduce_sum` check, then `run_noise_scaling` over a
    rank-contiguous shard of the prompts (`ROWS[lo:hi]`, `start_index=lo`)
    into one output tree, which must equal a one-rank run's byte for byte
    (`compare_trees`). `reference` names a one-rank tree to compare with (kept
    there), else one is made in a world of 1 first. Raises on a mismatch;
    returns each rank's result and the comparison."""
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        if reference is None:
            reference, _ = multihost_reference(td, device=device, backend=backend)
        got = os.path.join(td, "mh")
        ranks = launch(_multihost_rank, n_processes, args=(got,), backend=backend,
                       device=device, init_method=file_init(td))
        return {"ranks": ranks, "compare": compare_trees(reference, got)}


def multihost_reference(root: str, *, device="cuda", backend: str | None = None) -> tuple[str, dict]:
    """The one-rank tree `dryrun_multihost(reference=...)` compares with,
    written under `root` by a world of 1; returns its path and the rank's
    result."""
    out = os.path.join(root, f"ref-{uuid.uuid4().hex}")
    (rank,) = launch(_multihost_rank, 1, args=(out,), backend=backend, device=device,
                     init_method=file_init(root))
    return out, rank
