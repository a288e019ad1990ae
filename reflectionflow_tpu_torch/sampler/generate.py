"""The FLUX sampling loop, with the velocity cache.

Counterpart of `reflectionflow_tpu/sampler/generate.py::denoise`: a Python
loop over the precomputed sigma schedule where the reference has a
`lax.scan`, with the optional condition stream and image CFG (the
conditional and black-condition branches as one doubled batch), and the
velocity cache in all its modes (training-free step skipping, the
DeepCache/TeaCache/TaylorSeer family): a static `step_mask` or TeaCache's
dynamic threshold decides which steps run the DiT; a skipped step reuses the
last velocity (`vcache_order` 0), extrapolates it (1, 2), decodes a cached
image-stream residual (`vcache_cached="residual"`) or forecasts every
block's module outputs (`"module"`).

Where the reference decides inside the scan (`lax.cond` on any row's bit),
the port reads the step's decision on the host once a step, and only in the
dynamic mode (a static schedule is known beforehand); the batch forward runs
only when some row needs it. Decisions stay per candidate: a row whose
accumulator stayed under the threshold keeps its cached quantity, so its
output does not depend on its micro-batch. Skip-step velocities are computed
only when some row skips (the reference computes them every step, a
shape-static scan body). The dense path (no mask, no threshold) is the loop
it always was, with no host read.

Under tensor parallelism (a DiT cut by `parallel.specs.shard_dit_params`)
the dynamic mode's decision is broadcast from the model group's first rank,
so every rank of the group runs the same forward (the ranks compute the
same signal from the same replicated weights; the broadcast makes it so by
construction). Under ring attention over a mesh of ranks (a "seq" axis) no
broadcast is needed: the ring joins each attention's output over the seq
line, so its ranks hold the same latents and signals, bit for bit, and take
the same decisions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.flux.dit import FluxDiT, flux_mod_signal, flux_residual_decode
from ..parallel.collectives import broadcast
from .scheduler import FlowMatchSchedule

VCACHE_CACHED = ("velocity", "residual", "module")


class _Forecast:
    """TaylorSeer's order-1 forecast of a module cache, one block at a time
    (`FluxDiT.forward(module_cache=...)` reads block i of each leaf as
    `leaf[i]`), so no third full cache is built: each block's value is
    (a0 + d1 * (sigma - s0)) in fp32, d1 the divided difference of the last
    two snapshots where a row has two, cast back to the snapshot dtype."""

    def __init__(self, h0: dict, h1: dict | None, sigma: float, s0, den, have2, rows):
        self.h0, self.h1, self.sigma, self.rows = h0, h1, sigma, rows
        self.s0, self.den, self.have2 = (self._col(x) for x in (s0, den, have2))
        self.any2 = h1 is not None and bool(have2.any())

    def _col(self, x):  # (B,) -> (rows, 1, 1), the CFG branches sharing their row's value
        return (torch.cat([x, x]) if self.rows != x.shape[0] else x)[:, None, None]

    def _leaf(self, a0, a1):
        if not self.any2:
            return a0  # d1 = 0 everywhere: the forecast is a0 itself
        a0f = a0.float()
        d1 = torch.where(self.have2, (a0f - a1.float()) / self.den, 0.0)
        return (a0f + d1 * (self.sigma - self.s0)).to(a0.dtype)

    def __getitem__(self, family):
        h0, h1 = self.h0[family], None if self.h1 is None else self.h1[family]
        if family == "single":
            return _Blocks(self, h0, h1)
        return tuple(_Blocks(self, a, None if h1 is None else h1[j]) for j, a in enumerate(h0))


class _Blocks:
    """One leaf of a `_Forecast`: `[i]` forecasts block i."""

    def __init__(self, forecast: _Forecast, a0, a1):
        self.forecast, self.a0, self.a1 = forecast, a0, a1

    def __getitem__(self, i):
        return self.forecast._leaf(self.a0[i], None if self.a1 is None else self.a1[i])


def _update_rows(h0, h1, new, full_rows):
    """The module history after a step whose rows `full_rows` ran full:
    h1 <- h0 and h0 <- new on those rows. When every row ran, the snapshots
    just move (no copy)."""
    if full_rows is None:
        return new, h0
    if h1 is None:
        h1 = {"double": tuple(torch.zeros_like(a) for a in h0["double"]),
              "single": torch.zeros_like(h0["single"])}
    for a1, a0, n in zip((*h1["double"], h1["single"]), (*h0["double"], h0["single"]),
                         (*new["double"], new["single"])):
        a1[:, full_rows] = a0[:, full_rows]
        a0[:, full_rows] = n[:, full_rows]
    return h0, h1


@torch.no_grad()
def denoise(
    dit: FluxDiT,
    latents: torch.Tensor,  # (B, L_img, C) packed noise
    txt: torch.Tensor,  # (B, L_txt, text_dim)
    pooled: torch.Tensor,  # (B, pooled_dim)
    img_ids: torch.Tensor,  # (L_img, 3)
    txt_ids: torch.Tensor,  # (L_txt, 3)
    sigmas: torch.Tensor,  # (num_steps + 1,) fp32
    guidance_scale: float,
    num_steps: int,
    cond: torch.Tensor | None = None,  # (B, L_c, C)
    cond_ids: torch.Tensor | None = None,  # (L_c, 3)
    cond_empty: torch.Tensor | None = None,  # (B, L_c, C) black-image tokens
    cond_dit_params: FluxDiT | None = None,  # the cond stream's (LoRA-folded) model
    image_guidance_scale: float = 1.0,
    c_factor: float | None = None,
    union_cond_attn: bool = True,
    add_cond_attn: bool = False,
    attn_impl: str = "xla",
    rope_layout: str = "pair",
    step_mask=None,  # (num_steps,) bool: True = full forward
    vcache_threshold: float = 0.0,  # > 0: TeaCache-style dynamic skipping
    vcache_warmup: int = 1,  # dynamic mode: the first W steps run full
    vcache_tail: int = 1,  # dynamic mode: the last T steps run full
    vcache_poly: tuple[float, ...] | None = None,  # rescale polynomial, highest order first
    vcache_order: int = 0,  # 0 = reuse the cached velocity; 1/2 = Taylor-predict it
    vcache_cached: str = "velocity",  # what a skipped step consumes: velocity|residual|module
    vcache_force_mask=None,  # dynamic mode: extra forced-full steps
    return_vcache_stats: bool = False,  # also return the number of full forwards
):
    """Run the Euler loop; returns the final packed latents (B, L_img, C), and
    with `return_vcache_stats` (latents, n_full), n_full the batch forwards
    the DiT ran.

    As the reference: the timestep is cast to the latent dtype, the
    guidance is in the latent dtype, and the update runs in fp32. With
    `cond_empty` (image CFG) each step is one forward over the doubled batch
    [cond | cond_empty] with guidance [g | 1], combined as
    v_unc + image_guidance_scale * (v_cond - v_unc).

    The velocity cache (opt-in; the JAX `denoise` documents each mode): a
    static `step_mask` (step 0 always runs), or `vcache_threshold > 0`: each
    step computes `flux_mod_signal`, accumulates its relative L1 change per
    row in fp32 (rescaled by `vcache_poly` by Horner's rule when given) and
    runs the forward for rows whose accumulator reaches the threshold (then
    reset), the first `vcache_warmup` and last `vcache_tail` steps and the
    `vcache_force_mask` steps forced. `vcache_order` 1/2 extrapolates skipped
    velocities from an fp32 history by Newton divided differences;
    `vcache_cached="residual"` caches the image-stream residual (TeaCache's
    exact quantity; rows doubled under image CFG) and decodes it with the
    live input embedding and output head; `"module"` caches every block's
    module outputs and forecasts them to order 1 (t2i only)."""
    B = latents.shape[0]
    dtype, device = latents.dtype, latents.device
    g_main = torch.full((B,), guidance_scale, dtype=dtype, device=device)
    image_cfg = cond_empty is not None
    guidance, txt2, pooled2 = g_main, txt, pooled
    if image_cfg:
        guidance = torch.cat([g_main, torch.ones_like(g_main)])
        txt2, pooled2 = torch.cat([txt, txt]), torch.cat([pooled, pooled])
        if cond is not None:
            cond = torch.cat([cond, cond_empty])
    g_kw = lambda g: g if dit.cfg.guidance_embeds else None  # noqa: E731
    cond_kw = {}
    if cond is not None:
        cond_kw = dict(cond=cond, cond_ids=cond_ids, c_factor=c_factor,
                       union_cond_attn=union_cond_attn, add_cond_attn=add_cond_attn,
                       cond_params=cond_dit_params)
    sig = sigmas.detach().cpu().numpy().astype(np.float32)

    def t_rows(i, n):
        return torch.full((n,), float(sig[i]), dtype=dtype, device=device)

    def combine(v):
        if not image_cfg:
            return v
        v_cond, v_unc = v[:B], v[B:]
        return v_unc + torch.tensor(image_guidance_scale, dtype=v.dtype) * (v_cond - v_unc)

    def doubled(lat):
        return torch.cat([lat, lat]) if image_cfg else lat

    def forward(lat, i, **kw):
        """The DiT at step i over the (CFG-doubled) batch; a second output
        (residual or module cache) stays doubled."""
        lat2 = doubled(lat)
        out = dit(lat2, txt2, pooled2, t_rows(i, lat2.shape[0]), img_ids, txt_ids,
                  guidance=g_kw(guidance), attn_impl=attn_impl, rope_layout=rope_layout,
                  **cond_kw, **kw)
        if isinstance(out, tuple):
            return combine(out[0]), out[1]
        return combine(out)

    def from_resid(lat, i, resid):
        lat2 = doubled(lat)
        return combine(flux_residual_decode(dit, lat2, resid, pooled2, t_rows(i, lat2.shape[0]),
                                            guidance=g_kw(guidance)))

    def advance(lat, v, i):
        delta = float(sig[i + 1] - sig[i])  # fp32 difference, as the reference
        return (lat.float() + delta * v.float()).to(dtype)

    use_vcache = step_mask is not None or vcache_threshold > 0.0
    if not use_vcache:  # the exact, unmodified serving path
        for i in range(num_steps):
            latents = advance(latents, forward(latents, i), i)
        return (latents, num_steps) if return_vcache_stats else latents

    # validation, in the reference's order and with its messages
    dynamic = vcache_threshold > 0.0
    if step_mask is not None:
        if dynamic:
            raise ValueError("step_mask and vcache_threshold are mutually exclusive")
        step_mask = np.asarray(step_mask, bool)
        if step_mask.shape != (num_steps,):  # the reference asserts this
            raise ValueError(f"step_mask has shape {step_mask.shape}, expected ({num_steps},)")
    if dynamic:
        warmup = max(int(vcache_warmup), 1)  # step 0 must run full (no cached v yet)
        idx = np.arange(num_steps)
        forced = (idx < warmup) | (idx >= num_steps - max(int(vcache_tail), 0))
        if vcache_force_mask is not None:
            forced = forced | np.asarray(vcache_force_mask, bool)
    else:
        if vcache_force_mask is not None:
            raise ValueError("vcache_force_mask is a dynamic-mode lever; "
                             "fold it into step_mask for static schedules")
        forced = step_mask.copy()
        forced[0] = True
    order = int(vcache_order)
    if order not in (0, 1, 2):
        raise ValueError(f"vcache_order must be 0, 1, or 2 (got {vcache_order})")
    if vcache_cached not in VCACHE_CACHED:
        raise ValueError(f"vcache_cached must be velocity|residual|module (got {vcache_cached!r})")
    mode = vcache_cached
    if mode == "residual" and order != 0:
        raise ValueError(
            "vcache_cached='residual' is TeaCache's exact cache (one residual, "
            "order-0 reuse); Taylor prediction (vcache_order>0) is a velocity-mode lever")
    if mode == "module" and order != 0:
        raise ValueError(
            "vcache_cached='module' has its own order-1 TaylorSeer forecast "
            "built in; vcache_order is a velocity-mode lever")
    if mode == "module" and cond is not None:
        raise ValueError("vcache_cached='module' covers the plain t2i path (no cond stream)")

    poly = None if not vcache_poly else torch.tensor(vcache_poly, dtype=torch.float32)
    tp = getattr(dit, "tp", None) if dynamic else None
    sig_prev = torch.zeros((B, latents.shape[1], dit.cfg.hidden_size), dtype=torch.float32,
                           device=device) if dynamic else None
    acc = torch.zeros((B,), dtype=torch.float32, device=device)

    def decide(lat, i):
        """-> (do_full (B,) bool on the device or None, any row full, every row
        full). Per-candidate state: each row's accumulator sees its own signal."""
        nonlocal sig_prev, acc
        if not dynamic:
            bit = bool(forced[i])
            return None, bit, bit
        s = flux_mod_signal(dit, lat, pooled, t_rows(i, B), guidance=g_kw(g_main)).float()
        rel = (s - sig_prev).abs().sum(dim=(1, 2)) / (sig_prev.abs().sum(dim=(1, 2)) + 1e-8)
        est = rel
        if poly is not None:  # np.polyval order, Horner from 0 in fp32
            est = torch.zeros_like(rel)
            for c in poly.tolist():
                est = est * rel + c
        acc = acc + est
        do_full = (acc >= vcache_threshold) | bool(forced[i])
        if tp is not None:  # one decision for the model group: every rank runs the same forward
            do_full = broadcast(do_full.to(torch.uint8), 0, tp.group).bool()
        acc = torch.where(do_full, 0.0, acc)
        sig_prev = s
        n = int(do_full.sum())  # the one host read of the step
        return do_full, n > 0, n == B

    def pick(do_full, every, new, old):
        """Per-row choice of `new` (full rows) over `old`, rows on dim 0;
        `new` whole when every row ran full (`do_full` may then be None)."""
        if every:
            return new
        return torch.where(do_full.reshape(-1, *([1] * (new.dim() - 1))), new, old)

    n_full = 0
    if mode == "velocity" and order == 0:
        v_prev = None
        for i in range(num_steps):
            do_full, any_full, every = decide(latents, i)
            if any_full:
                v = pick(do_full, every, forward(latents, i), v_prev)
                n_full += 1
            else:
                v = v_prev
            latents, v_prev = advance(latents, v, i), v
    elif mode == "velocity":
        # fp32 full-forward velocities, most recent first, and their sigmas
        hist = [torch.zeros(latents.shape, dtype=torch.float32, device=device)] * (order + 1)
        sigs = [torch.full((B,), -1.0, device=device) for _ in range(order + 1)]
        k = torch.zeros((B,), dtype=torch.int32, device=device)
        for i in range(num_steps):
            do_full, any_full, every = decide(latents, i)
            s = float(sig[i])
            vhat = None
            if not every:  # Newton divided differences from the pre-step history
                col = lambda x: x[:, None, None]  # noqa: E731
                have2, have3 = k >= 2, k >= 3
                den1 = torch.where(have2, sigs[0] - sigs[1], 1.0)
                d1 = torch.where(col(have2), (hist[0] - hist[1]) / col(den1), 0.0)
                vhat = hist[0] + d1 * (s - col(sigs[0]))
                if order >= 2:
                    den1b = torch.where(have3, sigs[1] - sigs[2], 1.0)
                    d1b = torch.where(col(have3), (hist[1] - hist[2]) / col(den1b), 0.0)
                    den2 = torch.where(have3, sigs[0] - sigs[2], 1.0)
                    d2 = torch.where(col(have3), (d1 - d1b) / col(den2), 0.0)
                    vhat = vhat + d2 * (s - col(sigs[0])) * (s - col(sigs[1]))
            if any_full:
                v_new = forward(latents, i).float()
                n_full += 1
                v = pick(do_full, every, v_new, vhat)
                hist = [pick(do_full, every, v_new, hist[0])] + [
                    pick(do_full, every, hist[j - 1], hist[j]) for j in range(1, order + 1)]
                st = torch.full((B,), s, device=device)
                sigs = [pick(do_full, every, st, sigs[0])] + [
                    pick(do_full, every, sigs[j - 1], sigs[j]) for j in range(1, order + 1)]
                k = k + (1 if every else do_full.to(torch.int32))
            else:
                v = vhat
            latents = advance(latents, v, i)
    elif mode == "residual":
        resid = None  # (rows, L_img, hidden), model dtype; rows doubled under image CFG
        for i in range(num_steps):
            do_full, any_full, every = decide(latents, i)
            v_skip = None if every else from_resid(latents, i, resid)
            if any_full:
                v_new, r_new = forward(latents, i, return_img_residual=True)
                n_full += 1
                v = pick(do_full, every, v_new, v_skip)
                resid = pick(None if every else doubled(do_full), every, r_new, resid)
            else:
                v = v_skip
            latents = advance(latents, v, i)
    else:  # module
        rows = 2 * B if image_cfg else B
        h0 = h1 = None  # the last two full-forward module caches (model dtype)
        sigs = torch.full((B, 2), -1.0, device=device)
        kcnt = torch.zeros((B,), dtype=torch.int32, device=device)
        for i in range(num_steps):
            do_full, any_full, every = decide(latents, i)
            s = float(sig[i])
            v_skip = None
            if not every:
                have2 = kcnt >= 2
                den = torch.where(have2, sigs[:, 0] - sigs[:, 1], 1.0)
                v_skip = forward(latents, i,
                                 module_cache=_Forecast(h0, h1, s, sigs[:, 0], den, have2, rows))
            if any_full:
                v_new, cache_new = forward(latents, i, return_module_outs=True)
                n_full += 1
                v = pick(do_full, every, v_new, v_skip)
                h0, h1 = _update_rows(h0, h1, cache_new,
                                      None if every else doubled(do_full).nonzero().flatten())
                shifted = torch.stack([torch.full((B,), s, device=device), sigs[:, 0]], dim=1)
                sigs = pick(do_full, every, shifted, sigs)
                kcnt = kcnt + (1 if every else do_full.to(torch.int32))
            else:
                v = v_skip
            latents = advance(latents, v, i)
    return (latents, n_full) if return_vcache_stats else latents


def make_schedule(num_steps: int, image_seq_len: int) -> torch.Tensor:
    """Dynamic-shifted sigma array (host-precomputed, fp32, on the CPU)."""
    return torch.from_numpy(FlowMatchSchedule.create(num_steps, image_seq_len).sigmas)


def vcache_kwargs(vcache: dict | None, num_steps: int) -> dict:
    """`pipeline_args.vcache` -> `denoise(...)` keywords, the JAX package's one
    schedule grammar: {"interval": k[, warmup, tail, order, residual, module]}
    static or {"threshold": x[, warmup, tail, poly, order, residual, module,
    pin_n_full]} dynamic, with the same errors. Masks are host numpy arrays."""
    if not vcache:
        return {}
    vc = dict(vcache)
    if "interval" in vc and "threshold" in vc:
        raise ValueError("vcache: interval and threshold are mutually exclusive")
    extra = {"vcache_order": int(vc["order"])} if vc.get("order") else {}
    if vc.get("residual") and vc.get("module"):
        raise ValueError("vcache: residual and module are mutually exclusive")
    if vc.get("residual"):
        extra["vcache_cached"] = "residual"
    if vc.get("module"):  # TaylorSeer per-module order-1 forecast
        extra["vcache_cached"] = "module"
    if "interval" in vc:
        if "pin_n_full" in vc:
            raise ValueError("vcache: pin_n_full is a dynamic-mode lever")
        return {"step_mask": make_step_mask(
            num_steps, int(vc["interval"]),
            warmup=int(vc.get("warmup", 1)), tail=int(vc.get("tail", 1))), **extra}
    if "threshold" in vc:
        if not float(vc["threshold"]) > 0:
            raise ValueError("vcache threshold must be > 0 (omit vcache to disable)")
        # presence, not truthiness: an explicit pin of 0 must reach make_pinned_mask's error
        if vc.get("pin_n_full") is not None:
            extra["vcache_force_mask"] = make_pinned_mask(
                num_steps, min(int(vc["pin_n_full"]), num_steps))
        return {
            "vcache_threshold": float(vc["threshold"]),
            "vcache_warmup": int(vc.get("warmup", 1)),
            "vcache_tail": int(vc.get("tail", 1)),
            "vcache_poly": tuple(vc["poly"]) if vc.get("poly") else None,
            **extra,
        }
    raise ValueError(f"vcache needs 'interval' or 'threshold': {vc}")


def make_step_mask(num_steps: int, interval: int, warmup: int = 1, tail: int = 1) -> np.ndarray:
    """Static schedule (DeepCache/FORA-style): full forwards for the first
    `warmup` (at least 1) and last `tail` steps and every `interval`-th step
    after the warmup; interval=1 runs every step."""
    if num_steps < 1 or interval < 1:
        raise ValueError(f"num_steps={num_steps}, interval={interval}")
    warmup = max(int(warmup), 1)  # step 0 has no cached velocity to reuse
    mask = np.zeros(num_steps, dtype=bool)
    mask[:warmup] = True
    if tail > 0:
        mask[num_steps - tail:] = True
    mask[warmup::interval] = True
    return mask


def make_pinned_mask(num_steps: int, n_full: int) -> np.ndarray:
    """Exactly `n_full` evenly spaced full steps, the first and last included:
    a dynamic schedule's floor through `vcache_force_mask`."""
    n_full = int(n_full)
    if not 2 <= n_full <= num_steps:
        raise ValueError(f"n_full must be in [2, {num_steps}] (got {n_full})")
    mask = np.zeros(num_steps, dtype=bool)
    mask[np.round(np.linspace(0, num_steps - 1, n_full)).astype(int)] = True
    assert int(mask.sum()) == n_full  # linspace endpoints are distinct ints
    return mask
