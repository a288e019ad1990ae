"""Velocity-cache quality calibration: what a skip schedule costs.

Counterpart of `reflectionflow_tpu/sampler/vcache_calibrate.py`. The
velocity cache (`sampler/generate.py`) is training-free but lossy; this
harness sweeps candidate schedules against the DENSE trajectory on the same
latents and prompts and measures, per schedule:

  * `latent_rel_err` (and its max over candidates): the mean relative L1
    distance of the final packed latents from the dense ones;
  * `score` / `score_drop`: the mean verifier score of the decoded images,
    and its drop from the dense images' score, when a verifier is given;
  * `n_full` / `speedup_est`: the full DiT forwards the schedule launched
    and num_steps / n_full (denoise time is close to linear in them).

`select_schedule` picks the fastest candidate under both gates;
`save_calibration` writes the selection and the evidence, refusing a
"real" (headline-eligible) tier without a scored selection. The literature
anchors (TeaCache's published FLUX.1-dev schedule, a TaylorSeer-family
schedule) are this module's own copies of the JAX package's constants.

One divergence: `calibrate` draws its latents from a `torch.Generator` seeded
with `seed` (the JAX package uses `jax.random`), so the two packages sweep
different noise for the same seed (ROADMAP item 24).
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np
import torch

from ..models.flux.latents import latent_tokens, unpack_latents
from ..models.flux.rope import make_image_ids, make_text_ids
from ..models.flux.vae import vae_decode
from .generate import denoise, make_schedule, make_step_mask, vcache_kwargs


def default_candidates() -> list[dict]:
    """The sweep grid: static intervals, TeaCache-style thresholds, and
    Taylor-predicted variants of both (`order` > 0)."""
    cands = [
        {"name": f"interval{k}", "vcache": {"interval": k, "warmup": 2, "tail": 1}}
        for k in (2, 3, 4)
    ]
    cands += [
        {"name": f"threshold{t:g}", "vcache": {"threshold": t, "warmup": 2, "tail": 1}}
        for t in (0.10, 0.20, 0.35)
    ]
    cands += [
        {"name": f"interval{k}_o{o}",
         "vcache": {"interval": k, "warmup": 2, "tail": 1, "order": o}}
        for k in (3, 4, 5, 6) for o in (1, 2)
    ]
    cands += [
        {"name": f"threshold{t:g}_o1",
         "vcache": {"threshold": t, "warmup": 2, "tail": 1, "order": 1}}
        for t in (0.35, 0.6, 1.0)
    ]
    return cands


def _mean_score(verifier, images: np.ndarray, prompts: Sequence[str],
                metric: str = "overall_score") -> float:
    outs = verifier.score([np.asarray(im) for im in images], list(prompts))
    vals = []
    for o in outs:
        v = o.get(metric)
        if v is None:  # the verifier's first axis (e.g. VQ)
            v = next(iter(o.values()))
        vals.append(float(v["score"]) if isinstance(v, dict) else float(v))
    return float(np.mean(vals))


def run_schedule(pipe, vcache: dict | None, latents, txt, pooled, img_ids, txt_ids,
                 sigmas, num_steps: int, guidance_scale: float):
    """-> (final packed latents, full forwards launched) for one schedule
    (vcache=None: the dense trajectory)."""
    final, n_full = denoise(
        pipe.dit, latents, txt, pooled, img_ids, txt_ids, sigmas, guidance_scale, num_steps,
        attn_impl=pipe.attn_impl, rope_layout=pipe.rope_layout, return_vcache_stats=True,
        **vcache_kwargs(vcache, num_steps),
    )
    return final, int(n_full)


@torch.no_grad()
def _decode(pipe, final: torch.Tensor, ty: int, tx: int) -> np.ndarray:
    """Packed latents -> uint8 images, one image at a time (the decode's
    transients stay small beside a resident DiT)."""
    out = []
    for i in range(final.shape[0]):
        imgs = vae_decode(pipe.vae, unpack_latents(final[i:i + 1], ty, tx))
        out.append(((imgs.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy())
    return np.concatenate(out)


def calibrate(
    pipe,
    prompts: Sequence[str],
    verifier=None,
    height: int = 1024,
    width: int = 1024,
    num_steps: int = 30,
    guidance_scale: float = 3.5,
    max_sequence_length: int = 512,
    seed: int = 0,
    candidates: list[dict] | None = None,
    eps_score: float = 0.25,
    max_latent_rel_err: float = 0.35,
    metric: str = "overall_score",
) -> dict:
    """Sweep schedules on shared latents and embeddings; returns the evidence
    {dense, results, gates, settings, selected, selected_vcache}.

    `eps_score` is an absolute allowed drop of the mean verifier score (on
    the verifier's own scale); `max_latent_rel_err` bounds the latent error."""
    B = len(prompts)
    ty, tx = latent_tokens(height, width, pipe.vae_cfg.downscale)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    latents = torch.randn((B, ty * tx, pipe.dit_cfg.in_channels), generator=gen,
                          device=pipe.device).to(pipe.dtype)
    txt, pooled = pipe.encode_prompts(list(prompts), max_sequence_length)
    img_ids = torch.from_numpy(make_image_ids(ty, tx)).to(pipe.device)
    txt_ids = torch.from_numpy(make_text_ids(txt.shape[1])).to(pipe.device)
    sigmas = make_schedule(num_steps, ty * tx)

    args = (latents, txt, pooled, img_ids, txt_ids, sigmas, num_steps, guidance_scale)
    dense_final, _ = run_schedule(pipe, None, *args)
    dense_f32 = dense_final.float().cpu().numpy()
    dense_norm = np.sum(np.abs(dense_f32), axis=(1, 2)) + 1e-8
    dense_score = None
    if verifier is not None:
        dense_score = _mean_score(verifier, _decode(pipe, dense_final, ty, tx), prompts, metric)

    results = []
    for cand in candidates if candidates is not None else default_candidates():
        final, n_full = run_schedule(pipe, cand["vcache"], *args)
        f32 = final.float().cpu().numpy()
        rel = np.sum(np.abs(f32 - dense_f32), axis=(1, 2)) / dense_norm
        row = {
            "name": cand["name"],
            "vcache": cand["vcache"],
            "n_full": n_full,
            "speedup_est": round(num_steps / max(n_full, 1), 3),
            "latent_rel_err": round(float(np.mean(rel)), 5),
            "latent_rel_err_max": round(float(np.max(rel)), 5),
        }
        if verifier is not None:
            row["score"] = round(_mean_score(verifier, _decode(pipe, final, ty, tx), prompts, metric), 5)
            row["score_drop"] = round(dense_score - row["score"], 5)
        results.append(row)

    selected = select_schedule(results, eps_score=eps_score, max_latent_rel_err=max_latent_rel_err)
    return {
        "dense": {"n_full": num_steps, "score": dense_score},
        "results": results,
        "gates": {"eps_score": eps_score, "max_latent_rel_err": max_latent_rel_err,
                  "metric": metric},
        "settings": {"height": height, "width": width, "num_steps": num_steps,
                     "guidance_scale": guidance_scale, "n_prompts": B, "seed": seed},
        "selected": selected["name"] if selected else None,
        "selected_vcache": selected["vcache"] if selected else None,
    }


def select_schedule(results: list[dict], eps_score: float = 0.25,
                    max_latent_rel_err: float = 0.35) -> dict | None:
    """The fastest schedule passing both gates, ties to the lower latent
    error; a result without a score gates on latent error alone, and a sweep
    where nothing passes selects nothing. The latent gate is a backstop, not
    a quality gate: latent distance does not rank schedules by verifier
    quality, which is why `save_calibration` refuses an unscored "real"
    selection."""
    ok = [
        r for r in results
        if r["latent_rel_err"] <= max_latent_rel_err
        and (("score_drop" not in r) or r["score_drop"] <= eps_score)
    ]
    if not ok:
        return None
    return max(ok, key=lambda r: (r["speedup_est"], -r["latent_rel_err"]))


def save_calibration(path: str, result: dict, weights_kind: str,
                     verifier_name: str | None) -> None:
    """Write the selection and its evidence to `path`. `weights_kind` is the
    evidence tier: "real" calibrations may promote a schedule into serving,
    "synthetic" ones only check the harness. "real" requires a scored
    selection: the latent-error gate alone does not bound quality."""
    if weights_kind not in ("real", "synthetic"):
        raise ValueError(f"weights_kind must be real|synthetic, got {weights_kind!r}")
    if weights_kind == "real" and result.get("selected") is not None:
        sel = next((r for r in result.get("results", [])
                    if r.get("name") == result["selected"]), None)
        if sel is None or "score_drop" not in sel:
            raise ValueError(
                "weights_kind='real' (headline-eligible) requires a verifier-scored "
                "selection: the latent-error gate alone does not bound quality "
                "(see select_schedule docstring). Re-run calibration with a "
                "verifier, or save as weights_kind='synthetic'."
            )
    payload = dict(result, weights_kind=weights_kind, verifier=verifier_name)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_calibration(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# --- Literature-anchored schedules ------------------------------------------
# Evidence tiers, strongest first: "real" (calibrated on the target checkpoint
# by `calibrate`), "literature" (the schedule family was evaluated on public
# FLUX.1-dev in the cited work: their quality evaluation, our timing),
# "synthetic" (random weights: harness mechanics only).

# TeaCache's published FLUX.1-dev rescale polynomial (np.poly1d order, the
# highest coefficient first): raw relative-L1 change of the modulated input ->
# the estimated change of the model output that the threshold accumulates.
TEACACHE_FLUX_POLY = (
    4.98651651e02, -2.83781631e02, 5.58554382e01, -3.82021401e00, 2.64230861e-01,
)

# TeaCache's published FLUX.1-dev operating points: threshold -> reported speedup.
TEACACHE_FLUX_THRESHOLDS = {0.25: "1.5x", 0.4: "1.8x", 0.6: "2.0x", 0.8: "2.25x"}


def teacache_flux_schedule(threshold: float = 0.6) -> dict:
    """TeaCache as published for FLUX.1-dev: its signal (`flux_mod_signal`),
    rescale polynomial and threshold, the cached transformer residual, and
    the first and last steps forced full."""
    return {
        "threshold": float(threshold), "warmup": 1, "tail": 1,
        "poly": list(TEACACHE_FLUX_POLY), "residual": True,
    }


def _teacache_anchor(threshold: float, speedup: float, note: str) -> dict:
    return {
        "vcache": teacache_flux_schedule(threshold),
        "speedup_published": speedup,
        "anchor": (f"TeaCache (arXiv 2411.19108), method-exact for FLUX.1-dev at the published threshold "
                   f"{threshold:g}: {note} Signal = block 0's AdaLN-modulated image-stream input "
                   "(flux_mod_signal), relative L1 change rescaled by TEACACHE_FLUX_POLY, accumulated and "
                   "reset at the threshold; cached quantity = the transformer image-stream residual, "
                   "decoded with a fresh input embedding and the live output head (flux_residual_decode); "
                   "first and last steps full. Quality evaluation is the citation's, not measured here."),
    }


LITERATURE_ANCHORS = {
    "teacache_flux_t0.8": _teacache_anchor(
        0.8, 2.25, "the paper's faster FLUX operating point (~2.25x), with slightly more reported "
        "degradation than 0.6."),
    "teacache_flux_t0.6": _teacache_anchor(
        0.6, 2.0, "the paper's headline FLUX operating point (~2.0x), reported visually near-lossless; "
        "at B=1 the per-candidate accumulator is the paper's per-batch one."),
    "teacache_flux_t0.4": _teacache_anchor(
        0.4, 1.8, "a conservative published operating point (~1.8x)."),
    "teacache_flux_t0.25": _teacache_anchor(
        0.25, 1.5, "the paper's most conservative FLUX operating point (~1.5x)."),
    "taylor_o2_interval6": {
        "vcache": {"interval": 6, "warmup": 3, "tail": 1, "order": 2},
        "anchor": (
            "TaylorSeer (arXiv 2503.06923) validates Taylor-series forecasting of cached quantities "
            "(order >= 1 finite differences across skipped steps) on FLUX.1-dev at 3-5x with near-"
            "lossless quality, where order-0 reuse degrades. This variant forecasts the DiT's output "
            "velocity (one fp32 history buffer per order) rather than per-module features; the "
            "per-module variant is vcache {'module': true} (order-1 divided differences per block "
            "module, glue recomputed), whose two cache snapshots hold 1.076G values per candidate "
            "each at 1024 px full depth (19 double blocks x 4 modules x [4096 | 512] tokens + 38 "
            "single blocks x 4608 tokens, x 3072)."
        ),
    },
    "reuse_interval3": {
        "vcache": {"interval": 3, "warmup": 2, "tail": 1},
        "anchor": (
            "TeaCache (arXiv 2411.19108) and FORA (arXiv 2407.01425) validate order-0 reuse of the "
            "model output across skipped steps on FLUX at ~2x with minimal quality loss."
        ),
    },
}

# evidence-ranked: the method-exact anchor leads
ANCHOR_PRECEDENCE = ("teacache_flux_t0.6", "taylor_o2_interval6")
HEADLINE_ANCHOR = ANCHOR_PRECEDENCE[0]


def anchor_calibration(num_steps: int, name: str = HEADLINE_ANCHOR) -> dict:
    """A calibration-shaped evidence dict (weights_kind "literature") for a
    literature-anchored schedule: a static anchor's n_full and speedup come
    from its mask; a dynamic anchor's n_full is data-dependent, so its
    speedup is the citation's published number."""
    a = LITERATURE_ANCHORS[name]
    vc = a["vcache"]
    if "interval" in vc:
        n_full = int(make_step_mask(
            num_steps, int(vc["interval"]),
            warmup=int(vc.get("warmup", 1)), tail=int(vc.get("tail", 1))).sum())
        row = {
            "name": name,
            "vcache": vc,
            "n_full": n_full,
            "speedup_est": round(num_steps / max(n_full, 1), 3),
            "quality_basis": a["anchor"],
        }
    else:
        row = {
            "name": name,
            "vcache": vc,
            "n_full": None,
            "speedup_est": a["speedup_published"],
            "speedup_basis": (
                "published operating point (TeaCache, FLUX.1-dev); the actual "
                "forward count is measured at bench time and reported as "
                "n_full_forwards"
            ),
            "quality_basis": a["anchor"],
        }
    return {
        "dense": {"n_full": num_steps, "score": None},
        "results": [row],
        "gates": {"basis": "literature anchor — see results[0].quality_basis"},
        "settings": {"num_steps": num_steps},
        "selected": name,
        "selected_vcache": vc,
        "weights_kind": "literature",
        "verifier": None,
    }
