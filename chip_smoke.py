#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`reflectionflow_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device: requires CUDA; prints `nvidia-smi` name and power limit;
  2. build: compiles K1 and K7a (`csrc/flash_fwd.cu`), K6a/K6b and K7b/K7c
     (`csrc/flash_bwd.cu`), K3–K5 (`csrc/act_quant.cu`), K2
     (`csrc/norm_rope.cu`), K8 (`csrc/flash_fwd_int8.cu`) and K9
     (`csrc/flash_fwd_nr.cu`) into `.build/kernels/`, one nvcc per source,
     all started together; prints ptxas's registers and spills per kernel;
     checks that each kernel on the Hopper pipelines `csrc/flash_fwd_sm90.cuh`
     (K1, K8b, K9b) and `csrc/flash_bwd_sm90.cuh` (K6a, K6b) holds wgmma
     (HGMMA; K8b also the integer IGMMA) and TMA (UTMALDG) instructions and no
     mma.sync (HMMA, IMMA), spills nothing, that ptxas honoured its
     setmaxnreg (no warning C7508) and did not serialize its wgmma
     instructions;
  3. K1 against its plain PyTorch version on the card (fp32 reference), at
     the main-path shape (B=1, 2; L=4608; H=24; D=128), a ragged L, the
     cross-segment bias forms and the training shape; times both at the
     main-path shapes and at the training shape (B=8, L=2560, main_len 1536,
     cross bias log 0.5), with TFLOP/s, bound and share of the bound, and
     PyTorch's SDPA forward (the bias as a float mask) as the yardstick;
  3b. K6a/K6b against the fp32 plain backward at the training shape (B=8,
     L=512+1024+1024, main_len 1536, cross bias 0, -1e30, log 0.5), at
     (B=2, L=4608) and at a ragged L; a second launch at (8, 2560, log 0.5)
     must give bitwise the same dQ, dK and dV (no atomics); times both
     kernels, the plain version and PyTorch's SDPA backward (the yardstick
     only), with each kernel's share of its bound;
  3c. K7a/K7b/K7c (the ring-chunk kernels) against their plain versions at
     the ring's chunk shapes: the training sequence (8, 2560) and the
     corrector's (2, 5632) over 4 ring slots (chunks of 640 and 1408 rows)
     and a ragged (1, 4000) (chunks of 1000), at ring-global offset pairs on
     both sides of main_len, cross bias 0, log 0.5 and -1e30; the backward
     from the whole sequence's lse and delta rows. A row that sees no key
     under the mask must carry lse <= -1e29 (its ring merge weight is 0).
     Times each kernel, its plain version and SDPA with the chunk's float
     mask (forward; backward printed; yardsticks only) at the two chunk shapes;
  4. K2–K5 against their plain versions on the card at every shape the W8A8
     path gives them (strided panel slices included) and at a ragged
     L = 4608 + 77; times each kernel and its plain version in turns at
     each of those shapes but the ragged one, as device time (profiler) and
     as time per call (CUDA events, host gaps included);
  4b. K8 (`csrc/flash_fwd_int8.cu`) and K9 (`csrc/flash_fwd_nr.cu`) against
     their plain versions at the corrector shape (B=2, L=512+4096+1024,
     main_len 4608, cross bias 0, log 0.5, -1e30), the t2i shape (B=2,
     L=4608) and a ragged L, K9 in the double (txt_len 512) and single
     (txt_len 0) layouts, K9 also on column slices of one (2, 4608, 21504)
     panel (the single-block layout's views) and at L = 100 (below one tile);
     K8's K codes against the plain quantizer and its output against exact
     fp32 attention (cosine >= 0.999, max |err| < 0.05); times both, their
     plain versions and SDPA's forward (the yardstick only) at (2, 5632) and
     (2, 4608), with K9's and K8's K prologues (K9a, K8a) and attentions
     (K9b, K8b) apart as profiler device time, their rates and their shares
     of the bound;
  5. bf16 main path: FLUX.1-dev at full width and depth, random bf16 weights
     from a seeded CUDA generator, attn_impl="pallas", served through
     `run_noise_scaling` (the noise-scaling CLI's function) for 2 prompts x 2
     candidates at 1024x1024, 8 Euler steps (cut from 30 to bound the run);
     checks finite latents, 4 PNGs of 1024x1024x3, and exactly
     8 steps x 57 attention calls x 2 generate calls = 912 K1 launches (and no
     K2–K6 launch); and a full-width DiT forward on a small input agrees
     between K1 and the plain attention;
  5b. training: on that bf16 pipeline, `train()` of the FLUX-Corrector LoRA
     with TrainConfig's defaults (B=8, 512 px target and condition, r=32,
     prodigy, clip 0.5) and attn_impl="pallas" for 3 steps over a synthetic
     PNG shard; checks finite loss, grad_norm > 0, moved adapters, the
     checkpoint marker and 3 metric rows, and exactly 342 K1, 171 K6a and
     171 K6b launches (no K2–K5); prints s/step, peak memory and a profiler
     split of one step; at B=1 the adapter gradients with K1 + K6 agree with
     the plain attention's (cosine >= 0.99 per adapter family);
  5c. the training validation hook (`make_validation_hook`) once on the
     trained adapters: a conditioned generate of 2 val samples at 512 px,
     20 steps: exactly 20 x 57 = 1140 K1 launches, 2 PNGs of 512x512x3, and
     `cond_dit_params` restored;
  5d. ring attention (sequence parallel) on the bf16 pipeline, over
     `make_mesh((4,), ("seq",), devices=[cuda:i % n ...])`:
     `ring_attention` at (2, 5632) in the three cross forms, forward and
     backward, against the fp32 dense attention (K1/K6 limits) and K1 + K6
     (printed), with one call's time against K1 (+ K6); `train()` with
     attn_impl="ring_pallas" at TrainConfig's defaults for 2 steps: exactly
     2 x 57 x 16 K7a, 57 x 16 K7b and 57 x 16 K7c launches a step and no
     K1/K6, s/step and peak memory; at B=1 with union_cond_attn=False (live
     offsets; add_cond_attn so the adapters reach the loss) the adapter
     gradients against K1 + K6 (cosine >= 0.99 per family the loss reaches);
     a conditioned `denoise` at 1024 px with a 512 px condition (B=2 with
     image CFG, L=5632), 2 steps, union_cond_attn=False, under "ring_pallas"
     (exactly 2 x 57 x 16 K7a, no K1) against "pallas" (cosine >= 0.999);
  6. W8A8 main path: the trained adapters folded into `pipe.cond_dit_params`
     (a copy of the bf16 DiT), then the pipeline quantized in place with the
     CLI's int8 profile (`pipe.quantize(int4=(), weight_only=("t5",))`: fused,
     split-RoPE W8A8 DiT and cond model + w8a16 T5), served the same way;
     checks finite latents, 4 PNGs
     and exactly 912 K1, 2432 K2, 1824 K3, 1216 K4 and 1216 K5 launches; a
     full-width W8A8 DiT forward on a small input agrees between the fused path
     (K1–K5) and the plain "xla" serving path (cosine >= 0.999); the same at
     lengths that are not multiples of 8 (a served 1008x1008 generate call with
     77 text tokens must launch K1–K5 once per W8A8 linear, as at 1024px, and
     a small ragged forward must agree with the plain path); and a profiler
     split of one W8A8 step at B=2;
  7. corrector: `run_samples` (the corrector sampler CLI's function) over 2
     synthetic (bad, good, reflection) items at 1024 px with a 512 px
     condition, 8 Euler steps, image_guidance_scale 1.5 (one doubled-batch
     forward per step: B=2, L=512+4096+1024), once under attn_impl="pallas_nr"
     and once under "pallas_int8"; checks finite latents, 2 sheets of
     1024x3072x3 per run and exact launch counts (per forward 57 K9, or 57 K8
     and 266 K2; 190 K3, 133 K4, 133 K5; no K1); a full-width W8A8 forward
     with the cond stream under each impl agrees with the plain "xla" serving
     path (cosine >= 0.999); and a profiler split of one corrector step under
     "pallas_nr".
The training numbers are on the line {"train": {...}}, the ring phase's on
{"ring": {...}}; the line before the last is {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_TOL, LSE_TOL = 1e-2, 1e-3  # K1 (bf16 out, fp32 lse) against the fp32 plain version
DIT_REL_TOL = 3e-2  # bf16 DiT forward, K1 vs plain attention, relative to max |output|
NR_REL, NR_ABS = 7.9e-3, 1e-3  # K2: |err| <= NR_REL * |ref| + NR_ABS (two bf16 ulps)
Q_SCALE_RTOL, Q_MISMATCH = 1e-5, 1e-3  # K3/K4: scale rtol; |dq| <= 1 on <= 0.1% of values
W8A8_COS = 0.999  # full-width W8A8 DiT, fused path vs plain serving path
K8_COS, K8_EXACT_ERR = 0.999, 0.05  # K8 against exact fp32 attention (the JAX test's bounds)
K6_REL_TOL = 1e-2  # K6a/K6b: max |err| <= K6_REL_TOL * max |ref| for each of dQ, dK, dV
TRAIN_STEPS = 3  # corrector training steps at TrainConfig defaults (B=8, 512 px, r=32)
TRAIN_COS = 0.99  # adapter gradients, K1 + K6 vs plain attention, cosine per adapter family
STEPS, N_PROMPTS, BRANCH = 8, 2, 2
H, M, D, LT, LI = 3072, 12288, 128, 512, 4096  # FLUX.1-dev widths; txt and img tokens at 1024px
LC = 1024  # cond tokens of a 512 px condition
CORR_ITEMS, IMAGE_CFG = 2, 1.5  # corrector items served per impl; image guidance scale
RING = 4  # ring slots of the sequence-parallel phases (all on the one card)
RING_TRAIN_STEPS, RING_DENOISE_STEPS = 2, 2
RING_COS = 0.999  # ring denoise final latents against K1
# K1 timed: (B, L, main_len, cross bias): the t2i forward at B = 1 and 2, and the training
# sequence (512 + 1024 + 1024 tokens, the cond segment at 1536) with the c_factor bias
K1_TIMED = ((1, 4608, 4608, 0.0), (2, 4608, 4608, 0.0), (8, 2560, 1536, math.log(0.5)))
# K7 check: (B, whole L, main_len, ring-global (q, k) chunk starts, the timed pair): the training
# sequence and the corrector's, each over RING slots, and a ragged one (chunks of 1000 rows)
K7_SHAPES = ((8, 2560, 1536, ((0, 0), (640, 1920), (1920, 0), (1280, 640), (1280, 1280)), (1280, 1280)),
             (2, 5632, 4608, ((0, 4224), (4224, 1408), (2816, 4224), (4224, 4224), (0, 0)), (4224, 4224)),
             (1, 4000, 2500, ((2000, 1000), (1000, 2000), (2000, 2000), (0, 3000)), None))
HBM_TBS = 3.35  # H100 SXM HBM3, TB/s (data sheet)
BF16_TFLOPS = 989.0  # H100 SXM dense bf16 tensor-core peak, TFLOP/s (data sheet)
INT8_TOPS = 1979.0  # H100 SXM dense int8 tensor-core peak, TOP/s (data sheet)
PA = "reflectionflow_tpu/ops/pallas_attention.py"
PQ = "reflectionflow_tpu/ops/pallas_quant.py"
KERNELS = (  # name, source, TPU kernel it replaces
    ("norm_rope", "norm_rope.cu", f"{PQ}:116"),
    ("adaln_quant", "act_quant.cu", f"{PQ}:32"),
    ("gelu_quant", "act_quant.cu", f"{PQ}:44"),
    ("rowquant", "act_quant.cu", f"{PQ}:52"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")


def cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, kern, plain, k_iters: int, p_iters: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(torch, plain, p_iters), cuda_ms(torch, kern, k_iters),
                      cuda_ms(torch, kern, k_iters), cuda_ms(torch, plain, p_iters))
    return (k1 + k2) / 2, (p1 + p2) / 2


def profiled(torch, fn):
    """[(kernel name, self device µs)] of the device kernels `fn()` ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.key, us))
    return out


def kernel_split_ms(torch, fn, iters: int, tags=("",)) -> dict:
    """{tag: device ms per call of the kernels whose names hold tag}: the
    kernels' own durations, without the host's gaps between launches (which a
    short kernel's event timing includes)."""
    fn()

    def loop():
        for _ in range(iters):
            fn()

    for _ in range(3):  # a short window's trace can come back empty; take it again
        events = profiled(torch, loop)
        out = {tag: sum(us for key, us in events if tag in key) / 1e3 / iters for tag in tags}
        if all(ms > 0 for ms in out.values()):
            return out
    raise RuntimeError(f"the profiler saw no device time for {tags}")


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of all the kernels `fn` runs."""
    return kernel_split_ms(torch, fn, iters)[""]


HOPPER_KERNELS = (  # label, source, kernel: the kernels on flash_fwd_sm90.cuh / flash_bwd_sm90.cuh
    ("K1", "flash_fwd.cu", "flash_fwd_kernel"),
    ("K8b", "flash_fwd_int8.cu", "flash_fwd_int8_kernel"),
    ("K9b", "flash_fwd_nr.cu", "flash_fwd_nr_kernel"),
    ("K6a", "flash_bwd.cu", "flash_bwd_dq_kernel"),
    ("K6b", "flash_bwd.cu", "flash_bwd_dkv_kernel"),
)


def hopper_check(kernel_build, ptxas) -> dict:
    """K1, K8b, K9b, K6a and K6b are built as designed for Hopper: TMA (UTMALDG) and
    wgmma instructions (HGMMA for the bf16 products; K8b's int8 QK^T also an
    integer GMMA, IGMMA as cuobjdump prints it), no mma.sync (HMMA, IMMA), no
    spills, ptxas honoured their setmaxnreg (no warning C7508) and did not
    serialize their wgmma pipelines (its "are serialized" notices). Returns
    each kernel's SASS opcode counts."""
    out = {}
    for label, src, name in HOPPER_KERNELS:
        regs = ptxas[src][name]
        text = kernel_build.build(src).with_suffix(".ptxas").read_text()
        ops = kernel_build.sass_opcodes(src, name)
        gmma = {op: n for op, n in ops.items() if op.endswith("GMMA")}
        counts = {**gmma, **{op: ops.get(op, 0) for op in ("UTMALDG", "SYNCS", "USETMAXREG", "BAR",
                                                           "HMMA", "IMMA")}}
        log(f"{label} SASS opcode counts {counts}; ptxas {regs}")
        for line in text.splitlines():
            if "warning" in line.lower() or "Performance" in line:
                log(f"  ptxas ({src}): {line.strip()}")
        int_gmma = sum(n for op, n in gmma.items() if op != "HGMMA")
        check(counts.get("HGMMA", 0) > 0 and counts["UTMALDG"] > 0
              and counts["HMMA"] == counts["IMMA"] == 0 and (int_gmma > 0) == (label == "K8b"),
              f"{label} is not the wgmma/TMA kernel it was written as")
        check(regs.get("spill_stores") == regs.get("spill_loads") == 0 and "C7508" not in text,
              f"{label} spills or ptxas ignored its setmaxnreg")
        check("are serialized" not in text, f"ptxas serialized {label}'s wgmma instructions")
        out[label] = counts
    return out


def k1_phase(torch):
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, L):
        return [torch.randn((B, L, 24, 128), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    cases = [(1, 4608, None, 0.0), (2, 4608, None, 0.0), (1, 4608 + 77, None, 0.0),
             (1, 4608, 4096, -1e30), (1, 4608, 4096, math.log(0.5)), (8, 2560, 1536, math.log(0.5))]
    err_out = err_lse = 0.0
    with torch.no_grad():
        for B, L, main_len, cross_bias in cases:
            q, k, v = qkv(B, L)
            out, lse = flash_attention_fwd(q, k, v, main_len, cross_bias)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), main_len, cross_bias)
            e_out = (out.float() - ref_out).abs().max().item()
            e_lse = (lse - ref_lse).abs().max().item()
            log(f"K1 B={B} L={L} main_len={main_len} cross_bias={cross_bias}: "
                f"max|out err| {e_out:.3e} (tol {OUT_TOL}), max|lse err| {e_lse:.3e} (tol {LSE_TOL})")
            check(e_out <= OUT_TOL and e_lse <= LSE_TOL, "K1 disagrees with its plain version")
            err_out, err_lse = max(err_out, e_out), max(err_lse, e_lse)
            del q, k, v, out, lse, ref_out, ref_lse
        times = {}
        for B, L, main_len, cb in K1_TIMED:
            q, k, v = qkv(B, L)
            label = f"B={B} L={L}"
            kern_ms, plain_ms = in_turns(
                torch, lambda: flash_attention_fwd(q, k, v, main_len, cb),  # noqa: B023
                lambda: flash_attention_ref(q, k, v, main_len, cb), 20, 3)  # noqa: B023
            # yardstick only: PyTorch's SDPA forward on (B, H, L, D) copies of the same inputs,
            # with the cross bias as a float mask where there is one
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = None
            if cb != 0.0:
                pos = torch.arange(L, device="cuda")
                cross = (pos[:, None] >= main_len) != (pos[None, :] >= main_len)
                mask = torch.where(cross, cb, 0.0).to(torch.bfloat16)
            lib = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: B023
                qh, kh, vh, attn_mask=mask), 20)  # noqa: B023
            flops = 4 * B * L * L * D * 24
            b = bound(flops, 4 * B * L * 24 * D * 2 + B * 24 * L * 4)  # q, k, v, out bf16; lse fp32
            times[label] = {"ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b[0],
                            "bound_by": b[1], "tflops": flops / kern_ms / 1e9, "bound_share": b[0] / kern_ms,
                            "main_len": main_len, "cross_bias": cb}
            log(f"K1 {label} main_len={main_len} cross_bias={cb}: kernel {kern_ms:.4f} ms "
                f"({flops / kern_ms / 1e9:.1f} TFLOP/s, bound {b[0]:.4f} ms ({b[1]}), "
                f"{b[0] / kern_ms:.1%} of it), plain {plain_ms:.4f} ms, SDPA forward {lib:.4f} ms")
            del q, k, v, qh, kh, vh, mask
    torch.cuda.empty_cache()
    return err_out, err_lse, times


def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the operations over their peaks
    (bf16 FLOPs at the bf16 peak plus int8 operations at the int8 peak) and
    the bytes over the memory rate."""
    t_ops = flops / (BF16_TFLOPS * 1e9) + int8_ops / (INT8_TOPS * 1e9)
    t_bytes = nbytes / (HBM_TBS * 1e9)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k6_phase(torch):
    """K6a/K6b against the fp32 plain backward at the training shape (B=8,
    L=512+1024+1024, main_len 1536, three cross-bias forms), the serving shape
    (B=2, L=4608) and a ragged L; at (8, 2560, log 0.5) a second launch must
    be bitwise equal to the first; times both kernels in turns against the
    plain version and against PyTorch's SDPA backward (the yardstick only),
    with each kernel's share of its bound."""
    import torch.nn.functional as F

    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_ref, flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq)

    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(B, L, main_len, cross_bias):
        q, k, v, do = (torch.randn((B, L, 24, D), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, main_len, cross_bias)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, do, out, lse, delta

    res = {"dq": {"err": 0.0, "rel": 0.0}, "dkv": {"err": 0.0, "rel": 0.0}, "by_shape": {}}
    cases = [(8, 2560, 1536, 0.0), (8, 2560, 1536, -1e30), (8, 2560, 1536, math.log(0.5)),
             (2, 4608, 4608, 0.0), (1, 4608 + 77, 4608 + 77, 0.0)]
    with torch.no_grad():
        for B, L, main_len, cb in cases:
            q, k, v, do, out, lse, delta = inputs(B, L, main_len, cb)
            got = (flash_bwd_dq(q, k, v, do, lse, delta, main_len, cb),
                   *flash_bwd_dkv(q, k, v, do, lse, delta, main_len, cb))
            torch.cuda.synchronize()
            want = flash_attention_bwd_ref(q, k, v, out, lse, do, main_len, cb)
            msg = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w).abs().max().item()
                rel = err / w.abs().max().item()
                r = res["dq" if name == "dq" else "dkv"]
                r["err"], r["rel"] = max(r["err"], err), max(r["rel"], rel)
                msg.append(f"{name} max|err| {err:.3e} ({rel:.2e} of max|ref|)")
                check(bool(torch.isfinite(g).all()) and rel <= K6_REL_TOL,
                      f"K6 {name} disagrees with its plain version at B={B} L={L} cross_bias={cb}")
            log(f"K6 B={B} L={L} main_len={main_len} cross_bias={cb}: {', '.join(msg)} "
                f"(tol {K6_REL_TOL} of max|ref|)")
            del want
            if cb == math.log(0.5):  # the design has no atomics: a second launch is bitwise equal
                again = (flash_bwd_dq(q, k, v, do, lse, delta, main_len, cb),
                         *flash_bwd_dkv(q, k, v, do, lse, delta, main_len, cb))
                same = [torch.equal(a, g) for a, g in zip(again, got)]
                log(f"K6 B={B} L={L} cross_bias={cb}: second launch bitwise equal (dq, dk, dv) {same}")
                check(all(same), "K6's second launch differs from its first")
                del again
            del got
            if cb == 0.0 and L % 8 == 0:
                t_dq, plain = in_turns(
                    torch, lambda: flash_bwd_dq(q, k, v, do, lse, delta, main_len),  # noqa: B023
                    lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, main_len), 10, 2)  # noqa: B023
                t_dkv, _ = in_turns(
                    torch, lambda: flash_bwd_dkv(q, k, v, do, lse, delta, main_len),  # noqa: B023
                    lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, main_len), 10, 2)  # noqa: B023
                with torch.enable_grad():
                    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
                    o = F.scaled_dot_product_attention(qs, ks, vs)
                    dos = do.transpose(1, 2).contiguous()
                    lib = cuda_ms(torch, lambda: torch.autograd.grad(  # noqa: B023
                        o, (qs, ks, vs), dos, retain_graph=True), 10)  # noqa: B023
                    del o, qs, ks, vs, dos
                pairs = B * 24 * L * L * D
                io = B * L * 24 * D * 2
                b_dq = bound(6 * pairs, 5 * io + 2 * B * 24 * L * 4)
                b_dkv = bound(8 * pairs, 6 * io + 2 * B * 24 * L * 4)
                res["by_shape"][f"B={B} L={L}"] = {
                    "dq": {"ms": t_dq, "bound_ms": b_dq[0], "bound_by": b_dq[1],
                           "bound_share": b_dq[0] / t_dq},
                    "dkv": {"ms": t_dkv, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                            "bound_share": b_dkv[0] / t_dkv},
                    "plain_ms": plain, "library_ms": lib}
                log(f"K6 B={B} L={L}: K6a {t_dq:.4f} ms ({6 * pairs / t_dq / 1e9:.1f} TFLOP/s, bound "
                    f"{b_dq[0]:.4f} ms, {b_dq[0] / t_dq:.1%} of it), K6b {t_dkv:.4f} ms "
                    f"({8 * pairs / t_dkv / 1e9:.1f} TFLOP/s, bound {b_dkv[0]:.4f} ms, "
                    f"{b_dkv[0] / t_dkv:.1%} of it), together {t_dq + t_dkv:.4f} ms, plain backward "
                    f"{plain:.3f} ms, SDPA backward {lib:.4f} ms")
            del q, k, v, do, out, lse, delta
            torch.cuda.empty_cache()
    return res


def visible_rows(torch, Lc, q_off, k_off, main_len, cross_bias):
    """(Lc,) bool on the card: the chunk's query rows that see at least one
    key. Under the -1e30 mask a Q chunk can meet a K/V shard wholly across the
    cond boundary; such a row's partial is implementation-defined, and the
    ring needs only that its lse is <= -1e29 (its merge weight is then 0)."""
    if cross_bias > -1e29:
        return torch.ones(Lc, dtype=torch.bool, device="cuda")
    pos = torch.arange(Lc, device="cuda")
    q_cond, k_cond = (q_off + pos) >= main_len, (k_off + pos) >= main_len
    return (q_cond[:, None] == k_cond[None, :]).any(1)


def k7_phase(torch):
    """K7a/K7b/K7c against their plain versions at the ring's chunk shapes:
    the training sequence (8, 2560) and the corrector's (2, 5632), each split
    over p = 4 (chunks of 640 and 1408 rows), and a ragged (1, 4000) split
    (chunks of 1000, not a multiple of 64); offset pairs with 0 and non-zero
    starts on both sides of main_len, cross bias 0, log 0.5 and -1e30. The
    backward takes the ring-global lse and delta rows of the whole sequence
    (from K1). Each kernel, its plain version and SDPA (forward and backward,
    with the chunk's float mask; yardsticks only) timed at the two chunk
    shapes with a live cross bias."""
    import torch.nn.functional as F

    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_chunk_bwd, flash_chunk_bwd_ref, flash_chunk_fwd, flash_chunk_fwd_ref)

    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"fwd": {"err": 0.0, "lse_err": 0.0}, "dq": {"err": 0.0, "rel": 0.0},
           "dkv": {"err": 0.0, "rel": 0.0}, "by_shape": {}, "cases": 0}
    with torch.no_grad():
        for B, L, main_len, pairs, timed in K7_SHAPES:
            Lc = L // RING
            q, k, v, do = (torch.randn((B, L, 24, D), generator=gen, device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            for cb in (0.0, math.log(0.5), -1e30):
                out, lse = flash_attention_fwd(q, k, v, main_len, cb)
                delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
                del out
                for q_off, k_off in pairs:
                    qc, doc = q[:, q_off:q_off + Lc], do[:, q_off:q_off + Lc]
                    kc, vc = k[:, k_off:k_off + Lc], v[:, k_off:k_off + Lc]
                    g_lse, g_delta = (x[..., q_off:q_off + Lc].contiguous() for x in (lse, delta))
                    c_out, c_lse = flash_chunk_fwd(qc, kc, vc, main_len, cb, q_off, k_off)
                    got = flash_chunk_bwd(qc, kc, vc, doc, g_lse, g_delta, main_len, cb, q_off, k_off)
                    torch.cuda.synchronize()
                    r_out, r_lse = flash_chunk_fwd_ref(qc.float(), kc.float(), vc.float(), main_len, cb,
                                                       q_off, k_off)
                    rows = visible_rows(torch, Lc, q_off, k_off, main_len, cb)
                    e_out = (c_out - r_out)[:, rows].abs().amax().item() if rows.any() else 0.0
                    e_lse = (c_lse - r_lse)[..., rows].abs().amax().item() if rows.any() else 0.0
                    hidden_ok = bool((c_lse[..., ~rows] <= -1e29).all()) and bool(torch.isfinite(c_out).all())
                    want = flash_chunk_bwd_ref(qc, kc, vc, doc, g_lse, g_delta, main_len, cb, q_off, k_off)
                    msg = [f"out {e_out:.3e}, lse {e_lse:.3e} over {int(rows.sum())} of {Lc} rows"]
                    for name, g, w in zip(("dq", "dk", "dv"), got, want):
                        err = (g.float() - w).abs().max().item()
                        # a shard wholly across the -1e30 mask: every p is 0, so is the reference
                        rel = err / max(w.abs().max().item(), 1e-30)
                        r = res["dq" if name == "dq" else "dkv"]
                        r["err"], r["rel"] = max(r["err"], err), max(r["rel"], rel)
                        msg.append(f"{name} {err:.3e} ({rel:.2e} of max|ref|)")
                        check(bool(torch.isfinite(g).all()) and rel <= K6_REL_TOL,
                              f"K7 {name} disagrees with its plain version at B={B} Lc={Lc} "
                              f"offsets ({q_off}, {k_off}) cross_bias={cb}")
                    log(f"K7 B={B} Lc={Lc} main_len={main_len} offsets ({q_off}, {k_off}) cross_bias={cb}: "
                        f"max|err| {', '.join(msg)}")
                    check(e_out <= OUT_TOL and e_lse <= LSE_TOL and hidden_ok,
                          f"K7a disagrees with its plain version at B={B} Lc={Lc} offsets ({q_off}, {k_off})")
                    res["fwd"]["err"] = max(res["fwd"]["err"], e_out)
                    res["fwd"]["lse_err"] = max(res["fwd"]["lse_err"], e_lse)
                    res["cases"] += 1
                    del c_out, c_lse, r_out, r_lse, got, want
                if timed is not None and cb == math.log(0.5):
                    res["by_shape"][f"B={B} Lc={Lc}"] = _time_k7(
                        torch, F, q, k, v, do, lse, delta, main_len, cb, *timed, Lc)
                del lse, delta
                torch.cuda.empty_cache()
            del q, k, v, do
    torch.cuda.empty_cache()
    return res


def _time_k7(torch, F, q, k, v, do, lse, delta, main_len, cb, q_off, k_off, Lc):
    """K7a/K7b/K7c at one chunk in turns with their plain versions; SDPA's
    forward and backward with the chunk's float mask as yardsticks."""
    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_chunk_bwd_dkv, flash_chunk_bwd_dq, flash_chunk_bwd_ref, flash_chunk_fwd,
        flash_chunk_fwd_ref)

    B = q.shape[0]
    qc, doc = q[:, q_off:q_off + Lc], do[:, q_off:q_off + Lc]
    kc, vc = k[:, k_off:k_off + Lc], v[:, k_off:k_off + Lc]
    g_lse, g_delta = (x[..., q_off:q_off + Lc].contiguous() for x in (lse, delta))
    mods = (main_len, cb, q_off, k_off)
    t_fwd, p_fwd = in_turns(torch, lambda: flash_chunk_fwd(qc, kc, vc, *mods),
                            lambda: flash_chunk_fwd_ref(qc, kc, vc, *mods), 20, 3)
    plain_bwd = lambda: flash_chunk_bwd_ref(qc, kc, vc, doc, g_lse, g_delta, *mods)  # noqa: E731
    t_dq, p_bwd = in_turns(torch, lambda: flash_chunk_bwd_dq(qc, kc, vc, doc, g_lse, g_delta, *mods),
                           plain_bwd, 20, 2)
    t_dkv, _ = in_turns(torch, lambda: flash_chunk_bwd_dkv(qc, kc, vc, doc, g_lse, g_delta, *mods),
                        plain_bwd, 20, 2)
    pos = torch.arange(Lc, device="cuda")
    cross = ((q_off + pos)[:, None] >= main_len) != ((k_off + pos)[None, :] >= main_len)
    mask = torch.where(cross, cb, 0.0).to(torch.bfloat16)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (qc, kc, vc, doc))
    lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), 20)
    with torch.enable_grad():
        qs, ks, vs = (x.requires_grad_() for x in (qh, kh, vh))
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(o, (qs, ks, vs), doh, retain_graph=True), 10)
        del o, qs, ks, vs
    pairs = B * 24 * Lc * Lc * D
    io = B * Lc * 24 * D * 2
    rows = B * 24 * Lc * 4
    b_fwd, b_dq, b_dkv = (bound(4 * pairs, 4 * io + rows), bound(6 * pairs, 5 * io + 2 * rows),
                          bound(8 * pairs, 6 * io + 2 * rows))
    log(f"K7 B={B} Lc={Lc} offsets ({q_off}, {k_off}) cross_bias={cb}: K7a {t_fwd:.4f} ms "
        f"({4 * pairs / t_fwd / 1e9:.1f} TFLOP/s, bound {b_fwd[0]:.4f}), plain {p_fwd:.3f} ms; "
        f"K7b {t_dq:.4f} ms (bound {b_dq[0]:.4f}), K7c {t_dkv:.4f} ms (bound {b_dkv[0]:.4f}), "
        f"plain backward {p_bwd:.3f} ms; SDPA with the chunk's mask: forward {lib_fwd:.4f} ms, "
        f"backward {lib_bwd:.4f} ms")
    return {"fwd": {"ms": t_fwd, "plain_ms": p_fwd, "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                    "library_ms": lib_fwd},
            "dq": {"ms": t_dq, "plain_ms": p_bwd, "bound_ms": b_dq[0], "bound_by": b_dq[1],
                   "library_ms": None, "sdpa_backward_ms": lib_bwd},
            "dkv": {"ms": t_dkv, "plain_ms": p_bwd, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                    "library_ms": None, "sdpa_backward_ms": lib_bwd}}


def fused_phase(torch):
    """K2–K5 against their plain versions at the W8A8 path's shapes, each timed
    there against its plain version; the result line keeps the B=2, L=4608
    single-block shape."""
    from reflectionflow_tpu_torch.ops import fused_quant as fq

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def tables(L):
        ang = torch.rand((L, D // 2), generator=gen, device="cuda") * 6.283
        return (torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16),
                torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16))

    res = {name: {"err": 0.0, "by_shape": {}} for name, _, _ in KERNELS}

    def timed(name, label, kern, plain, nbytes):
        """Kernel and plain version in turns, per call: device time (the
        kernels' own durations, from the profiler) and event time (which
        includes the host's gaps between launches when the wrapper's host
        work outlasts the kernel). nbytes is what the kernel must read and
        write; GB/s is taken over device time. Inputs up to ~50 MB may stay in
        the 50 MB L2 across the repeated calls."""
        ev_ms, ev_plain_ms = in_turns(torch, kern, plain, 50, 5)
        p1, k1, k2, p2 = (device_ms(torch, plain, 5), device_ms(torch, kern, 20),
                          device_ms(torch, kern, 20), device_ms(torch, plain, 5))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        gbps = nbytes / ms / 1e6
        res[name]["by_shape"][label] = {"ms": ms, "plain_ms": plain_ms, "gbps": gbps,
                                        "event_ms": ev_ms, "plain_event_ms": ev_plain_ms}
        if label.endswith(f"L={LT + LI}"):  # the single-block shape: the result line's numbers
            res[name].update(ms=ms, plain_ms=plain_ms, gbps=gbps, bound_ms=nbytes / (HBM_TBS * 1e9))
        log(f"  {name} {label}: device {ms:.4f} ms ({gbps:.0f} GB/s, {gbps / (HBM_TBS * 1e3):.1%} "
            f"of {HBM_TBS} TB/s), plain {plain_ms:.4f} ms; per call with host gaps "
            f"{ev_ms:.4f} ms, plain {ev_plain_ms:.4f} ms")

    def check_quant(name, got, ref, exact):
        (q, s), (rq, rs) = got, ref
        torch.cuda.synchronize()
        dq = (q.int() - rq.int()).abs()
        frac = (dq > 0).float().mean().item()
        s_rel = ((s - rs).abs() / rs).max().item()
        if exact:
            ok = torch.equal(q, rq) and torch.equal(s, rs)
        else:
            ok = dq.max().item() <= 1 and frac <= Q_MISMATCH and s_rel <= Q_SCALE_RTOL
        r = res[name]
        r["err"] = max(r["err"], float(dq.max().item()))
        r["scale_rel_err"] = max(r.get("scale_rel_err", 0.0), s_rel)
        r["mismatch_frac"] = max(r.get("mismatch_frac", 0.0), frac)
        return ok, f"max|dq| {dq.max().item()}, differing {frac:.2e}, scale rel err {s_rel:.2e}"

    with torch.no_grad():
        # K2 on the k slice of the qkv panel (row stride 3H) or of in_proj (3H + M);
        # the img stream reads the joint table from row LT on
        for L, row, table_off in ((LT, 3 * H, 0), (LI, 3 * H, LT), (LT + LI, 3 * H + M, 0),
                                  (LT + LI + 77, 3 * H + M, 0)):
            x = randn(2, L, row)[..., H:2 * H]
            scale = (1.0 + 0.1 * randn(D)).contiguous()
            cos, sin = (t[table_off:] for t in tables(L + table_off))
            got = fq.norm_rope(x, scale, cos, sin)
            ref = fq.norm_rope_ref(x, scale, cos, sin)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            ok = bool((err <= NR_REL * ref.float().abs() + NR_ABS).all())
            res["norm_rope"]["err"] = max(res["norm_rope"]["err"], err.max().item())
            log(f"K2 x (2, {L}, {H}) row stride {row}: max|err| {err.max().item():.3e}, "
                f"bit-identical {torch.equal(got, ref)}")
            check(ok, f"K2 disagrees with its plain version at L={L}")
            if L <= LT + LI:  # bytes: the slice read and the output written, bf16
                timed("norm_rope", f"row stride {row} L={L}", lambda: fq.norm_rope(x, scale, cos, sin),
                      lambda: fq.norm_rope_ref(x, scale, cos, sin), 2 * (2 * L * H * 2))
        for L in (LT, LI, LT + LI, LT + LI + 77):
            x = randn(2, L, H, scale=2.0)
            mod = randn(2, 6 * H, scale=0.5)  # shift/scale: strided chunks of the modulation output
            shift, scale = mod[:, H:2 * H], mod[:, 4 * H:5 * H]
            ok, msg = check_quant("adaln_quant", fq.adaln_quant(x, shift, scale),
                                  fq.adaln_quant_ref(x, shift, scale), False)
            log(f"K3 x (2, {L}, {H}): {msg}")
            check(ok, f"K3 disagrees with its plain version at L={L}")
            if L <= LT + LI:  # bytes: bf16 read, int8 written
                timed("adaln_quant", f"L={L}", lambda: fq.adaln_quant(x, shift, scale),
                      lambda: fq.adaln_quant_ref(x, shift, scale), 3 * L * H * 2)
        for L, row in ((LT, M), (LI, M), (LT + LI, 3 * H + M), (LT + LI + 77, 3 * H + M)):
            x = randn(2, L, row, scale=2.0)[..., row - M:]  # single blocks: fused[..., 3H:]
            ok, msg = check_quant("gelu_quant", fq.gelu_quant(x), fq.gelu_quant_ref(x), False)
            log(f"K4 x (2, {L}, {M}) row stride {row}: {msg}")
            check(ok, f"K4 disagrees with its plain version at L={L}")
            if L <= LT + LI:
                timed("gelu_quant", f"row stride {row} L={L}", lambda: fq.gelu_quant(x),
                      lambda: fq.gelu_quant_ref(x), 3 * L * M * 2)
        joint = randn(2, LT + LI, 24, D)  # K1's output; the out-projections read views of it
        for label, x in (("joint[:, :512]", joint[:, :LT].flatten(2)),
                         ("joint[:, 512:]", joint[:, LT:].flatten(2)),
                         ("joint", joint.flatten(2)),
                         ("ragged", randn(2, LT + LI + 77, H))):
            ok, msg = check_quant("rowquant", fq.rowquant(x), fq.rowquant_ref(x), True)
            log(f"K5 {label} {tuple(x.shape)}: {msg}")
            check(ok, f"K5 is not bit-exact against its plain version on {label}")
            if label != "ragged":
                timed("rowquant", f"{label} L={x.shape[1]}", lambda: fq.rowquant(x),
                      lambda: fq.rowquant_ref(x), 3 * x.shape[1] * H * 2)
    del x, joint
    torch.cuda.empty_cache()
    return res


def serving_attn_phase(torch):
    """K8 and K9 against their plain versions at the corrector shape (B=2,
    L=5632, main_len 4608) in the three cross-bias forms, the t2i shape (B=2,
    L=4608) and a ragged L; K9 in the double and single layouts. K8's K codes
    against the plain quantizer and its output against exact fp32 attention.
    Both kernels, their plain versions and SDPA's forward timed in turns at the
    two B=2 shapes with no cross bias (the main paths' form)."""
    import torch.nn.functional as F

    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_ref
    from reflectionflow_tpu_torch.ops.flash_attention_int8 import (
        flash_attention_int8, flash_attention_int8_ref, quantize_k, quantize_k_ref)
    from reflectionflow_tpu_torch.ops.flash_attention_nr import flash_attention_nr, flash_attention_nr_ref

    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def tables(L):
        ang = torch.rand((L, D // 2), generator=gen, device="cuda") * 6.283
        return (torch.cat([ang.cos()] * 2, -1).to(torch.bfloat16),
                torch.cat([ang.sin()] * 2, -1).to(torch.bfloat16))

    Lc = LT + LI + LC
    cases = [(2, Lc, LT + LI, 0.0), (2, Lc, LT + LI, math.log(0.5)), (2, Lc, LT + LI, -1e30),
             (2, LT + LI, LT + LI, 0.0), (1, LT + LI + 77, LT + LI, math.log(0.5))]
    nr = {"err": 0.0, "by_shape": {}}
    i8 = {"err": 0.0, "by_shape": {}, "code_max_diff": 0, "code_mismatch_frac": 0.0,
          "scale_rel_err": 0.0, "exact_cosine_min": 1.0, "exact_max_abs_err": 0.0}

    def check_nr(q, k, v, cos, sin, scq, sck, txt_len, main_len, cb, what):
        out = flash_attention_nr(q, k, v, cos, sin, scq, sck, txt_len, main_len, cb)
        torch.cuda.synchronize()
        ref = flash_attention_nr_ref(q, k, v, cos, sin, scq, sck, txt_len, main_len, cb)
        err = (out.float() - ref.float()).abs().max().item()
        nr["err"] = max(nr["err"], err)
        log(f"K9 {what} main_len={main_len} cross_bias={cb} txt_len={txt_len}: "
            f"max|out err| {err:.3e} (tol {OUT_TOL})")
        check(bool(torch.isfinite(out).all()) and err <= OUT_TOL, "K9 disagrees with its plain version")

    with torch.no_grad():
        # the single-block layout's views (t2i under pallas_nr): q/k/v are column slices of
        # one (B, L, 21504) panel, read at its strides; and a length below one 128-row tile
        panel = randn(2, LT + LI, 7 * H)
        views = [panel[..., i * H:(i + 1) * H].unflatten(-1, (24, D)) for i in range(3)]
        scales = [1.0 + randn(2, D, scale=0.1, dtype=torch.float32) for _ in range(2)]
        check_nr(*views, *tables(LT + LI), *scales, 0, LT + LI, 0.0,
                 f"B=2 L={LT + LI} (column slices of a (2, {LT + LI}, {7 * H}) panel)")
        del panel, views
        check_nr(*(randn(2, 100, 24, D) for _ in range(3)), *tables(100), *scales, 16, 80,
                 math.log(0.5), "B=2 L=100")
        for B, L, main_len, cb in cases:
            q, k, v = (randn(B, L, 24, D) for _ in range(3))
            cos, sin = tables(L)
            scq, sck = (1.0 + randn(2, D, scale=0.1, dtype=torch.float32) for _ in range(2))
            for txt_len in (LT, 0) if cb == 0.0 else (LT,):
                check_nr(q, k, v, cos, sin, scq, sck, txt_len, main_len, cb, f"B={B} L={L}")
            k8, ks = quantize_k(k)
            torch.cuda.synchronize()
            rk8, rks = quantize_k_ref(k)
            dq = (k8.int() - rk8.int()).abs()
            frac, s_rel = (dq > 0).float().mean().item(), ((ks - rks).abs() / rks).max().item()
            out = flash_attention_int8(q, k, v, main_len, cb)
            torch.cuda.synchronize()
            err = (out.float() - flash_attention_int8_ref(q, k, v, main_len, cb).float()).abs().max().item()
            exact = flash_attention_ref(q.float(), k.float(), v.float(), main_len, cb)[0]
            e_cos = torch.nn.functional.cosine_similarity(out.float().flatten(), exact.flatten(), dim=0).item()
            e_err = (out.float() - exact).abs().max().item()
            i8.update(err=max(i8["err"], err), code_max_diff=max(i8["code_max_diff"], dq.max().item()),
                      code_mismatch_frac=max(i8["code_mismatch_frac"], frac),
                      scale_rel_err=max(i8["scale_rel_err"], s_rel),
                      exact_cosine_min=min(i8["exact_cosine_min"], e_cos),
                      exact_max_abs_err=max(i8["exact_max_abs_err"], e_err))
            log(f"K8 B={B} L={L} main_len={main_len} cross_bias={cb}: K codes max|diff| {dq.max().item()}, "
                f"differing {frac:.2e}, scale rel err {s_rel:.2e}; max|out err| {err:.3e} (tol {OUT_TOL}); "
                f"against exact fp32 attention cosine {e_cos:.6f}, max|err| {e_err:.3e}")
            check(dq.max().item() <= 1 and frac <= Q_MISMATCH and s_rel <= Q_SCALE_RTOL,
                  "K8's K codes disagree with the plain quantizer")
            check(bool(torch.isfinite(out).all()) and err <= OUT_TOL, "K8 disagrees with its plain version")
            check(e_cos >= K8_COS and e_err < K8_EXACT_ERR, "K8 is too far from exact attention")
            del k8, ks, rk8, rks, dq, out, exact
            if B == 2 and cb == 0.0:
                t_nr, p_nr = in_turns(
                    torch, lambda: flash_attention_nr(q, k, v, cos, sin, scq, sck, LT, main_len),  # noqa: B023
                    lambda: flash_attention_nr_ref(q, k, v, cos, sin, scq, sck, LT, main_len), 20, 3)  # noqa: B023
                t_i8, p_i8 = in_turns(
                    torch, lambda: flash_attention_int8(q, k, v, main_len),  # noqa: B023
                    lambda: flash_attention_int8_ref(q, k, v, main_len), 20, 3)  # noqa: B023
                qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)  # noqa: B023
                del qh, kh, vh
                pairs = B * 24 * L * L * D
                io = 4 * B * L * 24 * D * 2  # q, k, v read and out written, bf16
                b_nr = bound(4 * pairs, io + 2 * L * D * 2 + 2 * 2 * D * 4)  # + tables and scales
                b_i8 = bound(2 * pairs, io, int8_ops=2 * pairs)
                label = f"B={B} L={L}"
                parts = kernel_split_ms(
                    torch, lambda: flash_attention_nr(q, k, v, cos, sin, scq, sck, LT, main_len),  # noqa: B023
                    10, ("nr_prep_k", "flash_fwd_nr_kernel"))
                parts8 = kernel_split_ms(
                    torch, lambda: flash_attention_int8(q, k, v, main_len),  # noqa: B023
                    10, ("int8_prep_k", "flash_fwd_int8_kernel"))
                tflops = 4 * pairs / t_nr / 1e9
                tops8 = 4 * pairs / t_i8 / 1e9  # int8 QK^T and bf16 P.V operations together
                nr["by_shape"][label] = {"ms": t_nr, "plain_ms": p_nr, "bound_ms": b_nr[0],
                                         "bound_by": b_nr[1], "library_ms": lib,
                                         "k9a_ms": parts["nr_prep_k"], "k9b_ms": parts["flash_fwd_nr_kernel"],
                                         "tflops": tflops, "bound_share": b_nr[0] / t_nr}
                i8["by_shape"][label] = {"ms": t_i8, "plain_ms": p_i8, "bound_ms": b_i8[0],
                                         "bound_by": b_i8[1], "library_ms": lib,
                                         "k8a_ms": parts8["int8_prep_k"],
                                         "k8b_ms": parts8["flash_fwd_int8_kernel"],
                                         "tops": tops8, "bound_share": b_i8[0] / t_i8}
                log(f"{label}: K9 {t_nr:.4f} ms ({tflops:.1f} TFLOP/s, bound {b_nr[0]:.4f} ms, "
                    f"{b_nr[0] / t_nr:.1%} of it; device time K9a {parts['nr_prep_k']:.4f} ms, "
                    f"K9b {parts['flash_fwd_nr_kernel']:.4f} ms), plain {p_nr:.3f} ms; "
                    f"K8 {t_i8:.4f} ms ({tops8:.1f} TOP/s, bound {b_i8[0]:.4f} ms, "
                    f"{b_i8[0] / t_i8:.1%} of it; device time K8a {parts8['int8_prep_k']:.4f} ms, "
                    f"K8b {parts8['flash_fwd_int8_kernel']:.4f} ms), plain {p_i8:.3f} ms; "
                    f"SDPA forward {lib:.4f} ms")
            del q, k, v
            torch.cuda.empty_cache()
    return {"flash_fwd_nr": nr, "flash_fwd_int8": i8}


def read_png_header(path: str):
    with open(path, "rb") as f:
        head = f.read(26)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, color


def _counters():
    from reflectionflow_tpu_torch.ops import fused_quant as fq
    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq, flash_chunk_bwd_dkv, flash_chunk_bwd_dq,
        flash_chunk_fwd)
    from reflectionflow_tpu_torch.ops.flash_attention_int8 import flash_attention_int8
    from reflectionflow_tpu_torch.ops.flash_attention_nr import flash_attention_nr

    return {"flash_fwd": flash_attention_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "flash_chunk_fwd": flash_chunk_fwd,
            "flash_chunk_bwd_dq": flash_chunk_bwd_dq, "flash_chunk_bwd_dkv": flash_chunk_bwd_dkv,
            "flash_fwd_nr": flash_attention_nr,
            "flash_fwd_int8": flash_attention_int8, **{n: getattr(fq, n) for n, _, _ in KERNELS}}


def zero_counts():
    """Every launch count set to 0; returns the counters."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def serve(torch, pipe, label: str):
    """run_noise_scaling over 2 prompts x 2 candidates with every launch count
    set to 0 just before and read just after; checks latents and PNGs."""
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.search.noise_scaling import run_noise_scaling
    from reflectionflow_tpu_torch.utils.timing import PhaseTimer

    cfg = TTSConfig.load(os.path.join(REPO, "configs", "flux.1_dev_fake.json"))
    cfg.search_args.search_rounds = 1
    cfg.pipeline_args.num_inference_steps = STEPS
    pa = cfg.pipeline_args
    check(cfg.search_args.search_branch == BRANCH and cfg.batch_size_for_img_gen == BRANCH,
          "flux.1_dev_fake.json no longer serves one prompt x 2 candidates per call")
    with open(os.path.join(REPO, "configs", "geneval_sample.jsonl")) as f:
        prompts = [json.loads(line) for line in f if line.strip()][:N_PROMPTS]

    # watch each generate call: finite latents, and the split into text encode,
    # denoise and decode, all through the pipeline's public methods
    calls = []
    generate = pipe.generate

    def generate_checked(flux_prompts, **kw):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        txt, pooled = pipe.encode_prompts(flux_prompts, kw["max_sequence_length"])
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        lat = generate(flux_prompts, txt=txt, pooled=pooled, **{**kw, "output_type": "latent"})
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        check(tuple(lat.shape) == (len(flux_prompts), (kw["height"] // 16) * (kw["width"] // 16), 64),
              f"latents shape {tuple(lat.shape)}")
        check(bool(torch.isfinite(lat).all()), f"{label}: non-finite final latents")
        images = pipe.decode_latents(lat, kw["height"], kw["width"])
        t_d = time.perf_counter()
        calls.append({"encode_s": t_b - t_a, "denoise_s": t_c - t_b, "decode_s": t_d - t_c})
        return images

    pipe.generate = generate_checked
    timer = PhaseTimer()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        counters = zero_counts()
        run_noise_scaling(pipe, cfg, prompts, out_dir, timer=timer)
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        pngs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs
                      if f.endswith(".png"))
        headers = [read_png_header(p) for p in pngs]
        meta_rows = sum(1 for dp, _, fs in os.walk(out_dir) for f in fs if f == "metadata.jsonl")
    pipe.generate = generate

    check(len(pngs) == N_PROMPTS * BRANCH and meta_rows == N_PROMPTS,
          f"{label}: {len(pngs)} PNGs and {meta_rows} metadata files written")
    check(all(h == (pa.width, pa.height, 8, 2) for h in headers), f"PNG headers {headers}")
    for i, c in enumerate(calls):
        log(f"{label} generate call {i}: encode {c['encode_s']:.3f} s, denoise {c['denoise_s']:.3f} s "
            f"({c['denoise_s'] / STEPS:.4f} s/step, B={BRANCH}), decode {c['decode_s']:.3f} s")
    log(f"{label} per-call seconds (generate span): {[round(s, 3) for s in timer.spans['generate']]}; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    return launches, calls, peak


def small_dit_inputs(torch, cfg_d, B=1, ty=16, tx=16, lt=64, seed=1):
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids

    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    args = (torch.randn((B, ty * tx, cfg_d.in_channels), generator=gen, device="cuda").to(bf),
            torch.randn((B, lt, cfg_d.text_dim), generator=gen, device="cuda").to(bf),
            torch.randn((B, cfg_d.pooled_dim), generator=gen, device="cuda").to(bf),
            torch.full((B,), 0.5, dtype=bf, device="cuda"),
            torch.from_numpy(make_image_ids(ty, tx)).cuda(), torch.from_numpy(make_text_ids(lt)).cuda())
    return args, torch.full((B,), 3.5, dtype=bf, device="cuda")


def bf16_phase(torch):
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    t0 = time.perf_counter()
    pipe = FluxPipeline.random_init(torch.Generator(device="cuda").manual_seed(0),
                                    dtype=torch.bfloat16, device="cuda")
    pipe.attn_impl = "pallas"
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("dit", "t5", "clip", "vae")}
    log(f"random_init {time.perf_counter() - t0:.1f} s, params {n_params}")

    launches, calls, peak = serve(torch, pipe, "bf16")
    n_blocks = pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks
    expected = {name: 0 for name in launches}
    expected["flash_fwd"] = STEPS * n_blocks * N_PROMPTS
    log(f"bf16 launches in the main path: {launches} (expected {expected})")
    check(launches == expected, "the bf16 main path did not run K1 the expected number of times")

    # the whole DiT at full width on a small input: K1 against the plain attention
    args, g = small_dit_inputs(torch, pipe.dit_cfg)
    with torch.no_grad():
        v_k1 = pipe.dit(*args, guidance=g, attn_impl="pallas").float()
        v_plain = pipe.dit(*args, guidance=g, attn_impl="xla").float()
    rel = ((v_k1 - v_plain).abs().max() / v_plain.abs().max()).item()
    log(f"DiT forward (full width, L=320): max|K1 - plain| / max|plain| = {rel:.3e} (tol {DIT_REL_TOL})")
    check(bool(torch.isfinite(v_k1).all()) and rel <= DIT_REL_TOL, "DiT with K1 disagrees with plain attention")
    return pipe, launches, calls, peak


def _family(key: str) -> str:
    """Kernel name -> family of the profiler splits."""
    name = key.lower()
    for tag, grp in (("flash_fwd_nr", "K9 flash_fwd_nr"), ("nr_prep_k", "K9 flash_fwd_nr"),
                     ("flash_fwd_int8", "K8 flash_fwd_int8"), ("int8_prep_k", "K8 flash_fwd_int8"),
                     ("flash_chunk_fwd", "K7a flash_chunk_fwd"), ("flash_chunk_bwd_dq", "K7b flash_chunk_bwd_dq"),
                     ("flash_chunk_bwd_dkv", "K7c flash_chunk_bwd_dkv"),
                     ("flash_fwd", "K1 flash_fwd"), ("flash_bwd_dq", "K6a flash_bwd_dq"),
                     ("flash_bwd_dkv", "K6b flash_bwd_dkv"), ("norm_rope", "K2 norm_rope"),
                     ("act_quant", "K3-K5 act_quant")):
        if tag in name:
            return grp
    if any(t in name for t in ("gemm", "xmma", "cutlass", "imma", "nvjet")):
        return "int8 GEMM" if any(t in name for t in ("s8", "i8", "int8", "imma")) else "bf16 GEMM"
    if "elementwise" in name or "vectorized" in name or "reduce" in name:
        return "elementwise"
    return "other"


def log_split(label: str, events, wall_s: float) -> dict:
    groups: dict[str, float] = {}
    other: dict[str, float] = {}
    for key, us in events:
        grp = _family(key)
        if grp == "other":
            other[key[:90]] = other.get(key[:90], 0.0) + us
        groups[grp] = groups.get(grp, 0.0) + us
    busy = sum(groups.values()) / 1e3
    log(f"{label}: wall {wall_s * 1e3:.1f} ms, device kernels {busy:.1f} ms "
        f"({busy / (wall_s * 1e3):.1%} busy)")
    for grp, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {grp}: {us / 1e3:.2f} ms ({us / 1e3 / busy:.1%})")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    other: {us / 1e3:.2f} ms  {name}")
    return {"wall_ms": wall_s * 1e3, "device_ms": busy, **{k: v / 1e3 for k, v in groups.items()}}


def run_train(torch, pipe, cfg, tmp: str, label: str) -> dict:
    """`train()` over a synthetic 512 px PNG shard written to `tmp`, with every
    launch count set to 0 just before and read just after; checks the loss,
    the gradient norm, the adapters, the checkpoint and the metric rows."""
    from reflectionflow_tpu_torch.train.data import GenRefDataset, write_synthetic_shard
    from reflectionflow_tpu_torch.train.train_loop import latest_checkpoint, train

    d = cfg.data
    cfg.checkpoint_dir = os.path.join(tmp, "ckpt")
    shard = os.path.join(tmp, "genref_000.tar")
    t0 = time.perf_counter()
    write_synthetic_shard(shard, n=2 * d.batch_size, size=d.target_size)
    log(f"{label}: synthetic shard of {2 * d.batch_size} samples at {d.target_size} px in "
        f"{time.perf_counter() - t0:.1f} s")

    def dataset():
        return GenRefDataset(shards=[shard], batch_size=d.batch_size, target_size=d.target_size,
                             condition_size=d.condition_size, seed=cfg.seed)

    moved = []

    def hook(step, adapters, row):
        if step == 0:
            moved.append(any(bool(ab["lora_B"].abs().sum() > 0) for ab in adapters.values()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    t0 = time.perf_counter()
    out = train(pipe, cfg, dataset(), hooks=[hook])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(cfg.checkpoint_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    latest = latest_checkpoint(cfg.checkpoint_dir)
    for r in rows:
        log(f"{label} step {r['step']}: loss {r['loss']:.5f}, grad_norm {r['grad_norm']:.4e}, "
            f"t_mean {r['t_mean']:.3f}, {r['step_time_s']:.3f} s")
    s_per_step = sum(r["step_time_s"] for r in rows[1:]) / (len(rows) - 1)
    log(f"{label}: {cfg.max_steps} steps in {wall:.1f} s; {s_per_step:.3f} s/step (steps 2-{cfg.max_steps}, "
        f"B={d.batch_size}, {d.target_size} px); peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    check(len(rows) == cfg.max_steps and latest == cfg.max_steps, f"{len(rows)} metric rows, latest {latest}")
    check(all(math.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows), "bad loss or grad_norm")
    check(moved == [True], "the adapters' B did not move after step 1")
    return {"adapters": out["adapters"], "rows": rows, "launches": launches, "peak": peak,
            "s_per_step": s_per_step, "raw": next(iter(dataset()))}


def adapter_grad_cosines(torch, pipe, adapters, raw, impls, model_flags=None):
    """At B=1, the adapter gradients of one rf_loss under each of the two
    impls (the same t and noise): cosine per adapter family, and the launch
    counts of the first impl's forward and backward."""
    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.train.rectified_flow import prepare_batch_tensors, rf_loss

    lc, d = TrainConfig().lora, TrainConfig().data
    one = {k: v[:1] for k, v in raw.items()}
    batch = prepare_batch_tensors(pipe, one, (0, -d.condition_size // 16))
    g = torch.Generator(device="cuda").manual_seed(2)
    t = torch.sigmoid(torch.randn((1,), generator=g, device="cuda"))
    noise = torch.randn(batch["x0"].shape, generator=g, device="cuda")
    names = list(adapters)
    params = [adapters[n][k] for n in names for k in ("lora_A", "lora_B")]
    grads, launches = {}, None
    for impl in impls:
        counters = zero_counts()
        loss, _ = rf_loss(adapters, pipe.dit, batch, alpha=lc.alpha, r=lc.r, model_flags=model_flags,
                          attn_impl=impl, t=t, noise=noise)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        if launches is None:
            launches = {name: fn.launches for name, fn in counters.items()}
        grads[impl] = [torch.zeros_like(p) if x is None else x for x, p in zip(gs, params)]
        log(f"B=1 {impl} (model_flags {model_flags}): loss {loss.item():.6f}")
    fams: dict[str, list[int]] = {}
    for i, n in enumerate(names):
        fam = ".".join(p for p in n.split(".") if not p.isdigit())
        fams.setdefault(fam, []).extend((2 * i, 2 * i + 1))
    cos, zero = {}, []
    for fam, idx in fams.items():
        a, b = (torch.cat([grads[impl][i].flatten().float() for i in idx]) for impl in impls)
        if not (a.any() or b.any()):  # a family the loss does not reach under these flags
            zero.append(fam)
            continue
        cos[fam] = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    log(f"B=1 adapter-gradient cosine, {impls[0]} vs {impls[1]}, per family: "
        + ", ".join(f"{f} {c:.6f}" for f, c in cos.items())
        + (f"; exactly 0 under both: {', '.join(zero)}" if zero else ""))
    check(bool(cos), "every adapter gradient is 0")
    return cos, launches


def train_phase(torch, pipe):
    """Corrector LoRA training on the bf16 FLUX.1-dev pipeline at full width
    and depth: `train()` with TrainConfig's defaults (batch 8, target and
    condition 512 px, r = alpha = 32, prodigy, grad clip 0.5) and
    attn_impl="pallas", over a synthetic 512 px PNG shard, for 3 steps. Checks
    the loss, the gradient norm, the adapters, the checkpoint and the metric
    rows, and exactly 114 K1, 57 K6a and 57 K6b launches per step (forward,
    recomputation, backward of 57 attention calls). Then a profiler split of
    one more step, and at B=1 the adapter gradients with K1 + K6 against the
    plain attention."""
    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora.lora import lora_parameters
    from reflectionflow_tpu_torch.train.rectified_flow import (
        make_optimizer, make_train_step, prepare_batch_tensors)

    cfg = TrainConfig()
    cfg.attn_impl, cfg.max_steps = "pallas", TRAIN_STEPS
    d = cfg.data
    n_blocks = pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks
    with tempfile.TemporaryDirectory() as tmp:
        run = run_train(torch, pipe, cfg, tmp, "train")
        launches = run["launches"]
        expected = {name: 0 for name in launches}
        expected.update(flash_fwd=2 * n_blocks * TRAIN_STEPS, flash_bwd_dq=n_blocks * TRAIN_STEPS,
                        flash_bwd_dkv=n_blocks * TRAIN_STEPS)
        log(f"train launches {launches} (expected {expected})")
        check(launches == expected, "training did not run K1/K6a/K6b the expected number of times")

        # a profiler split of one more step on the trained adapters
        raw = run["raw"]
        batch = prepare_batch_tensors(pipe, raw, (0, -d.condition_size // 16))
        adapters = run["adapters"]
        opt = make_optimizer(cfg)
        opt_state = opt.init(lora_parameters({"adapters": adapters}))
        step = make_train_step(pipe.dit, opt, alpha=cfg.lora.alpha, r=cfg.lora.r, attn_impl="pallas")
        gen = torch.Generator(device="cuda").manual_seed(1)
        wall_prof = []

        def one_step():
            t1 = time.perf_counter()
            step(adapters, opt_state, batch, gen)
            torch.cuda.synchronize()
            wall_prof.append(time.perf_counter() - t1)

        events = profiled(torch, one_step)
        prof = log_split(f"train step profile (B={d.batch_size}, L=512+1024+1024)", events, wall_prof[0])
        log(f"train step: K6a {prof.get('K6a flash_bwd_dq', 0.0):.2f} ms, K6b "
            f"{prof.get('K6b flash_bwd_dkv', 0.0):.2f} ms device time (57 launches each), "
            f"K1 {prof.get('K1 flash_fwd', 0.0):.2f} ms (114)")
        del opt_state, batch

        # B=1: adapter gradients with K1 + K6 against the plain attention
        cos, _ = adapter_grad_cosines(torch, pipe, adapters, raw, ("pallas", "xla"))
        check(min(cos.values()) >= TRAIN_COS, f"adapter gradients disagree (min cosine {min(cos.values())})")
    torch.cuda.empty_cache()
    return {"s_per_step": run["s_per_step"], "peak_gib": run["peak"] / 2**30, "launches": launches,
            "rows": run["rows"], "profile_ms": prof, "grad_cosine_min": min(cos.values()),
            "grad_cosine": cos, "adapters": adapters}


def ring_phase(torch, pipe):
    """Sequence-parallel ring attention on the bf16 pipeline, over a mesh of
    RING slots on the card(s) (`make_mesh((4,), ("seq",), devices=[cuda:i % n
    ...])`, set with `set_ring_context`):
      (i) `ring_attention` at (2, 5632), main_len 4608, under the three cross
          forms, forward and backward, against the fp32 plain dense attention
          (K1/K6 limits) and against K1 + K6 over the whole sequence (printed);
      (ii) `train()` with attn_impl="ring_pallas" at TrainConfig's defaults for
          2 steps: exactly 2 x 57 x p^2 K7a (forward and remat recomputation),
          57 x p^2 K7b and 57 x p^2 K7c a step, no K1/K6; then at B=1 with
          union_cond_attn=False (live offsets and cross bias; add_cond_attn so
          that the adapters reach the loss) the adapter gradients against
          K1 + K6 under the same flags;
      (iii) a conditioned `denoise` at 1024 px with a 512 px condition (B=2
          with image CFG, L=5632), 2 steps, union_cond_attn=False, under
          "ring_pallas" and "pallas": steps x 57 x p^2 K7a and no K1 under the
          ring, final latents agree."""
    from reflectionflow_tpu_torch.ops.attention import set_ring_context
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    mesh = make_mesh((RING,), ("seq",), devices=[torch.device("cuda", i % n) for i in range(RING)])
    log(f"ring mesh {mesh}")
    set_ring_context(mesh, "seq")
    try:
        t0 = time.perf_counter()
        attn = ring_attention_check(torch, mesh)
        t1 = time.perf_counter()
        train = ring_train(torch, pipe)
        t2 = time.perf_counter()
        den = ring_denoise(torch, pipe)
        t3 = time.perf_counter()
    finally:
        set_ring_context(None)
    log(f"ring phase: attention check {t1 - t0:.1f} s, training {t2 - t1:.1f} s, denoise {t3 - t2:.1f} s")
    return {"attention": attn, "train": train, "denoise": den}


def ring_attention_check(torch, mesh):
    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_ref, flash_attention_ref)
    from reflectionflow_tpu_torch.ops.ring_attention import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(12)
    B, L, main_len = 2, LT + LI + LC, LT + LI
    q, k, v, do = (torch.randn((B, L, 24, D), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    res = {"out_err": 0.0, "grad_rel": 0.0, "vs_k1_out": 0.0, "vs_k6_grad_rel": 0.0}

    def run(attend):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attend(*xs)
        out.backward(do)
        torch.cuda.synchronize()
        return out.detach(), [x.grad for x in xs]

    for cb in (0.0, math.log(0.5), -1e30):
        r_out, r_grads = run(lambda a, b, c: ring_attention(a, b, c, mesh, "seq", "pallas", main_len, cb))  # noqa: B023
        k_out, k_grads = run(lambda a, b, c: flash_attention(a, b, c, main_len, cb))  # noqa: B023
        e_out, rels = 0.0, [0.0, 0.0, 0.0]
        for b in range(B):  # the fp32 dense reference one batch element at a time (≈ 12 GB of logits)
            sl = slice(b, b + 1)
            w_out, w_lse = flash_attention_ref(q[sl].float(), k[sl].float(), v[sl].float(), main_len, cb)
            e_out = max(e_out, (r_out[sl].float() - w_out).abs().max().item())
            want = flash_attention_bwd_ref(q[sl], k[sl], v[sl], w_out, w_lse, do[sl], main_len, cb)
            for i, (g, w) in enumerate(zip(r_grads, want)):
                rels[i] = max(rels[i], ((g[sl].float() - w).abs().max() / w.abs().max()).item())
            del w_out, w_lse, want
            torch.cuda.empty_cache()
        vs_out = (r_out.float() - k_out.float()).abs().max().item()
        vs_rel = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                     for a, b in zip(r_grads, k_grads))
        log(f"ring_attention (B={B}, L={L}, p={RING}) main_len={main_len} cross_bias={cb}: against fp32 "
            f"dense attention max|out err| {e_out:.3e} (tol {OUT_TOL}), dq/dk/dv "
            f"{', '.join(f'{r:.2e}' for r in rels)} of max|ref| (tol {K6_REL_TOL}); against K1 + K6 "
            f"max|out diff| {vs_out:.3e}, grads {vs_rel:.2e} of max|K6|")
        check(bool(torch.isfinite(r_out).all()) and e_out <= OUT_TOL and max(rels) <= K6_REL_TOL,
              f"ring attention disagrees with dense attention at cross_bias={cb}")
        res.update(out_err=max(res["out_err"], e_out), grad_rel=max(res["grad_rel"], *rels),
                   vs_k1_out=max(res["vs_k1_out"], vs_out), vs_k6_grad_rel=max(res["vs_k6_grad_rel"], vs_rel))
        del r_out, r_grads, k_out, k_grads

    # one call's time, forward and forward + backward, ring against K1 (+ K6)
    with torch.no_grad():
        t_ring, t_k1 = in_turns(torch, lambda: ring_attention(q, k, v, mesh, "seq", "pallas", main_len, 0.0),
                                lambda: flash_attention(q, k, v, main_len, 0.0), 10, 10)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]

    def fwd_bwd(attend):
        return lambda: torch.autograd.grad(attend(*xs), xs, do)

    t_ring_fb, t_k_fb = in_turns(
        torch, fwd_bwd(lambda a, b, c: ring_attention(a, b, c, mesh, "seq", "pallas", main_len, 0.0)),
        fwd_bwd(lambda a, b, c: flash_attention(a, b, c, main_len, 0.0)), 5, 5)
    res.update(ring_fwd_ms=t_ring, k1_fwd_ms=t_k1, ring_fwd_bwd_ms=t_ring_fb, k1_k6_fwd_bwd_ms=t_k_fb)
    log(f"ring_attention (B={B}, L={L}, p={RING}) one call: forward {t_ring:.3f} ms (K1 {t_k1:.3f}), "
        f"forward + backward {t_ring_fb:.3f} ms (K1 + K6 {t_k_fb:.3f})")
    del q, k, v, do, xs
    torch.cuda.empty_cache()
    return res


def ring_train(torch, pipe):
    from reflectionflow_tpu_torch.config import TrainConfig

    cfg = TrainConfig()
    cfg.attn_impl, cfg.max_steps = "ring_pallas", RING_TRAIN_STEPS
    n_blocks = pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks
    chunks = n_blocks * RING * RING  # chunk calls per pass over the DiT
    with tempfile.TemporaryDirectory() as tmp:
        run = run_train(torch, pipe, cfg, tmp, "ring train")
        launches = run["launches"]
        expected = {name: 0 for name in launches}
        expected.update(flash_chunk_fwd=2 * chunks * cfg.max_steps, flash_chunk_bwd_dq=chunks * cfg.max_steps,
                        flash_chunk_bwd_dkv=chunks * cfg.max_steps)
        log(f"ring train launches {launches} (expected {expected})")
        check(launches == expected, "ring training did not run K7a/K7b/K7c the expected number of times")
        # B=1, union_cond_attn=False: the offsets and the cross bias are live in forward and backward.
        # The mask cuts the cond stream (the only one the adapters act on) off the image tokens, so
        # add_cond_attn=True carries its attention output into the image stream: else every adapter
        # gradient would be 0 under both impls
        cos, live = adapter_grad_cosines(torch, pipe, run["adapters"], run["raw"], ("ring_pallas", "pallas"),
                                         model_flags={"union_cond_attn": False, "add_cond_attn": True})
        expected_live = {name: 0 for name in live}
        expected_live.update(flash_chunk_fwd=2 * chunks, flash_chunk_bwd_dq=chunks, flash_chunk_bwd_dkv=chunks)
        log(f"B=1 ring_pallas (union_cond_attn=False, add_cond_attn=True) launches {live} "
            f"(expected {expected_live})")
        check(live == expected_live, "the B=1 ring gradient did not run K7a/K7b/K7c as expected")
        check(min(cos.values()) >= TRAIN_COS,
              f"ring adapter gradients disagree with K1 + K6 (min cosine {min(cos.values())})")
    torch.cuda.empty_cache()
    return {"s_per_step": run["s_per_step"], "peak_gib": run["peak"] / 2**30, "launches": launches,
            "rows": run["rows"], "live_launches": live, "grad_cosine_min": min(cos.values()),
            "grad_cosine": cos}


def ring_denoise(torch, pipe):
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
    from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule

    cfg_d = pipe.dit_cfg
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(pipe.dtype)

    ty = tx = 2 * LT // 16  # 1024 px: 64 x 64 packed tokens
    cy = cx = LT // 16  # the 512 px condition: 32 x 32
    lat, txt, pooled = randn(1, ty * tx, cfg_d.in_channels), randn(1, LT, cfg_d.text_dim), randn(1, cfg_d.pooled_dim)
    cond, cond_empty = randn(1, cy * cx, cfg_d.in_channels), randn(1, cy * cx, cfg_d.in_channels)
    ids = dict(img_ids=torch.from_numpy(make_image_ids(ty, tx)).cuda(),
               txt_ids=torch.from_numpy(make_text_ids(LT)).cuda(),
               cond_ids=torch.from_numpy(make_image_ids(cy, cx, position_delta=(0, -cx))).cuda())
    sigmas = make_schedule(RING_DENOISE_STEPS, ty * tx)
    n_blocks = cfg_d.num_double_blocks + cfg_d.num_single_blocks
    outs, res = {}, {}
    for impl in ("ring_pallas", "pallas"):
        torch.cuda.synchronize()
        counters = zero_counts()
        t0 = time.perf_counter()
        outs[impl] = denoise(pipe.dit, lat, txt, pooled, ids["img_ids"], ids["txt_ids"], sigmas, 3.5,
                             RING_DENOISE_STEPS, cond=cond, cond_ids=ids["cond_ids"], cond_empty=cond_empty,
                             cond_dit_params=pipe.dit, image_guidance_scale=IMAGE_CFG,
                             union_cond_attn=False, attn_impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        res[impl] = {"s_per_step": wall / RING_DENOISE_STEPS, "launches": launches}
        log(f"ring denoise {impl} (B=2 with image CFG, L={LT}+{LI}+{LC}, union_cond_attn=False): "
            f"{RING_DENOISE_STEPS} steps in {wall:.3f} s; launches {launches}")
        check(tuple(outs[impl].shape) == (1, ty * tx, cfg_d.in_channels)
              and bool(torch.isfinite(outs[impl]).all()), f"ring denoise {impl}: bad latents")
    expected = {name: 0 for name in res["ring_pallas"]["launches"]}
    expected["flash_chunk_fwd"] = RING_DENOISE_STEPS * n_blocks * RING * RING
    check(res["ring_pallas"]["launches"] == expected,
          f"the ring denoise did not run K7a as expected ({expected})")
    cos = torch.nn.functional.cosine_similarity(outs["ring_pallas"].float().flatten(),
                                                outs["pallas"].float().flatten(), dim=0).item()
    log(f"ring denoise: cosine(ring_pallas, pallas) of the final latents {cos:.6f} (min {RING_COS})")
    check(cos >= RING_COS, "the ring denoise disagrees with K1")
    res["cosine"] = cos
    return res


def validation_phase(torch, pipe, adapters):
    """`make_validation_hook` once on the trained adapters, as `train` would
    call it at step `sample_interval`: a conditioned generate (no image CFG)
    of 2 val samples at TrainConfig's 512 px, 20 steps, through the bf16
    pipeline with K1: exactly 20 x 57 K1 launches, 2 PNGs of 512x512x3, and
    `cond_dit_params` restored."""
    import numpy as np

    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.train.train_loop import make_validation_hook

    cfg = TrainConfig()
    d = cfg.data
    rng = np.random.default_rng(7)
    val = [{"prompt": p, "condition": rng.integers(0, 256, (d.condition_size, d.condition_size, 3),
                                                   dtype=np.uint8)}
           for p in ("a photo of a red cube", "a photo of a blue sphere")]
    n_blocks = pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks
    before = pipe.cond_dit_params
    with tempfile.TemporaryDirectory() as out_dir:
        hook = make_validation_hook(pipe, cfg, val, out_dir)
        torch.cuda.synchronize()
        counters = zero_counts()
        t0 = time.perf_counter()
        hook(cfg.sample_interval - 1, adapters, {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        pngs = sorted(os.listdir(out_dir))
        headers = [read_png_header(os.path.join(out_dir, p)) for p in pngs]
    torch.cuda.empty_cache()
    expected = {name: 0 for name in launches}
    expected["flash_fwd"] = 20 * n_blocks
    log(f"validation hook (2 samples, {d.target_size} px, 20 steps, fold included): {wall:.1f} s; "
        f"files {pngs}; launches {launches} (expected {expected})")
    check(pngs == [f"step{cfg.sample_interval}_{i:02d}.png" for i in range(2)]
          and all(h == (d.target_size, d.target_size, 8, 2) for h in headers),
          f"validation hook wrote {pngs} {headers}")
    check(launches == expected, "the validation hook did not run K1 the expected number of times")
    check(pipe.cond_dit_params is before, "the validation hook did not restore cond_dit_params")
    return {"wall_s": wall, "launches": launches}


def profile_step(torch, pipe):
    """Device time of one W8A8 DiT forward at B=2, 1024px, by kernel family."""
    args, g = small_dit_inputs(torch, pipe.dit_cfg, B=2, ty=64, tx=64, lt=LT, seed=3)
    kw = dict(guidance=g, attn_impl="pallas", rope_layout="split")
    wall = []

    def step():
        t0 = time.perf_counter()
        pipe.dit(*args, **kw)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    with torch.no_grad():
        pipe.dit(*args, **kw)
        torch.cuda.synchronize()
        events = profiled(torch, step)
    return log_split(f"W8A8 step profile (B=2, L={LT}+{LI})", events, wall[0])


def w8a8_phase(torch, pipe, adapters):
    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora.lora import make_dit_param_views
    from reflectionflow_tpu_torch.ops.quant import QuantLinear

    # the corrector's cond model: the trained adapters folded into a copy of the
    # bf16 DiT before quantization, the JAX CLI's order; quantize converts both
    lc = TrainConfig().lora
    torch.cuda.synchronize()
    log(f"device memory before the fold: {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    _, pipe.cond_dit_params = make_dit_param_views(
        pipe.dit, {"_alpha": lc.alpha, "_r": lc.r, "adapters": adapters})
    torch.cuda.synchronize()
    log(f"fold of the trained adapters into the cond model: {time.perf_counter() - t0:.1f} s; "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    pipe.quantize(int4=(), weight_only=("t5",))  # the CLI's --quantize int8 profile
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    modes = {name: [m.act_quant for m in model.modules() if isinstance(m, QuantLinear)]
             for name, model in (("dit", pipe.dit), ("cond", pipe.cond_dit_params), ("t5", pipe.t5))}
    log(f"quantize {time.perf_counter() - t0:.1f} s: DiT {sum(modes['dit'])} W8A8 + "
        f"{len(modes['dit']) - sum(modes['dit'])} w8a16 linears, cond model {sum(modes['cond'])} W8A8, "
        f"T5 {len(modes['t5'])} w8a16; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(pipe.rope_layout == "split" and all(modes["dit"]) and modes["t5"] and not any(modes["t5"])
          and modes["cond"] == modes["dit"] and pipe.cond_dit_params.rope_layout == "split",
          "pipe.quantize did not make the W8A8 serving layout of both models")

    # the cond model's own weights (what it does not share with the DiT), resident while t2i serves
    dit_ptrs = {t.data_ptr() for t in (*pipe.dit.parameters(), *pipe.dit.buffers())}
    cond_gib = sum(t.numel() * t.element_size() for t in (*pipe.cond_dit_params.parameters(),
                                                          *pipe.cond_dit_params.buffers())
                   if t.data_ptr() not in dit_ptrs) / 2**30
    log(f"W8A8 cond model weights resident: {cond_gib:.2f} GiB")

    launches, calls, peak = serve(torch, pipe, "w8a8")
    log(f"W8A8 t2i peak {peak / 2**30:.2f} GiB, of which {cond_gib:.2f} GiB are the resident cond "
        f"model's weights ({peak / 2**30 - cond_gib:.2f} GiB without them)")
    cfg_d = pipe.dit_cfg
    nd, ns = cfg_d.num_double_blocks, cfg_d.num_single_blocks
    per_forward = {name: 0 for name in launches}
    per_forward.update(flash_fwd=nd + ns, norm_rope=4 * nd + 2 * ns, adaln_quant=4 * nd + ns,
                       gelu_quant=2 * nd + ns, rowquant=2 * nd + ns)
    expected = {k: v * STEPS * N_PROMPTS for k, v in per_forward.items()}
    log(f"W8A8 launches in the main path: {launches} (expected {expected})")
    check(launches == expected, "the W8A8 main path did not run K1–K5 the expected number of times")

    # the whole W8A8 DiT at full width on a small input: fused (K1–K5) vs plain serving path
    args, g = small_dit_inputs(torch, cfg_d)
    with torch.no_grad():
        v_fused = pipe.dit(*args, guidance=g, attn_impl="pallas", rope_layout="split").float()
        v_plain = pipe.dit(*args, guidance=g, attn_impl="xla", rope_layout="split").float()
    cos = torch.nn.functional.cosine_similarity(v_fused.flatten(), v_plain.flatten(), dim=0).item()
    log(f"W8A8 DiT forward (full width, L=320): cosine(fused, plain serving path) = {cos:.6f} "
        f"(min {W8A8_COS})")
    check(bool(torch.isfinite(v_fused).all()) and cos >= W8A8_COS,
          "the fused W8A8 DiT disagrees with the plain serving path")
    ragged = ragged_phase(torch, pipe, per_forward)
    return launches, calls, peak, cond_gib, profile_step(torch, pipe), ragged


def ragged_phase(torch, pipe, per_forward):
    """The W8A8 path at lengths that are not multiples of 8, where the JAX
    package's gate leaves its fused kernels: one served `generate` call at
    1008x1008 (3969 image tokens) with 77 text tokens, one Euler step, B=2,
    must launch K1–K5 as often as one forward at 1024px does; and a full-width
    forward at such lengths agrees between the fused and plain serving paths."""
    counters = zero_counts()
    lat = pipe.generate(["a photo of a red cube", "a photo of a blue sphere"], height=1008, width=1008,
                        num_inference_steps=1, max_sequence_length=77, seed=0, output_type="latent")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"W8A8 ragged generate (L=77+3969): launches {launches} (expected {per_forward})")
    check(tuple(lat.shape) == (2, 63 * 63, 64) and bool(torch.isfinite(lat).all()),
          "the ragged W8A8 generate gave bad latents")
    check(launches == per_forward, "the ragged W8A8 generate did not run K1–K5 once per linear")

    args, g = small_dit_inputs(torch, pipe.dit_cfg, ty=15, tx=15, lt=77, seed=4)
    with torch.no_grad():
        v_fused = pipe.dit(*args, guidance=g, attn_impl="pallas", rope_layout="split").float()
        v_plain = pipe.dit(*args, guidance=g, attn_impl="xla", rope_layout="split").float()
    cos = torch.nn.functional.cosine_similarity(v_fused.flatten(), v_plain.flatten(), dim=0).item()
    log(f"W8A8 DiT forward (full width, L=77+225): cosine(fused, plain serving path) = {cos:.6f} "
        f"(min {W8A8_COS})")
    check(bool(torch.isfinite(v_fused).all()) and cos >= W8A8_COS,
          "the fused W8A8 DiT disagrees with the plain serving path at ragged lengths")
    return {"launches": launches, "cosine": cos}


def _cond_inputs(torch, cfg_d, B, ty, tx, seed):
    """Random cond tokens (B, ty*tx, C) and their ids at the 'cot' position delta."""
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cond = torch.randn((B, ty * tx, cfg_d.in_channels), generator=gen, device="cuda").to(torch.bfloat16)
    return cond, torch.from_numpy(make_image_ids(ty, tx, position_delta=(0, -tx))).cuda()


def corrector_phase(torch, pipe):
    """`run_samples` over 2 synthetic items at 1024 px (512 px condition, 8
    steps, image CFG 1.5: B=2, L=512+4096+1024 per forward) under "pallas_nr"
    and "pallas_int8", with every launch count set to 0 just before each run
    and read just after; then a full-width W8A8 forward with the cond stream
    under each impl against the plain "xla" serving path, and a profiler split
    of one corrector step under "pallas_nr"."""
    from argparse import Namespace

    import numpy as np

    from reflectionflow_tpu_torch.cli.sample import run_samples
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.sampler import pipeline as pipeline_mod
    from reflectionflow_tpu_torch.search.artifacts import save_image

    cfg = TTSConfig.load(os.path.join(REPO, "configs", "flux.1_dev_fake.json"))
    pa = cfg.pipeline_args
    pa.num_inference_steps = STEPS
    check(pa.height == pa.width == LT * 2 and pa.condition_size == LT,
          "flux.1_dev_fake.json no longer serves 1024 px with a 512 px condition")
    pipe.model_flags = {"union_cond_attn": cfg.model.union_cond_attn,
                        "add_cond_attn": cfg.model.add_cond_attn}
    cfg_d = pipe.dit_cfg
    nd, ns = cfg_d.num_double_blocks, cfg_d.num_single_blocks
    quant = {"adaln_quant": 6 * nd + 2 * ns, "gelu_quant": 3 * nd + 2 * ns, "rowquant": 3 * nd + 2 * ns}
    per_forward = {"pallas_nr": {"flash_fwd_nr": nd + ns, **quant},
                   "pallas_int8": {"flash_fwd_int8": nd + ns, "norm_rope": 6 * nd + 4 * ns, **quant}}
    rng = np.random.default_rng(9)
    runs = {}
    generate, denoise = pipe.generate, pipeline_mod.denoise
    with tempfile.TemporaryDirectory() as tmp:
        items = []
        for i in range(CORR_ITEMS):
            save_image(os.path.join(tmp, f"bad{i}.png"), rng.integers(0, 256, (768, 1024, 3), dtype=np.uint8))
            save_image(os.path.join(tmp, f"good{i}.png"), rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8))
            items.append({"prompt": ("a photo of a red cube", "a photo of two dogs")[i],
                          "bad_image": f"bad{i}.png", "good_image": f"good{i}.png",
                          "reflection": ("make the cube blue", "add a second dog on the left")[i]})
        for impl in ("pallas_nr", "pallas_int8"):
            pipe.attn_impl = impl
            calls, denoise_s = [], []

            def denoise_timed(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = denoise(*a, **kw)
                torch.cuda.synchronize()
                denoise_s.append(time.perf_counter() - t0)
                return out

            def generate_checked(prompts, **kw):
                torch.cuda.synchronize()
                txt, pooled = pipe.encode_prompts(prompts, kw["max_sequence_length"], kw["prompts_2"])
                torch.cuda.synchronize()
                t_b = time.perf_counter()
                lat = generate(prompts, txt=txt, pooled=pooled, **{**kw, "output_type": "latent"})
                torch.cuda.synchronize()
                calls.append(time.perf_counter() - t_b)
                check(tuple(lat.shape) == (1, LI, 64) and bool(torch.isfinite(lat).all()),
                      f"corrector {impl}: bad final latents {tuple(lat.shape)}")
                return pipe.decode_latents(lat, kw["height"], kw["width"])

            pipe.generate, pipeline_mod.denoise = generate_checked, denoise_timed
            cfg.output_dir = os.path.join(tmp, impl)
            args = Namespace(seed=0, start_index=0, root_dir=tmp, image_guidance_scale=IMAGE_CFG)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters = zero_counts()
            run_samples(pipe, items, cfg, args)
            launches = {name: fn.launches for name, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            pipe.generate, pipeline_mod.denoise = generate, denoise
            sheets = sorted(os.listdir(cfg.output_dir))
            headers = [read_png_header(os.path.join(cfg.output_dir, f)) for f in sheets]
            expected = {name: 0 for name in launches}
            expected.update({k: v * CORR_ITEMS * STEPS for k, v in per_forward[impl].items()})
            check(len(calls) == len(denoise_s) == CORR_ITEMS,
                  f"corrector {impl}: {len(calls)} generate and {len(denoise_s)} denoise calls timed")
            encode = [c - d for c, d in zip(calls, denoise_s)]
            log(f"corrector {impl}: per item denoise {[round(d, 3) for d in denoise_s]} s, condition "
                f"encode {[round(e, 3) for e in encode]} s; {denoise_s[-1] / STEPS:.4f} s/step over "
                f"denoise (second item, B=2 with image CFG, L={LT}+{LI}+{LC}); peak device memory "
                f"{peak / 2**30:.2f} GiB; launches {launches} (expected {expected})")
            check(sheets == [f"result_{i}.png" for i in range(CORR_ITEMS)]
                  and all(h == (3 * pa.width, pa.height, 8, 2) for h in headers),
                  f"corrector {impl} wrote {sheets} {headers}")
            check(launches == expected, f"the corrector under {impl} did not run its kernels as expected")
            runs[impl] = {"s_per_step": denoise_s[-1] / STEPS, "encode_s": encode[-1],
                          "peak_gib": peak / 2**30, "launches": launches}

    # the whole W8A8 DiT with the cond stream at full width on a small input
    args, g = small_dit_inputs(torch, cfg_d)
    cond, cond_ids = _cond_inputs(torch, cfg_d, 1, 8, 8, seed=5)
    kw = dict(guidance=g, rope_layout="split", cond=cond, cond_ids=cond_ids, cond_params=pipe.cond_dit_params)
    with torch.no_grad():
        v_plain = pipe.dit(*args, attn_impl="xla", **kw).float()
        for impl in ("pallas_nr", "pallas_int8"):
            v = pipe.dit(*args, attn_impl=impl, **kw).float()
            cos = torch.nn.functional.cosine_similarity(v.flatten(), v_plain.flatten(), dim=0).item()
            log(f"W8A8 DiT forward with the cond stream (full width, L=64+256+64), {impl}: "
                f"cosine(fused, plain serving path) = {cos:.6f} (min {W8A8_COS})")
            check(bool(torch.isfinite(v).all()) and cos >= W8A8_COS,
                  f"the W8A8 DiT with the cond stream under {impl} disagrees with the plain serving path")
            runs[impl]["cosine"] = cos

    # a profiler split of one corrector step (one doubled-batch forward) under pallas_nr
    args, g = small_dit_inputs(torch, cfg_d, B=2, ty=64, tx=64, lt=LT, seed=6)
    cond, cond_ids = _cond_inputs(torch, cfg_d, 2, 32, 32, seed=7)
    kw = dict(kw, guidance=g, attn_impl="pallas_nr", cond=cond, cond_ids=cond_ids)
    wall = []

    def step():
        t0 = time.perf_counter()
        pipe.dit(*args, **kw)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    with torch.no_grad():
        step()
        events = profiled(torch, step)
    runs["profile_ms"] = log_split(f"W8A8 corrector step profile (pallas_nr, B=2, L={LT}+{LI}+{LC})",
                                   events, wall[-1])
    return runs


def kernel_entry(name, source, replaces, launches, res, main_shape, other_shape):
    return {"name": name, "route": "cuda", "source": f"reflectionflow_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": res["err"],
            **res["by_shape"][main_shape], "shape": main_shape,
            "t2i_shape": {"shape": other_shape, **res["by_shape"][other_shape]},
            **{k: v for k, v in res.items() if k not in ("err", "by_shape")}}


def main() -> int:
    import torch

    device_phase(torch)
    sys.path.insert(0, REPO)
    from reflectionflow_tpu_torch.ops import kernel_build

    t_start = t0 = time.perf_counter()
    kernel_build.build_all()
    log(f"build {', '.join(kernel_build.SOURCES)} (in parallel): {time.perf_counter() - t0:.2f} s")
    ptxas = {src: kernel_build.ptxas_report(src) for src in kernel_build.SOURCES}
    log(json.dumps({"ptxas": ptxas}))
    hopper_sass = hopper_check(kernel_build, ptxas)
    err_out, err_lse, k1_times = k1_phase(torch)
    k6 = k6_phase(torch)
    t0 = time.perf_counter()
    k7 = k7_phase(torch)
    t_k7 = time.perf_counter() - t0
    log(f"K7 phase (3c): {k7['cases']} chunk cases in {t_k7:.1f} s")
    fused = fused_phase(torch)
    serving_attn = serving_attn_phase(torch)
    pipe, bf16_launches, bf16_calls, bf16_peak = bf16_phase(torch)
    training = train_phase(torch, pipe)
    adapters = training.pop("adapters")
    validation = validation_phase(torch, pipe, adapters)
    t0 = time.perf_counter()
    ring = ring_phase(torch, pipe)
    t_ring = time.perf_counter() - t0
    log(f"ring phase (5d): {t_ring:.1f} s")
    w8_launches, w8_calls, w8_peak, cond_gib, prof, ragged = w8a8_phase(torch, pipe, adapters)
    del adapters
    corrector = corrector_phase(torch, pipe)
    step = {name: calls[-1]["denoise_s"] / STEPS for name, calls in (("bf16", bf16_calls),
                                                                      ("w8a8", w8_calls))}
    step.update({f"corrector_{impl}": corrector[impl]["s_per_step"] for impl in ("pallas_nr", "pallas_int8")})
    log(f"s/step at B={BRANCH} (second call): bf16 {step['bf16']:.4f}, W8A8 {step['w8a8']:.4f}; "
        f"peak device memory bf16 {bf16_peak / 2**30:.2f} GiB, W8A8 {w8_peak / 2**30:.2f} GiB; "
        f"training {training['s_per_step']:.4f} s/step at B=8, peak {training['peak_gib']:.2f} GiB; "
        f"corrector (B=2, L={LT + LI + LC}) pallas_nr {step['corrector_pallas_nr']:.4f}, "
        f"pallas_int8 {step['corrector_pallas_int8']:.4f} s/step, peaks "
        f"{corrector['pallas_nr']['peak_gib']:.2f} / {corrector['pallas_int8']['peak_gib']:.2f} GiB; "
        f"ring training {ring['train']['s_per_step']:.4f} s/step, peak {ring['train']['peak_gib']:.2f} GiB")
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "reflectionflow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": f"{PA}:63",
        "launches": bf16_launches["flash_fwd"],
        "launches_w8a8": w8_launches["flash_fwd"],
        "launches_train": training["launches"]["flash_fwd"],
        "max_abs_err": err_out,
        "lse_max_abs_err": err_lse,
        **{k: k1_times["B=2 L=4608"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": "B=2 L=4608",
        "by_shape": k1_times,
    }]
    train_shape, serve_shape = "B=8 L=2560", "B=2 L=4608"
    for name, key, replaces in (("flash_bwd_dq", "dq", f"{PA}:126"), ("flash_bwd_dkv", "dkv", f"{PA}:175")):
        at = {label: k6["by_shape"][label] for label in (train_shape, serve_shape)}
        kernels.append({
            "name": name, "route": "cuda", "source": "reflectionflow_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces, "launches": training["launches"][name],
            "max_abs_err": k6[key]["err"], "rel_err": k6[key]["rel"],
            "ms": at[train_shape][key]["ms"], "plain_ms": at[train_shape]["plain_ms"],
            "bound_ms": at[train_shape][key]["bound_ms"], "bound_by": at[train_shape][key]["bound_by"],
            "bound_share": at[train_shape][key]["bound_share"], "library_ms": at[train_shape]["library_ms"],
            "serving_shape": {"ms": at[serve_shape][key]["ms"], "plain_ms": at[serve_shape]["plain_ms"],
                              "bound_ms": at[serve_shape][key]["bound_ms"],
                              "bound_share": at[serve_shape][key]["bound_share"],
                              "library_ms": at[serve_shape]["library_ms"]},
        })
    for name, source, replaces in KERNELS:
        r = fused[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"reflectionflow_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": w8_launches[name],
            "launches_ragged": ragged["launches"][name], "max_abs_err": r["err"],
            **{k: r[k] for k in ("scale_rel_err", "mismatch_frac") if k in r},
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "gbps": r["gbps"], "by_shape": r["by_shape"],
        })
    k7_train, k7_corr = (f"B={B} Lc={L // RING}" for B, L, *_ in K7_SHAPES[:2])
    for name, key, line, err_keys in (
            ("flash_chunk_fwd", "fwd", 63, {"max_abs_err": "err", "lse_max_abs_err": "lse_err"}),
            ("flash_chunk_bwd_dq", "dq", 126, {"max_abs_err": "err", "rel_err": "rel"}),
            ("flash_chunk_bwd_dkv", "dkv", 175, {"max_abs_err": "err", "rel_err": "rel"})):
        at = k7["by_shape"][k7_train][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"reflectionflow_tpu_torch/csrc/{'flash_fwd.cu' if key == 'fwd' else 'flash_bwd.cu'}",
            "replaces": f"{PA}:{line} (dyn_offsets=True, via {PA}:{789 if key == 'fwd' else 815})",
            "launches": ring["train"]["launches"][name],
            "launches_live_offsets": ring["train"]["live_launches"][name],
            "launches_ring_denoise": ring["denoise"]["ring_pallas"]["launches"][name],
            **{k: k7[key][v] for k, v in err_keys.items()},
            **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": k7_train, "corrector_shape": {"shape": k7_corr, **k7["by_shape"][k7_corr][key]},
            **({"sdpa_backward_ms": at["sdpa_backward_ms"]} if key != "fwd" else {}),
        })
    corr_shape, t2i_shape = f"B=2 L={LT + LI + LC}", f"B=2 L={LT + LI}"
    for name, source, line, impl in (("flash_fwd_int8", "flash_fwd_int8.cu", 234, "pallas_int8"),
                                     ("flash_fwd_nr", "flash_fwd_nr.cu", 313, "pallas_nr")):
        kernels.append(kernel_entry(name, source, f"{PA}:{line}", corrector[impl]["launches"][name],
                                    serving_attn[name], corr_shape, t2i_shape))
    log(json.dumps({"train": {k: training[k] for k in ("s_per_step", "peak_gib", "profile_ms",
                                                       "grad_cosine_min", "grad_cosine")},
                    "validation_hook": validation}))
    log(json.dumps({"ring": {"attention": ring["attention"],
                             "train": {k: ring["train"][k] for k in ("s_per_step", "peak_gib", "launches",
                                                                      "grad_cosine_min", "grad_cosine")},
                             "denoise": ring["denoise"]}}))
    total = time.perf_counter() - t_start
    log(f"chip_smoke: {total:.1f} s after the device check, of which the ring phases (3c, 5d) "
        f"{t_k7 + t_ring:.1f} s")
    log(json.dumps({"kernels": kernels, "hopper_sass": hopper_sass, "s_per_step": step,
                    "w8a8_step_profile_ms": prof,
                    "corrector_step_profile_ms": corrector["profile_ms"],
                    "peak_gib": {"bf16": bf16_peak / 2**30, "w8a8": w8_peak / 2**30,
                                 "w8a8_cond_weights": cond_gib,
                                 **{f"corrector_{i}": corrector[i]["peak_gib"]
                                    for i in ("pallas_nr", "pallas_int8")}}}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
