#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`reflectionflow_tpu_torch`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device: requires CUDA; prints `nvidia-smi` name and power limit;
  2. build: compiles kernel K1 (`csrc/flash_fwd.cu`) into `.build/kernels/`;
  3. K1 against its plain PyTorch version on the card (fp32 reference), at
     the main-path shape (B=1, 2; L=4608; H=24; D=128), a ragged L, and the
     cross-segment bias forms; times both at the main-path shape;
  4. main path: FLUX.1-dev at full width and depth, random bf16 weights from
     a seeded CUDA generator, attn_impl="pallas", served through
     `run_noise_scaling` (the noise-scaling CLI's function) for 2 prompts x 2
     candidates at 1024x1024, 8 Euler steps (cut from 30 to bound the run);
     checks finite latents, 4 PNGs of 1024x1024x3, and exactly
     8 steps x 57 attention calls x 2 generate calls = 912 K1 launches; and a
     full-width DiT forward on a small input agrees between K1 and the
     plain attention.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
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
STEPS, N_PROMPTS, BRANCH = 8, 2, 2


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


def k1_phase(torch):
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, L):
        return [torch.randn((B, L, 24, 128), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    cases = [(1, 4608, None, 0.0), (2, 4608, None, 0.0), (1, 4608 + 77, None, 0.0),
             (1, 4608, 4096, -1e30), (1, 4608, 4096, math.log(0.5))]
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
        for B in (1, 2):
            q, k, v = qkv(B, 4608)
            kern = lambda: flash_attention_fwd(q, k, v)  # noqa: E731
            plain = lambda: flash_attention_ref(q, k, v)  # noqa: E731
            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (cuda_ms(torch, plain, 5), cuda_ms(torch, kern, 20),
                              cuda_ms(torch, kern, 20), cuda_ms(torch, plain, 5))
            times[B] = ((k1 + k2) / 2, (p1 + p2) / 2)
            flops = 4 * 4608 * 4608 * 128 * 24 * B
            log(f"K1 B={B} L=4608: kernel {times[B][0]:.4f} ms ({flops / times[B][0] / 1e9:.1f} TFLOP/s), "
                f"plain {times[B][1]:.4f} ms")
            del q, k, v
    torch.cuda.empty_cache()
    return err_out, err_lse, times


def read_png_header(path: str):
    with open(path, "rb") as f:
        head = f.read(26)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, color


def main_path_phase(torch):
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
    from reflectionflow_tpu_torch.search.noise_scaling import run_noise_scaling
    from reflectionflow_tpu_torch.utils.timing import PhaseTimer

    t0 = time.perf_counter()
    pipe = FluxPipeline.random_init(torch.Generator(device="cuda").manual_seed(0),
                                    dtype=torch.bfloat16, device="cuda")
    pipe.attn_impl = "pallas"
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("dit", "t5", "clip", "vae")}
    log(f"random_init {time.perf_counter() - t0:.1f} s, params {n_params}")

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
        check(bool(torch.isfinite(lat).all()), "non-finite final latents")
        images = pipe.decode_latents(lat, kw["height"], kw["width"])
        t_d = time.perf_counter()
        calls.append({"encode_s": t_b - t_a, "denoise_s": t_c - t_b, "decode_s": t_d - t_c})
        return images

    pipe.generate = generate_checked
    timer = PhaseTimer()
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        flash_attention_fwd.launches = 0
        run_noise_scaling(pipe, cfg, prompts, out_dir, timer=timer)
        launches = flash_attention_fwd.launches
        peak = torch.cuda.max_memory_allocated()
        pngs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs
                      if f.endswith(".png"))
        headers = [read_png_header(p) for p in pngs]
        meta_rows = sum(1 for dp, _, fs in os.walk(out_dir) for f in fs if f == "metadata.jsonl")
    pipe.generate = generate

    expected = STEPS * (pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks) * N_PROMPTS
    log(f"K1 launches in the main path: {launches} (expected {expected})")
    check(launches == expected, "the main path did not run K1 the expected number of times")
    check(len(pngs) == N_PROMPTS * BRANCH and meta_rows == N_PROMPTS,
          f"{len(pngs)} PNGs and {meta_rows} metadata files written")
    check(all(h == (pa.width, pa.height, 8, 2) for h in headers), f"PNG headers {headers}")
    for i, c in enumerate(calls):
        log(f"generate call {i}: encode {c['encode_s']:.3f} s, denoise {c['denoise_s']:.3f} s "
            f"({c['denoise_s'] / STEPS:.3f} s/step, B={BRANCH}), decode {c['decode_s']:.3f} s")
    gen_spans = timer.spans["generate"]
    log(f"per-call seconds (generate span): {[round(s, 3) for s in gen_spans]}; "
        f"peak device memory {peak / 2**30:.2f} GiB")

    # the whole DiT at full width on a small input: K1 against the plain attention
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg_d = pipe.dit_cfg
    img = torch.randn((1, 256, cfg_d.in_channels), generator=gen, device="cuda").to(torch.bfloat16)
    txt = torch.randn((1, 64, cfg_d.text_dim), generator=gen, device="cuda").to(torch.bfloat16)
    pooled = torch.randn((1, cfg_d.pooled_dim), generator=gen, device="cuda").to(torch.bfloat16)
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids

    args = (img, txt, pooled, torch.full((1,), 0.5, dtype=torch.bfloat16, device="cuda"),
            torch.from_numpy(make_image_ids(16, 16)).cuda(), torch.from_numpy(make_text_ids(64)).cuda())
    g = torch.full((1,), 3.5, dtype=torch.bfloat16, device="cuda")
    with torch.no_grad():
        v_k1 = pipe.dit(*args, guidance=g, attn_impl="pallas").float()
        v_plain = pipe.dit(*args, guidance=g, attn_impl="xla").float()
    rel = ((v_k1 - v_plain).abs().max() / v_plain.abs().max()).item()
    log(f"DiT forward (full width, L=320): max|K1 - plain| / max|plain| = {rel:.3e} (tol {DIT_REL_TOL})")
    check(bool(torch.isfinite(v_k1).all()) and rel <= DIT_REL_TOL, "DiT with K1 disagrees with plain attention")
    return launches, calls, gen_spans, peak


def main() -> int:
    import torch

    device_phase(torch)
    sys.path.insert(0, REPO)
    from reflectionflow_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    kernel_build.build("flash_fwd.cu")
    log(f"build K1: {time.perf_counter() - t0:.2f} s")
    err_out, err_lse, times = k1_phase(torch)
    launches, _, _, _ = main_path_phase(torch)
    kernels = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "reflectionflow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "reflectionflow_tpu/ops/pallas_attention.py:63",
        "launches": launches,
        "max_abs_err": err_out,
        "lse_max_abs_err": err_lse,
        "ms": times[2][0],
        "plain_ms": times[2][1],
        "ms_b1": times[1][0],
        "plain_ms_b1": times[1][1],
    }]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
