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
     all started together, and with g++ beside them the host image codecs
     (`csrc/host/image_io.cpp`) and the native tar indexer
     (`native/genref_loader.cpp`) into `.build/host/`; prints ptxas's
     registers and spills per kernel;
     checks that each kernel on the Hopper pipelines `csrc/flash_fwd_sm90.cuh`
     (K1, K7a, K8b, K9b) and `csrc/flash_bwd_sm90.cuh` (K6a, K6b, K7b, K7c) holds wgmma
     (HGMMA; K8b also the integer IGMMA) and TMA (UTMALDG) instructions and no
     mma.sync (HMMA, IMMA), spills nothing, that ptxas honoured its
     setmaxnreg (no warning C7508) and did not serialize its wgmma
     instructions; that K2–K5 spill nothing, printing their registers and
     the SASS opcodes that bound them (load and store widths, shuffles, MUFU,
     F2I, calls to the division's slow path);
  2b. threefry: `utils/threefry.py` on the card against the committed
     `jax.random` fixtures of tests/data/torch_prng/ (keys from seeds and
     split / fold_in chains; bits and float32 / bfloat16 uniforms bit for
     bit; normals within NORMAL_ULPS fp32 ulps; a 1024 px FLUX latent with at
     most LATENT_DIFF_FRAC of its bf16 elements one ulp off); times a
     2-candidate 1024 px latent draw and a training step's t and noise (B=8,
     512 px). Every seeded draw of the phases below (the search loops'
     latents, `generate(seed=)`, `train`'s LoRA init and step draws, the
     reward trainer's heads) goes through it;
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
     At (8, 640, log 0.5) a second K7b and K7c launch must give bitwise the
     same dQ, dK and dV (no atomics). Times each kernel, its plain version
     and SDPA with the chunk's float mask (forward; backward printed;
     yardsticks only) at the two chunk shapes, with each kernel's TFLOP/s,
     share of the bound and device time (profiler), and K6a on the chunk
     view (q and k from the same rows, no live boundary) in turns with K7b:
     the pipeline K7b shares, without the chunk's modifiers;
  4. K2–K5 against their plain versions on the card at every shape the W8A8
     path gives them (strided panel slices included) and at a ragged
     L = 4608 + 77, K2 bit-identical at each; times each kernel and its plain
     version in turns at each of those shapes but the ragged one, as device
     time (profiler) and as time per call (CUDA events, host gaps included),
     K2's bytes with its cos/sin tables read once; and K5 in turns with K4 on
     K4's single-block view (2, 4608, 12288), the same bytes without the GELU;
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
  5e. GenRef JPEG training, on the same bf16 pipeline: each committed JPEG
     fixture of tests/data/torch_jpeg/ (sequential, progressive, grey, CMYK,
     YCCK) decodes (`utils/image_io.py`) to the sha256 of PIL's decode in its
     manifest, and `resize_bicubic` gives the manifest's PIL resize hashes at
     the paired-crop shapes and equals `resize_ref` bit for bit; the
     progressive fixture cut after its fifth scan raises
     NotImplementedError; each PNG fixture (every colour type and bit depth,
     PLTE, tRNS, Adam7) decodes to PIL's hash; `encode_jpeg` of each
     committed pixel array gives the sha256 of PIL's default save; the median of GENREF_REPS runs of: a 1024^2 4:2:0
     decode (and the other 1024-wide fixtures), a 1024^2 -> 512^2 resize in
     C++ and in `resize_ref` in turns, and the Paeth PNG unfilter of a
     1024^2 RGB image in C++ and in its numpy loop in turns; a GenRef-format
     tar of GENREF_SAMPLES samples (the 1024^2 fixtures good, the 1024x768
     one bad, subsets general / length / rule / editing, every other sample's
     members under PAX long names) indexed by `utils/native.py`; one
     `GenRefDataset` batch (B=8, 512 px, condition 512, the train CLI's
     GenRef subset schedule) timed alone and split into decode, resize and
     the rest; then `train()` for 3 steps from that shard at TrainConfig's
     defaults: phase 5b's checks and launch counts (342 K1, 171 K6a, 171 K6b),
     no `tarfile` read and no native fallback, JPEG decodes counted; prints
     s/step and the data's share of it;
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
     "pallas_nr";
  8. reflection round: on that W8A8 pipeline under "pallas_nr", with the
     prompt-embedding cache on (the CLI's int8 profile),
     `run_reflectionflow_block` (the reflectionflow CLI's function) with the
     fake verifier, reflector and refiner of configs/flux.1_dev_fake.json:
     one prompt, 2 candidates per call at 1024 px with a 512 px condition,
     round 0 bootstrapped (t2i), then 2 rounds (cut from 16) of verify ->
     reflect -> refine -> conditioned generate, 8 steps each; checks finite
     latents, the JAX artifact tree (midimg/{round}_round@{seed}.png,
     samples_lastround/, samples_path_bestround/, samples_best/00000.png, all
     1024x1024x3), 2 metadata rows and round_done 2 in search_state.json,
     every conditioned FLUX prompt "<refined> [Reflexion]: <reflection>",
     exact launch counts from the block counts (per t2i forward 57 K9, 114
     K3, 76 K4, 76 K5; per conditioned forward 57 K9, 190 K3, 133 K4, 133 K5;
     no K1, K2 or K8), the prompt cache's misses (1, then the 2 new prompts of
     each round); a second call on the same directory must generate, encode
     and write nothing; prints each round's time and its split (generate,
     verify, reflect, refine, the rest), their p50 and peak memory;
  9. snapshot load: writes a diffusers-layout FLUX.1-dev snapshot of seeded
     random bf16 weights (full width: DiT 3072, 24 x 128 heads, text 4096; the
     whole VAE; CLIP-L with a byte-level tokenizer; T5-XXL at d_model 4096,
     d_ff 10240, 64 heads; depth cut to DiT 2 double + 4 single blocks and T5
     to 2 layers) and a Qwen2.5-VL-7B-width snapshot (LM 2 layers, vision 2
     blocks, the last full attention; transformers' newer key layout in two
     shards) with the port's safetensors writer to a temporary directory;
     `FluxPipeline.from_pretrained(dir)` and `load_qwen_vl(dir)` without a
     device must land on cuda with every tensor bitwise what was written; then
     1 prompt x 2 candidates at 1024 px, 4 steps, "pallas", `vae_tiling`: 128^2
     latents decode as 3 x 3 tiles, exactly 4 x 6 K1 launches; then the CLI's
     int8 profile and one more call with exact K1–K5 counts; the loaded Qwen
     scores those 2 images in bf16 and under quantize="int8" (|diff| <= 0.1;
     the 3420-wide vision MLP's padded W8A8 products bitwise equal to fp64);
     the tiled decode of a 64^2 latent bitwise equal to the untiled decode;
  10. the reflection round with models: one Qwen2.5-VL-7B at full width and
     depth (LM 28 x 3584, 28/4 heads, vocab 152064; vision 32 x 1280, window
     112, full blocks 7/15/23/31), seeded random bf16 weights, shared by
     `QwenRewardVerifier` (random head, "last" pooling) and
     `LocalQwenReflector` (64 new tokens, cut from 256; a byte-level stub
     tokenizer, as random weights have no vocabulary); phase 8's round with
     them and the fake refiner, with phase 8's checks and launch counts,
     finite scores one per candidate and one reflection per candidate; the
     cached decode against a full recompute (logits cosine >= 0.999 at the last
     prefill position and 4 decode steps, B=2 with left pads); prints each
     round's split, the p50, prefill ms, decode ms per token at B=2, vision ms
     per image and peak memory; then, with the model still resident, one
     synthetic clip of 8 frames at 448 px through the verifier: a finite score
     on the grid `fetch_video` + `video_to_patches` give it ((4, 32, 32)), and
     its ms;
  11. the NVILA-scored round: K1 at the preset's shape (B=1, L=512+4096+1024,
     main_len 4608, cross bias 0) against its plain version, a second launch
     bitwise equal, timed in turns with it and beside SDPA; a full-size
     NVILA-Lite-2B VILA bundle (SigLIP-SO400M-patch14-448 tower, Qwen2-1.5B
     LM with the tied 151936 x 1536 embedding, mlp_downsample_3x3_fix
     projector) of seeded random bf16 weights written to a temporary
     directory and read by `load_nvila` without a device, every tensor bitwise;
     the verifier that configs/flux.1_dev_nvilascore.json asks for
     (`nvila_jax`, quantize int8) built by `build_verifier`, and phase 8's
     round from that preset (W8A8 "pallas": K1 with the cond segment and K2–K5;
     1 candidate a call; fake reflect and refine, the preset's being OpenAI
     backends) with exact launch counts (per forward 57 K1; K2 152 a t2i and
     266 a conditioned forward; K3–K5 as phase 8; no K8, K9); on the round's
     images the int8 yes/no logits against the bf16 model's (|diff| <=
     NVILA_INT8_TOL), the score pass timed at B=2 in int8 and bf16 in turns
     (the median of NVILA_TIMED_REPS; tower and LM apart, host preprocess),
     and the `verifier_filter` CLI with --nfes 1 2 writing
     nfe1/ and nfe2/; prints each round's split, the p50 and peak memory;
  12. the velocity cache and the NF4 profile, on the W8A8 pipeline under
     "pallas" at 1024 px, 1 prompt x 2 candidates: `vcache={"interval": 1}`
     at 8 steps bitwise the dense latents; the static schedule (interval 3,
     warmup 2, tail 1, order 2) at 30 steps: 12 full forwards, exactly 12
     forwards' K1–K5 launches, cosine >= W8A8_COS against the same schedule
     on the plain serving path ("xla"), and its denoise timed against the
     dense 30-step denoise in turns (dense, cached, cached, dense); the
     teacache preset's schedule (residual, threshold 0.6, its polynomial) at 8
     steps: launches exactly n_full forwards' worth (none on a skip step),
     then phase 8's round from configs/flux.1_dev_qwenscore_v5e_teacache.json
     (W8A8 "pallas", 1 candidate a call, fake verify/reflect/refine) with
     launch counts from each call's n_full and the per-round split; module
     mode at interval 3 (8 steps): launches on full steps only, cosine >=
     W8A8_COS against the plain path, peak memory against the B=2 snapshot
     arithmetic; the `_v5e_co` profile (NF4 MLPs + W8A8 panels, NF4 T5) from
     a fresh seeded bf16 FLUX.1-dev at full width and depth: 2 candidates at 4
     steps with exact K1/K2/K3/K5 counts (no K4), NF4 resident bytes, s/step
     against W8A8 in turns, an NF4 linear of each packing against fp64 on its
     decoded weight (NF4_REL_TOL) and the NF4 T5 encode's cosine against bf16;
  13. reward-model training: Qwen2.5-VL-7B at full width and depth (seeded
     random bf16, lm_head dropped), LoRA r=16 / alpha=32 on the LM and the
     vision tower, the LM's and the tower's blocks quantized weight-only int8
     (`quantize_rm_base`), RM_STEPS steps of `make_rm_train_step` (btt loss,
     special pooling) on a batch of B=2 synthetic GSB pairs of 448 px PNG
     images collated in the vision-training layout (grid (1, 32, 32), 256
     image rows a side): finite losses, the loss on that batch lower after the
     steps, every group (LM adapters, tower adapters, head, special row)
     moved, no float weight left on a block linear and none quantizing its
     activation, no launch of K1–K9; s/step, peak device memory and the base's
     resident bytes; `save_rm_checkpoint` -> `load_rm_checkpoint` bitwise;
     a `QwenRewardVerifier` over the same seeded base reads that checkpoint
     and gives the two images of a pair finite, different scores; then an NF4
     base (`quantize_base="nf4"`) for RM_NF4_STEPS steps, its s/step beside
     int8's;
  14. serving over a mesh of ranks (`reflectionflow_tpu_torch/parallel/`), the
     parent holding no model: MESH_WORLD gloo ranks on cuda:0 (NCCL refuses two
     ranks on one GPU, so every collective goes through host memory and is
     counted), each sub-phase spawned afresh by `parallel.distributed.launch`,
     full-width FLUX.1-dev of random bf16 weights from seed 0 built one rank at a
     time, the ranks' weights checked equal, MESH_STEPS steps at 1024 px (cut
     from 30); every launch count read on each rank around its sharded call:
     (a) TP, data 1 x model MESH_WORLD, bf16 "pallas", MESH_TP_B candidate(s) of
     one prompt: final latents cosine >= MESH_COS against rank 0's one-rank
     generate of the same seed, exactly 57 K1 and 114 all-reduces a forward on
     each rank (all through host memory, no gather), each rank's DiT holding
     exactly its shard's bytes (the specs' cut dims halved; < 0.7 of the whole),
     K1's first launch at each of its shapes on the sharded forward (B =
     MESH_TP_B, L=4608, 12 heads a rank) held against its plain version on those same
     inputs (OUT_TOL, LSE_TOL), s/step and the all-reduce time share
     (synchronised around each call);
     (b) DP, data MESH_WORLD, W8A8 "pallas", 2 prompts x 2 candidates, one prompt a
     rank: cosine >= MESH_COS against the one-rank W8A8 generate, the uint8 max
     |diff| printed, exactly 57 K1, 152 K2, 114 K3, 76 K4, 76 K5 a forward on
     each rank and one gather;
     (c) `parallel.dryrun.dryrun_multihost` on the card: a cross-rank sum and
     prompt-sharded `run_noise_scaling` (tiny fp32 weights) over NCCL in a
     world of one (the one-rank tree), at MESH_WORLD over gloo against it, and
     over NCCL at `torch.cuda.device_count()` ranks where there are several
     cards: the same files, the PNGs byte for byte;
     (d) `run_reflectionflow_block` at data MESH_WORLD under W8A8 "pallas_nr"
     with the fake models (1 prompt, round 0 + 1 round, the cond stream on the
     DiT itself): on rank 0 alone first, one data slice a generate call, then
     on both ranks; the same files, byte for byte, and exactly the K9 and
     K3–K5 launches of MESH_STEPS t2i and MESH_STEPS conditioned forwards a
     rank;
  15. training over a mesh of ranks, MESH_WORLD gloo ranks on cuda:0 as in
     phase 14, at FLUX.1-dev's full width with random bf16 weights from a
     seed, one launch for 15b, 15a and 15d in turn (15c runs in 14a's launch):
     (a) DP corrector training, data MESH_WORLD, "pallas", global B =
     MESH_TRAIN_B at 512 px, MESH_TRAIN_STEPS steps of sgd with the 0.5 clip
     at full depth, after rank 0 ran the same global batches alone: the
     adapters bitwise equal on every rank after each step, each step's loss
     within MESH_TRAIN_LOSS_RTOL and every adapter tensor at cosine >=
     MESH_ADAPTER_COS of the one-rank run, exactly 114 K1, 57 K6a and 57 K6b
     a step on each rank and one gradient all-reduce a step;
     (b) TP corrector training, data 1 x model MESH_WORLD, depth
     MESH_TP_DEPTH, B=2, one sgd step without a clip from adapters with a
     non-zero B: each adapter's gradient at cosine >= MESH_TP_GRAD_COS of the
     one-rank step, K1's first launch on each rank (2, 2560, 12, 128) against
     its plain version (OUT_TOL, LSE_TOL), and K6a + K6b's first launch there,
     dQ, dK, dV against the plain backward on the same q, k, v, out, lse and
     dO (K6_REL_TOL of max |ref|), 2 K1, 1 K6a, 1 K6b a block, the saved
     adapters whole-shaped and byte-identical on both ranks;
     (c) W8A8 under TP: in 14a's launch, `quantize` (DiT W8A8) on the cut
     model, which keeps the unfused layout, and MESH_STEPS steps: cosine >=
     MESH_COS against rank 0's one-rank W8A8 run of that layout, 57 K1 a
     forward and no K2–K5, one all_reduce_max and one int32 all_reduce_sum a
     row-cut linear;
     (d) the reward trainer's FSDP, data MESH_WORLD: Qwen2.5-VL-7B's widths
     at depth MESH_RM_DEPTH, int8 weight-only base sharded over the ranks,
     one step on RM_PAIRS pairs at RM_PX px: the loss within
     MESH_RM_LOSS_RTOL of the one-rank step, each trainable's reduced
     gradient at cosine >= MESH_RM_GRAD_COS of the one-rank step's, the whole
     gradient within MESH_RM_GRAD_NORM_RTOL of its norm, each change over the
     step at cosine >= MESH_RM_DELTA_COS of the one-rank change (a tensor
     whose one-rank gradient is zero, as lora_A's under a zero lora_B, must
     be zero too), the trainables bitwise equal on every rank, each rank
     holding at most 0.55 of the base's bytes, no K1–K9 launch.
     Each sub-phase prints its seconds and each rank's peak GiB.
  16. ring attention across ranks (`ops/ring_attention.py` over a
     `RankMesh`, `parallel.collectives.ring_shift`), RING_RANKS gloo ranks on
     cuda:0 as in phase 14, FLUX.1-dev widths, random bf16 weights from a
     seeded CUDA generator, one launch for 16a-c, one of four ranks for 16d:
     (a) `ring_attention` over a ("seq",) mesh at the corrector's (2, 5632,
     24, 128), main_len 4608, cross bias 0, log 0.5 and -1e30, forward and
     backward: against the fp32 plain dense attention (OUT_TOL, K6_REL_TOL
     of max |ref|), output and dq/dk/dv bitwise equal to the one-process
     ring of as many slots on the same rank and equal across ranks, exactly
     2 K7a a forward and 2 K7b + 2 K7c a backward on each rank; prints the
     shifted bytes, the ring shifts' seconds and their share;
     (b) the conditioned denoise at 1024 px (512 px condition, image CFG:
     B=2 rows, L=5632, union_cond_attn=False), RING_RANK_STEPS steps, full
     depth, "ring_pallas" over the two ranks: final latents bitwise equal
     across ranks and to the one-process ring on rank 0, cosine >= RING_COS
     against "pallas" (K1), steps x 57 x 2 K7a a rank and no K1;
     (c) one corrector training step, full width, depth RING_RANK_DEPTH,
     512 px, B=2, "ring_pallas" over the two ranks: adapter gradients at
     cosine >= MESH_TP_GRAD_COS of the one-process ring's step (printed
     whether bitwise), exactly 2 x 6 x 2 K7a, 6 x 2 K7b and 6 x 2 K7c a rank;
     (d) four ranks, (data 2, seq 2), depth RING_RANK_DEPTH: the conditioned
     denoise of B=4 items at 1024 px, 2 a data row: each data row's latents
     at cosine >= MESH_COS of the one-rank K1 run, the gathered latents
     bitwise equal on every rank, steps x 6 x 2 K7a a rank.
     Two ranks that share one card are a correctness path: their seconds are
     not a ring across cards.
  17. ControlNet residuals and the condition preprocessors, on the bf16
     pipeline after phase 5d: a 1024 px DiT forward (B=2) under "pallas" with
     seeded residuals (CN_HOOKS double and single hooks): all-zero residuals
     bitwise the forward without them, non-zero ones at cosine >= CN_COS of
     "xla", 57 K1; a conditioned `generate` (1024 px, image CFG, 8 steps)
     whose 512 px condition is the port's `canny` of a seeded image: finite
     latents, 8 x 57 K1; the host milliseconds of `canny`, `coloring` and
     `deblurring` on a 1024^2 image.
The training numbers are on the line {"train": {...}}, phase 5e's on
{"genref_data": {...}}, the ring phase's on
{"ring": {...}}, the reflection round's on {"reflection_round": {...}}, the
snapshot phase's on {"snapshot_load": {...}}, the round with models on
{"reflection_round_models": {...}}, the NVILA round on {"nvila_round":
{...}}, phase 12's on {"vcache_nf4": {...}} and phase 13's on {"rm_train":
{...}}, phase 14's on {"mesh": {...}}, phase 15's on {"mesh_train": {...}},
phase 16's on {"ring_ranks": {...}}, phase 17's on {"controlnet": {...}};
the line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_TOL, LSE_TOL = 1e-2, 1e-3  # K1 (bf16 out, fp32 lse) against the fp32 plain version
DIT_REL_TOL = 3e-2  # bf16 DiT forward, K1 vs plain attention, relative to max |output|
NR_REL, NR_ABS = 7.9e-3, 1e-3  # K2: |err| <= NR_REL * |ref| + NR_ABS (two bf16 ulps)
Q_SCALE_RTOL, Q_MISMATCH = 1e-5, 1e-3  # K3/K4: scale rtol; |dq| <= 1 on <= 0.1% of values
W8A8_COS = 0.999  # full-width W8A8 DiT, fused path vs plain serving path
NF4_REL_TOL = 1e-2  # phase 12: an NF4 linear's bf16 product vs fp64 on its decoded weight, of max |ref|
K8_COS, K8_EXACT_ERR = 0.999, 0.05  # K8 against exact fp32 attention (the JAX test's bounds)
K6_REL_TOL = 1e-2  # K6a/K6b: max |err| <= K6_REL_TOL * max |ref| for each of dQ, dK, dV
TRAIN_STEPS = 3  # corrector training steps at TrainConfig defaults (B=8, 512 px, r=32)
TRAIN_COS = 0.99  # adapter gradients, K1 + K6 vs plain attention, cosine per adapter family
GENREF_SAMPLES = 16  # phase 5e's shard: 2 batches at B=8
GENREF_REPS = 9  # phase 5e's host timings: the median of this many runs
GENREF_SUBSETS = ("general", "length", "rule", "editing")
GENREF_STAGES = [0, 1000]  # the train CLI's subset ratios (`GENREF_SPLIT_RATIOS`), stage 0 -> 1
FIXTURES = os.path.join(REPO, "tests", "data", "torch_jpeg")
PRNG_FIXTURES = os.path.join(REPO, "tests", "data", "torch_prng")
NORMAL_ULPS = 4  # threefry normals against JAX's, fp32 ulps (log1p's last bit differs)
LATENT_DIFF_FRAC = 1e-4  # bf16 latent elements allowed to differ from JAX's, by one ulp each
PRNG_REPS = 20  # threefry timings: the median of this many draws
STEPS, N_PROMPTS, BRANCH = 8, 2, 2
H, M, D, LT, LI = 3072, 12288, 128, 512, 4096  # FLUX.1-dev widths; txt and img tokens at 1024px
LC = 1024  # cond tokens of a 512 px condition
CORR_ITEMS, IMAGE_CFG = 2, 1.5  # corrector items served per impl; image guidance scale
RING = 4  # ring slots of the sequence-parallel phases (all on the one card)
RING_TRAIN_STEPS, RING_DENOISE_STEPS = 2, 2
RING_COS = 0.999  # ring denoise final latents against K1
REFLECT_ROUNDS = 2  # reflection rounds of phase 8 (the fake preset's 16, cut)
VC_STEPS = 30  # phase 12's static schedule and its dense baseline: the presets' 30 steps
VC_STATIC = {"interval": 3, "warmup": 2, "tail": 1, "order": 2}  # 12 full forwards at 30 steps
VC_NF4_STEPS = 4  # phase 12's NF4 profile generate
# phase 9: the written snapshots' depth cuts (FLUX.1-dev has 19 + 38 DiT blocks and 24 T5 layers;
# Qwen2.5-VL-7B 28 LM layers and 32 vision blocks) and the steps of its generate calls
SNAP_DIT_BLOCKS, SNAP_T5_LAYERS, SNAP_STEPS = (2, 4), 2, 4
SNAP_QWEN_LM_LAYERS, SNAP_QWEN_VIS_BLOCKS = 2, 2
QWEN_NEW_TOKENS = 64  # phase 10's reflection decode (LocalQwenReflector's default 256, cut)
QWEN_COS = 0.999  # cached decode logits against a full recompute
QWEN_INT8_TOL = 0.1  # phase 9's Qwen verifier: |W8A8 score - bf16 score|, scores of order 1
QWEN_CLIP_FRAMES, QWEN_CLIP_PX = 8, 448  # phase 10's synthetic video clip
NVILA_INT8_TOL = 0.12  # phase 11: |W8A8 - bf16| of the yes and no logits (|logit| 0.03-0.70; read 0.060, 0.074)
NVILA_TIMED_B = 2  # phase 11: the NVILA score pass timed at this batch
NVILA_TIMED_REPS = 9  # phase 11: its repetitions, int8 and bf16 in turns; the median is kept
RM_STEPS, RM_NF4_STEPS = 3, 2  # phase 13: int8-base training steps; NF4 steps (the first warms up)
RM_PAIRS, RM_PX = 2, 448  # train_reward's per_device_train_batch_size and max_pixels side
RM_LORA_R, RM_LORA_ALPHA = 16, 32.0  # train_reward's defaults
RM_LR = 1e-5  # train_reward's default
RM_SEED = 13
MESH_WORLD = 2  # phase 14: ranks on the one card (gloo; NCCL refuses two ranks on one GPU)
MESH_STEPS = 1  # phase 14's Euler steps (cut from 30; 4 until phase 15 needed the time, 2 until phase 16 did)
MESH_TP_B = 2  # phase 14a / 15c: candidates of one prompt (2 prompts x BRANCH until phase 15 needed the time)
MESH_COS = 0.999  # phase 14: sharded final latents against the one-rank run of the same seed
MESH_SEED = 21
MESH_TIMEOUT = 420  # seconds a phase-14 or phase-15 launch may take
MESH_PARENT_GIB = 4.0  # phase 14: what the parent may still hold of the card its ranks share
# phase 15: training over a mesh of ranks, MESH_WORLD gloo ranks on the one card
MESH_TRAIN_B, MESH_TRAIN_STEPS = 4, 2  # 15a: global batch (2 a rank), steps
MESH_TRAIN_PX = 512  # 15a / 15b: target and condition size (TrainConfig's)
MESH_TRAIN_LOSS_RTOL = 1e-2  # 15a: each step's loss against the one-rank step on the same global batch
MESH_ADAPTER_COS = 0.9999  # 15a: every adapter tensor after the steps against the one-rank run
MESH_TP_DEPTH = (2, 4)  # 15b: double and single blocks (full width; a block's K1/K6 shapes ignore depth)
MESH_TP_GRAD_COS = 0.999  # 15b: each adapter's gradient against the one-rank step
MESH_RM_DEPTH = (2, 4)  # 15d: Qwen2.5-VL-7B LM layers and vision blocks (full width; phase 13 runs full depth)
MESH_RM_LOSS_RTOL = 1e-2  # 15d: the FSDP step's loss against the one-rank step
MESH_RM_GRAD_COS = 0.99  # 15d: each trainable's reduced gradient against the one-rank step's, cosine
MESH_RM_GRAD_NORM_RTOL = 2e-2  # 15d: |the whole gradient's norm / the one-rank norm - 1| (a scale is global)
MESH_RM_DELTA_COS = 0.95  # 15d: each trainable's change over the step (AdamW) against the one-rank change
# phase 16: ring attention across ranks, RING_RANKS gloo ranks on the one card
RING_RANKS = 2
RING_RANK_STEPS = 1  # 16b / 16d: Euler steps (cut from 30 for the run's time)
RING_RANK_DEPTH = (2, 4)  # 16c / 16d: double and single blocks (full width; a chunk's shapes ignore depth)
RING_RANK_TIMEOUT = MESH_TIMEOUT  # seconds a phase-16 launch may take
CN_HOOKS = (2, 4)  # phase 17: ControlNet double and single hooks (10 blocks a hook of 19 + 38)
CN_COS = 0.999  # phase 17: the ControlNet forward under "pallas" against "xla"
K1_PRESET = (1, LT + LI + LC, LT + LI, 0.0)  # phase 11: K1 at the NVILA preset's (B, L, main_len, cross bias)
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
KERNELS = (  # name, label, source, its `*_kernel`, TPU kernel it replaces
    ("norm_rope", "K2", "norm_rope.cu", "norm_rope_kernel", f"{PQ}:116"),
    ("adaln_quant", "K3", "act_quant.cu", "act_quant_adaln_kernel", f"{PQ}:32"),
    ("gelu_quant", "K4", "act_quant.cu", "act_quant_gelu_kernel", f"{PQ}:44"),
    ("rowquant", "K5", "act_quant.cu", "act_quant_row_kernel", f"{PQ}:52"),
)
# the SASS opcodes (with their modifiers: load widths, MUFU functions) printed for K2–K5
FUSED_OPS = ("LDG", "STG", "SHFL", "F2I", "MUFU", "CALL", "BRA", "FFMA", "FMUL", "FADD", "FSETP",
             "PRMT", "F2FP", "BAR")


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
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return card


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


def profile_events(torch, fn):
    """torch.profiler's `key_averages()` over `fn()` (host and device)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def profiled(torch, fn):
    """[(kernel name, self device µs)] of the device kernels `fn()` ran."""
    out = []
    for evt in profile_events(torch, fn):
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
    ("K7a", "flash_fwd.cu", "flash_chunk_fwd_kernel"),
    ("K8b", "flash_fwd_int8.cu", "flash_fwd_int8_kernel"),
    ("K9b", "flash_fwd_nr.cu", "flash_fwd_nr_kernel"),
    ("K6a", "flash_bwd.cu", "flash_bwd_dq_kernel"),
    ("K6b", "flash_bwd.cu", "flash_bwd_dkv_kernel"),
    ("K7b", "flash_bwd.cu", "flash_chunk_bwd_dq_kernel"),
    ("K7c", "flash_bwd.cu", "flash_chunk_bwd_dkv_kernel"),
)


def hopper_check(kernel_build, ptxas) -> dict:
    """K1, K7a, K8b, K9b, K6a, K6b, K7b and K7c are built as designed for Hopper: TMA (UTMALDG) and
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


def fused_check(kernel_build, ptxas) -> dict:
    """K2–K5 spill nothing; returns each one's registers and the counts of the
    SASS opcodes that bound it (FUSED_OPS, with modifiers) and of all its
    instructions."""
    out = {}
    for name, label, src, kernel, _ in KERNELS:
        regs = ptxas[src][kernel]
        ops = kernel_build.sass_opcodes(src, kernel, modifiers=True)
        sass = {op: n for op, n in sorted(ops.items()) if op.split(".")[0] in FUSED_OPS}
        sass["total"] = sum(ops.values())
        log(f"{label} {kernel}: ptxas {regs}; SASS {sass}")
        check(regs.get("spill_stores") == regs.get("spill_loads") == 0, f"{label} spills")
        out[name] = {"registers": regs.get("registers"), "sass": sass}
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
    (from K1). At the training chunk with the log 0.5 bias a second K7b and
    K7c launch must be bitwise equal to the first. Each kernel, its plain version
    and SDPA (forward and backward, with the chunk's float mask; yardsticks
    only) timed at the two chunk shapes with a live cross bias."""
    import torch.nn.functional as F

    from reflectionflow_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_chunk_bwd, flash_chunk_bwd_dkv, flash_chunk_bwd_dq, flash_chunk_bwd_ref,
        flash_chunk_fwd, flash_chunk_fwd_ref)

    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"fwd": {"err": 0.0, "lse_err": 0.0}, "dq": {"err": 0.0, "rel": 0.0},
           "dkv": {"err": 0.0, "rel": 0.0}, "by_shape": {}, "cases": 0, "bitwise_cases": 0}
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
                    if B == 8 and cb == math.log(0.5):  # no atomics: a second launch is bitwise equal
                        mods = (main_len, cb, q_off, k_off)
                        again = (flash_chunk_bwd_dq(qc, kc, vc, doc, g_lse, g_delta, *mods),
                                 *flash_chunk_bwd_dkv(qc, kc, vc, doc, g_lse, g_delta, *mods))
                        same = [torch.equal(a, g) for a, g in zip(again, got)]
                        log(f"K7b/K7c B={B} Lc={Lc} offsets ({q_off}, {k_off}) cross_bias={cb}: second "
                            f"launch bitwise equal (dq, dk, dv) {same}")
                        check(same[0], "K7b's second launch differs from its first")
                        check(all(same[1:]), "K7c's second launch differs from its first")
                        res["bitwise_cases"] += 1
                        del again
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
        flash_bwd_dq, flash_chunk_bwd_dkv, flash_chunk_bwd_dq, flash_chunk_bwd_ref, flash_chunk_fwd,
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
    # the pipeline K7b shares with K6a, without the chunk's modifiers: K6a on the chunk view with
    # q and k from the same rows and no live boundary, in turns with K7b
    k_same, v_same = k[:, q_off:q_off + Lc], v[:, q_off:q_off + Lc]
    k6a = lambda: flash_bwd_dq(qc, k_same, v_same, doc, g_lse, g_delta, Lc)  # noqa: E731
    t_dq_pair, t_k6a = in_turns(
        torch, lambda: flash_chunk_bwd_dq(qc, kc, vc, doc, g_lse, g_delta, *mods), k6a, 20, 20)
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
    rate = {key: (n * pairs / t / 1e9, b[0] / t) for key, n, t, b in (
        ("fwd", 4, t_fwd, b_fwd), ("dq", 6, t_dq, b_dq), ("dkv", 8, t_dkv, b_dkv))}
    # each kernel's own device time (profiler), without the wrapper's host time between launches
    dev = {key: kernel_split_ms(torch, fn, 20, (tag,))[tag] for key, tag, fn in (
        ("fwd", "flash_chunk_fwd_kernel", lambda: flash_chunk_fwd(qc, kc, vc, *mods)),
        ("dq", "flash_chunk_bwd_dq_kernel",
         lambda: flash_chunk_bwd_dq(qc, kc, vc, doc, g_lse, g_delta, *mods)),
        ("dkv", "flash_chunk_bwd_dkv_kernel",
         lambda: flash_chunk_bwd_dkv(qc, kc, vc, doc, g_lse, g_delta, *mods)),
        ("k6a", "flash_bwd_dq_kernel", k6a))}
    log(f"K7 B={B} Lc={Lc} offsets ({q_off}, {k_off}) cross_bias={cb}: K7a {t_fwd:.4f} ms "
        f"({rate['fwd'][0]:.1f} TFLOP/s, bound {b_fwd[0]:.4f} ms, {rate['fwd'][1]:.1%} of it), "
        f"plain {p_fwd:.3f} ms; K7b {t_dq:.4f} ms ({rate['dq'][0]:.1f} TFLOP/s, bound {b_dq[0]:.4f} ms, "
        f"{rate['dq'][1]:.1%} of it), K7c {t_dkv:.4f} ms ({rate['dkv'][0]:.1f} TFLOP/s, bound "
        f"{b_dkv[0]:.4f} ms, {rate['dkv'][1]:.1%} of it), plain backward {p_bwd:.3f} ms; SDPA with "
        f"the chunk's mask: forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; device time "
        f"K7a {dev['fwd']:.4f}, K7b {dev['dq']:.4f}, K7c {dev['dkv']:.4f} ms")
    log(f"K7 B={B} Lc={Lc}: K6a on the chunk view (same rows, no live boundary) {t_k6a:.4f} ms "
        f"(device {dev['k6a']:.4f}), K7b {t_dq_pair:.4f} ms in turns with it")
    out = {"fwd": {"ms": t_fwd, "plain_ms": p_fwd, "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                   "library_ms": lib_fwd},
           "dq": {"ms": t_dq, "plain_ms": p_bwd, "bound_ms": b_dq[0], "bound_by": b_dq[1],
                  "library_ms": None, "sdpa_backward_ms": lib_bwd, "k6a_same_chunk_ms": t_k6a,
                  "k6a_same_chunk_device_ms": dev["k6a"]},
           "dkv": {"ms": t_dkv, "plain_ms": p_bwd, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                   "library_ms": None, "sdpa_backward_ms": lib_bwd}}
    for key, (tflops, share) in rate.items():
        out[key].update(tflops=tflops, bound_share=share, device_ms=dev[key])
    return out


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

    res = {name: {"err": 0.0, "by_shape": {}} for name, *_ in KERNELS}

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
            same = torch.equal(got, ref)
            log(f"K2 x (2, {L}, {H}) row stride {row}: max|err| {err.max().item():.3e}, "
                f"bit-identical {same}")
            check(ok, f"K2 disagrees with its plain version at L={L}")
            check(same, f"K2 is not bit-identical to its plain version at L={L}")
            if L <= LT + LI:  # bytes: the slice read and the output written, and cos/sin read once, bf16
                timed("norm_rope", f"row stride {row} L={L}", lambda: fq.norm_rope(x, scale, cos, sin),
                      lambda: fq.norm_rope_ref(x, scale, cos, sin), 2 * (2 * L * H * 2) + 2 * L * D * 2)
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
        # K5 on K4's single-block view: the same bytes without the GELU; in turns with K4
        L = LT + LI
        x = randn(2, L, 3 * H + M, scale=2.0)[..., 3 * H:]
        r1, g1, g2, r2 = (device_ms(torch, f, 20) for f in (lambda: fq.rowquant(x), lambda: fq.gelu_quant(x),
                                                            lambda: fq.gelu_quant(x), lambda: fq.rowquant(x)))
        k5_ms, k4_ms, bound = (r1 + r2) / 2, (g1 + g2) / 2, 3 * L * M * 2 / (HBM_TBS * 1e9)
        res["gelu_quant"].update(rowquant_same_view_ms=k5_ms)
        log(f"K5 on K4's view {tuple(x.shape)} row stride {x.stride(1)}: device {k5_ms:.4f} ms "
            f"({bound / k5_ms:.1%} of the bound {bound:.4f} ms); K4 there {k4_ms:.4f} ms ({bound / k4_ms:.1%})")
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
            "flash_fwd_int8": flash_attention_int8, **{n: getattr(fq, n) for n, *_ in KERNELS}}


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


class TimedData:
    """A dataset whose iterator records the seconds of each `next` in `secs`."""

    def __init__(self, ds):
        self.ds, self.secs = ds, []

    def set_step(self, step):
        self.ds.set_step(step)

    def __iter__(self):
        it = iter(self.ds)
        while True:
            t0 = time.perf_counter()
            batch = next(it)
            self.secs.append(time.perf_counter() - t0)
            yield batch


def run_train(torch, pipe, cfg, tmp: str, label: str, shard: str | None = None, schedule=None) -> dict:
    """`train()` over `shard` (by default a synthetic 512 px PNG shard written
    to `tmp`), with every launch count set to 0 just before and read just
    after; checks the loss, the gradient norm, the adapters, the checkpoint
    and the metric rows. `data_s` holds the seconds of each step's batch."""
    from reflectionflow_tpu_torch.train.data import GenRefDataset, write_synthetic_shard
    from reflectionflow_tpu_torch.train.train_loop import latest_checkpoint, train

    d = cfg.data
    cfg.checkpoint_dir = os.path.join(tmp, "ckpt")
    if shard is None:
        shard = os.path.join(tmp, "genref_000.tar")
        t0 = time.perf_counter()
        write_synthetic_shard(shard, n=2 * d.batch_size, size=d.target_size)
        log(f"{label}: synthetic shard of {2 * d.batch_size} samples at {d.target_size} px in "
            f"{time.perf_counter() - t0:.1f} s")

    def dataset():
        return GenRefDataset(shards=[shard], batch_size=d.batch_size, target_size=d.target_size,
                             condition_size=d.condition_size, schedule=schedule, seed=cfg.seed)

    moved = []

    def hook(step, adapters, row):
        if step == 0:
            moved.append(any(bool(ab["lora_B"].abs().sum() > 0) for ab in adapters.values()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    data = TimedData(dataset())
    t0 = time.perf_counter()
    out = train(pipe, cfg, data, hooks=[hook])
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
            "s_per_step": s_per_step, "data_s": data.secs, "raw": next(iter(dataset()))}


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


def check_train_launches(launches: dict, n_blocks: int, label: str) -> None:
    """Exactly 2 K1, 1 K6a and 1 K6b launch per attention call and step
    (forward, recomputation, backward) and no other kernel."""
    expected = {name: 0 for name in launches}
    expected.update(flash_fwd=2 * n_blocks * TRAIN_STEPS, flash_bwd_dq=n_blocks * TRAIN_STEPS,
                    flash_bwd_dkv=n_blocks * TRAIN_STEPS)
    log(f"{label} launches {launches} (expected {expected})")
    check(launches == expected, f"{label} did not run K1/K6a/K6b the expected number of times")


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
    from reflectionflow_tpu_torch.utils import threefry
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
        check_train_launches(launches, n_blocks, "train")

        # a profiler split of one more step on the trained adapters
        raw = run["raw"]
        batch = prepare_batch_tensors(pipe, raw, (0, -d.condition_size // 16))
        adapters = run["adapters"]
        opt = make_optimizer(cfg)
        opt_state = opt.init(lora_parameters({"adapters": adapters}))
        step = make_train_step(pipe.dit, opt, alpha=cfg.lora.alpha, r=cfg.lora.r, attn_impl="pallas")
        wall_prof = []

        def one_step():
            t1 = time.perf_counter()
            step(adapters, opt_state, batch, threefry.prng_key(1))
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


def _sha256(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _raw_words(a):
    """A float tensor's raw bits as an unsigned numpy array of its width."""
    import numpy as np
    import torch

    a = a.detach().cpu().contiguous()
    words = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    return words.view(np.uint16 if a.element_size() == 2 else np.uint32)


def _ulp_distance(a, b) -> int:
    """The largest distance in units in the last place between two arrays of
    raw float words (sign-magnitude mapped onto a monotone integer line)."""
    import numpy as np

    sign = np.int64(1) << (8 * a.dtype.itemsize - 1)

    def line(x):
        x = x.astype(np.int64)
        return np.where(x & sign, -(x & (sign - 1)), x)

    return int(np.abs(line(a) - line(b)).max()) if a.size else 0


def threefry_phase(torch) -> dict:
    """Phase 2b: `utils/threefry.py` on the card against the committed JAX
    fixtures of tests/data/torch_prng/ (keys, split / fold_in chains, bits and
    uniforms bit for bit, normals within NORMAL_ULPS, a 1024 px FLUX latent
    within LATENT_DIFF_FRAC one-ulp elements); times a 2-candidate 1024 px
    latent draw (`search.seeds.seeds_to_latents`, as the search loops draw)
    and one training step's t and noise (B=8, 512 px: `train.rectified_flow`)."""
    import numpy as np

    from reflectionflow_tpu_torch.models.flux.latents import draw_packed_noise
    from reflectionflow_tpu_torch.search.seeds import seeds_to_latents
    from reflectionflow_tpu_torch.train.rectified_flow import _draw_t_noise
    from reflectionflow_tpu_torch.utils import threefry

    with open(os.path.join(PRNG_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    normals = np.load(os.path.join(PRNG_FIXTURES, "normals.npz"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = 0
    for name, case in sorted(manifest["cases"].items()):
        key = threefry.prng_key(case["seed"])
        for step in case["chain"]:
            op, arg = step.split(":")
            key = threefry.fold_in(key, int(arg)) if op == "fold_in" else \
                threefry.split(key, int(op[len("split"):]))[int(arg)]
        check(list(key) == case["key"], f"threefry {name}: key {key} != JAX's {case['key']}")
        shape, dt = tuple(case["shape"]), dtypes[case["dtype"]]
        bits = threefry.random_bits(key, shape, device="cuda")
        check(bits.is_cuda, "threefry drew off the card")
        check(_sha256(bits.cpu().numpy().astype(np.uint32)) == case["bits_sha256"], f"threefry {name}: bits")
        check(_sha256(_raw_words(threefry.uniform(key, shape, dt, device="cuda"))) == case["uniform_sha256"],
              f"threefry {name}: uniforms")
        ulps = _ulp_distance(_raw_words(threefry.normal(key, shape, dt, device="cuda")), normals[name])
        check(ulps <= NORMAL_ULPS, f"threefry {name}: normals {ulps} ulps from JAX's")
        worst = max(worst, ulps)
    lat = manifest["latent"]
    got = _raw_words(draw_packed_noise(threefry.prng_key(lat["seed"]), 1, lat["height"], lat["width"],
                                       lat["channels"], torch.bfloat16, device="cuda"))
    want = normals["latent"]
    diff_frac = float((got != want).mean())
    lat_ulps = _ulp_distance(got, want)
    check(diff_frac <= LATENT_DIFF_FRAC and lat_ulps <= 1,
          f"1024 px latent: {diff_frac:.2e} of the elements differ from JAX's, by up to {lat_ulps} ulps")

    def timed(fn) -> float:
        times = []
        for _ in range(PRNG_REPS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[2:])

    latent_ms = timed(lambda: seeds_to_latents([11, 12], 1024, 1024, 16, torch.bfloat16, 8, "cuda"))
    x0 = torch.empty((8, 1024, 64), device="cuda")
    train_ms = timed(lambda: _draw_t_noise(threefry.prng_key(5), tuple(x0.shape), x0.device))
    out = {"cases": len(manifest["cases"]), "normal_max_ulps": worst, "latent_diff_frac": diff_frac,
           "latent_max_ulps": lat_ulps, "latent_2x1024px_ms": latent_ms, "train_draw_b8_512px_ms": train_ms}
    log(f"threefry on the card: {len(manifest['cases'])} JAX fixture cases, bits and uniforms bitwise, normals "
        f"within {worst} ulps; 1024 px latent {diff_frac:.2e} of elements off by <= {lat_ulps} ulp; "
        f"2-candidate 1024 px latent draw {latent_ms:.3f} ms, training draw (B=8, 512 px) {train_ms:.3f} ms "
        f"(medians of {PRNG_REPS})")
    log(json.dumps({"threefry": out}))
    return out


def _median_ms(fns: dict, reps: int) -> dict:
    """{name: median ms of `reps` calls}, the functions called in turns."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(ts) for name, ts in times.items()}


def genref_fixtures(image_io) -> dict:
    """Every committed fixture: a JPEG's decode and its resize chains against
    the manifest's PIL hashes, each resize against `resize_ref` bit for bit
    (a progressive file cut short raises NotImplementedError); a PNG's
    decode (`train/data.py::decode_png`) against PIL's hash; the JPEG
    writer's bytes for each committed pixel array against PIL's save.
    Returns {name: (bytes, decoded image)} of the decodable JPEG files."""
    import hashlib

    import numpy as np

    from reflectionflow_tpu_torch.train.data import decode_png

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    out, kinds = {}, {}
    for name, entry in sorted(manifest.items()):
        kinds[entry["kind"]] = kinds.get(entry["kind"], 0) + 1
        if entry["kind"] == "encode":
            arr = np.load(os.path.join(FIXTURES, "encode_pixels.npz"))[entry["pixels"]]
            check(_sha256(arr) == entry["pixels_sha256"], f"{name}: not the committed pixels")
            jpeg = image_io.encode_jpeg(arr)
            check(hashlib.sha256(jpeg).hexdigest() == entry["jpeg_sha256"], f"{name}: JPEG bytes differ from PIL's")
            continue
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        check(_sha256(data) == entry["file_sha256"], f"{name}: not the committed fixture")
        if entry["kind"] == "png":
            check(_sha256(decode_png(data)) == entry["decode_sha256"], f"{name}: decode differs from PIL's")
            continue
        if "raises" in entry:
            try:
                image_io.decode_jpeg(data)
            except NotImplementedError as e:
                log(f"fixture {name}: NotImplementedError ({e})")
                continue
            check(False, f"{name} decoded; it must raise NotImplementedError")
        img = image_io.decode_jpeg(data)
        check(_sha256(img) == entry["decode_sha256"], f"{name}: decode differs from PIL's")
        for chain, want in entry["resize_sha256"].items():
            got = ref = img
            for step in chain.split(","):
                size = tuple(int(v) for v in step.split("x"))
                got, ref = image_io.resize_bicubic(got, size), image_io.resize_ref(ref, size)
            check(_sha256(got) == want, f"{name}: resize {chain} differs from PIL's")
            check(bool((got == ref).all()), f"{name}: resize {chain} differs from resize_ref")
        log(f"fixture {name} ({img.shape[1]}x{img.shape[0]}): decode and {len(entry['resize_sha256'])} "
            "resize chains equal PIL's hashes; resize_ref bitwise")
        out[name] = (data, img)
    log(f"fixtures by kind {kinds}: JPEG and PNG decodes and JPEG writer bytes equal PIL's hashes")
    return out


def write_genref_jpeg_shard(path: str, goods: list, bad: bytes) -> None:
    """GENREF_SAMPLES GenRef samples of JPEG bytes; every other sample's
    members sit under a directory name long enough to need PAX records."""
    import io
    import tarfile

    with tarfile.open(path, "w", format=tarfile.PAX_FORMAT) as tar:
        for i in range(GENREF_SAMPLES):
            key = f"{i:06d}"
            prefix = ("genref_" + "x" * 120 + "/") if i % 2 else ""
            files = {"good_image.jpg": goods[i % len(goods)], "bad_image.jpg": bad,
                     "prompt.txt": f"a photo of object {i} on a table".encode(),
                     "reflection.txt": f"make object {i} sharper and correctly colored".encode(),
                     "subset.txt": GENREF_SUBSETS[i % len(GENREF_SUBSETS)].encode()}
            for field, data in files.items():
                info = tarfile.TarInfo(f"{prefix}{key}.{field}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


def genref_phase(torch, pipe, card: str, host_build_s: float) -> dict:
    """Phase 5e: the GenRef data path from a JPEG shard (see the module's
    docstring)."""
    import tarfile

    import numpy as np

    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.train import data as tdata
    from reflectionflow_tpu_torch.utils import image_io, native

    t_phase = time.perf_counter()
    out = {"card": card, "host_build_s": host_build_s}
    fixtures = genref_fixtures(image_io)
    out["fixtures_checked"] = len(fixtures)
    good_names = sorted(n for n, (_, img) in fixtures.items() if img.shape[:2] == (1024, 1024))
    bad_name = next(n for n, (_, img) in fixtures.items() if img.shape[:2] == (768, 1024))
    check(len(good_names) >= 2, "fewer than two 1024^2 fixtures")

    # host timings, the median of GENREF_REPS runs
    dec = _median_ms({n: (lambda d=fixtures[n][0]: image_io.decode_jpeg(d))
                      for n in good_names + [bad_name]}, GENREF_REPS)
    img = fixtures["good_a_1024_q75_420.jpg"][1]
    res = _median_ms({"cpp": lambda: image_io.resize_bicubic(img, (512, 512)),
                      "resize_ref": lambda: image_io.resize_ref(img, (512, 512))}, GENREF_REPS)
    raw = np.random.default_rng(0).integers(0, 256, (1024, 3 * 1024 + 1), dtype=np.uint8)
    raw[:, 0] = 4  # Paeth on every row
    check(bool((image_io.png_unfilter(raw, 1024, 3072, 3)
                == image_io.png_unfilter_ref(raw, 1024, 3072, 3)).all()), "Paeth unfilter differs")
    paeth = _median_ms({"cpp": lambda: image_io.png_unfilter(raw, 1024, 3072, 3),
                        "numpy": lambda: image_io.png_unfilter_ref(raw, 1024, 3072, 3)}, GENREF_REPS)
    out.update(decode_ms=dec, decode_ms_1024_420=dec["good_a_1024_q75_420.jpg"], resize_ms=res["cpp"],
               resize_ref_ms=res["resize_ref"], resize_ref_ratio=res["resize_ref"] / res["cpp"],
               paeth_unfilter_ms=paeth["cpp"], paeth_unfilter_numpy_ms=paeth["numpy"])
    log(f"host codecs (median of {GENREF_REPS}): decode ms {', '.join(f'{n} {v:.2f}' for n, v in dec.items())}; "
        f"resize 1024^2 -> 512^2 {res['cpp']:.2f} ms C++, {res['resize_ref']:.1f} ms resize_ref "
        f"({out['resize_ref_ratio']:.1f}x); Paeth unfilter 1024^2 RGB {paeth['cpp']:.2f} ms C++, "
        f"{paeth['numpy']:.0f} ms numpy loop; {card}")

    cfg = TrainConfig()
    cfg.attn_impl, cfg.max_steps = "pallas", TRAIN_STEPS
    d = cfg.data
    schedule = tdata.StageSchedule(tdata.GENREF_SPLIT_RATIOS, list(GENREF_STAGES))
    n_blocks = pipe.dit_cfg.num_double_blocks + pipe.dit_cfg.num_single_blocks
    with tempfile.TemporaryDirectory() as tmp:
        shard = os.path.join(tmp, "genref_jpeg_000.tar")
        write_genref_jpeg_shard(shard, [fixtures[n][0] for n in good_names], fixtures[bad_name][0])
        idx = native.tar_index(shard)
        check(idx is not None and len(idx[0]) == 5 * GENREF_SAMPLES, "the native indexer did not take the shard")
        check(sum(len(n) > 100 for n in idx[0]) == 5 * (GENREF_SAMPLES // 2), "PAX long names not indexed")
        out["shard_mib"] = os.path.getsize(shard) / 2**20

        # one batch alone, split into decode, resize and the rest
        spent = {"decode": 0.0, "resize": 0.0}

        def timed(fn, key):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spent[key] += time.perf_counter() - t0
            return wrapper

        orig = tdata.decode_image, tdata.resize
        tdata.decode_image, tdata.resize = timed(orig[0], "decode"), timed(orig[1], "resize")
        calls0 = dict(image_io.calls)
        try:
            ds = tdata.GenRefDataset(shards=[shard], batch_size=d.batch_size, target_size=d.target_size,
                                     condition_size=d.condition_size, schedule=schedule, seed=cfg.seed)
            t0 = time.perf_counter()
            batch = next(iter(ds))
            batch_s = time.perf_counter() - t0
        finally:
            tdata.decode_image, tdata.resize = orig
        n_dec = image_io.calls["decode_jpeg"] - calls0.get("decode_jpeg", 0)
        n_res = image_io.calls["resize_bicubic"] - calls0.get("resize_bicubic", 0)
        shape = (d.batch_size, d.target_size, d.target_size, 3)
        check(batch["image"].shape == shape and batch["condition"].shape[0] == d.batch_size,
              f"batch shapes {batch['image'].shape}, {batch['condition'].shape}")
        check(bool(np.isfinite(batch["image"]).all() and np.abs(batch["image"]).max() <= 1.0), "bad batch values")
        check(set(batch["subset"]) <= set(GENREF_SUBSETS), f"subsets {batch['subset']}")
        out["batch"] = {"s": batch_s, "decode_s": spent["decode"], "resize_s": spent["resize"],
                        "rest_s": batch_s - spent["decode"] - spent["resize"], "jpeg_decodes": n_dec,
                        "resizes": n_res, "subsets": batch["subset"]}
        log(f"one GenRef batch (B={d.batch_size}, {d.target_size} px, condition {d.condition_size}): "
            f"{batch_s:.3f} s = decode {spent['decode']:.3f} s ({n_dec} JPEGs) + resize {spent['resize']:.3f} s "
            f"({n_res}) + rest {out['batch']['rest_s']:.3f} s; subsets {batch['subset']}")

        # train 3 steps from the shard: no tarfile read, no native fallback
        opened = []
        tar_open, fallbacks0, calls0 = tarfile.open, native.fallbacks, dict(image_io.calls)

        def counting_open(*a, **k):
            opened.append(a[0] if a else k.get("name"))
            return tar_open(*a, **k)

        tarfile.open = counting_open
        try:
            run = run_train(torch, pipe, cfg, tmp, "genref train", shard=shard, schedule=schedule)
        finally:
            tarfile.open = tar_open
        n_dec = image_io.calls["decode_jpeg"] - calls0.get("decode_jpeg", 0)
        check(not opened and native.fallbacks == fallbacks0, f"tarfile opened {opened}; "
              f"fallbacks {native.fallbacks - fallbacks0}")
        check(n_dec > 0, "training decoded no JPEG")
        check_train_launches(run["launches"], n_blocks, "genref train")
        data_s = run["data_s"][:TRAIN_STEPS]
        out.update(launches=run["launches"], s_per_step=run["s_per_step"], peak_gib=run["peak"] / 2**30,
                   losses=[r["loss"] for r in run["rows"]], step_time_s=[r["step_time_s"] for r in run["rows"]],
                   data_s_in_loop=data_s, jpeg_decodes_in_training=n_dec,
                   batch_share_of_step=batch_s / run["s_per_step"],
                   loop_data_share=statistics.mean(data_s[1:]) / run["s_per_step"])
        del run
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"GenRef JPEG training (5e): {out['s_per_step']:.3f} s/step (steps 2-{TRAIN_STEPS}); one batch "
        f"{batch_s:.3f} s alone = {100 * out['batch_share_of_step']:.1f}% of a step; in the loop "
        f"{[round(x, 3) for x in data_s]} s ({100 * out['loop_data_share']:.1f}%); phase {out['phase_s']:.1f} s; "
        f"{card}")
    torch.cuda.empty_cache()
    return out


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


def round_counts(pipe, impl: str):
    """Kernel launches per t2i forward and per conditioned forward (L = 512 +
    4096 + 1024) of the W8A8 DiT, from its block counts: the attention kernel
    of `impl` once a block (K9 under "pallas_nr", K1 under "pallas", which also
    runs K2 on each stream's q and k), K3–K5 before every W8A8 linear."""
    nd, ns = pipe.dit_cfg.num_double_blocks, pipe.dit_cfg.num_single_blocks
    per_t2i = {"adaln_quant": 4 * nd + ns, "gelu_quant": 2 * nd + ns, "rowquant": 2 * nd + ns}
    per_cond = {"adaln_quant": 6 * nd + 2 * ns, "gelu_quant": 3 * nd + 2 * ns, "rowquant": 3 * nd + 2 * ns}
    if impl == "pallas_nr":
        per_t2i["flash_fwd_nr"] = per_cond["flash_fwd_nr"] = nd + ns
    else:
        check(impl == "pallas", f"round_counts: impl {impl!r}")
        per_t2i.update({"flash_fwd": nd + ns, "norm_rope": 4 * nd + 2 * ns})
        per_cond.update({"flash_fwd": nd + ns, "norm_rope": 6 * nd + 4 * ns})
    return per_t2i, per_cond


def reflection_phase(torch, pipe, verifier=None, reflector=None, label="reflection round",
                     note="fake verify/reflect/refine: not item 19", preset="flux.1_dev_fake.json",
                     impl="pallas_nr", out_dir=None):
    """Phase 8: the reflection round. `run_reflectionflow_block` (the loop of
    the reflectionflow CLI) with the fake verifier, reflector and refiner of
    configs/flux.1_dev_fake.json, on the W8A8 pipeline with its folded int8
    cond model, under "pallas_nr" and with the prompt-embedding cache on, as
    `cli/common.py::load_pipeline` sets the int8 profile: one prompt at 1024
    px with a 512 px condition, 2 candidates per call, round 0 bootstrapped,
    then REFLECT_ROUNDS verify -> reflect -> refine -> conditioned generate
    rounds of STEPS steps. Every launch count is set to 0 just before and read
    just after; a second call on the same directory must be a resume no-op.
    Phase 10 passes its Qwen2.5-VL `verifier` and `reflector` in place of the
    fake ones; phase 11 the NVILA preset (`preset`, its `impl` and
    micro-batches) with its verifier, and an `out_dir` of its own, which it
    reads after the round and removes (else the run's directory is temporary);
    phase 12 the teacache preset, whose `vcache` the pipeline takes for the
    round, as `load_pipeline` sets it. Each generate call's full forwards
    (n_full, every step without a velocity cache) are read from `denoise`, and
    the expected launch counts are n_full times the per-forward counts."""
    import contextlib
    import re

    from reflectionflow_tpu_torch.sampler import pipeline as pipeline_mod

    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.reflect import FakeReflector, FakeRefiner
    from reflectionflow_tpu_torch.search.artifacts import round_image_name
    from reflectionflow_tpu_torch.search.reflectionflow import run_reflectionflow_block
    from reflectionflow_tpu_torch.search.seeds import candidate_seeds
    from reflectionflow_tpu_torch.search.state import SearchManifest
    from reflectionflow_tpu_torch.utils.jsonl import read_jsonl
    from reflectionflow_tpu_torch.utils.timing import PhaseTimer
    from reflectionflow_tpu_torch.verifiers import FakeVerifier

    t_phase = time.perf_counter()
    verifier, reflector = verifier or FakeVerifier(), reflector or FakeReflector()
    cfg = TTSConfig.load(os.path.join(REPO, "configs", preset))
    pa, sa = cfg.pipeline_args, cfg.search_args
    micro = cfg.batch_size_for_img_gen
    check(sa.search_branch == BRANCH and BRANCH % micro == 0 and pa.height == pa.width == 2 * LT
          and pa.condition_size == LT and pa.image_guidance_scale == 1.0 and sa.search_rounds == 16,
          f"{preset} no longer serves 2 candidates at 1024 px with a 512 px condition and no image CFG")
    check(preset != "flux.1_dev_fake.json" or (micro == BRANCH and cfg.verifier_args.name
                                               == cfg.reflection_args.name == cfg.prompt_refiner_args.name
                                               == "fake"),
          "flux.1_dev_fake.json no longer serves fake models, 2 candidates per call")
    sa.search_rounds, pa.num_inference_steps = REFLECT_ROUNDS, STEPS  # cut from 16 rounds and 30 steps
    pipe.model_flags = {"union_cond_attn": cfg.model.union_cond_attn, "add_cond_attn": cfg.model.add_cond_attn}
    pipe.attn_impl = impl
    pipe._embed_cache = None  # each run of the round starts with an empty prompt cache
    pipe.enable_prompt_cache()
    pipe.vcache = pa.vcache
    rows = round_rows()

    calls, encoded, forwards = [], [], []
    generate, encode_raw, denoise = pipe.generate, pipe._encode_raw, pipeline_mod.denoise

    def denoise_counted(*a, **kw):
        lat, n_full = denoise(*a, **kw, return_vcache_stats=True)
        forwards.append(n_full)
        return lat

    def generate_checked(prompts, **kw):
        conds = kw.get("conditions") or []
        check(all(c.image.shape == (LT, LT, 3) and tuple(c.position_delta) == (0, -LT // 16) for c in conds),
              "reflection round: a condition is not a 512 px cot image at (0, -32)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = generate(prompts, **{**kw, "output_type": "latent"})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check(tuple(lat.shape) == (len(prompts), LI, 64) and bool(torch.isfinite(lat).all()),
              f"reflection round: bad final latents {tuple(lat.shape)}")
        images = pipe.decode_latents(lat, kw["height"], kw["width"])
        calls.append({"prompts": list(prompts), "conditions": len(conds), "denoise_s": t1 - t0,
                      "decode_s": time.perf_counter() - t1, "n_full": forwards[-1]})
        return images

    def encode_counted(pairs, length):
        encoded.append(list(pairs))
        return encode_raw(pairs, length)

    pipe.generate, pipe._encode_raw, pipeline_mod.denoise = generate_checked, encode_counted, denoise_counted
    timer = PhaseTimer()
    try:
        with contextlib.nullcontext(out_dir) if out_dir else tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counters = zero_counts()
            t0 = time.perf_counter()
            dps = run_reflectionflow_block(pipe, verifier, reflector, FakeRefiner(), cfg, rows, out_dir,
                                           timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            root = os.path.join(out_dir, "00000")
            pngs = sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                          for f in fs if f.endswith(".png"))
            headers = {p: read_png_header(os.path.join(root, p)) for p in pngs}
            meta = read_jsonl(os.path.join(root, "metadata.jsonl"))
            manifest = SearchManifest.load(root)
            n_calls, n_encoded = len(calls), len(encoded)

            # the same call again on the same directory: a resume no-op
            mtimes = {p: os.path.getmtime(os.path.join(root, p)) for p in pngs}
            counters = zero_counts()
            again = run_reflectionflow_block(pipe, verifier, reflector, FakeRefiner(), cfg, rows, out_dir,
                                             timer=PhaseTimer())
            resume_launches = sum(fn.launches for fn in counters.values())
            check(len(calls) == n_calls and len(encoded) == n_encoded and resume_launches == 0
                  and again == dps and mtimes == {p: os.path.getmtime(os.path.join(root, p)) for p in pngs},
                  "the second call on a finished run was not a resume no-op")
    finally:
        pipe.generate, pipe._encode_raw, pipeline_mod.denoise, pipe.vcache = generate, encode_raw, denoise, None

    # the JAX artifact tree: every candidate at midimg/{round}_round@{seed}.png, 1024x1024x3
    want = {f"midimg/{round_image_name(r, s)}" for r in range(REFLECT_ROUNDS + 1)
            for s in candidate_seeds(0, 0, r, BRANCH)}
    want |= {f"{d}/{i:05d}.png" for d in ("samples_lastround", "samples_path_bestround") for i in range(BRANCH)}
    want.add("samples_best/00000.png")
    check(set(pngs) == want, f"reflection round wrote {pngs}, expected {sorted(want)}")
    check(all(h == (pa.width, pa.height, 8, 2) for h in headers.values()), f"PNG headers {headers}")
    check(len(meta) == REFLECT_ROUNDS and manifest.round_done == REFLECT_ROUNDS and dps[0]["flag_terminated"],
          f"{len(meta)} metadata rows, round_done {manifest.round_done}")

    # the calls: round 0 t2i calls, then the conditioned calls of each round, each of `micro`
    # candidates, whose FLUX prompts are "<refined> [Reflexion]: <reflection>" of that round's row
    per_round = BRANCH // micro
    t2i = [c for c in calls if not c["conditions"]]
    cond = [c for c in calls if c["conditions"]]
    check(len(t2i) == per_round and len(cond) == REFLECT_ROUNDS * per_round
          and all(len(c["prompts"]) == micro for c in calls) and all(c["conditions"] == micro for c in cond),
          f"reflection round: {len(t2i)} t2i and {len(cond)} conditioned generate calls of "
          f"{[len(c['prompts']) for c in calls]} candidates")
    form = re.compile(r"^(.+) \[Reflexion\]: (.+)$", re.S)
    for r, row in enumerate(meta):
        prompts = [p for c in cond[r * per_round:(r + 1) * per_round] for p in c["prompts"]]
        parts = [form.match(p) for p in prompts]
        check(all(parts) and [m.groups() for m in parts] == list(zip(row["refined_prompt"], row["reflections"])),
              f"round {row['search_round']}: FLUX prompts {prompts} are not '<refined> [Reflexion]: "
              "<reflection>' of the round's metadata")

    # the prompt cache: each encode is one batch of a call's prompts not seen before
    requested = sum(len(c["prompts"]) for c in calls)
    seen, want_batches = set(), []
    for c in calls:
        new = sorted(set(c["prompts"]) - seen)
        if new:
            want_batches.append(new)
            seen |= set(new)
    misses = [len(batch) for batch in encoded]
    check([[p for p, _ in batch] for batch in encoded] == want_batches and all(p == q for b in encoded for p, q in b)
          and want_batches[0] == [rows[0]["prompt"]] and misses == [1] + [micro] * len(cond),
          f"prompt cache: miss batches {encoded}")
    log(f"{label} prompt cache: {requested} embeddings read, {sum(misses)} misses encoded in "
        f"{len(misses)} batches {misses}, {requested - sum(misses)} hits; the resume run encoded nothing")

    # launch counts from the block counts and each call's full forwards
    per_t2i, per_cond = round_counts(pipe, impl)
    n_t2i, n_cond = sum(c["n_full"] for c in t2i), sum(c["n_full"] for c in cond)
    check(pa.vcache is not None or all(c["n_full"] == STEPS for c in calls),
          f"{label}: a dense generate call ran {[c['n_full'] for c in calls]} forwards")
    expected = {name: 0 for name in launches}
    for name in per_t2i:
        expected[name] = n_t2i * per_t2i[name] + n_cond * per_cond[name]
    log(f"{label} launches {launches} (expected {expected}: {n_t2i} t2i forwards, {n_cond} conditioned "
        f"forwards over {STEPS}-step calls, B={micro}; full forwards a call {[c['n_full'] for c in calls]})")
    check(launches == expected, f"the reflection round did not run the kernels of {impl!r} the expected number "
          "of times")

    spans = timer.spans
    rounds = []
    for r in range(REFLECT_ROUNDS):
        mine = cond[r * per_round:(r + 1) * per_round]
        split = {"round_s": spans["round"][r], "generate_s": spans["generate"][r + 1],
                 "verify_s": spans["verify"][2 * r] + spans["verify"][2 * r + 1],
                 "reflect_s": spans["reflect"][r], "refine_s": spans["refine"][r],
                 "denoise_s": sum(c["denoise_s"] for c in mine), "decode_s": sum(c["decode_s"] for c in mine)}
        split["rest_s"] = split["round_s"] - sum(split[k] for k in ("generate_s", "verify_s", "reflect_s",
                                                                      "refine_s"))
        split["host_share"] = 1.0 - split["generate_s"] / split["round_s"]
        split["n_full"] = [c["n_full"] for c in mine]
        rounds.append(split)
        log(f"{label} {r + 1}: {split['round_s']:.3f} s = generate {split['generate_s']:.3f} "
            f"(denoise and encode {split['denoise_s']:.3f}, decode {split['decode_s']:.3f}) + verify "
            f"{split['verify_s']:.4f} + reflect {split['reflect_s']:.5f} + refine {split['refine_s']:.5f} + "
            f"rest (PNG writes and loads) {split['rest_s']:.3f}; host work outside generate "
            f"{split['host_share']:.1%}")
    p50 = timer.percentile("round", 50)
    wall_phase = time.perf_counter() - t_phase
    log(f"{label} p50 {p50:.3f} s over {REFLECT_ROUNDS} rounds ({BRANCH} candidates in calls of B={micro}, "
        f"L={LT}+{LI}+{LC}, {STEPS} steps, W8A8 {impl}; {note}); "
        f"round-0 generate {spans['generate'][0]:.3f} s; block {wall:.1f} s; phase {wall_phase:.1f} s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    return {"rounds": rounds, "p50_s": p50, "round0_generate_s": spans["generate"][0], "block_s": wall,
            "phase_s": wall_phase, "peak_gib": peak / 2**30, "launches": launches,
            "cache": {"read": requested, "misses": misses}, "note": note,
            "n_full": [c["n_full"] for c in calls]}


def round_rows() -> list[dict]:
    """The round phases' one prompt: the first row of configs/geneval_sample.jsonl."""
    with open(os.path.join(REPO, "configs", "geneval_sample.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()][:1]


def _qwen_cfgs(lm_layers=None, vis_blocks=None):
    """Qwen2.5-VL-7B's configs, at full depth or cut to `lm_layers` LM layers
    and `vis_blocks` vision blocks (the last block full attention)."""
    import dataclasses

    from reflectionflow_tpu_torch.config import QwenLMConfig, QwenVLVisionConfig

    lm, vis = QwenLMConfig(), QwenVLVisionConfig()
    if lm_layers is not None:
        lm = dataclasses.replace(lm, num_layers=lm_layers)
        vis = dataclasses.replace(vis, depth=vis_blocks, fullatt_block_indexes=(vis_blocks - 1,))
    return lm, vis


def _flux_snapshot_cfgs():
    """FLUX.1-dev's configs at full width with the depth cuts of phase 9."""
    import dataclasses

    from reflectionflow_tpu_torch.config import CLIPTextConfig, FluxDiTConfig, FluxVAEConfig, T5Config

    nd, ns = SNAP_DIT_BLOCKS
    return (dataclasses.replace(FluxDiTConfig(), num_double_blocks=nd, num_single_blocks=ns), FluxVAEConfig(),
            dataclasses.replace(T5Config(), num_layers=SNAP_T5_LAYERS), CLIPTextConfig())


def write_flux_snapshot(torch, root: str, cfgs) -> dict:
    """A diffusers-layout FLUX.1 snapshot of seeded random bf16 weights (made on the
    card) under `root`, with a byte-level CLIP tokenizer at the published special
    ids; -> the written state dicts, on the card."""
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
    from reflectionflow_tpu_torch.utils.bpe import bytes_to_unicode
    from reflectionflow_tpu_torch.utils.safetensors_io import save_file

    dit, vae, t5, clip = cfgs
    src = FluxPipeline.random_init(torch.Generator(device="cuda").manual_seed(9), dit, vae, t5, clip,
                                   dtype=torch.bfloat16, device="cuda")
    configs = {
        "transformer": {"in_channels": dit.in_channels, "num_attention_heads": dit.num_heads,
                        "attention_head_dim": dit.head_dim, "num_layers": dit.num_double_blocks,
                        "num_single_layers": dit.num_single_blocks, "joint_attention_dim": dit.text_dim,
                        "pooled_projection_dim": dit.pooled_dim, "axes_dims_rope": list(dit.axes_dims_rope),
                        "guidance_embeds": dit.guidance_embeds},
        "vae": {"in_channels": vae.in_channels, "latent_channels": vae.latent_channels,
                "block_out_channels": list(vae.block_out_channels), "layers_per_block": vae.layers_per_block,
                "norm_num_groups": vae.norm_num_groups, "scaling_factor": vae.scaling_factor,
                "shift_factor": vae.shift_factor},
        "text_encoder_2": {"vocab_size": t5.vocab_size, "d_model": t5.d_model, "d_kv": t5.d_kv, "d_ff": t5.d_ff,
                           "num_layers": t5.num_layers, "num_heads": t5.num_heads},
        "text_encoder": {"vocab_size": clip.vocab_size, "hidden_size": clip.hidden_size,
                         "intermediate_size": clip.intermediate_size, "num_hidden_layers": clip.num_layers,
                         "num_attention_heads": clip.num_heads,
                         "max_position_embeddings": clip.max_position_embeddings, "eos_token_id": clip.eos_token_id},
    }
    written = {}
    for sub, module in (("transformer", src.dit), ("vae", src.vae), ("text_encoder_2", src.t5),
                        ("text_encoder", src.clip)):
        sd = module.state_dict()
        save_file(sd, os.path.join(root, sub, "diffusion_pytorch_model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(configs[sub], f)
        written[sub] = sd
    chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars])}
    vocab.update({"<|startoftext|>": clip.vocab_size - 2, "<|endoftext|>": clip.vocab_size - 1})
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return written


def write_qwen_snapshot(torch, root: str, lm_cfg, vis_cfg) -> dict:
    """A Qwen2.5-VL snapshot of seeded random bf16 weights: transformers' newer key
    layout in two shards, config.json and a byte-level tokenizer.json with the
    chat special tokens at their published ids; -> {written name: tensor}."""
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel, QwenVLSpecialTokens
    from reflectionflow_tpu_torch.utils.bpe import bytes_to_unicode
    from reflectionflow_tpu_torch.utils.safetensors_io import save_file

    model = QwenVLModel.random_init(torch.Generator(device="cuda").manual_seed(10), lm_cfg, vis_cfg,
                                    dtype=torch.bfloat16, device="cuda")
    sd = {k.replace("model.", "model.language_model.", 1).replace("visual.", "model.visual.", 1): v
          for k, v in model.state_dict().items()}
    names = sorted(sd)
    for i in range(2):
        save_file({k: sd[k] for k in names[i::2]}, os.path.join(root, f"model-0000{i + 1}-of-00002.safetensors"))
    cfg = {"vocab_size": lm_cfg.vocab_size, "hidden_size": lm_cfg.hidden_size,
           "intermediate_size": lm_cfg.intermediate_size, "num_hidden_layers": lm_cfg.num_layers,
           "num_attention_heads": lm_cfg.num_heads, "num_key_value_heads": lm_cfg.num_kv_heads,
           "rope_theta": lm_cfg.rope_theta, "rope_scaling": {"type": "mrope", "mrope_section": list(lm_cfg.mrope_section)},
           "tie_word_embeddings": lm_cfg.tie_word_embeddings,
           "vision_config": {"depth": vis_cfg.depth, "hidden_size": vis_cfg.hidden_size,
                             "intermediate_size": vis_cfg.intermediate_size, "num_heads": vis_cfg.num_heads,
                             "patch_size": vis_cfg.patch_size, "temporal_patch_size": vis_cfg.temporal_patch_size,
                             "spatial_merge_size": vis_cfg.spatial_merge_size, "window_size": vis_cfg.window_size,
                             "fullatt_block_indexes": list(vis_cfg.fullatt_block_indexes),
                             "out_hidden_size": vis_cfg.out_hidden_size}}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    tok = QwenVLSpecialTokens()
    added = [{"id": i, "content": c, "special": True} for c, i in (
        ("<|endoftext|>", tok.endoftext), ("<|im_start|>", tok.im_start), ("<|im_end|>", tok.im_end),
        ("<|vision_start|>", tok.vision_start), ("<|vision_end|>", tok.vision_end),
        ("<|image_pad|>", tok.image_pad), ("<|video_pad|>", tok.video_pad))]
    with open(os.path.join(root, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"added_tokens": added, "model": {"type": "BPE", "merges": [],
                                                    "vocab": {c: i for i, c in enumerate(bytes_to_unicode().values())}}},
                  f, ensure_ascii=False)
    return {k: v for k, v in model.state_dict().items()}


def snapshot_phase(torch):
    """Phase 9: `FluxPipeline.from_pretrained` and `load_qwen_vl` on snapshots this
    phase writes (full width, depth cut), every tensor bitwise what was written, on
    cuda without a device argument; then generate 1 prompt x 2 candidates at 1024 px
    with `vae_tiling` (128^2 latents in 3 x 3 tiles) under "pallas", once in bf16
    and once after the CLI's int8 profile, with exact K1–K5 counts; the loaded
    Qwen's verifier scores of the two images in bf16 and under quantize="int8"
    (`qwen_int8_check`); and the single-tile decode of a 64^2 latent bitwise
    equal to the untiled decode."""
    import shutil

    from reflectionflow_tpu_torch.models.flux import vae as fvae
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline
    from reflectionflow_tpu_torch.utils.hf_loader import load_qwen_vl

    t0, px = time.perf_counter(), 1024
    lm_cfg, vis_cfg = _qwen_cfgs(SNAP_QWEN_LM_LAYERS, SNAP_QWEN_VIS_BLOCKS)
    root = tempfile.mkdtemp(prefix="snapshot_")
    try:
        written = write_flux_snapshot(torch, os.path.join(root, "flux"), _flux_snapshot_cfgs())
        q_written = write_qwen_snapshot(torch, os.path.join(root, "qwen"), lm_cfg, vis_cfg)
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t0
        gib = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs) / 2**30

        t1 = time.perf_counter()
        pipe = FluxPipeline.from_pretrained(os.path.join(root, "flux"))  # no device: cuda
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        check(pipe.device.type == "cuda" and pipe.dtype == torch.bfloat16, f"from_pretrained landed on {pipe.device}")
        for sub, module in (("transformer", pipe.dit), ("vae", pipe.vae), ("text_encoder_2", pipe.t5),
                            ("text_encoder", pipe.clip)):
            got = module.state_dict()
            check(set(got) == set(written[sub]) and all(
                v.device.type == "cuda" and torch.equal(v, written[sub][k]) for k, v in got.items()),
                f"{sub}: the loaded tensors are not bitwise the written ones")
        del written
        check(type(pipe.clip_tokenizer).__name__ == "CLIPBPETokenizer", "the snapshot's CLIP tokenizer was not loaded")
        t2 = time.perf_counter()
        qmodel, qtok = load_qwen_vl(os.path.join(root, "qwen"))
        torch.cuda.synchronize()
        t_qload = time.perf_counter() - t2
        got = qmodel.state_dict()
        check(qmodel.device.type == "cuda" and set(got) == set(q_written)
              and all(torch.equal(v, q_written[k]) for k, v in got.items()),
              "load_qwen_vl: the loaded tensors are not bitwise the written ones")
        check(qtok is not None and qtok.encode("<|im_start|>user\n")[0] == 151644, "the Qwen tokenizer was not loaded")
        del q_written, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"snapshot load: wrote {gib:.2f} GiB in {t_write:.1f} s; FLUX from_pretrained {t_load:.1f} s, "
        f"load_qwen_vl {t_qload:.1f} s; every tensor bitwise equal on cuda (cut to DiT {SNAP_DIT_BLOCKS}, "
        f"T5 {SNAP_T5_LAYERS} layers, Qwen LM {lm_cfg.num_layers} layers, vision {vis_cfg.depth} blocks)")

    decode_calls = []
    vae_decode = fvae.vae_decode

    def counted_decode(vae, z):
        decode_calls.append(tuple(z.shape))
        return vae_decode(vae, z)

    pipe.attn_impl, pipe.vae_tiling = "pallas", True
    nd, ns = pipe.dit_cfg.num_double_blocks, pipe.dit_cfg.num_single_blocks
    kw = dict(height=px, width=px, num_inference_steps=SNAP_STEPS, max_sequence_length=LT, seed=0)
    res = {"gib_written": gib, "write_s": t_write, "flux_load_s": t_load, "qwen_load_s": t_qload,
           "cut": {"dit_blocks": list(SNAP_DIT_BLOCKS), "t5_layers": SNAP_T5_LAYERS,
                   "qwen_lm_layers": lm_cfg.num_layers, "qwen_vision_blocks": vis_cfg.depth}}
    fvae.vae_decode = counted_decode
    try:
        for label in ("bf16", "int8"):
            if label == "int8":  # the CLI's int8 profile (cli/common.py::load_pipeline)
                pipe.quantize(int4=(), weight_only=("t5",))
                pipe.enable_prompt_cache()
            decode_calls.clear()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            counters = zero_counts()
            images = pipe.generate(["a photo of a red cube on a wooden table"] * BRANCH, **kw)
            launches = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t3
            lat = px // pipe.vae_cfg.downscale
            n_tiles = (-(-lat // 48)) ** 2  # tiles of 64 latents at stride 48
            check(images.shape == (BRANCH, px, px, 3) and images.dtype.name == "uint8",
                  f"snapshot {label} generate: images {images.shape}")
            check(len(decode_calls) == n_tiles and all(s[1] <= 64 and s[2] <= 64 for s in decode_calls),
                  f"snapshot {label}: {len(decode_calls)} decode tiles {decode_calls[:4]}, expected {n_tiles}")
            expected = {name: 0 for name in launches}
            expected["flash_fwd"] = SNAP_STEPS * (nd + ns)
            if label == "int8":
                expected.update({"norm_rope": SNAP_STEPS * (4 * nd + 2 * ns),
                                 "adaln_quant": SNAP_STEPS * (4 * nd + ns),
                                 "gelu_quant": SNAP_STEPS * (2 * nd + ns), "rowquant": SNAP_STEPS * (2 * nd + ns)})
            check(launches == expected, f"snapshot {label} generate launched {launches}, expected {expected}")
            log(f"snapshot {label} generate (B={BRANCH}, {px} px, {SNAP_STEPS} steps, vae_tiling: "
                f"{len(decode_calls)} tiles): {dt:.2f} s; launches {launches}")
            res[f"launches_{label}"], res[f"generate_{label}_s"] = launches, dt
            res["decode_tiles"] = len(decode_calls)
    finally:
        fvae.vae_decode = vae_decode
    res["qwen_int8"] = qwen_int8_check(torch, qmodel, qtok, list(images), px)
    del qmodel
    z = torch.randn((1, 64, 64, pipe.vae_cfg.latent_channels), generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        check(torch.equal(fvae.vae_decode_tiled(pipe.vae, z), fvae.vae_decode(pipe.vae, z)),
              "the single-tile decode of a 64^2 latent is not bitwise the untiled decode")
    del pipe
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"snapshot phase (9): {res['phase_s']:.1f} s")
    return res


def qwen_int8_check(torch, model, tokenizer, images, px: int) -> dict:
    """The W8A8 Qwen verifier on the card: `model` (phase 9's loaded snapshot)
    scores `images` in bf16, then `QwenRewardVerifier(quantize="int8")` puts its
    LM and vision block linears on `QuantLinear` in place and scores them again
    (|int8 - bf16| <= QWEN_INT8_TOL; the random head's hidden^-1/2 weights on the
    RMS-normed last state make the scores of order 1). The vision MLP (3420
    wide) holds its int8 weights padded to 3424 for the library int8 GEMM; its
    W8A8 product is held bit for bit to an fp64 product of the same int8
    operands (exact: |sum| < 2^53) with the same fp32 rescale, at M = 5 (the
    GEMM's short-M path) and M = 300."""
    from reflectionflow_tpu_torch.models.qwen_vl.reward import RewardHead
    from reflectionflow_tpu_torch.ops.quant import QuantLinear
    from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

    head = RewardHead.random_init(torch.Generator(device="cuda").manual_seed(12), model.lm_cfg.hidden_size)
    prompts = ["a photo of a red cube on a wooden table"] * len(images)
    t0 = time.perf_counter()
    bf16 = QwenRewardVerifier(model=model, tokenizer=tokenizer, head=head).raw_scores(images, prompts)
    verifier = QwenRewardVerifier(model=model, tokenizer=tokenizer, head=head, quantize="int8")
    int8 = verifier.raw_scores(images, prompts)
    mlp = model.visual.blocks[0].mlp
    check(all(isinstance(m, QuantLinear) for m in (mlp.gate_proj, mlp.down_proj,
                                                    model.model.layers[0].self_attn.q_proj)),
          "quantize='int8' left a block linear in bf16")
    inter = model.vis_cfg.intermediate_size
    padded = -(-inter // 8) * 8
    check(tuple(mlp.gate_proj.w_q.shape) == (padded, model.vis_cfg.hidden_size)
          and mlp.down_proj.w_q.shape[1] == padded, f"vision MLP int8 weights {tuple(mlp.gate_proj.w_q.shape)}")
    g = torch.Generator(device="cuda").manual_seed(13)
    for lin in (mlp.gate_proj, mlp.down_proj):
        n, k = lin.w_scale.shape[0], lin.in_features
        for m in (5, 300):
            x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            x_scale = torch.rand((m, 1), generator=g, device="cuda") + 0.5
            with torch.no_grad():
                got = lin.matmul_pre(x_q, x_scale, torch.float32)
                acc = (x_q.double() @ lin.w_q[:n, :k].double().t()).float()
                want = (acc * x_scale).mul_(lin.w_scale)
                want = want if lin.bias is None else want + lin.bias
            check(torch.equal(got, want), f"W8A8 ({m}, {k}) x ({n}, {k}): max |err| {(got - want).abs().max().item()}")
    err = max(abs(a - b) for a, b in zip(int8, bf16))
    log(f"Qwen verifier, quantize='int8' ({len(images)} images at {px} px, W8A8 LM and vision blocks, vision MLP "
        f"padded {inter} -> {mlp.gate_proj.w_q.shape[0]}): scores {list(map(float, int8))} against bf16 "
        f"{list(map(float, bf16))}, max |diff| {err:.4f} (limit {QWEN_INT8_TOL}); padded W8A8 products bitwise "
        f"equal to fp64 at M = 5 and 300; {time.perf_counter() - t0:.1f} s")
    check(all(map(math.isfinite, int8)) and len(int8) == len(images) and err <= QWEN_INT8_TOL,
          f"int8 verifier scores {int8} against bf16 {bf16}")
    return {"scores_bf16": [float(v) for v in bf16], "scores_int8": [float(v) for v in int8], "max_abs_diff": err}


class ByteStubTokenizer:
    """Random weights have no vocabulary: phase 10's reflector encodes text as
    its UTF-8 bytes (ids 5..260, so prompts keep their length) and decodes ids
    as numbers."""

    def encode(self, text, add_special_tokens=False):
        return [5 + b for b in text.encode("utf-8")]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _cosine(a, b) -> float:
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def reflection_models_phase(torch, pipe):
    """Phase 10: the reflection round with the local models. One Qwen2.5-VL-7B
    (full width and depth, seeded random bf16 weights on the card) is both the
    `QwenRewardVerifier` (random head, "last" pooling) and the `LocalQwenReflector`
    (QWEN_NEW_TOKENS new tokens); phase 8's W8A8 "pallas_nr" round runs with them
    (exact K9/K3–K5 counts, no K1/K2/K8). Checks finite scores and one reflection
    per candidate; the cached decode against a full recompute (cosine >= QWEN_COS
    at the last prefill position and the first 4 decode steps); times prefill,
    decode per token at B=2 and the vision tower per image."""
    import numpy as np

    from reflectionflow_tpu_torch.models.qwen_vl.generate import QwenVLGenerator, decode_tokens, prefill
    from reflectionflow_tpu_torch.models.qwen_vl.lm import qwen_lm_apply
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel
    from reflectionflow_tpu_torch.models.qwen_vl.reward import RewardHead
    from reflectionflow_tpu_torch.models.qwen_vl.vision import image_to_patches, qwen_vision_apply, smart_resize
    from reflectionflow_tpu_torch.reflect.generator import LocalQwenReflector
    from reflectionflow_tpu_torch.train.data import resize
    from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

    t0 = time.perf_counter()
    lm_cfg, vis_cfg = _qwen_cfgs()
    gen = torch.Generator(device="cuda").manual_seed(11)
    model = QwenVLModel.random_init(gen, lm_cfg, vis_cfg, dtype=torch.bfloat16, device="cuda")
    qwen_gib = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30
    verifier = QwenRewardVerifier(model=model, head=RewardHead.random_init(gen, lm_cfg.hidden_size, pooling="last"))
    generator = QwenVLGenerator(model=model, tokenizer=ByteStubTokenizer())
    reflector = LocalQwenReflector(generator, max_new_tokens=QWEN_NEW_TOKENS)
    torch.cuda.synchronize()
    log(f"Qwen2.5-VL ({lm_cfg.num_layers} x {lm_cfg.hidden_size} LM, {vis_cfg.depth} x {vis_cfg.hidden_size} "
        f"vision): {qwen_gib:.2f} GiB of bf16 weights made in {time.perf_counter() - t0:.1f} s")

    scores, reflections, inputs = [], [], []
    score, generate = verifier.score, reflector.generate

    def score_recorded(images, prompts, **kw):
        out = score(images, prompts, **kw)
        scores.append([o["VQ"] for o in out])
        check(len(out) == len(images) and all(math.isfinite(v) for v in scores[-1]),
              f"verifier scores {scores[-1]} for {len(images)} images")
        return out

    def generate_recorded(images, *args, **kw):
        out = generate(images, *args, **kw)
        reflections.append(out)
        inputs.append(list(images))
        check(len(out) == len(images) and all(isinstance(t, str) and t for t in out),
              f"{len(out)} reflections for {len(images)} candidates")
        return out

    verifier.score, reflector.generate = score_recorded, generate_recorded
    res = reflection_phase(torch, pipe, verifier=verifier, reflector=reflector, label="reflection round (Qwen)",
                           note="Qwen2.5-VL verify and reflect, random weights, fake refine")
    check(len(reflections) == REFLECT_ROUNDS and all(len(s) == BRANCH for s in scores),
          f"{len(reflections)} reflect calls, verifier calls of {[len(s) for s in scores]} images")

    # the cached decode against a full recompute, on the last round's two reflection inputs
    factor = vis_cfg.patch_size * vis_cfg.spatial_merge_size
    imgs = [resize(img, smart_resize(*img.shape[:2], factor=factor, max_pixels=448 * 448)[::-1]) for img in inputs[-1]]
    seqs = [(generator._build_chat_ids(img, f"prompt {i} " * (3 * i + 1), system="You are a helpful assistant."),
             [img]) for i, img in enumerate(imgs)]
    with torch.no_grad():
        embeds, pos, cache, next_pos0 = generator.prepare_batch(seqs, 8)
        logits, cache = prefill(model, embeds, pos, cache)
        pads = cache["pad"].tolist()
        toks, cos = [], []
        for step in range(5):
            if step:
                tok = torch.argmax(logits[:, -1], dim=-1)
                toks.append(tok)
                p = (next_pos0 + step - 1)[None, :, None].expand(3, len(seqs), 1)
                logits, cache = qwen_lm_apply(model.model, model.lm_head, model.model.embed_tokens(tok)[:, None], p,
                                              kv_cache=cache)
            for b in range(len(seqs)):
                e = embeds[b : b + 1, pads[b]:]
                q = pos[:, b : b + 1, pads[b]:]
                if toks:
                    e = torch.cat([e, model.model.embed_tokens(torch.stack(toks, 1)[b : b + 1])], dim=1)
                    q = torch.cat([q, (next_pos0[b] + torch.arange(len(toks), device="cuda"))[None, None].expand(3, 1, -1)], -1)
                full, _ = qwen_lm_apply(model.model, model.lm_head, e, q)
                cos.append(_cosine(logits[b, -1], full[0, -1]))
    log(f"cached decode vs full recompute (B={len(seqs)}, left pads {pads}): logits cosine min {min(cos):.6f} over "
        f"the last prefill position and 4 decode steps (limit {QWEN_COS})")
    check(min(cos) >= QWEN_COS, f"cached decode disagrees with the full recompute: cosines {cos}")

    # prefill, decode per token at B=2, the vision tower per image
    patches, grid = image_to_patches(imgs[0], vis_cfg)
    stack = torch.from_numpy(np.stack([patches, patches])).to("cuda", torch.bfloat16)
    with torch.no_grad():
        vision_ms = _best_ms(torch, lambda: qwen_vision_apply(model.visual, stack, grid)) / 2
        L = embeds.shape[1]

        def fresh():
            return generator.prepare_batch(seqs, QWEN_NEW_TOKENS)

        def run_prefill():
            e, p, c, _ = state
            c["len"] = 0  # refill the same cache
            prefill(model, e, p, c)

        state = fresh()
        prefill_ms = _best_ms(torch, run_prefill)

        def run_decode():
            e, p, c, n0 = fresh()
            lg, c = prefill(model, e, p, c)
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            decode_tokens(model, c, lg[:, -1], n0, max_new_tokens=QWEN_NEW_TOKENS, eos_id=-1)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t_a)

        decode_s = []
        for _ in range(2):
            run_decode()
    decode_ms = min(decode_s) * 1e3 / QWEN_NEW_TOKENS
    weight_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters() if not n.startswith("visual"))
    bound_ms = weight_bytes / (HBM_TBS * 1e12) * 1e3
    log(f"Qwen timings: prefill {prefill_ms:.2f} ms (B={len(seqs)}, L={L}); decode {decode_ms:.2f} ms/token "
        f"(B={len(seqs)}, {QWEN_NEW_TOKENS} tokens; LM weight-read bound {bound_ms:.2f} ms); vision "
        f"{vision_ms:.2f} ms/image (grid {grid}, B=2)")
    res["clip"] = qwen_clip_check(torch, verifier)
    res.update({"qwen_gib": qwen_gib, "verifier_scores": scores, "reflection_chars": [[len(t) for t in r] for r in reflections],
                "cache_cosine_min": min(cos), "prefill_ms": prefill_ms, "prefill_len": L, "decode_ms_per_token": decode_ms,
                "decode_bound_ms": bound_ms, "vision_ms_per_image": vision_ms, "vision_grid": list(grid),
                "new_tokens": QWEN_NEW_TOKENS, "phase_s_with_model": time.perf_counter() - t0})
    del verifier.score, reflector.generate  # the recording wrappers hold their bound methods: a cycle
    del verifier, reflector, generator, model  # so the Qwen model is freed here, not at a later gc
    torch.cuda.empty_cache()
    log(f"reflection round with models (10): {res['phase_s_with_model']:.1f} s")
    return res


def qwen_clip_check(torch, verifier) -> dict:
    """Phase 10's video clip: QWEN_CLIP_FRAMES synthetic frames at QWEN_CLIP_PX
    through the resident `QwenRewardVerifier`; a finite score on the grid that
    `fetch_video` + `video_to_patches` give the clip at the verifier's
    max_pixels, video pads for every merged patch; its ms (a second call)."""
    import numpy as np

    from reflectionflow_tpu_torch.models.qwen_vl.video import fetch_video, video_to_patches

    clip = np.random.default_rng(15).integers(0, 256, (QWEN_CLIP_FRAMES, QWEN_CLIP_PX, QWEN_CLIP_PX, 3), np.uint8)
    prompt = "a red cube rotating on a wooden table"
    model = verifier.rm.model
    merge = model.vis_cfg.spatial_merge_size
    want = video_to_patches(fetch_video(clip, image_factor=model.vis_cfg.patch_size * merge,
                                        max_pixels=verifier.max_pixels), model.vis_cfg)[1]
    ids, _, grid = verifier._prepare_ids(clip, prompt)
    n_pads = int((ids == model.tokens.video_pad).sum())
    check(grid == want and n_pads == grid[0] * (grid[1] // merge) * (grid[2] // merge),
          f"clip grid {grid} with {n_pads} video pads, fetch_video + video_to_patches give {want}")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = verifier.raw_scores([clip], [prompt])[0]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(score), f"clip score {score}")
    log(f"Qwen2.5-VL clip ({QWEN_CLIP_FRAMES} x {QWEN_CLIP_PX} px, max_pixels {verifier.max_pixels}): grid {grid}, "
        f"{n_pads} video pads, score {score:.4f}, {times[-1]:.1f} ms (first call {times[0]:.1f} ms)")
    return {"grid": list(grid), "video_pads": n_pads, "score": score, "ms": times[-1], "first_ms": times[0]}


def k1_preset_check(torch) -> dict:
    """Phase 11 (c): K1 at the NVILA preset's serving shape, K1_PRESET (B=1:
    batch_size_for_img_gen 1; L = 512 + 4096 + 1024 with the cond segment at
    4608, cross bias 0: union attention, nothing masked), against the fp32
    plain version (OUT_TOL, LSE_TOL); a second launch bitwise equal to the
    first; timed in turns with the plain version (CUDA events) and beside SDPA
    (no mask needed: cross bias 0 masks nothing), with its bound."""
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref

    B, L, main_len, cb = K1_PRESET
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v = (torch.randn((B, L, 24, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        out, lse = flash_attention_fwd(q, k, v, main_len, cb)
        out2, lse2 = flash_attention_fwd(q, k, v, main_len, cb)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), main_len, cb)
        e_out = (out.float() - ref_out).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
        del ref_out, ref_lse, out2, lse2
        kern_ms, plain_ms = in_turns(torch, lambda: flash_attention_fwd(q, k, v, main_len, cb),
                                     lambda: flash_attention_ref(q, k, v, main_len, cb), 20, 3)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh), 20)
    flops = 4 * B * L * L * D * 24
    b = bound(flops, 4 * B * L * 24 * D * 2 + B * 24 * L * 4)
    log(f"K1 B={B} L={L} main_len={main_len} cross_bias={cb} (NVILA preset): max|out err| {e_out:.3e} (tol {OUT_TOL}), "
        f"max|lse err| {e_lse:.3e} (tol {LSE_TOL}), second launch bitwise {bitwise}; kernel {kern_ms:.4f} ms "
        f"({flops / kern_ms / 1e9:.1f} TFLOP/s, bound {b[0]:.4f} ms ({b[1]}), {b[0] / kern_ms:.1%} of it), plain "
        f"{plain_ms:.4f} ms, SDPA forward {lib:.4f} ms")
    check(e_out <= OUT_TOL and e_lse <= LSE_TOL, "K1 disagrees with its plain version at the NVILA preset's shape")
    check(bitwise, "K1's second launch at the NVILA preset's shape is not bitwise its first")
    del q, k, v, qh, kh, vh, out, lse
    torch.cuda.empty_cache()
    return {"ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib, "bound_ms": b[0], "bound_by": b[1],
            "tflops": flops / kern_ms / 1e9, "bound_share": b[0] / kern_ms, "main_len": main_len, "cross_bias": cb,
            "max_abs_err": e_out, "lse_max_abs_err": e_lse, "bitwise": bitwise}


def _nvila_cfgs():
    """NVILA-Lite-2B's published widths: the SigLIP-SO400M-patch14-448 tower
    (`SiglipVisionConfig`'s defaults), the Qwen2-1.5B `llm/` (vocab 151936,
    hidden 1536, MLP 8960, 28 layers, 12 heads, 2 KV heads, head_dim 128,
    theta 1e6, tied embeddings) and the mlp_downsample_3x3_fix projector."""
    from reflectionflow_tpu_torch.config import NvilaConfig, QwenLMConfig, SiglipVisionConfig

    lm = QwenLMConfig(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_layers=28, num_heads=12,
                      num_kv_heads=2, head_dim=128, rope_theta=1e6, mrope_section=(64, 0, 0),
                      tie_word_embeddings=True)
    return SiglipVisionConfig(), lm, NvilaConfig(select_layer=-2, downsample=3)


def write_nvila_bundle(torch, root: str, vis_cfg, lm_cfg, cfg) -> dict:
    """A VILA bundle of seeded random bf16 weights made on the card: `llm/`
    (Qwen2 config and a byte-level tokenizer.json with the chat tokens at their
    published ids), `vision_tower/`, `mm_projector/` (mlp_downsample_3x3_fix:
    layers.{1,2,4}) and the root config.json; -> {subdir: written state dict}."""
    from reflectionflow_tpu_torch.models.nvila.model import NvilaModel
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLSpecialTokens
    from reflectionflow_tpu_torch.utils.bpe import bytes_to_unicode
    from reflectionflow_tpu_torch.utils.safetensors_io import save_file

    model = NvilaModel.random_init(torch.Generator(device="cuda").manual_seed(14), vis_cfg, lm_cfg, cfg,
                                   dtype=torch.bfloat16, device="cuda")
    configs = {
        "llm": {"architectures": ["Qwen2ForCausalLM"], "vocab_size": lm_cfg.vocab_size,
                "hidden_size": lm_cfg.hidden_size, "intermediate_size": lm_cfg.intermediate_size,
                "num_hidden_layers": lm_cfg.num_layers, "num_attention_heads": lm_cfg.num_heads,
                "num_key_value_heads": lm_cfg.num_kv_heads, "rope_theta": lm_cfg.rope_theta,
                "rms_norm_eps": lm_cfg.rms_norm_eps, "tie_word_embeddings": lm_cfg.tie_word_embeddings},
        "vision_tower": {"hidden_size": vis_cfg.hidden_size, "intermediate_size": vis_cfg.intermediate_size,
                         "num_hidden_layers": vis_cfg.num_layers, "num_attention_heads": vis_cfg.num_heads,
                         "patch_size": vis_cfg.patch_size, "image_size": vis_cfg.image_size,
                         "layer_norm_eps": vis_cfg.layer_norm_eps},
        "mm_projector": {"mm_projector_type": "mlp_downsample_3x3_fix"},
    }
    written = {}
    for sub, module in (("llm", model.llm), ("vision_tower", model.vision_tower), ("mm_projector", model.mm_projector)):
        sd = module.state_dict()
        save_file(sd, os.path.join(root, sub, "model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(configs[sub], f)
        written[sub] = sd
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"mm_vision_select_layer": cfg.select_layer}, f)
    tok = QwenVLSpecialTokens()
    added = [{"id": i, "content": c, "special": True} for c, i in (
        ("<|endoftext|>", tok.endoftext), ("<|im_start|>", tok.im_start), ("<|im_end|>", tok.im_end))]
    with open(os.path.join(root, "llm", "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"added_tokens": added, "model": {"type": "BPE", "merges": [],
                                                    "vocab": {c: i for i, c in enumerate(bytes_to_unicode().values())}}},
                  f, ensure_ascii=False)
    return written


def _turns_ms(torch, fns: dict, reps: int) -> dict:
    """Each thunk of `fns` run `reps` times in turns with the others, the card
    synchronised on each side; -> the same keys, each a list of `reps` ms."""
    ms = {key: [] for key in fns}
    for _ in range(reps):
        for key, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    return ms


def _best_ms(torch, fn, reps=3) -> float:
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def nvila_phase(torch, pipe):
    """Phase 11: the NVILA-scored round. (c) K1 at the preset's shape; (a) a
    full-size NVILA-Lite-2B bundle of random bf16 weights written and read back
    by `load_nvila` (no device: cuda), every tensor bitwise; (b) the verifier
    of configs/flux.1_dev_nvilascore.json (`nvila_jax`, quantize int8) built by
    `build_verifier`, and phase 8's round under the preset's pipeline args
    (W8A8, "pallas", 1 candidate a call) with fake reflect and refine (the
    preset's are OpenAI backends): exact K1–K5 counts, no K8/K9; on the round's
    directory (d) the int8 yes/no logits against the bf16 model's and (e) the
    `verifier_filter` CLI with --nfes 1 2; (f) the score pass timed at
    NVILA_TIMED_B, int8 and bf16 in turns, tower and LM apart, and the
    phase's peak memory."""
    import glob
    import shutil

    from reflectionflow_tpu_torch.cli import verifier_filter
    from reflectionflow_tpu_torch.cli.common import build_verifier
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.models.nvila.model import nvila_logits
    from reflectionflow_tpu_torch.models.nvila.siglip import siglip_apply
    from reflectionflow_tpu_torch.ops.quant import QuantLinear
    from reflectionflow_tpu_torch.search.artifacts import load_image
    from reflectionflow_tpu_torch.utils.hf_loader import load_nvila
    from reflectionflow_tpu_torch.verifiers.nvila import NvilaJaxVerifier

    t0 = time.perf_counter()
    start_gib = torch.cuda.memory_allocated() / 2**30
    log(f"NVILA phase (11) starts with {start_gib:.2f} GiB allocated on the card (the W8A8 pipeline)")
    k1 = k1_preset_check(torch)
    torch.cuda.reset_peak_memory_stats()
    vis_cfg, lm_cfg, ncfg = _nvila_cfgs()
    preset = os.path.join(REPO, "configs", "flux.1_dev_nvilascore.json")
    cfg = TTSConfig.load(preset)
    va, pa = cfg.verifier_args, cfg.pipeline_args
    check((va.name, va.quantize, pa.quantize, pa.attn_impl, cfg.batch_size_for_img_gen) ==
          ("nvila_jax", "int8", "int8", "pallas", 1),
          f"{preset} no longer asks for nvila_jax int8 beside a W8A8 'pallas' DiT, 1 candidate a call")
    root = tempfile.mkdtemp(prefix="nvila_")
    try:
        bundle = os.path.join(root, "bundle")
        t1 = time.perf_counter()
        written = write_nvila_bundle(torch, bundle, vis_cfg, lm_cfg, ncfg)
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t1
        gib = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(bundle) for f in fs) / 2**30
        t1 = time.perf_counter()
        bf16 = load_nvila(bundle)  # no device: cuda
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        for sub, part in (("llm", bf16.llm), ("vision_tower", bf16.vision_tower), ("mm_projector", bf16.mm_projector)):
            got = part.state_dict()
            check(set(got) == set(written[sub]) and all(v.device.type == "cuda" and torch.equal(v, written[sub][k])
                                                        for k, v in got.items()),
                  f"load_nvila {sub}: the loaded tensors are not bitwise the written ones")
        del written, got
        check((bf16.cfg.select_layer, bf16.cfg.downsample) == (-2, 3) and bf16.tokenizer is not None
              and bf16.tokenizer.encode("<|im_start|>user\n")[0] == 151644, "load_nvila: bundle config or tokenizer")
        log(f"NVILA bundle: wrote {gib:.2f} GiB in {t_write:.1f} s, load_nvila {t_load:.1f} s, every tensor bitwise "
            f"on cuda (tower {vis_cfg.num_layers} x {vis_cfg.hidden_size}, LM {lm_cfg.num_layers} x "
            f"{lm_cfg.hidden_size}, vocab {lm_cfg.vocab_size}, projector mlp_downsample_3x3_fix; full depth)")
        bf16 = bf16.cpu()  # the bf16 copy waits on the host while the preset's int8 verifier serves the round

        va.model_path = bundle
        t1 = time.perf_counter()
        verifier = build_verifier(cfg, device="cuda")  # as the CLIs build it
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t1
        m = verifier.model
        check(isinstance(verifier, NvilaJaxVerifier) and m.device.type == "cuda" and all(
            isinstance(lin, QuantLinear) for blocks in (m.llm.model.layers, m.vision_tower.vision_model.encoder.layers)
            for lin in blocks.modules() if isinstance(lin, (QuantLinear, torch.nn.Linear))),
            "the preset's verifier is not the int8 nvila_jax on cuda")
        int8_gib = sum(t.numel() * t.element_size() for t in list(m.parameters()) + list(m.buffers())) / 2**30

        out_dir, rows = os.path.join(root, "round"), round_rows()
        res = reflection_phase(torch, pipe, verifier=verifier, label="reflection round (NVILA preset)",
                               note="NVILA-Lite-2B int8 verify, random weights; fake reflect and refine; the "
                               "trained adapters folded into the cond model stand in for lora_path",
                               preset="flux.1_dev_nvilascore.json", impl=pa.attn_impl, out_dir=out_dir)

        # (d) the int8 verifier against the bf16 model on the round's candidates
        images = [load_image(p) for p in sorted(glob.glob(os.path.join(out_dir, "00000", "midimg", "*.png")))]
        prompts = [rows[0]["prompt"]] * len(images)
        ref = bf16.cuda()
        ids = [verifier.yes_id, verifier.no_id]
        lq = m.first_token_logits(images, prompts)
        lb = ref.first_token_logits(images, prompts)
        err = float(abs(lq[:, ids] - lb[:, ids]).max())
        log(f"NVILA int8 vs bf16 on the round's {len(images)} images: yes/no logits {lq[:, ids].round(4).tolist()} "
            f"against {lb[:, ids].round(4).tolist()}, max |diff| {err:.4f} (limit {NVILA_INT8_TOL}); logit std "
            f"{float(lb.std()):.3f}")
        check(all(map(math.isfinite, lq[:, ids].ravel())) and err <= NVILA_INT8_TOL,
              f"NVILA int8 logits differ from bf16 by {err}")

        # (f) the score pass at NVILA_TIMED_B, int8 and bf16 in turns: host preprocess, tower + projector,
        # the whole forward
        batch_imgs, batch_prompts = images[:NVILA_TIMED_B], prompts[:NVILA_TIMED_B]
        n_img = math.ceil(vis_cfg.image_size // vis_cfg.patch_size / ncfg.downsample) ** 2
        fns, tokens = {}, {}
        with torch.no_grad():
            for name, model in (("int8", m), ("bf16", ref)):
                args = model.batch(batch_imgs, batch_prompts)
                tokens[name] = int(args[1].shape[1] + args[3].shape[1]) + n_img
                fns[name, "tower"] = lambda model=model, args=args: model.mm_projector(siglip_apply(
                    model.vision_tower, args[0], model.cfg.select_layer))
                fns[name, "total"] = lambda model=model, args=args: nvila_logits(model, *args)
                fns[name, "prep"] = lambda model=model: model.batch(batch_imgs, batch_prompts)
            ms = _turns_ms(torch, fns, NVILA_TIMED_REPS)
        timings = {}
        for name in ("int8", "bf16"):
            med = {part: statistics.median(ms[name, part]) / NVILA_TIMED_B for part in ("tower", "total", "prep")}
            timings[name] = {"per_image_ms": med["total"], "tower_ms": med["tower"], "lm_ms": med["total"] - med["tower"],
                             "preprocess_ms": med["prep"], "tokens": tokens[name],
                             "per_image_ms_reps": [t / NVILA_TIMED_B for t in ms[name, "total"]]}
            log(f"NVILA score pass {name} (B={NVILA_TIMED_B}, {tokens[name]} positions; median of {NVILA_TIMED_REPS} "
                f"in turns with the other): {med['total']:.2f} ms an image (reps {min(ms[name, 'total']) / NVILA_TIMED_B:.2f}"
                f"-{max(ms[name, 'total']) / NVILA_TIMED_B:.2f}) = tower + projector {med['tower']:.2f} + LM "
                f"{med['total'] - med['tower']:.2f}; host preprocess {med['prep']:.2f} ms an image")
        ref.cpu()

        # (e) the post-hoc filter CLI over the round's candidates
        cfg_path, meta_path = os.path.join(root, "preset.json"), os.path.join(root, "meta.jsonl")
        with open(preset) as f:
            raw = json.load(f)
        raw["verifier_args"]["model_path"] = bundle
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        with open(meta_path, "w") as f:
            f.write(json.dumps(rows[0]) + "\n")
        nfe_dir = os.path.join(root, "nfe")
        t_f = time.perf_counter()
        verifier_filter.main(["--pipeline_config_path", cfg_path, "--meta_path", meta_path, "--imgpath", out_dir,
                              "--output_dir", nfe_dir, "--nfes", "1", "2", "--device", "cuda"])
        t_f = time.perf_counter() - t_f
        picked = sorted(os.path.relpath(p, nfe_dir) for p in glob.glob(os.path.join(nfe_dir, "*", "*.png")))
        check(picked == ["nfe1/00000.png", "nfe2/00000.png"], f"verifier_filter wrote {picked}")
        log(f"verifier_filter --nfes 1 2 (preset, int8 NVILA loaded by the CLI): {picked} in {t_f:.1f} s")
        peak = max(res["peak_gib"], torch.cuda.max_memory_allocated() / 2**30)
        del verifier, m, bf16, ref, fns
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out = {"start_gib": start_gib, "k1_preset": k1, "bundle_gib": gib, "write_s": t_write, "load_s": t_load, "build_verifier_s": t_build,
           "int8_gib": int8_gib, "round": res, "int8_vs_bf16_max_abs": err, "logits_int8": lq[:, ids].tolist(),
           "logits_bf16": lb[:, ids].tolist(), "timings": timings, "filter_s": t_f, "filter_wrote": picked,
           "peak_gib": peak, "phase_s": time.perf_counter() - t0}
    log(f"NVILA phase (11): {out['phase_s']:.1f} s; int8 verifier {int8_gib:.2f} GiB resident; peak device memory "
        f"{peak:.2f} GiB")
    return out


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def nf4_counts(pipe) -> dict:
    """K1–K5 launches per t2i forward of the `_v5e_co` DiT (NF4 MLPs, W8A8
    attention and modulation panels) under "pallas", from `dit.py`'s gates:
    K1 once a block; K2 on each stream's q and k; K3 before the fused W8A8
    qkv panels (two a double block) and `in_proj`; K5 before the double
    blocks' two out-projections; none before an NF4 linear (fc1, fc2,
    `out_mlp`) and none for the single blocks' `out_attn`, which the unfused
    output path multiplies by itself, as JAX's `_single_out` does; no K4."""
    nd, ns = pipe.dit_cfg.num_double_blocks, pipe.dit_cfg.num_single_blocks
    return {"flash_fwd": nd + ns, "norm_rope": 4 * nd + 2 * ns, "adaln_quant": 2 * nd + ns, "rowquant": 2 * nd}


def vcache_phase(torch, pipe):
    """Phase 12: the velocity cache and the NF4 serving profile on the W8A8
    pipeline ("pallas", 1024 px, 1 prompt x 2 candidates): (1) interval 1 is
    bitwise the dense loop; (2) the static schedule at VC_STEPS steps (12 full
    forwards) launches K1–K5 12 times a forward's counts, agrees with the plain
    serving path (cosine >= W8A8_COS) and is timed against the dense denoise in
    turns; (3) the teacache preset's schedule at STEPS steps launches n_full
    forwards' worth and nothing on skip steps, then the preset's round (fake
    verify, reflect and refine); (4) module mode at interval 3 launches only
    on full steps, agrees with the plain path and prints its peak memory; (5)
    the `_v5e_co` profile from a fresh seeded bf16 pipeline at full width and
    depth: exact K1/K2/K3/K5 counts at VC_NF4_STEPS steps, resident bytes,
    s/step against W8A8 in turns, an NF4 linear of each packing against fp64
    on its decoded weight, and the NF4 T5 encode's cosine against bf16
    (printed: through 24 random layers the rounding grows, so it is no
    check)."""
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
    from reflectionflow_tpu_torch.ops.quant import NF4Linear, QuantLinear, int4_matmul, int4_matmul_plane
    from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule, make_step_mask, vcache_kwargs
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    t_phase = time.perf_counter()
    pipe.attn_impl, pipe.vcache = "pallas", None
    nd, ns = pipe.dit_cfg.num_double_blocks, pipe.dit_cfg.num_single_blocks
    per_forward = round_counts(pipe, "pallas")[0]
    prompt = round_rows()[0]["prompt"]
    txt, pooled = pipe.encode_prompts([prompt] * BRANCH, LT)
    gen = torch.Generator(device="cuda").manual_seed(12)
    lat0 = torch.randn((BRANCH, LI, pipe.dit_cfg.in_channels), generator=gen, device="cuda").to(torch.bfloat16)
    side = math.isqrt(LI)
    ids = (torch.from_numpy(make_image_ids(side, side)).cuda(), torch.from_numpy(make_text_ids(LT)).cuda())

    def run(steps, kw, impl="pallas", dit=None, text=(txt, pooled)):
        """-> (final latents, n_full, launches, seconds) of one denoise, every
        launch count set to 0 just before and read just after."""
        counters = zero_counts()
        (lat, n_full), secs = _timed(torch, lambda: denoise(
            pipe.dit if dit is None else dit, lat0, *text, *ids, make_schedule(steps, LI), 3.5, steps, attn_impl=impl,
            rope_layout="split", return_vcache_stats=True, **kw))
        return lat, n_full, {k: fn.launches for k, fn in counters.items()}, secs

    def want(n_full, counts=per_forward):
        return {k: n_full * counts.get(k, 0) for k in _counters()}

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(), dim=0).item()

    out = {}
    # (1) every step full through the cached path: bitwise the dense loop
    dense8, n8, l_dense, _ = run(STEPS, {})
    every8, n_every, l_every, _ = run(STEPS, vcache_kwargs({"interval": 1}, STEPS))
    check(n8 == n_every == STEPS and l_dense == l_every == want(STEPS) and torch.equal(dense8, every8),
          "vcache interval 1 is not bitwise the dense loop")
    log(f"vcache interval 1 ({STEPS} steps, B={BRANCH}): bitwise the dense latents; launches {l_every}")
    out["interval1_bitwise"] = True

    # (2) the static schedule at VC_STEPS steps, timed in turns with the dense denoise
    kw = vcache_kwargs(VC_STATIC, VC_STEPS)
    n_mask = int(make_step_mask(VC_STEPS, VC_STATIC["interval"], VC_STATIC["warmup"], VC_STATIC["tail"]).sum())
    _, _, _, t_d1 = run(VC_STEPS, {})
    cached, n_full, launches, t_c1 = run(VC_STEPS, kw)
    _, _, _, t_c2 = run(VC_STEPS, kw)
    _, _, _, t_d2 = run(VC_STEPS, {})
    plain, n_plain, l_plain, _ = run(VC_STEPS, kw, impl="xla")
    cos = cosine(cached, plain)
    log(f"vcache static {VC_STATIC} at {VC_STEPS} steps: n_full {n_full} (mask {n_mask}), launches {launches}; "
        f"cosine against the plain serving path {cos:.6f} (min {W8A8_COS}); denoise dense {t_d1:.3f} / "
        f"{t_d2:.3f} s, cached {t_c1:.3f} / {t_c2:.3f} s (in turns): speedup "
        f"{(t_d1 + t_d2) / (t_c1 + t_c2):.3f}x (forward ratio {VC_STEPS / n_mask:.3f})")
    check(n_full == n_plain == n_mask == 12 and launches == want(n_full) and sum(l_plain.values()) == 0,
          "the static schedule did not run K1–K5 on exactly its full steps")
    check(bool(torch.isfinite(cached).all()) and cos >= W8A8_COS,
          "the static schedule disagrees with the plain serving path")
    out["static"] = {"vcache": VC_STATIC, "steps": VC_STEPS, "n_full": n_full, "launches": launches,
                     "cosine_plain": cos, "dense_s": [t_d1, t_d2], "cached_s": [t_c1, t_c2],
                     "speedup": (t_d1 + t_d2) / (t_c1 + t_c2)}

    # (3) the teacache preset's schedule, then its round
    preset = "flux.1_dev_qwenscore_v5e_teacache.json"
    pa = TTSConfig.load(os.path.join(REPO, "configs", preset)).pipeline_args
    check(pa.vcache.get("residual") and pa.vcache.get("poly") and pa.attn_impl == "pallas"
          and pa.quantize == "int8", f"{preset} no longer asks for the TeaCache residual schedule under W8A8 pallas")
    tea, n_tea, l_tea, t_tea = run(STEPS, vcache_kwargs(pa.vcache, STEPS))
    log(f"vcache teacache preset {pa.vcache} at {STEPS} steps (B={BRANCH}): n_full {n_tea} (random weights: "
        f"not predicted), launches {l_tea}, denoise {t_tea:.3f} s")
    check(bool(torch.isfinite(tea).all()) and 2 <= n_tea <= STEPS and l_tea == want(n_tea),
          "the teacache schedule's launches are not n_full forwards' worth (a skip step launched K1–K5)")
    round_res = reflection_phase(torch, pipe, label="reflection round (teacache preset)",
                                 note="the teacache preset's residual schedule; fake verify/reflect/refine",
                                 preset=preset, impl="pallas")
    out["teacache"] = {"vcache": pa.vcache, "steps": STEPS, "n_full": n_tea, "launches": l_tea,
                       "denoise_s": t_tea, "round": round_res}

    # (4) module mode (TaylorSeer per-module forecast) at interval 3
    kw = vcache_kwargs({"interval": 3, "module": True}, STEPS)
    n_mod_mask = int(kw["step_mask"].sum())
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mod, n_mod, l_mod, t_mod = run(STEPS, kw)
    peak = torch.cuda.max_memory_allocated()
    mod_plain, _, _, _ = run(STEPS, kw, impl="xla")
    cos_mod = cosine(mod, mod_plain)
    snap_gb = BRANCH * (nd * 2 * (LI + LT) + ns * (LT + LI)) * H * 2 / 1e9
    log(f"vcache module mode (interval 3) at {STEPS} steps: n_full {n_mod}, launches {l_mod}, denoise "
        f"{t_mod:.3f} s; cosine against the plain serving path {cos_mod:.6f}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 1e9:.2f} GB above the {base / 2**30:.2f} GiB resident), "
        f"one B={BRANCH} module snapshot {snap_gb:.2f} GB bf16 (the port holds up to 3)")
    check(n_mod == n_mod_mask and l_mod == want(n_mod) and bool(torch.isfinite(mod).all()) and cos_mod >= W8A8_COS,
          "module mode launched on a skip step or disagrees with the plain serving path")
    out["module"] = {"n_full": n_mod, "launches": l_mod, "denoise_s": t_mod, "cosine_plain": cos_mod,
                     "peak_gib": peak / 2**30, "above_resident_gb": (peak - base) / 1e9,
                     "snapshot_gb": snap_gb}
    del dense8, every8, cached, plain, tea, mod, mod_plain
    torch.cuda.empty_cache()

    # (5) the `_v5e_co` profile from a fresh seeded bf16 pipeline at full size
    t0 = time.perf_counter()
    co = FluxPipeline.random_init(torch.Generator(device="cuda").manual_seed(13), pipe.dit_cfg, pipe.vae_cfg,
                                  pipe.t5_cfg, pipe.clip_cfg, dtype=torch.bfloat16)
    co.attn_impl = "pallas"
    t5_bf16, _ = co.encode_prompts([prompt] * BRANCH, LT)
    co.quantize(int4=("t5",), dit_int4_mlp=True)  # the CLI's int8 profile with dit_quant int8_int4mlp
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    co_txt, co_pooled = co.encode_prompts([prompt] * BRANCH, LT)
    t5_cos = cosine(co_txt, t5_bf16)
    kinds = {}
    for name, model in (("dit", co.dit), ("t5", co.t5)):
        nf4 = [m for m in model.modules() if isinstance(m, NF4Linear)]
        i8 = [m for m in model.modules() if isinstance(m, QuantLinear)]
        kinds[name] = {"nf4": len(nf4), "int8": len(i8),
                       "gib": sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
                       / 2**30}
    check(kinds["dit"]["nf4"] == 4 * nd + ns and kinds["t5"]["nf4"] == 7 * co.t5_cfg.num_layers,
          f"the _v5e_co profile's NF4 layers {kinds}")
    nf4_lat, n_nf4, l_nf4, _ = run(VC_NF4_STEPS, {}, dit=co.dit, text=(co_txt, co_pooled))
    check(n_nf4 == VC_NF4_STEPS and l_nf4 == want(VC_NF4_STEPS, nf4_counts(co)) and bool(torch.isfinite(nf4_lat).all()),
          f"the NF4 profile's launches {l_nf4} are not {want(VC_NF4_STEPS, nf4_counts(co))}")
    images = co.generate([prompt] * BRANCH, height=2 * LT, width=2 * LT, num_inference_steps=VC_NF4_STEPS, seed=0)
    check(images.shape == (BRANCH, 2 * LT, 2 * LT, 3), f"NF4 generate images {images.shape}")
    ms = _turns_ms(torch, {"w8a8": lambda: run(VC_NF4_STEPS, {}), "nf4": lambda: run(
        VC_NF4_STEPS, {}, dit=co.dit, text=(co_txt, co_pooled))}, 2)
    step_s = {k: statistics.mean(v) / 1e3 / VC_NF4_STEPS for k, v in ms.items()}
    log(f"NF4 _v5e_co profile (full width and depth; built and quantized in {t_build:.1f} s): DiT "
        f"{kinds['dit']['nf4']} NF4 + {kinds['dit']['int8']} int8 linears, {kinds['dit']['gib']:.2f} GiB; T5 "
        f"{kinds['t5']['nf4']} NF4 + {kinds['t5']['int8']} int8, {kinds['t5']['gib']:.2f} GiB; launches at "
        f"{VC_NF4_STEPS} steps {l_nf4}; s/step at B={BRANCH} NF4 {step_s['nf4']:.4f} against W8A8 "
        f"{step_s['w8a8']:.4f} (in turns, {ms}); T5 NF4 encode cosine against bf16 {t5_cos:.6f}")
    # each NF4 packing's product on the card against fp64 on the decoded weight
    errs = {}
    for name, lin in (("dit fc1", co.dit.transformer_blocks[0].ff.net[0].proj), ("t5 wo", co.t5.encoder.block[0]
                                                                               .layer[1].DenseReluDense.wo)):
        x = torch.randn((BRANCH * LT, lin.in_features), generator=gen, device="cuda").to(torch.bfloat16)
        mm = int4_matmul_plane if lin.layout == "plane" else int4_matmul
        ref = mm(x.double(), lin.w_packed, lin.w_scale4)
        ref = ref if lin.bias is None else ref + lin.bias.double()
        with torch.no_grad():
            errs[name] = ((lin(x).double() - ref).abs().max() / ref.abs().max()).item()
    log(f"NF4 linears on the card against fp64 on their decoded weights: max |err| / max |ref| {errs} "
        f"(limit {NF4_REL_TOL})")
    check(math.isfinite(t5_cos) and all(e <= NF4_REL_TOL for e in errs.values()),
          f"an NF4 linear disagrees with its decoded weight: {errs}")
    out["nf4"] = {"depth": "full", "build_s": t_build, "kinds": kinds, "launches": l_nf4, "steps": VC_NF4_STEPS,
                  "s_per_step": step_s, "ms": ms, "t5_cosine": t5_cos, "linear_rel_err": errs}
    del co, nf4_lat
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"vcache and NF4 phase (12): {out['phase_s']:.1f} s")
    return out


def _module_bytes(module) -> int:
    return sum(t.numel() * t.element_size() for t in [*module.parameters(), *module.buffers()])


def _rm_trainable(torch, model, seed: int, device) -> dict:
    """Fresh reward-model trainables from `seed`, as the train_reward CLI draws
    them: LM adapters from the seed's key, rm_head, the special row and the
    tower adapters from its fold_in 1, 2 and 3."""
    from reflectionflow_tpu_torch.rm_train import train as rt
    from reflectionflow_tpu_torch.utils import threefry

    key, H = threefry.prng_key(seed), model.lm_cfg.hidden_size
    return {"lora": rt.rm_lora_init(key, model.model, RM_LORA_R, RM_LORA_ALPHA)["adapters"],
            "rm_head": threefry.normal(threefry.fold_in(key, 1), (H, 1), device=device) * 0.02,
            "special": threefry.normal(threefry.fold_in(key, 2), (H,), device=device) * 0.02,
            "vision_lora": rt.rm_vision_lora_init(threefry.fold_in(key, 3), model.visual, RM_LORA_R,
                                                  RM_LORA_ALPHA)["adapters"]}


def rm_train_phase(torch, card: str) -> dict:
    """Phase 13: the reward-model trainer on Qwen2.5-VL-7B (full width and
    depth, seeded random bf16, no lm_head): LoRA on the LM and the tower over
    a weight-only int8 base, RM_STEPS steps on one collated batch of
    RM_PAIRS synthetic GSB pairs (RM_PX px PNG files); the checkpoint round
    trip; a `QwenRewardVerifier` over the same seeded base from that
    checkpoint; RM_NF4_STEPS steps on an NF4 base. No step may launch K1–K9."""
    import gc

    import numpy as np

    from reflectionflow_tpu_torch.lora.lora import qwen_adapters_to_jax
    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel
    from reflectionflow_tpu_torch.ops.quant import NF4Linear, QuantLinear
    from reflectionflow_tpu_torch.rm_train import train as rt
    from reflectionflow_tpu_torch.rm_train.data import collate_rm_batch, vision_train_geometry
    from reflectionflow_tpu_torch.rm_train.losses import reward_loss
    from reflectionflow_tpu_torch.search.artifacts import load_image, save_image
    from reflectionflow_tpu_torch.train import optim
    from reflectionflow_tpu_torch.verifiers.qwen_verifier import QwenRewardVerifier

    t_phase = time.perf_counter()
    start_gib = torch.cuda.memory_allocated() / 2**30
    lm_cfg, vis_cfg = _qwen_cfgs()
    sp = lm_cfg.vocab_size - 1  # the CLI's <|VQ_reward|> id
    side, grid = vision_train_geometry(vis_cfg, RM_PX * RM_PX)
    check(side == RM_PX and grid == (1, 32, 32), f"vision-training geometry {side}, {grid}")

    def base():
        gen = torch.Generator(device="cuda").manual_seed(RM_SEED)
        model = QwenVLModel.random_init(gen, lm_cfg, vis_cfg, dtype=torch.bfloat16, device="cuda")
        model.lm_head = None  # the reward model reads hidden states, never logits
        return model

    def fresh_trainable(model, seed):
        return _rm_trainable(torch, model, seed, "cuda")

    def make_step(model, mode):
        opt = rt.make_rm_optimizer(lr=RM_LR)
        step = rt.make_rm_train_step(model.model, opt, loss_type="btt", pooling="special", special_token_id=sp,
                                     alpha=RM_LORA_ALPHA, r=RM_LORA_R, tower=model.visual, grid_thw=grid,
                                     quantize_base=mode)
        blocks = [*model.model.layers, *model.visual.blocks]
        left = [type(m).__name__ for b in blocks for m in b.modules() if isinstance(m, torch.nn.Linear)]
        check(not left, f"{len(left)} block linears left float under quantize_base={mode}")
        w8a8 = [m for b in blocks for m in b.modules() if isinstance(m, QuantLinear) and m.act_quant]
        check(not w8a8, f"{len(w8a8)} block linears quantize their activation (W8A8) in the training base")
        kinds = {}
        for b in blocks:
            for m in b.modules():
                if isinstance(m, (QuantLinear, NF4Linear)):
                    k = f"nf4_{m.layout}" if isinstance(m, NF4Linear) else "int8_w8a16"
                    kinds[k] = kinds.get(k, 0) + 1
        nbytes = {"lm_blocks": _module_bytes(model.model.layers), "embed": _module_bytes(model.model.embed_tokens),
                  "tower": _module_bytes(model.visual), "total": _module_bytes(model)}
        return opt, step, kinds, nbytes

    def timed_steps(step, trainable, state, batch, n):
        counters = zero_counts()
        losses, secs = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainable, state, aux = step(trainable, state, batch)
            losses.append(float(aux["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in counters.items()}
        check(not any(launches.values()), f"reward-model training launched kernels of the DiT path: {launches}")
        check(all(math.isfinite(x) for x in losses), f"reward-model losses {losses}")
        return trainable, state, losses, secs, launches

    tmp = tempfile.mkdtemp(prefix="rm_train_")
    rng = np.random.default_rng(RM_SEED)
    rows = []
    for i in range(RM_PAIRS):
        row = {"prompt": f"a photo of {i + 2} red cubes on a wooden table", "gsb": "GB"[i % 2],
               "score_A": 4.0 - i, "score_B": 2.0 + i}
        for s in "AB":
            row[f"image_{s}"] = os.path.join(tmp, f"{s}{i}.png")
            save_image(row[f"image_{s}"], rng.integers(0, 256, (RM_PX, RM_PX, 3), dtype=np.uint8))
        rows.append(row)

    t0 = time.perf_counter()
    model = base()
    trainable = fresh_trainable(model, RM_SEED + 1)
    n_adapter = {g: sum(t.numel() for ab in trainable[g].values() for t in ab.values())
                 for g in ("lora", "vision_lora")}
    batch = collate_rm_batch(model, rows, max_pixels=RM_PX * RM_PX, special_token_id=sp, train_vision=True)
    opt, step, kinds, base_bytes = make_step(model, "int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = batch["ids_A"].shape[1]
    log(f"reward model: Qwen2.5-VL-7B int8 base {base_bytes['total'] / 2**30:.2f} GiB (LM blocks "
        f"{base_bytes['lm_blocks'] / 2**30:.2f}, embeddings {base_bytes['embed'] / 2**30:.2f}, tower "
        f"{base_bytes['tower'] / 2**30:.2f}); {kinds}; adapters {n_adapter} (r={RM_LORA_R}); batch "
        f"{RM_PAIRS} pairs x {L} tokens a side; built in {build_s:.1f} s; {card}")

    def fixed_loss():
        with torch.no_grad():
            rw = []
            for s in "AB":
                emb = rt.apply_vision_lora_embeds(trainable, model.visual, batch[f"embeds_{s}"], batch[f"patches_{s}"],
                                                  grid, RM_LORA_ALPHA, RM_LORA_R)
                rw.append(rt.rm_forward_rewards(trainable, model.model, emb, batch[f"pos_{s}"], batch[f"mask_{s}"],
                                                batch[f"ids_{s}"], "special", sp, RM_LORA_ALPHA, RM_LORA_R))
            return float(reward_loss(rw[0].float(), rw[1].float(), batch["scores_A"], batch["scores_B"],
                                     batch["chosen_label"], "btt"))

    before = {k: v.detach().clone() for k, v in optim.flatten_tree(trainable).items()}
    state = opt.init(trainable)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainable, state, losses, secs, launches = timed_steps(step, trainable, state, batch, RM_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = fixed_loss()
    check(after < losses[0], f"the loss on the fixed batch did not fall: {losses} then {after}")
    moved = {}
    for group in ("lora/", "vision_lora/", "rm_head", "special"):
        moved[group.rstrip("/")] = max(float((v.detach() - before[k]).abs().max())
                                       for k, v in optim.flatten_tree(trainable).items() if k.startswith(group))
    check(all(m > 0 for m in moved.values()), f"a trainable group did not move: {moved}")
    s_per_step = secs[1:]
    log(f"reward-model int8 steps: losses {[round(x, 5) for x in losses]} then {after:.5f} on the same batch; "
        f"s/step {[round(x, 4) for x in secs]} (steps 2-{RM_STEPS}: {statistics.mean(s_per_step):.4f}); peak "
        f"{peak:.2f} GiB ({peak - start_gib:.2f} above the phase's start); K1-K9 launches 0; {card}")

    wall = []

    def one_step():  # one more step, under the profiler: device kernels by family, host ops by self time
        nonlocal trainable, state
        t0 = time.perf_counter()
        trainable, state, _ = step(trainable, state, batch)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    events = profile_events(torch, one_step)
    device = [(e.key, getattr(e, "self_device_time_total", 0.0)) for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, "self_device_time_total", 0.0) > 0]
    profile = log_split(f"reward-model int8 step profile (B={RM_PAIRS} pairs, {card})", device, wall[0])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda t: -t[1])[:10]
    profile["host_top_ms"] = {k: [round(ms, 2), n] for k, ms, n in host}
    log(f"  host ops by self time (ms, calls): {profile['host_top_ms']}")

    ckpt = os.path.join(tmp, "checkpoint")
    t0 = time.perf_counter()
    rt.save_rm_checkpoint(ckpt, trainable, "special", sp, lora_alpha=RM_LORA_ALPHA, lora_r=RM_LORA_R)
    back, cfg = rt.load_rm_checkpoint(ckpt)
    ckpt_s = time.perf_counter() - t0
    want = {"lora": qwen_adapters_to_jax(trainable["lora"]),
            "vision_lora": qwen_adapters_to_jax(trainable["vision_lora"], tower=True),
            "rm_head": trainable["rm_head"].detach().float().cpu(), "special": trainable["special"].detach().float().cpu()}
    check(set(back) == set(want) and all(set(back[g]) == set(want[g]) for g in ("lora", "vision_lora")),
          f"checkpoint groups {sorted(back)}")
    for g in ("lora", "vision_lora"):
        for p, ab in want[g].items():
            check(all(torch.equal(back[g][p][k], ab[k]) for k in ("A", "B")), f"checkpoint {g} {p} differs")
    check(torch.equal(back["rm_head"], want["rm_head"]) and torch.equal(back["special"], want["special"]),
          "checkpoint head or special row differs")
    check(cfg["special_token_id"] == sp and cfg["lora_r"] == RM_LORA_R, f"model_config {cfg}")
    ckpt_mb = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 2**20

    del step, opt, state, trainable, before, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    model = base()
    verifier = QwenRewardVerifier(model=model, model_path=ckpt)
    pair = [load_image(rows[0]["image_A"]), load_image(rows[0]["image_B"])]
    scores = verifier.raw_scores(pair, [rows[0]["prompt"]] * 2)
    check(all(math.isfinite(x) for x in scores) and scores[0] != scores[1], f"verifier scores {scores}")
    log(f"checkpoint ({ckpt_mb:.1f} MiB) written and read back bitwise in {ckpt_s:.1f} s; QwenRewardVerifier "
        f"from it over the same seeded base: raw scores {scores}")
    del verifier
    gc.collect()

    trainable = fresh_trainable(model, RM_SEED + 2)
    batch = collate_rm_batch(model, rows, max_pixels=RM_PX * RM_PX, special_token_id=sp, train_vision=True)
    opt, step, nf4_kinds, nf4_bytes = make_step(model, "nf4")
    state = opt.init(trainable)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainable, state, nf4_losses, nf4_secs, nf4_launches = timed_steps(step, trainable, state, batch, RM_NF4_STEPS)
    nf4_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"reward-model NF4 base {nf4_bytes['total'] / 2**30:.2f} GiB (LM blocks "
        f"{nf4_bytes['lm_blocks'] / 2**30:.2f}, tower {nf4_bytes['tower'] / 2**30:.2f}); {nf4_kinds}; "
        f"losses {nf4_losses}; s/step {[round(x, 4) for x in nf4_secs]} (int8 {statistics.mean(s_per_step):.4f}); "
        f"peak {nf4_peak:.2f} GiB; K1-K9 launches 0; {card}")
    del step, opt, state, trainable, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "start_gib": start_gib, "batch_pairs": RM_PAIRS, "tokens_per_side": L, "px": RM_PX,
           "lora_r": RM_LORA_R, "lora_alpha": RM_LORA_ALPHA, "lr": RM_LR, "adapter_params": n_adapter,
           "int8": {"losses": losses, "loss_after": after, "s_per_step_all": secs,
                    "s_per_step": statistics.mean(s_per_step), "peak_gib": peak, "base_bytes": base_bytes,
                    "kinds": kinds, "moved": moved, "launches": launches, "profile": profile},
           "nf4": {"losses": nf4_losses, "s_per_step_all": nf4_secs, "s_per_step": nf4_secs[-1],
                   "peak_gib": nf4_peak, "base_bytes": nf4_bytes, "kinds": nf4_kinds, "launches": nf4_launches},
           "checkpoint_mib": ckpt_mb, "checkpoint_s": ckpt_s, "verifier_raw_scores": scores,
           "phase_s": time.perf_counter() - t_phase}
    log(f"reward-model training phase (13): {out['phase_s']:.1f} s")
    return out


# -- phase 14: serving over a mesh of ranks ----------------------------------


def _mesh_ctx():
    import torch
    import torch.distributed as dist

    from reflectionflow_tpu_torch.parallel import collectives

    return torch, dist, collectives


def _mesh_prompts(n: int) -> list[str]:
    """n prompts of configs/geneval_sample.jsonl, each BRANCH times."""
    with open(os.path.join(REPO, "configs", "geneval_sample.jsonl")) as f:
        rows = [json.loads(line)["prompt"] for line in f if line.strip()][:n]
    return [p for p in rows for _ in range(BRANCH)]


def _mesh_build(device, mesh, quantize: bool, setup=None, first=None):
    """The full-width FLUX.1-dev pipeline of random bf16 weights from seed 0 on
    every rank, built one rank at a time, each rank down to its serving size
    before the next builds (two bf16 pipelines at once, 2 x 34 GB, would not
    fit beside a third rank's): W8A8 after `quantize` (the CLI's int8
    profile), then `setup(pipe)`, on rank 0 `first(pipe)` (the one-rank
    reference), then `pipe.set_mesh(mesh)` (the TP cut). Weights are not
    broadcast: every rank draws the same seed on the same card
    (`mesh_weight_check` holds them equal)."""
    torch, dist, _ = _mesh_ctx()
    from reflectionflow_tpu_torch.sampler.pipeline import FluxPipeline

    pipe, ref, build_s = None, None, 0.0
    for turn in range(dist.get_world_size()):
        if dist.get_rank() == turn:
            t0 = time.perf_counter()
            pipe = FluxPipeline.random_init(torch.Generator(device=device).manual_seed(0),
                                            dtype=torch.bfloat16, device=device)
            if quantize:
                pipe.quantize(int4=(), weight_only=("t5",))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if setup is not None:
                setup(pipe)
            if turn == 0 and first is not None:
                ref = first(pipe)
            pipe.set_mesh(mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return pipe, ref, build_s


def mesh_weight_check(pipe) -> None:
    """Every rank holds rank 0's weights: a checksum of each model (the DiT's
    whole modules only) gathered and compared."""
    torch, dist, _ = _mesh_ctx()
    from reflectionflow_tpu_torch.parallel.specs import dit_param_spec

    sums = []
    for name in ("dit", "t5", "clip", "vae"):
        for k, t in getattr(pipe, name).state_dict().items():
            if name != "dit" or dit_param_spec(k) is None:
                sums.append(t.float().sum())
    mine = torch.stack(sums).double().cpu()
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    check(all(torch.equal(every[0], x) for x in every), "phase 14: the ranks' weights differ")


def _timed_call(torch, module, name: str = "all_reduce_sum"):
    """Wrap `module.<name>` (a collective) to add each call's seconds
    (synchronised before and after) to the returned list; returns (list,
    restore)."""
    spent, inner = [], getattr(module, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    return spent, lambda: setattr(module, name, inner)


def _launch_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _spy_k1():
    """Wrap K1's wrapper where `FlashAttention` calls it, to keep a copy of the
    inputs and outputs of its first launch at each (shape, main_len,
    cross_bias). The wrapper counts its launches on the name it is called
    by, the spy while it is in place; `restore` hands that count back.
    Returns (captured, restore)."""
    from reflectionflow_tpu_torch.ops import flash_attention as fa

    seen, inner = {}, fa.flash_attention_fwd

    def spy(q, k, v, main_len=None, cross_bias=0.0):
        out, lse = inner(q, k, v, main_len, cross_bias)
        key = (tuple(q.shape), main_len, cross_bias)
        if key not in seen:
            seen[key] = [t.clone() for t in (q, k, v, out, lse)]
        return out, lse

    def restore():
        inner.launches = spy.launches
        fa.flash_attention_fwd = inner

    spy.launches = inner.launches
    fa.flash_attention_fwd = spy
    return seen, restore


def _k1_against_plain(torch, seen) -> list[dict]:
    """K1's outputs kept by `_spy_k1` against `flash_attention_ref` on the same
    inputs (OUT_TOL, LSE_TOL), one batch row at a time (the plain version's
    fp32 logits of 12 heads at L = 4608 take 1 GB a row)."""
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_ref

    res = []
    with torch.no_grad():
        for (shape, main_len, cb), (q, k, v, out, lse) in seen.items():
            e_out = e_lse = ref_max = 0.0
            for b in range(shape[0]):
                r_out, r_lse = flash_attention_ref(q[b:b + 1].float(), k[b:b + 1].float(),
                                                   v[b:b + 1].float(), main_len, cb)
                e_out = max(e_out, (out[b:b + 1].float() - r_out).abs().max().item())
                e_lse = max(e_lse, (lse[b:b + 1] - r_lse).abs().max().item())
                ref_max = max(ref_max, r_out.abs().max().item())
                del r_out, r_lse
            res.append({"shape": list(shape), "main_len": main_len, "cross_bias": cb,
                        "max_abs_err": e_out, "max_lse_err": e_lse, "ref_max_abs": ref_max})
    seen.clear()
    torch.cuda.empty_cache()
    return res


def _spy_k6():
    """Wrap `flash_attention_bwd` where `FlashAttention.backward` calls it, to
    keep a copy of the inputs and gradients of its first call at each (shape,
    main_len, cross_bias). K6a and K6b launch inside it and count as they
    would without the spy. Returns (captured, restore)."""
    from reflectionflow_tpu_torch.ops import flash_attention as fa

    seen, inner = {}, fa.flash_attention_bwd

    def spy(q, k, v, out, lse, do, main_len=None, cross_bias=0.0):
        grads = inner(q, k, v, out, lse, do, main_len, cross_bias)
        key = (tuple(q.shape), main_len, cross_bias)
        if key not in seen:
            seen[key] = [t.clone() for t in (q, k, v, out, lse, do, *grads)]
        return grads

    fa.flash_attention_bwd = spy
    return seen, lambda: setattr(fa, "flash_attention_bwd", inner)


def _k6_against_plain(torch, seen) -> list[dict]:
    """K6a + K6b's dQ, dK, dV kept by `_spy_k6` against
    `flash_attention_bwd_ref` on the same inputs, one batch row at a time;
    each error is relative to the max |ref| over the rows (K6_REL_TOL)."""
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_bwd_ref

    res = []
    with torch.no_grad():
        for (shape, main_len, cb), (q, k, v, out, lse, do, *got) in seen.items():
            err, ref_max = [0.0] * 3, [0.0] * 3
            for b in range(shape[0]):
                rows = slice(b, b + 1)
                want = flash_attention_bwd_ref(q[rows], k[rows], v[rows], out[rows], lse[rows], do[rows],
                                               main_len, cb)
                for j, (g, w) in enumerate(zip(got, want)):
                    err[j] = max(err[j], (g[rows].float() - w).abs().max().item())
                    ref_max[j] = max(ref_max[j], w.abs().max().item())
                del want
            res.append({"shape": list(shape), "main_len": main_len, "cross_bias": cb,
                        **{f"{n}_max_abs_err": e for n, e in zip(("dq", "dk", "dv"), err)},
                        **{f"{n}_rel": e / m for n, e, m in zip(("dq", "dk", "dv"), err, ref_max)},
                        "finite": all(bool(torch.isfinite(g).all()) for g in got)})
    seen.clear()
    torch.cuda.empty_cache()
    return res


def mesh_tp_rank(device, _td):
    """14a: data 1 x model MESH_WORLD, bf16 "pallas", MESH_TP_B candidate(s) of
    one prompt; then 15c: `quantize` (W8A8 DiT) on the cut model, which keeps the
    unfused layout, and the same generate. Rank 0 makes the one-rank
    references before the cut: the bf16 run, and the W8A8 run of that layout
    on a copy of its DiT."""
    torch, dist, collectives = _mesh_ctx()
    from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh
    from reflectionflow_tpu_torch.parallel.specs import dit_param_spec

    prompts = _mesh_prompts(1)[:MESH_TP_B]
    kw = dict(num_inference_steps=MESH_STEPS, seed=MESH_SEED, output_type="latent")

    def setup(pipe):
        pipe.attn_impl = "pallas"

    def references(pipe):
        bf16 = pipe.generate(prompts, **kw)
        t0 = time.perf_counter()
        unfused = copy.copy(pipe)
        unfused.dit = copy.deepcopy(pipe.dit)
        unfused.quantize(which=("dit",), int4=(), fuse_qkv=False)
        w8a8 = unfused.generate(prompts, **kw)
        del unfused
        torch.cuda.empty_cache()
        return bf16, w8a8, time.perf_counter() - t0

    tp = MESH_WORLD
    pipe, ref, build_s = _mesh_build(device, make_mesh((1, tp), ("data", "model")), quantize=False,
                                     setup=setup, first=references)
    mesh_weight_check(pipe)
    with torch.device("meta"):  # the whole DiT's bytes, from its shapes
        full = {k: t.numel() * pipe.dtype.itemsize for k, t in FluxDiT(pipe.dit_cfg).state_dict().items()}
    want_bytes = sum(b // tp if dit_param_spec(k) is not None else b for k, b in full.items())
    dit_bytes = sum(t.numel() * t.element_size() for t in pipe.dit.state_dict().values())
    check(dit_bytes == want_bytes, f"14a: rank DiT holds {dit_bytes} bytes, its shard {want_bytes}")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.reset_counts()
    spent, restore = _timed_call(torch, collectives)
    k1_seen, restore_k1 = _spy_k1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        final = pipe.generate(prompts, **kw)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_k1()
    wall = time.perf_counter() - t0
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "launches": _launch_counts(),
           "collectives": dict(collectives.COUNTS), "dit_bytes": dit_bytes, "dit_bytes_full": sum(full.values()),
           "generate_s": wall, "s_per_step": wall / MESH_STEPS, "all_reduce_s": sum(spent),
           "all_reduce_share": sum(spent) / wall, "build_s": build_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "finite": bool(torch.isfinite(final).all()), "k1_vs_plain": _k1_against_plain(torch, k1_seen)}
    if ref is not None:
        out["cosine"] = _cosine(final, ref[0])
    del final

    # 15c: W8A8 under the model axis, on the cut DiT
    t_q = time.perf_counter()
    pipe.quantize(which=("dit",), int4=())
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t_q
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    final = pipe.generate(prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    q = {"launches": _launch_counts(), "collectives": dict(collectives.COUNTS), "rope_layout": pipe.rope_layout,
         "quantize_s": quantize_s, "generate_s": wall, "s_per_step": wall / MESH_STEPS,
         "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "finite": bool(torch.isfinite(final).all()),
         "dit_bytes": sum(t.numel() * t.element_size() for t in (*pipe.dit.parameters(), *pipe.dit.buffers())),
         "phase_s": time.perf_counter() - t_q}
    if ref is not None:
        q["cosine"] = _cosine(final, ref[1])
        q["reference_s"] = ref[2]
    out["w8a8"] = q
    return out


def mesh_dp_rank(device, _td):
    """14b: data MESH_WORLD, W8A8 "pallas", 2 prompts x BRANCH (one prompt a rank)."""
    torch, dist, collectives = _mesh_ctx()
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh

    prompts = _mesh_prompts(N_PROMPTS)
    kw = dict(num_inference_steps=MESH_STEPS, seed=MESH_SEED, output_type="latent")

    def setup(pipe):
        pipe.attn_impl = "pallas"

    def reference(pipe):
        lat = pipe.generate(prompts, **kw)
        return lat, pipe.decode_latents(lat, 1024, 1024)

    pipe, ref, build_s = _mesh_build(device, make_mesh((MESH_WORLD,), ("data",)), quantize=True,
                                     setup=setup, first=reference)
    mesh_weight_check(pipe)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = pipe.generate(prompts, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rank": dist.get_rank(), "launches": _launch_counts(), "collectives": dict(collectives.COUNTS),
           "generate_s": wall, "s_per_step": wall / MESH_STEPS, "build_s": build_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "shape": list(final.shape),
           "finite": bool(torch.isfinite(final).all())}
    if ref is not None:
        images = pipe.decode_latents(final, 1024, 1024)
        out["cosine"] = _cosine(final, ref[0])
        out["uint8_max_diff"] = int(abs(images.astype(int) - ref[1].astype(int)).max())
    return out


def mesh_round_rank(device, td):
    """14d: `run_reflectionflow_block` at data MESH_WORLD under W8A8 "pallas_nr"
    with the fake models of configs/flux.1_dev_fake.json (1 prompt, round 0 +
    1 round, MESH_STEPS steps): first on rank 0 alone, one data slice a
    generate call, then on both ranks; rank 0 holds the trees against each
    other (the same files, byte for byte)."""
    torch, dist, collectives = _mesh_ctx()
    from reflectionflow_tpu_torch.config import TTSConfig
    from reflectionflow_tpu_torch.parallel.dryrun import compare_trees
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh
    from reflectionflow_tpu_torch.reflect import FakeReflector, FakeRefiner
    from reflectionflow_tpu_torch.search.reflectionflow import run_reflectionflow_block
    from reflectionflow_tpu_torch.verifiers import FakeVerifier

    cfg = TTSConfig.load(os.path.join(REPO, "configs", "flux.1_dev_fake.json"))
    cfg.search_args.search_rounds, cfg.pipeline_args.num_inference_steps = 1, MESH_STEPS
    base_cfg = TTSConfig.load(os.path.join(REPO, "configs", "flux.1_dev_fake.json"))
    base_cfg.search_args.search_rounds, base_cfg.pipeline_args.num_inference_steps = 1, MESH_STEPS
    base_cfg.batch_size_for_img_gen = cfg.batch_size_for_img_gen // MESH_WORLD
    rows = round_rows()
    models = lambda: (FakeVerifier(), FakeReflector(), FakeRefiner())  # noqa: E731

    def setup(pipe):
        # the cond stream reads the DiT itself (no second W8A8 model beside it on the shared card)
        pipe.cond_dit_params = pipe.dit
        pipe.attn_impl = "pallas_nr"
        pipe.model_flags = {"union_cond_attn": cfg.model.union_cond_attn,
                            "add_cond_attn": cfg.model.add_cond_attn}
        pipe.enable_prompt_cache()

    def reference(pipe):
        run_reflectionflow_block(pipe, *models(), base_cfg, rows, os.path.join(td, "base"))
        pipe._embed_cache.clear()

    pipe, _, build_s = _mesh_build(device, make_mesh((MESH_WORLD,), ("data",)), quantize=True,
                                   setup=setup, first=reference)
    zero_counts()
    collectives.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_reflectionflow_block(pipe, *models(), cfg, rows, os.path.join(td, "mesh"))
    torch.cuda.synchronize()
    out = {"rank": dist.get_rank(), "launches": _launch_counts(), "collectives": dict(collectives.COUNTS),
           "block_s": time.perf_counter() - t0, "build_s": build_s}
    if dist.get_rank() == 0:
        out["compare"] = compare_trees(os.path.join(td, "base"), os.path.join(td, "mesh"))
    return out


def mesh_phase(torch, card: str) -> dict:
    """Phase 14: serving over a mesh of ranks on the one card (see the module
    docstring). Each sub-phase spawns fresh ranks; every launch count is read
    on each rank around its sharded call only."""
    from reflectionflow_tpu_torch.parallel.distributed import launch
    from reflectionflow_tpu_torch.parallel.dryrun import dryrun_multihost, file_init, multihost_reference

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"phase 14: parent holds {held:.2f} GiB; {MESH_WORLD} gloo ranks "
        f"on cuda:0 ({card}); collectives through host memory (NCCL refuses two ranks on one GPU)")
    check(held < MESH_PARENT_GIB, f"phase 14: the parent still holds {held:.2f} GiB of the card its ranks share")
    cfg = _dit_cfg()
    nd, ns = cfg.num_double_blocks, cfg.num_single_blocks
    res = {"world": MESH_WORLD, "backend": "gloo", "steps": MESH_STEPS}
    with tempfile.TemporaryDirectory() as td:
        def run(fn):
            t0 = time.perf_counter()
            out = launch(fn, MESH_WORLD, args=(td,), backend="gloo", device="cuda:0",
                         init_method=file_init(td), timeout=MESH_TIMEOUT)
            return out, time.perf_counter() - t0

        # 14a: tensor parallelism, bf16; then 15c, W8A8 under the same cut
        tp, res["tp_wall_s"] = run(mesh_tp_rank)
        per_rank = MESH_STEPS * (nd + ns)
        sums = MESH_STEPS * (4 * nd + ns)
        for r in tp:
            want = {name: 0 for name in r["launches"]}
            want["flash_fwd"] = per_rank
            check(r["launches"] == want, f"14a rank {r['rank']}: launches {r['launches']}, expected {want}")
            q = r["w8a8"]
            check(q["launches"] == want, f"15c rank {r['rank']}: launches {q['launches']}, expected {want} "
                  "(K1 alone: no K2-K5 under tensor parallelism, as JAX runs none there)")
            # each row-cut W8A8 linear: one amax of its input's rows and one int32 sum, through host memory
            check(q["collectives"]["all_reduce_max"] == sums and q["collectives"]["all_reduce_sum"] == sums
                  and q["collectives"]["host_copies"] == 2 * sums and q["rope_layout"] == "pair" and q["finite"],
                  f"15c rank {r['rank']}: {q['collectives']}, layout {q['rope_layout']}, expected {sums} "
                  "max and sum all-reduces")
            check(r["collectives"]["all_reduce_sum"] == sums and r["collectives"]["host_copies"] == sums
                  and r["collectives"]["all_gather_batch"] == 0,
                  f"14a rank {r['rank']}: collectives {r['collectives']}, expected {sums} all-reduces")
            check(r["finite"] and r["dit_bytes"] < 0.7 * r["dit_bytes_full"], f"14a rank {r['rank']}: {r}")
            # K1 at this rank's heads (num_heads / MESH_WORLD) against its plain version
            k1 = r["k1_vs_plain"]
            check(bool(k1) and all(c["shape"][2] == cfg.num_heads // MESH_WORLD for c in k1)
                  and all(c["max_abs_err"] <= OUT_TOL and c["max_lse_err"] <= LSE_TOL for c in k1),
                  f"14a rank {r['rank']}: K1 at the sharded heads against its plain version: {k1}")
            log(f"14a rank {r['rank']}: K1 on the TP forward's own inputs against its plain version "
                f"(tol {OUT_TOL}, lse {LSE_TOL}): {json.dumps(k1)}")
        check(tp[0]["cosine"] >= MESH_COS, f"14a: cosine {tp[0]['cosine']:.6f} against the one-rank run")
        check(tp[0]["w8a8"]["cosine"] >= MESH_COS,
              f"15c: cosine {tp[0]['w8a8']['cosine']:.6f} against the one-rank W8A8 run of the unfused layout")
        res["tp"] = tp
        log(f"15c W8A8 under TP (data 1 x model {MESH_WORLD}, `quantize` after the cut, unfused layout, "
            f"B={MESH_TP_B}, {MESH_STEPS} steps): cosine {tp[0]['w8a8']['cosine']:.6f} vs the "
            f"one-rank W8A8 run (made in {tp[0]['w8a8']['reference_s']:.1f} s); per rank {per_rank} K1, no K2-K5, "
            f"{tp[0]['w8a8']['collectives']['all_reduce_max']} all_reduce_max + "
            f"{tp[0]['w8a8']['collectives']['all_reduce_sum']} int32 all_reduce_sum; quantize "
            f"{[round(r['w8a8']['quantize_s'], 2) for r in tp]} s; s/step "
            f"{[round(r['w8a8']['s_per_step'], 4) for r in tp]}; peak {[round(r['w8a8']['peak_gib'], 2) for r in tp]} "
            f"GiB; DiT bytes a rank {tp[0]['w8a8']['dit_bytes'] / 2**30:.2f} GiB; 15c's seconds a rank "
            f"{[round(r['w8a8']['phase_s'], 1) for r in tp]}; {card}")
        log(f"14a TP (data 1 x model {MESH_WORLD}, bf16 pallas, B={MESH_TP_B}, {MESH_STEPS} steps): "
            f"cosine {tp[0]['cosine']:.6f} vs one rank; per rank {per_rank} K1, {sums} all-reduces "
            f"(all through host memory); DiT bytes {tp[0]['dit_bytes'] / 2**30:.2f} of "
            f"{tp[0]['dit_bytes_full'] / 2**30:.2f} GiB ({tp[0]['dit_bytes'] / tp[0]['dit_bytes_full']:.3f}); "
            f"s/step {[round(r['s_per_step'], 4) for r in tp]}, all-reduce share "
            f"{[round(r['all_reduce_share'], 4) for r in tp]}; {card}")

        # 14b: data parallelism, W8A8
        dp, res["dp_wall_s"] = run(mesh_dp_rank)
        per_fwd = {"flash_fwd": nd + ns, "norm_rope": 4 * nd + 2 * ns, "adaln_quant": 4 * nd + ns,
                   "gelu_quant": 2 * nd + ns, "rowquant": 2 * nd + ns}
        for r in dp:
            want = {name: MESH_STEPS * per_fwd.get(name, 0) for name in r["launches"]}
            check(r["launches"] == want, f"14b rank {r['rank']}: launches {r['launches']}, expected {want}")
            check(r["collectives"]["all_gather_batch"] == 1 and r["collectives"]["all_reduce_sum"] == 0
                  and r["finite"] and r["shape"][0] == N_PROMPTS * BRANCH, f"14b rank {r['rank']}: {r}")
        check(dp[0]["cosine"] >= MESH_COS, f"14b: cosine {dp[0]['cosine']:.6f} against the one-rank run")
        res["dp"] = dp
        log(f"14b DP (data {MESH_WORLD}, W8A8 pallas, {N_PROMPTS * BRANCH} candidates): cosine "
            f"{dp[0]['cosine']:.6f}, uint8 max |diff| {dp[0]['uint8_max_diff']} vs one rank; launches per rank "
            f"{dp[0]['launches']}; s/step {[round(r['s_per_step'], 4) for r in dp]}; {card}")

        # 14c: the multihost dryrun on the card: NCCL at a world of one (the one-rank tree), gloo at
        # MESH_WORLD against it, and NCCL at the card count where there is more than one card
        t0 = time.perf_counter()
        ref, ref_rank = multihost_reference(td, device="cuda", backend="nccl")
        runs = [([ref_rank], {"reference": True})]
        for n, dev, backend in ((MESH_WORLD, "cuda:0", "gloo"), (torch.cuda.device_count(), "cuda", "nccl")):
            if backend == "gloo" or n > 1:
                out = dryrun_multihost(n, device=dev, backend=backend, workdir=td, reference=ref)
                runs.append((out["ranks"], out["compare"]))
        res["multihost_wall_s"] = time.perf_counter() - t0
        res["multihost"] = []
        for ranks, compare in runs:
            line = {"backend": ranks[0]["backend"], "world": ranks[0]["world"], **compare,
                    "host_copies": [r["counts"]["host_copies"] for r in ranks]}
            check(all(r["sum"] == r["world"] * (r["world"] - 1) / 2 for r in ranks), f"14c: {ranks}")
            res["multihost"].append(line)
            log(f"14c dryrun_multihost: {json.dumps(line)}")

        # 14d: the reflection block under W8A8 pallas_nr at data MESH_WORLD
        rnd, res["round_wall_s"] = run(mesh_round_rank)
        per_t2i, per_cond = round_counts(types.SimpleNamespace(dit_cfg=cfg), "pallas_nr")
        for r in rnd:
            # one candidate a rank: round 0 (t2i) and round 1 (conditioned), MESH_STEPS forwards each
            want = {name: MESH_STEPS * (per_t2i.get(name, 0) + per_cond.get(name, 0)) for name in r["launches"]}
            check(r["launches"] == want, f"14d rank {r['rank']}: launches {r['launches']}, expected {want}")
        res["round"] = rnd
        log(f"14d reflection block (data {MESH_WORLD}, W8A8 pallas_nr, fake models): "
            f"{json.dumps(rnd[0]['compare'])}; launches per rank {rnd[0]['launches']}; "
            f"block s {[round(r['block_s'], 2) for r in rnd]}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 14: {res['wall_s']:.1f} s")
    return res


# -- phase 15: training over a mesh of ranks ----------------------------------


def _train_batch(torch, cfg, B: int, seed: int, device) -> dict:
    """A prepared corrector batch at MESH_TRAIN_PX (the tensors
    `prepare_batch_tensors` makes from the VAE and the text encoders), random
    bf16 from a seeded generator on the card: the same on every rank."""
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids

    g = torch.Generator(device=device).manual_seed(seed)
    side = MESH_TRAIN_PX // 16  # packed latent tokens a side
    bf = dict(device=device, dtype=torch.bfloat16, generator=g)
    return {"x0": torch.randn((B, side * side, cfg.in_channels), **bf),
            "cond": torch.randn((B, side * side, cfg.in_channels), **bf),
            "txt": torch.randn((B, LT, cfg.text_dim), **bf), "pooled": torch.randn((B, cfg.pooled_dim), **bf),
            "img_ids": torch.from_numpy(make_image_ids(side, side)).to(device),
            "txt_ids": torch.from_numpy(make_text_ids(LT)).to(device),
            "cond_ids": torch.from_numpy(make_image_ids(side, side, position_delta=(0, -side))).to(device)}


def _data_slice(batch: dict, mesh) -> dict:
    """This rank's rows over "data" of a corrector batch's batch-leading
    tensors: what each rank's loader yields under `train(mesh=)`."""
    from reflectionflow_tpu_torch.parallel.mesh import shard_batch

    return dict(batch, **shard_batch({k: batch[k] for k in ("x0", "cond", "txt", "pooled")}, mesh))


def _same_on_every_rank(torch, collectives, tensors) -> bool:
    """This rank's tensors equal rank 0's bit for bit (rank 0's broadcast
    into a copy); the collective counts are left as they were."""
    saved = dict(collectives.COUNTS)
    mine = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    theirs = collectives.broadcast(mine.clone(), 0)
    collectives.COUNTS.update(saved)
    return bool(torch.equal(mine, theirs))


def _adapter_list(adapters):
    return [ab[k] for ab in adapters.values() for k in ("lora_A", "lora_B")]


def _train_dit(torch, cfg, device):
    from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
    from reflectionflow_tpu_torch.sampler.pipeline import _build

    return _build(FluxDiT, cfg, torch.bfloat16, device, torch.Generator(device=device).manual_seed(0)).requires_grad_(False)


def mesh_tp_train(torch, dist, collectives, device, td) -> dict:
    """15b: one corrector step over data 1 x model MESH_WORLD on FLUX.1-dev's
    full width cut to MESH_TP_DEPTH blocks (B=2, 512 px, "pallas"): sgd at
    lr 1 without a clip from adapters with a seeded non-zero B, so that the
    update is the reduced gradient; the same step unsharded on the rank's
    whole DiT first."""
    from reflectionflow_tpu_torch.utils import threefry
    import dataclasses
    import hashlib

    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora.lora import lora_init, lora_parameters
    from reflectionflow_tpu_torch.models.flux.dit import FluxDiT
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh
    from reflectionflow_tpu_torch.parallel.specs import shard_dit_params
    from reflectionflow_tpu_torch.train import rectified_flow
    from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step
    from reflectionflow_tpu_torch.train.train_loop import export_diffusers_lora

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    nd, ns = MESH_TP_DEPTH
    cfg = dataclasses.replace(_dit_cfg(), num_double_blocks=nd, num_single_blocks=ns)
    tcfg = TrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr, tcfg.optimizer.grad_clip = "sgd", 1.0, 0.0
    batch = _train_batch(torch, cfg, 2, MESH_SEED, device)

    def step_delta(dit, mesh):
        """The adapters' change over one step (= minus the reduced gradient)."""
        lora = lora_init(threefry.prng_key(MESH_SEED), dit, r=tcfg.lora.r, alpha=tcfg.lora.alpha)
        with torch.no_grad():
            g = torch.Generator(device=device).manual_seed(MESH_SEED + 1)
            for ab in lora["adapters"].values():
                ab["lora_B"].normal_(0.0, 0.02, generator=g)
        before = [t.detach().clone() for t in lora_parameters(lora)]
        opt = make_optimizer(tcfg)
        step = make_train_step(dit, opt, alpha=tcfg.lora.alpha, r=tcfg.lora.r, attn_impl="pallas", mesh=mesh)
        mine = batch if mesh is None else _data_slice(batch, mesh)
        adapters, _, metrics = step(lora["adapters"], opt.init(lora_parameters(lora)), mine,
                                    threefry.prng_key(MESH_SEED + 2))
        return adapters, [a.detach() - b for a, b in zip(_adapter_list(adapters), before)], float(metrics["loss"])

    dit = _train_dit(torch, cfg, device)
    _, want, want_loss = step_delta(dit, None)
    mesh = make_mesh((1, MESH_WORLD), ("data", "model"))
    shard_dit_params(dit, mesh)
    torch.cuda.synchronize()
    zero_counts()
    collectives.reset_counts()
    k1_seen, restore_k1 = _spy_k1()
    k6_seen, restore_k6 = _spy_k6()
    sums, restore_sums = _timed_call(torch, collectives)  # the row sums and the column copies' backward
    bucket, restore_bucket = _timed_call(torch, rectified_flow, "reduce_gradients")
    t0 = time.perf_counter()
    try:
        adapters, got, loss = step_delta(dit, mesh)
        torch.cuda.synchronize()
    finally:
        restore_k1()
        restore_k6()
        restore_sums()
        restore_bucket()
    step_s = time.perf_counter() - t0
    launches, counts = _launch_counts(), dict(collectives.COUNTS)
    cos = [_cosine(a, b) for a, b in zip(got, want)]
    path = os.path.join(td, f"tp_adapters_rank{dist.get_rank()}.safetensors")
    export_diffusers_lora(adapters, path)
    with torch.device("meta"):  # the whole model's linears
        whole = dict(FluxDiT(cfg).named_modules())
    r = tcfg.lora.r
    shapes_whole = all(tuple(ab["lora_A"].shape) == (r, whole[n].in_features)
                       and tuple(ab["lora_B"].shape) == (whole[n].out_features, r) for n, ab in adapters.items())
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    out = {"launches": launches, "collectives": counts, "step_s": step_s, "loss": loss, "loss_one_rank": want_loss,
           "all_reduce_s": sum(sums) + sum(bucket), "all_reduce_share": (sum(sums) + sum(bucket)) / step_s,
           "grad_cosine_min": min(cos), "adapters_sha256": digest, "shapes_whole": shapes_whole,
           "same_on_every_rank": _same_on_every_rank(torch, collectives, _adapter_list(adapters)),
           "k1_vs_plain": _k1_against_plain(torch, k1_seen), "k6_vs_plain": _k6_against_plain(torch, k6_seen),
           "depth": [nd, ns],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del dit, adapters, got, want, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["sub_s"] = time.perf_counter() - t_sub
    return out


def mesh_dp_train(torch, dist, collectives, device) -> dict:
    """15a: MESH_TRAIN_STEPS corrector steps over data MESH_WORLD on the full
    FLUX.1-dev DiT (19 + 38 blocks, random bf16 from seed 0 on every rank),
    "pallas", r = alpha = 32, sgd (an update along the clipped gradient, so
    that the adapters' cosines read the gradients) with the 0.5 clip, global
    B = MESH_TRAIN_B at 512 px, each rank passing its data slice; rank 0 first
    runs the same steps on the same global batches alone. After each mesh step the adapters are checked equal
    on every rank, bit for bit."""
    from reflectionflow_tpu_torch.utils import threefry
    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora.lora import lora_init, lora_parameters
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh
    from reflectionflow_tpu_torch.train import rectified_flow
    from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step

    t_sub = time.perf_counter()
    cfg = _dit_cfg()
    t0 = time.perf_counter()
    dit = _train_dit(torch, cfg, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_same = _same_on_every_rank(torch, collectives, [dit.x_embedder.weight, dit.proj_out.weight,
                                                            dit.transformer_blocks[-1].attn.to_q.weight,
                                                            dit.single_transformer_blocks[-1].proj_mlp.weight])
    batches = [_train_batch(torch, cfg, MESH_TRAIN_B, MESH_SEED + i, device) for i in range(MESH_TRAIN_STEPS)]
    tcfg = TrainConfig()
    tcfg.optimizer.name = "sgd"

    def trainer(mesh):
        """Adapters, optimizer state and step, and the step keys, as `train` draws them."""
        k_init, key = threefry.split(threefry.prng_key(MESH_SEED))
        lora = lora_init(k_init, dit, r=tcfg.lora.r, alpha=tcfg.lora.alpha)
        opt = make_optimizer(tcfg)
        step = make_train_step(dit, opt, alpha=tcfg.lora.alpha, r=tcfg.lora.r, attn_impl="pallas", mesh=mesh)
        keys = []
        for _ in batches:
            key, k_step = threefry.split(key)
            keys.append(k_step)
        return lora["adapters"], opt.init(lora_parameters(lora)), step, keys

    ref = None
    if dist.get_rank() == 0:  # the one-rank run of the same global batches, draws and seed
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        adapters, state, step, keys = trainer(None)
        losses = []
        for batch, k_step in zip(batches, keys):
            adapters, state, m = step(adapters, state, batch, k_step)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ref = {"adapters": [t.detach().clone() for t in _adapter_list(adapters)], "losses": losses,
               "s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del adapters, state, step
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh((MESH_WORLD,), ("data",))
    adapters, state, step, keys = trainer(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    collectives.reset_counts()
    losses, secs, same = [], [], []
    bucket, restore_bucket = _timed_call(torch, rectified_flow, "reduce_gradients")
    try:
        for batch, k_step in zip(batches, keys):
            t0 = time.perf_counter()
            adapters, state, m = step(adapters, state, _data_slice(batch, mesh), k_step)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            same.append(_same_on_every_rank(torch, collectives, _adapter_list(adapters)))
    finally:
        restore_bucket()
    out = {"launches": _launch_counts(), "collectives": dict(collectives.COUNTS), "losses": losses,
           "s_per_step_all": secs, "all_reduce_s_all": bucket,
           "all_reduce_share": sum(bucket) / sum(secs), "same_on_every_rank": same, "weights_same": weights_same,
           "build_s": build_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "adapter_params": sum(t.numel() for t in _adapter_list(adapters))}
    if ref is not None:
        cos = [_cosine(a, b) for a, b in zip(_adapter_list(adapters), ref["adapters"])]
        out.update(adapter_cosine_min=min(cos), losses_one_rank=ref["losses"], one_rank_s=ref["s"],
                   one_rank_peak_gib=ref["peak_gib"],
                   loss_rel=max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])))
    del dit, adapters, state, step, batches, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["sub_s"] = time.perf_counter() - t_sub
    return out


def mesh_fsdp_rm(torch, dist, collectives, device) -> dict:
    """15d: one reward-model step over data MESH_WORLD on Qwen2.5-VL-7B's
    widths cut to MESH_RM_DEPTH (random bf16 from RM_SEED on every rank), the
    LM and the tower int8 weight-only and sharded FSDP, the LM and vision
    adapters, the head and the special row trained, RM_PAIRS pairs at RM_PX
    (one a rank); the same step unsharded on each rank's own model first.
    The optimizer's `update` is wrapped to keep the gradients it is handed
    (reduced, under the mesh), which are held with each trainable's change
    over the step against the one-rank step's."""
    import numpy as np

    from reflectionflow_tpu_torch.models.qwen_vl.model import QwenVLModel
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh
    from reflectionflow_tpu_torch.parallel.specs import fsdp_local_bytes
    from reflectionflow_tpu_torch.rm_train import train as rt
    from reflectionflow_tpu_torch.rm_train.data import collate_rm_batch, vision_train_geometry
    from reflectionflow_tpu_torch.train.optim import flatten_tree

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    lm_cfg, vis_cfg = _qwen_cfgs(*MESH_RM_DEPTH)
    sp = lm_cfg.vocab_size - 1
    _, grid = vision_train_geometry(vis_cfg, RM_PX * RM_PX)
    rng = np.random.default_rng(RM_SEED)
    rows = [{"prompt": f"a photo of {i + 2} red cubes on a wooden table", "gsb": "GB"[i % 2],
             "score_A": 4.0 - i, "score_B": 2.0 + i,
             **{f"image_{s}": rng.integers(0, 256, (RM_PX, RM_PX, 3), dtype=np.uint8) for s in "AB"}}
            for i in range(RM_PAIRS)]

    def run(mesh):
        model = QwenVLModel.random_init(torch.Generator(device=device).manual_seed(RM_SEED), lm_cfg, vis_cfg,
                                        dtype=torch.bfloat16, device=device)
        model.lm_head = None
        batch = collate_rm_batch(model, rows, max_pixels=RM_PX * RM_PX, special_token_id=sp, train_vision=True)
        trainable = _rm_trainable(torch, model, RM_SEED + 1, device)
        opt = rt.make_rm_optimizer(lr=RM_LR)
        step = rt.make_rm_train_step(model.model, opt, loss_type="btt", pooling="special", special_token_id=sp,
                                     alpha=RM_LORA_ALPHA, r=RM_LORA_R, tower=model.visual, grid_thw=grid,
                                     quantize_base="int8", mesh=mesh)
        held = fsdp_local_bytes(model.model) + fsdp_local_bytes(model.visual)
        state = opt.init(trainable)
        before = {k: v.detach().clone() for k, v in flatten_tree(trainable).items()}
        grads, update = {}, opt.update

        def keep_grads(g, *args):
            grads.update((k, t.detach().clone()) for k, t in flatten_tree(g).items())
            return update(g, *args)

        opt.update = keep_grads
        torch.cuda.synchronize()
        zero_counts()
        collectives.reset_counts()
        t0 = time.perf_counter()
        trainable, state, aux = step(trainable, state, batch)
        torch.cuda.synchronize()
        res = {"loss": float(aux["loss"]), "step_s": time.perf_counter() - t0, "bytes": held,
               "launches": _launch_counts(), "collectives": dict(collectives.COUNTS),
               "same_on_every_rank": _same_on_every_rank(torch, collectives, list(flatten_tree(trainable).values())),
               "grads": grads,
               "change": {k: v.detach() - before[k] for k, v in flatten_tree(trainable).items()}}
        del model, batch, trainable, state, step, opt, before
        gc.collect()
        torch.cuda.empty_cache()
        return res

    one = run(None)
    out = run(make_mesh((MESH_WORLD,), ("data",)))
    out.update(_against_one_rank(out.pop("grads"), one.pop("grads"), out.pop("change"), one.pop("change")))
    out.update(loss_one_rank=one["loss"], bytes_whole=one["bytes"], one_rank_step_s=one["step_s"],
               depth=list(MESH_RM_DEPTH), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               sub_s=time.perf_counter() - t_sub)
    return out


def _against_one_rank(grads, grads_one, change, change_one) -> dict:
    """15d's gradients and changes of each trainable against the one-rank
    step's: the least cosines, the whole gradient's norm ratio and each
    tensor's (their range, printed), and whether every tensor whose one-rank
    gradient is zero is zero here too (its cosine is then not taken)."""
    cos_g, cos_d, ratio, zeros = [], [], [], []
    whole = [sum(float(g.double().norm()) ** 2 for g in gs.values()) ** 0.5 for gs in (grads, grads_one)]
    for k, want in grads_one.items():
        if not bool(want.any()):
            zeros.append(not bool(grads[k].any()) and not bool(change[k].any()))
            continue
        cos_g.append(_cosine(grads[k], want))
        ratio.append(float(grads[k].double().norm() / want.double().norm()))
        cos_d.append(_cosine(change[k], change_one[k]))
    return {"grad_cosine_min": min(cos_g), "grad_norm_ratio": whole[0] / whole[1],
            "grad_norm_ratio_tensors": [min(ratio), max(ratio)],
            "change_cosine_min": min(cos_d), "tensors": len(grads_one), "zero_tensors": len(zeros),
            "zeros_match": all(zeros)}


def mesh_train_rank(device, td):
    """Phase 15's launch: 15b, 15a, 15d in turn on every rank, each read
    around its own run (15c runs inside 14a's launch)."""
    torch, dist, collectives = _mesh_ctx()
    out = {"rank": dist.get_rank()}
    out["tp"] = mesh_tp_train(torch, dist, collectives, device, td)
    dist.barrier()
    out["dp"] = mesh_dp_train(torch, dist, collectives, device)
    dist.barrier()
    out["fsdp"] = mesh_fsdp_rm(torch, dist, collectives, device)
    return out


def mesh_train_phase(torch, card: str, quant: list[dict]) -> dict:
    """Phase 15: training over a mesh of ranks on the one card (see the module
    docstring); `quant` is 15c's result on each rank from 14a's launch."""
    from reflectionflow_tpu_torch.parallel.distributed import launch
    from reflectionflow_tpu_torch.parallel.dryrun import file_init

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    check(held < MESH_PARENT_GIB, f"phase 15: the parent still holds {held:.2f} GiB of the card its ranks share")
    cfg = _dit_cfg()
    nd, ns = cfg.num_double_blocks, cfg.num_single_blocks
    with tempfile.TemporaryDirectory() as td:
        ranks = launch(mesh_train_rank, MESH_WORLD, args=(td,), backend="gloo", device="cuda:0",
                       init_method=file_init(td), timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t_phase
    tp, dp, fs = ([r[k] for r in ranks] for k in ("tp", "dp", "fsdp"))

    # 15b: TP step at MESH_TP_DEPTH
    n = sum(MESH_TP_DEPTH)
    for i, r in enumerate(tp):
        want = {k: 0 for k in r["launches"]}
        want.update(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
        check(r["launches"] == want, f"15b rank {i}: launches {r['launches']}, expected {want}")
        check(r["grad_cosine_min"] >= MESH_TP_GRAD_COS, f"15b rank {i}: adapter gradient cosine "
              f"{r['grad_cosine_min']:.6f} against the one-rank step")
        check(r["shapes_whole"] and r["same_on_every_rank"] and r["collectives"]["grad_all_reduce"] == 1,
              f"15b rank {i}: {r}")
        k1 = r["k1_vs_plain"]
        check(bool(k1) and all(c["shape"][2] == cfg.num_heads // MESH_WORLD for c in k1)
              and all(c["max_abs_err"] <= OUT_TOL and c["max_lse_err"] <= LSE_TOL for c in k1),
              f"15b rank {i}: K1 at the sharded heads against its plain version: {k1}")
        k6 = r["k6_vs_plain"]
        check(bool(k6) and all(c["shape"][2] == cfg.num_heads // MESH_WORLD and c["finite"] for c in k6)
              and all(c[f"{n}_rel"] <= K6_REL_TOL for c in k6 for n in ("dq", "dk", "dv")),
              f"15b rank {i}: K6a + K6b at the sharded heads against the plain backward: {k6}")
    check(len({r["adapters_sha256"] for r in tp}) == 1, "15b: the saved adapters differ between the ranks")
    log(f"15b TP training (data 1 x model {MESH_WORLD}, depth {MESH_TP_DEPTH} at full width, B=2, 512 px, "
        f"pallas): adapter gradients min cosine {min(r['grad_cosine_min'] for r in tp):.6f} vs one rank; loss "
        f"{tp[0]['loss']:.6f} (one rank {tp[0]['loss_one_rank']:.6f}); per rank {tp[0]['launches']['flash_fwd']} K1, "
        f"{tp[0]['launches']['flash_bwd_dq']} K6a, {tp[0]['launches']['flash_bwd_dkv']} K6b; collectives "
        f"{tp[0]['collectives']}; K1 on its own inputs: {json.dumps(tp[0]['k1_vs_plain'])}; K6a + K6b on their "
        f"own inputs (tol {K6_REL_TOL} of max |ref|): {json.dumps([r['k6_vs_plain'] for r in tp])}; saved adapters "
        f"whole-shaped, sha256 {tp[0]['adapters_sha256'][:16]} on both ranks; step s "
        f"{[round(r['step_s'], 3) for r in tp]}, all-reduce share {[round(r['all_reduce_share'], 3) for r in tp]}; peak {[round(r['peak_gib'], 2) for r in tp]} GiB; "
        f"{[round(r['sub_s'], 1) for r in tp]} s")

    # 15a: DP steps at full depth
    for i, r in enumerate(dp):
        want = {k: 0 for k in r["launches"]}
        want.update(flash_fwd=2 * (nd + ns) * MESH_TRAIN_STEPS, flash_bwd_dq=(nd + ns) * MESH_TRAIN_STEPS,
                    flash_bwd_dkv=(nd + ns) * MESH_TRAIN_STEPS)
        check(r["launches"] == want, f"15a rank {i}: launches {r['launches']}, expected {want}")
        check(all(r["same_on_every_rank"]) and r["weights_same"], f"15a rank {i}: adapters or weights differ "
              f"from rank 0's: {r['same_on_every_rank']}, {r['weights_same']}")
        check(r["collectives"]["grad_all_reduce"] == MESH_TRAIN_STEPS
              and r["collectives"]["all_reduce_sum"] == 0, f"15a rank {i}: collectives {r['collectives']}")
        check(all(math.isfinite(x) for x in r["losses"]), f"15a rank {i}: losses {r['losses']}")
    check(dp[0]["loss_rel"] <= MESH_TRAIN_LOSS_RTOL and dp[0]["adapter_cosine_min"] >= MESH_ADAPTER_COS,
          f"15a: losses {dp[0]['losses']} vs one rank {dp[0]['losses_one_rank']}, adapter cosine min "
          f"{dp[0]['adapter_cosine_min']:.6f}")
    log(f"15a DP training (data {MESH_WORLD}, full depth, global B={MESH_TRAIN_B}, 512 px, pallas, "
        f"{MESH_TRAIN_STEPS} steps): losses {dp[0]['losses']} vs one rank {dp[0]['losses_one_rank']} (max rel "
        f"{dp[0]['loss_rel']:.2e}); adapters ({dp[0]['adapter_params']} parameters) min cosine "
        f"{dp[0]['adapter_cosine_min']:.7f}, bitwise equal across ranks after each step; per rank a step "
        f"{dp[0]['launches']['flash_fwd'] // MESH_TRAIN_STEPS} K1, {dp[0]['launches']['flash_bwd_dq'] // MESH_TRAIN_STEPS} "
        f"K6a, {dp[0]['launches']['flash_bwd_dkv'] // MESH_TRAIN_STEPS} K6b; collectives {dp[0]['collectives']}; "
        f"s/step {[[round(x, 3) for x in r['s_per_step_all']] for r in dp]}, gradient all-reduce "
        f"{[[round(x, 3) for x in r['all_reduce_s_all']] for r in dp]} s (share "
        f"{[round(r['all_reduce_share'], 3) for r in dp]}) (one rank at B={MESH_TRAIN_B}: "
        f"{dp[0]['one_rank_s'] / MESH_TRAIN_STEPS:.3f}); peak {[round(r['peak_gib'], 2) for r in dp]} GiB (one "
        f"rank {dp[0]['one_rank_peak_gib']:.2f}); build {[round(r['build_s'], 1) for r in dp]} s; "
        f"{[round(r['sub_s'], 1) for r in dp]} s")

    # 15d: the reward trainer's FSDP
    for i, r in enumerate(fs):
        check(not any(r["launches"].values()), f"15d rank {i}: launched kernels of the DiT path: {r['launches']}")
        check(r["same_on_every_rank"] and r["bytes"] <= 0.55 * r["bytes_whole"]
              and r["collectives"]["all_gather_dim"] > 0 and r["collectives"]["grad_all_reduce"] == 1,
              f"15d rank {i}: {r}")
        check(abs(r["loss"] - r["loss_one_rank"]) <= MESH_RM_LOSS_RTOL * abs(r["loss_one_rank"]),
              f"15d rank {i}: loss {r['loss']} vs one rank {r['loss_one_rank']}")
        check(r["grad_cosine_min"] >= MESH_RM_GRAD_COS and r["change_cosine_min"] >= MESH_RM_DELTA_COS
              and abs(r["grad_norm_ratio"] - 1.0) <= MESH_RM_GRAD_NORM_RTOL and r["zeros_match"],
              f"15d rank {i}: gradients and changes against the one-rank step: gradient cosine min "
              f"{r['grad_cosine_min']:.6f}, norm ratio {r['grad_norm_ratio']}, change cosine min "
              f"{r['change_cosine_min']:.6f}, zero tensors {r['zero_tensors']} matched {r['zeros_match']}")
    log(f"15d reward-model FSDP (data {MESH_WORLD}, Qwen2.5-VL-7B widths, depth {MESH_RM_DEPTH}, int8 base, "
        f"{RM_PAIRS} pairs at {RM_PX} px): loss {fs[0]['loss']:.6f} vs one rank {fs[0]['loss_one_rank']:.6f}; "
        f"reduced gradients min cosine {min(r['grad_cosine_min'] for r in fs):.6f} (limit {MESH_RM_GRAD_COS}), "
        f"norm ratio {[r['grad_norm_ratio'] for r in fs]} (limit 1 +- {MESH_RM_GRAD_NORM_RTOL}; a tensor's "
        f"{fs[0]['grad_norm_ratio_tensors']}), changes min cosine {min(r['change_cosine_min'] for r in fs):.6f} "
        f"(limit {MESH_RM_DELTA_COS}) over the {fs[0]['tensors'] - fs[0]['zero_tensors']} of {fs[0]['tensors']} "
        f"tensors with a gradient, {fs[0]['zero_tensors']} zero on both; "
        f"trainables bitwise equal across ranks; base bytes a rank {[r['bytes'] for r in fs]} of "
        f"{fs[0]['bytes_whole']} ({fs[0]['bytes'] / fs[0]['bytes_whole']:.3f}); collectives {fs[0]['collectives']}; "
        f"step s {[round(r['step_s'], 3) for r in fs]} (one rank {fs[0]['one_rank_step_s']:.3f}); peak "
        f"{[round(r['peak_gib'], 2) for r in fs]} GiB; {[round(r['sub_s'], 1) for r in fs]} s")
    q_s = max(q["phase_s"] + q.get("reference_s", 0.0) for q in quant)
    res = {"world": MESH_WORLD, "backend": "gloo", "tp": tp, "dp": dp, "fsdp": fs, "quant_tp": quant,
           "launch_wall_s": wall, "quant_tp_s": q_s, "phase_s": wall + q_s}
    log(f"phase 15: {res['phase_s']:.1f} s (its launch {wall:.1f} s, 15c inside 14a's launch {q_s:.1f} s); {card}")
    return res


# -- phase 16: ring attention across ranks -------------------------------------


def _ring_inputs(torch, cfg_d, B: int, seed: int, device):
    """A conditioned denoise's inputs at 1024 px with a 512 px condition: B
    items of random bf16 latents, text states, pooled and condition tokens
    (and black-condition tokens) from a seeded generator: the same on every
    rank."""
    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    ty = tx = 2 * LT // 16  # 64 x 64 packed tokens
    cy = cx = LT // 16  # the 512 px condition: 32 x 32
    x = {"lat": randn(B, ty * tx, cfg_d.in_channels), "txt": randn(B, LT, cfg_d.text_dim),
         "pooled": randn(B, cfg_d.pooled_dim), "cond": randn(B, cy * cx, cfg_d.in_channels),
         "cond_empty": randn(B, cy * cx, cfg_d.in_channels)}
    ids = {"img_ids": torch.from_numpy(make_image_ids(ty, tx)).to(device),
           "txt_ids": torch.from_numpy(make_text_ids(LT)).to(device),
           "cond_ids": torch.from_numpy(make_image_ids(cy, cx, position_delta=(0, -cx))).to(device)}
    return x, ids


def _ring_denoise(torch, dit, x, ids, impl, image_cfg: float, steps: int):
    from reflectionflow_tpu_torch.sampler.generate import denoise, make_schedule

    kw = {"cond_empty": x["cond_empty"], "image_guidance_scale": image_cfg} if image_cfg != 1.0 else {}
    return denoise(dit, x["lat"], x["txt"], x["pooled"], ids["img_ids"], ids["txt_ids"],
                   make_schedule(steps, x["lat"].shape[1]), 3.5, steps, cond=x["cond"], cond_ids=ids["cond_ids"],
                   cond_dit_params=dit, union_cond_attn=False, attn_impl=impl, **kw)


def _one_process_ring(device):
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((RING_RANKS,), ("seq",), devices=[device] * RING_RANKS)


def ring_rank_attention(torch, dist, collectives, device, mesh) -> dict:
    """16a: `ring_attention` over the rank ring at the corrector's (2, 5632,
    24, 128), main_len 4608, in the three cross forms, forward and backward:
    launches counted around each pass, the ring shifts and gathers timed
    (synchronised around each call); then the one-process ring of as many
    slots on this rank and, on rank 0, the fp32 plain dense attention."""
    from reflectionflow_tpu_torch.ops.flash_attention import flash_attention_bwd_ref, flash_attention_ref
    from reflectionflow_tpu_torch.ops.ring_attention import ring_attention

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(12)
    B, L, main_len = 2, LT + LI + LC, LT + LI
    q, k, v, do = (torch.randn((B, L, 24, D), generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
    one = _one_process_ring(device)
    cases = []
    for cb in (0.0, math.log(0.5), -1e30):
        def run(on):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            out = ring_attention(*xs, on, "seq", "pallas", main_len, cb)  # noqa: B023
            torch.cuda.synchronize()
            fwd = _launch_counts()
            grads = torch.autograd.grad(out, xs, do)
            torch.cuda.synchronize()
            return out.detach(), grads, fwd

        zero_counts()
        collectives.reset_counts()
        shifts, restore_shift = _timed_call(torch, collectives, "ring_shift")
        gathers, restore_gather = _timed_call(torch, collectives, "all_gather_dim")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out, grads, fwd = run(mesh)
        finally:
            restore_shift()
            restore_gather()
        call_s = time.perf_counter() - t0
        launches, counts = _launch_counts(), dict(collectives.COUNTS)
        w_out, w_grads, _ = run(one)
        bitwise = bool(torch.equal(out, w_out)) and all(torch.equal(a, b) for a, b in zip(grads, w_grads))
        same = _same_on_every_rank(torch, collectives, [out, *grads])
        case = {"cross_bias": cb, "fwd_launches": fwd, "launches": launches, "collectives": counts,
                "bitwise_one_process": bitwise, "same_on_every_rank": same, "fwd_bwd_s": call_s,
                "ring_shift_s": sum(shifts), "all_gather_s": sum(gathers),
                "p2p_share": sum(shifts) / call_s, "shifted_gb": counts["ring_shift_bytes"] / 1e9}
        if dist.get_rank() == 0:  # the fp32 dense reference one batch element at a time (the ranks agree)
            e_out, rels = 0.0, [0.0, 0.0, 0.0]
            for b in range(B):
                sl = slice(b, b + 1)
                w_o, w_lse = flash_attention_ref(q[sl].float(), k[sl].float(), v[sl].float(), main_len, cb)
                e_out = max(e_out, (out[sl].float() - w_o).abs().max().item())
                want = flash_attention_bwd_ref(q[sl], k[sl], v[sl], w_o, w_lse, do[sl], main_len, cb)
                for i, (g_, w) in enumerate(zip(grads, want)):
                    rels[i] = max(rels[i], ((g_[sl].float() - w).abs().max() / w.abs().max()).item())
                del w_o, w_lse, want
            case.update(out_err=e_out, grad_rel=rels)
        case["finite"] = bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g_).all()) for g_ in grads)
        cases.append(case)
        del out, grads, w_out, w_grads
        torch.cuda.empty_cache()
    del q, k, v, do
    torch.cuda.empty_cache()
    return {"cases": cases, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "sub_s": time.perf_counter() - t_sub}


def ring_rank_denoise(torch, dist, collectives, device, mesh) -> dict:
    """16b: the conditioned denoise at 1024 px (512 px condition, image CFG:
    B=2 rows, L=5632, union_cond_attn=False), RING_RANK_STEPS steps, at full
    depth under "ring_pallas" over the rank ring; rank 0 then runs the
    one-process ring of as many slots and "pallas" (K1) on the same inputs."""
    from reflectionflow_tpu_torch.ops.attention import set_ring_context

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dit = _train_dit(torch, _dit_cfg(), device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x, ids = _ring_inputs(torch, dit.cfg, 1, 13, device)
    set_ring_context(mesh, "seq")
    zero_counts()
    collectives.reset_counts()
    shifts, restore_shift = _timed_call(torch, collectives, "ring_shift")
    gathers, restore_gather = _timed_call(torch, collectives, "all_gather_dim")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = _ring_denoise(torch, dit, x, ids, "ring_pallas", IMAGE_CFG, RING_RANK_STEPS)
        torch.cuda.synchronize()
    finally:
        restore_shift()
        restore_gather()
        set_ring_context(None)
    wall = time.perf_counter() - t0
    launches, counts = _launch_counts(), dict(collectives.COUNTS)
    res = {"launches": launches, "collectives": counts, "s_per_step": wall / RING_RANK_STEPS,
           "ring_shift_s": sum(shifts), "all_gather_s": sum(gathers), "p2p_share": sum(shifts) / wall,
           "shifted_gb": counts["ring_shift_bytes"] / 1e9, "build_s": build_s,
           "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape),
           "same_on_every_rank": _same_on_every_rank(torch, collectives, [out])}
    if dist.get_rank() == 0:
        set_ring_context(_one_process_ring(device), "seq")
        try:
            ref = _ring_denoise(torch, dit, x, ids, "ring_pallas", IMAGE_CFG, RING_RANK_STEPS)
        finally:
            set_ring_context(None)
        k1 = _ring_denoise(torch, dit, x, ids, "pallas", IMAGE_CFG, RING_RANK_STEPS)
        res.update(bitwise_one_process=bool(torch.equal(out, ref)), cosine_k1=_cosine(out, k1))
        del ref, k1
    dist.barrier()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del dit, out, x
    gc.collect()
    torch.cuda.empty_cache()
    res["sub_s"] = time.perf_counter() - t_sub
    return res


def ring_rank_train(torch, dist, collectives, device, mesh) -> dict:
    """16c: one corrector step at full width, depth RING_RANK_DEPTH, 512 px,
    B=2, under "ring_pallas" over the rank ring (sgd at lr 1 without a clip
    from adapters with a seeded non-zero B: the update is the gradient),
    against the same step with the one-process ring of as many slots on this
    rank."""
    from reflectionflow_tpu_torch.utils import threefry
    import dataclasses

    from reflectionflow_tpu_torch.config import TrainConfig
    from reflectionflow_tpu_torch.lora.lora import lora_init, lora_parameters
    from reflectionflow_tpu_torch.ops.attention import set_ring_context
    from reflectionflow_tpu_torch.train.rectified_flow import make_optimizer, make_train_step

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    nd, ns = RING_RANK_DEPTH
    cfg = dataclasses.replace(_dit_cfg(), num_double_blocks=nd, num_single_blocks=ns)
    tcfg = TrainConfig()
    tcfg.optimizer.name, tcfg.optimizer.lr, tcfg.optimizer.grad_clip = "sgd", 1.0, 0.0
    batch = _train_batch(torch, cfg, 2, MESH_SEED, device)
    dit = _train_dit(torch, cfg, device)

    def step_delta(on, ring):
        lora = lora_init(threefry.prng_key(MESH_SEED), dit, r=tcfg.lora.r, alpha=tcfg.lora.alpha)
        with torch.no_grad():
            g = torch.Generator(device=device).manual_seed(MESH_SEED + 1)
            for ab in lora["adapters"].values():
                ab["lora_B"].normal_(0.0, 0.02, generator=g)
        before = [t.detach().clone() for t in lora_parameters(lora)]
        opt = make_optimizer(tcfg)
        step = make_train_step(dit, opt, alpha=tcfg.lora.alpha, r=tcfg.lora.r, attn_impl="ring_pallas", mesh=on)
        set_ring_context(ring, "seq")
        try:
            adapters, _, metrics = step(lora["adapters"], opt.init(lora_parameters(lora)), batch,
                                        threefry.prng_key(MESH_SEED + 2))
        finally:
            set_ring_context(None)
        return [a.detach() - b for a, b in zip(_adapter_list(adapters), before)], float(metrics["loss"])

    want, want_loss = step_delta(None, _one_process_ring(device))
    torch.cuda.synchronize()
    zero_counts()
    collectives.reset_counts()
    t0 = time.perf_counter()
    got, loss = step_delta(mesh, mesh)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches, counts = _launch_counts(), dict(collectives.COUNTS)
    cos = [_cosine(a, b) for a, b in zip(got, want)]
    out = {"launches": launches, "collectives": counts, "step_s": step_s, "loss": loss, "loss_one_process": want_loss,
           "grad_cosine_min": min(cos), "bitwise_one_process": all(torch.equal(a, b) for a, b in zip(got, want)),
           "same_on_every_rank": _same_on_every_rank(torch, collectives, got), "depth": [nd, ns],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del dit, got, want, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["sub_s"] = time.perf_counter() - t_sub
    return out


def ring_rank(device, _td):
    """Phase 16's two-rank launch: 16a, 16b, 16c in turn over a ("seq",) mesh
    of RING_RANKS ranks."""
    torch, dist, collectives = _mesh_ctx()
    from reflectionflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((RING_RANKS,), ("seq",))
    out = {"rank": dist.get_rank(), "coords": mesh.coords}
    out["attention"] = ring_rank_attention(torch, dist, collectives, device, mesh)
    dist.barrier()
    out["denoise"] = ring_rank_denoise(torch, dist, collectives, device, mesh)
    dist.barrier()
    out["train"] = ring_rank_train(torch, dist, collectives, device, mesh)
    return out


def ring_data_seq_rank(device, _td):
    """16d: a (data 2, seq 2) mesh of four ranks, depth RING_RANK_DEPTH at
    full width: the conditioned denoise (1024 px, 512 px condition,
    union_cond_attn=False) of B=4 items, 2 a data row, RING_RANK_STEPS steps
    under "ring_pallas", each rank passing its data row's items; rank 0 first
    runs the four items alone under "pallas". The latents gathered over
    "data" on every rank."""
    import dataclasses

    torch, dist, collectives = _mesh_ctx()
    from reflectionflow_tpu_torch.ops.attention import set_ring_context
    from reflectionflow_tpu_torch.parallel.mesh import gather_candidates, make_mesh, shard_batch

    t_sub = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh((2, 2), ("data", "seq"))
    nd, ns = RING_RANK_DEPTH
    dit = _train_dit(torch, dataclasses.replace(_dit_cfg(), num_double_blocks=nd, num_single_blocks=ns), device)
    x, ids = _ring_inputs(torch, dit.cfg, 4, MESH_SEED, device)
    ref = _ring_denoise(torch, dit, x, ids, "pallas", 1.0, RING_RANK_STEPS) if dist.get_rank() == 0 else None
    dist.barrier()
    mine = shard_batch(x, mesh)
    set_ring_context(mesh, "seq")
    zero_counts()
    collectives.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        lat = _ring_denoise(torch, dit, mine, ids, "ring_pallas", 1.0, RING_RANK_STEPS)
        torch.cuda.synchronize()
    finally:
        set_ring_context(None)
    wall = time.perf_counter() - t0
    launches, counts = _launch_counts(), dict(collectives.COUNTS)
    every = gather_candidates(lat, mesh)
    out = {"rank": dist.get_rank(), "coords": mesh.coords, "launches": launches, "collectives": counts,
           "s_per_step": wall / RING_RANK_STEPS, "finite": bool(torch.isfinite(every).all()),
           "shape": list(every.shape), "same_on_every_rank": _same_on_every_rank(torch, collectives, [every]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if ref is not None:
        out["row_cosines"] = [_cosine(every[2 * i:2 * i + 2], ref[2 * i:2 * i + 2]) for i in range(2)]
    out["sub_s"] = time.perf_counter() - t_sub
    return out


def ring_ranks_phase(torch, card: str) -> dict:
    """Phase 16: ring attention across ranks on the one card (see the module
    docstring): one launch of RING_RANKS gloo ranks for 16a-c, one of four
    for 16d. Two ranks that share one card are a correctness path: their
    seconds are not a ring across cards."""
    from reflectionflow_tpu_torch.parallel.distributed import launch
    from reflectionflow_tpu_torch.parallel.dryrun import file_init

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    check(held < MESH_PARENT_GIB, f"phase 16: the parent still holds {held:.2f} GiB of the card its ranks share")
    cfg = _dit_cfg()
    n_blocks = cfg.num_double_blocks + cfg.num_single_blocks
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        ranks = launch(ring_rank, RING_RANKS, args=(td,), backend="gloo", device="cuda:0",
                       init_method=file_init(td), timeout=RING_RANK_TIMEOUT)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = launch(ring_data_seq_rank, 4, args=(td,), backend="gloo", device="cuda:0",
                      init_method=file_init(td), timeout=RING_RANK_TIMEOUT)
        four_s = time.perf_counter() - t0
    p = RING_RANKS
    check(sorted(r["coords"]["seq"] for r in ranks) == list(range(p)), f"16: ring coordinates {ranks}")

    # 16a
    for r in ranks:
        for c in r["attention"]["cases"]:
            want_fwd = {name: 0 for name in c["fwd_launches"]}
            want_fwd["flash_chunk_fwd"] = p
            want = dict(want_fwd, flash_chunk_bwd_dq=p, flash_chunk_bwd_dkv=p)
            check(c["fwd_launches"] == want_fwd and c["launches"] == want,
                  f"16a rank {r['rank']} cross_bias={c['cross_bias']}: launches {c['fwd_launches']} / "
                  f"{c['launches']}, expected {want_fwd} / {want}")
            check(c["bitwise_one_process"] and c["same_on_every_rank"] and c["finite"],
                  f"16a rank {r['rank']} cross_bias={c['cross_bias']}: bitwise one-process "
                  f"{c['bitwise_one_process']}, same on every rank {c['same_on_every_rank']}")
            check(c["collectives"]["ring_shift"] == 2 * p - 1 and c["collectives"]["host_copies"] > 0,
                  f"16a rank {r['rank']}: collectives {c['collectives']}")
    for c in ranks[0]["attention"]["cases"]:
        check(c["out_err"] <= OUT_TOL and max(c["grad_rel"]) <= K6_REL_TOL,
              f"16a cross_bias={c['cross_bias']}: against fp32 dense attention max|out err| {c['out_err']:.3e}, "
              f"dq/dk/dv {c['grad_rel']} of max|ref|")
        per = [cc for r in ranks for cc in r["attention"]["cases"] if cc["cross_bias"] == c["cross_bias"]]

        def each(key, digits=3):
            return [round(cc[key], digits) for cc in per]  # noqa: B023

        log(f"16a ring_attention over {p} ranks (B=2, L={LT + LI + LC}, main_len {LT + LI}, cross_bias "
            f"{c['cross_bias']}): against fp32 dense attention max|out err| {c['out_err']:.3e} (tol {OUT_TOL}), "
            f"dq/dk/dv {', '.join(f'{x:.2e}' for x in c['grad_rel'])} of max|ref| (tol {K6_REL_TOL}); output "
            f"and dq/dk/dv bitwise the one-process {p}-slot ring's on each rank and equal across ranks; per rank "
            f"{c['launches']['flash_chunk_fwd']} K7a, {c['launches']['flash_chunk_bwd_dq']} K7b, "
            f"{c['launches']['flash_chunk_bwd_dkv']} K7c; shifted {each('shifted_gb', 4)} GB a rank, forward + "
            f"backward {each('fwd_bwd_s')} s, ring shifts {each('ring_shift_s')} s (share {each('p2p_share')}), "
            f"gathers {each('all_gather_s')} s; {card}")

    # 16b
    for r in ranks:
        d = r["denoise"]
        want = {name: 0 for name in d["launches"]}
        want["flash_chunk_fwd"] = RING_RANK_STEPS * n_blocks * p
        check(d["launches"] == want, f"16b rank {r['rank']}: launches {d['launches']}, expected {want}")
        check(d["finite"] and d["same_on_every_rank"], f"16b rank {r['rank']}: {d}")
    d0 = ranks[0]["denoise"]
    check(d0["bitwise_one_process"], "16b: the rank ring's denoise differs from the one-process ring's on rank 0")
    check(d0["cosine_k1"] >= RING_COS, f"16b: cosine {d0['cosine_k1']:.6f} against K1")
    log(f"16b ring denoise over {p} ranks (1024 px, 512 px condition, image CFG: B=2 rows, L={LT + LI + LC}, "
        f"union_cond_attn=False, {RING_RANK_STEPS} steps, full depth, ring_pallas): final latents bitwise equal "
        f"across ranks and to the one-process {p}-slot ring on rank 0, cosine {d0['cosine_k1']:.6f} against K1 "
        f"(min {RING_COS}); per rank {d0['launches']['flash_chunk_fwd']} K7a, no K1; s/step "
        f"{[round(r['denoise']['s_per_step'], 3) for r in ranks]}, P2P {[round(r['denoise']['ring_shift_s'], 3) for r in ranks]} s "
        f"(share {[round(r['denoise']['p2p_share'], 3) for r in ranks]}), gathers "
        f"{[round(r['denoise']['all_gather_s'], 3) for r in ranks]} s, shifted "
        f"{[round(r['denoise']['shifted_gb'], 3) for r in ranks]} GB a rank; collectives {d0['collectives']}; "
        f"peak {[round(r['denoise']['peak_gib'], 2) for r in ranks]} GiB; build "
        f"{[round(r['denoise']['build_s'], 1) for r in ranks]} s; {[round(r['denoise']['sub_s'], 1) for r in ranks]} s; "
        f"{card}")

    # 16c
    n = sum(RING_RANK_DEPTH)
    for r in ranks:
        t = r["train"]
        want = {name: 0 for name in t["launches"]}
        want.update(flash_chunk_fwd=2 * n * p, flash_chunk_bwd_dq=n * p, flash_chunk_bwd_dkv=n * p)
        check(t["launches"] == want, f"16c rank {r['rank']}: launches {t['launches']}, expected {want}")
        check(t["grad_cosine_min"] >= MESH_TP_GRAD_COS and t["same_on_every_rank"]
              and t["collectives"]["grad_all_reduce"] == 0,
              f"16c rank {r['rank']}: gradient cosine {t['grad_cosine_min']:.6f} against the one-process ring, {t}")
    t0_ = ranks[0]["train"]
    log(f"16c ring training over {p} ranks (depth {RING_RANK_DEPTH} at full width, B=2, 512 px, ring_pallas, one "
        f"sgd step): adapter gradients min cosine {min(r['train']['grad_cosine_min'] for r in ranks):.7f} against "
        f"the one-process {p}-slot ring (bitwise {[r['train']['bitwise_one_process'] for r in ranks]}); loss "
        f"{t0_['loss']:.6f} (one process {t0_['loss_one_process']:.6f}); per rank {t0_['launches']['flash_chunk_fwd']} "
        f"K7a, {t0_['launches']['flash_chunk_bwd_dq']} K7b, {t0_['launches']['flash_chunk_bwd_dkv']} K7c; collectives "
        f"{t0_['collectives']}; step s {[round(r['train']['step_s'], 3) for r in ranks]}; peak "
        f"{[round(r['train']['peak_gib'], 2) for r in ranks]} GiB; {[round(r['train']['sub_s'], 1) for r in ranks]} s")

    # 16d
    for r in four:
        want = {name: 0 for name in r["launches"]}
        want["flash_chunk_fwd"] = RING_RANK_STEPS * n * 2
        check(r["launches"] == want, f"16d rank {r['rank']}: launches {r['launches']}, expected {want}")
        check(r["finite"] and r["same_on_every_rank"] and r["shape"][0] == 4, f"16d rank {r['rank']}: {r}")
    cos = four[0]["row_cosines"]
    check(min(cos) >= MESH_COS, f"16d: data rows' cosines {cos} against the one-rank run")
    log(f"16d (data 2, seq 2) ring denoise (4 ranks, depth {RING_RANK_DEPTH}, 1024 px, B=4, 2 a data row, "
        f"{RING_RANK_STEPS} steps): data rows' cosine {[round(c, 6) for c in cos]} against the one-rank K1 run "
        f"(min {MESH_COS}); latents bitwise equal on every rank; per rank {four[0]['launches']['flash_chunk_fwd']} "
        f"K7a; s/step {[round(r['s_per_step'], 3) for r in four]}; peak {[round(r['peak_gib'], 2) for r in four]} GiB; "
        f"{[round(r['sub_s'], 1) for r in four]} s")
    res = {"ranks": p, "backend": "gloo", "attention": [r["attention"] for r in ranks],
           "denoise": [r["denoise"] for r in ranks], "train": [r["train"] for r in ranks], "data_seq": four,
           "two_rank_launch_s": two_s, "four_rank_launch_s": four_s, "phase_s": time.perf_counter() - t_phase}
    log(f"phase 16: {res['phase_s']:.1f} s (launches {two_s:.1f} s and {four_s:.1f} s); {card}")
    return res


# -- phase 17: ControlNet residuals and the condition preprocessors -------------


def controlnet_phase(torch, pipe) -> dict:
    """Phase 17 on the bf16 pipeline: a 1024 px DiT forward (B=2) under
    "pallas" with seeded ControlNet residuals (CN_HOOKS hooks) against the
    same forward without them (all-zero residuals: bitwise) and against
    "xla" (non-zero: cosine >= CN_COS); a conditioned `generate` (1024 px,
    512 px condition, image CFG, STEPS steps) whose condition is the port's
    `canny` of a seeded 512^2 image, launches counted around it; and the
    three preprocessors' host milliseconds on a 1024^2 image."""
    import numpy as np

    from reflectionflow_tpu_torch.models.flux.rope import make_image_ids, make_text_ids
    from reflectionflow_tpu_torch.sampler.condition import PREPROCESSORS, Condition, cot_position_delta

    t_phase = time.perf_counter()
    cfg_d = pipe.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(pipe.dtype)

    ty = tx = 2 * LT // 16
    x = {"img": randn(2, ty * tx, cfg_d.in_channels), "txt": randn(2, LT, cfg_d.text_dim),
         "pooled": randn(2, cfg_d.pooled_dim), "timestep": torch.tensor([0.7, 0.3], device="cuda"),
         "img_ids": torch.from_numpy(make_image_ids(ty, tx)).cuda(),
         "txt_ids": torch.from_numpy(make_text_ids(LT)).cuda(),
         "guidance": torch.full((2,), 3.5, device="cuda")}
    nd_h, ns_h = CN_HOOKS
    with torch.no_grad():
        plain = pipe.dit(**x, attn_impl="pallas")
        hidden_scale = float(pipe.dit.x_embedder(x["img"]).float().std())
        res_d = randn(nd_h, 2, ty * tx, cfg_d.hidden_size, scale=0.1 * hidden_scale)
        res_s = randn(ns_h, 2, ty * tx, cfg_d.hidden_size, scale=0.1 * hidden_scale)
        zeros = pipe.dit(**x, attn_impl="pallas", controlnet_block_samples=torch.zeros_like(res_d),
                         controlnet_single_block_samples=torch.zeros_like(res_s))
        counters = zero_counts()
        hooked = pipe.dit(**x, attn_impl="pallas", controlnet_block_samples=res_d,
                          controlnet_single_block_samples=res_s)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        dense = pipe.dit(**x, attn_impl="xla", controlnet_block_samples=res_d, controlnet_single_block_samples=res_s)
    n_blocks = cfg_d.num_double_blocks + cfg_d.num_single_blocks
    want = {name: 0 for name in launches}
    want["flash_fwd"] = n_blocks
    check(launches == want, f"17: ControlNet forward launches {launches}, expected {want}")
    check(torch.equal(zeros, plain), "17: all-zero ControlNet residuals changed the forward")
    cos, moved = _cosine(hooked, dense), _cosine(hooked, plain)
    check(bool(torch.isfinite(hooked).all()) and cos >= CN_COS,
          f"17: ControlNet forward under pallas against xla: cosine {cos:.6f} (min {CN_COS})")
    del plain, zeros, hooked, dense, res_d, res_s
    torch.cuda.empty_cache()

    # the preprocessors' host milliseconds on a 1024^2 image, then a canny-conditioned generate
    rng = np.random.default_rng(17)
    big = np.repeat(np.repeat(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), 32, 0), 32, 1)
    names = ("canny", "coloring", "deblurring")
    for name in names:
        PREPROCESSORS[name](big)  # the first call imports what it needs
    host_ms = _median_ms({name: (lambda n=name: PREPROCESSORS[n](big)) for name in names}, 5)
    small = np.repeat(np.repeat(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), 32, 0), 32, 1)
    cond = Condition("canny", small, cot_position_delta(LT))
    edges = cond.preprocess()
    check(edges.shape == small.shape and int((edges > 0).sum()) > 0, "17: canny found no edge on the seeded image")
    counters = zero_counts()
    t0 = time.perf_counter()
    lat = pipe.generate(["a photo of a red cube"], height=2 * LT, width=2 * LT, num_inference_steps=STEPS,
                        conditions=[cond], image_guidance_scale=IMAGE_CFG, output_type="latent", seed=17)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: 0 for name in gen_launches}
    want["flash_fwd"] = STEPS * n_blocks
    check(gen_launches == want, f"17: canny-conditioned generate launches {gen_launches}, expected {want}")
    check(tuple(lat.shape) == (1, ty * tx, cfg_d.in_channels) and bool(torch.isfinite(lat).all()),
          "17: canny-conditioned generate gave bad latents")
    res = {"hooks": list(CN_HOOKS), "cosine_xla": cos, "cosine_without": moved, "launches": launches,
           "generate_launches": gen_launches, "generate_s": gen_s, "edge_pixels": int((edges[..., 0] > 0).sum()),
           "host_ms_1024": host_ms, "phase_s": time.perf_counter() - t_phase}
    log(f"17 ControlNet (1024 px, B=2, {nd_h} double + {ns_h} single hooks, pallas): zero residuals bitwise the "
        f"plain forward; cosine {cos:.6f} against xla (min {CN_COS}), {moved:.6f} against the forward without "
        f"them; {launches['flash_fwd']} K1; canny-conditioned generate (1024 px, 512 px condition of "
        f"{res['edge_pixels']} edge pixels, image CFG {IMAGE_CFG}, {STEPS} steps) {gen_s:.2f} s, "
        f"{gen_launches['flash_fwd']} K1; preprocessors on 1024^2 (host ms, median of 5): "
        f"{json.dumps({k: round(v, 2) for k, v in host_ms.items()})}; phase 17 {res['phase_s']:.1f} s")
    return res


def _dit_cfg():
    from reflectionflow_tpu_torch.config import FluxDiTConfig

    return FluxDiTConfig()


def kernel_entry(name, source, replaces, launches, res, main_shape, other_shape):
    return {"name": name, "route": "cuda", "source": f"reflectionflow_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": res["err"],
            **res["by_shape"][main_shape], "shape": main_shape,
            "t2i_shape": {"shape": other_shape, **res["by_shape"][other_shape]},
            **{k: v for k, v in res.items() if k not in ("err", "by_shape")}}


def main() -> int:
    import torch

    card = device_phase(torch)
    sys.path.insert(0, REPO)
    from reflectionflow_tpu_torch.ops import kernel_build

    from concurrent.futures import ThreadPoolExecutor

    from reflectionflow_tpu_torch.utils import image_io, native

    t_start = t0 = time.perf_counter()

    def build_host():
        t1 = time.perf_counter()
        kernel_build.build_host_all([image_io.SOURCE, native.SOURCE])
        return time.perf_counter() - t1

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(build_host)
        kernel_build.build_all()
        host_build_s = host.result()
    log(f"build {', '.join(kernel_build.SOURCES)} (in parallel): {time.perf_counter() - t0:.2f} s; "
        f"host libraries image_io.cpp and genref_loader.cpp (g++, beside them): {host_build_s:.2f} s")
    ptxas = {src: kernel_build.ptxas_report(src) for src in kernel_build.SOURCES}
    log(json.dumps({"ptxas": ptxas}))
    hopper_sass = hopper_check(kernel_build, ptxas)
    fused_build = fused_check(kernel_build, ptxas)
    threefry_phase(torch)
    err_out, err_lse, k1_times = k1_phase(torch)
    k6 = k6_phase(torch)
    t0 = time.perf_counter()
    k7 = k7_phase(torch)
    t_k7 = time.perf_counter() - t0
    log(f"K7 phase (3c): {k7['cases']} chunk cases ({k7['bitwise_cases']} with K7b's and K7c's second "
        f"launches) in {t_k7:.1f} s")
    check(k7["bitwise_cases"] > 0, "K7b's and K7c's second launches were not checked")
    fused = fused_phase(torch)
    serving_attn = serving_attn_phase(torch)
    pipe, bf16_launches, bf16_calls, bf16_peak = bf16_phase(torch)
    training = train_phase(torch, pipe)
    adapters = training.pop("adapters")
    genref = genref_phase(torch, pipe, card, host_build_s)
    validation = validation_phase(torch, pipe, adapters)
    t0 = time.perf_counter()
    ring = ring_phase(torch, pipe)
    t_ring = time.perf_counter() - t0
    log(f"ring phase (5d): {t_ring:.1f} s")
    controlnet = controlnet_phase(torch, pipe)
    w8_launches, w8_calls, w8_peak, cond_gib, prof, ragged = w8a8_phase(torch, pipe, adapters)
    del adapters
    corrector = corrector_phase(torch, pipe)
    reflection = reflection_phase(torch, pipe)
    snapshot = snapshot_phase(torch)
    round_models = reflection_models_phase(torch, pipe)
    nvila = nvila_phase(torch, pipe)
    vcache = vcache_phase(torch, pipe)
    rm_train = rm_train_phase(torch, card)
    del pipe  # phase 14's ranks share the card: the parent keeps no model (the phases'
    gc.collect()  # generate wrappers leave reference cycles through the pipeline)
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch, card)
    mesh_train = mesh_train_phase(torch, card, [r["w8a8"] for r in mesh["tp"]])
    ring_ranks = ring_ranks_phase(torch, card)
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
        "launches_genref": genref["launches"]["flash_fwd"],
        "launches_snapshot": {"bf16": snapshot["launches_bf16"]["flash_fwd"],
                              "w8a8": snapshot["launches_int8"]["flash_fwd"]},
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
            "launches_genref": genref["launches"][name],
            "max_abs_err": k6[key]["err"], "rel_err": k6[key]["rel"],
            "ms": at[train_shape][key]["ms"], "plain_ms": at[train_shape]["plain_ms"],
            "bound_ms": at[train_shape][key]["bound_ms"], "bound_by": at[train_shape][key]["bound_by"],
            "bound_share": at[train_shape][key]["bound_share"], "library_ms": at[train_shape]["library_ms"],
            "serving_shape": {"ms": at[serve_shape][key]["ms"], "plain_ms": at[serve_shape]["plain_ms"],
                              "bound_ms": at[serve_shape][key]["bound_ms"],
                              "bound_share": at[serve_shape][key]["bound_share"],
                              "library_ms": at[serve_shape]["library_ms"]},
        })
    for name, _, source, _, replaces in KERNELS:
        r = fused[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"reflectionflow_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": w8_launches[name],
            "launches_ragged": ragged["launches"][name], "launches_round": reflection["launches"][name],
            "max_abs_err": r["err"], "launches_snapshot": snapshot["launches_int8"][name],
            **({"launches_round_models": round_models["launches"][name]} if name != "norm_rope" else {}),
            **{k: r[k] for k in ("scale_rel_err", "mismatch_frac", "rowquant_same_view_ms") if k in r},
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "gbps": r["gbps"], "by_shape": r["by_shape"], **fused_build[name],
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
            **({k: at[k] for k in ("k6a_same_chunk_ms", "k6a_same_chunk_device_ms")} if key == "dq" else {}),
            # phase 16, per rank (rank 0's; the checks hold every rank's)
            "launches_ring_ranks": {"attention_fwd_bwd": ring_ranks["attention"][0]["cases"][0]["launches"][name],
                                    "denoise": ring_ranks["denoise"][0]["launches"][name],
                                    "train": ring_ranks["train"][0]["launches"][name],
                                    "data_seq_denoise": ring_ranks["data_seq"][0]["launches"][name]},
        })
    corr_shape, t2i_shape = f"B=2 L={LT + LI + LC}", f"B=2 L={LT + LI}"
    for name, source, line, impl in (("flash_fwd_int8", "flash_fwd_int8.cu", 234, "pallas_int8"),
                                     ("flash_fwd_nr", "flash_fwd_nr.cu", 313, "pallas_nr")):
        kernels.append(kernel_entry(name, source, f"{PA}:{line}", corrector[impl]["launches"][name],
                                    serving_attn[name], corr_shape, t2i_shape))
    kernels[0]["by_shape"][f"B={K1_PRESET[0]} L={K1_PRESET[1]}"] = nvila["k1_preset"]
    kernels[0]["launches_controlnet"] = {"forward": controlnet["launches"]["flash_fwd"],
                                         "canny_generate": controlnet["generate_launches"]["flash_fwd"]}
    for k in kernels:
        k["launches_round_nvila"] = nvila["round"]["launches"][k["name"]]
    for k in kernels:
        k["launches_vcache_static"] = vcache["static"]["launches"][k["name"]]
        k["launches_vcache_teacache"] = vcache["teacache"]["launches"][k["name"]]
        k["launches_round_teacache"] = vcache["teacache"]["round"]["launches"][k["name"]]
        k["launches_vcache_module"] = vcache["module"]["launches"][k["name"]]
        k["launches_nf4"] = vcache["nf4"]["launches"][k["name"]]
        k["launches_rm_train"] = rm_train["int8"]["launches"][k["name"]] + rm_train["nf4"]["launches"][k["name"]]
        for sub in ("tp", "dp", "round"):  # per rank: rank 0's (the checks hold every rank's)
            k[f"launches_mesh_{sub}"] = mesh[sub][0]["launches"][k["name"]]
        k["launches_mesh_quant_tp"] = mesh["tp"][0]["w8a8"]["launches"][k["name"]]
        for sub in ("tp", "dp"):  # phase 15's training, per rank (15b at MESH_TP_DEPTH)
            k[f"launches_mesh_train_{sub}"] = mesh_train[sub][0]["launches"][k["name"]]
    k9 = next(k for k in kernels if k["name"] == "flash_fwd_nr")
    k9["launches_round"] = reflection["launches"]["flash_fwd_nr"]
    k9["launches_round_models"] = round_models["launches"]["flash_fwd_nr"]
    log(json.dumps({"train": {k: training[k] for k in ("s_per_step", "peak_gib", "profile_ms",
                                                       "grad_cosine_min", "grad_cosine")},
                    "validation_hook": validation}))
    log(json.dumps({"genref_data": genref}))
    log(json.dumps({"reflection_round": reflection}))
    log(json.dumps({"snapshot_load": snapshot}))
    log(json.dumps({"reflection_round_models": round_models}))
    log(json.dumps({"nvila_round": nvila}))
    log(json.dumps({"vcache_nf4": vcache}))
    log(json.dumps({"rm_train": rm_train}))
    log(json.dumps({"mesh": mesh}))
    log(json.dumps({"mesh_train": mesh_train}))
    log(json.dumps({"ring_ranks": ring_ranks}))
    log(json.dumps({"controlnet": controlnet}))
    log(json.dumps({"ring": {"attention": ring["attention"],
                             "train": {k: ring["train"][k] for k in ("s_per_step", "peak_gib", "launches",
                                                                      "grad_cosine_min", "grad_cosine")},
                             "denoise": ring["denoise"]}}))
    total = time.perf_counter() - t_start
    log(card)  # again beside the summary lines, which a log's tail keeps
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
