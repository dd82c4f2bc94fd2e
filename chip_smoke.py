#!/usr/bin/env python3
"""Run the PyTorch port of DiffMa on one NVIDIA GPU and check what it gives.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc. It
needs neither JAX nor the JAX package, PyYAML or PIL. Phases:

1. build: compile every CUDA kernel of the sampling and training paths from
   ``csrc/``, one nvcc process per source, all at once;
2. kernels: kernel A (the selective scan) and kernel C (the fused Mamba-1
   mixer) each against its plain PyTorch version on the card, at the shapes
   the DiffMa-B/2 sampler gives them (2a, 2b; A also at the training batch
   G = 24, at one step, at 9 steps, fewer than its chunks allow, at a wide
   decay span and in bf16 with the most chunks), and their backward kernels B
   and D against theirs at the training shapes, batch 8 (2c, 2d; B also at
   1, 16 and 17 steps, a wide span and both bf16 delta types, each case
   twice with equal bits, and its device ms by stage), with times and
   bounds; kernel E (the fused Mamba-2 mixer: single, dual and prologue
   modes, 196 and 25 tokens, a finite dt_limit, a wide decay span) and
   kernel G (the Spiral block's tail: batch 1, 2 and 8, 196 and 25 tokens,
   each twice with equal bits; its device busy ms by stage beside its event
   ms at batch 1 and 8) against theirs, and the Mamba-2 block on its three
   routes (2e, 2f); kernel F (the fused Mamba-2 mixer's
   backward) against its plain version at the training shapes, batch 8:
   single and dual, 196 and 25 tokens, a dt_limit that clips some steps, a
   wide decay span, twice in a row; and kernel E's residual mode against its
   plain mode, bit for bit (2g); kernel H (the Mamba-1 mixer's inner part)
   against its plain version, values and gradients, at the shapes of the
   DiffMa-B/2 streams at batch 1 and 8, ragged lengths and dt_bias near -2
   and +2, with its device ms by stage and two bounds (2h); kernel C's one-mixer form on the vim quirk, on
   EfficientVMamba's partition, on one stream (zig) and four (vmamba) (2i);
   kernel E on the partition (2j); kernel D's vim and partition branches
   (2k) and kernel F's partition branch (2l) against their plain versions,
   every gradient tensor, at 196 tokens and at 25 (the vim quirk) or streams
   of 25 steps (the partition); kernel P (the split SSD probe's core) against
   its plain version at zx (48, 196, 2096) and (6, 196, 2096), each twice with
   equal bits, with D and norm_w off one, at a wide decay span and at 25
   steps, the probe's split form against whole kernel E, and the times of P
   (by kernel), of E's SSD and gate stages inside E and of whole E (2m); the probe's entry point,
   ``tools/probes/probe_split_ssd_torch.py``, as it runs by default, bf16
   then fp32, 52 calls of each form in each dtype (2n, whose bf16 half is
   24d);
3. forward: one full-width DiffMa-B/2 forward through the plain scan,
   through kernel A (``scan_impl="pallas"``) and through kernel C
   (``scan_impl="fused"``), with the same random weights; 3b: one
   full-width DiffMa-B/2 training step (loss and every parameter's gradient)
   through the plain path, through kernels A + B and through kernels C + D;
   3c: the Mamba-2 DiffMa-B/2 forward on its three routes (composable, dual
   kernel E, ``fuse_block``: kernel E in prologue mode + kernel G), with
   the device kernels per forward and the idle share of each; 3d: one
   full-width Mamba-2 DiffMa-B/2 training step on the same three routes
   (torch autograd; kernels E + F; ``fuse_block``: kernels E + G forward,
   the recomputing backward through E + F); 3e: ``Mamba`` on a hand-made
   scan spec that kernel C cannot run (the four atrous streams and their
   reverses), which takes kernel H: against the plain route at batch 1 and
   8, then 2000 forwards at batch 1 (a DDPM-250 chain's worth for 8 blocks),
   2000 kernel H calls and no kernel C call; 3f: one full-width forward of
   ZigMa-, ViM-, VMamba-, EMamba- and DiT-B/2, on Mamba-1 and (not DiT) on
   Mamba-2, fused route against the plain one, 8 kernel C or E calls each
   (none for DiT), with the device kernels per forward and the idle share;
   3g: one full-width training step at batch 2 of ViM-B/2 and EMamba-B/2
   (8 C + 8 D calls) and EMamba-B/2 on Mamba-2 (8 E + 8 F), fused route
   against the plain one, loss and every parameter's gradient;
4. composable sampler: ``diffma_tpu_torch.train.sample.main`` on
   ``configs/brain.yaml`` with DiffMa-B/2, ``scan_impl="pallas"``, DDPM-250,
   1 batch of 1 image, synthetic conditioning;
5. fused sampler: the same with ``scan_impl`` left to its default, 2 batches;
6. checkpoint: a reference-format checkpoint of seeded DiffMa-L/2 weights,
   sampled by the sampler's CLI on ``configs/brain.yaml`` as it is, 1 batch;
7. trainer: the trainer's CLI on ``configs/brain.yaml`` as it is (DiffMa-L/2,
   batch 8, synthetic batches), 20 steps on the default (fused) path, with a
   checkpoint at step 20 that the sampler's loader reads back;
8. composable trainer: DiffMa-B/2, batch 8, 5 steps through kernels A + B;
9. learning: DiffMa-B/2 on the fused path trained 100 steps on one fixed
   batch; the loss's MSE term at a fixed (t, noise) must fall at least 2x;
10. Mamba-2 sampler: the sampler's CLI on ``configs/brain.yaml`` with
    ``--model DiffMa-B/2 --use-mamba2`` and a reference-format checkpoint of
    seeded weights, DDPM-250, 2 batches of 1 on the default (fused) route:
    2000 kernel E calls per image;
11. block-fused Mamba-2 sampler: the same checkpoint loaded into a model
    built with ``fuse_block=True`` and handed to the sampler's loop, same
    seed, 1 batch: 2000 kernel E and 2000 kernel G calls, and an image that
    agrees with phase 10's first;
12. Mamba-2 trainer: the trainer's CLI on ``configs/brain.yaml
    --use-mamba2`` (DiffMa-L/2, batch 8, synthetic batches), 20 steps on the
    default (fused) path: 320 kernel E and 320 kernel F calls; its
    checkpoint at step 20 sampled back by the sampler's CLI with
    ``--use-mamba2`` (DDPM-250, 1 image, 4000 kernel E calls);
13. Mamba-2 learning: DiffMa-B/2 with ``use_mamba2`` on the fused path
    trained 100 steps on one fixed batch; the MSE term must fall at least 2x;
14. family samplers: the sampler's CLI on ``configs/brain.yaml`` with
    ``--model`` and a reference-format checkpoint of seeded weights, DDPM-250,
    1 image each: ViM-B/2 and EMamba-B/2 (2000 kernel C calls each),
    VMamba-BL/2 (depth 13: 3250), EMamba-B/2 and ZigMa-B/2 with
    ``--use-mamba2`` (2000 kernel E calls each), DiT-SB/2 (no kernel call);
15. family trainers: VMamba-B/2, batch 8, 5 steps on the fused path (40
    kernel C and 40 kernel D calls); ViM-B/2 with ``scan_impl: auto``, 5
    steps (40 kernel A and 40 kernel B calls); then the trainer's CLI on the
    fused route, batch 8, 5 steps each: ViM-B/2 and EMamba-B/2 (40 C + 40 D
    calls, no A or B) and EMamba-B/2 ``--use-mamba2`` (40 E + 40 F);
16. learning: ViM-B/2 on the fused path trained 100 steps on one fixed
    batch; the MSE term must fall at least 2x;
17. the conditioning stack and real data: (17a) ``Conditioning`` at full
    width (SD-VAE, BiomedCLIP ViT-B/16 at 224², the CT encoder 28 x 28 x 4,
    patch 2, 512 wide) on seeded weights, the card's ``z``, ``y``, ``y2`` and
    ``w`` against the same module's on the CPU with the same noise, and the
    ms per call at batch 8 of the VAE encode, CLIP, the CT encoder and the
    whole encode beside an fp32 bound; (17b) SynthRAD-like ``.npy`` folders
    (64 train and 4 val triplets of 256 x 256 float32 slices) laid out as
    ``configs/brain.yaml`` names them, in a temporary directory that the
    CLIs run in; (17c) the embedder's CLI on them, 10 steps at batch 32,
    whose checkpoint loads into a ``CTEncoder`` and becomes ``ct_ckpt``;
    (17d) the trainer's CLI on ``configs/brain.yaml`` (DiffMa-L/2, batch 8),
    20 steps on the folders, every batch encoded: 320 kernel C and 320
    kernel D calls, the encode span's ms per step; then 4 steps with
    ``--use-mamba2``: 64 E and 64 F calls; (17e) the sampler's CLI from 17d's
    checkpoint on the val folders, DDPM-250, 2 images decoded by the stack's
    VAE: 8000 kernel C calls, the grids written, PSNR and SSIM against the
    MRI;
18. the graphs: (18a) DiffMa-B/2's sampler on four routes (Mamba-1 fused:
    C; Mamba-2 dual: E; ``fuse_block``: E + G; composable: A), DDPM-250 at
    batch 1 and DDIM-50 at batch 1 and 2 (DDPM-250 at batch 2 is left out
    for the time limit), 2 batches each, with its chain as a CUDA graph
    against the eager loop on the same seed and weights: the images equal in
    bits (or within ``TOL_IMAGE``), the launches counted through the
    replays, the seconds a batch both ways with the capture's time and
    pool; then a DDIM-50 chain replayed under
    ``torch.cuda.set_sync_debug_mode("error")`` and both chains profiled
    (busy ms, idle share, kernels); (18b) DiffMa-L/2's training step at
    batch 8, Mamba-1 fused (C + D) and Mamba-2 fused (E + F), 20 steps with
    a NaN batch at step 10, graphed against eager under the sync check: the
    NaN step leaves every parameter, EMA and optimizer tensor and the step
    count as they were, the graphed params and EMA within ``TOL_STEP`` of
    the eager ones; then both steps profiled and timed in turns, and the
    real-data step (batches encoded by the conditioning stack) likewise;
19. bf16, the JAX package's ``--autocast`` model: (19a) the bf16 variants
    of kernels C and D against their bf16 plain versions, each case twice
    with equal bits: C dual at the B/2 sampler's shape (batch 1) and the
    training batch 8, and its one-mixer forms on the vim quirk, the
    EfficientVMamba partition and zig; D on the same forms at batch 8 (zig
    2), every gradient tensor; event ms, device ms by stage (torch.profiler
    in a process of its own, ``--bf16-stages``, as for 20a, 24a and 24c: the
    smoke's process loses kernel records as it ages) and a bound at the
    bf16 rate beside the fp32 variants' ms from phases 2b and 2d;
    (19b) the trainer's CLI on ``configs/brain.yaml --autocast`` as phase 7
    runs it (DiffMa-L/2, batch 8, 20 steps: 320 bf16 C and 320 bf16 D
    calls, none of the fp32 ones), its checkpoint fp32, its ms a step
    beside phase 7's; (19c) the sampler's CLI with ``--model DiffMa-B/2
    --autocast`` from a checkpoint of seeded weights, DDPM-250, 2 images
    (4000 bf16 C calls), each equal in bits to the eager loop's, and its
    PSNR against the fp32 model's image from the same seed (reported,
    not held to a bar); (19d) DiffMa-B/2 in bf16 on the fused route trained
    100 steps on one batch, the MSE term falling at least 2x; (19e) the
    graphed L/2 bf16 step profiled (busy ms, idle share, top kernels)
    beside phase 18b's fp32 step.
20. bf16 on the Mamba-2 mixers (``--use-mamba2 --autocast``): (20a) the
    bf16 variants of kernels E, F and G against their bf16 plain versions,
    each case twice with equal bits: E dual at batch 1 and 8, on the
    EfficientVMamba partition, zig and 256 tokens, E in prologue mode and G
    at batch 1 and 8 from a bf16 block's adaLN chunks, F on the dual,
    partition, zig and 256-token forms, every gradient tensor (streams of
    196 and 256 steps: longer than the kernels' 64-step chunk); event ms,
    device ms by stage (``--bf16-stages``) and a bound with every product at the bf16 rate
    beside the fp32 variants' ms from phases 2e, 2f and 2g; (20b) the trainer's
    CLI on ``configs/brain.yaml --use-mamba2 --autocast`` as phase 12 runs
    it (320 bf16 E and 320 bf16 F calls, none of the fp32 ones; its
    checkpoint fp32, sampled back with 4000 bf16 E calls); (20c) the
    sampler's CLI ``--model DiffMa-B/2 --use-mamba2 --autocast``, DDPM-250,
    2 images (4000 bf16 E calls), graphed equal to eager in bits, PSNR
    against fp32; (20d) a bf16 ``fuse_block`` B/2 sampler built as phase 11
    builds it (2000 bf16 E and 2000 bf16 G calls), its image's PSNR against
    20c's; (20e) a bf16 Mamba-2 DiffMa-B/2 trained 100 steps on one batch,
    the MSE term falling at least 2x.
21. resume, remat and the rest of the diffusion API: (21a) the trainer's
    CLI on ``configs/brain.yaml`` (DiffMa-L/2, batch 8, graphed, C + D),
    10 steps with a checkpoint every 5, against 5 steps and
    ``--resume-from`` that run's checkpoints for 5 more: parameters, EMA,
    AdamW's state and the step count equal in bits, the two step-5
    checkpoints equal, 160 or 80 C and D calls a run; the restore's
    seconds and each run's ms a step; (21b) the 10-step run with ``remat:
    true``: losses and state equal in bits to 21a's, 32 C and 16 D calls a
    step; the memory a forward keeps for the backward, the peak memory and
    the graphed step's ms with and without ``remat``; (21c) DiffMa-B/2
    through kernel C against the plain scan (its denoiser calls replayed as
    CUDA graphs), batch 2: a ``forward_with_cfg``-guided DDIM-50 chain (400
    C calls), ``calc_bpd_loop`` on a 250-step respacing (2000) and 50
    ``ddim_reverse_sample`` steps with DDIM-50 back (800), each within
    ``TOL_MODEL`` of the plain scan's, with their seconds. Nothing in it
    is caught: a failure exits non-zero.
22. decode, the associative scan and the plumbing: (22a) at DiffMa-B/2's
    mixer width (d_model 512, d_inner 1024, d_state 16, conv 4; Mamba-2
    headdim 64), batch 8, 196 tokens, ``models/decode.py``'s
    ``mamba_step`` iterated over the tokens against ``Mamba`` on an
    identity spec through kernel C (``scan_impl="fused"``) and kernel A
    (``"auto"``), and ``mamba2_step`` against ``Mamba2`` through kernel E,
    within ``TOL_DECODE``, one launch of each kernel and none in the steps;
    then one step captured as a CUDA graph over static cache buffers and
    replayed once per token, outputs and caches equal to the eager loop's
    in bits; the ms a token eager and graphed; (22b)
    ``selective_scan(impl="assoc")`` at G=24, L=196, d=1024, n=16 against
    kernel A within ``TOL_FP32``, both times and the assoc forward's peak
    memory; a DiffMa-B/2 training step's forward and backward at batch 8 on
    ``scan_impl: assoc`` (no kernel) against kernels A + B, its loss and
    every gradient within ``TOL_MODEL``, the ms and the peak memory of
    each; (22c) the native loader (``data/native.py``) built with g++,
    a batch of 8 at 224 from 224² files equal in bits to the Python path
    and from 256² files (the trainer's case) with its differences
    reported, host ms a batch on both paths; then
    ``tools/compute_metrics_torch.py``, PIL made unimportable, on phase
    17e's PNGs. Nothing in it is caught.

23. the parallel layer (``diffma_tpu_torch/parallel/``): ranks launched by
    ``python -m torch.distributed.run`` running this script with
    ``--parallel-worker``, over gloo (``DIFFMA_DIST_BACKEND=gloo``), every
    rank on cuda:0; 4 ranks, then 2. (23a) ``enter``, ``psum_out``,
    ``psum_mid`` and ``all_gather`` on CUDA tensors at world 4 and 2, values
    and gradients exact; (23b) both mixers at DiffMa-B/2 width (hidden 512,
    196 tokens, spiral, batch 8) at tp 2, sp 2 and tp 2 x sp 2 against the
    one-process composable mixer on the card, the output within
    ``TOL_FP32`` and every gradient within ``TOL_GRAD`` on every rank,
    kernels A and B once each a rank at Mamba-1's tp 2 and no kernel
    elsewhere; (23c) the trainer's CLI on ``configs/brain.yaml`` at dp 2,
    3 steps, Mamba-1 (48 C + 48 D calls a rank) and ``--use-mamba2`` (48 E +
    48 F), rank 0's checkpoint within ``TOL_STEP`` of one process fed both
    ranks' rows; (23d) the trainer's CLI with ``--model DiffMa-B/2 --tp 2``,
    3 steps, Mamba-1 (48 A + 48 B a rank) and ``--use-mamba2`` (no kernel),
    against one process at ``tests/test_parallel.py``'s 5e-3; (23e) a NaN in
    one rank's rows: both ranks skip, parameters and EMA equal in bits;
    (23f) the sampler's CLI at dp 2, DiffMa-B/2, DDPM-250, graphed on each
    rank (2000 C calls a rank), each rank's image equal in bits to one
    process on its shard; each rank's eager dp step ms and gloo's all-reduce
    ms of the L/2 gradient's size. Nothing in it is caught.

24. the last bf16 variants and the import tool: (24a) kernel H in bf16
    against its bf16 plain version (the TPU kernel's rounding) at the
    atrous streams' (8, 49) and the training batch's (24, 196), d 1024,
    at H and P bf16's bars (``TOL_HP_BF16``, ``TOL_HP_BF16_MEAN``), twice
    with equal bits, with its device ms by stage (torch.profiler in a
    process of its own, ``--bf16-stages``) and a bound at the bf16 rate
    beside phase 2h's fp32 times; (24b)
    the bf16 ``Mamba(512)`` on the doubled-atrous spec at batch 8, forward
    and backward against the plain route (every gradient within 1e-2
    mean-rel; one bf16 H, one A and one B launch, no C), then 2000 bf16
    forwards at batch 1 (2000 bf16 H calls); (24c) kernel P in bf16
    against its bf16 plain version on the probe's zx (48, 196, 2096) and
    at 25 steps, at the same bars, twice with equal bits, times and stages
    as 24a's beside phase 2m's; (24d) the probe's entry point at bf16 runs
    in phase 2n; (24e) ``tools/validate_imports_torch.py``
    on seeded full-width stand-ins of the SD-VAE, BiomedCLIP, CT-encoder and
    DiffMa-B/2 files in the upstream layouts: exit 0 with the forwards on
    the card, exit 1 with one ``FAIL`` line on a CT checkpoint without a key
    and on a DiffMa checkpoint with a wrongly shaped tensor. Nothing in it
    is caught.
25. the training step's optimizer update (``csrc/masked_adamw.cu``): (25a)
    the kernel against its plain version at DiffMa-L/2's parameter shapes,
    Mamba-1 and Mamba-2, every seventh tensor taking the EMA alone and the
    largest off 16-byte alignment (at most ``MAX_ADAMW_ULPS`` apart, and
    mean-rel at ``TOL_ADAMW_MEAN`` in each of p, m, v, the steps and the
    EMA), a call with ``keep`` false that writes nothing, each timed as a
    CUDA graph
    beside its bound (36 bytes a parameter), its plain version and torch's
    ``_fused_adamw_`` with ``found_inf`` plus a foreach EMA (a yardstick the
    port never calls); (25b) the L/2 Mamba-1 step graphed and eager over 4
    batches, the third NaN: the NaN step leaves every tensor in bits, the
    two runs end equal in bits, one update launched a step. Phase 18b also
    counts one update a step. Alone: ``c.phase_build();
    c.phase_masked_adamw(card); c.phase_masked_adamw_step(card)``.

Each sampler and trainer phase sets the kernels' counts to 0 just before it
and checks them just after: every kernel of the path ran, as often as the
path says. The sampler's and the trainer's CLIs run their chains and steps
as CUDA graphs (``diffma_tpu_torch/utils/graphs.py``), whose replays add to
each kernel's count what their capture recorded.

The third line from the end is a JSON object with one entry per kernel (the
nine kernels, then the bf16 variants of C, D, E, F, G, H and P, then the
masked AdamW + EMA update at both configurations' shapes), the second
the card's name and power limit, the last ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before those lines are printed.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate, fp32 outside the tensor cores,
# and TF32 on them (dense). Kernels C and D do their products in 3xTF32, three
# TF32 products for each, so at a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # dense, on the tensor cores: the bf16 variants' GEMM products (C, D, E, F, G)

# The kernel's stated tolerances against its plain version.
TOL_FP32 = 1e-4  # rtol = atol; fp32 sums in another order than the plain loop
TOL_BF16 = 2e-2  # rtol = atol, compared in fp32; the output is rounded to bf16
# Gradients, per tensor: max |err| <= TOL_GRAD * max(1, max |ref|), the JAX
# package's gradient bar (tests/test_selective_scan.py). A whole model's
# gradients through 8 blocks: TOL_MODEL, the forward phase's bar.
TOL_GRAD = 2e-4
TOL_MODEL = 1e-3
# Two routes of one model through a whole DDPM-250 chain and the VAE decoder,
# same seed and weights: max |diff| <= TOL_IMAGE * max(1, max |image|). Each
# forward agrees to fp32 rounding (TOL_MODEL holds it); 250 steps feed the
# differences back in.
TOL_IMAGE = 1e-3
# A training step's parameters and EMA against another run of the same
# steps: max |diff| <= TOL_STEP * max(1, max |ref|), the JAX step bar
# (tests/test_torch_train.py::test_train_step_matches_jax).
TOL_STEP = 1e-5
# Kernels C and D in bf16 against their bf16 plain versions, which round at
# the same places: C max |err| <= TOL_C_BF16 * max(1, max |ref|) and
# mean-rel (mean |err| / mean |ref|) <= TOL_C_BF16_MEAN; D mean-rel <=
# TOL_D_BF16 per gradient tensor. A value near a bf16 rounding boundary
# rounds one way in one order of fp32 sums and the other way in another,
# an ulp (2^-8 relative) that the rest of the mixer carries on.
TOL_C_BF16 = 2e-2
TOL_C_BF16_MEAN = 5e-3
TOL_D_BF16 = 1e-2
# Kernels H and P in bf16 against their bf16 plain versions: max |err| <=
# TOL_HP_BF16 * max(1, max |ref|) (two bf16 ulps of the largest element) and
# mean-rel <= TOL_HP_BF16_MEAN. Both kernels round the same operands as their
# plain versions and keep the rest fp32, so only a rounding flipped by the
# order of fp32 sums parts them (H 6e-8 to 5e-7 mean-rel, P 3e-7 to 1.7e-6 on
# the card); a product that skips one of the rounds moves H 1.9e-5 (dt_proj)
# to 3.6e-4 (x_proj) and P 3e-5 (M) to 5e-5 (dt x) (PERF.md section 2).
TOL_HP_BF16 = 2.0**-6
TOL_HP_BF16_MEAN = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, windows: int = 5) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``windows``
    windows of the mean over back-to-back calls, with CUDA events around each
    window, so that the host's time between calls is hidden where the device
    is the slower."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_window = max(1, reps // windows)
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_window)
    return statistics.median(times)


def scan_inputs(G, L, d, n, dtype, delta_dtype, seed, wide=False):
    """Kernel A's inputs on the card: delta around -1, or, with ``wide``, dt
    of 30 to 60 against A of -50 to -100, a span dt |A| in the thousands over
    a chunk, where every cross-chunk decay underflows to 0."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=gen, device="cuda")

    def uniform(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=gen, device="cuda")

    return dict(
        u=r(G, L, d).to(dtype),
        delta=(uniform(30, 60, G, L, d) if wide else 0.5 * r(G, L, d) - 1.0).to(delta_dtype),
        A=-uniform(50, 100, d, n) if wide else -torch.exp(0.5 * r(d, n)),
        B=r(G, L, n).to(dtype),
        C=r(G, L, n).to(dtype),
        D=r(d),
        z=r(G, L, d).to(dtype),
    )


def scan_bound_ms(x) -> tuple[float, str]:
    """Least time for one scan on an H100: bytes (each input read once, the
    output written once) over the HBM rate, or operations over the fp32 rate
    (per state and step: exp, dt*A, 2 for the state update, 2 for C.h)."""
    G, L, d = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x.values() if t is not None)
    nbytes += x["u"].numel() * x["u"].element_size()  # out
    ops = G * L * d * (6 * n + 8)  # + softplus, D skip, gate per channel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from diffma_tpu_torch.ops import cuda_build

    print("== phase 1: build", flush=True)
    for name, res in cuda_build.build_all().items():
        print(f"built {os.path.relpath(res.path, ROOT)} in {res.seconds:.2f} s")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"  {line.strip()}")
        cuda_build.load(name)


def phase_kernels(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_cuda, selective_scan_ref

    print("== phase 2a: kernel A against its plain version on the card", flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, G, L, dtype, delta dtype, gated, wide span, tolerance
        ("fp32 gated (path)", 3, 196, f32, f32, True, False, TOL_FP32),
        ("fp32 ungated", 3, 196, f32, f32, False, False, TOL_FP32),
        ("fp32 gated, prime L=197", 3, 197, f32, f32, True, False, TOL_FP32),
        ("bf16 gated, fp32 delta", 3, 196, bf16, f32, True, False, TOL_BF16),
        ("bf16 gated, bf16 delta", 3, 196, bf16, bf16, True, False, TOL_BF16),
        ("bf16 ungated, prime L=13", 3, 13, bf16, bf16, False, False, TOL_BF16),
        ("fp32 gated, training batch G=24", 24, 196, f32, f32, True, False, TOL_FP32),
        ("fp32 gated, one step", 1, 1, f32, f32, True, False, TOL_FP32),
        ("fp32 gated, L=9: one chunk", 3, 9, f32, f32, True, False, TOL_FP32),
        ("fp32 gated, wide span", 3, 196, f32, f32, True, True, TOL_FP32),
        ("fp32 ungated, wide span", 3, 196, f32, f32, False, True, TOL_FP32),
        ("bf16 ungated, L=196: eight chunks", 3, 196, bf16, f32, False, False, TOL_BF16),
    ]
    path_err = None
    for i, (name, G, L, dtype, ddtype, gated, wide, tol) in enumerate(cases):
        x = scan_inputs(G, L, 1024, 16, dtype, ddtype, seed=i, wide=wide)
        if not gated:
            x["z"] = None
        got = selective_scan_cuda(**x)
        want = selective_scan_ref(**x)
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"selective_scan_fwd gave a wrong shape or a non-finite value: {name}")
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        print(f"  {name}: G={G} L={L} d=1024 n=16  max|err| {err:.3e}  (rtol=atol={tol:g}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"selective_scan_fwd disagrees with its plain version: {name}")
        if path_err is None:
            path_err = err

    times = {}
    for G in (3, 24):  # the sampler's streams at batch 1; the composable training step's
        x = scan_inputs(G, 196, 1024, 16, f32, f32, seed=0)
        bound_ms, bound_by = scan_bound_ms(x)
        times[G] = (cuda_ms(lambda: selective_scan_cuda(**x), reps=50),
                    cuda_ms(lambda: selective_scan_ref(**x), reps=5), bound_ms, bound_by,
                    stage_table(lambda: selective_scan_cuda(**x), SCAN_STAGES)["total"])
        print(f"  [{card}] selective_scan_fwd fp32 G={G} L=196 d=1024 n=16: "
              f"kernel {times[G][0]:.4f} ms (device busy "
              f"{times[G][4]:.4f}), plain {times[G][1]:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the selective scan")
    ms, plain_ms, bound_ms, bound_by, busy = times[3]
    return {
        "name": "selective_scan_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/selective_scan_fwd.cu",
        "replaces": "diffma_tpu/ops/selective_scan.py:229",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "busy_ms": busy,
        "G24": {"ms": times[24][0], "plain_ms": times[24][1], "bound_ms": times[24][2],
                "busy_ms": times[24][4]},
    }


def kernel_counters() -> dict:
    """Each mixer kernel's wrapper, whose ``launches`` counts its launches (a
    graph's replay adds what its capture recorded). The optimizer's update,
    ``masked_adamw``, runs once in every training step; phases 18b and 25
    count it."""
    from diffma_tpu_torch.utils.graphs import kernel_counters as counters

    return {name: c for name, c in counters().items() if name != "masked_adamw"}


def reset_counts() -> None:
    from diffma_tpu_torch.utils.graphs import kernel_counters as counters

    for counter in counters().values():
        counter.launches = 0


def check_counts(what: str, expect: dict) -> dict:
    counts = {name: counter.launches for name, counter in kernel_counters().items()}
    print("  launches: " + ", ".join(f"{k} {v} (expected {expect[k]})" for k, v in counts.items()))
    for name, n in counts.items():
        if n != expect[name]:
            fail(f"{what} ran {name} {n} times, not {expect[name]}")
    return counts


def grad_errors(got, want, tol: float):
    """(name, max |err|, bar) of each pair of gradients, the bar being
    tol * max(1, max |ref|); fails on a shape, a non-finite value or an error
    over its bar."""
    if set(got) != set(want):
        fail(f"gradients of {sorted(set(got) ^ set(want))} are missing on one side")
    rows = []
    for name, b in want.items():
        a = got[name]
        bar = tol * max(1.0, b.abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        if a.shape != b.shape or not bool(a.isfinite().all()) or err > bar:
            fail(f"gradient {name}: max |err| {err:.3e} over its bar {bar:.3e}, or bad values")
        rows.append((name, err, bar))
    return rows


def scan_bwd_bound_ms(x, g) -> tuple[float, str]:
    """Least time for one scan backward on an H100: its inputs (kernel A's and
    g) read once and its outputs (du, ddelta, dz, dB, dC, dA, dD) written
    once over the HBM rate, or its operations over the fp32 rate: the forward
    once (6n + 8 per channel and step, as kernel A's bound) and the adjoint
    (17 per state and step: the adjoint state, its decay, dA, ddelta, du, dB,
    dC; 12 per channel and step for the gate, the softplus and the D skip)."""
    G, L, d = x["u"].shape
    n = x["A"].shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in x.values() if t is not None)
    nbytes += g.numel() * g.element_size()
    nbytes += 4 * (G * L * d * (3 if x["z"] is not None else 2) + 2 * G * L * n + d * n + d)
    ops = G * L * d * ((6 * n + 8) + (17 * n + 12))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_scan_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.selective_scan import selective_scan_bwd_cuda, selective_scan_bwd_ref

    print("== phase 2c: kernel B (scan backward) against its plain version on the card",
          flush=True)
    f32, bf16 = torch.float32, torch.bfloat16
    names = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz")
    cases = [
        # name, G, L, dtype, delta dtype, gated, wide: G = 24 is batch 8 x 3 streams
        ("fp32 gated (path)", 24, 196, f32, f32, True, False),
        ("fp32 ungated", 24, 196, f32, f32, False, False),
        ("fp32 gated, prime L=197", 24, 197, f32, f32, True, False),
        ("bf16 gated, fp32 delta", 24, 196, bf16, f32, True, False),
        ("bf16 ungated, bf16 delta", 24, 196, bf16, bf16, False, False),
        ("fp32 gated, one step", 2, 1, f32, f32, True, False),
        ("fp32 gated, one chunk", 2, 16, f32, f32, True, False),
        ("fp32 ungated, a chunk and a step", 2, 17, f32, f32, False, False),
        ("fp32 gated, wide span", 3, 196, f32, f32, True, True),
    ]
    path_err = None
    for i, (name, G, L, dtype, ddtype, gated, wide) in enumerate(cases):
        x = scan_inputs(G, L, 1024, 16, dtype, ddtype, seed=10 + i, wide=wide)
        if not gated:
            x["z"] = None
        g = torch.randn(G, L, 1024, generator=torch.Generator(device="cuda").manual_seed(i),
                        device="cuda").to(dtype)
        first = selective_scan_bwd_cuda(**x, g=g)
        got = dict(zip(names, selective_scan_bwd_cuda(**x, g=g)))
        want = dict(zip(names, selective_scan_bwd_ref(**x, g=g)))
        torch.cuda.synchronize()
        for (n, a), b in zip(got.items(), first):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                fail(f"kernel B's {n} differs between two calls ({name})")
        if not gated:
            if got.pop("dz") is not None or want.pop("dz") is not None:
                fail("an ungated scan's backward gave a dz")
        rows = grad_errors(got, want, TOL_GRAD)
        err = max(e for _, e, _ in rows)
        print(f"  {name}: G={G} L={L} d=1024 n=16  max|err| per gradient "
              + ", ".join(f"{n} {e:.2e}/{b:.1e}" for n, e, b in rows) + "; two calls equal")
        if path_err is None:
            path_err = err

    x = scan_inputs(24, 196, 1024, 16, f32, f32, seed=10)
    g = torch.randn(24, 196, 1024, generator=torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    ms = cuda_ms(lambda: selective_scan_bwd_cuda(**x, g=g), reps=20)
    stages = stage_table(lambda: selective_scan_bwd_cuda(**x, g=g), SCAN_BWD_STAGES)
    plain_ms = cuda_ms(lambda: selective_scan_bwd_ref(**x, g=g), reps=5)
    bound_ms, bound_by = scan_bwd_bound_ms(x, g)
    print(f"  [{card}] selective_scan_bwd fp32 G=24 L=196 d=1024 n=16: kernel {ms:.4f} ms, "
          f"device busy {stages['total']:.4f} ms ({stage_line(stages)}), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    print("  library_ms: none; no single PyTorch call computes the scan's backward")
    return {
        "name": "selective_scan_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/selective_scan_bwd.cu",
        "replaces": "diffma_tpu/ops/selective_scan.py:323",
        "max_abs_err": path_err,
        "ms": ms,
        "busy_ms": stages["total"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def random_(module, seed: int, scale: float = 0.1):
    """Every parameter moved by seeded noise, A_log, D and the biases too: std
    ``scale`` for vectors, ``scale / sqrt(fan-in)`` for the others, so that
    activations stay of order 1."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = scale if p.dim() == 1 else scale / math.sqrt(p.shape[-1])
            p.add_(std * torch.randn(p.shape, generator=gen))
    return module


def mixer_work(M, B, L, h, d, n, r, S, K, Ls=None, quirk=False,
               act_bytes=4) -> tuple[int, int, int]:
    """One fused-mixer call of M branches: the operations of its products
    (in_proj, x_proj, dt_proj, out_proj), its other operations (conv, scan,
    D skip, gate) and the bytes that must move (the fp32 weights, x and out
    of ``act_bytes`` each, and the index tables, once). ``Ls`` is the steps
    per stream (L unless the streams partition the tokens); the vim quirk
    runs out_proj once per stream."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    products = M * (
        2 * tokens * h * 2 * d  # in_proj
        + 2 * rows * d * (r + 2 * n)  # x_proj
        + 2 * rows * r * d  # dt_proj
        + 2 * tokens * d * h * (S if quirk else 1)  # out_proj
    )
    other = M * (rows * d * 2 * K + rows * d * (6 * n + 8))  # conv; scan, D skip, gate
    weights = 2 * d * h + d * K + d + (r + 2 * n) * d + d * r + d + d * n + d + h * d
    nbytes = M * (4 * weights + act_bytes * 2 * tokens * h) + 2 * S * Ls * 8
    return products, other, nbytes


def bound_from(products, other, nbytes, product_flops=FP32_FLOPS) -> tuple[float, str]:
    """The larger of the bytes over the HBM rate and the operations over
    their rates (products at ``product_flops``, the rest at fp32), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / product_flops + other / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def mixer_bound_ms(*args, **kw) -> tuple[float, str]:
    """Least time for one fused-mixer call of M branches on an H100 in the
    arithmetic kernel C does it in: the products at the 3xTF32 rate,
    TF32_FLOPS / 3, the rest at fp32 (``mixer_work``'s arguments)."""
    return bound_from(*mixer_work(*args, **kw), product_flops=TF32_FLOPS / 3)


def mixer_bound_fp32_ms(*args, **kw) -> tuple[float, str]:
    """The same with every operation at the fp32 rate, as the products ran
    before they moved to the tensor cores."""
    return bound_from(*mixer_work(*args, **kw))


# Kernels A's, H's, C's and D's device kernels by stage: (label, regular
# expression on the profiler's kernel name). The products are gemm_tc.cuh's
# instances, named by their stage class.
SCAN_STAGES = (("scan", r"\bscan_kernel\b"),)
SCAN_BWD_STAGES = (
    ("forward to the checkpoints", r"scan_ckpt_kernel"), ("reverse", r"scan_bwd_kernel"),
    ("reduce_bc", r"reduce_bc"),
)
EPILOGUE_STAGES = (
    ("LayerNorm", r"ln_kernel"), ("fc1 + SiLU + fc2 partials", r"\bFc1\b"),
    ("tail", r"tail_kernel"),
)
INNER_STAGES = (
    ("conv + x_proj", r"\bconv_kernel\b|\bXProj\b"), ("dt_proj", r"\bDtProj\b"),
    ("scan", r"\bscan_kernel\b"), ("split sums", r"sum_splits"),
)
MIXER_STAGES = (
    ("in_proj", r"\bInProj\b"), ("conv + x_proj", r"\bconv_kernel\b|\bXProj\b"), ("dt_proj", r"\bDtProj\b"),
    ("scan", r"\bscan_kernel\b"), ("merge + out_proj", r"merge_kernel|\bOutProj\b|flip_cat"),
    ("split sums", r"sum_splits"),
)
MIXER_BWD_STAGES = (
    ("in_proj", r"\bInProj\b"), ("conv + x_proj", r"\bconv_kernel\b|\bXProj\b"), ("dt_proj", r"\bDtProj\b"),
    ("g W_out", r"\bGradOutProj\b"), ("scan adjoint", r"scan_bwd_kernel"),
    ("reduce_bc", r"reduce_bc"), ("d dt_r", r"\bGradDtRank\b"), ("dW_x", r"\bGradXProjW\b"),
    ("dW_dt", r"\bGradDtW\b"), ("dpre", r"\bGradPre\b"), ("conv adjoints", r"grad_xz|grad_conv"),
    ("gx", r"\bGradX\b"), ("dW_in", r"\bGradInW\b"), ("dW_out", r"GradOutW|fold_out_w|merge_y"),
    ("split sums", r"sum_splits"), ("finalize", r"finalize"),
)


# Kernels E's and F's device kernels by stage, as above.
SSD_STAGES = (
    ("prologue", r"prologue_kernel"), ("in_proj", r"\bInProj\b"),
    ("ssd", r"ssd_state_kernel|ssd_out_kernel"), ("gate + norm + merge", r"gate_norm_merge"),
    ("out_proj", r"\bOutProj\b"), ("split sums", r"sum_splits"),
)
# Kernel P's: the chunk states, then y with the gate and the norm in a cluster.
CORE_STAGES = (("chunk states", r"core_states_kernel"), ("y + gate + norm", r"core_out_norm_kernel"))
SSD_BWD_STAGES = (
    ("g W_out", r"\bGradOutProj\b"), ("recompute y", r"ssd_state_kernel|ssd_out_kernel"),
    ("gate + norm adjoint", r"gate_norm_bwd"), ("SSD adjoint", r"ssd_chunk_adj|ssd_adjoint"),
    ("conv adjoints", r"grad_preact|grad_zx|grad_conv"), ("gx", r"\bGradX\b"),
    ("gW_in", r"\bGradInW\b"), ("gW_out", r"\bGradOutW\b"), ("split sums", r"sum_splits"),
    ("finalize", r"finalize|norm_w_partial"),
)


def stage_table(fn, stages, calls: int = 10) -> dict:
    """Device ms per call of ``fn`` by stage, from torch.profiler's kernel
    table over ``calls`` calls (after one warm-up): each stage's kernels,
    ``other`` for kernels no stage names, and ``total``."""
    from diffma_tpu_torch.utils.profiling import profile_calls

    kernels = profile_calls(fn, calls=calls, top=1000)["top_kernels_ms_per_call"]
    table = {label: sum(ms for name, ms in kernels.items() if re.search(pattern, name))
             for label, pattern in stages}
    table["other"] = sum(kernels.values()) - sum(table.values())
    table["total"] = sum(kernels.values())
    if not table["total"] > 0:  # fn launches kernels: the profiler recorded none
        fail("torch.profiler recorded no device kernel for a call that launches some")
    return table


def stage_line(table: dict) -> str:
    return ", ".join(f"{label} {ms:.4f}" for label, ms in table.items() if ms > 0 or label == "total")


def phase_fused_mixer(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import (
        mamba_dual_mixer_fused,
        mamba_mixer_fused,
        mixer_ref,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2b: kernel C (fused mixer) against its plain version on the card",
          flush=True)
    h = 512  # DiffMa's width: d_inner 1024, d_state 16, dt_rank 32
    path_err = None
    for grid_n, layer in ((14, 0), (14, 3), (5, 0)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        m0, m1 = (random_(Mamba(h, spec), 10 * layer + i).cuda() for i in range(2))
        gen = torch.Generator().manual_seed(layer)
        x0, x1 = (torch.randn(1, L, h, generator=gen).cuda() for _ in range(2))
        with torch.no_grad():
            cases = {
                "dual": (mamba_dual_mixer_fused(spec, x0, x1, m0.weights(), m1.weights()),
                         (mixer_ref(spec, x0, m0.weights()), mixer_ref(spec, x1, m1.weights()))),
                "single": ((mamba_mixer_fused(spec, x1, m1.weights()),),
                           (mixer_ref(spec, x1, m1.weights()),)),
            }
        torch.cuda.synchronize()
        for entry, (got, want) in cases.items():
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            tol = TOL_FP32 * max(1.0, max(w.abs().max().item() for w in want))
            print(f"  {entry}, spiral layer {layer}: B=1 L={L} h={h} d=1024 n=16 r=32  "
                  f"max|err| {err:.3e}  (tol {tol:.1e})")
            if not all(g.shape == w.shape and torch.isfinite(g).all() for g, w in zip(got, want)):
                fail(f"fused mixer gave a wrong shape or a non-finite value: {entry}, L={L}")
            if err > tol:
                fail(f"fused mixer disagrees with its plain version: {entry}, layer {layer}, L={L}")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    m0, m1 = (random_(Mamba(h, spec), 100 + i).cuda().eval() for i in range(2))
    gen = torch.Generator().manual_seed(100)
    x0, x1 = (torch.randn(1, 196, h, generator=gen).cuda() for _ in range(2))
    w0, w1 = m0.weights(), m1.weights()
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba_dual_mixer_fused(spec, x0, x1, w0, w1), reps=50)
        plain_ms = cuda_ms(lambda: (mixer_ref(spec, x0, w0), mixer_ref(spec, x1, w1)), reps=5)
        m0.scan_impl = m1.scan_impl = "pallas"
        pair_ms = cuda_ms(lambda: (m0(x0), m1(x1)), reps=50)
        stages = stage_table(lambda: mamba_dual_mixer_fused(spec, x0, x1, w0, w1), MIXER_STAGES)
        x8 = [torch.randn(8, 196, h, generator=gen).cuda() for _ in range(2)]
        ms8 = cuda_ms(lambda: mamba_dual_mixer_fused(spec, *x8, w0, w1), reps=20)
        stages8 = stage_table(lambda: mamba_dual_mixer_fused(spec, *x8, w0, w1), MIXER_STAGES)
    dims = dict(h=h, d=1024, n=16, r=32, S=3, K=4)
    bound_ms, bound_by = mixer_bound_ms(M=2, B=1, L=196, **dims)
    fp32_ms, fp32_by = mixer_bound_fp32_ms(M=2, B=1, L=196, **dims)
    print(f"  [{card}] mixer_fused_fwd, both branches, B=1 L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, products at the 3xTF32 rate); all at fp32 {fp32_ms * 1e3:.2f} us "
          f"({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler), B=1: {stage_line(stages)}")
    bound8, by8 = mixer_bound_ms(M=2, B=8, L=196, **dims)
    fp32_8, fp32_by8 = mixer_bound_fp32_ms(M=2, B=8, L=196, **dims)
    print(f"  [{card}] mixer_fused_fwd, both branches, B=8 L=196: kernel {ms8:.4f} ms, bound "
          f"{bound8 * 1e3:.2f} us ({by8}, 3xTF32); all at fp32 {fp32_8 * 1e3:.2f} us ({fp32_by8})")
    print(f"  [{card}] device ms per call by stage (torch.profiler), B=8: {stage_line(stages8)}")
    print("  library_ms: none; no single PyTorch call computes the whole mixer")
    print(f"  [{card}] yardstick: the composable pair (two Mamba.forward through kernel A, "
          f"same weights) {pair_ms:.4f} ms")
    return {
        "name": "mixer_fused_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mixer_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_mixer.py:104",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fp32_ms": fp32_ms,
        "library_ms": None,
        "stages_ms": stages,
        "b8": {"ms": ms8, "bound_ms": bound8, "bound_fp32_ms": fp32_8, "stages_ms": stages8},
    }


def mixer_bwd_work(M, B, L, h, d, n, r, S, K, Ls=None, quirk=False,
                   act_bytes=4) -> tuple[int, int, int]:
    """One fused-mixer backward of M branches: the operations of its products,
    its other operations and the bytes that must move. The forward as far as
    the backward needs it, once (in_proj, x_proj, dt_proj; conv, scan; not
    out_proj); the backward: two products per projection (the input's and the
    weight's gradient), the conv's two adjoints and the scan's adjoint (17 per
    state and step, 12 per channel and step). Bytes: the weights, x and g
    read once, gx and the weight gradients written once (x, g and gx of
    ``act_bytes`` each, the rest fp32). ``Ls`` is the steps
    per stream (L unless the streams partition the tokens); the vim quirk's
    out_proj is one product per stream."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    r2n = r + 2 * n
    products = M * (
        2 * tokens * h * 2 * d + 2 * rows * d * r2n + 2 * rows * r * d  # the forward's
        + 2 * 2 * tokens * d * h * (S if quirk else 1)  # g W_out, dW_out
        + 2 * 2 * rows * r * d  # d dt_r, dW_dt
        + 2 * 2 * rows * r2n * d  # dpre's product, dW_x
        + 2 * 2 * tokens * 2 * d * h  # gx, dW_in
    )
    other = M * (
        rows * d * 2 * K + rows * d * (6 * n + 8)  # the forward's conv and scan
        + rows * d * (17 * n + 12)  # the scan's adjoint
        + 2 * 2 * rows * d * K  # the conv's input and weight adjoints
    )
    weights = 2 * d * h + d * K + d + r2n * d + d * r + d + d * n + d + h * d
    nbytes = M * (4 * 2 * weights + act_bytes * 3 * tokens * h) + 2 * S * Ls * 8
    return products, other, nbytes


def mixer_bwd_bound_ms(*args, **kw) -> tuple[float, str]:
    """Least time for one fused-mixer backward on an H100 as kernel D does it:
    the products at the 3xTF32 rate, the rest at fp32 (``mixer_bwd_work``'s
    arguments)."""
    return bound_from(*mixer_bwd_work(*args, **kw), product_flops=TF32_FLOPS / 3)


def mixer_bwd_bound_fp32_ms(*args, **kw) -> tuple[float, str]:
    """The same with every operation at the fp32 rate."""
    return bound_from(*mixer_bwd_work(*args, **kw))


def phase_mixer_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import MixerWeights, mixer_bwd_ref, mixer_fused_bwd_cuda
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2d: kernel D (fused mixer backward) against its plain version on the card",
          flush=True)
    h, batch = 512, 8

    def grads_of(gx, gw, m):
        return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(MixerWeights._fields, gw)}}

    path_err = None
    for grid_n, layer in ((14, 0), (14, 3), (5, 0)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        mixers = [random_(Mamba(h, spec), 20 * layer + i).cuda() for i in range(2)]
        ws = [m.weights() for m in mixers]
        gen = torch.Generator().manual_seed(50 + layer)
        xs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        gs = [torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2)]
        want = {}
        for m in range(2):
            want.update(grads_of(*mixer_bwd_ref(spec, xs[m], gs[m], ws[m]), m))
        for entry, M in (("dual", 2), ("single", 1)):
            gxs, gws = mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M])
            torch.cuda.synchronize()
            got = {}
            for m in range(M):
                got.update(grads_of(gxs[m], gws[m], m))
            rows = grad_errors(got, {k: want[k] for k in got}, TOL_GRAD)
            err = max(e for _, e, _ in rows)
            worst = max(rows, key=lambda row: row[1] / row[2])
            print(f"  {entry}, spiral layer {layer}: B={batch} L={L} h={h} d=1024 n=16 r=32  "
                  f"max|err| {err:.3e} over {len(rows)} gradients; nearest its bar: "
                  f"{worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e})")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    mixers = [random_(Mamba(h, spec), 200 + i).cuda() for i in range(2)]
    ws = [m.weights() for m in mixers]
    gen = torch.Generator().manual_seed(200)
    xs = [torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(2)]
    gs = [torch.randn(batch, 196, h, generator=gen).cuda() for _ in range(2)]
    ms = cuda_ms(lambda: mixer_fused_bwd_cuda(spec, xs, gs, ws), reps=10)
    plain_ms = cuda_ms(lambda: [mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(xs, gs, ws)],
                       reps=5)
    for m in mixers:
        m.scan_impl = "pallas"
    leaves = [x.clone().requires_grad_() for x in xs]
    outs = [m(x) for m, x in zip(mixers, leaves)]
    inputs = leaves + [p for m in mixers for p in m.parameters()]
    pair_ms = cuda_ms(lambda: torch.autograd.grad(outs, inputs, gs, retain_graph=True), reps=10)
    stages = stage_table(lambda: mixer_fused_bwd_cuda(spec, xs, gs, ws), MIXER_BWD_STAGES)
    dims = dict(M=2, B=batch, L=196, h=h, d=1024, n=16, r=32, S=3, K=4)
    bound_ms, bound_by = mixer_bwd_bound_ms(**dims)
    fp32_ms, fp32_by = mixer_bwd_bound_fp32_ms(**dims)
    print(f"  [{card}] mixer_fused_bwd, both branches, B={batch} L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, products at the 3xTF32 rate); all at fp32 {fp32_ms * 1e3:.2f} us "
          f"({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler): {stage_line(stages)}")
    print("  library_ms: none; no single PyTorch call computes the whole mixer's backward")
    print(f"  [{card}] yardstick: the composable pair's backward (autograd through kernels "
          f"A and B, same weights) {pair_ms:.4f} ms")
    return {
        "name": "mixer_fused_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mixer_bwd.cu",
        "replaces": "diffma_tpu/ops/fused_mixer.py:565",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fp32_ms": fp32_ms,
        "library_ms": None,
        "stages_ms": stages,
    }


def close_to_ref(what: str, got, want, tol: float = TOL_FP32) -> float:
    """max |got - want|, held to ``tol * max(1, max |want|)``; fails on a
    shape, a non-finite value or an error over the bar."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: wrong shape {tuple(got.shape)} or a non-finite value")
    err = (got - want).abs().max().item()
    bar = tol * max(1.0, want.abs().max().item())
    if err > bar:
        fail(f"{what}: max |err| {err:.3e} over its bar {bar:.1e}")
    return err


def ssd_chunk_work(seqs, Ls, n, H, hd, backward=False, Q=64) -> tuple[int, int]:
    """The SSD's operations in the chunked form that kernels E, F and P
    compute it in (``csrc/ssd_core.cuh``), for ``seqs`` sequences of ``Ls``
    steps in chunks of ``Q`` (the last one ragged): (products, other).
    Products: per chunk C . B^T on the causal pairs (once: the heads share
    it), and per head the 2 * headdim of M times dt * x on those pairs, the
    chunk's end state (2 * n * headdim a step) where a later chunk reads it,
    and the state's term of y where an earlier chunk feeds it. Other: per
    head and causal pair the decay (a difference, an exp, a product), and
    per head and chunk boundary the fold of the state. The backward adds the
    products of g_C and g_B on the causal pairs (once, W summed over the
    heads) and per head M^T g_y and g_y xdt^T on them; per head and step the
    state adjoint's share (a_c) and g_C's cross term where an earlier chunk
    feeds the step, and g_xdt's and g_B's where a later chunk reads it; and
    as other per head and pair W's decay, the sum over heads, P and its row
    and column sums, per head and step the two inner products that carry
    g_cs across chunks, and the fold of the state adjoint."""
    sizes = [Q] * (Ls // Q) + ([Ls % Q] if Ls % Q else [])
    pairs = sum(q * (q + 1) // 2 for q in sizes)
    fed, read = Ls - sizes[0], Ls - sizes[-1]  # steps an earlier chunk feeds; a later reads
    state = 2 * n * hd
    products = pairs * 2 * n + H * (pairs * 2 * hd + (read + fed) * state)
    other = H * (3 * pairs + (len(sizes) - 1) * state)
    if backward:
        products += 2 * pairs * 2 * n + H * (2 * pairs * 2 * hd + 2 * (read + fed) * state)
        other += H * (5 * pairs + 2 * hd * (read + fed) + (len(sizes) - 1) * state)
    return seqs * products, seqs * other


def ssd_mixer_work(M, B, L, h, d, n, H, S, K, prologue=False, Ls=None) -> tuple[int, int, int]:
    """One fused-SSD-mixer call of M branches: the operations of its products
    (in_proj, out_proj, and the SSD's, ``ssd_chunk_work``), its other
    operations (the conv, the SSD's decays and folds, then gate, norm and
    merge (about 8 per channel and stream row), and in prologue mode
    LayerNorm and modulation (about 10 per input element)), and the bytes
    that must move (the weights, x, out and the index table, once). ``Ls``
    is the steps per stream (L unless the streams partition the tokens)."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    ssd_products, ssd_other = ssd_chunk_work(M * B * S, Ls, n, H, hd)
    products = M * (2 * tokens * h * dproj + 2 * tokens * d * h) + ssd_products
    other = M * (
        rows * conv_dim * 2 * K  # conv
        + rows * d * 8  # D skip, gate, norm, merge
    ) + ssd_other + (10 * tokens * h if prologue else 0)
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    x_bytes = (tokens * h + tokens + 2 * h + 2 * B * h) if prologue else M * tokens * h
    nbytes = 4 * (M * weights + x_bytes + M * tokens * h) + S * L * 8
    return products, other, nbytes


def ssd_mixer_bound_ms(*args, **kw) -> tuple[float, str]:
    """Least time for one fused-SSD-mixer call on an H100: the products
    (in_proj, out_proj and the SSD's) at the 3xTF32 rate, TF32_FLOPS / 3, the
    tensor cores' rate for fp32-accurate products, the rest at fp32
    (``ssd_mixer_work``'s arguments)."""
    return bound_from(*ssd_mixer_work(*args, **kw), product_flops=TF32_FLOPS / 3)


def ssd_mixer_bound_fp32_ms(*args, **kw) -> tuple[float, str]:
    """The same with every operation at the fp32 rate, as the products ran
    before they moved to the tensor cores."""
    return bound_from(*ssd_mixer_work(*args, **kw))


def epilogue_work(B, L, h) -> tuple[int, int, int]:
    """One call of the Spiral block's tail: the operations of its 2h -> h
    product, its other operations (about 8 per concat element for the
    LayerNorm, about 12 per output element for the SiLU, the h -> 1 product,
    the mix and the residual), and the bytes of o0, o1, x, the gate and the
    weights read and out written once."""
    rows = B * L
    products = 2 * rows * 2 * h * h
    other = rows * 2 * h * 8 + rows * h * 12
    nbytes = 4 * (4 * rows * h + B * h + 2 * h * h + 4 * h + h + h + 1)
    return products, other, nbytes


def epilogue_bound_ms(B, L, h) -> tuple[float, str]:
    """Least time for one call of the tail on an H100 in the arithmetic
    kernel G does it in: the product at the 3xTF32 rate, TF32_FLOPS / 3, the
    rest at fp32."""
    return bound_from(*epilogue_work(B, L, h), product_flops=TF32_FLOPS / 3)


def epilogue_bound_fp32_ms(B, L, h) -> tuple[float, str]:
    """The same with every operation at the fp32 rate, as the product ran
    before it moved to the tensor cores."""
    return bound_from(*epilogue_work(B, L, h))


def mamba2_mixers(spec, seed: int, wide: bool = False):
    """Two Mamba-2 mixers at DiffMa's width on the card, every parameter off
    its init. ``wide``: decay rates from 1 to 16 and dt above 1, so that each
    head's span of dt * A over the sequence is in the hundreds or thousands,
    far beyond what exp can hold."""
    import torch

    from diffma_tpu_torch.models.mamba2 import Mamba2

    torch.manual_seed(seed)  # the modules' default init: the same draw in every run
    mixers = [random_(Mamba2(512, spec), seed + i) for i in range(2)]
    if wide:
        with torch.no_grad():
            for m in mixers:
                m.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, m.A_log.numel())))
                m.dt_bias.fill_(1.0)
    return [m.cuda().eval() for m in mixers]


def block_inputs(L: int, seed: int, batch: int, h: int = 512):
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, L, h, generator=gen).cuda()
    c = torch.randn(batch, 2 * h, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(batch, L, 1, generator=gen)).cuda()
    return x, c, w


def phase_fused_ssd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.layers import modulate
    from diffma_tpu_torch.ops.fused_ssd import (
        Prologue,
        mamba2_dual_mixer_fused,
        mamba2_mixer_fused,
        ssd_mixer_fused_cuda,
        ssd_mixer_ref,
    )
    from diffma_tpu_torch.ops.norm import layer_norm
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2e: kernel E (fused Mamba-2 mixer) against its plain version on the card",
          flush=True)
    h = 512  # DiffMa's width: d_inner 1024, d_state 16, 16 heads of 64
    no_limit = (0.0, float("inf"))
    path_err = None
    cases = [
        # grid, layer, batch, dt_limit, wide span; 256 and 1024 tokens are past the caps
        # that a whole stream per block in shared memory set (about 440 steps)
        (14, 0, 1, no_limit, False), (14, 3, 8, no_limit, False), (5, 0, 2, no_limit, False),
        (14, 1, 1, (0.01, 0.05), False), (14, 2, 1, no_limit, True),
        (16, 0, 2, no_limit, False), (32, 1, 1, no_limit, False),
    ]
    for grid_n, layer, batch, dt_limit, wide in cases:
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        m0, m1 = mamba2_mixers(spec, 10 * layer, wide)
        w0, w1 = m0.weights(), m1.weights()
        x0, c, wmask = block_inputs(L, layer, batch)
        x1 = x0 * wmask
        gen = torch.Generator(device="cuda").manual_seed(layer)
        ln_w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
        ln_b = 0.1 * torch.randn(h, generator=gen, device="cuda")
        shift, scale = (0.3 * c).chunk(2, dim=-1)  # rows a stride apart, as adaLN's chunks
        with torch.no_grad():
            want = [ssd_mixer_ref(spec, x, w, dt_limit) for x, w in ((x0, w0), (x1, w1))]
            xm = modulate(layer_norm(x0, ln_w, ln_b, eps=1e-5), shift, scale)
            want_pro = [ssd_mixer_ref(spec, xm, w0, dt_limit),
                        ssd_mixer_ref(spec, xm * wmask, w1, dt_limit)]
            got = {
                "dual": (mamba2_dual_mixer_fused(spec, x0, x1, w0, w1, dt_limit), want),
                "single": ((mamba2_mixer_fused(spec, x1, w1, dt_limit),), want[1:]),
                "prologue": (ssd_mixer_fused_cuda(
                    spec, (x0,), (w0, w1), dt_limit,
                    prologue=Prologue(wmask, ln_w, ln_b, shift, scale)), want_pro),
            }
        torch.cuda.synchronize()
        span = max((torch.nn.functional.softplus(
            torch.nn.functional.linear(x0, w.in_w)[..., -16:] + w.dt_bias).sum(1)
            * torch.exp(w.A_log)).max().item() for w in (w0, w1))
        tag = (f"spiral layer {layer}: B={batch} L={L} h={h} d=1024 H=16 n=16 "
               f"dt_limit={dt_limit} max span of dt*|A| {span:.0f}")
        for mode, (outs, refs) in got.items():
            err = max(close_to_ref(f"fused SSD mixer, {mode}, {tag}", o, r)
                      for o, r in zip(outs, refs))
            bar = TOL_FP32 * max(1.0, max(r.abs().max().item() for r in refs))
            print(f"  {mode}, {tag}  max|err| {err:.3e}  (tol {bar:.1e})")
            if path_err is None:
                path_err = err
        if wide and span < 200:
            fail(f"the wide-span case has a span of only {span:.0f}")

    spec = build_scan_spec("spiral", 14, 0)
    m0, m1 = mamba2_mixers(spec, 100)
    w0, w1 = m0.weights(), m1.weights()
    x0, c, wmask = block_inputs(196, 100, 1)
    x1 = x0 * wmask
    pro = Prologue(wmask, torch.ones_like(c[0, :h]), torch.zeros_like(c[0, :h]),
                   *(0.3 * c).chunk(2, dim=-1))
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba2_dual_mixer_fused(spec, x0, x1, w0, w1), reps=50)
        pro_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, (x0,), (w0, w1), prologue=pro),
                         reps=50)
        plain_ms = cuda_ms(lambda: (ssd_mixer_ref(spec, x0, w0), ssd_mixer_ref(spec, x1, w1)),
                           reps=10)
        pair_ms = cuda_ms(lambda: (m0(x0), m1(x1)), reps=10)  # scan_impl "auto"
        stages = stage_table(lambda: mamba2_dual_mixer_fused(spec, x0, x1, w0, w1), SSD_STAGES)
        x8 = [block_inputs(196, 101 + i, 8)[0] for i in range(2)]
        ms8 = cuda_ms(lambda: mamba2_dual_mixer_fused(spec, *x8, w0, w1), reps=20)
        stages8 = stage_table(lambda: mamba2_dual_mixer_fused(spec, *x8, w0, w1), SSD_STAGES)
    dims = dict(h=h, d=1024, n=16, H=16, S=3, K=4)
    bound_ms, bound_by = ssd_mixer_bound_ms(M=2, B=1, L=196, **dims)
    fp32_ms, fp32_by = ssd_mixer_bound_fp32_ms(M=2, B=1, L=196, **dims)
    pro_bound_ms, _ = ssd_mixer_bound_ms(M=2, B=1, L=196, prologue=True, **dims)
    bound8, by8 = ssd_mixer_bound_ms(M=2, B=8, L=196, **dims)
    fp32_8, fp32_by8 = ssd_mixer_bound_fp32_ms(M=2, B=8, L=196, **dims)
    print(f"  [{card}] ssd_mixer_fwd fp32, both branches, B=1 L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, products at the 3xTF32 rate); all at fp32 {fp32_ms * 1e3:.2f} us "
          f"({fp32_by}); prologue mode {pro_ms:.4f} ms, bound {pro_bound_ms * 1e3:.2f} us")
    print(f"  [{card}] device ms per call by stage (torch.profiler), B=1: {stage_line(stages)}")
    print(f"  [{card}] ssd_mixer_fwd, both branches, B=8 L=196: kernel {ms8:.4f} ms, bound "
          f"{bound8 * 1e3:.2f} us ({by8}, 3xTF32); all at fp32 {fp32_8 * 1e3:.2f} us ({fp32_by8})")
    print(f"  [{card}] device ms per call by stage (torch.profiler), B=8: {stage_line(stages8)}")
    print("  library_ms: none; no single PyTorch call computes the whole mixer")
    print(f"  [{card}] yardstick: the composable pair (two Mamba2.forward with "
          f"scan_impl='auto': torch operators and cuBLAS, the plain version's own path, "
          f"same weights) {pair_ms:.4f} ms")
    return {
        "name": "ssd_mixer_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_ssd_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:174",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fp32_ms": fp32_ms,
        "library_ms": None,
        "stages_ms": stages,
        "b8": {"ms": ms8, "bound_ms": bound8, "bound_fp32_ms": fp32_8, "stages_ms": stages8},
    }


def phase_spiral_epilogue(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.blocks import SpiralMambaBlock
    from diffma_tpu_torch.ops.fused_ssd import spiral_epilogue_cuda, spiral_epilogue_ref
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2f: kernel G (the Spiral block's tail) against its plain version, and the "
          "Mamba-2 block on its three routes", flush=True)
    h = 512
    path_err = None
    for grid_n, layer, batch in ((14, 0, 1), (14, 3, 8), (5, 1, 2)):
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        block = random_(SpiralMambaBlock(h, spec, use_mamba2=True), 30 + layer).cuda().eval()
        x, c, w = block_inputs(L, 30 + layer, batch)
        o0, o1 = (block_inputs(L, seed + layer, batch)[0] for seed in (40, 50))
        an, fc1, _, fc2 = block.attention_network
        with torch.no_grad():
            gate = block.adaLN_modulation(c).chunk(3, dim=-1)[2]
            tail = (o0, o1, x, gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight,
                    fc2.bias)
            got = spiral_epilogue_cuda(*tail)
            err = close_to_ref(f"spiral epilogue, B={batch} L={L}", got,
                               spiral_epilogue_ref(*tail))
            if not torch.equal(got, spiral_epilogue_cuda(*tail)):
                fail(f"two calls of spiral_epilogue_fwd gave different bits, B={batch} L={L}")
            routes = {}
            for route, impl, fuse in (("two composable mixers", "auto", False),
                                      ("dual kernel E", "fused", False),
                                      ("fuse_block: E prologue + G", "fused", True)):
                block.scan_impl = block.mamba1.scan_impl = block.mamba2.scan_impl = impl
                block.fuse_block = fuse
                reset_counts()
                routes[route] = block(x, c, w)
                counts = {k: v.launches for k, v in kernel_counters().items() if v.launches}
                expect = {"auto": {}, "fused": {"ssd_mixer_fwd": 1}}[impl] | (
                    {"spiral_epilogue": 1} if fuse else {})
                if counts != expect:
                    fail(f"the block's route '{route}' launched {counts}, not {expect}")
        torch.cuda.synchronize()
        want = routes.pop("two composable mixers")
        errs = {r: close_to_ref(f"Mamba-2 block, {r}, B={batch} L={L}", got, want)
                for r, got in routes.items()}
        print(f"  spiral layer {layer}: B={batch} L={L} h={h}  kernel G max|err| {err:.3e}, two "
              f"calls equal bits; block against its composable route: "
              + ", ".join(f"{r} {e:.3e}" for r, e in errs.items())
              + f"  (tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
        if path_err is None:
            path_err = err

    times = {}
    for batch in (1, 8):  # the sampler's; the fuse_block training forward's
        tail = epilogue_inputs(batch)
        with torch.no_grad():
            ms = cuda_ms(lambda: spiral_epilogue_cuda(*tail), reps=50)
            stages = stage_table(lambda: spiral_epilogue_cuda(*tail), EPILOGUE_STAGES, calls=50)
            plain_ms = cuda_ms(lambda: spiral_epilogue_ref(*tail), reps=50)
        bound_ms, bound_by = epilogue_bound_ms(B=batch, L=196, h=h)
        fp32_ms, fp32_by = epilogue_bound_fp32_ms(B=batch, L=196, h=h)
        times[batch] = dict(ms=ms, busy_ms=stages["total"], plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bound_fp32_ms=fp32_ms, stages_ms=stages)
        print(f"  [{card}] spiral_epilogue fp32, B={batch} L=196 h=512: kernel {ms:.4f} ms "
              f"(events), device busy {stages['total']:.4f} ms ({stage_line(stages)}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, the product at "
              f"the 3xTF32 rate); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
    print("  library_ms: none; no single PyTorch call computes the block's tail; the plain "
          "version is the unfused tail in torch operators (cuBLAS), the yardstick")
    return {
        "name": "spiral_epilogue",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/spiral_epilogue.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:1131",
        "max_abs_err": path_err,
        **{k: v for k, v in times[1].items() if k != "stages_ms"},
        "library_ms": None,
        "stages_ms": times[1]["stages_ms"],
        "b8": times[8],
    }


def epilogue_inputs(batch: int, seed: int = 300):
    """Kernel G's arguments at the sampler's shapes (196 tokens, h = 512): a
    seeded block's tail weights and gate, random o0, o1 and x, on the card."""
    import torch

    from diffma_tpu_torch.models.blocks import SpiralMambaBlock
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    block = random_(SpiralMambaBlock(512, build_scan_spec("spiral", 14, 0), use_mamba2=True),
                    seed).cuda().eval()
    x, c, _ = block_inputs(196, seed, batch)
    o0, o1 = (block_inputs(196, seed + i, batch)[0] for i in (1, 2))
    an, fc1, _, fc2 = block.attention_network
    with torch.no_grad():
        gate = block.adaLN_modulation(c).chunk(3, dim=-1)[2]
    return (o0, o1, x, gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)


def ssd_mixer_bwd_work(M, B, L, h, d, n, H, S, K, Ls=None) -> tuple[int, int, int]:
    """One fused-SSD-mixer backward of M branches: the operations of its four
    GEMMs over the token rows (g W_out, gW_out, gx, gW_in) and of the SSD's
    products, forward and adjoint (``ssd_chunk_work``); its other operations:
    the conv recomputed and its two adjoints, the SSD's decays, folds and sums
    of P, and about 30 per channel and stream row for the gate, the norm, the
    D skip and their adjoints; and the bytes that must move: x, g, the
    residual zx and the weights read once, gx and the weight gradients
    written once. ``Ls`` is the steps per stream (L unless the streams
    partition the tokens)."""
    Ls = L if Ls is None else Ls
    tokens, rows = B * L, B * S * Ls
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    ssd_products, ssd_other = ssd_chunk_work(M * B * S, Ls, n, H, hd, backward=True)
    products = M * (2 * 2 * tokens * d * h + 2 * 2 * tokens * dproj * h) + ssd_products
    other = M * (
        3 * rows * conv_dim * 2 * K  # the conv again and its two adjoints
        + rows * d * 30  # gate, norm, D skip, their adjoints
    ) + ssd_other
    weights = dproj * h + conv_dim * K + conv_dim + 3 * H + d + h * d
    nbytes = M * 4 * (2 * weights + 3 * tokens * h + tokens * dproj) + 2 * S * Ls * 8
    return products, other, nbytes


def ssd_mixer_bwd_bound_ms(*args, **kw) -> tuple[float, str]:
    """Least time for one fused-SSD-mixer backward on an H100: the products
    (the four GEMMs and the SSD's) at the 3xTF32 rate, the rest at fp32
    (``ssd_mixer_bwd_work``'s arguments)."""
    return bound_from(*ssd_mixer_bwd_work(*args, **kw), product_flops=TF32_FLOPS / 3)


def ssd_mixer_bwd_bound_fp32_ms(*args, **kw) -> tuple[float, str]:
    """The same with every operation at the fp32 rate."""
    return bound_from(*ssd_mixer_bwd_work(*args, **kw))


def phase_ssd_bwd(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2g: kernel F (fused Mamba-2 mixer backward) against its plain version on "
          "the card, and kernel E's residual mode against its plain mode", flush=True)
    h, batch = 512, 8
    no_limit = (0.0, float("inf"))

    def grads_of(gx, gw, m):
        return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(Mamba2Weights._fields, gw)}}

    def inputs(L, seed, b=batch):
        gen = torch.Generator().manual_seed(seed)
        return ([torch.randn(b, L, h, generator=gen).cuda() for _ in range(2)],
                [torch.randn(b, L, h, generator=gen).cuda() for _ in range(2)])

    path_err = None
    cases = [
        # grid, layer, dt_limit, wide span, batch; 256 and 1024 tokens are past the cap
        # that a whole stream per block in shared memory set (227 steps)
        (14, 0, no_limit, False, batch), (14, 3, no_limit, False, batch),
        (5, 0, no_limit, False, batch), (14, 1, (0.5, 0.9), False, batch),
        (14, 2, no_limit, True, batch), (16, 0, no_limit, False, 4), (32, 1, no_limit, False, 1),
    ]
    for grid_n, layer, dt_limit, wide, b in cases:
        spec = build_scan_spec("spiral", grid_n, layer)
        L = grid_n * grid_n
        ws = [m.weights() for m in mamba2_mixers(spec, 20 * layer, wide)]
        xs, gs = inputs(L, 60 + layer, b)
        sp = torch.nn.functional.softplus(
            torch.nn.functional.linear(xs[0], ws[0].in_w)[..., -16:] + ws[0].dt_bias)
        inside = ((sp >= dt_limit[0]) & (sp <= dt_limit[1])).float().mean().item()
        span = (sp.sum(1) * torch.exp(ws[0].A_log)).max().item()
        if dt_limit != no_limit and not 0.05 < inside < 0.95:
            fail(f"dt_limit {dt_limit} leaves {inside:.2f} of the steps unclipped: it must clip "
                 f"some and not others")
        if wide and span < 200:
            fail(f"the wide-span case has a span of only {span:.0f}")
        with torch.no_grad():
            plain = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit)
            outs, zx = ssd_mixer_fused_cuda(spec, xs, ws, dt_limit, want_res=True)
            outs1, zx1 = ssd_mixer_fused_cuda(spec, xs[:1], ws[:1], dt_limit, want_res=True)
        if dt_limit != no_limit:
            # The clip's gradient jumps at a limit; E's 3xTF32 in_proj and the plain
            # version's fp32 one differ by about 1e-6, so a step that near a limit
            # would be clipped for F and not for the plain version (or the other way
            # round), and the comparison would not hold (tests/test_torch_cuda_kernels.py).
            for m in range(2):
                pre = torch.nn.functional.linear(xs[m], ws[m].in_w)[..., -16:].reshape(-1, 16)
                sides = []
                for p_ in (pre, zx[m][:, -16:]):
                    dt_ = torch.nn.functional.softplus(p_ + ws[m].dt_bias)
                    sides.append((dt_ >= dt_limit[0]) & (dt_ <= dt_limit[1]))
                if not torch.equal(*sides):
                    fail(f"a step of mixer {m} lies on the two sides of a clip limit of "
                         f"{dt_limit} for kernel E's in_proj and the plain one")
        if not all(torch.equal(a, b) for a, b in zip((*outs, *outs1), (*plain, plain[0]))):
            fail(f"kernel E's residual mode changed its outputs: layer {layer}, L={L}")
        want = {}
        for m in range(2):
            want.update(grads_of(*ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m], dt_limit), m))
        tag = (f"spiral layer {layer}: B={b} L={L} h={h} d=1024 H=16 n=16 dt_limit={dt_limit} "
               f"(unclipped {inside:.2f}) max span of dt*|A| {span:.0f}")
        for entry, M, res in (("dual", 2, zx), ("single", 1, zx1)):
            first = None
            for call in (1, 2):  # two calls in a row: nothing is left over from the first
                gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M], res, dt_limit)
                torch.cuda.synchronize()
                got = {}
                for m in range(M):
                    got.update(grads_of(gxs[m], gws[m], m))
                rows = grad_errors(got, {k: want[k] for k in got}, TOL_GRAD)
                if first is not None and not all(torch.equal(got[k], first[k]) for k in got):
                    fail(f"kernel F gave other bits on its second call: {entry}, {tag}")
                first = got
            err = max(e for _, e, _ in rows)
            worst = max(rows, key=lambda row: row[1] / row[2])
            print(f"  {entry}, {tag}  max|err| {err:.3e} over {len(rows)} gradients, twice, "
                  f"same bits; nearest its bar: {worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e}); "
                  f"residual mode's outputs equal plain E's")
            if path_err is None:
                path_err = err

    spec = build_scan_spec("spiral", 14, 0)
    mixers = mamba2_mixers(spec, 200)
    ws = [m.weights() for m in mixers]
    xs, gs = inputs(196, 200)
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
        e_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, xs, ws), reps=20)
        e_res_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, xs, ws, want_res=True), reps=20)
    ms = cuda_ms(lambda: ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx), reps=10)
    stages = stage_table(lambda: ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx), SSD_BWD_STAGES)
    plain_ms = cuda_ms(lambda: [ssd_mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(xs, gs, ws)],
                       reps=5)
    for m in mixers:
        m.train()
    leaves = [x.clone().requires_grad_() for x in xs]
    outs = [m(x) for m, x in zip(mixers, leaves)]  # scan_impl "auto": the composable path
    params = leaves + [p for m in mixers for p in m.parameters()]
    pair_ms = cuda_ms(lambda: torch.autograd.grad(outs, params, gs, retain_graph=True), reps=10)
    dims = dict(M=2, B=batch, L=196, h=h, d=1024, n=16, H=16, S=3, K=4)
    bound_ms, bound_by = ssd_mixer_bwd_bound_ms(**dims)
    fp32_ms, fp32_by = ssd_mixer_bwd_bound_fp32_ms(**dims)
    e_bound_ms, _ = ssd_mixer_bound_ms(**dims)
    print(f"  [{card}] ssd_mixer_bwd fp32, both branches, B={batch} L=196 h=512 d=1024: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (forward and autograd backward), bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}, products at the 3xTF32 rate); all at fp32 "
          f"{fp32_ms * 1e3:.2f} us ({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler): {stage_line(stages)}")
    print("  library_ms: none; no single PyTorch call computes the whole mixer's backward")
    print(f"  [{card}] yardstick: the composable pair's backward (autograd through "
          f"ssd_mixer_ref: torch operators and cuBLAS, same weights) {pair_ms:.4f} ms")
    print(f"  [{card}] ssd_mixer_fwd at the training shapes (B={batch}, both branches): plain "
          f"mode {e_ms:.4f} ms, residual mode {e_res_ms:.4f} ms (bound {e_bound_ms * 1e3:.2f} us); "
          f"the residual is {zx.numel() * 4 / 1e6:.1f} MB per call")
    return {
        "name": "ssd_mixer_bwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_ssd_bwd.cu",
        "replaces": "diffma_tpu/ops/fused_ssd.py:555",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fp32_ms": fp32_ms,
        "library_ms": None,
        "stages_ms": stages,
    }


def inner_work(G, L, d, n, r, K) -> tuple[int, int, int]:
    """One call of the mixer's inner part: the operations of its products
    (x_proj, dt_proj), its other operations (conv, scan with the D skip and
    the gate) and the bytes that must move (xz and the weights read, the
    output written, once)."""
    rows = G * L
    products = 2 * rows * d * (r + 2 * n) + 2 * rows * r * d
    other = rows * d * 2 * K + rows * d * (6 * n + 8)
    weights = d * K + d + (r + 2 * n) * d + d * r + d + d * n + d
    return products, other, 4 * (rows * 2 * d + rows * d + weights)


def inner_bound_ms(*args) -> tuple[float, str]:
    """Least time for one call of kernel H on an H100 in the arithmetic it
    does it in: the products at the 3xTF32 rate, TF32_FLOPS / 3, the rest at
    fp32 (``inner_work``'s arguments), as kernel C is counted."""
    return bound_from(*inner_work(*args), product_flops=TF32_FLOPS / 3)


def inner_bound_fp32_ms(*args) -> tuple[float, str]:
    """The same with every operation at the fp32 rate."""
    return bound_from(*inner_work(*args))


def inner_inputs(G, L, seed, dt_bias=0.0):
    """xz (G, L, 2048) and one mixer's inner weights at DiffMa's width on the
    card, every parameter off its init, dt_proj's bias moved by ``dt_bias``."""
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    m = random_(Mamba(512, build_scan_spec("zig", 2, 0)), seed)
    with torch.no_grad():
        m.dt_proj.bias.add_(dt_bias)
    w = m.cuda().weights()
    xz = torch.randn(G, L, 2048, generator=torch.Generator().manual_seed(seed + 1)).cuda()
    return (xz, w.conv_w[:, 0, :].detach(), w.conv_b.detach(), w.xp_w.detach(),
            w.dt_w.detach(), w.dt_b.detach(), -torch.exp(w.A_log.detach()), w.D.detach())


def doubled_atrous_spec(grid_n: int):
    """A scan spec that the whole-mixer kernel C cannot run: the four atrous
    streams of the grid and their reverses (every token twice, in 8 streams
    of L / 4 steps, merged with scale 0.5)."""
    import numpy as np

    from diffma_tpu_torch.ops.scan_orders import ScanSpec, _build_merge_table, build_scan_spec

    eff = build_scan_spec("efficientVMamba", grid_n, 0)
    fwd = np.concatenate([eff.fwd, eff.fwd[:, ::-1]])
    return ScanSpec(fwd=fwd, merge=_build_merge_table(fwd, grid_n * grid_n), scale=0.5)


def stage_ms(report: dict, *needles: str) -> float:
    """ms per call of the profiled device kernels whose name holds every needle."""
    return sum(ms for name, ms in report["top_kernels_ms_per_call"].items()
               if all(n in name for n in needles))


def phase_mamba_inner(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mamba import (
        mamba_inner_fused,
        mamba_inner_fused_cuda,
        mamba_inner_ref,
    )
    from diffma_tpu_torch.ops.fused_mixer import mamba_mixer_fused
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2h: kernel H (the Mamba-1 mixer's inner part) against its plain version "
          "on the card, values and gradients", flush=True)
    names = ("xz", "conv_w", "conv_b", "xp_w", "dt_w", "dt_b", "A", "D")
    cases = [
        # G, L, dt_bias: the path's shape (8 atrous streams of 49 steps at batch 1) first,
        # the three B/2 streams at batch 1 and 8, ragged lengths
        (8, 49, 0.0), (3, 196, 0.0), (24, 196, 0.0), (64, 49, 0.0), (3, 25, -2.0), (5, 13, 2.0),
    ]
    path_err = None
    for i, (G, L, dt_bias) in enumerate(cases):
        args = inner_inputs(G, L, seed=300 + i, dt_bias=dt_bias)
        with torch.no_grad():
            got, want = mamba_inner_fused_cuda(*args), mamba_inner_ref(*args)
        torch.cuda.synchronize()
        err = close_to_ref(f"fused Mamba inner, G={G} L={L}", got, want)
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(i)).cuda()
        leaves = [t.clone().requires_grad_() for t in args]
        refs = [t.clone().requires_grad_() for t in args]
        mamba_inner_fused(*leaves).backward(g)  # MambaInnerFn: H, then A and B
        mamba_inner_ref(*refs).backward(g)
        rows = grad_errors(dict(zip(names, (t.grad for t in leaves))),
                           dict(zip(names, (t.grad for t in refs))), TOL_GRAD)
        worst = max(rows, key=lambda row: row[1] / row[2])
        print(f"  G={G} L={L} d=1024 n=16 r=32, dt_bias {dt_bias:+.0f} + noise: max|err| {err:.3e} "
              f"(tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e}); 8 gradients through "
              f"MambaInnerFn, nearest its bar: {worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e})")
        if path_err is None:
            path_err = err

    times = {}
    with torch.no_grad():
        for G, L in ((8, 49), (3, 196), (24, 196)):
            args = inner_inputs(G, L, seed=400 + G)
            bound_ms, bound_by = inner_bound_ms(G, L, 1024, 16, 32, 4)
            fp32_ms, fp32_by = inner_bound_fp32_ms(G, L, 1024, 16, 32, 4)
            times[G, L] = (cuda_ms(lambda: mamba_inner_fused_cuda(*args), reps=50),
                           cuda_ms(lambda: mamba_inner_ref(*args), reps=5), bound_ms, bound_by,
                           fp32_ms, stage_table(lambda: mamba_inner_fused_cuda(*args), INNER_STAGES))
            print(f"  [{card}] mamba_inner_fwd fp32 G={G} L={L} d=1024: kernel {times[G, L][0]:.4f} ms, "
                  f"plain {times[G, L][1]:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, "
                  f"products at the 3xTF32 rate); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
            print(f"  [{card}] device ms per call by stage (torch.profiler): "
                  f"{stage_line(times[G, L][5])}")
        # The same stages inside kernel C (one mixer, 3 spiral streams, batch 1).
        spec = build_scan_spec("spiral", 14, 0)
        m = random_(Mamba(512, spec), 404).cuda()
        x = torch.randn(1, 196, 512, generator=torch.Generator().manual_seed(405)).cuda()
        c_stages = stage_table(lambda: mamba_mixer_fused(spec, x, m.weights()), MIXER_STAGES)
    print(f"  [{card}] kernel C, one mixer, 3 streams of 196, by stage: {stage_line(c_stages)}")
    print("  library_ms: none; no single PyTorch call computes the mixer's inner part")
    ms, plain_ms, bound_ms, bound_by, fp32_ms, stages = times[8, 49]
    return {
        "name": "mamba_inner_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/fused_mamba_fwd.cu",
        "replaces": "diffma_tpu/ops/fused_mamba.py:42",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fp32_ms": fp32_ms,
        "library_ms": None,
        "stages_ms": stages,
        "other_shapes": {f"G{G}_L{L}": {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                                        "bound_fp32_ms": t[4], "stages_ms": t[5]}
                         for (G, L), t in times.items()},
    }


def phase_mixer_families(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import mamba_mixer_fused, mixer_ref
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2i: kernel C's one-mixer form on the vim quirk, the EfficientVMamba "
          "partition, one stream (zig) and four (vmamba), against its plain version", flush=True)
    h = 512
    times = {}
    for family, batches in (("vim", (1, 8)), ("efficientVMamba", (1, 8)), ("zig", (1,)),
                            ("vmamba", (1,))):
        # 196 tokens, 25 (the partition: 100 tokens, streams of 25 steps) and 16 (the
        # partition's streams of 4 steps)
        for grid_n in (14, 10 if family == "efficientVMamba" else 5, 4):
            spec = build_scan_spec(family, grid_n, 1)
            L = grid_n * grid_n
            S, Ls = spec.fwd.shape
            m = random_(Mamba(h, spec), 500 + grid_n).cuda()
            for batch in batches:
                x = torch.randn(batch, L, h, generator=torch.Generator().manual_seed(batch)).cuda()
                with torch.no_grad():
                    got, want = mamba_mixer_fused(spec, x, m.weights()), mixer_ref(spec, x, m.weights())
                torch.cuda.synchronize()
                err = close_to_ref(f"fused mixer, {family}, B={batch} L={L}", got, want)
                print(f"  {family}: B={batch} L={L} S={S} Ls={Ls} quirk={spec.mamba1_vim_quirk}  "
                      f"max|err| {err:.3e}  (tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
        spec = build_scan_spec(family, 14, 1)
        S, Ls = spec.fwd.shape
        m = random_(Mamba(h, spec), 600).cuda()
        x = torch.randn(1, 196, h, generator=torch.Generator().manual_seed(600)).cuda()
        with torch.no_grad():
            ms = cuda_ms(lambda: mamba_mixer_fused(spec, x, m.weights()), reps=50)
            plain_ms = cuda_ms(lambda: mixer_ref(spec, x, m.weights()), reps=5)
            stages = stage_table(lambda: mamba_mixer_fused(spec, x, m.weights()), MIXER_STAGES)
        dims = dict(M=1, B=1, L=196, h=h, d=1024, n=16, r=32, S=S, K=4, Ls=Ls,
                    quirk=spec.mamba1_vim_quirk)
        bound_ms, bound_by = mixer_bound_ms(**dims)
        fp32_ms, fp32_by = mixer_bound_fp32_ms(**dims)
        times[family] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_fp32_ms": fp32_ms, "stages_ms": stages}
        print(f"  [{card}] mixer_fused_fwd, one mixer, {family} (S={S}, Ls={Ls}), B=1 L=196: "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}, 3xTF32); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
        print(f"  [{card}] device ms per call by stage: {stage_line(stages)}")
    return times


def phase_ssd_partition(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        mamba2_dual_mixer_fused,
        mamba2_mixer_fused,
        ssd_mixer_ref,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2j: kernel E on the EfficientVMamba partition against its plain version",
          flush=True)
    h = 512
    for grid_n, batch in ((14, 1), (14, 8), (4, 1), (4, 8), (32, 1)):  # Ls = 49, 4 and 256
        spec = build_scan_spec("efficientVMamba", grid_n, 0)
        L = grid_n * grid_n
        m0, m1 = mamba2_mixers(spec, 700 + grid_n)
        w0, w1 = m0.weights(), m1.weights()
        x0, _, wmask = block_inputs(L, 700 + batch, batch)
        x1 = x0 * wmask
        with torch.no_grad():
            want = [ssd_mixer_ref(spec, x, w) for x, w in ((x0, w0), (x1, w1))]
            got = (*mamba2_dual_mixer_fused(spec, x0, x1, w0, w1),
                   mamba2_mixer_fused(spec, x1, w1))
        torch.cuda.synchronize()
        err = max(close_to_ref(f"fused SSD mixer, partition, B={batch} L={L}", o, r)
                  for o, r in zip(got, (*want, want[1])))
        print(f"  dual and single: B={batch} L={L} S=4 Ls={L // 4}  max|err| {err:.3e}  "
              f"(tol {TOL_FP32 * max(1.0, max(r.abs().max().item() for r in want)):.1e})")
    spec = build_scan_spec("efficientVMamba", 14, 0)
    (m0, _) = mamba2_mixers(spec, 800)
    x0 = block_inputs(196, 800, 1)[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: mamba2_mixer_fused(spec, x0, m0.weights()), reps=50)
        plain_ms = cuda_ms(lambda: ssd_mixer_ref(spec, x0, m0.weights()), reps=10)
        stages = stage_table(lambda: mamba2_mixer_fused(spec, x0, m0.weights()), SSD_STAGES)
    dims = dict(M=1, B=1, L=196, h=h, d=1024, n=16, H=16, S=4, K=4, Ls=49)
    bound_ms, bound_by = ssd_mixer_bound_ms(**dims)
    fp32_ms, fp32_by = ssd_mixer_bound_fp32_ms(**dims)
    print(f"  [{card}] ssd_mixer_fwd fp32, one mixer, partition (S=4, Ls=49), B=1 L=196: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, "
          f"3xTF32); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler): {stage_line(stages)}")
    return {"efficientVMamba": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_fp32_ms": fp32_ms, "stages_ms": stages}}


def phase_mixer_bwd_branches(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.fused_mixer import MixerWeights, mixer_bwd_ref, mixer_fused_bwd_cuda
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2k: kernel D's vim and partition branches against its plain version, every "
          "gradient tensor", flush=True)
    h, batch = 512, 8

    def grads_of(gx, gw):
        return {"gx": gx, **{f"w.{f}": t for f, t in zip(MixerWeights._fields, gw)}}

    def case(spec, seed):
        m = random_(Mamba(h, spec), seed).cuda()
        gen = torch.Generator().manual_seed(seed)
        L = spec.seq_len
        x, g = (torch.randn(batch, L, h, generator=gen).cuda() for _ in range(2))
        return m, x, g

    times = {}
    # (family, grid): 196 tokens, then the vim quirk at 25 tokens and the partition's four
    # streams of 25 steps (grid 10), neither a multiple of the 16-step checkpoint chunk
    for branch, family, grids in (("vim", "vim", (14, 5)), ("partition", "efficientVMamba", (14, 10))):
        path_err = None
        for grid_n in grids:
            spec = build_scan_spec(family, grid_n, 1)
            S, Ls = spec.fwd.shape
            m, x, g = case(spec, 700 + grid_n)
            want = grads_of(*mixer_bwd_ref(spec, x, g, m.weights()))
            (gx,), (gw,) = mixer_fused_bwd_cuda(spec, (x,), (g,), (m.weights(),))
            torch.cuda.synchronize()
            rows = grad_errors(grads_of(gx, gw), want, TOL_GRAD)
            worst = max(rows, key=lambda row: row[1] / row[2])
            err = max(e for _, e, _ in rows)
            print(f"  {branch} ({family}): B={batch} L={spec.seq_len} S={S} Ls={Ls}  max|err| "
                  f"{err:.3e} over {len(rows)} gradients; nearest its bar: {worst[0]} "
                  f"{worst[1]:.2e} (bar {worst[2]:.1e})")
            path_err = err if path_err is None else path_err
        spec = build_scan_spec(family, 14, 1)
        S, Ls = spec.fwd.shape
        m, x, g = case(spec, 750)
        w = m.weights()
        ms = cuda_ms(lambda: mixer_fused_bwd_cuda(spec, (x,), (g,), (w,)), reps=10)
        plain_ms = cuda_ms(lambda: mixer_bwd_ref(spec, x, g, w), reps=5)
        stages = stage_table(lambda: mixer_fused_bwd_cuda(spec, (x,), (g,), (w,)), MIXER_BWD_STAGES)
        dims = dict(M=1, B=batch, L=196, h=h, d=1024, n=16, r=32, S=S, K=4, Ls=Ls,
                    quirk=spec.mamba1_vim_quirk)
        bound_ms, bound_by = mixer_bwd_bound_ms(**dims)
        fp32_ms, fp32_by = mixer_bwd_bound_fp32_ms(**dims)
        times[branch] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bound_fp32_ms": fp32_ms, "max_abs_err": path_err,
                         "stages_ms": stages}
        print(f"  [{card}] mixer_fused_bwd, one mixer, {branch} (S={S}, Ls={Ls}), B={batch} "
              f"L=196: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}, 3xTF32); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
        print(f"  [{card}] device ms per call by stage: {stage_line(stages)}")
    return times


def phase_ssd_bwd_partition(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 2l: kernel F's partition branch against its plain version, every gradient "
          "tensor", flush=True)
    h, batch = 512, 8

    def grads_of(gx, gw, m):
        return {f"gx{m}": gx, **{f"w{m}.{f}": t for f, t in zip(Mamba2Weights._fields, gw)}}

    def case(grid_n, seed, b=batch):
        spec = build_scan_spec("efficientVMamba", grid_n, 0)
        ws = [m.weights() for m in mamba2_mixers(spec, seed)]
        gen = torch.Generator().manual_seed(seed)
        L = spec.seq_len
        xs = [torch.randn(b, L, h, generator=gen).cuda() for _ in range(2)]
        gs = [torch.randn(b, L, h, generator=gen).cuda() for _ in range(2)]
        return spec, ws, xs, gs

    path_err = None
    for grid_n in (14, 10, 32):  # 4 streams of 49 steps, of 25, and of 256
        spec, ws, xs, gs = case(grid_n, 800 + grid_n, batch if grid_n < 32 else 2)
        with torch.no_grad():
            _, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
            _, zx1 = ssd_mixer_fused_cuda(spec, xs[:1], ws[:1], want_res=True)
        want = {}
        for m in range(2):
            want.update(grads_of(*ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m]), m))
        for entry, M, res in (("dual", 2, zx), ("single", 1, zx1)):
            gxs, gws = ssd_mixer_fused_bwd_cuda(spec, xs[:M], gs[:M], ws[:M], res)
            torch.cuda.synchronize()
            got = {}
            for m in range(M):
                got.update(grads_of(gxs[m], gws[m], m))
            rows = grad_errors(got, {k: want[k] for k in got}, TOL_GRAD)
            worst = max(rows, key=lambda row: row[1] / row[2])
            err = max(e for _, e, _ in rows)
            print(f"  {entry}: B={xs[0].shape[0]} L={spec.seq_len} S=4 Ls={spec.stream_len}  max|err| "
                  f"{err:.3e} over {len(rows)} gradients; nearest its bar: {worst[0]} "
                  f"{worst[1]:.2e} (bar {worst[2]:.1e})")
            path_err = err if path_err is None else path_err
    spec, ws, xs, gs = case(14, 850)
    with torch.no_grad():
        _, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
    ms = cuda_ms(lambda: ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx), reps=10)
    stages = stage_table(lambda: ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx), SSD_BWD_STAGES)
    plain_ms = cuda_ms(lambda: [ssd_mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(xs, gs, ws)],
                       reps=5)
    dims = dict(M=2, B=batch, L=196, h=h, d=1024, n=16, H=16, S=4, K=4, Ls=49)
    bound_ms, bound_by = ssd_mixer_bwd_bound_ms(**dims)
    fp32_ms, fp32_by = ssd_mixer_bwd_bound_fp32_ms(**dims)
    print(f"  [{card}] ssd_mixer_bwd fp32, both branches, partition (S=4, Ls=49), B={batch} "
          f"L=196: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, 3xTF32); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler): {stage_line(stages)}")
    return {"partition": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_fp32_ms": fp32_ms, "max_abs_err": path_err,
                          "stages_ms": stages}}


def ssd_core_work(G, L, d, n, H, K) -> tuple[int, int, int]:
    """One call of kernel P on G sequences of L steps: the SSD's products
    (``ssd_chunk_work``), the other operations (the conv, the SSD's decays
    and folds, and about 8 per channel and row for the D skip, the gate and
    the norm), and the bytes of zx read and the normed streams written once."""
    dproj, conv_dim, hd = 2 * d + 2 * n + H, d + 2 * n, d // H
    products, other = ssd_chunk_work(G, L, n, H, hd)
    other += G * L * conv_dim * 2 * K + G * L * d * 8
    nbytes = 4 * (G * L * dproj + G * L * d + 2 * (conv_dim * K + conv_dim + 3 * H + d))
    return products, other, nbytes


def ssd_core_bound_ms(*args, **kw) -> tuple[float, str]:
    """Least time for one call of kernel P on an H100: its bytes over the HBM
    rate, or its products at the 3xTF32 rate and the rest at fp32
    (``ssd_core_work``'s arguments)."""
    return bound_from(*ssd_core_work(*args, **kw), product_flops=TF32_FLOPS / 3)


def load_split_probe():
    """``tools/probes/probe_split_ssd_torch.py``, loaded by path."""
    import importlib.util

    path = os.path.join(ROOT, "tools", "probes", "probe_split_ssd_torch.py")
    spec = importlib.util.spec_from_file_location("probe_split_ssd_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_ssd_core(card: str) -> dict:
    import torch

    from diffma_tpu_torch.ops.fused_ssd import ssd_core_cuda, ssd_core_ref, ssd_mixer_fused_cuda
    from diffma_tpu_torch.utils.profiling import profile_calls

    print("== phase 2m: kernel P (the split SSD probe's core) against its plain version, and the "
          "probe's split form against whole kernel E", flush=True)
    probe = load_split_probe()
    path_err = None
    for batch in (8, 1):  # zx (48, 196, 2096), then (6, 196, 2096)
        x12, ws = probe.inputs(batch, seed=batch, device="cuda")
        with torch.no_grad():
            zxs = probe.gathered_streams(x12, ws)
            got, want = ssd_core_cuda(zxs, ws), ssd_core_ref(zxs, ws)
            torch.cuda.synchronize()
            err = close_to_ref(f"kernel P, zx {tuple(zxs.shape)}", got, want)
            if not torch.equal(got, ssd_core_cuda(zxs, ws)):
                fail(f"two calls of ssd_core_fwd gave different bits, zx {tuple(zxs.shape)}")
            whole, split = probe.whole_dual(x12, ws), probe.split_dual(x12, ws)
            torch.cuda.synchronize()
            split_err = close_to_ref(f"the split form against whole kernel E, B={batch}", split,
                                     whole, TOL_MODEL)
        print(f"  zx {tuple(zxs.shape)}: kernel P max|err| {err:.3e}, two calls equal bits (tol "
              f"{TOL_FP32 * max(1.0, want.abs().max().item()):.1e}); split form (P) against whole "
              f"E, B={batch}: max|diff| {split_err:.3e} (tol "
              f"{TOL_MODEL * max(1.0, whole.abs().max().item()):.1e})")
        if path_err is None:
            path_err = err
    x12, ws = probe.inputs(8, seed=8, device="cuda")
    with torch.no_grad():
        zxs = probe.gathered_streams(x12, ws)
        # The probe holds D and norm_w at one on both branches: draw them off
        # one, and different per branch, so that the D skip and each
        # branch's choice of weights show in the comparison.
        gen = torch.Generator(device="cuda").manual_seed(80)
        ws_off = tuple(w._replace(D=1.0 + 0.5 * torch.randn(w.D.shape, generator=gen, device="cuda"),
                                  norm_w=1.0 + 0.5 * torch.randn(w.norm_w.shape, generator=gen,
                                                                 device="cuda"))
                       for w in ws)
        want = ssd_core_ref(zxs, ws_off)
        off_err = close_to_ref(f"kernel P, zx {tuple(zxs.shape)}, D and norm_w random per branch",
                               ssd_core_cuda(zxs, ws_off), want)
        print(f"  zx {tuple(zxs.shape)}, D and norm_w drawn off one per branch: kernel P max|err| "
              f"{off_err:.3e} (tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
        path_err = max(path_err, off_err)
        # Decay rates from 1 to 16 and dt near 1.3: each head's span of dt * |A|
        # over the 196 steps in the thousands, every cross-chunk decay 0.
        ws_wide = tuple(w._replace(A_log=torch.log(torch.linspace(1.0, 16.0, w.A_log.numel(),
                                                                  device="cuda")),
                                   dt_bias=torch.ones_like(w.dt_bias)) for w in ws)
        want = ssd_core_ref(zxs, ws_wide)
        wide_err = close_to_ref(f"kernel P, zx {tuple(zxs.shape)}, a wide span",
                                ssd_core_cuda(zxs, ws_wide), want)
        dt = torch.nn.functional.softplus(zxs[:24, :, -16:] + 1.0)
        span = (dt.sum(1) * torch.linspace(1.0, 16.0, 16, device="cuda")).max().item()
        if span < 1000:
            fail(f"the wide-span case of kernel P has a span of only {span:.0f}")
        zx25 = zxs[:4, :25].contiguous()  # one ragged chunk
        want25 = ssd_core_ref(zx25, ws)
        err25 = close_to_ref("kernel P, zx (4, 25, 2096)", ssd_core_cuda(zx25, ws), want25)
        print(f"  a span of dt*|A| of {span:.0f}: kernel P max|err| {wide_err:.3e}; zx (4, 25, "
              f"2096): {err25:.3e}")
        path_err = max(path_err, wide_err, err25)
        ms = cuda_ms(lambda: ssd_core_cuda(zxs, ws), reps=50)
        plain_ms = cuda_ms(lambda: ssd_core_ref(zxs, ws), reps=10)
        e_ms = cuda_ms(lambda: ssd_mixer_fused_cuda(probe.SPEC, tuple(x12), ws), reps=20)
        e_prof = profile_calls(lambda: ssd_mixer_fused_cuda(probe.SPEC, tuple(x12), ws),
                               calls=10)
        p_stages = stage_table(lambda: ssd_core_cuda(zxs, ws), CORE_STAGES)
    core = dict(G=48, L=196, d=1024, n=16, H=16, K=4)
    bound_ms, bound_by = ssd_core_bound_ms(**core)
    fp32_ms, fp32_by = bound_from(*ssd_core_work(**core))
    e_core = sum(stage_ms(e_prof, k) for k in ("ssd_state_kernel", "ssd_out_kernel",
                                                "gate_norm_merge"))
    print(f"  [{card}] ssd_core_fwd (kernel P) fp32, zx (48, 196, 2096): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us ({bound_by}, products at the 3xTF32 "
          f"rate); all at fp32 {fp32_ms * 1e3:.2f} us ({fp32_by})")
    print(f"  [{card}] device ms per call by stage (torch.profiler): kernel P's "
          f"{stage_line(p_stages)}; the same stages inside whole kernel E (both branches, B=8) "
          f"{e_core:.4f} of whole E's {e_ms:.4f} ms (CUDA events)")
    print("  library_ms: none; no single PyTorch call computes the SSD core")
    return {
        "name": "ssd_core_fwd",
        "route": "cuda",
        "source": "diffma_tpu_torch/csrc/ssd_core_fwd.cu",
        "replaces": "tools/probes/probe_split_ssd.py:44",
        "max_abs_err": path_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bound_fp32_ms": fp32_ms,
        "busy_ms": p_stages["total"],
        "stages_ms": p_stages,
        "whole_e_ms": e_ms,
        "e_core_stages_ms": e_core,
    }


def phase_split_probe(card: str) -> tuple[int, int]:
    """The probe's entry point on the card as it runs by default, bf16 then
    fp32 (24d: its bf16 half); returns kernel P's fp32 and bf16 launches."""
    print("== phase 2n (and 24d): the split SSD probe's entry point "
          "(tools/probes/probe_split_ssd_torch.py) at both dtypes, bf16 first, batch 8, 50 "
          "chained calls of each form", flush=True)
    probe = load_split_probe()
    zero = {name: 0 for name in kernel_counters()}
    reset_counts()
    out = probe.main(["--batch", "8"])
    calls = probe.CHAIN + 2  # the comparison call, the warm-up, the chain
    if list(out) != ["bfloat16", "float32"]:
        fail(f"the probe ran {list(out)}, not bf16 then fp32")
    counts = check_counts("the split probe at both dtypes", {
        **zero, "ssd_mixer_fwd": calls, "ssd_core_fwd": calls, "ssd_mixer_fwd_bf16": calls,
        "ssd_core_fwd_bf16": calls})
    for name, tol, mean_tol in (("bfloat16", TOL_C_BF16, TOL_C_BF16_MEAN),
                                ("float32", TOL_MODEL, None)):
        res = out[name]
        bar = tol * max(1.0, res["max_abs_ref"])
        if not res["max_abs_diff"] <= bar or (mean_tol is not None and not res["rel"] <= mean_tol):
            fail(f"the probe's split form differs from whole kernel E at {name}: max |diff| "
                 f"{res['max_abs_diff']:.3e} (bar {bar:.1e}), mean-rel {res['rel']:.2e}")
        print(f"  [{card}] {name}: whole (kernel E) {res['whole_ms']:.4f} ms, split (kernel P) "
              f"{res['split_ms']:.4f} ms per dual-mixer call; max|diff| {res['max_abs_diff']:.3e} "
              f"(bar {bar:.1e}), mean-rel {res['rel']:.2e}")
    return counts["ssd_core_fwd"], counts["ssd_core_fwd_bf16"]


def phase_inner_path(card: str) -> int:
    import torch

    from diffma_tpu_torch.models.mamba import Mamba

    print("== phase 3e: Mamba(512, scan_impl='fused') on a spec kernel C cannot run (4 atrous "
          "streams and their reverses): kernel H on the path", flush=True)
    spec = doubled_atrous_spec(14)
    if spec.fwd.shape != (8, 49) or spec.merge.shape != (196, 2):
        fail(f"the doubled-atrous spec has streams {spec.fwd.shape} and merge {spec.merge.shape}")
    m = random_(Mamba(512, spec, scan_impl="fused"), 900).cuda().eval()
    zero = {name: 0 for name in kernel_counters()}
    for batch in (1, 8):
        x = torch.randn(batch, 196, 512, generator=torch.Generator().manual_seed(batch)).cuda()
        with torch.no_grad():
            reset_counts()
            got = m(x)
            check_counts(f"Mamba on the doubled-atrous spec, B={batch}",
                         {**zero, "mamba_inner_fwd": 1})
            m.scan_impl = "ref"
            want = m(x)
            m.scan_impl = "fused"
        torch.cuda.synchronize()
        err = close_to_ref(f"Mamba through kernel H, B={batch}", got, want)
        print(f"  B={batch} L=196, 8 streams of 49 steps: max|fused - plain route| {err:.3e}  "
              f"(tol {TOL_FP32 * max(1.0, want.abs().max().item()):.1e})")
    calls = 8 * 250  # blocks x steps: a DDPM-250 chain's worth of one B/2 model's mixers
    x = torch.randn(1, 196, 512, generator=torch.Generator().manual_seed(3)).cuda()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(calls):
            x = x + 0.01 * m(x)  # each call feeds the next, as a chain's steps do
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = check_counts("2000 Mamba forwards through kernel H", {**zero, "mamba_inner_fwd": calls})
    if not bool(torch.isfinite(x).all()):
        fail("2000 Mamba forwards through kernel H left a non-finite value")
    print(f"  [{card}] {calls} forwards at batch 1 in {seconds:.3f} s ({seconds / calls * 1e3:.4f} ms "
          f"each, host clock), every one through kernel H, none through kernel C")
    return counts["mamba_inner_fwd"]


FAMILY_MODELS = ("ZigMa-B/2", "ViM-B/2", "VMamba-B/2", "EMamba-B/2", "DiT-B/2")


def seeded_model(name: str, seed: int, **kw):
    """A registry model on the CPU whose every parameter is seeded noise (std
    0.3 / sqrt(fan-in) on top of the init), so that the blocks' gates are
    open and the mixers shape the output."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    model = build_model(name, input_size=28, **kw)
    return random_(model.init_weights(torch.Generator().manual_seed(seed)), seed, scale=0.3)


def phase_family_forwards(card: str) -> None:
    import torch

    from diffma_tpu_torch.utils.profiling import profile_denoiser

    print("== phase 3f: full-width forward of each other family (B/2: depth 8, hidden 512, 196 "
          "tokens), fused route against the plain one", flush=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()
    inputs = (x, t, y, y2, w)
    zero = {name: 0 for name in kernel_counters()}
    for name in FAMILY_MODELS:
        for use_mamba2 in (False, True):
            dit = name.startswith("DiT")
            if dit and use_mamba2:
                continue  # DiT has no mixer
            model = seeded_model(name, 21, scan_impl="fused", use_mamba2=use_mamba2).cuda().eval()
            kernel = "ssd_mixer_fwd" if use_mamba2 else "mixer_fused_fwd"
            reset_counts()
            with torch.no_grad():
                got = model(*inputs)
            check_counts(f"the {name} forward", zero if dit else {**zero, kernel: 8})
            report = profile_denoiser(model, inputs, calls=5)
            with torch.no_grad():
                event_ms = cuda_ms(lambda: model(*inputs), reps=10)
                if not dit:
                    model.set_scan_impl("ref")
                want = model(*inputs)
            if tuple(got.shape) != (1, 8, 28, 28):
                fail(f"the {name} forward gave shape {tuple(got.shape)}")
            err = close_to_ref(f"{name} forward, use_mamba2={use_mamba2}", got, want, TOL_MODEL)
            mixer = "no mixer" if dit else ("Mamba-2, kernel E" if use_mamba2 else "Mamba-1, kernel C")
            print(f"  [{card}] {name} ({mixer}): max|fused - plain| {err:.3e} (max|ref| "
                  f"{want.abs().max().item():.3f}, tol {TOL_MODEL * max(1.0, want.abs().max().item()):.1e}); "
                  f"{event_ms:.3f} ms per forward at batch 1 (CUDA events); under the profiler "
                  f"{report['ms_per_call']:.3f} ms wall, device busy "
                  f"{report['device_busy_ms_per_call']:.3f} ms, idle share "
                  f"{report['device_idle_share']:.3f}, {report['kernels_per_call']:.0f} device "
                  f"kernels per forward")
            del model
    torch.cuda.empty_cache()


def write_checkpoint(path: str, name: str, seed: int, use_mamba2: bool = False) -> None:
    """A reference-format checkpoint of ``seeded_model(name, seed)``."""
    import torch

    model = seeded_model(name, seed, use_mamba2=use_mamba2)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)


def phase_family_samplers(card: str) -> None:
    import tempfile

    from diffma_tpu_torch.train import sample

    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    zero = {name: 0 for name in kernel_counters()}
    runs = (
        # name, use_mamba2, the kernel of its path, its calls: blocks x 250 steps
        ("ViM-B/2", False, "mixer_fused_fwd", 8 * 250),
        ("EMamba-B/2", False, "mixer_fused_fwd", 8 * 250),
        ("VMamba-BL/2", False, "mixer_fused_fwd", 13 * 250),
        ("EMamba-B/2", True, "ssd_mixer_fwd", 8 * 250),
        ("ZigMa-B/2", True, "ssd_mixer_fwd", 8 * 250),
        ("DiT-SB/2", False, None, 0),
    )
    for i, (name, use_mamba2, kernel, calls) in enumerate(runs):
        flag = ["--use-mamba2"] if use_mamba2 else []
        print(f"== phase 14.{i + 1}: sampler CLI on configs/brain.yaml --model {name} "
              f"{' '.join(flag)} from a checkpoint, DDPM-250, 1 image", flush=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            path = os.path.join(tmp, "0050000.pt")
            write_checkpoint(path, name, 50 + i, use_mamba2)
            reset_counts()
            images = sample.cli([
                "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model", name, *flag,
                "--ckpt", path, "--num-batches", "1",
            ])
        check_counts(f"the {name} sampler", {**zero, kernel: calls} if kernel else zero)
        check_images(card, f"the {name}{' --use-mamba2' if use_mamba2 else ''} sampler", images, 1)


def phase_family_trainers(card: str) -> dict:
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train

    zero = {name: 0 for name in kernel_counters()}
    calls = 8 * 5  # blocks x steps: one mixer per block
    runs = (
        ("VMamba-B/2", {}, "fused (kernels C + D, 4 streams)",
         {"mixer_fused_fwd": calls, "mixer_fused_bwd": calls}),
        ("ViM-B/2", {"scan_impl": "auto"}, "scan_impl: auto (kernels A + B)",
         {"selective_scan_fwd": calls, "selective_scan_bwd": calls}),
    )
    for i, (name, extra, what, expect) in enumerate(runs):
        print(f"== phase 15.{i + 1}: trainer on configs/brain.yaml, {name}, batch 8, 5 steps, {what}",
              flush=True)
        results = os.path.join(ROOT, "results", f"chip_smoke_train_family_{i}")
        shutil.rmtree(results, ignore_errors=True)
        cfg = brain_config(model=name, max_steps=5, log_every=5, ckpt_every=10**9,
                           results_dir=results, **extra)
        reset_counts()
        state = train.main(cfg, device="cuda")
        check_counts(f"the {name} trainer", {**zero, **expect})
        if int(state.step) != 5:
            fail(f"the {name} trainer counted {int(state.step)} finite steps of 5")
        init = build_model(name, input_size=28).init_weights(
            torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
        still = moved_from_init(state.model, init)
        if still:
            fail(f"{still} tensors of the {name} params did not move in 5 steps")
        (exp,) = os.listdir(results)
        steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
        print(f"  [{card}] {name} training, batch 8, steps 1-5 (first step included): {steps_s} "
              f"steps/s, {images_s} images/s; every parameter moved")
        shutil.rmtree(results, ignore_errors=True)
        del state
        torch.cuda.empty_cache()

    counts = {}
    runs = (
        ("ViM-B/2", [], "kernels C + D, the vim quirk", "mixer_fused_fwd", "mixer_fused_bwd"),
        ("EMamba-B/2", [], "kernels C + D, the partition", "mixer_fused_fwd", "mixer_fused_bwd"),
        ("EMamba-B/2", ["--use-mamba2"], "kernels E + F, the partition", "ssd_mixer_fwd",
         "ssd_mixer_bwd"),
    )
    for i, (name, flag, what, fwd, bwd) in enumerate(runs):
        print(f"== phase 15.{i + 3}: trainer CLI on configs/brain.yaml --model {name} "
              f"{' '.join(flag)}, batch 8, 5 steps on the fused route ({what})", flush=True)
        results = os.path.join(ROOT, "results", f"chip_smoke_train_fused_{i}")
        shutil.rmtree(results, ignore_errors=True)
        reset_counts()
        t0 = time.perf_counter()
        state = train.cli([
            "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model", name, *flag,
            "--max-steps", "5", "--ckpt-every", str(10**9), "--results-dir", results,
        ])
        seconds = time.perf_counter() - t0
        key = f"{name}{' --use-mamba2' if flag else ''}"
        counts[key] = check_counts(f"the fused {key} trainer", {**zero, fwd: calls, bwd: calls})
        if int(state.step) != 5:
            fail(f"the fused {key} trainer counted {int(state.step)} finite steps of 5")
        if state.model.blocks[0].scan_impl != "fused":
            fail(f"the {key} trainer's default route is not the fused one")
        init = build_model(name, input_size=28, use_mamba2=bool(flag)).init_weights(
            torch.Generator().manual_seed(int(brain_config().global_seed))).state_dict()
        still = moved_from_init(state.model, init)
        if still:
            fail(f"{still} tensors of the fused {key} params did not move in 5 steps")
        print(f"  [{card}] {key} fused training, batch 8: 5 steps, every parameter moved; "
              f"{seconds:.1f} s for the whole CLI run (host clock, model init and first step "
              f"included)")
        shutil.rmtree(results, ignore_errors=True)
        del state
        torch.cuda.empty_cache()
    return counts


def phase_forward(card: str) -> None:
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    print("== phase 3: full-width DiffMa-B/2 forward: plain scan, kernel A, kernel C",
          flush=True)
    model = build_model("DiffMa-B/2", input_size=28)
    gen = torch.Generator().manual_seed(0)
    model.init_weights(gen)
    with torch.no_grad():
        for p in model.parameters():  # every parameter random, adaLN included
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = model.cuda().eval()
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()

    def run(impl):
        model.set_scan_impl(impl)
        with torch.no_grad():
            return model(x, t, y, y2, w)

    want = run("ref")
    got_a = run("pallas")
    ms_a = cuda_ms(lambda: run("pallas"), reps=10)
    got_c = run("fused")
    ms_c = cuda_ms(lambda: run("fused"), reps=10)
    scale = want.abs().max().item()
    tol = 1e-3 * max(1.0, scale)  # fp32 through 8 blocks, 16 mixers
    for name, got, ref, ref_name in (("kernel A", got_a, want, "plain"),
                                     ("kernel C", got_c, got_a, "kernel A")):
        err = (got - ref).abs().max().item()
        print(f"  out {tuple(got.shape)}  max|ref| {scale:.3f}  max|{name} - {ref_name}| "
              f"{err:.3e}  (tol {tol:.1e})")
        if tuple(got.shape) != (1, 8, 28, 28) or not torch.isfinite(got).all() or err > tol:
            fail(f"DiffMa-B/2 forward through {name} disagrees with the {ref_name} path")
    print(f"  [{card}] one denoiser forward at batch 1: {ms_a:.3f} ms through kernel A "
          f"(pallas), {ms_c:.3f} ms through kernel C (fused)")


def phase_train_step(card: str) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    print("== phase 3b: full-width DiffMa-B/2 training step, batch 2: plain path, "
          "kernels A + B, kernels C + D", flush=True)
    # Weights as phase 6 draws them (std 0.3 / sqrt(fan-in)), so that every
    # block's gate is open and the mixers' gradients are of order 1.
    model = build_model("DiffMa-B/2", input_size=28)
    model = random_(model.init_weights(torch.Generator().manual_seed(3)), 3, scale=0.3)
    model = model.cuda()
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(3), 2, 28, 196)
    batch["t"] = torch.tensor([10, 900], device="cuda")
    batch["noise"] = torch.randn(2, 4, 28, 28, generator=torch.Generator().manual_seed(4)).cuda()
    loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
    losses, grads = {}, {}
    zero = {name: 0 for name in kernel_counters()}
    expect = {"ref": zero, "pallas": {**zero, "selective_scan_fwd": 16, "selective_scan_bwd": 16},
              "fused": {**zero, "mixer_fused_fwd": 8, "mixer_fused_bwd": 8}}
    for impl in ("ref", "pallas", "fused"):
        model.set_scan_impl(impl)
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, _ = loss_fn(batch, None)
        loss.backward()
        torch.cuda.synchronize()
        check_counts(f"the {impl} training step", expect[impl])
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        if any(g is None for g in grads[impl].values()):
            fail(f"the {impl} path left a parameter without a gradient")
    mixer_grads = [g for n, g in grads["ref"].items() if ".mamba" in n]
    print(f"  plain path: max |gradient| {max(g.abs().max().item() for g in grads['ref'].values()):.3e} "
          f"over all parameters, {max(g.abs().max().item() for g in mixer_grads):.3e} over the "
          f"mixers' ({len(mixer_grads)} tensors)")
    for impl, what in (("pallas", "kernels A + B"), ("fused", "kernels C + D")):
        rows = grad_errors(grads[impl], grads["ref"], TOL_MODEL)
        worst = max(rows, key=lambda row: row[1] / row[2])
        rel = max((got - grads["ref"][n]).abs().max().item()
                  / max(grads["ref"][n].abs().max().item(), 1e-30)
                  for n, got in grads[impl].items())
        loss_err = abs(losses[impl] - losses["ref"])
        print(f"  {what}: loss {losses[impl]:.6f} (plain {losses['ref']:.6f}, |err| "
              f"{loss_err:.2e}); {len(rows)} gradients, max |err| "
              f"{max(e for _, e, _ in rows):.3e}, largest error relative to its tensor's "
              f"max |ref| {rel:.2e}; nearest its bar: {worst[0]} {worst[1]:.2e} "
              f"(bar {worst[2]:.1e})")
        if not math.isfinite(losses[impl]) or loss_err > TOL_MODEL * max(1.0, abs(losses["ref"])):
            fail(f"the training loss through {what} disagrees with the plain path's")


def sampler_forward_inputs() -> tuple:
    """One batch-1 forward's inputs of the DiffMa-B/2 sampler at 224² (a 28²
    latent), on the card, from seed 0: x, t, y, y2, w."""
    import torch

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 28, 28, generator=gen).cuda()
    t = torch.tensor([500], device="cuda")
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()
    return x, t, y, y2, w


def sampler_model(use_mamba2: bool):
    """DiffMa-B/2 at full width on the card, every parameter random (adaLN
    included) from seed 1, in eval mode."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    model = build_model("DiffMa-B/2", input_size=28, use_mamba2=use_mamba2)
    g = torch.Generator().manual_seed(1)
    model.init_weights(g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return model.cuda().eval()


def phase_mamba2_forward(card: str) -> None:
    import torch

    from diffma_tpu_torch.utils.profiling import profile_denoiser

    print("== phase 3c: full-width Mamba-2 DiffMa-B/2 forward: composable, dual kernel E, "
          "fuse_block (kernel E prologue + kernel G)", flush=True)
    inputs = sampler_forward_inputs()
    model = sampler_model(True)
    routes = (("composable", "auto", False, {}),
              ("dual kernel E", "fused", False, {"ssd_mixer_fwd": 8}),
              ("fuse_block", "fused", True, {"ssd_mixer_fwd": 8, "spiral_epilogue": 8}))
    outs, reports = {}, {}
    for route, impl, fuse, expect in routes:
        model.set_scan_impl(impl)
        for blk in model.blocks:
            blk.fuse_block = fuse
        reset_counts()
        with torch.no_grad():
            outs[route] = model(*inputs)
        check_counts(f"the Mamba-2 forward, {route}",
                     {name: expect.get(name, 0) for name in kernel_counters()})
        reports[route] = profile_denoiser(model, inputs, calls=5)
        with torch.no_grad():
            reports[route]["event_ms"] = cuda_ms(lambda: model(*inputs), reps=10)
    mamba1 = sampler_model(False).set_scan_impl("fused")
    reports["Mamba-1 fused (kernel C)"] = profile_denoiser(mamba1, inputs, calls=5)
    with torch.no_grad():
        reports["Mamba-1 fused (kernel C)"]["event_ms"] = cuda_ms(lambda: mamba1(*inputs), reps=10)
    want = outs.pop("composable")
    scale = want.abs().max().item()
    for route, got in outs.items():
        if tuple(got.shape) != (1, 8, 28, 28):
            fail(f"the Mamba-2 forward gave shape {tuple(got.shape)}")
        err = close_to_ref(f"Mamba-2 DiffMa-B/2 forward, {route}", got, want, TOL_MODEL)
        print(f"  out {tuple(got.shape)}  max|ref| {scale:.3f}  max|{route} - composable| "
              f"{err:.3e}  (tol {TOL_MODEL * max(1.0, scale):.1e})")
    for route, r in reports.items():
        print(f"  [{card}] {route}: {r['event_ms']:.3f} ms per forward at batch 1 (CUDA events); "
              f"under the profiler {r['ms_per_call']:.3f} ms wall, device busy "
              f"{r['device_busy_ms_per_call']:.3f} ms, idle share {r['device_idle_share']:.3f}, "
              f"{r['kernels_per_call']:.0f} device kernels per forward")


def phase_mamba2_train_step(card: str) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    print("== phase 3d: full-width Mamba-2 DiffMa-B/2 training step, batch 2: composable "
          "(torch autograd), dual (kernels E + F), fuse_block (E + G forward, recomputing "
          "backward)", flush=True)
    model = build_model("DiffMa-B/2", input_size=28, use_mamba2=True)
    model = random_(model.init_weights(torch.Generator().manual_seed(5)), 5, scale=0.3)
    model = model.cuda()
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(5), 2, 28, 196)
    batch["t"] = torch.tensor([10, 900], device="cuda")
    batch["noise"] = torch.randn(2, 4, 28, 28, generator=torch.Generator().manual_seed(6)).cuda()
    loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
    zero = {name: 0 for name in kernel_counters()}
    routes = (
        ("composable", "auto", False, zero),
        ("dual (E + F)", "fused", False, {**zero, "ssd_mixer_fwd": 8, "ssd_mixer_bwd": 8}),
        # forward E (prologue) + G per block; backward E (residual) + F per block
        ("fuse_block", "fused", True,
         {**zero, "ssd_mixer_fwd": 16, "spiral_epilogue": 8, "ssd_mixer_bwd": 8}),
    )
    losses, grads = {}, {}
    for route, impl, fuse, expect in routes:
        model.set_scan_impl(impl)
        for blk in model.blocks:
            blk.fuse_block = fuse
        model.zero_grad(set_to_none=True)
        reset_counts()
        loss, _ = loss_fn(batch, None)
        loss.backward()
        torch.cuda.synchronize()
        check_counts(f"the Mamba-2 training step, {route}", expect)
        losses[route] = loss.item()
        grads[route] = {n: p.grad for n, p in model.named_parameters()}
        if any(g is None for g in grads[route].values()):
            fail(f"the Mamba-2 {route} route left a parameter without a gradient")
    ref = grads["composable"]
    mixer_grads = [g for n, g in ref.items() if ".mamba" in n]
    print(f"  composable route: max |gradient| {max(g.abs().max().item() for g in ref.values()):.3e} "
          f"over all parameters, {max(g.abs().max().item() for g in mixer_grads):.3e} over the "
          f"mixers' ({len(mixer_grads)} tensors)")
    for route in ("dual (E + F)", "fuse_block"):
        rows = grad_errors(grads[route], ref, TOL_MODEL)
        worst = max(rows, key=lambda row: row[1] / row[2])
        rel = max((got - ref[n]).abs().max().item() / max(ref[n].abs().max().item(), 1e-30)
                  for n, got in grads[route].items())
        loss_err = abs(losses[route] - losses["composable"])
        print(f"  {route}: loss {losses[route]:.6f} (composable {losses['composable']:.6f}, |err| "
              f"{loss_err:.2e}); {len(rows)} gradients, max |err| "
              f"{max(e for _, e, _ in rows):.3e}, largest error relative to its tensor's "
              f"max |ref| {rel:.2e}; nearest its bar: {worst[0]} {worst[1]:.2e} "
              f"(bar {worst[2]:.1e})")
        if (not math.isfinite(losses[route])
                or loss_err > TOL_MODEL * max(1.0, abs(losses["composable"]))):
            fail(f"the Mamba-2 training loss on the {route} route disagrees with the "
                 f"composable route's")


def phase_family_train_steps(card: str) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.train.train import make_loss_fn, synthetic_batch

    print("== phase 3g: full-width B/2 training step, batch 2, fused route against the plain "
          "one: ViM-B/2 and EMamba-B/2 (kernels C + D), EMamba-B/2 --use-mamba2 (E + F)",
          flush=True)
    zero = {name: 0 for name in kernel_counters()}
    runs = (
        ("ViM-B/2", False, "ref", {"mixer_fused_fwd": 8, "mixer_fused_bwd": 8}),
        ("EMamba-B/2", False, "ref", {"mixer_fused_fwd": 8, "mixer_fused_bwd": 8}),
        ("EMamba-B/2", True, "auto", {"ssd_mixer_fwd": 8, "ssd_mixer_bwd": 8}),
    )
    for i, (name, use_mamba2, plain, fused_calls) in enumerate(runs):
        model = seeded_model(name, 60 + i, use_mamba2=use_mamba2).cuda()
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        batch = synthetic_batch(gen, 2, 28, 196)
        batch["t"] = torch.tensor([10, 900], device="cuda")
        batch["noise"] = torch.randn(2, 4, 28, 28,
                                     generator=torch.Generator().manual_seed(61 + i)).cuda()
        loss_fn = make_loss_fn(model, create_diffusion("", device="cuda"))
        losses, grads = {}, {}
        for impl, expect in ((plain, zero), ("fused", {**zero, **fused_calls})):
            model.set_scan_impl(impl)
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss, _ = loss_fn(batch, None)
            loss.backward()
            torch.cuda.synchronize()
            check_counts(f"the {name} training step, {impl}", expect)
            losses[impl] = loss.item()
            grads[impl] = {n: p.grad for n, p in model.named_parameters()}
            if any(g is None for g in grads[impl].values()):
                fail(f"the {name} {impl} route left a parameter without a gradient")
        rows = grad_errors(grads["fused"], grads[plain], TOL_MODEL)
        worst = max(rows, key=lambda row: row[1] / row[2])
        loss_err = abs(losses["fused"] - losses[plain])
        mixer = "Mamba-2, E + F" if use_mamba2 else "Mamba-1, C + D"
        print(f"  {name} ({mixer}): loss {losses['fused']:.6f} (plain {losses[plain]:.6f}, |err| "
              f"{loss_err:.2e}); {len(rows)} gradients, max |err| {max(e for _, e, _ in rows):.3e}; "
              f"nearest its bar: {worst[0]} {worst[1]:.2e} (bar {worst[2]:.1e})")
        if not math.isfinite(losses["fused"]) or loss_err > TOL_MODEL * max(1.0, abs(losses[plain])):
            fail(f"the {name} training loss on the fused route disagrees with the plain route's")
        del model
    torch.cuda.empty_cache()


def write_mamba2_checkpoint(path: str) -> dict:
    """A reference-format checkpoint of a Mamba-2 DiffMa-B/2 whose every
    parameter is seeded noise (std 0.3 / sqrt(fan-in), as phase 6's), so that
    the blocks' gates are open and the mixers shape the image; returns the
    state dict written."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model

    model = build_model("DiffMa-B/2", input_size=28, use_mamba2=True)
    model = random_(model.init_weights(torch.Generator().manual_seed(42)), 42, scale=0.3)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)
    return model.state_dict()


def phase_mamba2_samplers(card: str) -> dict:
    import tempfile

    import numpy as np
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint

    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    calls = 8 * 250  # blocks x steps: one kernel E call per block and step, per image
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        written = write_mamba2_checkpoint(path)

        print("== phase 10: Mamba-2 sampler, CLI on configs/brain.yaml --model DiffMa-B/2 "
              "--use-mamba2 from a checkpoint, DDPM-250, 2 batches of 1 (kernel E)", flush=True)
        reset_counts()
        dual = sample.cli([
            "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model", "DiffMa-B/2",
            "--use-mamba2", "--ckpt", path, "--num-batches", "2",
        ])
        counts = check_counts("the Mamba-2 sampler", {name: 0 for name in kernel_counters()}
                              | {"ssd_mixer_fwd": 2 * calls})
        loaded = sample.load_model(
            brain_config(model="DiffMa-B/2", use_mamba2=True, ckpt=path), "cuda")
        for key, value in loaded.state_dict().items():
            if not torch.equal(value.cpu(), written[key]):
                fail(f"the sampler's model does not hold the checkpoint's {key}")
        if loaded.blocks[0].scan_impl != "fused" or loaded.blocks[0].fuse_block:
            fail("the Mamba-2 sampler's default route is not the dual fused one")

        print("== phase 11: block-fused Mamba-2 sampler (fuse_block: kernel E prologue + "
              "kernel G), same checkpoint and seed, 1 batch of 1", flush=True)
        cfg = brain_config(
            model="DiffMa-B/2", synthetic_data=True, sample_global_batch_size=1,
            sample_num_steps=250, sample_num_batches=1,
            save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_fuse_block"),
        )
        model = build_model("DiffMa-B/2", input_size=28, scan_impl="fused", use_mamba2=True,
                            fuse_block=True)
        load_diffma_checkpoint(model, path, "ema")
        reset_counts()
        whole = sample.sample_batches(model.cuda().eval(), cfg, device="cuda")
        counts |= {"spiral_epilogue": check_counts(
            "the block-fused Mamba-2 sampler", {name: 0 for name in kernel_counters()}
            | {"ssd_mixer_fwd": calls, "spiral_epilogue": calls})["spiral_epilogue"]}
    check_images(card, "the Mamba-2 sampler", dual, 2)
    check_images(card, "the block-fused Mamba-2 sampler", whole, 1)
    a, b = dual[0]["images"], whole[0]["images"]
    err, scale = float(np.abs(a - b).max()), float(np.abs(a).max())
    bar = TOL_IMAGE * max(1.0, scale)
    print(f"  first image, dual route against fuse_block, same seed: max |diff| {err:.3e} "
          f"(max |image| {scale:.3f}, bar {bar:.1e}); image std {a.std():.4f}")
    if err > bar:
        fail(f"the two Mamba-2 routes' images differ by {err:.3e}, over the bar {bar:.1e}")
    return counts


def phase_mamba2_trainer(card: str, autocast: bool = False) -> tuple[dict, float]:
    """Phase 12, or with ``autocast`` phase 20b (the bf16 Mamba-2 model
    through kernels E's and F's bf16 variants); returns the counts and the
    logged steps/s."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample, train

    flags = ["--use-mamba2"] + (["--autocast"] if autocast else [])
    print(f"== phase {'20b' if autocast else '12'}: Mamba-2 trainer CLI on configs/brain.yaml "
          f"{' '.join(flags)} (DiffMa-L/2, batch 8, synthetic), 20 steps, checkpoint at step 20, "
          f"sampled back", flush=True)
    cfg = brain_config()
    results = os.path.join(ROOT, "results", "chip_smoke_train_mamba2")
    shutil.rmtree(results, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    state = train.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), *flags,
        "--max-steps", "20", "--ckpt-every", "20", "--results-dir", results,
    ])
    seconds = time.perf_counter() - t0
    zero = {name: 0 for name in kernel_counters()}
    calls = 16 * 20  # blocks x steps: one E and one F call per block and step
    suffix = "_bf16" if autocast else ""
    counts = check_counts("the Mamba-2 trainer", {**zero, f"ssd_mixer_fwd{suffix}": calls,
                                                  f"ssd_mixer_bwd{suffix}": calls})
    if int(state.step) != 20:
        fail(f"the Mamba-2 trainer counted {int(state.step)} finite steps of 20")
    if not state.model.blocks[0].use_mamba2 or state.model.blocks[0].scan_impl != "fused":
        fail("the Mamba-2 trainer's default path is not the fused Mamba-2 one")
    init = build_model(cfg.model, input_size=28, use_mamba2=True).init_weights(
        torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
    for what, module in (("params", state.model), ("EMA", state.ema)):
        still = moved_from_init(module, init)
        if still:
            fail(f"{still} tensors of the Mamba-2 {what} did not move in 20 steps")
    (exp,) = os.listdir(results)
    ckpt = os.path.join(results, exp, "checkpoints", "0000020.pt")
    if not os.path.exists(ckpt):
        fail(f"the Mamba-2 trainer wrote no checkpoint at {ckpt}")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    if any(v.dtype != torch.float32 for k in ("model", "ema") for v in saved[k].values()):
        fail("the Mamba-2 trainer's checkpoint holds a tensor that is not fp32")
    loaded = sample.load_model(
        brain_config(ckpt=ckpt, use_mamba2=True, autocast=autocast or None), "cuda")
    if loaded.dtype != state.model.dtype:
        fail(f"the sampler built a {loaded.dtype} model from a {state.model.dtype} trainer's")
    ema = state.ema.state_dict()
    for key, value in loaded.state_dict().items():
        if not torch.equal(value, ema[key]):
            fail(f"the sampler's model does not hold the Mamba-2 checkpoint's EMA {key}")
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  20 steps, every loss finite; params and EMA moved; checkpoint "
          f"{os.path.getsize(ckpt) / 2**20:.0f} MiB, every tensor fp32, read back by the sampler "
          f"({loaded.dtype} model), EMA equal")
    print(f"  [{card}] DiffMa-L/2 Mamba-2 fused training{' in bf16' if autocast else ''}, batch "
          f"8, steps 11-20: {steps_s} steps/s ({1e3 / steps_s:.1f} ms a step), {images_s} "
          f"images/s ({seconds:.1f} s for the whole CLI run, init included)")
    del state, loaded
    torch.cuda.empty_cache()
    reset_counts()
    images = sample.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), *flags, "--ckpt", ckpt,
        "--num-batches", "1",
    ])
    check_counts("the sampler on the Mamba-2 trainer's checkpoint",
                 {**zero, f"ssd_mixer_fwd{suffix}": 16 * 250})  # blocks x steps, no backward
    check_images(card, "the sampler on the Mamba-2 trainer's checkpoint", images, 1)
    shutil.rmtree(results, ignore_errors=True)
    return counts, steps_s


def phase_mamba2_sizes(card: str) -> None:
    """configs/brain.yaml's larger image sizes on the fused Mamba-2 route,
    whose streams are longer than a stream held whole in shared memory
    allowed (227 steps in kernel F, about 440 in kernel E): the trainer at
    256² (256 tokens) and the sampler at 512² (1024 tokens)."""
    import torch

    from diffma_tpu_torch.train import sample, train

    zero = {name: 0 for name in kernel_counters()}
    steps = 4
    print(f"== phase 12b: Mamba-2 trainer (train.main) on configs/brain.yaml at image_size 256 "
          f"(DiffMa-L/2, 256 tokens, batch 8, synthetic), {steps} steps, kernels E + F",
          flush=True)
    results = os.path.join(ROOT, "results", "chip_smoke_train_mamba2_256")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(image_size=256, use_mamba2=True, max_steps=steps, log_every=steps,
                       ckpt_every=10**9, results_dir=results)
    reset_counts()
    t0 = time.perf_counter()
    state = train.main(cfg, device="cuda")
    seconds = time.perf_counter() - t0
    calls = 16 * steps  # blocks x steps: one E and one F call per block and step
    check_counts("the Mamba-2 trainer at 256²", {**zero, "ssd_mixer_fwd": calls,
                                                 "ssd_mixer_bwd": calls})
    if int(state.step) != steps:
        fail(f"the Mamba-2 trainer at 256² counted {int(state.step)} finite steps of {steps}")
    tokens = state.model.pos_embed.shape[-2]
    if tokens != 256 or state.model.blocks[0].scan_impl != "fused":
        fail(f"the Mamba-2 trainer at 256² ran {tokens} tokens on the "
             f"{state.model.blocks[0].scan_impl} route")
    print(f"  [{card}] DiffMa-L/2 Mamba-2 fused training at 256² ({tokens} tokens), batch 8: "
          f"{steps} steps, every loss finite; {seconds:.1f} s for the whole run (host clock, "
          f"model init and first step included)")
    shutil.rmtree(results, ignore_errors=True)
    del state
    torch.cuda.empty_cache()

    sample_steps = 10
    print(f"== phase 12c: Mamba-2 sampler (sample.main) on configs/brain.yaml at image_size 512 "
          f"(DiffMa-B/2, 1024 tokens), {sample_steps} DDPM steps, 1 batch of 1, kernel E",
          flush=True)
    cfg = brain_config(model="DiffMa-B/2", image_size=512, use_mamba2=True, synthetic_data=True,
                       sample_num_steps=sample_steps, sample_num_batches=1,
                       sample_global_batch_size=1,
                       save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_512"))
    reset_counts()
    images = sample.main(cfg, device="cuda")
    check_counts("the Mamba-2 sampler at 512²", {**zero, "ssd_mixer_fwd": 8 * sample_steps})
    check_images(card, "the Mamba-2 sampler at 512²", images, 1, size=512)


def brain_config(**override):
    from diffma_tpu_torch.utils.config import load_config, merge

    return merge(load_config(os.path.join(ROOT, "configs", "brain.yaml")), override)


def run_sampler(card: str, cfg, batches: int, expect: dict) -> list:
    """``sample.main`` with the kernels' counts set to 0 just before it;
    checks the images and that each kernel ran exactly ``expect[name]`` times."""
    from diffma_tpu_torch.train import sample

    reset_counts()
    results = sample.main(cfg, device="cuda")
    check_counts("the sampler", {name: expect.get(name, 0) for name in kernel_counters()})
    check_images(card, "the sampler", results, batches)
    return results


def check_images(card: str, what: str, results: list, batches: int, size: int = 224) -> None:
    """``batches`` batches of one finite (1, 3, size, size) image each, whose
    values vary and stay in the thousands (the VAE's weights are random, so
    its range is its own); prints the seconds per batch."""
    import numpy as np

    if len(results) != batches:
        fail(f"{what}: expected {batches} batches, got {len(results)}")
    for i, r in enumerate(results, start=1):
        img = r["images"]
        print(f"  batch {i}: images {img.shape}, {r['seconds']:.3f} s, "
              f"PSNR {r['quality']['psnr_db']:.2f} dB (random weights)")
        if img.shape != (1, 3, size, size) or not np.isfinite(img).all():
            fail(f"{what}, batch {i}: expected finite (1, 3, {size}, {size}) images, got "
                 f"{img.shape}")
        if float(np.abs(img).max()) > 1e3 or float(img.std()) == 0.0:
            fail(f"{what}, batch {i}: image values out of range or constant")
    seconds = [r["seconds"] for r in results]
    print(f"  [{card}] {what}: seconds per batch {', '.join(f'{x:.3f}' for x in seconds)}; "
          f"images/s {len(seconds) / sum(seconds):.4f} over all, {1 / seconds[-1]:.4f} last")


def phase_sampler(card: str) -> int:
    print("== phase 4: composable sampler (kernel A), DiffMa-B/2, DDPM-250, 1 batch of 1",
          flush=True)
    cfg = brain_config(
        model="DiffMa-B/2", scan_impl="pallas", synthetic_data=True,
        sample_global_batch_size=1, sample_num_steps=250, sample_num_batches=1,
        save_dir=os.path.join(ROOT, "result_sample", "chip_smoke"),
    )
    expected = 2 * 8 * 250 * 1  # mixers x blocks x steps x batches
    run_sampler(card, cfg, 1, {"selective_scan_fwd": expected})
    return expected


def phase_fused_sampler(card: str) -> int:
    print("== phase 5: default (fused) sampler, DiffMa-B/2, DDPM-250, 2 batches of 1",
          flush=True)
    cfg = brain_config(
        model="DiffMa-B/2", synthetic_data=True, sample_global_batch_size=1,
        sample_num_steps=250, sample_num_batches=2,
        save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_fused"),
    )
    if "scan_impl" in cfg:
        fail("configs/brain.yaml sets scan_impl; this phase samples with the default")
    expected = 8 * 250 * 2  # blocks x steps x batches: one call per block
    run_sampler(card, cfg, 2, {"mixer_fused_fwd": expected})
    return expected


def phase_checkpoint(card: str) -> None:
    import tempfile

    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample

    print("== phase 6: DiffMa-L/2 from a reference-format checkpoint, sampler CLI on "
          "configs/brain.yaml, 1 batch", flush=True)
    model = build_model("DiffMa-L/2", input_size=28)
    model = random_(model.init_weights(torch.Generator().manual_seed(16)), 16, scale=0.3)
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["module.pos_embed"] = model.pos_embed.reshape(1, 196, 512)  # upstream saves it too
    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        torch.save({"model": sd, "ema": sd, "opt": {}, "args": None}, path)
        reset_counts()
        t0 = time.perf_counter()
        results = sample.cli([
            "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--ckpt", path,
            "--num-batches", "1",
        ])
        seconds = time.perf_counter() - t0
        check_counts("the checkpoint sampler", {name: 0 for name in kernel_counters()}
                     | {"mixer_fused_fwd": 16 * 250})  # blocks x steps
        loaded = sample.load_model(brain_config(ckpt=path), "cuda")
    written = model.state_dict()
    for key, value in loaded.state_dict().items():
        if not torch.equal(value.cpu(), written[key]):
            fail(f"the sampler's model does not hold the checkpoint's {key}")
    print(f"  loaded {len(written)} tensors of {loaded.depth}-block "
          f"{brain_config().model}, equal to the written ones")
    img = results[0]["images"]
    if len(results) != 1 or img.shape != (1, 3, 224, 224) or not math.isfinite(float(abs(img).max())):
        fail(f"expected one batch of finite (1, 3, 224, 224) images, got {img.shape}")
    print(f"  [{card}] batch 1: {results[0]['seconds']:.3f} s ({seconds:.3f} s with loading)")


def trainer_log_rate(exp_dir: str) -> tuple[float, float]:
    """The last (steps/s, images/s) the trainer logged in ``exp_dir``."""
    with open(os.path.join(exp_dir, "log_0.txt")) as f:
        found = re.findall(r"Train Steps/Sec: ([0-9.]+), Images/Sec: ([0-9.]+)", f.read())
    if not found:
        fail(f"the trainer logged no throughput in {exp_dir}")
    return float(found[-1][0]), float(found[-1][1])


def moved_from_init(module, init_state: dict) -> int:
    """How many of ``module``'s parameters still equal their init."""
    import torch

    state = module.state_dict()
    return sum(torch.equal(state[k].cpu(), v) for k, v in init_state.items())


def phase_trainer(card: str, autocast: bool = False) -> tuple[dict, float]:
    """Phase 7, or with ``autocast`` phase 19b (the bf16 model through kernels
    C's and D's bf16 variants); returns the counts and the logged steps/s."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample, train

    flag = ["--autocast"] if autocast else []
    print(f"== phase {'19b' if autocast else '7'}: trainer CLI on configs/brain.yaml "
          f"{' '.join(flag)} (DiffMa-L/2, batch 8, synthetic), 20 steps, checkpoint at step 20",
          flush=True)
    cfg = brain_config()
    if "scan_impl" in cfg:
        fail("configs/brain.yaml sets scan_impl; this phase trains with the default")
    results = os.path.join(ROOT, "results", "chip_smoke_train")
    shutil.rmtree(results, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    state = train.cli([
        "--config", os.path.join(ROOT, "configs", "brain.yaml"), "--max-steps", "20",
        "--ckpt-every", "20", "--results-dir", results, *flag,
    ])
    seconds = time.perf_counter() - t0
    zero = {name: 0 for name in kernel_counters()}
    calls = 16 * 20  # blocks x steps: one C and one D call per block and step
    suffix = "_bf16" if autocast else ""
    counts = check_counts("the trainer", {**zero, f"mixer_fused_fwd{suffix}": calls,
                                          f"mixer_fused_bwd{suffix}": calls})
    if int(state.step) != 20:
        fail(f"the trainer counted {int(state.step)} finite steps of 20")
    init = build_model(cfg.model, input_size=28).init_weights(
        torch.Generator().manual_seed(int(cfg.global_seed))).state_dict()
    for what, module in (("params", state.model), ("EMA", state.ema)):
        still = moved_from_init(module, init)
        if still:
            fail(f"{still} tensors of the {what} did not move in 20 steps")
    (exp,) = os.listdir(results)
    ckpt = os.path.join(results, exp, "checkpoints", "0000020.pt")
    if not os.path.exists(ckpt):
        fail(f"the trainer wrote no checkpoint at {ckpt}")
    loaded = sample.load_model(brain_config(ckpt=ckpt, autocast=autocast or None), "cuda")
    ema = state.ema.state_dict()
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    if any(v.dtype != torch.float32 for k in ("model", "ema") for v in saved[k].values()):
        fail("the trainer's checkpoint holds a tensor that is not fp32")
    if loaded.dtype != state.model.dtype:
        fail(f"the sampler built a {loaded.dtype} model from a {state.model.dtype} trainer's")
    for key, value in loaded.state_dict().items():
        if not torch.equal(value, ema[key]):
            fail(f"the sampler's model does not hold the checkpoint's EMA {key}")
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  20 steps, every loss finite; params and EMA moved; checkpoint "
          f"{os.path.getsize(ckpt) / 2**20:.0f} MiB, every tensor fp32, read back by the "
          f"sampler ({loaded.dtype} model), EMA equal")
    print(f"  [{card}] DiffMa-L/2 fused training{' in bf16' if autocast else ''}, batch 8, steps "
          f"11-20: {steps_s} steps/s ({1e3 / steps_s:.1f} ms a step), {images_s} images/s "
          f"({seconds:.1f} s for the whole CLI run, build and init included)")
    shutil.rmtree(results, ignore_errors=True)
    return counts, steps_s


def phase_composable_trainer(card: str) -> dict:
    from diffma_tpu_torch.train import train

    print("== phase 8: composable trainer (kernels A + B), DiffMa-B/2, batch 8, 5 steps",
          flush=True)
    results = os.path.join(ROOT, "results", "chip_smoke_train_composable")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(model="DiffMa-B/2", scan_impl="pallas", max_steps=5, log_every=5,
                       ckpt_every=10**9, results_dir=results)
    reset_counts()
    state = train.main(cfg, device="cuda")
    zero = {name: 0 for name in kernel_counters()}
    calls = 2 * 8 * 5  # mixers x blocks x steps
    counts = check_counts("the composable trainer", {**zero, "selective_scan_fwd": calls,
                                                     "selective_scan_bwd": calls})
    if int(state.step) != 5:
        fail(f"the composable trainer counted {int(state.step)} finite steps of 5")
    (exp,) = os.listdir(results)
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  [{card}] DiffMa-B/2 composable training, batch 8, steps 1-5 (first step "
          f"included): {steps_s} steps/s, {images_s} images/s")
    shutil.rmtree(results, ignore_errors=True)
    return counts


def phase_learning(card: str, phase, use_mamba2: bool, model: str = "DiffMa-B/2",
                   autocast: bool = False) -> None:
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train

    steps = 100
    family = ("Mamba-2 (use_mamba2) " if use_mamba2 else "") + ("bf16 " if autocast else "")
    print(f"== phase {phase}: does it learn: {model} {family}fused, one fixed batch of 8, "
          f"lr 1e-3, {steps} steps", flush=True)
    results = os.path.join(ROOT, "results", f"chip_smoke_overfit_{phase}")
    shutil.rmtree(results, ignore_errors=True)
    cfg = brain_config(model=model, overfit_fixed_batch=True, lr=1e-3, max_steps=steps,
                       log_every=10, ckpt_every=10**9, results_dir=results,
                       use_mamba2=use_mamba2, autocast=autocast or None)
    seed = int(cfg.global_seed)
    # The trainer's fixed batch, and one fixed (t, noise) to evaluate at.
    batch = train.synthetic_batch(torch.Generator(device="cuda").manual_seed(seed + 1), 8, 28,
                                  196)
    t = torch.randint(0, 1000, (8,), generator=torch.Generator().manual_seed(7)).cuda()
    noise = torch.randn(8, 4, 28, 28, generator=torch.Generator().manual_seed(8)).cuda()
    diffusion = create_diffusion("", device="cuda")

    def mse(model) -> float:
        with torch.no_grad():
            terms = diffusion.training_losses(
                train.fp32_output(model), batch["z"], t, noise=noise,
                model_kwargs={"y": batch["y"], "y2": batch["y2"], "w": batch["w"]})
        return terms["mse"].mean().item()

    init = build_model(model, input_size=28, scan_impl="fused", use_mamba2=use_mamba2,
                       dtype=train.compute_dtype(cfg))
    before = mse(init.init_weights(torch.Generator().manual_seed(seed)).cuda().eval())
    state = train.main(cfg, device="cuda")
    after = mse(state.model.eval())
    (exp,) = os.listdir(results)
    steps_s, images_s = trainer_log_rate(os.path.join(results, exp))
    print(f"  MSE term at the fixed (t, noise): {before:.5f} before, {after:.5f} after "
          f"{steps} steps: fell {before / after:.2f}x (at least 2x required)")
    print(f"  [{card}] {model} {family}fused training, batch 8, steps {steps - 9}-{steps}: "
          f"{steps_s} steps/s, {images_s} images/s")
    if int(state.step) != steps or not after * 2 <= before:
        fail(f"the MSE term fell {before / after:.2f}x in {steps} steps, not 2x")
    shutil.rmtree(results, ignore_errors=True)


def stack_work(cond, x) -> dict:
    """[fp32 operations, bytes] of one encode of ``x`` (B, 3, H, W) by each
    part of ``cond``: the products of every conv, linear, patch embedding and
    attention, counted with forward hooks at this run's shapes; each input
    read and each output written once, with the weights."""
    import torch

    from diffma_tpu_torch.models.clip_vit import _Attention
    from diffma_tpu_torch.models.layers import PatchEmbed
    from diffma_tpu_torch.models.vae import AttnBlock

    def count(flops):
        def hook(module, inputs, out):
            x = inputs[0]
            if isinstance(module, torch.nn.Conv2d):  # PatchEmbed runs its proj's weight itself
                flops[0] += 2 * out.numel() * module.weight[0].numel()
            elif isinstance(module, torch.nn.Linear):
                flops[0] += 2 * out.numel() * module.in_features
            elif isinstance(module, PatchEmbed):
                flops[0] += 2 * out.numel() * module.proj.weight[0].numel()
            elif isinstance(module, AttnBlock):  # QK^T and AV over the pixels
                flops[0] += 4 * x.shape[0] * (x.shape[2] * x.shape[3]) ** 2 * x.shape[1]
            else:  # _Attention: over the tokens, all heads
                flops[0] += 4 * x.shape[0] * x.shape[1] ** 2 * x.shape[2]
        return hook

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    work, handles = {}, []
    for part, module in (("vae", cond.vae), ("clip", cond.clip), ("ct", cond.ct)):
        work[part] = [0, nbytes(*module.parameters())]
        handles += [m.register_forward_hook(count(work[part])) for m in module.modules()
                    if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, PatchEmbed, AttnBlock,
                                      _Attention))]
    with torch.no_grad():
        lat = cond.vae.encode_sample(x)
        w, y2 = cond.ct(lat)
        y = cond.clip(x)
    for h in handles:
        h.remove()
    work["vae"][1] += nbytes(x, lat) - nbytes(*cond.vae.decoder.parameters(),
                                              *cond.vae.post_quant_conv.parameters())
    work["clip"][1] += nbytes(x, y)
    work["ct"][1] += nbytes(lat, w, y2)
    return work


def phase_conditioning(card: str) -> None:
    import tempfile

    import numpy as np
    import torch

    from diffma_tpu_torch.train.train import Conditioning
    from diffma_tpu_torch.utils.logging import create_logger
    from diffma_tpu_torch.utils.profiling import profile_calls

    print("== phase 17a: the conditioning stack at full width (SD-VAE, BiomedCLIP ViT-B/16 at "
          "224², CT encoder 28 x 28 x 4, patch 2, 512 wide), seeded weights: the card against "
          "the CPU, then ms per call at batch 8", flush=True)
    cfg = brain_config(ct_ckpt=None)
    with tempfile.TemporaryDirectory() as tmp:
        logger = create_logger(tmp)
        ref = Conditioning(cfg, logger, "cpu", seed=17)
        cond = Conditioning(cfg, logger, "cuda", seed=17)
        logger.close()
    rng = np.random.default_rng(17)

    def images(b, scale):
        return torch.from_numpy(np.repeat(
            scale * np.tanh(rng.standard_normal((b, 1, 224, 224))), 3, axis=1).astype(np.float32))

    x, z = images(2, 1.0), images(2, 1.6)  # the MRI outside [-1, 1]: the renorm runs
    noise = tuple(torch.from_numpy(rng.standard_normal((2, 4, 28, 28)).astype(np.float32))
                  for _ in range(2))
    want = ref(x, z, noise=noise)
    got = cond(x.cuda(), z.cuda(), noise=tuple(n.cuda() for n in noise))
    for key in ("z", "y", "y2", "w"):
        bound = max(1.0, float(want[key].abs().max()))
        err = float((got[key].cpu() - want[key]).abs().max())
        print(f"  {key} {tuple(got[key].shape)}: max |card - CPU| {err:.3e} "
              f"(bar {TOL_FP32 * bound:.3e})")
        if not torch.isfinite(got[key]).all() or err > TOL_FP32 * bound:
            fail(f"the conditioning's {key} on the card disagrees with the CPU's: {err:.3e}")

    x8, z8 = images(8, 1.0).cuda(), images(8, 1.0).cuda()
    with torch.no_grad():
        lat8 = cond.vae.encode_sample(x8)
    work = stack_work(cond, x8)
    parts = {
        "vae_encode": (lambda: cond.vae.encode_sample(x8), work["vae"]),
        "clip": (lambda: cond.clip(x8), work["clip"]),
        "ct_encoder": (lambda: cond.ct(lat8), work["ct"]),
        "encode": (lambda: cond(x8, z8), [work["vae"][0] * 2 + work["clip"][0] + work["ct"][0],
                                          work["vae"][1] * 2 + work["clip"][1] + work["ct"][1]]),
    }
    with torch.no_grad():
        for name, (fn, (flops, nbytes)) in parts.items():
            ms = cuda_ms(fn, reps=10)
            prof = profile_calls(fn, calls=3)
            t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            print(f"  [{card}] {name}, batch 8: {ms:.3f} ms per call (busy "
                  f"{prof['device_busy_ms_per_call']:.3f} ms, {prof['kernels_per_call']:.0f} "
                  f"kernels); {flops / 1e9:.1f} GFLOP, bound {max(t_ops, t_bytes):.3f} ms at the "
                  f"fp32 rate ({'operations' if t_ops >= t_bytes else 'bytes'}); "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")


def trainer_log_encode(exp_dir: str) -> list:
    with open(os.path.join(exp_dir, "log_0.txt")) as f:
        return [float(v) for v in re.findall(r"Encode ms/step: ([0-9.]+)", f.read())]


def phase_real_data(card: str) -> str:
    """17b-17e; returns the directory where 17e's PNGs are kept."""
    import tempfile

    import numpy as np
    import torch

    from diffma_tpu_torch.data.npy_dataset import write_triplet_folders
    from diffma_tpu_torch.models.ct_encoder import CTEncoder
    from diffma_tpu_torch.train import sample, train, train_embedder
    from diffma_tpu_torch.utils.torch_io import load_weights

    brain = os.path.join(ROOT, "configs", "brain.yaml")
    cfg = brain_config()
    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    here = os.getcwd()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "results")) as tmp:
        os.chdir(tmp)  # configs/brain.yaml's paths are relative: ./datasets/brain/...
        try:
            print("== phase 17b: SynthRAD-like .npy folders, 64 train and 4 val triplets of 256 x "
                  "256, where configs/brain.yaml looks for them", flush=True)
            t0 = time.perf_counter()
            root = os.path.dirname(cfg.ct_image_folder_train)
            folders = write_triplet_folders(root, 64, "train", mri_outside=8)
            folders.update(write_triplet_folders(root, 4, "test", seed=1))
            for key, folder in folders.items():
                if os.path.abspath(folder) != os.path.abspath(cfg[key]):
                    fail(f"{key}: wrote {folder}, configs/brain.yaml reads {cfg[key]}")
            print(f"  wrote {len(os.listdir(cfg.ct_image_folder_train))} + "
                  f"{len(os.listdir(cfg.ct_image_folder_val))} triplets in "
                  f"{time.perf_counter() - t0:.1f} s")

            print("== phase 17c: embedder CLI on configs/brain.yaml, 10 steps at batch 32",
                  flush=True)
            t0 = time.perf_counter()
            state = train_embedder.cli(["--config", brain, "--max-steps", "10",
                                        "--ckpt-every", "10"])
            seconds = time.perf_counter() - t0
            ckpt = os.path.join(cfg.embedder_results_dir, "000-vision_encoder", "checkpoints",
                                "0000010.pt")
            encoder = CTEncoder(img_size=28, patch_size=2, in_channels=4, embed_dim=512)
            encoder.load_state_dict(load_weights("ct", ckpt))
            for key, value in state.ema.state_dict().items():
                if not torch.equal(encoder.state_dict()[key], value.cpu()):
                    fail(f"the embedder's checkpoint does not hold its EMA {key}")
            with open(os.path.join(cfg.embedder_results_dir, "000-vision_encoder",
                                   "log_0.txt")) as f:
                losses = re.findall(r"Train Loss: ([0-9.naninf]+), Train Steps/Sec: ([0-9.]+)",
                                    f.read())
            if not losses or not all(math.isfinite(float(v)) for v, _ in losses):
                fail(f"the embedder logged no finite loss: {losses}")
            os.makedirs(os.path.dirname(cfg.ct_ckpt), exist_ok=True)
            shutil.copy(ckpt, cfg.ct_ckpt)
            print(f"  10 steps, loss {losses[-1][0]}; checkpoint loads into a CTEncoder and is "
                  f"ct_ckpt now; [{card}] {losses[-1][1]} steps/s over steps 1-10 "
                  f"({seconds:.1f} s for the CLI run)")

            print("== phase 17d: trainer CLI on configs/brain.yaml (DiffMa-L/2, batch 8) on the "
                  "folders, ct_ckpt from 17c, 20 steps, every batch encoded", flush=True)
            zero = {name: 0 for name in kernel_counters()}
            runs = (("", 20, {"mixer_fused_fwd": 320, "mixer_fused_bwd": 320}),
                    ("--use-mamba2", 4, {"ssd_mixer_fwd": 64, "ssd_mixer_bwd": 64}))
            for flag, steps, expect in runs:
                results = os.path.join(tmp, "results", f"train{flag}")
                reset_counts()
                state = train.cli(["--config", brain, "--max-steps", str(steps), "--ckpt-every",
                                   str(steps), "--results-dir", results] + ([flag] if flag else []))
                check_counts(f"the real-data trainer {flag}", {**zero, **expect})
                if int(state.step) != steps:
                    fail(f"the real-data trainer counted {int(state.step)} finite steps of {steps}")
                (exp,) = os.listdir(results)
                with open(os.path.join(results, exp, "log_0.txt")) as f:
                    log = f.read()
                if "Dataset contains 64." not in log or "ct-encoder: importing weights" not in log:
                    fail("the real-data trainer did not read the folders and ct_ckpt")
                encode = trainer_log_encode(os.path.join(results, exp))
                if flag:
                    print(f"  {steps} steps {flag}: every loss finite")
                    continue
                steps_s, _ = trainer_log_rate(os.path.join(results, exp))
                print(f"  [{card}] DiffMa-L/2 real-data training, batch 8, steps 11-20: "
                      f"{1e3 / steps_s:.1f} ms per step ({steps_s} steps/s), of which the encode "
                      f"span {encode[-1]:.2f} ms per step on the device (steps 1-10: "
                      f"{encode[0]:.2f})")
                train_ckpt = os.path.join(results, exp, "checkpoints", f"{steps:07d}.pt")

            print("== phase 17e: sampler CLI from 17d's checkpoint on the val folders, DDPM-250, "
                  "2 images, decoded by the stack's VAE", flush=True)
            reset_counts()
            results = sample.cli(["--config", brain, "--ckpt", train_ckpt, "--num-batches", "2"])
            check_counts("the real-data sampler", {**zero, "mixer_fused_fwd": 16 * 250 * 2})
            check_images(card, "the real-data sampler", results, 2)
            grids = sorted(os.listdir(cfg.save_dir))
            want = sorted(f"{i}_sample_{k}.png" for i in (1, 2) for k in ("ct", "gen", "ori"))
            if grids != want:
                fail(f"the sampler wrote {grids}, not {want}")
            for i, r in enumerate(results, start=1):
                q = r["quality"]
                if not np.isfinite([q["psnr_db"], q["ssim"]]).all():
                    fail(f"image {i}: PSNR/SSIM not finite: {q}")
                print(f"  image {i}: PSNR {q['psnr_db']:.2f} dB, SSIM {q['ssim']:.4f} against "
                      f"the val MRI (random conditioning weights, 20 training steps)")
            kept = os.path.join(ROOT, "results", "phase17e_samples")  # for phase 22c's tool
            shutil.rmtree(kept, ignore_errors=True)
            shutil.copytree(cfg.save_dir, kept)
        finally:
            os.chdir(here)
    return kept


GRAPH_ROUTES = (  # route, use_mamba2, scan_impl, fuse_block, kernel calls per forward
    ("Mamba-1 fused (C)", False, "fused", False, {"mixer_fused_fwd": 8}),
    ("Mamba-2 dual (E)", True, "fused", False, {"ssd_mixer_fwd": 8}),
    ("fuse_block (E + G)", True, "fused", True, {"ssd_mixer_fwd": 8, "spiral_epilogue": 8}),
    ("composable (A)", False, "pallas", False, {"selective_scan_fwd": 16}),
)


def route_model(use_mamba2: bool, impl: str, fuse: bool):
    model = sampler_model(use_mamba2).set_scan_impl(impl)
    for blk in model.blocks:
        blk.fuse_block = fuse
    return model


def phase_graphed_chains(card: str) -> None:
    import numpy as np
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.diffusion.gaussian import ChainGraph
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.train.train import synthetic_batch
    from diffma_tpu_torch.utils.profiling import profile_calls

    print("== phase 18a: the B/2 sampler's chain as a CUDA graph against the eager loop, same "
          "seed and weights: DDPM-250 at batch 1, DDIM-50 at batch 1 and 2, 2 batches each, on "
          "four routes", flush=True)
    zero = {name: 0 for name in kernel_counters()}
    for route, use_mamba2, impl, fuse, per_forward in GRAPH_ROUTES:
        model = route_model(use_mamba2, impl, fuse)
        for steps, ddim, batches in ((250, False, (1,)), (50, True, (1, 2))):
            loop = f"DDIM-{steps}" if ddim else f"DDPM-{steps}"
            for batch in batches:
                cfg = brain_config(
                    model="DiffMa-B/2", synthetic_data=True, sample_global_batch_size=batch,
                    sample_num_steps=steps, use_ddim=ddim, sample_num_batches=2,
                    save_dir=os.path.join(ROOT, "result_sample", "chip_smoke_graphs"))
                expect = {**zero, **{k: v * steps * 2 for k, v in per_forward.items()}}
                runs = {}
                for graphed in (False, True):
                    reset_counts()
                    runs[graphed] = sample.sample_batches(model, cfg, "cuda", graphed=graphed)
                    check_counts(f"{route} {loop} batch {batch} graphed={graphed}", expect)
                errs = []
                for got, want in zip(runs[True], runs[False]):
                    a, b = got["images"], want["images"]
                    if a.shape != (batch, 3, 224, 224) or not np.isfinite(a).all():
                        fail(f"{route} {loop}: the graphed chain gave {a.shape} or a non-finite "
                             f"value")
                    err = float(np.abs(a - b).max())
                    bar = TOL_IMAGE * max(1.0, float(np.abs(b).max()))
                    if err > bar:
                        fail(f"{route} {loop} batch {batch}: graphed images differ from the eager "
                             f"ones by {err:.3e}, over the bar {bar:.1e}")
                    errs.append("equal in bits" if np.array_equal(a, b)
                                else f"max |diff| {err:.3e}")
                first = runs[True][0]
                print(f"  [{card}] {route} {loop} batch {batch}: images {', '.join(errs)}; "
                      f"s a batch "
                      f"eager {runs[False][0]['seconds']:.3f}, {runs[False][1]['seconds']:.3f}; "
                      f"graphed {first['seconds']:.3f} (capture {first['capture_seconds']:.3f} s, "
                      f"pool {first['pool_bytes'] / 2**20:.1f} MiB), "
                      f"{runs[True][1]['seconds']:.3f}")

        # The chain alone, DDIM-50 at batch 1: replays with no synchronizing
        # call, and the device's busy time and idle share both ways.
        diffusion = create_diffusion("50", device="cuda")
        b = synthetic_batch(torch.Generator(device="cuda").manual_seed(5), 1, 28, 196)
        z = torch.randn(1, 4, 28, 28, generator=torch.Generator(device="cuda").manual_seed(6),
                        device="cuda")
        kw = {"y": b["y"], "y2": b["y2"], "w": b["w"]}
        chain = ChainGraph("cuda")

        def run(graph, seed=7):
            return diffusion.ddim_sample_loop(
                model, z.shape, torch.Generator(device="cuda").manual_seed(seed), noise=z,
                clip_denoised=False, model_kwargs=kw, graph=graph)

        want = run(None)
        first = run(chain)
        gen = torch.Generator(device="cuda").manual_seed(7)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = diffusion.ddim_sample_loop(model, z.shape, gen, noise=z, clip_denoised=False,
                                               model_kwargs=kw, graph=chain)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if not (torch.equal(first, want) and torch.equal(again, want)):
            close_to_ref(f"{route}: the graphed DDIM-50 chain", first, want, TOL_IMAGE)
            close_to_ref(f"{route}: its replays under the sync check", again, want, TOL_IMAGE)
        reports = {"eager": profile_calls(lambda: run(None), calls=1),
                   "graphed": profile_calls(lambda: run(chain), calls=1)}
        print(f"  [{card}] {route} DDIM-50 chain, batch 1: replays under "
              f"set_sync_debug_mode('error') ran, equal to the eager chain "
              f"{'in bits' if torch.equal(again, want) else 'within TOL_IMAGE'}; "
              + "; ".join(f"{mode} {r['ms_per_call']:.1f} ms, device busy "
                          f"{r['device_busy_ms_per_call']:.1f} ms, idle share "
                          f"{r['device_idle_share']:.3f}, {r['kernels_per_call']:.0f} kernels"
                          for mode, r in reports.items()))
        del model, chain
        torch.cuda.empty_cache()


def phase_graphed_steps(card: str) -> dict:
    """Phase 18b; returns the Mamba-1 fp32 step's profile."""
    import copy

    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.ops.masked_adamw import masked_adamw_cuda
    from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train import loss_draws, make_loss_fn, synthetic_batch
    from diffma_tpu_torch.utils.profiling import profile_train_step

    steps, nan_at = 20, 9  # the NaN batch is step 10
    print(f"== phase 18b: the L/2 training step as a CUDA graph against the eager step, batch 8, "
          f"{steps} steps, a NaN batch at step {nan_at + 1}", flush=True)
    zero = {name: 0 for name in kernel_counters()}
    diffusion = create_diffusion("", device="cuda")
    for label, use_mamba2, per_step in (
            ("Mamba-1 fused (C + D)", False, {"mixer_fused_fwd": 16, "mixer_fused_bwd": 16}),
            ("Mamba-2 fused (E + F)", True, {"ssd_mixer_fwd": 16, "ssd_mixer_bwd": 16})):
        model = build_model("DiffMa-L/2", input_size=28, scan_impl="fused", use_mamba2=use_mamba2)
        model = model.init_weights(torch.Generator().manual_seed(0)).cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(9)
        batches = []
        for i in range(steps):
            b = synthetic_batch(gen, 8, 28, 196)
            b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
            if i == nan_at:
                b["z"][0, 0, 0, 0] = float("nan")
            batches.append(b)

        def tensors(st):
            return ([p.detach() for p in st.model.parameters()] + list(st.ema.parameters())
                    + [v for p in st.model.parameters() for v in st.optimizer.state[p].values()]
                    + [st.step])

        states = {}
        for graphed in (False, True):
            m = copy.deepcopy(model)
            optimizer = adamw(m.parameters(), 1e-4)
            st = TrainState(m, optimizer)
            step = make_train_step(make_loss_fn(m, diffusion), optimizer)
            if graphed:
                step = GraphedTrainStep(step, "cuda")
            reset_counts()
            finite = []
            for i, b in enumerate(batches):
                if i == nan_at:
                    before = [t.clone() for t in tensors(st)]
                # The eager step's first call and the graph's warm-up and
                # capture run outside the check (a capture synchronizes).
                if i >= (2 if graphed else 1):
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    finite.append(step(st, b, None)["finite"])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if i == nan_at:
                    after = [t.clone() for t in tensors(st)]
            mode = "graphed" if graphed else "eager"
            check_counts(f"the {label} {mode} steps", {**zero, **{k: v * steps for k, v in
                                                                   per_step.items()}})
            if masked_adamw_cuda.launches != steps:
                fail(f"the {label} {mode} steps ran masked_adamw {masked_adamw_cuda.launches} "
                     f"times, not {steps}")
            flags = torch.stack(finite).tolist()
            if flags != [i != nan_at for i in range(steps)] or int(st.step) != steps - 1:
                fail(f"{label} {mode}: finite flags {flags}, step count {int(st.step)}")
            moved = [i for i, (x, y) in enumerate(zip(before, after))
                     if not torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                        y.view(torch.int32) if y.dtype == torch.float32 else y)]
            if moved:
                fail(f"{label} {mode}: the NaN step changed {len(moved)} of {len(before)} tensors")
            print(f"  {label} {mode}: {steps} steps under set_sync_debug_mode('error') from step "
                  f"{3 if graphed else 2}; the NaN step left all {len(before)} tensors (params, "
                  f"EMA, AdamW's state, the step count) equal in bits; step count {int(st.step)}")
            states[mode] = st
        worst, equal = 0.0, 0
        for what in ("model", "ema"):
            want = getattr(states["eager"], what).state_dict()
            for key, value in getattr(states["graphed"], what).state_dict().items():
                err = close_to_ref(f"{label} graphed {what} {key}", value, want[key], TOL_STEP)
                worst, equal = max(worst, err), equal + int(torch.equal(value, want[key]))
        print(f"  {label}: graphed params and EMA against eager after {steps} steps: {equal} of "
              f"{2 * len(want)} tensors equal in bits, max |diff| {worst:.3e} (bar {TOL_STEP:g} "
              f"of max(1, max |ref|))")
        del model, states, st, batches
        torch.cuda.empty_cache()

        report = profile_train_step("DiffMa-L/2", 8, "fused", use_mamba2=use_mamba2)
        print_step_report(card, f"DiffMa-L/2 {label}, synthetic", report)
        if not use_mamba2:
            fp32_report = report
        torch.cuda.empty_cache()
    report = profile_train_step("DiffMa-L/2", 8, "fused", real_data=True)
    print_step_report(card, "DiffMa-L/2 Mamba-1 fused (C + D), real-data batches encoded", report)
    return fp32_report


def print_step_report(card: str, what: str, report: dict) -> None:
    print(f"  [{card}] {what}, batch 8: ms a step on the host clock, eager "
          + ", ".join(f"{x:.2f}" for x in report["ms_per_step_eager"]) + "; graphed "
          + ", ".join(f"{x:.2f}" for x in report["ms_per_step_graphed"])
          + f" (capture {report['capture_seconds']:.3f} s, pool "
          f"{report['pool_bytes'] / 2**20:.0f} MiB)")
    for mode in ("eager", "graphed"):
        r = report[mode]
        print(f"    under the profiler, {mode}: {r['ms_per_call']:.2f} ms a step, device busy "
              f"{r['device_busy_ms_per_call']:.2f} ms, idle share {r['device_idle_share']:.3f}, "
              f"{r['kernels_per_call']:.0f} kernels a step")
    top = report["graphed"]["top_kernels_ms_per_call"]
    print("    graphed, top device ms a step: "
          + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in top.items()))

# ---- phase 19: bf16


def mixer_bf16_case(family: str, layer: int, batch: int, seed: int) -> tuple:
    """Phase 19a's case: the spec of ``family`` at grid 14, its mixers'
    weights (two for spiral) and x and g in bf16 for each mixer."""
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    h, bf16 = 512, torch.bfloat16
    spec = build_scan_spec(family, 14, layer)
    M = 2 if family == "spiral" else 1
    ws = [random_(Mamba(h, spec), seed + m).cuda().weights() for m in range(M)]
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(batch, 196, h, generator=gen).cuda().to(bf16) for _ in range(M)]
    gs = [torch.randn(batch, 196, h, generator=gen).cuda().to(bf16) for _ in range(M)]
    return spec, ws, xs, gs


def phase_bf16_kernels(card: str, mixer: dict, mixer_bwd: dict,
                       stage_tables: dict) -> tuple[dict, dict]:
    """19a: kernels C's and D's bf16 variants against their bf16 plain
    versions, each case twice with equal bits; their times, stages
    (``stage_tables``) and bounds at the bf16 rate beside the fp32 variants'
    (``mixer``, ``mixer_bwd``: phases 2b and 2d of this run)."""
    import torch

    from diffma_tpu_torch.ops.fused_mixer import (
        MixerWeights,
        mixer_bwd_ref,
        mixer_fused_bwd_cuda,
        mixer_fused_cuda,
        mixer_ref,
    )

    print("== phase 19a: kernels C and D in bf16 against their bf16 plain versions on the card",
          flush=True)
    h, bf16 = 512, torch.bfloat16
    case = mixer_bf16_case

    def mean_rel(a, b) -> float:
        return ((a.float() - b.float()).abs().mean() / b.float().abs().mean()).item()

    fwd_err = bwd_err = None
    for label, family, layer, batch in (("dual, B/2 sampler", "spiral", 0, 1),
                                        ("dual, training", "spiral", 0, 8),
                                        ("vim quirk", "vim", 0, 1),
                                        ("EfficientVMamba partition", "eff", 0, 1),
                                        ("zig", "zig", 2, 1)):
        spec, ws, xs, _ = case(family, layer, batch, 300 + layer)
        with torch.no_grad():
            got, again = (mixer_fused_cuda(spec, xs, ws) for _ in range(2))
            want = [mixer_ref(spec, x, w) for x, w in zip(xs, ws)]
        torch.cuda.synchronize()
        errs, rels = [], []
        for g, a, w in zip(got, again, want):
            if g.dtype != bf16 or g.shape != w.shape or not bool(torch.isfinite(g.float()).all()):
                fail(f"C bf16, {label}: wrong dtype {g.dtype}, shape or a non-finite value")
            if not torch.equal(g, a):
                fail(f"C bf16, {label}: a second call gave other bits")
            err, bar = (g.float() - w.float()).abs().max().item(), TOL_C_BF16 * max(
                1.0, w.float().abs().max().item())
            if err > bar or mean_rel(g, w) > TOL_C_BF16_MEAN:
                fail(f"C bf16, {label}: max |err| {err:.3e} (bar {bar:.2e}), mean-rel "
                     f"{mean_rel(g, w):.2e} (bar {TOL_C_BF16_MEAN:g})")
            errs.append(err)
            rels.append(mean_rel(g, w))
        print(f"  C bf16, {label}: B={batch} L=196, {len(xs)} mixer(s): max|err| "
              f"{max(errs):.3e}, mean-rel {max(rels):.2e}; equal bits on a second call")
        if fwd_err is None:
            fwd_err = max(errs)
    for label, family, layer, batch in (("dual, training", "spiral", 0, 8),
                                        ("vim quirk", "vim", 0, 8),
                                        ("EfficientVMamba partition", "eff", 0, 8),
                                        ("zig", "zig", 2, 2)):
        spec, ws, xs, gs = case(family, layer, batch, 400 + layer)
        got, again = (mixer_fused_bwd_cuda(spec, xs, gs, ws) for _ in range(2))
        torch.cuda.synchronize()
        worst = ("", 0.0)
        for m in range(len(xs)):
            gx_ref, gw_ref = mixer_bwd_ref(spec, xs[m], gs[m], ws[m])
            names = ["gx", *(f"w{m}.{f}" for f in MixerWeights._fields)]
            for name, a, b, ref in zip(names, (got[0][m], *got[1][m]), (again[0][m], *again[1][m]),
                                       (gx_ref, *gw_ref)):
                want_dtype = bf16 if name == "gx" else torch.float32
                if a.dtype != want_dtype or not bool(torch.isfinite(a).all()):
                    fail(f"D bf16, {label}: {name} is {a.dtype} (not {want_dtype}) or not finite")
                if not torch.equal(a, b):
                    fail(f"D bf16, {label}: a second call gave other bits in {name}")
                rel = mean_rel(a, ref)
                if rel > TOL_D_BF16:
                    fail(f"D bf16, {label}: {name} mean-rel {rel:.2e} over {TOL_D_BF16:g}")
                if rel > worst[1]:
                    worst = (name, rel)
                if label == "dual, training":  # the training path's case
                    err = (a.float() - ref.float()).abs().max().item()
                    bwd_err = max(bwd_err or 0.0, err)
        print(f"  D bf16, {label}: B={batch} L=196, {10 * len(xs)} gradient tensors within "
              f"mean-rel {TOL_D_BF16:g}; the largest {worst[0]} {worst[1]:.2e}; equal bits on a "
              f"second call")

    spec, ws, xs, gs = case("spiral", 0, 1, 500)
    _, _, x8, g8 = case("spiral", 0, 8, 501)
    with torch.no_grad():
        ms = cuda_ms(lambda: mixer_fused_cuda(spec, xs, ws), reps=50)
        plain_ms = cuda_ms(lambda: [mixer_ref(spec, x, w) for x, w in zip(xs, ws)], reps=5)
        ms8 = cuda_ms(lambda: mixer_fused_cuda(spec, x8, ws), reps=20)
    bwd_ms = cuda_ms(lambda: mixer_fused_bwd_cuda(spec, x8, g8, ws), reps=10)
    bwd_plain_ms = cuda_ms(lambda: [mixer_bwd_ref(spec, x, g, w) for x, g, w in zip(x8, g8, ws)],
                           reps=5)
    stages, stages8, bwd_stages = (stage_tables[k] for k in ("C", "C_B8", "D"))
    dims = dict(M=2, L=196, h=h, d=1024, n=16, r=32, S=3, K=4, act_bytes=2)
    bound = bound_from(*mixer_work(B=1, **dims), product_flops=BF16_FLOPS)
    bound8 = bound_from(*mixer_work(B=8, **dims), product_flops=BF16_FLOPS)
    bwd_bound = bound_from(*mixer_bwd_work(B=8, **dims), product_flops=BF16_FLOPS)
    print(f"  [{card}] mixer_fused_fwd bf16, both branches, B=1 L=196 h=512 d=1024: kernel "
          f"{ms:.4f} ms (fp32 variant {mixer['ms']:.4f} ms, phase 2b), plain {plain_ms:.3f} ms, "
          f"bound {bound[0] * 1e3:.2f} us ({bound[1]}, products at the bf16 rate)")
    print(f"  [{card}] device ms per call by stage (a fresh process), B=1: {stage_line(stages)}")
    print(f"  [{card}] mixer_fused_fwd bf16, both branches, B=8: kernel {ms8:.4f} ms (fp32 "
          f"variant {mixer['b8']['ms']:.4f} ms), bound {bound8[0] * 1e3:.2f} us ({bound8[1]})")
    print(f"  [{card}] device ms per call by stage (a fresh process), B=8: {stage_line(stages8)}")
    print(f"  [{card}] mixer_fused_bwd bf16, both branches, B=8 L=196: kernel {bwd_ms:.4f} ms "
          f"(fp32 variant {mixer_bwd['ms']:.4f} ms, phase 2d), plain {bwd_plain_ms:.3f} ms, bound "
          f"{bwd_bound[0] * 1e3:.2f} us ({bwd_bound[1]}, products at the bf16 rate)")
    print(f"  [{card}] device ms per call by stage (a fresh process): {stage_line(bwd_stages)}")
    print("  library_ms: none; no single PyTorch call computes the whole mixer or its backward")
    common = dict(route="cuda", library_ms=None)
    fwd = {"name": "mixer_fused_fwd_bf16", "source": "diffma_tpu_torch/csrc/fused_mixer_fwd.cu",
           "replaces": "diffma_tpu/ops/fused_mixer.py:104", "max_abs_err": fwd_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], **common,
           "fp32_ms": mixer["ms"], "stages_ms": stages,
           "b8": {"ms": ms8, "bound_ms": bound8[0], "fp32_ms": mixer["b8"]["ms"],
                  "stages_ms": stages8}}
    bwd = {"name": "mixer_fused_bwd_bf16", "source": "diffma_tpu_torch/csrc/fused_mixer_bwd.cu",
           "replaces": "diffma_tpu/ops/fused_mixer.py:565", "max_abs_err": bwd_err, "ms": bwd_ms,
           "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
           **common, "fp32_ms": mixer_bwd["ms"], "stages_ms": bwd_stages}
    return fwd, bwd


def phase_bf16_sampler(card: str, use_mamba2: bool = False) -> tuple[int, list]:
    """19c, or with ``use_mamba2`` 20c: the sampler's CLI with ``--autocast``
    on DiffMa-B/2 from a seeded checkpoint; the graphed image against the
    eager loop's in bits, and against the fp32 model's by PSNR. Returns the
    CLI's bf16 C (or E) calls and its images."""
    import tempfile

    import numpy as np

    from diffma_tpu_torch.train import sample

    batches = 2
    mixer = ["--use-mamba2"] if use_mamba2 else []
    print(f"== phase {'20c' if use_mamba2 else '19c'}: sampler CLI on configs/brain.yaml --model "
          f"DiffMa-B/2 {' '.join(mixer + ['--autocast'])} from a checkpoint, DDPM-250, {batches} "
          f"batches of 1; then the eager loop and the fp32 model on its seed", flush=True)
    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    zero = {name: 0 for name in kernel_counters()}
    calls = 8 * 250 * batches  # blocks x steps x batches: one C (or E) call per block
    kernel = "ssd_mixer_fwd_bf16" if use_mamba2 else "mixer_fused_fwd_bf16"
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        write_checkpoint(path, "DiffMa-B/2", 19, use_mamba2=use_mamba2)
        reset_counts()
        graphed = sample.cli(["--config", os.path.join(ROOT, "configs", "brain.yaml"), "--model",
                              "DiffMa-B/2", "--ckpt", path, "--num-batches", str(batches),
                              "--autocast", *mixer])
        check_counts("the bf16 sampler", {**zero, kernel: calls})
        check_images(card, "the bf16 sampler (graphed)", graphed, batches)
        cfg = dict(model="DiffMa-B/2", ckpt=path, sample_num_batches=batches,
                   save_dir=os.path.join(tmp, "images"), use_mamba2=use_mamba2 or None)
        model = sample.load_model(brain_config(**cfg, autocast=True), "cuda")
        eager = sample.sample_batches(model, brain_config(**cfg, autocast=True), "cuda",
                                      graphed=False)
        fp32 = sample.main(brain_config(**cfg), device="cuda")
    for i, (a, b, ref) in enumerate(zip(*([r["images"] for r in run]
                                          for run in (graphed, eager, fp32))), start=1):
        if not np.array_equal(a, b):
            fail(f"batch {i}: the bf16 graphed chain's image differs from the eager loop's: "
                 f"max |diff| {np.abs(a - b).max():.3e}")
        span = float(ref.max() - ref.min())
        psnr = 10 * math.log10(span**2 / max(float(np.mean((a - ref) ** 2)), 1e-30))
        print(f"  batch {i}: the graphed image equals the eager loop's in bits; PSNR of the bf16 "
              f"image against the fp32 model's from the same seed and weights: {psnr:.2f} dB "
              f"over the fp32 image's range {span:.3f} (information, no bar)")
    print(f"  [{card}] DDPM-250, seconds per batch: bf16 graphed "
          + ", ".join(f"{r['seconds']:.3f}" for r in graphed) + "; bf16 eager "
          + ", ".join(f"{r['seconds']:.3f}" for r in eager) + "; fp32 graphed "
          + ", ".join(f"{r['seconds']:.3f}" for r in fp32))
    return calls, graphed


def phase_bf16_step_profile(card: str, fp32_report: dict) -> None:
    """19e: the graphed L/2 bf16 step profiled beside phase 18b's fp32 step."""
    import torch

    from diffma_tpu_torch.utils.profiling import profile_train_step

    print("== phase 19e: the DiffMa-L/2 bf16 training step (fused: C and D in bf16), batch 8, "
          "eager and graphed, profiled and timed", flush=True)
    report = profile_train_step("DiffMa-L/2", 8, "fused", dtype=torch.bfloat16)
    print_step_report(card, "DiffMa-L/2 Mamba-1 fused bf16 (C + D bf16), synthetic", report)
    print(f"  [{card}] graphed step, bf16 against fp32 (phase 18b): host ms a step "
          f"{min(report['ms_per_step_graphed']):.2f} against "
          f"{min(fp32_report['ms_per_step_graphed']):.2f}; device busy "
          f"{report['graphed']['device_busy_ms_per_call']:.2f} against "
          f"{fp32_report['graphed']['device_busy_ms_per_call']:.2f} ms; idle share "
          f"{report['graphed']['device_idle_share']:.3f} against "
          f"{fp32_report['graphed']['device_idle_share']:.3f}")

# ---- phase 20: bf16 Mamba-2


def bf16_close(what: str, got, again, want, tol=TOL_C_BF16,
               mean_tol=TOL_C_BF16_MEAN) -> tuple[float, float]:
    """A bf16 variant's output against its bf16 plain version at ``tol`` of
    max(1, max |ref|) and ``mean_tol`` mean-rel (kernel C bf16's bars by
    default) and against a second call in bits; (max |err|, mean-rel)."""
    import torch

    if got.dtype != torch.bfloat16 or got.shape != want.shape or not bool(
            torch.isfinite(got.float()).all()):
        fail(f"{what}: wrong dtype {got.dtype}, shape or a non-finite value")
    if not torch.equal(got, again):
        fail(f"{what}: a second call gave other bits")
    diff = (got.float() - want.float()).abs()
    err, rel = diff.max().item(), (diff.mean() / want.float().abs().mean()).item()
    bar = tol * max(1.0, want.float().abs().max().item())
    if err > bar or rel > mean_tol:
        fail(f"{what}: max |err| {err:.3e} (bar {bar:.2e}), mean-rel {rel:.2e} "
             f"(bar {mean_tol:g})")
    return err, rel


def ssd_bf16_bound(work, act_bytes) -> tuple[float, str]:
    """The bound of a bf16 variant of E or F from ``work`` = (products, other,
    bytes) as the fp32 variant's work function gives them: every product, the
    SSD's included, at the bf16 rate (bf16 operands, fp32 sums: the function
    the variant computes, whatever units it runs them on), the rest at fp32,
    and the activations' ``act_bytes`` fp32 bytes at 2 bytes an element."""
    products, other, nbytes = work
    return bound_from(products, other, nbytes - act_bytes // 2, product_flops=BF16_FLOPS)


def ssd_bf16_case(family: str, grid_n: int, layer: int, batch: int, seed: int) -> tuple:
    """Phase 20a's case: the spec of ``family``, its Mamba-2 mixers' weights
    (two for spiral) and x and g in bf16 for each mixer."""
    import torch

    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    h, bf16 = 512, torch.bfloat16
    spec = build_scan_spec(family, grid_n, layer)
    M = 2 if family == "spiral" else 1
    ws = [m.weights() for m in mamba2_mixers(spec, seed)[:M]]
    gen = torch.Generator().manual_seed(seed)
    L = grid_n * grid_n
    xs = [torch.randn(batch, L, h, generator=gen).cuda().to(bf16) for _ in range(M)]
    gs = [torch.randn(batch, L, h, generator=gen).cuda().to(bf16) for _ in range(M)]
    return spec, ws, xs, gs


def epilogue_bf16_inputs(batch: int) -> tuple:
    """Phase 20a's inputs of kernel G's bf16 variant: o0, o1, x and the gate
    in bf16, the weights fp32."""
    import torch

    return tuple(t.to(torch.bfloat16) if i < 4 else t for i, t in enumerate(epilogue_inputs(batch)))


def phase_bf16_ssd_kernels(card: str, ssd: dict, epilogue: dict, ssd_bwd: dict,
                           stage_tables: dict) -> tuple:
    """20a: kernels E's, F's and G's bf16 variants against their bf16 plain
    versions, each case twice with equal bits; their times, stages
    (``stage_tables``) and bounds (every product at the bf16 rate) beside the
    fp32 variants' (``ssd``, ``epilogue``, ``ssd_bwd``: phases 2e, 2f and 2g
    of this run)."""
    import torch

    from diffma_tpu_torch.models.blocks import SpiralMambaBlock
    from diffma_tpu_torch.ops.fused_ssd import (
        Mamba2Weights,
        Prologue,
        mamba2_mixer_fused,
        spiral_epilogue_cuda,
        spiral_epilogue_ref,
        ssd_mixer_bwd_ref,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    print("== phase 20a: kernels E, F and G in bf16 against their bf16 plain versions on the "
          "card", flush=True)
    h, bf16 = 512, torch.bfloat16
    no_limit = (0.0, float("inf"))
    case = ssd_bf16_case

    def mean_rel(a, b) -> float:
        return ((a.float() - b.float()).abs().mean() / b.float().abs().mean()).item()

    fwd_err = bwd_err = tail_err = None
    for label, family, grid_n, layer, batch in (
            ("dual, B/2 sampler", "spiral", 14, 0, 1), ("dual, training", "spiral", 14, 3, 8),
            ("EfficientVMamba partition", "eff", 14, 1, 1), ("zig", "zig", 14, 2, 2),
            ("dual, 256 tokens", "spiral", 16, 1, 2)):
        spec, ws, xs, _ = case(family, grid_n, layer, batch, 600 + layer)
        with torch.no_grad():
            got, again = (ssd_mixer_fused_cuda(spec, xs, ws) for _ in range(2))
            want = [mamba2_mixer_fused(spec, x, w, impl="ref") for x, w in zip(xs, ws)]
        torch.cuda.synchronize()
        res = [bf16_close(f"E bf16, {label}, mixer {m}", g, a, w)
               for m, (g, a, w) in enumerate(zip(got, again, want))]
        print(f"  E bf16, {label}: B={batch} L={grid_n * grid_n}, {len(xs)} mixer(s): max|err| "
              f"{max(r[0] for r in res):.3e}, mean-rel {max(r[1] for r in res):.2e}; equal bits on "
              f"a second call")
        if fwd_err is None:
            fwd_err = max(r[0] for r in res)
    # prologue mode and kernel G, from a bf16 block's own adaLN chunks
    for batch in (1, 8):
        spec = build_scan_spec("spiral", 14, 2)
        torch.manual_seed(610)
        block = random_(SpiralMambaBlock(h, spec, use_mamba2=True, dtype=bf16), 610).cuda().eval()
        x, c, w = (t.to(bf16) for t in block_inputs(196, 610 + batch, batch))
        an, fc1, _, fc2 = block.attention_network
        with torch.no_grad():
            mod = torch.nn.functional.linear(torch.nn.functional.silu(c),
                                             block.adaLN_modulation[1].weight.to(bf16),
                                             block.adaLN_modulation[1].bias.to(bf16))
            shift, scale, gate = mod.chunk(3, dim=-1)
            pro = Prologue(w, block.norm1.weight, block.norm1.bias, shift, scale)
            ws = (block.mamba1.weights(), block.mamba2.weights())
            outs, again = (ssd_mixer_fused_cuda(spec, (x,), ws, prologue=pro) for _ in range(2))
            xm = torch.nn.functional.layer_norm(x.float(), (h,), pro.ln_w, pro.ln_b, 1e-5)
            xm = xm * (1 + scale.float()[:, None]) + shift.float()[:, None]
            want = [mamba2_mixer_fused(spec, xm.to(bf16), ws[0], impl="ref"),
                    mamba2_mixer_fused(spec, (xm * w.float()).to(bf16), ws[1], impl="ref")]
            tail = (gate, an.weight, an.bias, fc1.weight, fc1.bias, fc2.weight, fc2.bias)
            g_out, g_again = (spiral_epilogue_cuda(*want, x, *tail) for _ in range(2))
            g_want = spiral_epilogue_ref(*want, x, *tail)
        torch.cuda.synchronize()
        res = [bf16_close(f"E bf16 prologue, B={batch}, branch {m}", o, a, r)
               for m, (o, a, r) in enumerate(zip(outs, again, want))]
        g_res = bf16_close(f"G bf16, B={batch}", g_out, g_again, g_want)
        print(f"  E bf16 prologue mode, B={batch} L=196: max|err| {max(r[0] for r in res):.3e}, "
              f"mean-rel {max(r[1] for r in res):.2e}; G bf16: max|err| {g_res[0]:.3e}, mean-rel "
              f"{g_res[1]:.2e}; each twice with equal bits")
        if tail_err is None:
            tail_err = g_res[0]
    for label, family, grid_n, layer, batch in (
            ("dual, training", "spiral", 14, 0, 8), ("EfficientVMamba partition", "eff", 14, 0, 8),
            ("zig", "zig", 14, 2, 2), ("dual, 256 tokens", "spiral", 16, 1, 2)):
        spec, ws, xs, gs = case(family, grid_n, layer, batch, 700 + layer)
        with torch.no_grad():
            _, zx = ssd_mixer_fused_cuda(spec, xs, ws, want_res=True)
        got, again = (ssd_mixer_fused_bwd_cuda(spec, xs, gs, ws, zx) for _ in range(2))
        torch.cuda.synchronize()
        worst = ("", 0.0)
        for m in range(len(xs)):
            gx_ref, gw_ref = ssd_mixer_bwd_ref(spec, xs[m], gs[m], ws[m])
            names = ["gx", *(f"w{m}.{f}" for f in Mamba2Weights._fields)]
            for name, a, b, ref in zip(names, (got[0][m], *got[1][m]), (again[0][m], *again[1][m]),
                                       (gx_ref, *gw_ref)):
                want_dtype = bf16 if name == "gx" else torch.float32
                if a.dtype != want_dtype or not bool(torch.isfinite(a).all()):
                    fail(f"F bf16, {label}: {name} is {a.dtype} (not {want_dtype}) or not finite")
                if not torch.equal(a, b):
                    fail(f"F bf16, {label}: a second call gave other bits in {name}")
                rel = mean_rel(a, ref)
                if rel > TOL_D_BF16:
                    fail(f"F bf16, {label}: {name} mean-rel {rel:.2e} over {TOL_D_BF16:g}")
                if rel > worst[1]:
                    worst = (name, rel)
                if label == "dual, training":
                    bwd_err = max(bwd_err or 0.0, (a.float() - ref.float()).abs().max().item())
        print(f"  F bf16, {label}: B={batch} L={grid_n * grid_n}, {9 * len(xs)} gradient tensors "
              f"within mean-rel {TOL_D_BF16:g}; the largest {worst[0]} {worst[1]:.2e}; equal bits "
              f"on a second call")

    spec, ws, xs, gs = case("spiral", 14, 0, 1, 800)
    _, _, x8, g8 = case("spiral", 14, 0, 8, 801)
    with torch.no_grad():
        ms = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, xs, ws), reps=50)
        plain_ms = cuda_ms(lambda: [mamba2_mixer_fused(spec, x, w, impl="ref")
                                    for x, w in zip(xs, ws)], reps=5)
        ms8 = cuda_ms(lambda: ssd_mixer_fused_cuda(spec, x8, ws), reps=20)
        _, zx8 = ssd_mixer_fused_cuda(spec, x8, ws, want_res=True)
    bwd_ms = cuda_ms(lambda: ssd_mixer_fused_bwd_cuda(spec, x8, g8, ws, zx8), reps=10)
    bwd_plain_ms = cuda_ms(lambda: [ssd_mixer_bwd_ref(spec, x, g, w)
                                    for x, g, w in zip(x8, g8, ws)], reps=5)
    stages, stages8, bwd_stages = (stage_tables[k] for k in ("E", "E_B8", "F"))
    dims = dict(M=2, L=196, h=h, d=1024, n=16, H=16, S=3, K=4)
    bound = ssd_bf16_bound(ssd_mixer_work(B=1, **dims), 4 * 2 * 2 * 196 * h)
    bound8 = ssd_bf16_bound(ssd_mixer_work(B=8, **dims), 4 * 2 * 2 * 8 * 196 * h)
    bwd_bound = ssd_bf16_bound(ssd_mixer_bwd_work(B=8, **dims), 4 * 2 * 3 * 8 * 196 * h)
    print(f"  [{card}] ssd_mixer_fwd bf16, both branches, B=1 L=196 h=512 d=1024: kernel "
          f"{ms:.4f} ms (fp32 variant {ssd['ms']:.4f} ms, phase 2e), plain {plain_ms:.3f} ms, "
          f"bound {bound[0] * 1e3:.2f} us ({bound[1]}, every product, the SSD's "
          f"included, at the bf16 rate)")
    print(f"  [{card}] device ms per call by stage (a fresh process), B=1: {stage_line(stages)}")
    print(f"  [{card}] ssd_mixer_fwd bf16, both branches, B=8: kernel {ms8:.4f} ms (fp32 variant "
          f"{ssd['b8']['ms']:.4f} ms), bound {bound8[0] * 1e3:.2f} us ({bound8[1]})")
    print(f"  [{card}] device ms per call by stage (a fresh process), B=8: {stage_line(stages8)}")
    print(f"  [{card}] ssd_mixer_bwd bf16, both branches, B=8 L=196: kernel {bwd_ms:.4f} ms (fp32 "
          f"variant {ssd_bwd['ms']:.4f} ms, phase 2g), plain {bwd_plain_ms:.3f} ms, bound "
          f"{bwd_bound[0] * 1e3:.2f} us ({bwd_bound[1]}, every product at the "
          f"bf16 rate)")
    print(f"  [{card}] device ms per call by stage (a fresh process): {stage_line(bwd_stages)}")
    g_times = {}
    for batch in (1, 8):
        tail = epilogue_bf16_inputs(batch)
        with torch.no_grad():
            g_ms = cuda_ms(lambda: spiral_epilogue_cuda(*tail), reps=50)
            g_stages = stage_tables[f"G_B{batch}"]
            g_plain = cuda_ms(lambda: spiral_epilogue_ref(*tail), reps=50)
        products, other, nbytes = epilogue_work(B=batch, L=196, h=h)
        g_bound = bound_from(products, other, nbytes - 2 * (4 * batch * 196 * h + batch * h),
                             product_flops=BF16_FLOPS)
        fp32 = epilogue if batch == 1 else epilogue["b8"]
        g_times[batch] = dict(ms=g_ms, busy_ms=g_stages["total"], plain_ms=g_plain,
                              bound_ms=g_bound[0], bound_by=g_bound[1], stages_ms=g_stages)
        print(f"  [{card}] spiral_epilogue bf16, B={batch} L=196 h=512: kernel {g_ms:.4f} ms "
              f"(events), device busy {g_stages['total']:.4f} ms, a fresh process "
              f"({stage_line(g_stages)}; fp32 "
              f"variant {fp32['ms']:.4f} ms, busy {fp32['busy_ms']:.4f}, phase 2f), plain "
              f"{g_plain:.4f} ms, bound {g_bound[0] * 1e3:.2f} us ({g_bound[1]}, the product at "
              f"the bf16 rate)")
    print("  library_ms: none; no single PyTorch call computes the whole mixer, its backward or "
          "the block's tail")
    common = dict(route="cuda", library_ms=None)
    fwd = {"name": "ssd_mixer_fwd_bf16", "source": "diffma_tpu_torch/csrc/fused_ssd_fwd.cu",
           "replaces": "diffma_tpu/ops/fused_ssd.py:174", "max_abs_err": fwd_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1], **common,
           "fp32_ms": ssd["ms"], "stages_ms": stages,
           "b8": {"ms": ms8, "bound_ms": bound8[0], "fp32_ms": ssd["b8"]["ms"],
                  "stages_ms": stages8}}
    bwd = {"name": "ssd_mixer_bwd_bf16", "source": "diffma_tpu_torch/csrc/fused_ssd_bwd.cu",
           "replaces": "diffma_tpu/ops/fused_ssd.py:555", "max_abs_err": bwd_err, "ms": bwd_ms,
           "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
           **common, "fp32_ms": ssd_bwd["ms"], "stages_ms": bwd_stages}
    tail = {"name": "spiral_epilogue_bf16", "source": "diffma_tpu_torch/csrc/spiral_epilogue.cu",
            "replaces": "diffma_tpu/ops/fused_ssd.py:1131", "max_abs_err": tail_err,
            **{k: v for k, v in g_times[1].items() if k != "stages_ms"}, **common,
            "fp32_ms": epilogue["ms"], "stages_ms": g_times[1]["stages_ms"], "b8": g_times[8]}
    return fwd, bwd, tail


def phase_bf16_fuse_block(card: str, dual_images: list) -> dict:
    """20d: a bf16 ``fuse_block`` B/2 sampler, built as phase 11 builds it,
    from phase 20c's checkpoint weights (the same seed); its counts of E's
    and G's bf16 variants, and its image against phase 20c's dual route by
    PSNR. Returns the counts."""
    import tempfile

    import numpy as np
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import sample
    from diffma_tpu_torch.train.checkpoints import load_diffma_checkpoint

    print("== phase 20d: block-fused bf16 Mamba-2 sampler (fuse_block: kernel E prologue + "
          "kernel G, bf16), phase 20c's weights and seed, 1 batch of 1", flush=True)
    out_dir = os.path.join(ROOT, "result_sample")
    os.makedirs(out_dir, exist_ok=True)
    calls = 8 * 250  # blocks x steps
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "0050000.pt")
        write_checkpoint(path, "DiffMa-B/2", 19, use_mamba2=True)
        cfg = brain_config(model="DiffMa-B/2", use_mamba2=True, autocast=True,
                           sample_num_batches=1, save_dir=os.path.join(tmp, "images"))
        model = build_model("DiffMa-B/2", input_size=28, scan_impl="fused", use_mamba2=True,
                            fuse_block=True, dtype=torch.bfloat16)
        load_diffma_checkpoint(model, path, "ema")
        reset_counts()
        whole = sample.sample_batches(model.cuda().eval(), cfg, device="cuda")
        counts = check_counts("the block-fused bf16 Mamba-2 sampler",
                              {name: 0 for name in kernel_counters()}
                              | {"ssd_mixer_fwd_bf16": calls, "spiral_epilogue_bf16": calls})
    check_images(card, "the block-fused bf16 Mamba-2 sampler", whole, 1)
    a, b = whole[0]["images"], dual_images[0]["images"]
    span = float(b.max() - b.min())
    psnr = 10 * math.log10(span**2 / max(float(np.mean((a - b) ** 2)), 1e-30))
    print(f"  its image against phase 20c's dual-route bf16 image, same weights and seed: PSNR "
          f"{psnr:.2f} dB over that image's range {span:.3f} (the routes round in other places; "
          f"information, no bar)")
    return counts

# ---- phase 21: resume, remat, and the rest of the diffusion API


def logged_rates(exp_dir: str) -> list:
    """Every (step, steps/s) the trainer logged in ``exp_dir``: each over the
    steps since the log before it, or since the loop began."""
    with open(os.path.join(exp_dir, "log_0.txt")) as f:
        text = f.read()
    return [(int(s), float(r)) for s, r in
            re.findall(r"\(step=(\d+)\) Train Loss: [^,]+, Train Steps/Sec: ([0-9.]+)", text)]


def run_dir(results: str) -> str:
    (exp,) = os.listdir(results)
    return os.path.join(results, exp)


def equal_states(what: str, got, want) -> int:
    """Fails unless the two ``TrainState``s hold equal bits: parameters, EMA,
    AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``, and the step count;
    returns the number of tensors compared."""
    import torch

    n = 0
    if int(got.step) != int(want.step):
        fail(f"{what}: step count {int(got.step)}, not {int(want.step)}")
    for part in ("model", "ema"):
        ref = getattr(want, part).state_dict()
        for key, value in getattr(got, part).state_dict().items():
            if not torch.equal(value, ref[key]):
                fail(f"{what}: {part} {key} differs, max |diff| "
                     f"{(value - ref[key]).abs().max().item():.3e}")
            n += 1
    for (name, p), q in zip(got.model.named_parameters(), want.model.parameters()):
        a, b = got.optimizer.state[p], want.optimizer.state[q]
        if not a.keys() == b.keys() == {"step", "exp_avg", "exp_avg_sq"}:
            fail(f"{what}: AdamW's state of {name} holds {sorted(a)} and {sorted(b)}")
        for key in a:
            if not torch.equal(a[key], b[key]):
                fail(f"{what}: AdamW's {key} of {name} differs")
            n += 1
    return n


def phase_resume(card: str, k: int = 5) -> dict:
    """21a: the trainer's CLI on configs/brain.yaml, k steps and a resume for
    k more, against 2k steps uninterrupted; returns the uninterrupted run's
    state, losses, peak memory and ms a step."""
    import torch

    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.checkpoints import restore_checkpoint

    print(f"== phase 21a: resume: the trainer's CLI on configs/brain.yaml (DiffMa-L/2, batch 8, "
          f"graphed, fused C + D), {2 * k} steps uninterrupted against {k} steps and "
          f"--resume-from for {k} more", flush=True)
    if "scan_impl" in brain_config():
        fail("configs/brain.yaml sets scan_impl; this phase trains with the default")
    root = os.path.join(ROOT, "results", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    brain = os.path.join(ROOT, "configs", "brain.yaml")
    zero = {name: 0 for name in kernel_counters()}

    def expect(steps):
        return {**zero, "mixer_fused_fwd": 16 * steps, "mixer_fused_bwd": 16 * steps}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    # the CLI's main on the CLI's config, with its per-step losses kept
    full, losses = train.main(brain_config(
        max_steps=2 * k, ckpt_every=k, log_every=k, return_loss_history=True,
        results_dir=os.path.join(root, "full")), device="cuda")
    full_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    check_counts("the uninterrupted run", expect(2 * k))
    if not losses["finite"].all():
        fail(f"the uninterrupted run had a non-finite loss: {losses['loss']}")

    reset_counts()
    t0 = time.perf_counter()
    train.cli(["--config", brain, "--max-steps", str(k), "--ckpt-every", str(k),
               "--log-every", str(k), "--results-dir", os.path.join(root, "a")])
    first_s = time.perf_counter() - t0
    check_counts("the first half", expect(k))
    ckpts = os.path.join(run_dir(os.path.join(root, "a")), "checkpoints")
    mine = restore_checkpoint(ckpts, k)
    theirs = restore_checkpoint(os.path.join(run_dir(os.path.join(root, "full")), "checkpoints"), k)
    for key in ("model", "ema"):
        for name, value in mine[key].items():
            if not torch.equal(value, theirs[key][name]):
                fail(f"the step-{k} checkpoints of the two runs differ in {key} {name}")
    if not torch.equal(mine["rng"], theirs["rng"]):
        fail(f"the step-{k} checkpoints of the two runs hold different generator states")

    reset_counts()
    t0 = time.perf_counter()
    resumed = train.cli(["--config", brain, "--max-steps", str(2 * k), "--resume-from", ckpts,
                         "--log-every", str(k), "--results-dir", os.path.join(root, "b")])
    second_s = time.perf_counter() - t0
    check_counts("the resumed half", expect(k))
    n = equal_states("resumed against uninterrupted", resumed, full)
    with open(os.path.join(run_dir(os.path.join(root, "b")), "log_0.txt")) as f:
        found = re.search(r"Resumed from .* at step (\d+) \(([0-9.]+) s\)", f.read())
    if not found or int(found.group(1)) != k:
        fail(f"the resumed run logged no resume from step {k}")
    restore_s = float(found.group(2))
    rates = {run: dict(logged_rates(run_dir(os.path.join(root, run))))
             for run in ("full", "a", "b")}
    ms = {run: {step: 1e3 / r for step, r in rs.items()} for run, rs in rates.items()}
    size = os.path.getsize(os.path.join(ckpts, f"{k:07d}.pt")) / 2**20
    print(f"  {k} steps + a resume for {k} more against {2 * k} uninterrupted: all {n} tensors "
          f"(params, EMA, AdamW's exp_avg, exp_avg_sq and step) and the step count "
          f"({int(resumed.step)}) equal in bits; the step-{k} checkpoints of both runs equal "
          f"(model, EMA, generator state)")
    print(f"  [{card}] restore of the step-{k} checkpoint ({size:.0f} MiB: model, EMA, AdamW, "
          f"generator) {restore_s:.3f} s, as the trainer logs it; ms a step over each run's "
          f"first {k} steps (eager warm-up, capture, {k - 2} replays): uninterrupted "
          f"{ms['full'][k]:.1f}, first half {ms['a'][k]:.1f}, resumed {ms['b'][2 * k]:.1f}; "
          f"whole CLI runs {full_s:.1f} s, {first_s:.1f} s, {second_s:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    return {"state": full, "losses": losses["loss"], "peak": peak, "ms": ms["full"]}


def graphed_step_memory_and_ms(remats=(False, True), steps: int = 10) -> dict:
    """The L/2 Mamba-1 step at batch 8 with and without ``remat``: the memory
    that an eager forward under autograd keeps for the backward; then,
    graphed, the peak memory of its first three calls (warm-up, capture, a
    replay) above what was allocated before them, and ms a step over
    ``steps`` replays, timed in turns (off, on, on, off)."""
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train import loss_draws, make_loss_fn, synthetic_batch

    diffusion = create_diffusion("", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    batches = []
    for _ in range(4):
        b = synthetic_batch(gen, 8, 28, 196)
        b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
        batches.append(b)
    runs, out = {}, {}
    for remat in remats:
        model = build_model("DiffMa-L/2", input_size=28, scan_impl="fused", remat=remat)
        model = model.init_weights(torch.Generator().manual_seed(0)).cuda().train()
        optimizer = adamw(model.parameters(), 1e-4)
        state = TrainState(model, optimizer)
        loss_fn = make_loss_fn(model, diffusion)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss, _ = loss_fn(batches[0], None)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - before
        del loss
        step = GraphedTrainStep(make_train_step(loss_fn, optimizer), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for b in batches[:3]:
            step(state, b)
        torch.cuda.synchronize()
        out[remat] = {"kept": kept, "peak": torch.cuda.max_memory_allocated() - base,
                      "pool": step.graph.pool_bytes, "ms": []}
        runs[remat] = (state, step)
    for remat in list(remats) + list(reversed(remats)):
        state, step = runs[remat]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        out[remat]["ms"].append((time.perf_counter() - t0) * 1e3 / steps)
    return out


def phase_remat(card: str, full: dict, k: int = 5) -> None:
    """21b: ``remat: true`` on 21a's uninterrupted run."""
    import numpy as np
    import torch

    from diffma_tpu_torch.train import train

    print(f"== phase 21b: remat: 21a's uninterrupted run ({2 * k} steps) with remat: true",
          flush=True)
    root = os.path.join(ROOT, "results", "chip_smoke_remat")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    state, losses = train.main(brain_config(
        max_steps=2 * k, ckpt_every=k, log_every=k, return_loss_history=True, remat=True,
        results_dir=os.path.join(root, "run")), device="cuda")
    peak = torch.cuda.max_memory_allocated() - base
    steps = 2 * k
    counts = check_counts("the remat run", {**{name: 0 for name in kernel_counters()},
                                             "mixer_fused_fwd": 32 * steps,
                                             "mixer_fused_bwd": 16 * steps})
    if not state.model.remat:
        fail("the trainer built the model without remat")
    if not np.array_equal(losses["loss"], full["losses"]):
        fail(f"remat's losses {losses['loss']} are not 21a's {full['losses']}")
    n = equal_states("remat against 21a's run", state, full["state"])
    ms = {step: 1e3 / r for step, r in logged_rates(run_dir(os.path.join(root, "run")))}
    print(f"  all {steps} losses and all {n} tensors (params, EMA, AdamW's state) equal in bits "
          f"to 21a's run without remat; a step launches C {counts['mixer_fused_fwd'] // steps} "
          f"times (16 without remat) and D {counts['mixer_fused_bwd'] // steps} times")
    print(f"  [{card}] trainer runs, peak memory above what was allocated before them: "
          f"{full['peak'] / 2**20:.0f} MiB without remat, {peak / 2**20:.0f} MiB with; ms a "
          f"step over steps 1-{k} (warm-up, capture, replays): {full['ms'][k]:.1f} without, "
          f"{ms[k]:.1f} with")
    del state, full
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    step = graphed_step_memory_and_ms()
    print(f"  [{card}] the graphed L/2 step alone, batch 8: memory kept from the forward for "
          f"the backward (an eager forward under autograd) {step[False]['kept'] / 2**20:.0f} "
          f"MiB without remat, {step[True]['kept'] / 2**20:.0f} MiB with; peak memory of "
          f"warm-up, capture and a replay {step[False]['peak'] / 2**20:.0f} and "
          f"{step[True]['peak'] / 2**20:.0f} MiB (graph pools "
          f"{step[False]['pool'] / 2**20:.0f} and {step[True]['pool'] / 2**20:.0f} MiB); ms a "
          f"step over 10 replays, in turns off, on, on, off: "
          f"{step[False]['ms'][0]:.2f}, {step[True]['ms'][0]:.2f}, {step[True]['ms'][1]:.2f}, "
          f"{step[False]['ms'][1]:.2f}")
    torch.cuda.empty_cache()


def graphed_call(fn):
    """``fn(x, t, **kw)`` as a CUDA graph (``utils/graphs.py::Graph``): the
    first call warms it up and captures it at that call's shapes and
    conditioning; every call replays it with x and t copied into its
    buffers. The same kernels as the eager call, without the host's launch
    time, which the plain scan's 196 steps a stream multiply."""
    from diffma_tpu_torch.utils.graphs import Graph

    graph, static = Graph("cuda"), {}

    def call(x, t, **kw):
        if not static:
            static.update(x=x.clone(), t=t.clone(), kw=kw)
            graph.warm_up(fn, static["x"], static["t"], **kw)
            static["out"] = graph.capture(fn, static["x"], static["t"], **kw)
        elif kw.keys() != static["kw"].keys() or any(
                kw[k] is not v for k, v in static["kw"].items()):
            fail("a graphed call takes the conditioning it was captured with")
        static["x"].copy_(x)
        static["t"].copy_(t)
        graph.replay()
        return static["out"].clone()

    return call


def phase_diffusion_api(card: str) -> None:
    """21c: guidance, the bound and the reverse ODE on DiffMa-B/2, each
    through kernel C against the plain scan on the card."""
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model

    print("== phase 21c: DiffMa-B/2 at full width through kernel C against the plain scan: a "
          "forward_with_cfg-guided DDIM-50 chain, calc_bpd_loop on 250 steps, "
          "ddim_reverse_sample up and DDIM-50 back, batch 2", flush=True)
    model = build_model("DiffMa-B/2", input_size=28)
    gen = torch.Generator().manual_seed(21)
    model.init_weights(gen)
    with torch.no_grad():  # as phase 3: every parameter random, adaLN included
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    model = model.cuda().eval()
    x0 = (0.5 * torch.randn(2, 4, 28, 28, generator=gen)).clamp(-1, 1).cuda()
    z = torch.randn(2, 4, 28, 28, generator=gen).cuda()
    y = torch.randn(1, 512, generator=gen).cuda()
    y2 = torch.randn(1, 196, 512, generator=gen).cuda()
    w = torch.sigmoid(torch.randn(1, 196, 1, generator=gen)).cuda()
    # [cond, uncond] halves: the second half's conditioning is null
    kw = {"y": torch.cat([y, torch.zeros_like(y)]), "y2": torch.cat([y2, torch.zeros_like(y2)]),
          "w": torch.cat([w, torch.ones_like(w)])}
    ddim, d250 = create_diffusion("ddim50", device="cuda"), create_diffusion("250", device="cuda")
    noise = torch.randn((250, 2, 4, 28, 28), generator=gen).cuda()

    def guided(x, t, **k):
        return model.forward_with_cfg(x, t, k["y"], k["y2"], k["w"], 4.0)

    def guided_chain(f):
        return ddim.ddim_sample_loop(f["guided"], z.shape, noise=z, clip_denoised=False,
                                     model_kwargs=kw)

    def bpd(f):
        return d250.calc_bpd_loop(f["model"], x0, clip_denoised=True, model_kwargs=kw,
                                  noise=noise)

    def reverse_and_back(f):
        with torch.no_grad():
            x = x0
            for i in range(ddim.num_timesteps):
                t = torch.full((2,), i, dtype=torch.long, device="cuda")
                x = ddim.ddim_reverse_sample(f["model"], x, t, clip_denoised=False,
                                             model_kwargs=kw)["sample"]
        back = ddim.ddim_sample_loop(f["model"], x.shape, noise=x, clip_denoised=False,
                                     model_kwargs=kw)
        return {"x_T": x, "back": back}

    zero = {name: 0 for name in kernel_counters()}
    eager = {"model": model, "guided": guided}
    graphed = {}
    for what, fn, calls in (("guided DDIM-50", guided_chain, 50),
                            ("calc_bpd_loop, 250 steps", bpd, 250),
                            ("ddim_reverse_sample x50, DDIM-50 back", reverse_and_back, 100)):
        results, seconds = {}, {}
        for impl in ("fused", "ref"):
            model.set_scan_impl(impl)
            if impl == "ref" and not graphed:  # captured at the first call of each
                graphed = {"model": graphed_call(model), "guided": graphed_call(guided)}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(eager if impl == "fused" else graphed)
            torch.cuda.synchronize()
            seconds[impl] = time.perf_counter() - t0
            check_counts(f"{what} ({impl})",
                         {**zero, **({"mixer_fused_fwd": 8 * calls} if impl == "fused" else {})})
            results[impl] = out if isinstance(out, dict) else {"out": out}
        errs = {key: close_to_ref(f"{what}: {key}, kernel C against the plain scan", value,
                                  results["ref"][key], TOL_MODEL)
                for key, value in results["fused"].items()}
        print(f"  {what}: max |kernel C - plain| " + ", ".join(
            f"{key} {err:.3e} (max |ref| {results['ref'][key].abs().max().item():.3g})"
            for key, err in errs.items()) + f"; bar {TOL_MODEL:g} of max(1, max |ref|)")
        if what.startswith("calc_bpd"):
            print(f"  total bits per dim {results['fused']['total_bpd'].tolist()} (random weights)")
        if what.startswith("ddim_reverse"):
            gap = (results["fused"]["back"] - x0).abs().max().item()
            print(f"  DDIM-50 back from the reversed x_T: max |x_0' - x_0| {gap:.3e} "
                  f"(random weights; reported, not held to a bar)")
        print(f"  [{card}] {what}, batch 2: {seconds['fused']:.2f} s through kernel C, eager; "
              f"the plain scan {seconds['ref']:.2f} s, its denoiser calls replayed as CUDA "
              f"graphs (a first call's capture included)")


def identity_spec(L: int):
    """One stream over the tokens in order: the scan order decode is defined on."""
    import numpy as np

    from diffma_tpu_torch.ops.scan_orders import ScanSpec

    ident = np.arange(L, dtype=np.int32)
    return ScanSpec(fwd=ident[None], merge=ident[:, None], scale=1.0)


def decode_loop(step, cache, x):
    """``step`` over every token of x (B, L, h) from ``cache``: (B, L, h), last cache."""
    import torch

    ys = []
    for t in range(x.shape[1]):
        y, cache = step(x[:, t], cache)
        ys.append(y)
    return torch.stack(ys, 1), cache


def graphed_decode(step, cache, x):
    """One step captured as a CUDA graph that reads the token and the cache
    from static buffers and copies the new cache into them, replayed once
    per token: ((B, L, h), last cache, seconds of the replays)."""
    import torch

    from diffma_tpu_torch.models.decode import MixerCache
    from diffma_tpu_torch.utils.graphs import Graph

    graph, token = Graph("cuda"), x[:, 0].clone()
    static = MixerCache(*(t.clone() for t in cache))

    def one_step():
        y, new = step(token, static)
        for buf, value in zip(static, new):
            buf.copy_(value)
        return y

    graph.warm_up(one_step)
    out = graph.capture(one_step)
    seconds = []
    for _ in range(2):  # the second loop is timed
        for buf, value in zip(static, cache):
            buf.copy_(value)
        ys = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(x.shape[1]):
            token.copy_(x[:, t])
            graph.replay()
            ys.append(out.clone())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return torch.stack(ys, 1), static, seconds[-1]


def timed_decode_loop(step, cache, x):
    """``decode_loop`` run twice; the second is timed: (ys, cache, seconds)."""
    import torch

    decode_loop(step, cache, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys, last = decode_loop(step, cache, x)
    torch.cuda.synchronize()
    return ys, last, time.perf_counter() - t0


# The iterated decode step against a full mixer forward on the card: rtol =
# atol = 2e-4, the JAX package's decode bar (tests/test_decode.py). The full
# forward's kernels C and E do their products in 3xTF32 (about fp32's
# accuracy) and sum them in another order than the step's cuBLAS fp32
# products, and kernel A scans in chunks; each token's differences are fp32
# rounding, carried through 196 steps of the state.
TOL_DECODE = 2e-4


def phase_decode(card: str) -> None:
    """22a: incremental decode against the mixers' forwards through C, A and E."""
    import torch

    from diffma_tpu_torch.models import decode
    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2

    B, L, h = 8, 196, 512
    print(f"== phase 22a: decode at DiffMa-B/2's mixer width (d_model {h}, d_inner 1024, "
          f"d_state 16, conv 4; Mamba-2 headdim 64), batch {B}, {L} tokens: the iterated "
          f"step against the full mixer on an identity spec", flush=True)
    spec = identity_spec(L)
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(B, L, h, generator=gen, device="cuda")
    zero = {name: 0 for name in kernel_counters()}
    torch.manual_seed(22)  # the mixers' own inits, before random_'s seeded noise
    mixers = (
        ("Mamba-1", random_(Mamba(h, spec, scan_impl="fused"), 221).cuda().eval(),
         lambda: decode.allocate_mamba_cache(B, 2 * h, device="cuda"), decode.mamba_step,
         (("fused", "kernel C", "mixer_fused_fwd"), ("auto", "kernel A", "selective_scan_fwd"))),
        ("Mamba-2", random_(Mamba2(h, spec, scan_impl="fused"), 222).cuda().eval(),
         lambda: decode.allocate_mamba2_cache(B, 2 * h, headdim=64, device="cuda"),
         decode.mamba2_step, (("fused", "kernel E", "ssd_mixer_fwd"),)),
    )
    with torch.no_grad():
        for what, mixer, allocate, step_fn, routes in mixers:
            def step(x_t, cache, mixer=mixer, step_fn=step_fn):
                return step_fn(mixer, x_t, cache)

            reset_counts()
            ys, last, eager_s = timed_decode_loop(step, allocate(), x)
            check_counts(f"the {what} decode loop", zero)  # plain operators only
            if tuple(ys.shape) != (B, L, h) or not bool(torch.isfinite(ys).all()):
                fail(f"the {what} decode gave a wrong shape or a non-finite value")
            for impl, name, counter in routes:
                mixer.scan_impl = impl
                reset_counts()
                full = mixer(x)
                torch.cuda.synchronize()
                check_counts(f"the {what} forward through {name}", {**zero, counter: 1})
                err = (ys - full).abs().max().item()
                ok = torch.allclose(ys, full, rtol=TOL_DECODE, atol=TOL_DECODE)
                print(f"  {what}: {L} steps against the forward through {name}: max |err| "
                      f"{err:.3e} (max |ref| {full.abs().max().item():.3g}; rtol=atol="
                      f"{TOL_DECODE:g}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"the {what} decode disagrees with the forward through {name}")
            reset_counts()
            gys, glast, graph_s = graphed_decode(step, allocate(), x)
            check_counts(f"the graphed {what} decode", zero)
            if not torch.equal(gys, ys) or not all(torch.equal(a, b) for a, b in zip(glast, last)):
                fail(f"the graphed {what} decode differs from the eager loop")
            print(f"  [{card}] {what} decode, batch {B}: eager {eager_s * 1e3 / L:.4f} ms a "
                  f"token, one step as a CUDA graph {graph_s * 1e3 / L:.4f} ms a token "
                  f"({L} replays; outputs and caches equal to the eager loop's in bits)")


def phase_assoc(card: str) -> None:
    """22b: the associative scan against kernel A, and a DiffMa-B/2 training
    step's forward and backward on ``scan_impl: assoc`` against kernels A + B."""
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.ops.selective_scan import selective_scan, selective_scan_cuda
    from diffma_tpu_torch.train.train import loss_draws, make_loss_fn, synthetic_batch

    print("== phase 22b: selective_scan(impl=\"assoc\") against kernel A at G=24, L=196, "
          "d=1024, n=16", flush=True)
    zero = {name: 0 for name in kernel_counters()}
    xs = scan_inputs(24, 196, 1024, 16, torch.float32, torch.float32, seed=22)
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = selective_scan(**xs, impl="assoc")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check_counts("the assoc scan", zero)
        want = selective_scan_cuda(**xs)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL_FP32, atol=TOL_FP32):
            fail(f"the assoc scan disagrees with kernel A: max |err| {err:.3e}")
        assoc_ms = cuda_ms(lambda: selective_scan(**xs, impl="assoc"), reps=10)
        a_ms = cuda_ms(lambda: selective_scan_cuda(**xs), reps=50)
    print(f"  max |assoc - kernel A| {err:.3e} (rtol=atol={TOL_FP32:g}) ok; [{card}] assoc "
          f"{assoc_ms:.3f} ms, kernel A {a_ms:.4f} ms; the assoc forward's peak memory "
          f"{peak / 2**20:.0f} MiB above its inputs (a and b: "
          f"{24 * 196 * 1024 * 16 * 4 / 2**20:.0f} MiB each)")
    del xs, got, want

    # One training step's forward and backward at DiffMa-B/2, batch 8: 16
    # scans of G=24 whose levels autograd keeps until the backward.
    B = 8
    model = build_model("DiffMa-B/2", input_size=28)
    model = random_(model.init_weights(torch.Generator().manual_seed(3)), 3, scale=0.3).cuda()
    diffusion = create_diffusion("", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(22)
    batch = synthetic_batch(gen, B, 28, 196)
    batch["t"], batch["noise"] = loss_draws(diffusion, batch["z"], gen)
    loss_fn = make_loss_fn(model, diffusion)
    print(f"  DiffMa-B/2 training step, batch {B}, forward and backward: scan_impl assoc "
          f"against kernels A + B (\"pallas\")", flush=True)
    result = {}
    for impl, expect in (("assoc", zero),
                         ("pallas", {**zero, "selective_scan_fwd": 16, "selective_scan_bwd": 16})):
        model.set_scan_impl(impl)
        for timed in (False, True):  # the second step, on the allocator's cached blocks
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            loss, _ = loss_fn(batch, None)
            loss.backward()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            check_counts(f"the {impl} training step", expect)
        result[impl] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                        torch.cuda.max_memory_allocated() - base, seconds)
        print(f"  {impl}: loss {result[impl][0]:.6f}; [{card}] {seconds * 1e3:.1f} ms, peak "
              f"memory {result[impl][2] / 2**30:.2f} GiB above the weights")
    rows = grad_errors(result["assoc"][1], result["pallas"][1], TOL_MODEL)
    loss_err = abs(result["assoc"][0] - result["pallas"][0])
    print(f"  assoc against kernels A + B: loss |err| {loss_err:.2e}, {len(rows)} gradients "
          f"within rtol=atol={TOL_MODEL:g}, max |err| {max(e for _, e, _ in rows):.3e}; the "
          f"parameters {sum(p.numel() for p in model.parameters()) * 4 / 2**20:.0f} MiB")
    if not math.isfinite(result["assoc"][0]) or loss_err > TOL_MODEL * max(1.0, abs(
            result["pallas"][0])):
        fail("the assoc training loss disagrees with kernels A + B's")
    del model, result
    torch.cuda.empty_cache()


def phase_plumbing(card: str, samples_dir: str) -> None:
    """22c: the native loader against the Python path, and the metrics tool."""
    import importlib.util
    import tempfile

    import numpy as np

    from diffma_tpu_torch.data import native
    from diffma_tpu_torch.data.npy_dataset import (
        NpyDataset,
        transform_train,
        write_triplet_folders,
    )

    print("== phase 22c: the native loader built with g++ here, a batch of 8 at 224 against "
          "the Python path; tools/compute_metrics_torch.py on phase 17e's PNGs", flush=True)
    t0 = time.perf_counter()
    lib = native.build()
    print(f"  built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(g++ at {shutil.which('g++')})")
    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "results")) as tmp:
        idx = list(range(8))
        for size in (224, 256):
            folders = write_triplet_folders(os.path.join(tmp, str(size)), 8, "train", size=size,
                                            mri_outside=2)
            dirs = [folders[f"{k}_image_folder_train"] for k in ("ct", "mask", "mir")]
            loader = native.NativeTripletLoader(*dirs, size=224)
            python = NpyDataset(*dirs, transform=transform_train)

            def python_batch():
                items = [python[i] for i in idx]
                return tuple(np.stack([it[k] for it in items]) for k in range(3))

            got, want = loader.load_batch(idx), python_batch()
            diffs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
            if any(a.shape != (8, 1, 224, 224) or a.dtype != np.float32 for a in got):
                fail("the native loader gave a wrong shape or dtype")
            times = {}
            for what, fn in (("native", lambda: loader.load_batch(idx)),
                             ("python", python_batch)) * 2:  # in turns; the second of each kept
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                times[what] = (time.perf_counter() - t0) * 1e3 / 5
            if size == 224:
                if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                    fail(f"the native loader's 224 batch differs from the Python path: {diffs}")
                note = "equal in bits"
            else:  # the trainer's case on phase 17's folders: a resize on both paths
                moved = [float((a != b).mean()) for a, b in zip(got[1:], want[1:])]
                note = (f"max |native - python| CT {diffs[0]:.3e}; the nearest resize picks "
                        f"another pixel at {moved[0]:.2%} of the mask's and {moved[1]:.2%} of "
                        f"the MRI's (the native resize, not PIL's; reported)")
            print(f"  {size} -> 224, batch 8: {note}; [{card}] host ms a batch: native "
                  f"{times['native']:.2f}, Python path {times['python']:.2f}")

    # The tool runs with PIL made unimportable, whether or not this machine has it.
    report_path = os.path.join(ROOT, "results", "phase22c_metrics.json")
    tool = os.path.join(ROOT, "tools", "compute_metrics_torch.py")
    no_pil = ("import runpy, sys; sys.modules['PIL'] = None; sys.argv = sys.argv[1:]; "
              "runpy.run_path(sys.argv[0], run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", no_pil, tool, samples_dir, "--json",
                           report_path], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"tools/compute_metrics_torch.py failed: {proc.stdout}\n{proc.stderr}")
    with open(report_path) as f:
        report = json.load(f)
    if report["n"] != 2 or not np.isfinite([report["psnr_db_mean"], report["ssim_mean"]]).all():
        fail(f"tools/compute_metrics_torch.py reported {report}")
    print(f"  tools/compute_metrics_torch.py on phase 17e's grids, PIL unimportable (this "
          f"machine has PIL: {importlib.util.find_spec('PIL') is not None}): {report['n']} "
          f"pairs, PSNR {report['psnr_db_mean']:.3f} dB, SSIM {report['ssim_mean']:.4f} (gen "
          f"against ori)")


# ---------------------------------------------------------------------------
# Phase 23: the parallel layer, ranks launched by torch.distributed.run over
# gloo, every rank on the one card
# ---------------------------------------------------------------------------

PAR_STEPS = 3
TOL_TP_STEP = 5e-3  # tp against one process: tests/test_parallel.py's bar, of each tensor's max


def par_mixer(use_mamba2: bool, seed: int, mesh=None, tp: int = 1, sp: int = 1,
              device="cuda"):
    """A DiffMa-B/2-width mixer (hidden 512, spiral layer 0 on the 14 x 14
    grid) with seeded weights, on the card; ``scan_impl="auto"``, the
    trainer's default under tp or sp."""
    import torch

    from diffma_tpu_torch.models.mamba import Mamba
    from diffma_tpu_torch.models.mamba2 import Mamba2
    from diffma_tpu_torch.ops.scan_orders import build_scan_spec

    torch.manual_seed(seed)
    cls = Mamba2 if use_mamba2 else Mamba
    mixer = cls(512, build_scan_spec("spiral", 14, 0), mesh=mesh,
                tp_axis="tp" if tp > 1 else None, sp_axis="sp" if sp > 1 else None)
    return random_(mixer, seed).to(device)


def par_mixer_grads(mixer, seed: int, device="cuda") -> dict:
    """The mixer's output at batch 8 and the gradients of x and every
    parameter of <g, out>, x and g seeded."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(8, 196, 512, generator=gen).to(device).requires_grad_()
    g = torch.randn(8, 196, 512, generator=gen).to(device)
    y = mixer(x)
    y.backward(g)
    return {"y": y.detach().cpu(), "x": x.grad.cpu(),
            **{k: p.grad.cpu() for k, p in mixer.named_parameters()}}


def par_collectives(rank: int, world: int, device="cuda") -> dict:
    """23a: each op on CUDA tensors of integer values (exact in fp32):
    x_r = r + 1 + arange, the cotangent c_r = 2 r + 1 + arange."""
    import torch
    import torch.distributed as dist

    from diffma_tpu_torch.parallel.collectives import all_gather, enter, psum_mid, psum_out

    group = dist.group.WORLD
    out = {}
    for op, fn in (("enter", lambda t: enter(t, group)), ("psum_out", lambda t: psum_out(t, group)),
                   ("psum_mid", lambda t: psum_mid(t, group)),
                   ("all_gather", lambda t: all_gather(t, rank, world, group))):
        x = (rank + 1 + torch.arange(6.0, device=device)).requires_grad_()
        y = fn(x)
        c = 2 * rank + 1 + torch.arange(float(y.numel()), device=device).view_as(y)
        (y * c).sum().backward()
        out[op] = (y.detach().cpu(), x.grad.cpu())
    return out


def par_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def par_nan(mesh) -> dict:
    """23e: a DiffMa-B/2 step at dp 2 (the fused route: C and D) whose rows
    hold a NaN on rank 1 only."""
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.parallel.mesh import shard_params
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    model = seeded_model("DiffMa-B/2", 23, scan_impl="fused").to(mesh.device).train()
    shard_params(model.parameters(), mesh)
    opt = adamw(model.parameters(), 1e-4)
    state = TrainState(model, opt)
    diffusion = create_diffusion("", device=mesh.device)
    step = make_train_step(train.make_loss_fn(model, diffusion), opt, group=mesh.group("dp"))
    gen = torch.Generator(mesh.device).manual_seed(230 + mesh.rank)
    batch = train.synthetic_batch(gen, 4, 28, 196)
    if mesh.rank == 1:
        batch["z"][2, 1, 3, 4] = float("nan")
    before = par_digest(list(model.parameters()) + list(state.ema.parameters()))
    metrics = step(state, batch, gen)
    after = par_digest(list(model.parameters()) + list(state.ema.parameters()))
    return {"finite": bool(metrics["finite"]), "loss": float(metrics["loss"]),
            "step": int(state.step), "before": before, "after": after}


def par_timing(mesh) -> dict:
    """Each rank's eager dp step ms (configs/brain.yaml's DiffMa-L/2, 4 rows a
    rank, the fused route) and the ms of gloo's all-reduce of a flat buffer
    of its parameters' size, on CUDA tensors of the shared card."""
    import torch
    import torch.distributed as dist

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    model = seeded_model("DiffMa-L/2", 0, scan_impl="fused").cuda().train()
    opt = adamw(model.parameters(), 1e-4)
    state = TrainState(model, opt)
    diffusion = create_diffusion("", device="cuda")
    step = make_train_step(train.make_loss_fn(model, diffusion), opt, group=mesh.group("dp"))
    gen = torch.Generator("cuda").manual_seed(0)
    times = []
    for i in range(5):
        batch = train.synthetic_batch(gen, 4, 28, 196)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    flat = torch.zeros(sum(p.numel() for p in model.parameters()), device="cuda")
    reduce_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=mesh.group("dp"))
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
    return {"step_ms": times[2:], "all_reduce_ms": reduce_ms[1:], "floats": flat.numel()}


def par_cli(run, argv) -> dict:
    """One CLI run on every rank with the kernels' counts set to 0 just
    before it; this rank's counts just after."""
    reset_counts()
    t0 = time.perf_counter()
    out = run(argv)
    seconds = time.perf_counter() - t0
    return {"counts": {k: c.launches for k, c in kernel_counters().items()}, "seconds": seconds,
            "out": out}


def parallel_worker(out_dir: str) -> int:
    """One rank of phase 23, launched by ``torch.distributed.run``: the
    cases of its world size, its results written to
    ``<out_dir>/rank<r>.pt``."""
    if not os.path.isdir(os.path.join(ROOT, "diffma_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from diffma_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from diffma_tpu_torch.train import sample, train
    from diffma_tpu_torch.utils.device import resolve_device

    device = init_distributed(resolve_device("cuda"))
    rank, world = dist.get_rank(), dist.get_world_size()
    brain = os.path.join(ROOT, "configs", "brain.yaml")
    res = {"device": str(device), "backend": dist.get_backend(),
           "collectives": par_collectives(rank, world, device), "mixers": {}}
    layouts = {"tp2sp2": (2, 2)} if world == 4 else {"tp2": (2, 1), "sp2": (1, 2)}
    for name, (tp, sp) in layouts.items():
        mesh = make_mesh(dp=1, tp=tp, sp=sp, device=device)
        for use_mamba2 in (False, True):
            reset_counts()
            grads = par_mixer_grads(par_mixer(use_mamba2, 2300, mesh, tp, sp, device), 2301,
                                    device)
            counts = {k: c.launches for k, c in kernel_counters().items()}
            res["mixers"][(name, use_mamba2)] = (grads, counts)
    if world == 2:
        dp = make_mesh(dp=2, device=device)
        res["nan"] = par_nan(dp)
        runs = {}
        for key, extra in (("dp2", []), ("dp2 --use-mamba2", ["--use-mamba2"]),
                           ("tp2", ["--model", "DiffMa-B/2", "--tp", "2"]),
                           ("tp2 --use-mamba2", ["--model", "DiffMa-B/2", "--tp", "2",
                                                 "--use-mamba2"])):
            results = os.path.join(out_dir, "runs", key.replace(" ", "_"))
            r = par_cli(train.cli, ["--config", brain, "--max-steps", str(PAR_STEPS),
                                    "--ckpt-every", str(PAR_STEPS), "--log-every", "1",
                                    "--results-dir", results, *extra])
            r["step"], r["out"] = int(r["out"].step), None
            r["results"] = results
            runs[key] = r
        res["trainer"] = runs
        cwd = os.getcwd()
        os.chdir(out_dir)  # the config's relative paths name no folder here: synthetic data
        try:
            r = par_cli(sample.cli, ["--config", brain, "--model", "DiffMa-B/2",
                                     "--num-batches", "1"])
        finally:
            os.chdir(cwd)
        r["images"] = [b["images"] for b in r.pop("out")]
        res["sampler"] = r
        res["timing"] = par_timing(dp)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def par_dir(root: str, name: str) -> str:
    path = os.path.join(root, name)
    os.makedirs(path)
    return path


def par_launch(world: int, out_dir: str, timeout: int = 300) -> list:
    """``python -m torch.distributed.run --nproc_per_node world chip_smoke.py
    --parallel-worker out_dir`` over gloo; each rank's results."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, DIFFMA_DIST_BACKEND="gloo", OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(world), "--master_addr", "127.0.0.1", "--master_port",
           str(port), os.path.abspath(__file__), "--parallel-worker", out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)
    if proc.returncode != 0:
        print(proc.stdout[-6000:])
        print(proc.stderr[-6000:])
        fail(f"torch.distributed.run of {world} ranks exited with {proc.returncode}")
    print(f"  {world} ranks over gloo on the card ran in {time.perf_counter() - t0:.1f} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def par_check_collectives(res: list) -> None:
    import torch

    world = len(res)
    xs = [r + 1 + torch.arange(6.0) for r in range(world)]
    for op in ("enter", "psum_out", "psum_mid", "all_gather"):
        n = world * 6 if op == "all_gather" else 6
        cs = [(2 * r + 1 + torch.arange(float(n))).view(world, 6) if op == "all_gather"
              else 2 * r + 1 + torch.arange(float(n)) for r in range(world)]
        for r, out in enumerate(res):
            y, g = out["collectives"][op]
            want_y = {"enter": lambda: xs[r], "psum_out": lambda: sum(xs),
                      "psum_mid": lambda: sum(xs), "all_gather": lambda: torch.stack(xs)}[op]()
            want_g = {"enter": lambda: sum(cs), "psum_out": lambda: cs[r],
                      "psum_mid": lambda: sum(cs),
                      "all_gather": lambda: sum(c[r] for c in cs)}[op]()
            if not (torch.equal(y, want_y) and torch.equal(g, want_g)):
                fail(f"23a: {op} at world {world} on rank {r}: value or gradient not exact")
    print(f"  23a: enter, psum_out, psum_mid and all_gather on CUDA tensors at world {world}: "
          f"values and gradients exact on every rank ({res[0]['backend']}, "
          f"{', '.join(sorted({o['device'] for o in res}))})")


def par_check_mixers(card: str, res: list) -> None:
    """23b: every rank's output and gradients against the one-process
    composable mixer on the card (kernels A + B for Mamba-1)."""
    zero = {name: 0 for name in kernel_counters()}
    for (name, use_mamba2), _ in res[0]["mixers"].items():
        reset_counts()
        want = par_mixer_grads(par_mixer(use_mamba2, 2300), 2301)
        a_b = 1 if name == "tp2" and not use_mamba2 else 0  # a shard's scan: kernels A and B
        for r, out in enumerate(res):
            got, counts = out["mixers"][(name, use_mamba2)]
            err = close_to_ref(f"23b {name} {'Mamba-2' if use_mamba2 else 'Mamba-1'} rank {r}",
                               got.pop("y"), want["y"], TOL_FP32)
            grads = grad_errors(got, {k: v for k, v in want.items() if k != "y"}, TOL_GRAD)
            expect = {**zero, "selective_scan_fwd": a_b, "selective_scan_bwd": a_b}
            if counts != expect:
                fail(f"23b {name} rank {r}: kernel counts {counts}, not {expect}")
        worst = max(grads, key=lambda row: row[1] / row[2])
        print(f"  23b: {'Mamba-2' if use_mamba2 else 'Mamba-1'} at {name}, B/2 width, batch 8: "
              f"every rank within {err:.2e} of the one-process mixer (bar {TOL_FP32:g} x "
              f"max(1, max |ref|)), {len(grads)} gradients within their bars ({TOL_GRAD:g} x "
              f"max(1, max |ref|); nearest {worst[0]}, {worst[1]:.2e} of {worst[2]:.2e}); "
              f"kernels A and B {a_b} call each a rank")


def par_replica_dp(use_mamba2: bool):
    """One process fed both dp ranks' rows of the trainer's first
    ``PAR_STEPS`` steps on configs/brain.yaml: every rank draws the same 4
    rows, so the global batch is them twice; the loss's draws cover it."""
    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.train import train
    from diffma_tpu_torch.train.state import TrainState, adamw, make_train_step

    cfg = brain_config()
    seed = int(cfg.global_seed)
    model = build_model(cfg.model, input_size=28, d_state=int(cfg.d_state), scan_impl="fused",
                        use_mamba2=use_mamba2)
    model = model.init_weights(torch.Generator().manual_seed(seed)).cuda().train()
    opt = adamw(model.parameters(), float(cfg.lr))
    state = TrainState(model, opt)
    diffusion = create_diffusion("", device="cuda")
    step = make_train_step(train.make_loss_fn(model, diffusion), opt)
    gen = torch.Generator("cuda").manual_seed(seed)
    for _ in range(PAR_STEPS):
        host = train.synthetic_batch(gen, 4, 28, 196)
        batch = {k: torch.cat([v, v]) for k, v in host.items()}
        batch["t"], batch["noise"] = train.loss_draws(diffusion, batch["z"], gen)
        step(state, batch, None)
    return state


def par_checkpoint(run: dict):
    import torch

    (exp,) = os.listdir(run["results"])
    path = os.path.join(run["results"], exp, "checkpoints", f"{PAR_STEPS:07d}.pt")
    if not os.path.exists(path):
        fail(f"rank 0 wrote no checkpoint at {path}")
    return torch.load(path, map_location="cuda", weights_only=False)


def par_check_trainers(card: str, res: list) -> None:
    """23c, 23d: the trainer's CLI at dp 2 (L/2) against one process fed both
    ranks' rows, and at tp 2 (B/2) against one process; each rank's kernels."""
    import torch

    from diffma_tpu_torch.train import train

    zero = {name: 0 for name in kernel_counters()}
    n = PAR_STEPS
    expects = {"dp2": {"mixer_fused_fwd": 16 * n, "mixer_fused_bwd": 16 * n},
               "dp2 --use-mamba2": {"ssd_mixer_fwd": 16 * n, "ssd_mixer_bwd": 16 * n},
               "tp2": {"selective_scan_fwd": 16 * n, "selective_scan_bwd": 16 * n},
               "tp2 --use-mamba2": {}}
    for key, expect in expects.items():
        for r, out in enumerate(res):
            run = out["trainer"][key]
            if run["counts"] != {**zero, **expect}:
                fail(f"23 {key} rank {r}: kernel counts {run['counts']}, not {expect}")
            if run["step"] != n:
                fail(f"23 {key} rank {r}: {run['step']} finite steps of {n}")
        saved = par_checkpoint(res[0]["trainer"][key])
        use_mamba2 = "mamba2" in key
        if key.startswith("dp2"):
            want = par_replica_dp(use_mamba2)
            errs = [close_to_ref(f"23c {key} {part} {k}", saved[part][k].float(), v, TOL_STEP)
                    for part, mod in (("model", want.model), ("ema", want.ema))
                    for k, v in mod.state_dict().items()]
            what = f"within {max(errs):.2e} of one process fed both ranks' rows (bar {TOL_STEP:g})"
        else:
            results = os.path.join(ROOT, "results", "chip_smoke_tp_ref")
            shutil.rmtree(results, ignore_errors=True)
            state = train.main(brain_config(model="DiffMa-B/2", scan_impl="auto",
                                            use_mamba2=use_mamba2, max_steps=n, log_every=n,
                                            ckpt_every=10 ** 9, results_dir=results), "cuda")
            shutil.rmtree(results, ignore_errors=True)
            worst = 0.0
            for k, v in state.model.state_dict().items():
                rel = (saved["model"][k] - v).abs().max().item() / (v.abs().max().item() + 1e-9)
                worst = max(worst, rel)
            if worst > TOL_TP_STEP:
                fail(f"23d {key}: parameters {worst:.2e} of their largest value from one "
                     f"process (bar {TOL_TP_STEP:g})")
            what = f"parameters within {worst:.2e} of their max of one process (bar {TOL_TP_STEP:g})"
        counts = ", ".join(f"{k} {v}" for k, v in expect.items()) or "no kernel"
        secs = " / ".join(f"{out['trainer'][key]['seconds']:.1f}" for out in res)
        print(f"  23{'c' if key.startswith('dp') else 'd'}: trainer CLI {key}, {n} steps: {what}; "
              f"each rank {counts} ({PAR_STEPS} steps); {secs} s a rank, build included")


def phase_parallel(card: str) -> None:
    """Phase 23: the parallel layer over gloo, every rank on the one card."""
    import tempfile

    import numpy

    from diffma_tpu_torch.train import sample

    print("== phase 23: the parallel layer: torch.distributed.run over gloo, all ranks on "
          "cuda:0", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res4 = par_launch(4, par_dir(tmp, "w4"))
        res2 = par_launch(2, par_dir(tmp, "w2"))
        par_check_collectives(res4)
        par_check_collectives(res2)
        par_check_mixers(card, res4)
        par_check_mixers(card, res2)
        par_check_trainers(card, res2)
        a, b = (out["nan"] for out in res2)
        if a["finite"] or b["finite"] or a["step"] or b["step"]:
            fail("23e: a NaN on rank 1 did not make both ranks skip the step")
        if not (a["before"] == a["after"] == b["before"] == b["after"]):
            fail("23e: a skipped step changed a parameter, or the ranks differ")
        print("  23e: a NaN in rank 1's rows: the global loss NaN on both ranks, both skipped, "
              "parameters and EMA as before and equal in bits across the ranks")
        zero = {name: 0 for name in kernel_counters()}
        cfg = brain_config(model="DiffMa-B/2", sample_num_batches=1,
                           save_dir=os.path.join(tmp, "ref_samples"))
        model = sample.load_model(cfg, "cuda")
        for r, out in enumerate(res2):
            got = out["sampler"]
            if got["counts"] != {**zero, "mixer_fused_fwd": 2000}:
                fail(f"23f rank {r}: kernel counts {got['counts']}, not 2000 C calls")
            want = sample.sample_batches(model, cfg, "cuda", process_index=r, process_count=2)
            for g, w in zip(got["images"], want):
                if not numpy.array_equal(g, w["images"]):
                    fail(f"23f rank {r}: its image differs from one process sampling its shard")
        print("  23f: sampler CLI at dp 2, DiffMa-B/2, DDPM-250, graphed on each rank: each "
              "rank's image equal in bits to one process's on that rank's shard; 2000 C calls "
              "a rank")
        for r, out in enumerate(res2):
            t = out["timing"]
            print(f"  [{card}] rank {r}: eager DiffMa-L/2 dp step, 4 rows a rank: "
                  f"{', '.join(f'{v:.1f}' for v in t['step_ms'])} ms; gloo all-reduce of "
                  f"{t['floats']:,} fp32 on CUDA tensors: "
                  f"{', '.join(f'{v:.1f}' for v in t['all_reduce_ms'])} ms "
                  f"(gloo over one shared card, through host memory: says nothing of NCCL)")
    print(f"phase 23 took {time.perf_counter() - t0:.1f} s")


INNER_BF16_SHAPES = ((8, 49), (24, 196))  # phase 24a's (G, L): the atrous streams, the batch


def inner_bf16_args(G: int, L: int) -> tuple:
    """Phase 24a's inputs of kernel H's bf16 variant: xz in bf16."""
    import torch

    xz, *weights = inner_inputs(G, L, seed=2400 + G)
    return (xz.to(torch.bfloat16), *weights)


def core_bf16_args() -> tuple:
    """Phase 24c's inputs of kernel P's bf16 variant: the probe's gathered
    streams zx (48, 196, 2096) in bf16 and both branches' weights."""
    import torch

    probe = load_split_probe()
    x12, ws = probe.inputs(8, seed=2420, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        return probe.gathered_streams(x12, ws), ws


def bf16_stage_worker() -> int:
    """The bf16 variants' stage tables, in a process of their own
    (``--bf16-stages``): device ms per call by stage of C and D (phase 19a's
    timed cases), E, F and G (20a's), H at each of ``INNER_BF16_SHAPES``
    and P at 24c's zx; one JSON line."""
    sys.path.insert(0, ROOT)
    import torch

    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda
    from diffma_tpu_torch.ops.fused_mixer import mixer_fused_bwd_cuda, mixer_fused_cuda
    from diffma_tpu_torch.ops.fused_ssd import (
        spiral_epilogue_cuda,
        ssd_core_cuda,
        ssd_mixer_fused_bwd_cuda,
        ssd_mixer_fused_cuda,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    spec, ws, xs, _ = mixer_bf16_case("spiral", 0, 1, 500)
    _, _, x8, g8 = mixer_bf16_case("spiral", 0, 8, 501)
    with torch.no_grad():
        out["C"] = stage_table(lambda: mixer_fused_cuda(spec, xs, ws), MIXER_STAGES)
        out["C_B8"] = stage_table(lambda: mixer_fused_cuda(spec, x8, ws), MIXER_STAGES)
    out["D"] = stage_table(lambda: mixer_fused_bwd_cuda(spec, x8, g8, ws), MIXER_BWD_STAGES)
    spec, ws, xs, _ = ssd_bf16_case("spiral", 14, 0, 1, 800)
    _, _, x8, g8 = ssd_bf16_case("spiral", 14, 0, 8, 801)
    with torch.no_grad():
        out["E"] = stage_table(lambda: ssd_mixer_fused_cuda(spec, xs, ws), SSD_STAGES)
        out["E_B8"] = stage_table(lambda: ssd_mixer_fused_cuda(spec, x8, ws), SSD_STAGES)
        _, zx8 = ssd_mixer_fused_cuda(spec, x8, ws, want_res=True)
    out["F"] = stage_table(lambda: ssd_mixer_fused_bwd_cuda(spec, x8, g8, ws, zx8),
                           SSD_BWD_STAGES)
    with torch.no_grad():
        for batch in (1, 8):
            tail = epilogue_bf16_inputs(batch)
            out[f"G_B{batch}"] = stage_table(lambda: spiral_epilogue_cuda(*tail),
                                             EPILOGUE_STAGES, calls=50)
        for G, L in INNER_BF16_SHAPES:
            args = inner_bf16_args(G, L)
            out[f"H_G{G}_L{L}"] = stage_table(lambda: mamba_inner_fused_cuda(*args), INNER_STAGES)
        zxs, ws = core_bf16_args()
        out["P"] = stage_table(lambda: ssd_core_cuda(zxs, ws), CORE_STAGES)
    print(json.dumps(out))
    return 0


def bf16_stage_tables() -> dict:
    """``bf16_stage_worker``'s tables. In this process torch.profiler loses
    more of the repo's kernels' records the longer it has run (a probe of H
    bf16: all 5 kernels a call through phase 3, 1.8 after phase 18, 0 after
    phase 23; PERF.md section 7), so a fresh process reads them."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--bf16-stages"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:])
        fail(f"the stage tables of phase 24 exited {res.returncode}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_bf16_inner(card: str, inner: dict, stage_tables: dict) -> dict:
    """24a: kernel H's bf16 variant against its bf16 plain version at the
    atrous streams' shape and the training batch's, twice with equal bits;
    its ms, device ms by stage (``stage_tables``) and a bound (products at
    the bf16 rate, xz and out at 2 bytes) beside the fp32 variant's
    (``inner``: phase 2h)."""
    import torch

    from diffma_tpu_torch.ops.fused_mamba import mamba_inner_fused_cuda, mamba_inner_plain

    print("== phase 24a: kernel H in bf16 against its bf16 plain version on the card", flush=True)
    times, path_err = {}, None
    for G, L in INNER_BF16_SHAPES:
        args = inner_bf16_args(G, L)
        with torch.no_grad():
            got, again = (mamba_inner_fused_cuda(*args) for _ in range(2))
            want = mamba_inner_plain(*args)
            torch.cuda.synchronize()
            err, rel = bf16_close(f"H bf16, G={G} L={L}", got, again, want, TOL_HP_BF16,
                                  TOL_HP_BF16_MEAN)
            products, other, nbytes = inner_work(G, L, 1024, 16, 32, 4)
            bound = bound_from(products, other, nbytes - 2 * G * L * 3 * 1024,
                               product_flops=BF16_FLOPS)
            times[G, L] = (cuda_ms(lambda: mamba_inner_fused_cuda(*args), reps=50),
                           cuda_ms(lambda: mamba_inner_plain(*args), reps=5), *bound,
                           stage_tables[f"H_G{G}_L{L}"])
        fp32 = inner if (G, L) == (8, 49) else inner["other_shapes"][f"G{G}_L{L}"]
        ms, plain_ms, bound_ms, bound_by, stages = times[G, L]
        print(f"  G={G} L={L} d=1024: max|err| {err:.3e}, mean-rel {rel:.2e}; equal bits on a "
              f"second call")
        print(f"  [{card}] mamba_inner_fwd bf16 G={G} L={L}: kernel {ms:.4f} ms (fp32 variant "
              f"{fp32['ms']:.4f} ms, phase 2h), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}, products at the bf16 rate); device ms per "
              f"call by stage (torch.profiler, a fresh process): {stage_line(stages)}")
        if path_err is None:
            path_err = err
    print("  library_ms: none; no single PyTorch call computes the mixer's inner part")
    ms, plain_ms, bound_ms, bound_by, stages = times[8, 49]
    t24 = times[24, 196]
    return {"name": "mamba_inner_fwd_bf16", "route": "cuda",
            "source": "diffma_tpu_torch/csrc/fused_mamba_fwd.cu",
            "replaces": "diffma_tpu/ops/fused_mamba.py:42", "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fp32_ms": inner["ms"], "busy_ms": stages["total"], "stages_ms": stages,
            "G24_L196": {"ms": t24[0], "plain_ms": t24[1], "bound_ms": t24[2],
                         "stages_ms": t24[4]}}


def phase_bf16_inner_path(card: str) -> int:
    """24b: the bf16 ``Mamba`` on the doubled-atrous spec through kernel H's
    bf16 variant, forward and backward at batch 8 against the plain route,
    then 2000 forwards at batch 1; returns the bf16 H launches of those."""
    import torch

    from diffma_tpu_torch.models.mamba import Mamba

    print("== phase 24b: Mamba(512, scan_impl='fused', dtype=bfloat16) on the doubled-atrous "
          "spec: kernel H's bf16 variant on the path", flush=True)
    bf16 = torch.bfloat16
    m = random_(Mamba(512, doubled_atrous_spec(14), scan_impl="fused", dtype=bf16), 2410).cuda()
    gen = torch.Generator().manual_seed(2411)
    x = torch.randn(8, 196, 512, generator=gen).cuda()
    g = torch.randn(8, 196, 512, generator=gen).cuda().to(bf16)
    zero = {name: 0 for name in kernel_counters()}
    # the fused route: H bf16 forward, then A and B (in bf16) in MambaInnerFn's
    # backward; the plain route (scan_impl "ref") no kernel
    expect = {"fused": {**zero, "mamba_inner_fwd_bf16": 1, "selective_scan_fwd": 1,
                        "selective_scan_bwd": 1}, "ref": zero}
    runs = {}
    for impl in ("fused", "ref"):
        m.scan_impl = impl
        m.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        reset_counts()
        out = m(xi)
        out.backward(g)
        torch.cuda.synchronize()
        check_counts(f"the bf16 Mamba on the doubled-atrous spec, {impl} route, forward and "
                     f"backward", expect[impl])
        if out.dtype != bf16:
            fail(f"the bf16 Mamba returned {out.dtype} on the {impl} route")
        runs[impl] = {"out": out.detach(), "x": xi.grad,
                      **{k: p.grad for k, p in m.named_parameters()}}
    worst = ("", 0.0)
    for name, want in runs["ref"].items():
        got = runs["fused"][name]
        if got is None or not bool(torch.isfinite(got.float()).all()):
            fail(f"the bf16 Mamba through kernel H: {name} is missing or not finite")
        rel = ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()
        if rel > TOL_D_BF16:
            fail(f"the bf16 Mamba through kernel H: {name} mean-rel {rel:.2e} over {TOL_D_BF16:g}")
        if rel > worst[1]:
            worst = (name, rel)
    print(f"  B=8 L=196, 8 streams of 49 steps: the output and {len(runs['ref']) - 1} gradients "
          f"against the plain route within mean-rel {TOL_D_BF16:g}, the largest {worst[0]} "
          f"{worst[1]:.2e}")
    calls = 8 * 250  # blocks x steps: a DDPM-250 chain's worth of one B/2 model's mixers
    m.scan_impl = "fused"
    m.eval()
    xb = torch.randn(1, 196, 512, generator=gen).cuda()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(calls):
            xb = xb + 0.01 * m(xb).float()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = check_counts("2000 bf16 Mamba forwards through kernel H",
                          {**zero, "mamba_inner_fwd_bf16": calls})
    if not bool(torch.isfinite(xb).all()):
        fail("2000 bf16 Mamba forwards through kernel H left a non-finite value")
    print(f"  [{card}] {calls} bf16 forwards at batch 1 in {seconds:.3f} s "
          f"({seconds / calls * 1e3:.4f} ms each, host clock), every one through kernel H's bf16 "
          f"variant, none through kernel C")
    return counts["mamba_inner_fwd_bf16"]


def phase_bf16_core(card: str, core: dict, stage_tables: dict) -> dict:
    """24c: kernel P's bf16 variant against its bf16 plain version on the
    probe's zx (48, 196, 2096) and at 25 steps, twice with equal bits; its
    ms, device ms by stage (``stage_tables``) and a bound beside the fp32
    variant's (``core``: phase 2m)."""
    import torch

    from diffma_tpu_torch.ops.fused_ssd import ssd_core_cuda, ssd_core_ref

    print("== phase 24c: kernel P in bf16 against its bf16 plain version on the card", flush=True)
    zxs, ws = core_bf16_args()
    with torch.no_grad():
        path_err = None
        for label, zx in (("zx (48, 196, 2096)", zxs), ("zx (4, 25, 2096)",
                                                        zxs[:4, :25].contiguous())):
            got, again = (ssd_core_cuda(zx, ws) for _ in range(2))
            want = ssd_core_ref(zx, ws)
            torch.cuda.synchronize()
            err, rel = bf16_close(f"P bf16, {label}", got, again, want, TOL_HP_BF16,
                                  TOL_HP_BF16_MEAN)
            print(f"  {label}: max|err| {err:.3e}, mean-rel {rel:.2e}; equal bits on a second "
                  f"call")
            if path_err is None:
                path_err = err
        ms = cuda_ms(lambda: ssd_core_cuda(zxs, ws), reps=50)
        plain_ms = cuda_ms(lambda: ssd_core_ref(zxs, ws), reps=5)
    stages = stage_tables["P"]
    G, L, d, H = 48, 196, 1024, 16
    bound_ms, bound_by = ssd_bf16_bound(ssd_core_work(G, L, d, 16, H, 4),
                                        4 * G * L * (2 * d + 32 + H + d))
    print(f"  [{card}] ssd_core_fwd bf16, zx (48, 196, 2096): kernel {ms:.4f} ms (fp32 variant "
          f"{core['ms']:.4f} ms, phase 2m), plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us "
          f"({bound_by}, products at the bf16 rate); device ms per call by stage "
          f"(torch.profiler, a fresh process): {stage_line(stages)}")
    print("  library_ms: none; no single PyTorch call computes the SSD core")
    return {"name": "ssd_core_fwd_bf16", "route": "cuda",
            "source": "diffma_tpu_torch/csrc/ssd_core_fwd.cu",
            "replaces": "tools/probes/probe_split_ssd.py:44", "max_abs_err": path_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fp32_ms": core["ms"], "busy_ms": stages["total"], "stages_ms": stages}


def phase_validate_imports(card: str) -> None:
    """24e: ``tools/validate_imports_torch.py`` on seeded full-width
    stand-ins of the four files in the upstream layouts: exit 0 with every
    forward on the card; exit 1 with a ``FAIL`` line on a CT checkpoint with
    a key removed and on a DiffMa checkpoint with one tensor of a wrong
    shape."""
    import importlib.util
    import tempfile

    import torch

    print("== phase 24e: tools/validate_imports_torch.py on seeded full-width stand-ins "
          "(SD-VAE, BiomedCLIP, CT encoder, DiffMa-B/2)", flush=True)
    tool = os.path.join(ROOT, "tools", "validate_imports_torch.py")
    spec = importlib.util.spec_from_file_location("validate_imports_torch", tool)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def run(what, expect, fails, *argv):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, tool, *argv], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = [line.strip().split(":")[0] for line in res.stdout.splitlines()
                 if line.strip().startswith("FAIL ")]
        if res.returncode != expect or lines != fails:
            print(res.stdout[-4000:], res.stderr[-4000:])
            fail(f"validate_imports_torch.py on {what}: exit {res.returncode} with {lines}, "
                 f"expected {expect} with {fails}")
        return res.stdout, seconds

    with tempfile.TemporaryDirectory() as tmp:
        paths = module.write_stand_ins(tmp, seed=2430)
        out, seconds = run("the stand-ins", 0, [], "--vae", paths["vae"], "--clip", paths["clip"],
                           "--ct", paths["ct"], "--diffma", paths["diffma"])
        for needle in ("latent (mode): shape (1, 4, 8, 8), finite=True",
                       "decode: shape (1, 3, 64, 64), finite=True",
                       "embedding: shape (2, 512), finite=True",
                       "tokens: shape (2, 196, 512), finite=True",
                       "denoiser output: shape (2, 8, 28, 28), finite=True"):
            if needle not in out:
                fail(f"validate_imports_torch.py did not print {needle!r}")
        print(f"  [{card}] the four stand-ins validated, forwards on cuda, in {seconds:.1f} s "
              f"(exit 0)")
        ckpt = torch.load(paths["ct"])
        for sd in ckpt.values():
            del sd["norm.weight"]
        torch.save(ckpt, os.path.join(tmp, "ct_missing.pt"))
        out, _ = run("a CT checkpoint without norm.weight", 1, ["FAIL ct"],
                     "--ct", os.path.join(tmp, "ct_missing.pt"))
        ckpt = torch.load(paths["diffma"], weights_only=False)
        ckpt["ema"]["final_layer.linear.weight"] = ckpt["ema"]["final_layer.linear.weight"][:-1]
        torch.save(ckpt, os.path.join(tmp, "diffma_shape.pt"))
        out2, _ = run("a DiffMa checkpoint with a wrong shape", 1, ["FAIL diffma"],
                      "--diffma", os.path.join(tmp, "diffma_shape.pt"))
    print("  a key removed: exit 1, " + next(line.strip() for line in out.splitlines()
                                            if line.strip().startswith("FAIL")))
    print("  a wrong shape: exit 1, " + next(line.strip() for line in out2.splitlines()
                                            if line.strip().startswith("FAIL")))


# ---- phase 25: the masked AdamW + EMA update

# The kernel against its plain version (csrc/masked_adamw.cu rounds each
# operation as the plain version's torch operations do): the largest
# distance in ulps of any element, and mean |err| / mean |ref| of each list
# the update writes (p, m, v, the step counts, the EMA).
MAX_ADAMW_ULPS = 4
TOL_ADAMW_MEAN = 1e-7
ADAMW_HYPER = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, ema_decay=0.999)


def bits(t):
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def adamw_inputs(shapes, seed: int) -> list:
    """An update's tensors at ``shapes`` on the card, as ``masked_adamw``
    takes them: params, grads, exp_avg, exp_avg_sq (>= 0), step counts (3)
    and the EMA. Every seventh tensor has no gradient and no AdamW state
    (the EMA alone), and the largest lies 4 bytes off 16-byte alignment (the
    kernel's element-by-element path)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))

    def place(x, i):
        if i != big:
            return x
        return torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x).copy_(x)

    def draw(scale=1.0):
        return [place(scale * torch.randn(s, generator=gen, device="cuda"), i)
                for i, s in enumerate(shapes)]

    p, g, m, v, e = draw(), draw(), draw(0.1), [x.square_() for x in draw(0.1)], draw()
    steps = [torch.full((), 3.0, device="cuda") for _ in shapes]
    for i in range(3, len(shapes), 7):
        g[i] = m[i] = v[i] = steps[i] = None
    return [p, g, m, v, steps, e]


def clone_all(lists) -> list:
    """``lists`` of tensors cloned with their strides (so the misaligned
    tensor stays misaligned), None kept."""
    import torch

    def clone(x):
        if x is None:
            return None
        return torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x).copy_(x) \
            if x.data_ptr() % 16 else x.clone()

    return [[clone(x) for x in xs] for xs in lists]


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn`` captured alone in a CUDA graph (so the
    host's per-call work is not timed); ``fn`` runs once eagerly first."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def phase_masked_adamw(card: str) -> dict:
    """25a: the kernel against its plain version at DiffMa-L/2's parameter
    shapes on both mixers, a skip that writes nothing, and its time beside
    its bound, its plain version's and torch's fused AdamW's; returns its
    entry for the kernels line."""
    import torch

    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.ops.masked_adamw import masked_adamw_cuda, masked_adamw_plain

    print("== phase 25a: the masked AdamW + EMA update against its plain version, DiffMa-L/2's "
          "parameters", flush=True)
    entry = {"name": "masked_adamw", "route": "cuda",
             "source": "diffma_tpu_torch/csrc/masked_adamw.cu", "replaces": None}
    for label, use_mamba2 in (("Mamba-1", False), ("Mamba-2", True)):
        shapes = [p.shape for p in build_model("DiffMa-L/2", input_size=28,
                                               use_mamba2=use_mamba2).parameters()]
        n = sum(math.prod(s) for s in shapes)
        base = adamw_inputs(shapes, 25)
        alone = sum(g is None for g in base[1])
        sides = []
        for fn in (masked_adamw_cuda, masked_adamw_plain):
            args = clone_all(base)
            before = clone_all(args)
            fn(torch.tensor(False, device="cuda"), *args, **ADAMW_HYPER)
            if not all(torch.equal(bits(x), bits(y)) for xs, ys in zip(args, before)
                       for x, y in zip(xs, ys) if x is not None):
                fail(f"{label}: {fn.__name__} with keep false wrote a tensor")
            fn(torch.tensor(True, device="cuda"), *args, **ADAMW_HYPER)
            sides.append(args)
        torch.cuda.synchronize()
        worst, mean_rel = 0, {}
        for name, got, want in zip(("p", "g", "m", "v", "step", "ema"), *sides):
            if name == "g":  # read only, by both sides
                continue
            got = torch.cat([x.flatten() for x in got if x is not None])
            want = torch.cat([x.flatten() for x in want if x is not None])
            order = [torch.where(i < 0, -(i & 0x7FFFFFFF), i)
                     for i in (got.view(torch.int32).long(), want.view(torch.int32).long())]
            worst = max(worst, int((order[0] - order[1]).abs().max()))
            mean_rel[name] = float((got - want).abs().mean() / want.abs().mean())
        if worst > MAX_ADAMW_ULPS:
            fail(f"{label}: the kernel is {worst} ulps from its plain version "
                 f"(bar {MAX_ADAMW_ULPS})")
        far = {k: r for k, r in mean_rel.items() if r > TOL_ADAMW_MEAN}
        if far:
            fail(f"{label}: the kernel's mean-rel from its plain version is over "
                 f"{TOL_ADAMW_MEAN:g} in {far}")
        keep = torch.tensor(True, device="cuda")
        args = clone_all(base)
        ms = graph_ms(lambda: masked_adamw_cuda(keep, *args, **ADAMW_HYPER), 50)
        plain_ms = graph_ms(lambda: masked_adamw_plain(keep, *args, **ADAMW_HYPER), 10)
        bound_ms = 36 * n / HBM_BYTES_PER_S * 1e3
        try:  # torch's fused AdamW with found_inf and a foreach EMA: a yardstick only
            e = args[5]
            p, g, m, v, steps = ([x for x, y in zip(xs, args[1]) if y is not None]
                                 for xs in args[:5])
            found_inf = torch.zeros((), device="cuda")
            h = ADAMW_HYPER

            def library():
                torch._fused_adamw_(p, g, m, v, [], steps, lr=h["lr"], beta1=h["betas"][0],
                                    beta2=h["betas"][1], weight_decay=h["weight_decay"],
                                    eps=h["eps"], amsgrad=False, maximize=False,
                                    grad_scale=None, found_inf=found_inf)
                torch._foreach_mul_(e, h["ema_decay"])
                torch._foreach_add_(e, args[0], alpha=1 - h["ema_decay"])

            library_ms = graph_ms(library, 50)
        except (RuntimeError, TypeError) as exc:
            library_ms = None
            print(f"  library_ms not measured: {exc}")
        print(f"  [{card}] {label}: {len(shapes)} tensors ({alone} the EMA alone), {n} "
              f"parameters; kernel against plain: max {worst} ulp (bar {MAX_ADAMW_ULPS}), "
              f"mean-rel " + ", ".join(f"{k} {r:.2e}" for k, r in mean_rel.items())
              + f" (bar {TOL_ADAMW_MEAN:g} each); keep false "
              f"wrote nothing on either; {ms:.4f} ms a step, bound {bound_ms:.4f} ms (bytes, "
              f"36 a parameter at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), {bound_ms / ms:.1%} of it; "
              f"plain {plain_ms:.4f} ms; library (_fused_adamw_ + foreach EMA) "
              + (f"{library_ms:.4f} ms" if library_ms is not None else "not measured"))
        entry[label] = {"tensors": len(shapes), "parameters": n, "max_ulp": worst,
                        "mean_rel": mean_rel, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}
        del base, sides, args
        torch.cuda.empty_cache()
    return entry


def phase_masked_adamw_step(card: str) -> None:
    """25b: the L/2 Mamba-1 step, graphed and eager, over 3 finite batches
    and a NaN one: the NaN step leaves every tensor as it was, and the two
    runs end equal in bits, one update launched a step."""
    import copy

    import torch

    from diffma_tpu_torch.diffusion import create_diffusion
    from diffma_tpu_torch.models.diffma import build_model
    from diffma_tpu_torch.ops.masked_adamw import masked_adamw_cuda
    from diffma_tpu_torch.train.state import GraphedTrainStep, TrainState, adamw, make_train_step
    from diffma_tpu_torch.train.train import loss_draws, make_loss_fn, synthetic_batch

    nan_at = 2
    print("== phase 25b: the L/2 step graphed against eager over 4 batches, a NaN batch third",
          flush=True)
    diffusion = create_diffusion("", device="cuda")
    model = build_model("DiffMa-L/2", input_size=28, scan_impl="fused")
    model = model.init_weights(torch.Generator().manual_seed(0)).cuda().train()
    gen = torch.Generator(device="cuda").manual_seed(25)
    batches = []
    for i in range(4):
        b = synthetic_batch(gen, 8, 28, 196)
        b["t"], b["noise"] = loss_draws(diffusion, b["z"], gen)
        if i == nan_at:
            b["z"][0, 0, 0, 0] = float("nan")
        batches.append(b)

    def tensors(st):
        return ([p.detach() for p in st.model.parameters()] + list(st.ema.parameters())
                + [v for p in st.model.parameters() for v in st.optimizer.state[p].values()]
                + [st.step])

    ends = []
    for graphed in (False, True):
        m = copy.deepcopy(model)
        optimizer = adamw(m.parameters(), 1e-4)
        st = TrainState(m, optimizer)
        step = make_train_step(make_loss_fn(m, diffusion), optimizer)
        if graphed:
            step = GraphedTrainStep(step, "cuda")
        masked_adamw_cuda.launches = 0
        for i, b in enumerate(batches):
            if i == nan_at:
                before = [t.clone() for t in tensors(st)]
            finite = bool(step(st, b, None)["finite"])
            if finite != (i != nan_at):
                fail(f"step {i + 1}: finite {finite}")
            if i == nan_at:
                moved = sum(not torch.equal(bits(x), bits(y)) for x, y in zip(before, tensors(st)))
                if moved:
                    fail(f"the NaN step changed {moved} of {len(before)} tensors")
        mode = "graphed" if graphed else "eager"
        if masked_adamw_cuda.launches != len(batches):
            fail(f"the {mode} steps ran masked_adamw {masked_adamw_cuda.launches} times")
        ends.append([t.clone() for t in tensors(st)])
        print(f"  {mode}: the NaN step left all {len(before)} tensors (params, EMA, exp_avg, "
              f"exp_avg_sq, every step count, the step count) equal in bits; "
              f"{masked_adamw_cuda.launches} masked_adamw launches")
        del m, optimizer, st, step
    differ = sum(not torch.equal(bits(x), bits(y)) for x, y in zip(*ends))
    if differ:
        fail(f"graphed against eager after {len(batches)} steps: {differ} of {len(ends[0])} "
             f"tensors differ in bits")
    print(f"  [{card}] graphed against eager after {len(batches)} steps: all {len(ends[0])} "
          f"tensors equal in bits")
    del model, ends, batches
    torch.cuda.empty_cache()


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "diffma_tpu_torch")):
        fail("run chip_smoke.py from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {card}", flush=True)

    t0 = time.perf_counter()
    phase_build()
    scan = phase_kernels(card)
    mixer = phase_fused_mixer(card)
    scan_bwd = phase_scan_bwd(card)
    mixer_bwd = phase_mixer_bwd(card)
    ssd = phase_fused_ssd(card)
    epilogue = phase_spiral_epilogue(card)
    ssd_bwd = phase_ssd_bwd(card)
    inner = phase_mamba_inner(card)
    mixer["branches"] = phase_mixer_families(card)
    ssd["branches"] = phase_ssd_partition(card)
    mixer_bwd["branches"] = phase_mixer_bwd_branches(card)
    ssd_bwd["branches"] = phase_ssd_bwd_partition(card)
    core = phase_ssd_core(card)
    core["launches"], core_bf16_launches = phase_split_probe(card)
    phase_forward(card)
    phase_train_step(card)
    phase_mamba2_forward(card)
    phase_mamba2_train_step(card)
    phase_family_train_steps(card)
    inner["launches"] = phase_inner_path(card)
    phase_family_forwards(card)
    scan["launches"] = phase_sampler(card)
    mixer["launches"] = phase_fused_sampler(card)
    phase_checkpoint(card)
    counts, fp32_steps_s = phase_trainer(card)
    mixer_bwd["launches"] = counts["mixer_fused_bwd"]
    scan_bwd["launches"] = phase_composable_trainer(card)["selective_scan_bwd"]
    phase_learning(card, 9, use_mamba2=False)
    counts = phase_mamba2_samplers(card)
    ssd["launches"], epilogue["launches"] = counts["ssd_mixer_fwd"], counts["spiral_epilogue"]
    counts, fp32_mamba2_steps_s = phase_mamba2_trainer(card)
    ssd_bwd["launches"] = counts["ssd_mixer_bwd"]
    phase_mamba2_sizes(card)
    phase_learning(card, 13, use_mamba2=True)
    phase_family_samplers(card)
    counts = phase_family_trainers(card)
    mixer_bwd["branches"]["vim"]["launches"] = counts["ViM-B/2"]["mixer_fused_bwd"]
    mixer_bwd["branches"]["partition"]["launches"] = counts["EMamba-B/2"]["mixer_fused_bwd"]
    ssd_bwd["branches"]["partition"]["launches"] = counts["EMamba-B/2 --use-mamba2"]["ssd_mixer_bwd"]
    phase_learning(card, 16, use_mamba2=False, model="ViM-B/2")
    phase_conditioning(card)
    samples_17e = phase_real_data(card)
    phase_graphed_chains(card)
    fp32_step = phase_graphed_steps(card)
    t19 = time.perf_counter()
    stage_tables = bf16_stage_tables()
    mixer_bf16, mixer_bwd_bf16 = phase_bf16_kernels(card, mixer, mixer_bwd, stage_tables)
    counts, bf16_steps_s = phase_trainer(card, autocast=True)
    mixer_bwd_bf16["launches"] = counts["mixer_fused_bwd_bf16"]
    print(f"  [{card}] DiffMa-L/2 training step in the trainer's CLI, batch 8: bf16 "
          f"{1e3 / bf16_steps_s:.1f} ms, fp32 {1e3 / fp32_steps_s:.1f} ms (phase 7)")
    mixer_bf16["launches"], _ = phase_bf16_sampler(card)
    phase_learning(card, "19d", use_mamba2=False, autocast=True)
    phase_bf16_step_profile(card, fp32_step)
    print(f"phase 19 took {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    ssd_bf16, ssd_bwd_bf16, epilogue_bf16 = phase_bf16_ssd_kernels(card, ssd, epilogue, ssd_bwd,
                                                                   stage_tables)
    counts, bf16_mamba2_steps_s = phase_mamba2_trainer(card, autocast=True)
    ssd_bwd_bf16["launches"] = counts["ssd_mixer_bwd_bf16"]
    print(f"  [{card}] DiffMa-L/2 Mamba-2 training step in the trainer's CLI, batch 8: bf16 "
          f"{1e3 / bf16_mamba2_steps_s:.1f} ms, fp32 {1e3 / fp32_mamba2_steps_s:.1f} ms (phase 12)")
    ssd_bf16["launches"], dual_images = phase_bf16_sampler(card, use_mamba2=True)
    epilogue_bf16["launches"] = phase_bf16_fuse_block(card, dual_images)["spiral_epilogue_bf16"]
    phase_learning(card, "20e", use_mamba2=True, autocast=True)
    print(f"phase 20 took {time.perf_counter() - t20:.1f} s")
    t21 = time.perf_counter()
    phase_remat(card, phase_resume(card))
    phase_diffusion_api(card)
    print(f"phase 21 took {time.perf_counter() - t21:.1f} s")
    t22 = time.perf_counter()
    phase_decode(card)
    phase_assoc(card)
    phase_plumbing(card, samples_17e)
    print(f"phase 22 took {time.perf_counter() - t22:.1f} s")
    phase_parallel(card)
    t24 = time.perf_counter()
    inner_bf16 = phase_bf16_inner(card, inner, stage_tables)
    inner_bf16["launches"] = phase_bf16_inner_path(card)
    core_bf16 = phase_bf16_core(card, core, stage_tables)
    core_bf16["launches"] = core_bf16_launches
    phase_validate_imports(card)
    print(f"phase 24 took {time.perf_counter() - t24:.1f} s")
    t25 = time.perf_counter()
    adamw_entry = phase_masked_adamw(card)
    phase_masked_adamw_step(card)
    print(f"phase 25 took {time.perf_counter() - t25:.1f} s")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [scan, mixer, scan_bwd, mixer_bwd, ssd, epilogue, ssd_bwd,
                                  inner, core, mixer_bf16, mixer_bwd_bf16, ssd_bf16,
                                  ssd_bwd_bf16, epilogue_bf16, inner_bf16, core_bf16,
                                  adamw_entry]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2]))
    if sys.argv[1:] == ["--bf16-stages"]:
        sys.exit(bf16_stage_worker())
    sys.exit(main())
