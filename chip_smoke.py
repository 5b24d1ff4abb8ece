#!/usr/bin/env python3
"""Drive the PyTorch port (``ganleaks_tpu_torch``) on one CUDA GPU and check
it. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the build of every kernel library from ``csrc/`` (one
   ``nvcc`` per source, started together);
2. kernel: the fused distance+argmin kernel (K1) against its plain PyTorch
   version on the card, in float32 (3xTF32 tile) and bfloat16 (wgmma tile),
   each asserted through the per-route launch counts — a ragged synthetic
   count, one smaller than a tile with K = 4,099 (3 mod 4: both routes'
   zero-padded copy), several tiles per block, the attack's K = 512,000,
   and planted duplicate rows (exact ties); then both types at
   K = 512,000 on non-negative rows (LPIPS-like, planted near-copies)
   against float64 computed on the card, float32's relative error printed
   beside the former FFMA tile's 3.86e-6; then per-pair invariance: the
   same pairs' d bit for bit at four shapes that move them across query
   tiles, synthetic tiles and spans (K = 20,003);
3. topk: the fused distance+top-k kernel (K3) against its plain version,
   float32 and bfloat16: ragged N_s, N_s < k, a long N_s across many
   spans, K = 512,000 (zero-mean rows), k = 128 (the wrapper's limit),
   planted ties across tiles and spans; both types on non-negative rows
   at K = 512,000 against float64; per-pair invariance as in phase 2;
4. epilogue: the tap epilogue kernel (K2) against its plain version on
   every 64-px tap of 2,048 images as each LPIPS tower produces them
   (VGG16, AlexNet, SqueezeNet1.1 and ResNet18: 5, 5, 7 and 5 taps,
   channels-last views), float32 -> float32, bf16 -> bf16 and
   bf16 -> int8 (bounds from ``lpips_part_bounds``), and on edge cases in
   the same three modes (positions not a multiple of the tile, C of 17,
   40, 96 and 1056, one image, an NCHW-contiguous tap, an out slice at an
   unaligned column): parts bit for bit, row norms within rtol 1e-6 and
   identical over two launches;
5. attack: the full-width fbb l2-lpips attack (VGG16 at 64x64x3,
   K = 512,000, seeded surrogate backbone with the real lin heads) through
   ``run_attack`` and ``evaluate`` on 1,024 members, 1,024 non-members and
   8,192 synthetic images written as npz, with members' noisy copies
   planted in the synthetic set: engines 'pallas' and 'gemm' (the
   float32 cross-check), 'pallas' with ``two_pass``, 'taps', 'taps' on a
   bf16 tower with bf16 parts (the recipe 'auto' degrades to: K1 on the
   wgmma tile), 'taps-int8' (float32 tower), 'taps-int8' with
   ``two_pass`` and 'auto' (which must resolve to taps-int8 on a bf16
   tower); every loss against the float64 distance of its pair, every
   engine's indices against the float32 'pallas' run's, every run's
   launches per kernel and tile; then the float32 top-k search
   (``knn_topk_streamed``, engine 'pallas': K3 on the 3xTF32 tile) on the
   same arrays, its nearest entries against the 'pallas' run's;
5b. attack_towers: the same attack on the same sets with the AlexNet and
   SqueezeNet1.1 towers (seeded surrogate backbones, uniform lin heads):
   'taps' (K2, K1 on the 3xTF32 tile; the float32 reference), 'gemm',
   'taps' on a bf16 tower (K1 on the wgmma tile) and 'auto', held as in
   phase 5;
6. timing: K1 at the attack's block (2,048 x 2,048, K = 512,000) in
   float32 and bfloat16, K3 there in bfloat16 and float32, K2 per tap and
   summed over the five taps of a 2,048-image block — each beside its
   plain version, its bound (float32 K1/K3: the 3xTF32 tile's and an
   FFMA design's on the CUDA cores, with the share of each), and, where
   one PyTorch call composition
   computes the same function, that composition (timed only), K2 also
   with GB/s and its share of the byte bound; K1 and K3
   also on the block's first query tile alone, for the work per block
   with and without the full grid's shared traffic; K2 also summed over
   the alex and over the squeeze taps of 2,048 images, and each tap also
   queued behind a spin of the card (``device_ms``: the kernel's device
   time without the wrapper's host time between launches);
6b. scores and train: ``make_pair_dist_fn`` on 1,024 seeded 64-px 2AFC
   triplets ('net-lin' on vgg, alex and squeeze, 'net' on resnet: 2AFC
   and JND scores), the first 32 against the same towers on the CPU in
   float64, 'l2' and 'ssim' on the host; then three ``train_2afc`` steps
   (alex lin heads and the rank net, batch 50) on the card and on the CPU
   in float64 with the same dropout masks: losses within rtol 1e-4, lin
   heads >= 0, the trained lin heads and rank net within 1e-6 (1% of an
   Adam step at lr 1e-4) of float64's;
7. fid: ``fid_from_image_sets``'s parts at full width — InceptionV3 pool_3
   at 299x299 in float32, batch 50, on 5,000 64x64 member images and their
   5,000 noisy copies; the tower is the seeded surrogate with its
   BatchNorm statistics calibrated on 100 other images (as drawn, whole
   channels never fire and the covariances are singular). FID under
   'newton-schulz', 'eigh' (float64 on the card) and 'scipy', the device
   square roots within 1e-3 + 1e-3 * FID of scipy's with no fall-back, the
   FID of a set against itself (within 1e-3 of the -2 eps n its eps
   offset gives), the count of scipy fall-backs, and the
   card's activations on 8 images against the same tower on the CPU in
   float64, before and after the calibration;
8. reconstruction: ``run_reconstruction_attack`` end to end on seeded
   VAE-GAN weights (z_dim 100, d 64, self-attention gamma nonzero) written
   as npz, 2,048 member + 2,048 non-member npz queries, batch 256,
   'l2-lpips' (VGG16), then ``evaluate``; the first 32 queries' losses
   against the same modules on the CPU in float64 with the same eps;
9. tabular: ``run_tabular_attack`` at medGAN's MIMIC-III width (D =
   1,071 binary codes; 10,000 synthetic rows against 4,652 members and
   4,652 non-members, the 10% hold-out of 46,520 patients) with 'pallas'
   (K1 on the 3xTF32 tile, launches counted) and 'gemm': every loss and
   index against float64 distances; K1 at that shape against its plain
   version, and timed (the zero-padded copy to K = 1,072 inside the call),
   beside both float32 bounds;
10. north_star: ``attack_arrays`` at the reference study's shape — 10,000
   members, 10,000 non-members and 100,000 synthetic images at 64 px,
   uint8, drawn on the card (members' noisy copies planted) — with the
   device-memory planner: 'auto' (taps-int8 on a bf16 tower, 1,024-row
   blocks) must plan one synthetic sweep (K2 launched for 120,000 images'
   blocks exactly), 'taps' on a bf16 tower (K1 on the wgmma tile) too;
   'auto' with the planner off (two sweeps of the 8 GiB cache) and 'auto'
   with the process capped below the planned run's peak
   (``set_per_process_memory_fraction``: the one-sweep cache allocation
   raises, the search halves its chunk and resumes) must give the planned
   run's indices and losses exactly; 512 sampled queries of the bf16 runs
   are held against float64 (each loss within the certificate's bound of
   its returned image's distance, no image of a 4,096-image sample closer
   by more than the two bounds), and the bf16 tower's error on them is
   printed beside the certificate's eta;
11. ingest: phase 10's sets written as three PNG directories (120,000
   files) by the port's encoder (``io/native``; disk space checked
   first), then ``run_attack`` ('auto', the planner on) from them: cold
   (no decode cache yet: every image decoded and the cache written,
   ``io/diskcache``), again from the warm cache, and with
   ``host_stream=True`` and no disk cache (``io/stream.HostImageSet``:
   the synthetic set decoded block by block as the search reads it, the
   closest-pair plots on); each run's indices and losses equal phase
   10's 'auto' run's on
   the arrays exactly, with the same K2 launches; encode and decode
   images/s, ``ingest_s``, end-to-end query-pairs/s and the peak host
   RSS per run are printed;
12. victims: DCGAN and WGAN-GP at full width (nz 100, ngf 64, ndf 64,
   64 px): their first 3 steps at batch 8 (float64 on the host's cores
   is the limit) on the CPU in float64 and on the card in float64 and
   float32, from the same weights, batches, noise and eps, at lr 0 and at
   the configs' lr (``victim_hold`` states each bound and why: the
   card's float64 is the CPU's to 1e-9 and every parameter within 1e-6 lr;
   its float32 within rtol 1e-4 on losses, 2e-2 on gradients and 1e-5 on
   BatchNorm statistics, trained parameters within Adam's bound; a TF32
   and a no-cuDNN control printed), then each through its entry points —
   ``train`` one epoch at batch 128 on 1,024 seeded training PNGs (and
   steps/s timed apart, synchronised, after a warm-up step),
   ``generate`` its 2,040 images as the PNG + npz + noise triplet, 256
   training PNGs planted in the PNG dump, ``run_attack`` ('auto') with
   the training and 1,024 held-out PNGs as members and non-members, and
   ``evaluate`` (AUROC, every planted member below every non-member);
   then ``bench --metric gen`` (4,096 images, batch 512);
13. victims2: VAE-GAN (d 64, z 100, 64 px, batch 64), medGAN (D = 1,071
   codes, latent 128, batch 2,000) and PGGAN (nz 512, in_channels 512,
   4 -> 64 px, batch 32, bfloat16) — their first 3 steps from the same
   weights, batches and draws at lr 0 and at the configs' lr on the CPU
   in float64 and on the card in float64 and float32 (VAE-GAN at batch
   8, medGAN 256, PGGAN 8 at 8 px; ``v2_hold`` states each bound and
   why), PGGAN's card float32 against its float64 at 64 px and its bf16
   step against both; then each through its entry points: VAE-GAN
   ``train`` on phase 12's 1,024 training PNGs for 2 epochs of 8
   iterations (a checkpoint after each), the same run stopped after one
   epoch and resumed (held against the uninterrupted one), ``sample``
   2,048, ``run_reconstruction_attack`` with the trained ``netE`` /
   ``netG`` on 256 training and 256 held-out PNGs; medGAN ``train`` from
   a seeded 10,000 x 1,071 CSV with missing fields (2 pretrain and 2 GAN
   epochs), ``generate`` 10,000 records, ``run_tabular_attack``
   ('pallas': K1 launches counted); PGGAN's progressive ``train`` at
   4 -> 64 px on the 256 training PNGs (8 batches a resolution, the
   fade-in active), ``generate`` 2,040, 64 training PNGs planted,
   ``run_attack`` ('auto': K2 launches counted; every planted member
   below every non-member); each ``evaluate``d; and steps/s timed apart
   (VAE-GAN iterations, medGAN steps, PGGAN at 64 px in bf16 and
   float32);
14. privgan: privDCGAN (nz 100, ngf / ndf 64, 64 px) and privPGGAN (nz
   512, in_channels 512, 4 -> 64 px, float32), each with 2 splits and
   privacy_ratio 0.5 — privDCGAN's first 3 steps (the classifier's gate
   off, then on) at batch 8 a split on the CPU in float64 and on the
   card in float64 and float32 at lr 0 and at the config's lr with phase
   12's bars, every net's BatchNorm statistics held (``priv_hold``), the
   per-convolution gradient table; privPGGAN's step at 8 px likewise and
   at 64 px the card's float32 against its float64; on the card each
   generator's statistics advanced twice a step and the classifier's
   left bit for bit by the generator step; then each through its entry
   points — ``train_privdcgan`` on phase 12's 1,024 training PNGs (2
   splits of 512, batch 32, 2 epochs, the gate opening in the second),
   ``train_privpggan`` on phase 13's 256 (batch 32, one epoch a
   resolution, flips, the gate from 8 px) — ``generate_priv*`` 2,040
   images from split 0 under ``privDCGAN`` / ``privPGGAN``, 256 / 64 of
   split 0's training PNGs planted, ``run_attack`` ('auto': K2 launches
   counted; every planted member below every non-member), ``evaluate``;
   and steps/s (privDCGAN at batch 32 and 128 a split, DCGAN at 32,
   privPGGAN at 64 px) beside phases 12-13's DCGAN and PGGAN rates.

15. pipeline: the reference study's first steps at the split's default
   size — a synthetic CelebA (6,720 seeded 178x218 JPEGs written by
   Pillow: 112 identities of exactly 30 images, 168 of 20), ``cli.split``
   at ``num_images`` 10,020 and ``num_same_id`` 30 (3,340 members and
   3,340 non-members; 10,020 training PNGs, a third each plain, ``_a1``
   and ``_a2``), 32 sampled PNGs per directory against their crop of the
   JPEG decode bit for bit and every pack against its sorted PNGs; DCGAN
   at full width one epoch at batch 128 on the 128-px training PNGs (the
   reader resizes them), ``generate`` 10,000 images, 256 positive PNGs
   planted, ``run_attack`` ('auto': K2's launches counted against its
   plan; every planted member below every non-member), ``evaluate``; the
   plots where matplotlib imports (else a line that says it is absent);
   ``tools.profile_attack`` at its defaults ('auto'): the profiler's K2
   launches must equal the launch counter's, the projected and measured
   seconds and the device's idle share printed; ``tools.hbm_projection``
   at phase 10's configuration with the budget phase 10's plan read must
   give phase 10's plan (cache bytes, blocks, sweeps).
16. ranks (run right after phase 5b, on phase 5's sets): the attack on a
   mesh (``parallel/knn_shard`` through ``attack_arrays(..., mesh=)``),
   VGG16 l2-lpips at 64 px — one ``parallel/multihost.launch`` of 2 ranks
   on cuda:0 over ``gloo`` (collectives staged through host memory):
   sharded 'auto' (K2, int8 products), sharded 'pallas' (K1 on the 3xTF32
   tile), sharded 'pallas' two-pass (K3 bf16 in pass 1, K1 in the
   re-rank), ring 'auto', ring 'taps' on a bf16 tower (K1 on the wgmma
   tile); one launch of 1 rank over NCCL (sharded 'auto'); then
   ``dryrun_multichip(2)``. Every run against phase 5's one-process run
   of the same search: the indices (where they differ, a near-tie within
   the engine's bar), every loss within the engine's bar of its pair's
   float64 distance, every planted member below every non-member, each
   rank's K1 / K2 / K3 launches against the plan; seconds per rank
   beside one process's, and the host-staging seconds and bytes.
17. train_ranks (run after phase 14, on phase 12's PNGs): the trainers'
   multi-GPU layouts — one ``parallel/multihost.launch`` of 2 ranks on
   cuda:0 over ``gloo``: DCGAN and WGAN-GP (nz 100, ngf / ndf 64, batch
   128), VAE-GAN (batch 64), medGAN (1,071 codes, batch 2,000) and PGGAN
   (64 px, batch 32, float32 and bf16) data-parallel (``parallel/dp``), a
   warm-up step and 3 timed ones, each against one process's steps on
   the same batches and draws (rank 0 runs them): the replicas bit for
   bit, losses, updates, buffers and every parameter within phases
   12-13's float32 / bf16 bars, steps/s per rank beside one process's,
   the collective seconds and staged bytes a step; EP privDCGAN (gate
   off) and privPGGAN (gate on) at 2 splits, one a rank
   (``parallel/ep``), 2 steps against the all-splits step, the
   classifier's replicas bit for bit; ``train`` (one epoch at batch 128)
   + ``generate`` of DCGAN on the 2 ranks (rank 0 alone writes the
   checkpoint), 256 training PNGs planted, ``run_attack`` ('auto': K2
   launches counted), ``evaluate``; then one rank over NCCL: the DCGAN
   data-parallel steps on a mesh of size 1 against one process's. Phase
   16's ``dryrun_multichip(2)`` runs the data-parallel DCGAN step and the
   EP privDCGAN step too.

Phase 12 and phase 14's privDCGAN hold also print each convolution's
gradient error against float64 with cuDNN and without it
(``grad_by_conv``).

Phases 7, 8, 12, 13 and 14's training and sampling run no hand-written kernel
(their convolutions and products are the library's, as in the JAX package
they are XLA's); their launch counts are read and printed all the same.

Then, on lines of their own, the ``nvidia-smi`` name/power line and the
``{"kernels": [...]}`` summary, and last ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device, or without the package beside it, it exits 1 before
printing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense, 700 W): float32 on the CUDA cores,
# bf16 and TF32 on the tensor cores, and device-memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# float32 K1/K3 issue three TF32 products per multiply-add (3xTF32)
TF32X3_PRODUCTS = 3
# the former FFMA tile's relative error off float64 on LPIPS rows at
# K = 512,000 (PERF.md), printed beside the 3xTF32 tile's
FFMA_REL_ERR = 3.86e-6
# |d_kernel - d_plain| <= TOL * (rq + rs): the two sum K products in
# different orders and rq + rs - 2 q.s cancels
TOL = 1e-5
SEED = 0
# the main path's shapes; a rehearsal on the CPU may shrink them
DEVICE = "cuda"
N_POS = 1024
N_SYN = 8192
RES = 64
TOPK_K = 4  # AttackConfig.two_pass_k
LPIPS_NETS = ("vgg", "alex", "squeeze", "resnet")  # every LPIPS tower
FID_N = 5000       # images per FID set: more than 2048, full-rank statistics
FID_BATCH = 50     # z_fid.py:68
FID_CALIB = 100    # images that set the surrogate tower's BN statistics
FID_NOISE = 24     # +- pixel noise of the second FID set's copies
RECON_N = 2048     # member and non-member queries of the reconstruction
RECON_BATCH = 256  # ReconstructionConfig.batch
RECON_CHECK = 32   # queries of the first batch held against float64
TAB_D = 1071       # medGAN's MIMIC-III width (Choi et al. 2017, Table 1)
TAB_SYN = 10000
TAB_Q = 4652       # the 10% hold-out of 46,520 patients, on either side
SCORES_N = 1024    # seeded 64-px 2AFC triplets
SCORES_BATCH = 256  # ScoresConfig.batch_size
SCORES_CHECK = 32  # triplets held against the CPU in float64
SCORES_SSIM = 256  # triplets the host's DSSIM (a python loop) scores
TRAIN_BATCH = 50   # the reference trainer's batch of 64-px patches
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
TRAIN_ATOL = TRAIN_LR / 100  # 1% of one Adam step (|update| ~ lr)
NS_POS = 10000     # the north star: 10,000 + 10,000 queries
NS_SYN = 100000    # x 100,000 synthetic images (the reference study's)
NS_BLOCK = 1024    # 'auto' blocks: the halved cache of the forced-OOM run
                   # fits beside them at the same blocks
NS_SAMPLE = 512    # queries held against float64
NS_SUBSET = 4096   # synthetic images each sampled query is checked against


VICTIM_TRAIN = 1024    # training PNGs (and as many held-out non-members)
VICTIM_BATCH = 128     # the configs' batch: 8 steps per epoch
VICTIM_PLANT = 256     # training PNGs planted in each victim's PNG dump
VICTIM_HOLD_STEPS = 3  # steps held against float64 on the CPU
VICTIM_HOLD_BATCH = 8  # their batch (float64 on the host's cores)
# the card's float32 against the CPU's float64 (victim_hold says why)
VICTIM_LOSS_RTOL = 1e-4   # lr-0 steps: losses, relative (absolute < 1)
VICTIM_GRAD_RTOL = 2e-2   # lr-0 steps: gradients, L2, relative
VICTIM_STAT_RTOL = 1e-5   # lr-0 steps: BN statistics' change, L2, relative
VICTIM_TRAJ_RTOL = {"dcgan": 1e-4, "wgangp": 5e-2}  # trained steps' losses
VICTIM_UPDATE_RTOL = 0.5  # trained: updates, statistics' change, L2
# the card's float64 against the CPU's float64
VICTIM_F64_RTOL = 1e-9    # losses, gradients, updates, statistics
VICTIM_F64_STEP = 1e-6    # every trained parameter, in units of lr
VICTIM_TIMED_STEPS = 10   # train steps timed at batch 128 after a warm-up
# phase 13: VAE-GAN, medGAN and PGGAN at the reference's widths
V2_HOLD_STEPS = 3
V2_HOLD_BATCH = {"vaegan": 8, "medgan": 256, "pggan": 8}
V2_PGGAN_CPU_STEPS = 1     # the CPU's float64 PGGAN steps at 8 px
V2_PGGAN_TOP = 4           # 64 px: the card's own float64 / float32 / bf16
V2_ALPHA = 0.5
# the card's float64 parameters against the CPU's, in units of lr: Adam
# divides a zero gradient's float64 rounding noise (~1e-14 on the biases
# ahead of a train-mode BatchNorm) by its eps 1e-8, up to 1e-6 lr a step
V2_F64_STEP = 1e-5
# trained losses, float32 against float64: PGGAN's read 2.1-4.7% at
# 64 px (Adam's sign-like steps part the trajectories)
V2_TRAJ_RTOL = {"vaegan": 1e-2, "medgan": 1e-3, "pggan": 0.1,
                "privdcgan": VICTIM_TRAJ_RTOL["dcgan"], "privpggan": 0.1}
V2_BF16_LOSS = 0.08        # bf16 lr-0 losses, relative (absolute < 1)
V2_BF16_TRAJ = 0.15        # bf16 trained losses (float32's drift 2%)
V2_BF16_GRAD = 0.25        # bf16 lr-0 gradients, L2, relative
V2_BF16_UPDATE = 1.0       # bf16 trained updates, L2, relative
V2_TRAIN_PNGS = 256        # PGGAN's training set; the attacks' query sets
V2_PLANT = 64              # PGGAN training PNGs planted in its dump
TAB2_ROWS = 10000          # medGAN's seeded CSV: rows x TAB_D codes
# phase 14: privDCGAN and privPGGAN at the reference's widths
PRIV_SPLITS = 2            # N_splits
PRIV_RATIO = 0.5           # privacy_ratio
PRIV_HOLD_BATCH = 8        # per split, the held steps
PRIV_DP = (False, True, True)  # the held privDCGAN steps' classifier gates
PRIV_DCGAN_BATCH = 32      # configs/dcgan_config.yaml
PRIV_DCGAN_EPOCHS = 2      # dp_delay 0: the gate opens in the second
PRIV_PGGAN_TOP = 4         # 64 px
PRIV_PGGAN_DP_DELAY = 8    # the private critic trains from 8 px
PRIV_GENERATED = 2040      # the configs' num_generated
PRIV_PLANT = {"privdcgan": VICTIM_PLANT, "privpggan": V2_PLANT}
PRIV_RATE_BATCHES = (32, 128)  # privDCGAN steps/s, per split
# a generator's statistics after the step against two forwards of a copy
# (L2 over the change): the same float32 operations in the same order
PRIV_STAT_RTOL = 1e-5
# phase 15: the pipeline from the split to AUROC (SplitConfig's defaults)
PIPE_IMAGES = 10020        # SplitConfig.num_images: a third each pool
PIPE_SAME_ID = 30          # SplitConfig.num_same_id: a member identity
PIPE_MEMBER_IDS = 112      # identities of exactly 30 images (3,360)
PIPE_PUBLIC_IDS = 168      # identities of 20 images (3,360)
PIPE_PUBLIC_PER_ID = 20
PIPE_CHECK = 32            # PNGs per directory held against the JPEGs
PIPE_BATCH = 128           # DCGAN's batch
PIPE_GENERATED = 10000     # sampled images
PIPE_PLANT = 256           # positive PNGs planted in the dump


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(torch, n_q, n_s, k_dim, dtype, ties, gen):
    """Seeded q (n_q, K), s (n_s, K) and their float32 squared norms.
    ``ties``: (query row, a, b) with s[a] == s[b] planted as that query's
    nearest rows, a < b."""
    from ganleaks_tpu_torch.ops.knn_fused import sq_norms
    dev = torch.device(DEVICE)
    q = torch.randn((n_q, k_dim), generator=gen, device=dev) / k_dim ** 0.5
    s = torch.randn((n_s, k_dim), generator=gen, device=dev) / k_dim ** 0.5
    for row, a, b in ties:
        near = q[row] + 0.05 * torch.randn(
            (k_dim,), generator=gen, device=dev) / k_dim ** 0.5
        s[a] = near
        s[b] = near
    q, s = q.to(dtype).contiguous(), s.to(dtype).contiguous()
    return q, s, sq_norms(q), sq_norms(s)


def kernel_case(torch, name, n_q, n_s, k_dim, dtype, ties, gen):
    """One comparison on the card at freshly made inputs."""
    q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, dtype, ties, gen)
    return hold_against_plain(torch, name, q, s, rq, rs, ties)


def hold_against_plain(torch, name, q, s, rq, rs, ties):
    """The kernel against its plain version on the same inputs: every d
    within TOL * (rq + rs), indices equal wherever the plain version's best
    two distances lie further apart than that, and on the planted ties."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_argmin_plain)
    n_q, k_dim = q.shape
    n_s = s.shape[0]
    done = on_route(knn_argmin_fused, q.dtype)
    d_k, i_k = knn_argmin_fused(q, s, rq=rq, rs=rs)
    done(name)
    d_p, i_p = knn_argmin_plain(q, s, rq, rs)
    if DEVICE == "cuda":
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
    full = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    tol = TOL * (rq + rs[i_p.long()])
    err = (d_k - d_p).abs()
    check(bool(torch.isfinite(d_k).all()), f"{name}: non-finite d")
    check(bool((err <= tol).all()),
          f"{name}: d off by {float((err / tol).max()):.3g} x tolerance")
    if n_s >= 2:
        top2 = torch.topk(full, 2, dim=1, largest=False).values
        clear = (top2[:, 1] - top2[:, 0]) > tol
    else:
        clear = torch.ones_like(err, dtype=torch.bool)
    bad = clear & (i_k != i_p)
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} indices differ where the plain "
          f"version's best two are apart")
    for row, a, _b in ties:
        check(int(i_p[row]) == a and int(i_k[row]) == a,
              f"{name}: planted tie at query {row} -> kernel "
              f"{int(i_k[row])}, plain {int(i_p[row])}, want {a}")
    return {"case": name, "n_q": n_q, "n_s": n_s, "k": k_dim,
            "dtype": str(q.dtype).replace("torch.", ""),
            "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / tol).max()),
            "ambiguous_rows": int((~clear).sum()),
            "ties": len(ties)}


def nonneg_inputs(torch, n_q, n_s, k_dim, near, gen, dtype):
    """LPIPS-like rows of ``dtype``: ``relu`` of seeded normal rows (every
    product >= 0), with each (query row, a) in ``near`` planting s[a] as a
    noisy copy of q[row]; float32 norms."""
    from ganleaks_tpu_torch.ops.knn_fused import sq_norms
    dev = torch.device(DEVICE)
    q = torch.randn((n_q, k_dim), generator=gen, device=dev).relu_()
    s = torch.randn((n_s, k_dim), generator=gen, device=dev).relu_()
    for row, a in near:
        s[a] = (q[row] + 0.05 * torch.randn(
            (k_dim,), generator=gen, device=dev)).relu_()
    q = (q / k_dim ** 0.5).to(dtype)
    s = (s / k_dim ** 0.5).to(dtype)
    return q, s, sq_norms(q), sq_norms(s)


def distances_f64(torch, q, s, rq, rs, chunk: int = 256):
    """rq + rs - 2 q.s with the cross term in float64 on the card (the
    float32 norms are the kernels' inputs, so only the cross term's
    rounding differs)."""
    cross = torch.empty((q.shape[0], s.shape[0]), dtype=torch.float64,
                        device=q.device)
    s64 = s.double()
    for lo in range(0, q.shape[0], chunk):
        cross[lo:lo + chunk] = q[lo:lo + chunk].double() @ s64.T
    del s64
    return rq.double()[:, None] + rs.double()[None, :] - 2.0 * cross


def hold_against_f64(torch, name, q, s, rq, rs, near, k=None, d64=None):
    """K1 (``k`` None) or K3 on non-negative rows against float64: every
    reported d within TOL * (rq + rs) of its pair's float64 distance, each
    pick within 2 TOL * (rq + rs) of the float64 rank it stands at, and
    the planted near-copies found first."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_topk_fused)
    d64 = distances_f64(torch, q, s, rq, rs) if d64 is None else d64
    if k is None:
        done = on_route(knn_argmin_fused, q.dtype)
        d_k, i_k = knn_argmin_fused(q, s, rq=rq, rs=rs)
        d_k, i_k = d_k[:, None], i_k[:, None]
    else:
        done = on_route(knn_topk_fused, q.dtype)
        d_k, i_k = knn_topk_fused(q, s, k, rq=rq, rs=rs)
    done(name)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    idx = i_k.long()
    norms = rq.double()[:, None] + rs.double()[idx]
    tol = TOL * norms
    err = (d_k.double() - d64.gather(1, idx)).abs()
    check(bool(torch.isfinite(d_k).all()), f"{name}: non-finite d")
    check(bool((err <= tol).all()),
          f"{name}: d off float64 by {float((err / tol).max()):.3g} x "
          f"tolerance")
    ranks = torch.sort(d64, dim=1).values[:, :idx.shape[1]]
    gap = d64.gather(1, idx) - ranks
    check(bool((gap <= 2.0 * tol).all()),
          f"{name}: picks off the float64 ranks by "
          f"{float((gap / tol).max()):.3g} x tolerance")
    for row, a in near:
        check(int(i_k[row, 0]) == a,
              f"{name}: near-copy of query {row} -> {int(i_k[row, 0])}, "
              f"want {a}")
    out = {"case": name, "n_q": q.shape[0], "n_s": s.shape[0],
           "k_dim": q.shape[1], "k": k,
           "dtype": str(q.dtype).replace("torch.", ""),
           "reference": "float64",
           "max_abs_err": float(err.max()),
           "max_err_over_tol": float((err / tol).max()),
           "max_rel_err": float((err / norms).max())}
    if q.dtype == torch.float32:
        out["ffma_tile_max_rel_err"] = FFMA_REL_ERR
    return out


# per-pair invariance: (query rows, synthetic rows) of one set, sliced so
# that the same pairs sit at other positions in the query tiles, in other
# synthetic tiles and in other spans of the launch plan
INVARIANCE_K = 20003  # 3 mod 4: the padded copy, and 157 promotions
INVARIANCE_SETS = (600, 9000)
INVARIANCE_SLICES = ((0, 600, 0, 9000), (3, 260, 3000, 5100),
                     (0, 128, 0, 9000), (5, 6, 3999, 4001))
INVARIANCE_NEAR = ((5, 4000), (200, 3001), (130, 5000), (7, 8999))


def hold_invariance(torch, name, dtype, gen, k=None):
    """K1 (``k`` None) or K3 at each slice of ``INVARIANCE_SLICES`` with
    the norms sliced from one computation: every (query, synthetic) pair
    that two launches report has the same d bit for bit, and the planted
    near-copies are found wherever their pair is in the slice."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_topk_fused)
    q, s, rq, rs = nonneg_inputs(torch, *INVARIANCE_SETS, INVARIANCE_K,
                                 INVARIANCE_NEAR, gen, dtype)
    seen: dict = {}
    compared = 0
    for q0, q1, s0, s1 in INVARIANCE_SLICES:
        args = (q[q0:q1].contiguous(), s[s0:s1].contiguous())
        kw = {"rq": rq[q0:q1].contiguous(), "rs": rs[s0:s1].contiguous()}
        fn = knn_argmin_fused if k is None else knn_topk_fused
        done = on_route(fn, dtype)
        d, i = (fn(*args, **kw) if k is None else fn(*args, k, **kw))
        done(f"{name} slice {(q0, q1, s0, s1)}")
        bits_rows = d.reshape(q1 - q0, -1).view(torch.int32).tolist()
        i = i.reshape(q1 - q0, -1).tolist()
        for row, (cols, row_bits) in enumerate(zip(i, bits_rows)):
            for col, bits in zip(cols, row_bits):
                if col < 0:
                    continue
                pair = (q0 + row, s0 + col)
                if pair in seen:
                    compared += 1
                    check(seen[pair] == bits,
                          f"{name}: pair {pair} gives d bits {bits:#x} at "
                          f"slice {(q0, q1, s0, s1)}, {seen[pair]:#x} "
                          f"before")
                seen[pair] = bits
        for row, a in INVARIANCE_NEAR:
            if q0 <= row < q1 and s0 <= a < s1:
                check(i[row - q0][0] == a - s0,
                      f"{name}: near-copy of query {row} -> "
                      f"{s0 + i[row - q0][0]}, want {a}")
    check(compared >= len(INVARIANCE_NEAR),
          f"{name}: only {compared} pairs seen twice")
    return {"case": name, "k_dim": INVARIANCE_K, "k": k,
            "dtype": str(dtype).replace("torch.", ""),
            "slices": [list(x) for x in INVARIANCE_SLICES],
            "pairs_compared": compared, "bit_identical": True}


def phase_kernel(torch) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [
        # ragged n_s (7 tiles + 104 rows), ties across tiles and spans
        ("ragged", 200, 1000, 1000, [(3, 10, 900), (150, 129, 130)]),
        # n_s below one tile, K not a multiple of 4 (scalar loads)
        ("small_s_odd_k", 130, 50, 4099, [(7, 5, 40)]),
        # many tiles per block, the merge across spans
        ("long_s", 100, 70000, 64, [(50, 3, 69999)]),
        # the attack's embedding width
        ("k512000", 256, 300, 512000, [(0, 1, 299), (255, 128, 256)]),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n_q, n_s, k_dim, ties in cases:
            res = kernel_case(torch, name, n_q, n_s, k_dim, dtype, ties, gen)
            worst[res["dtype"]] = max(worst[res["dtype"]], res["max_abs_err"])
            emit({"phase": "kernel", **res})
    # LPIPS-like rows: each tile's promoted sum against float64
    for dtype in (torch.float32, torch.bfloat16):
        q, s, rq, rs = nonneg_inputs(torch, 256, 300, 512000,
                                     [(3, 17), (200, 299)], gen, dtype)
        res = hold_against_f64(torch, "k512000_nonneg", q, s, rq, rs,
                               [(3, 17), (200, 299)])
        worst[res["dtype"]] = max(worst[res["dtype"]], res["max_abs_err"])
        emit({"phase": "kernel", **res})
        del q, s
    for dtype in (torch.float32, torch.bfloat16):
        emit({"phase": "kernel",
              **hold_invariance(torch, "per_pair_invariance", dtype, gen)})
    return worst


# ---------------------------------------------------------------------------
# phase 3: K3 against its plain version
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_topk_fused)
    from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue
    for fn in (knn_argmin_fused, knn_topk_fused, tap_epilogue):
        fn.launches = 0
    for fn in (knn_argmin_fused, knn_topk_fused):
        fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_launches() -> dict:
    """Launches per kernel, K1 and K3 per tile: 'knn_argmin.tf32x3'
    (float32) and 'knn_argmin.wgmma' (bfloat16), likewise 'knn_topk.*'."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_topk_fused)
    from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue
    out = {}
    for name, fn in (("knn_argmin", knn_argmin_fused),
                     ("knn_topk", knn_topk_fused)):
        check(sum(fn.launches_by_route.values()) == fn.launches,
              f"{name}: per-tile counts {fn.launches_by_route} do not add "
              f"up to {fn.launches}")
        out.update({f"{name}.{r}": n
                    for r, n in fn.launches_by_route.items()})
    out["tap_epilogue"] = tap_epilogue.launches
    return out


def on_route(fn, dtype):
    """A check to call after one call of ``fn``: on the card it must have
    launched the tile of ``dtype`` (3xTF32 for float32, wgmma for bfloat16)
    exactly once, and no other."""
    from ganleaks_tpu_torch.ops.knn_fused import route
    want = route(dtype)
    before = dict(fn.launches_by_route)

    def done(name):
        if DEVICE != "cuda":
            return
        got = {r: n - before[r] for r, n in fn.launches_by_route.items()}
        check(got == {r: int(r == want) for r in got},
              f"{name}: launches per tile {got}, want one on {want}")
    return done


def hold_topk(torch, name, q, s, rq, rs, k, ties):
    """K3 against its plain version on the same inputs: the (+inf, -1)
    fill where N_s < k, every finite d within TOL * (rq + rs), indices
    equal wherever the plain version's distance at that rank lies further
    than that from both neighbouring ranks (rank k+1 included), and the
    planted ties lower index first."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_topk_fused,
                                                  knn_topk_plain)
    done = on_route(knn_topk_fused, q.dtype)
    d_k, i_k = knn_topk_fused(q, s, k, rq=rq, rs=rs)
    done(name)
    d_p1, i_p1 = knn_topk_plain(q, s, k + 1, rq, rs)
    if DEVICE == "cuda":
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
    d_p, i_p = d_p1[:, :k], i_p1[:, :k]
    fin = torch.isfinite(d_p)
    check(bool((torch.isfinite(d_k) == fin).all()),
          f"{name}: finite entries differ from the plain version's")
    check(bool((i_k[~fin] == -1).all()), f"{name}: fill is not -1")
    tol = TOL * (rq[:, None] + rs[i_p.long().clamp(min=0)])
    err = torch.where(fin, (d_k - d_p).abs(), torch.zeros_like(d_k))
    check(bool((err <= tol).all()),
          f"{name}: d off by {float((err / tol).max()):.3g} x tolerance")
    inf = torch.full_like(d_p1[:, :1], torch.inf)
    ext = torch.cat([-inf, d_p1], dim=1)
    clear = ((ext[:, 1:k + 1] - ext[:, :k] > tol)
             & (ext[:, 2:k + 2] - ext[:, 1:k + 1] > tol) & fin)
    bad = clear & (i_k != i_p)
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} indices differ at clear ranks")
    for row, a, b in ties:
        want = [a, b] if a != b else [a]
        got = i_k[row, :len(want)].tolist()
        check(got == want and i_p[row, :len(want)].tolist() == want,
              f"{name}: planted tie at query {row} -> {got}, want {want}")
    return {"case": name, "n_q": q.shape[0], "n_s": s.shape[0],
            "k_dim": q.shape[1], "k": k,
            "dtype": str(q.dtype).replace("torch.", ""),
            "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / tol).max()),
            "unclear_entries": int((fin & ~clear).sum()),
            "ties": len(ties)}


def phase_topk(torch) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    cases = [
        # ragged n_s (7 tiles + 104 rows), ties across tiles and spans
        ("ragged", 200, 1000, 1000, 4, [(3, 10, 900), (150, 129, 130)]),
        ("ragged_k8", 200, 1000, 1000, 8, [(7, 2, 999)]),
        # fewer synthetic rows than k, K not a multiple of 4
        ("fewer_than_k", 130, 3, 4099, 4, []),
        # many tiles per block, the merge across spans
        ("long_s", 100, 70000, 64, TOPK_K, [(50, 3, 69999)]),
        # the attack's embedding width (zero-mean rows)
        ("k512000", 256, 300, 512000, TOPK_K,
         [(0, 1, 299), (255, 128, 256)]),
        # the wrapper's largest k (the wgmma ring shrinks to 3 stages)
        ("k128", 200, 700, 1000, 128, [(5, 0, 699), (130, 300, 301)]),
    ]
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n_q, n_s, k_dim, k, ties in cases:
            q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, dtype,
                                         ties, gen)
            res = hold_topk(torch, name, q, s, rq, rs, k, ties)
            worst[res["dtype"]] = max(worst[res["dtype"]], res["max_abs_err"])
            emit({"phase": "topk", **res})
    for dtype in (torch.float32, torch.bfloat16):
        q, s, rq, rs = nonneg_inputs(torch, 256, 300, 512000,
                                     [(3, 17), (200, 299)], gen, dtype)
        res = hold_against_f64(torch, "k512000_nonneg", q, s, rq, rs,
                               [(3, 17), (200, 299)], k=TOPK_K)
        worst[res["dtype"]] = max(worst[res["dtype"]], res["max_abs_err"])
        emit({"phase": "topk", **res})
        del q, s
    for dtype in (torch.float32, torch.bfloat16):
        emit({"phase": "topk",
              **hold_invariance(torch, "per_pair_invariance", dtype, gen,
                                k=TOPK_K)})
    return worst


# ---------------------------------------------------------------------------
# phase 4: K2 against its plain version on the tower's taps
# ---------------------------------------------------------------------------

def epilogue_modes(torch) -> dict:
    """name -> (tower dtype, embed dtype, output dtype, int8)."""
    return {"f32": (None, torch.float32, torch.float32, False),
            "bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
            "bf16_int8": (torch.bfloat16, torch.bfloat16, torch.int8, True)}


def tower_taps(torch, model, x, tower_dtype):
    """The taps as the port's tower returns them, with each tap's scale
    (the main path's featuriser does exactly this)."""
    from ganleaks_tpu_torch.ops.lpips.lpips import _tap_scale
    feats = model.features(x, tower_dtype)
    return [(fl, _tap_scale(w, 0.2, fl.shape[1] * fl.shape[2]))
            for fl, w in zip(feats, model.lins)]


def phase_epilogue(torch) -> float:
    x = torch.from_numpy(make_images(np.random.default_rng(SEED + 2),
                                     2 * N_POS, RES)).to(DEVICE)
    worst = 0.0
    for net in LPIPS_NETS:
        worst = max(worst, epilogue_tower_taps(torch, net, x))
    with torch.inference_mode():
        for mode in epilogue_modes(torch):
            for case in EPILOGUE_EDGE_CASES:
                worst = max(worst, epilogue_edge_case(torch, mode, *case))
    return worst


def epilogue_tower_taps(torch, net, x) -> float:
    """K2 against its plain version on every tap of ``net``'s tower for
    the images ``x``, in each of ``epilogue_modes``: parts bit for bit, rn
    within rtol 1e-6."""
    from ganleaks_tpu_torch.ops.lpips import (default_lpips_params,
                                              lpips_part_bounds)
    from ganleaks_tpu_torch.ops.lpips.epilogue import (tap_epilogue,
                                                       tap_epilogue_plain)
    model = default_lpips_params(net).to(DEVICE).eval()
    bounds = lpips_part_bounds(model, (RES, RES, 3))
    worst = 0.0
    with torch.inference_mode():
        for mode, (tdt, edt, odt, quant) in epilogue_modes(torch).items():
            for i, (fl, sc) in enumerate(tower_taps(torch, model, x, tdt)):
                kw = dict(embed_dtype=edt, out_dtype=odt,
                          quant_bound=bounds[i] if quant else None)
                part, rn = tap_epilogue(fl, sc, **kw)
                want, rn_want = tap_epilogue_plain(fl, sc, **kw)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                diff = (part.float() - want.float()).abs()
                n_diff = int((part != want).sum())
                rn_rel = float(((rn - rn_want).abs() / rn_want).max())
                worst = max(worst, float(diff.max()))
                emit({"phase": "epilogue", "net": net, "mode": mode,
                      "tap": i, "shape": list(fl.shape),
                      "strides": list(fl.stride()),
                      "out_dtype": str(part.dtype).replace("torch.", ""),
                      "parts_differing": n_diff,
                      "max_abs_diff": float(diff.max()),
                      "rn_max_rel_err": rn_rel})
                # the limit is bit-for-bit equality: one differing part
                # element fails the phase
                check(n_diff == 0, f"epilogue {net} {mode} tap {i}: "
                                   f"{n_diff} parts differ, max |diff| "
                                   f"{float(diff.max()):.3g}")
                check(rn_rel <= 1e-6, f"epilogue {net} {mode} tap {i}: rn "
                                      f"off by {rn_rel:.3g}")
                del part, rn, want, rn_want
    return worst


# (name, N, H, W, C, layout, out column offset): layouts and shapes the
# tower's taps do not cover — positions not a multiple of the kernel's
# tile, channel counts off its 32-channel chunk or over 1024, one image, an
# NCHW-contiguous tap (its generic load path), an out slice at an unaligned
# column (no 16-byte or bulk stores)
EPILOGUE_EDGE_CASES = [
    ("ragged_positions", 2048, 5, 7, 64, "nhwc", 0),
    ("c17", 2048, 8, 8, 17, "nhwc", 0),
    ("c40", 2048, 16, 16, 40, "nhwc", 0),
    ("c96", 2048, 16, 16, 96, "nhwc", 0),
    ("c1056", 256, 4, 4, 1056, "nhwc", 0),
    ("n1", 1, 64, 64, 64, "nhwc", 0),
    ("nchw", 2048, 32, 32, 128, "nchw", 0),
    ("unaligned_out", 2048, 16, 16, 256, "nhwc", 3),
]


def epilogue_edge_case(torch, mode, name, n, h, w, c, layout, col) -> float:
    """K2 against its plain version on one edge case in one of
    ``epilogue_modes`` (bounds from the scale): parts bit for bit, rn
    within rtol 1e-6 and identical over two launches."""
    from ganleaks_tpu_torch.ops.lpips.epilogue import (tap_epilogue,
                                                       tap_epilogue_plain)
    _, edt, odt, quant = epilogue_modes(torch)[mode]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    shape = (n, c, h, w) if layout == "nchw" else (n, h, w, c)
    tap = torch.randn(shape, generator=gen, device=DEVICE).relu_().to(edt)
    if layout == "nchw":
        tap = tap.permute(0, 2, 3, 1)
    scale = torch.rand((c,), generator=gen, device=DEVICE) * 0.05
    kw = dict(embed_dtype=edt, out_dtype=odt,
              quant_bound=float(scale.max()) if quant else None)
    width = h * w * c
    buf = torch.zeros((n, col + width + 5), dtype=torch.int8 if quant
                      else odt, device=DEVICE)
    part, rn = tap_epilogue(tap, scale, out=buf[:, col:col + width], **kw)
    rn1 = rn.clone()
    part, rn = tap_epilogue(tap, scale, out=buf[:, col:col + width], **kw)
    want, rn_want = tap_epilogue_plain(tap, scale, **kw)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    diff = (part.float() - want.float()).abs()
    n_diff = int((part != want).sum())
    rn_rel = float(((rn - rn_want).abs() / rn_want).max())
    untouched = bool((buf[:, :col] == 0).all()
                     and (buf[:, col + width:] == 0).all())
    emit({"phase": "epilogue", "mode": mode, "case": name,
          "shape": list(tap.shape), "strides": list(tap.stride()),
          "out_column": col, "parts_differing": n_diff,
          "max_abs_diff": float(diff.max()), "rn_max_rel_err": rn_rel,
          "rn_repeatable": bool(torch.equal(rn, rn1))})
    check(n_diff == 0, f"epilogue {mode} {name}: {n_diff} parts differ")
    check(rn_rel <= 1e-6, f"epilogue {mode} {name}: rn off by {rn_rel:.3g}")
    check(bool(torch.equal(rn, rn1)),
          f"epilogue {mode} {name}: rn differs between two launches")
    check(untouched, f"epilogue {mode} {name}: wrote outside its slice")
    return float(diff.max())


# ---------------------------------------------------------------------------
# phase 5: the attack at full width
# ---------------------------------------------------------------------------

def make_images(rng, n: int, res: int = 64) -> np.ndarray:
    """Image-like uint8 NHWC: an 8x8 random layout upsampled, plus
    pixel noise."""
    base = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.int16)
    up = np.repeat(np.repeat(base, res // 8, axis=1), res // 8, axis=2)
    noise = rng.integers(-24, 25, up.shape, dtype=np.int16)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def pair_distances(torch, embed, queries, syn, idx, device,
                   chunk: int = 256):
    """float64 ||phi(q_i) - phi(syn[idx_i])||^2, rq and rs per row, from
    float32 embeddings, in chunks of ``chunk`` rows."""
    d, rq, rs = [], [], []
    with torch.inference_mode():
        for lo in range(0, len(queries), chunk):
            eq = embed(torch.from_numpy(queries[lo:lo + chunk])
                       .to(device)).double()
            es = embed(torch.from_numpy(syn[idx[lo:lo + chunk]])
                       .to(device)).double()
            d.append(((eq - es) ** 2).sum(1).cpu().numpy())
            rq.append((eq ** 2).sum(1).cpu().numpy())
            rs.append((es ** 2).sum(1).cpu().numpy())
    return np.concatenate(d), np.concatenate(rq), np.concatenate(rs)


BF16 = {"dtype": "bfloat16", "lpips_compute_dtype": "bfloat16"}
# (label, engine, two_pass, extra config), the float32 flat engines first
ATTACK_RUNS = [
    ("pallas", "pallas", False, {}),
    ("gemm", "gemm", False, {}),
    ("pallas_two_pass", "pallas", True, {}),
    ("taps", "taps", False, {}),
    ("taps_bf16", "taps", False, BF16),
    ("taps_int8", "taps-int8", False, {}),
    ("taps_int8_two_pass", "taps-int8", True, {}),
    ("auto", "auto", False, {}),
]
# phase 5b on the alex and squeeze towers: 'taps' (K1 on the 3xTF32 tile,
# float32) is the reference; 'gemm' is cuBLAS's float32 fold
TOWER_RUNS = [
    ("taps", "taps", False, {}),
    ("gemm", "gemm", False, {}),
    ("taps_bf16", "taps", False, BF16),
    ("auto", "auto", False, {}),
]
# which kernels each run launches, K1 (knn_argmin) and K3 (knn_topk) per
# tile — '.tf32x3' on float32, '.wgmma' on bf16 — and K2 (tap_epilogue);
# pass 1 of two-pass runs K3 on bf16 embeddings, the float32 re-rank and
# fallbacks run K1 on the 3xTF32 tile
WANT_LAUNCHES = {
    "pallas": ("knn_argmin.tf32x3",), "gemm": (),
    "pallas_two_pass": ("knn_topk.wgmma", "knn_argmin.tf32x3"),
    "taps": ("tap_epilogue", "knn_argmin.tf32x3"),
    "taps_bf16": ("tap_epilogue", "knn_argmin.wgmma"),
    "taps_int8": ("tap_epilogue",),
    "taps_int8_two_pass": ("tap_epilogue", "knn_argmin.tf32x3"),
    "auto": ("tap_epilogue",)}


def cert_error_bound(torch, cfg, rq, rs, quantized: bool):
    """The two-pass certificate's bound on |d_lo - d| per pair for a run
    on the bf16 tower: the bf16 eta (``_default_cert_eta``) plus, for int8
    parts, the quantisation error (``_quant_abs_err``) of the engine's
    static part bounds. Returns (bound, int8 abs err or 0)."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    from ganleaks_tpu_torch.ops.knn import _default_cert_eta, _quant_abs_err
    from ganleaks_tpu_torch.ops.lpips.backbones import tap_shapes
    abs_err = 0.0
    if quantized:
        embed = build_embed_fn(cfg, "cpu", structured=True)
        bounds = embed.part_bound_fn((RES, RES, 3))
        widths = [3 * RES * RES] + [
            h * w * c for h, w, c in tap_shapes(cfg.lpips_net,
                                                (RES, RES, 3))]
        abs_err = _quant_abs_err(tuple(bounds), [(w,) for w in widths])
    s = np.sqrt(rq) + np.sqrt(rs)
    a = _default_cert_eta(True) * s + 2.0 * abs_err
    return a * (2.0 * s + a), abs_err


def attack_data(tmp: str) -> dict:
    """The attack's sets, written as npz: 1,024 members, 1,024
    non-members and 8,192 synthetic images, members' noisy copies planted
    in the synthetic set."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pos = make_images(rng, N_POS, RES)
    neg = make_images(rng, N_POS, RES)
    syn = make_images(rng, N_SYN, RES)
    slots = rng.permutation(N_SYN)[:N_POS]  # members' noisy copies
    syn[slots] = np.clip(pos.astype(np.int16)
                         + rng.integers(-8, 9, pos.shape, dtype=np.int16),
                         0, 255).astype(np.uint8)
    paths = {}
    for name, arr in (("pos", pos), ("neg", neg), ("syn", syn)):
        paths[name] = os.path.join(tmp, f"{name}.npz")
        np.savez(paths[name], images=arr)
    return {"paths": paths, "syn": syn, "queries": np.concatenate([pos, neg]),
            "tmp": tmp, "data_s": time.perf_counter() - t0}


def attack_runs(torch, data: dict, net: str, run_list, ref: str):
    """``run_attack`` and ``evaluate`` on ``data`` with the l2-lpips
    distance on ``net``'s tower, once per entry of ``run_list``; every loss
    against the float64 distance of its pair, every run's indices against
    the ``ref`` run's (an exact float32 fold), every run's launches per
    kernel and tile. Returns (label -> run record, the float32 flat
    featuriser the float64 distances came from)."""
    from dataclasses import replace

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn, run_attack
    from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
    from ganleaks_tpu_torch.ops.lpips.backbones import tap_shapes

    n_pos = n_neg = N_POS
    n_syn = N_SYN
    k_dim = 3 * RES * RES + sum(h * w * c for h, w, c
                                in tap_shapes(net, (RES, RES, 3)))
    paths, syn, queries = data["paths"], data["syn"], data["queries"]
    base = dict(syn_data_path=paths["syn"], pos_data_dir=paths["pos"],
                neg_data_dir=paths["neg"], resolution=RES,
                distance="l2-lpips", lpips_net=net, dtype="float32",
                query_block=2048, syn_block=2048, two_pass_k=TOPK_K,
                save_plots=False, save_root=os.path.join(data["tmp"], "runs"))
    embed = build_embed_fn(AttackConfig(distance="l2-lpips", lpips_net=net,
                                        dtype="float32"), DEVICE)
    runs = {}
    for label, engine, two_pass, extra in run_list:
        cfg = AttackConfig(exp_name=f"smoke_{net}_{label}", engine=engine,
                           two_pass=two_pass, **{**base, **extra})
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = run_attack(cfg, DEVICE)[0]
        e2e = time.perf_counter() - t0
        launches = read_launches()
        ev = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
        with open(os.path.join(out["save_dir"], "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        resolved = [r for r in records if "engine_resolved" in r]
        idx = np.concatenate([out["pos_nn_idx"], out["neg_nn_idx"]])
        loss = np.concatenate([out["pos_loss"], out["neg_loss"]])
        d64, rq, rs = pair_distances(torch, embed, queries, syn, idx,
                                     DEVICE)
        runs[label] = r = {
            "out": out, "auc": ev["auc"], "launches": launches,
            "idx": idx, "loss": loss, "d64": d64, "norms": rq + rs,
            "err": float((np.abs(loss - d64) / (rq + rs)).max()),
            "engine_resolved": resolved[0]["engine_resolved"]
            if resolved else None, "cfg": cfg}
        # single-pass runs on bf16 embeddings or int8 parts: held to the
        # certificate's error model (bf16 eta, + the int8 term for int8)
        if (engine in ("taps-int8", "auto") or extra) and not two_pass:
            run_cfg = cfg if engine != "auto" else replace(
                cfg, engine="taps-int8", **BF16)
            r["eps"], r["abs_err"] = cert_error_bound(
                torch, run_cfg, rq, rs, run_cfg.engine == "taps-int8")
        emit({"phase": "attack", "net": net, "run": label, "engine": engine,
              "two_pass": two_pass, "engine_resolved": r["engine_resolved"],
              "n_pos": n_pos, "n_neg": n_neg, "n_syn": n_syn, "k": k_dim,
              "auroc": ev["auc"], "ap": ev["ap"],
              "kernel_launches": launches,
              "two_pass_fallbacks": out.get("two_pass_fallbacks"),
              "loss_err_over_norms": r["err"],
              "featurize_s": out["featurize_s"], "fold_s": out["fold_s"],
              "end_to_end_s": e2e,
              "query_pairs_per_sec": out["query_pairs_per_sec"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
              if DEVICE == "cuda" else None,
              "data_gen_s": data["data_s"]})

    p = runs[ref]
    for key in ("pos_loss", "neg_loss"):
        check(p["out"][key].shape == (n_pos,)
              and bool(np.isfinite(p["out"][key]).all()),
              f"{net} {key}: not {n_pos} finite values")
    check(p["auc"] > 0.9, f"{net}: AUROC {p['auc']:.4f} <= 0.9 with planted "
                          f"member copies")
    check(p["err"] <= TOL, f"{net} {ref}: losses off their float64 "
                           f"distances by {p['err']:.3g} x (rq + rs)")
    for label, r in runs.items():
        for name, n in r["launches"].items():
            if name in WANT_LAUNCHES[label]:
                check(n > 0, f"{net} {label}: {name} never launched")
            else:
                check(n == 0, f"{net} {label}: {name} launched {n} times")
    check(runs["auto"]["engine_resolved"] == "taps-int8",
          f"{net}: engine='auto' resolved to "
          f"{runs['auto']['engine_resolved']}")
    summary = {}
    for label, r in runs.items():
        if label == ref:
            continue
        int8 = "eps" in r  # bf16 or int8 single pass: bounded, not exact
        # an engine whose distance to a row is off by at most e can only
        # pick a row whose float64 distance lies within 2 e of the best,
        # so two engines may disagree only between such near-ties
        mm = r["idx"] != p["idx"]
        if int8:  # each pick's distance is off by at most its eps
            near = 2.0 * r["eps"] + 2.0 * max(TOL, p["err"]) * p["norms"]
        else:
            near = 2.0 * max(TOL, p["err"], r["err"]) * np.maximum(
                p["norms"], r["norms"])
        gap = np.abs(r["d64"] - p["d64"])
        check(bool((gap[mm] <= near[mm]).all()),
              f"{net} {label}: {int(mm.sum())} index mismatches with the "
              f"float32 {ref} run, not all near-ties")
        if int8:  # the certificate's own error model
            check(bool((np.abs(r["loss"] - r["d64"]) <= r["eps"]).all()),
                  f"{net} {label}: losses outside the certificate bound")
            check(r["auc"] > 0.9, f"{net} {label}: AUROC {r['auc']:.4f}")
        elif label != "gemm":  # exact float32 results
            check(r["err"] <= TOL, f"{net} {label}: losses off float64 by "
                                   f"{r['err']:.3g} x (rq + rs)")
        if label == "gemm" or not int8:
            check(abs(r["auc"] - p["auc"]) <= 1e-6,
                  f"{net}: AUROC {label} {r['auc']} vs {ref} {p['auc']}")
        summary[label] = {
            "index_mismatches": int(mm.sum()), "auroc": r["auc"],
            "loss_err_over_norms": r["err"],
            "two_pass_fallbacks": r["out"].get("two_pass_fallbacks")}
        if int8:
            summary[label]["abs_err"] = r["abs_err"]
            summary[label]["max_err_over_bound"] = float(
                (np.abs(r["loss"] - r["d64"]) / r["eps"]).max())
    emit({"phase": "attack_check", "net": net, "reference": ref,
          f"auroc_{ref}": p["auc"], f"loss_err_over_norms_{ref}": p["err"],
          "runs": summary})
    return runs, embed


def phase_attack(torch, data: dict) -> tuple[dict, dict]:
    """Phase 5: VGG16 through every engine, then the float32 top-k
    search; returns each run's launches and each run's record."""
    runs, embed = attack_runs(torch, data, "vgg", ATTACK_RUNS, "pallas")
    launches = {label: r["launches"] for label, r in runs.items()}
    launches["topk_f32"] = topk_search(torch, embed, data["queries"],
                                       data["syn"], runs["pallas"])
    return launches, runs


def phase_attack_towers(torch, data: dict) -> dict:
    """Phase 5b: the alex and squeeze towers on the same sets; returns
    net -> label -> launches."""
    out = {}
    for net in ("alex", "squeeze"):
        runs, _ = attack_runs(torch, data, net, TOWER_RUNS, "taps")
        out[net] = {label: r["launches"] for label, r in runs.items()}
    return out


def topk_search(torch, embed, queries, syn, p) -> dict:
    """The float32 top-k search through the port's entry point
    (``knn_topk_streamed``, engine 'pallas', which folds every block with
    K3 on the 3xTF32 tile) on the attack's arrays: each query's list
    ascending, its first entry the 'pallas' run's nearest row (or a
    near-tie of it) at that row's float64 distance within TOL. Returns the
    launches of the search."""
    from ganleaks_tpu_torch.ops.knn import knn_topk_streamed
    reset_launches()
    t0 = time.perf_counter()
    d, i = knn_topk_streamed(embed, queries, syn, k=TOPK_K, engine="pallas",
                             device=DEVICE)
    d, i = d.cpu().numpy().astype(np.float64), i.cpu().numpy()
    secs = time.perf_counter() - t0
    launches = read_launches()
    want = {name: int(name == "knn_topk.tf32x3") for name in launches}
    for name, n in launches.items():
        check((n > 0) == bool(want[name]),
              f"topk_f32: {name} launched {n} times")
    check(d.shape == (len(queries), TOPK_K) and bool(np.isfinite(d).all()),
          f"topk_f32: not {len(queries)} x {TOPK_K} finite distances")
    check(bool((np.diff(d, axis=1) >= 0).all()), "topk_f32: not ascending")
    same = i[:, 0] == p["idx"]
    near = 2.0 * max(TOL, p["err"]) * p["norms"]
    check(bool((np.abs(d[~same, 0] - p["d64"][~same]) <= near[~same]).all()),
          f"topk_f32: {int((~same).sum())} nearest rows differ from the "
          f"pallas run's, not all near-ties")
    err = float((np.abs(d[same, 0] - p["d64"][same])
                 / p["norms"][same]).max())
    check(err <= TOL, f"topk_f32: d off float64 by {err:.3g} x (rq + rs)")
    emit({"phase": "attack", "run": "topk_f32", "entry": "knn_topk_streamed",
          "engine": "pallas", "k": TOPK_K, "kernel_launches": launches,
          "nearest_mismatches": int((~same).sum()),
          "loss_err_over_norms": err, "end_to_end_s": secs})
    return launches


# ---------------------------------------------------------------------------
# phase 6: timing at the attack's block shapes
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 10) -> float:
    """Like ``time_ms``, but the launches are queued behind a ~10 ms spin
    of the card (``torch.cuda._sleep``), so the host is far ahead when
    they run and the events time the device alone, not the wrapper's
    host time between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound(flops: float, peak_flops: float, nbytes: float) -> dict:
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def float32_bounds(flops: float, nbytes: float, ms: float) -> dict:
    """The float32 route's bounds: ``bound_ms``, the 3xTF32 tile's (three
    TF32 products per multiply-add at the tensor cores' TF32 peak), and
    ``ffma_bound_ms``, any design's on the float32 CUDA cores; each with
    the share of it that ``ms`` reached."""
    tc = bound(TF32X3_PRODUCTS * flops, PEAK_TF32_FLOPS, nbytes)
    cc = bound(flops, PEAK_FP32_FLOPS, nbytes)
    return {**tc, "bound_share": tc["bound_ms"] / ms,
            "ffma_bound_ms": cc["bound_ms"],
            "ffma_bound_share": cc["bound_ms"] / ms}


def kernel_bounds(dtype, flops: float, nbytes: float, ms: float) -> dict:
    """bf16: the bf16 tensor cores' bound (a bf16 product is exact in
    float32, so they could do the same math); float32: both bounds."""
    if dtype_name(dtype) == "float32":
        return float32_bounds(flops, nbytes, ms)
    out = bound(flops, PEAK_BF16_FLOPS, nbytes)
    return {**out, "bound_share": out["bound_ms"] / ms}


def kernel_reps(dtype) -> int:
    """Timed launches per K1/K3 measurement: more for the ~10 ms bf16 runs
    than for the slower float32 ones."""
    return 3 if dtype_name(dtype) == "float32" else 10


def timing_k1(torch, dtype) -> dict:
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_argmin_plain, route)
    n_q = n_s = 2048
    k_dim = 512000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # no planted near-copy here: its q.s sums 512,000 products >= 0, and at
    # this shape cuBLAS keeps one running float32 sum per output, which
    # drifts past TOL (phase 5 measures that against float64); phase 2
    # holds the ties at K = 512,000, a shape where the plain version stays
    # within TOL
    q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, dtype, [], gen)
    held = hold_against_plain(torch, f"main_block_{dtype_name(dtype)}", q,
                              s, rq, rs, [])
    emit({"phase": "kernel", **held})

    def library():  # one composition of PyTorch calls, timed only
        return torch.min(torch.addmm(rs[None, :].to(q.dtype), q, s.T,
                                     alpha=-2.0).float() + rq[:, None],
                         dim=1)

    reps = kernel_reps(dtype)
    ms = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs), reps)
    plain_ms = time_ms(torch, lambda: knn_argmin_plain(q, s, rq, rs))
    library_ms = time_ms(torch, library, reps)
    ms2 = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs), reps)
    flops = 2.0 * n_q * n_s * k_dim
    nbytes = (n_q + n_s) * k_dim * q.element_size() + (n_q + n_s) * 4 \
        + n_q * 8
    res = {"kernel": "knn_argmin", "tile": route(dtype), "n_q": n_q,
           "n_s": n_s, "k": k_dim, "dtype": dtype_name(dtype),
           "ms": min(ms, ms2),
           "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": library_ms, "max_abs_err": held["max_abs_err"],
           **kernel_bounds(dtype, flops, nbytes, min(ms, ms2)),
           "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12,
           **one_tile_ms(torch, lambda a, b, ra, rb: knn_argmin_fused(
               a, b, rq=ra, rs=rb), q, s, rq, rs, reps)}
    emit({"phase": "timing", **res})
    del q, s
    return res


def one_tile_ms(torch, fn, q, s, rq, rs, reps) -> dict:
    """The same call on the first 128 queries only (one query tile, a
    sixteenth of the blocks) beside the full block: the work each block
    does per second in both shows what the full grid's shared traffic (L2
    and device memory) costs a block."""
    from ganleaks_tpu_torch.ops.knn_fused import launch_plan
    n = 128
    ms = time_ms(torch, lambda: fn(q[:n], s, rq[:n], rs), reps)
    ms_full = time_ms(torch, lambda: fn(q, s, rq, rs), reps)
    out = {}
    for name, rows, t in (("one_query_tile", n, ms),
                          ("full", q.shape[0], ms_full)):
        tps, n_splits = launch_plan(q[:rows], s.shape[0])
        blocks = -(-rows // 128) * n_splits
        flops = 2.0 * rows * s.shape[0] * q.shape[1]
        out[f"{name}_ms"] = t
        out[f"{name}_blocks"] = blocks
        out[f"{name}_tiles_per_block"] = tps
        out[f"{name}_tflops_per_block"] = flops / blocks / (t * 1e-3) / 1e12
    return out


def timing_k3(torch, dtype) -> dict:
    from ganleaks_tpu_torch.ops.knn_fused import (knn_topk_fused,
                                                  knn_topk_plain, route)
    n_q = n_s = 2048
    k_dim = 512000
    k = TOPK_K
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, dtype, [], gen)
    held = hold_topk(torch, f"main_block_{dtype_name(dtype)}", q, s, rq, rs,
                     k, [])
    emit({"phase": "topk", **held})

    def library():  # one composition of PyTorch calls, timed only
        dist = (torch.addmm(rs[None, :].to(q.dtype), q, s.T, alpha=-2.0)
                .float() + rq[:, None])
        return torch.topk(dist, k, dim=1, largest=False)

    reps = kernel_reps(dtype)
    ms = time_ms(torch, lambda: knn_topk_fused(q, s, k, rq=rq, rs=rs), reps)
    plain_ms = time_ms(torch, lambda: knn_topk_plain(q, s, k, rq, rs))
    library_ms = time_ms(torch, library, reps)
    ms2 = time_ms(torch, lambda: knn_topk_fused(q, s, k, rq=rq, rs=rs), reps)
    flops = 2.0 * n_q * n_s * k_dim
    elt = q.element_size()
    nbytes = (n_q + n_s) * k_dim * elt + (n_q + n_s) * 4 + n_q * k * 8
    res = {"kernel": "knn_topk", "tile": route(dtype), "n_q": n_q,
           "n_s": n_s, "k_dim": k_dim,
           "k": k, "dtype": dtype_name(dtype), "ms": min(ms, ms2),
           "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": library_ms, "max_abs_err": held["max_abs_err"],
           **kernel_bounds(dtype, flops, nbytes, min(ms, ms2)),
           "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12,
           **one_tile_ms(torch, lambda a, b, ra, rb: knn_topk_fused(
               a, b, k, rq=ra, rs=rb), q, s, rq, rs, reps)}
    emit({"phase": "timing", **res})
    del q, s
    return res


def timing_k2(torch, mode: str, net: str = "vgg") -> dict:
    """K2 per tap and summed over the taps of ``net``'s tower for one
    2,048-image block, in one of ``epilogue_modes``; no single PyTorch
    call computes it."""
    from ganleaks_tpu_torch.ops.lpips import (default_lpips_params,
                                              lpips_part_bounds)
    from ganleaks_tpu_torch.ops.lpips.epilogue import (tap_epilogue,
                                                       tap_epilogue_plain)
    tdt, edt, odt, quant = epilogue_modes(torch)[mode]
    model = default_lpips_params(net).to("cuda").eval()
    bounds = lpips_part_bounds(model, (RES, RES, 3))
    x = torch.from_numpy(make_images(np.random.default_rng(SEED + 5),
                                     2 * N_POS, RES)).to("cuda")
    taps_ms, dev_ms, plain_ms, bound_ms = [], [], [], []
    ops, nbytes, err = 0.0, 0.0, 0.0
    with torch.inference_mode():
        taps = tower_taps(torch, model, x, tdt)
        for i, (fl, sc) in enumerate(taps):
            kw = dict(embed_dtype=edt, out_dtype=odt,
                      quant_bound=bounds[i] if quant else None)
            part, _ = tap_epilogue(fl, sc, **kw)
            want, _ = tap_epilogue_plain(fl, sc, **kw)
            err = max(err, float((part.float() - want.float()).abs().max()))
            del part, want
            t = time_ms(torch, lambda: tap_epilogue(fl, sc, **kw), reps=10)
            tp = time_ms(torch, lambda: tap_epilogue_plain(fl, sc, **kw))
            t2 = time_ms(torch, lambda: tap_epilogue(fl, sc, **kw), reps=10)
            td = device_ms(torch, lambda: tap_epilogue(fl, sc, **kw))
            n, h, w, c = fl.shape
            elems = n * h * w * c
            out_elt = 1 if quant else torch.empty((), dtype=odt).element_size()
            b = elems * (fl.element_size() + out_elt) + n * 4 + c * 4
            # per element: square, add, divide, scale, b*b, add (+ the
            # quantising multiply): float32 work on the CUDA cores
            f = elems * (7 if quant else 6)
            taps_ms.append(min(t, t2))
            dev_ms.append(td)
            plain_ms.append(tp)
            bound_ms.append(bound(f, PEAK_FP32_FLOPS, b)["bound_ms"])
            ops += f
            nbytes += b
            emit({"phase": "timing", "kernel": "tap_epilogue", "net": net,
                  "mode": mode, "tap": i, "shape": [n, h, w, c],
                  "ms": min(t, t2),
                  "ms_runs": [t, t2], "device_ms": td, "plain_ms": tp,
                  "bound_ms": bound_ms[-1], "gb": b / 1e9,
                  "gb_per_s": b / (min(t, t2) * 1e-3) / 1e9,
                  "bound_share": bound_ms[-1] / min(t, t2)})
    res = {"kernel": "tap_epilogue", "net": net, "mode": mode,
           "n_images": 2 * N_POS,
           "ms": sum(taps_ms), "plain_ms": sum(plain_ms),
           "library_ms": None, "max_abs_err": err,
           **bound(ops, PEAK_FP32_FLOPS, nbytes), "gb": nbytes / 1e9,
           "gb_per_s": nbytes / (sum(taps_ms) * 1e-3) / 1e9,
           "per_tap_ms": taps_ms, "device_ms": sum(dev_ms),
           "per_tap_device_ms": dev_ms}
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["device_bound_share"] = res["bound_ms"] / res["device_ms"]
    emit({"phase": "timing", "summed_over_taps": True, **res})
    return res


# ---------------------------------------------------------------------------
# phase 6b: 2AFC/JND scores and the lin-head trainer
# ---------------------------------------------------------------------------

SCORE_MODELS = (("net-lin", "vgg"), ("net-lin", "alex"),
                ("net-lin", "squeeze"), ("net", "resnet"))


def score_triplets(rng, n: int) -> dict:
    """2AFC triplets in [-1, 1]: reference images and two noisy copies at
    per-triplet noise levels; judge 1 where p1 is the cleaner copy (0.5 on
    equal levels), 'same' where a copy's noise is at most 8 levels."""
    ref = make_images(rng, n, RES)
    amp = {k: rng.integers(2, 40, n) for k in ("p0", "p1")}
    out = {"ref": (ref / 127.5 - 1.0).astype(np.float32)}
    for k, a in amp.items():
        a4 = a[:, None, None, None]
        img = np.clip(ref.astype(np.int16)
                      + rng.integers(-a4, a4 + 1, ref.shape), 0, 255)
        out[k] = (img / 127.5 - 1.0).astype(np.float32)
    out["judge"] = np.where(amp["p1"] < amp["p0"], 1.0,
                            np.where(amp["p1"] == amp["p0"], 0.5, 0.0))
    out["same"] = {k: (a <= 8).astype(np.float64) for k, a in amp.items()}
    return out


def phase_scores(torch) -> dict:
    """``make_pair_dist_fn`` on the card for 'net-lin' x vgg/alex/squeeze
    and 'net' x resnet on SCORES_N triplets (2AFC and JND scores), the
    first SCORES_CHECK held against the same tower on the CPU in float64;
    'l2' and 'ssim' on the host."""
    from ganleaks_tpu_torch.ops.lpips import (default_lpips_params,
                                              lpips_pair, pnet_pair)
    from ganleaks_tpu_torch.ops.lpips.scoring import (make_pair_dist_fn,
                                                      score_2afc, score_jnd)
    t = score_triplets(np.random.default_rng(SEED + 7), SCORES_N)
    c = SCORES_CHECK
    out = {}
    for model, net in SCORE_MODELS + (("l2", None), ("ssim", None)):
        dist = make_pair_dist_fn(model, net=net or "vgg",
                                 device=DEVICE if net else None)
        n = SCORES_N if model != "ssim" else SCORES_SSIM
        t0 = time.perf_counter()
        d0, d1 = (np.concatenate([dist(t["ref"][i:min(i + SCORES_BATCH, n)],
                                       t[k][i:min(i + SCORES_BATCH, n)])
                                  for i in range(0, n, SCORES_BATCH)])
                  for k in ("p0", "p1"))
        secs = time.perf_counter() - t0
        check(d0.shape == d1.shape == (n,) and bool(np.isfinite(d0).all())
              and bool(np.isfinite(d1).all()),
              f"scores {model} {net}: not {n} finite distance pairs")
        rec = {"phase": "scores", "model": model, "net": net, "n": n,
               "device": DEVICE if net else "host", "seconds": secs,
               "pairs_per_s": 2 * n / secs,
               "score_2afc": score_2afc(d0, d1, t["judge"][:n]),
               "score_jnd": score_jnd(np.concatenate([d0, d1]),
                                      np.concatenate([t["same"]["p0"][:n],
                                                      t["same"]["p1"][:n]]))}
        if net:  # the same tower on the CPU in float64
            fn = lpips_pair if model == "net-lin" else pnet_pair
            m64 = default_lpips_params(net).double().eval()
            with torch.no_grad():
                r64 = torch.from_numpy(t["ref"][:c]).double()
                w = np.concatenate([
                    fn(m64, r64, torch.from_numpy(t[k][:c]).double())
                    .numpy() for k in ("p0", "p1")])
            got = np.concatenate([d0[:c], d1[:c]])
            err = np.abs(got - w)
            # float32 on the card: rtol 1e-4, plus 1e-6 absolute for the
            # cosine distance's 1 - cos cancellation on near copies
            rec["max_rel_err_f64"] = float((err / np.abs(w)).max())
            rec["max_abs_err_f64"] = float(err.max())
            check(bool((err <= 1e-4 * np.abs(w) + 1e-6).all()),
                  f"scores {model} {net}: off the CPU float64 distances by "
                  f"{float((err / np.abs(w)).max()):.3g} relative")
        out[f"{model}_{net}" if net else model] = rec
        emit(rec)
    return out


def phase_train(torch) -> dict:
    """TRAIN_STEPS steps of ``train_2afc`` (one batch of TRAIN_BATCH
    triplets per epoch, the alex tower's lin heads and the rank net) on
    the card in float32 and on the CPU in float64, with the dropout masks
    drawn from one seeded CPU generator in both: every step's loss within
    rtol 1e-4, lin heads >= 0, and the trained lin heads and rank net
    within TRAIN_ATOL of the float64 run's (every step's update and clamp
    shows there; each group moved by more than 100 TRAIN_ATOL)."""
    from ganleaks_tpu_torch.ops.lpips import default_lpips_params
    from ganleaks_tpu_torch.ops.lpips.train2afc import Dist2Logit, train_2afc
    t = score_triplets(np.random.default_rng(SEED + 8), TRAIN_BATCH)
    batch = {k: t[k] for k in ("ref", "p0", "p1", "judge")}
    hist, params = {}, {}

    def groups(model, rank) -> dict:
        out = {"lins": torch.cat([w.reshape(-1) for w in model.lins])}
        out["rank"] = torch.cat([q.reshape(-1) for q in rank.parameters()])
        return {k: v.detach().cpu().double().numpy() for k, v in out.items()}

    for dev, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
        key = dtype_name(dtype)
        model = default_lpips_params("alex").to(device=dev, dtype=dtype)
        rank = Dist2Logit(seed=SEED).to(device=dev, dtype=dtype)
        init = groups(model, rank)
        npdt = np.float64 if dtype == torch.float64 else np.float32
        b = {k: v.astype(npdt) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, _, hist[key] = train_2afc(
            model.eval(), [b], epochs=TRAIN_STEPS, decay_epochs=0,
            lr=TRAIN_LR, rank=rank,
            generator=torch.Generator().manual_seed(SEED))
        secs = time.perf_counter() - t0
        params[key] = groups(model, rank)
        moved = {k: float(np.abs(params[key][k] - init[k]).max())
                 for k in init}
        lins_min = min(float(w.min()) for w in model.lins)
        check(lins_min >= 0.0, f"train {dev}: a lin head went below 0")
        check(min(moved.values()) > 100 * TRAIN_ATOL,
              f"train {dev}: the steps barely moved the weights: {moved}")
        emit({"phase": "train", "device": dev, "dtype": dtype_name(dtype),
              "net": "alex", "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
              "lr": TRAIN_LR, "losses": [h["loss"] for h in hist[key]],
              "acc": [h["acc"] for h in hist[key]], "seconds": secs,
              "lins_min": lins_min, "max_moved": moved})
    card = np.array([h["loss"] for h in hist["float32"]])
    ref = np.array([h["loss"] for h in hist["float64"]])
    rel = float((np.abs(card - ref) / np.abs(ref)).max())
    check(card.shape == (TRAIN_STEPS,) and rel <= 1e-4,
          f"train: losses {card.tolist()} off float64 {ref.tolist()} by "
          f"{rel:.3g} relative")
    param_err = {k: float(np.abs(params["float32"][k]
                                 - params["float64"][k]).max())
                 for k in params["float64"]}
    for k, err in param_err.items():
        check(err <= TRAIN_ATOL,
              f"train: trained {k} off float64 by {err:.3g} "
              f"(limit {TRAIN_ATOL:g})")
    emit({"phase": "train_check", "loss_max_rel_err_f64": rel,
          "param_max_abs_err_f64": param_err})
    return {"loss_max_rel_err_f64": rel, "param_max_abs_err_f64": param_err}


# ---------------------------------------------------------------------------
# phase 7: FID at full width
# ---------------------------------------------------------------------------

def noisy_copies(rng, images: np.ndarray, amp: int) -> np.ndarray:
    noise = rng.integers(-amp, amp + 1, images.shape, dtype=np.int16)
    return np.clip(images.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def calibrate_batchnorm(torch, model, images: np.ndarray) -> None:
    """Give the surrogate tower the BatchNorm statistics a trained one
    holds: each BN's running mean and variance become those of its input
    over ``images`` (one forward pass, so every layer sees inputs already
    normalised). At mean 0 and var 1 every input after the first ReLU is
    non-negative, so whole channels stay below zero for every image: pool_3
    features that never vary, and covariances singular whatever the set
    size."""
    from ganleaks_tpu_torch.ops.inception import BasicConv2d, preprocess

    def hook(bn):
        def set_stats(_mod, _inp, out):
            bn.running_mean.copy_(out.mean((0, 2, 3)))
            bn.running_var.copy_(out.var((0, 2, 3)))
        return set_stats
    handles = [blk.conv.register_forward_hook(hook(blk.bn))
               for blk in model.modules() if isinstance(blk, BasicConv2d)]
    model.to(DEVICE).eval()
    with torch.no_grad():
        model(preprocess(torch.from_numpy(images).to(DEVICE)))
    for h in handles:
        h.remove()


def tower_error(torch, model, images: np.ndarray) -> float:
    """Largest gap, over the largest activation, between the card's pool_3
    activations of ``images`` through ``get_activations`` and the same
    module's on the CPU in float64."""
    import copy

    import torch.nn.functional as F

    from ganleaks_tpu_torch.ops import fid
    got = fid.get_activations(model, images, len(images), device=DEVICE)
    x64 = torch.from_numpy(images).double().permute(0, 3, 1, 2)
    x64 = F.interpolate(x64 / 255.0, size=(299, 299), mode="bilinear",
                        align_corners=False, antialias=False) * 2.0 - 1.0
    with torch.inference_mode():
        want = copy.deepcopy(model).cpu().double()(x64).numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_fid(torch) -> dict:
    from ganleaks_tpu_torch.ops import fid
    rng = np.random.default_rng(SEED + 7)
    members = make_images(rng, FID_N, RES)
    copies = noisy_copies(rng, members, FID_NOISE)
    model = fid.init_inception_params(SEED)
    # the surrogate as drawn: its features barely vary, so float32 rounding
    # barely moves them
    drawn = tower_error(torch, model, members[:8])
    calibrate_batchnorm(torch, model, make_images(rng, FID_CALIB, RES))
    # calibrated, every feature follows its input, and float32's rounding
    # of it: a looser bar
    calibrated = tower_error(torch, model, members[:8])
    fid.frechet_distance.scipy_fallbacks = 0
    reset_launches()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts1 = fid.get_activations(model, members, FID_BATCH, device=DEVICE)
    acts2 = fid.get_activations(model, copies, FID_BATCH, device=DEVICE)
    act_s = time.perf_counter() - t0
    launches = read_launches()
    check(acts1.shape == (FID_N, 2048) and bool(np.isfinite(acts1).all())
          and bool(np.isfinite(acts2).all()),
          f"fid: activations {acts1.shape}, not {FID_N} x 2048 finite")

    m1, s1 = fid.activation_statistics(acts1)
    m2, s2 = fid.activation_statistics(acts2)
    values, secs, fallbacks = {}, {}, {}
    for method in ("newton-schulz", "eigh", "scipy"):
        before = fid.frechet_distance.scipy_fallbacks
        t0 = time.perf_counter()
        values[method] = fid.frechet_distance(m1, s1, m2, s2, method=method,
                                              device=DEVICE)
        secs[method] = time.perf_counter() - t0
        fallbacks[method] = fid.frechet_distance.scipy_fallbacks - before
    before = fid.frechet_distance.scipy_fallbacks
    self_fid = fid.frechet_distance(m1, s1, m1, s1, method="newton-schulz",
                                    device=DEVICE)
    fallbacks["self"] = fid.frechet_distance.scipy_fallbacks - before
    # the spread of eigenvalues the square roots work on
    w = np.linalg.eigvalsh(s1)
    res = {"phase": "fid", "n_images": [FID_N, FID_N], "batch": FID_BATCH,
           "copy_noise": FID_NOISE, "activation_s": act_s,
           "images_per_sec": 2 * FID_N / act_s,
           "act_max_rel_err_vs_cpu_f64": drawn,
           "calibrated_act_max_rel_err_vs_cpu_f64": calibrated,
           "constant_features": int(((np.diag(s1) == 0)
                                     & (np.diag(s2) == 0)).sum()),
           "fid": values,
           "sqrtm_s": secs, "scipy_fallbacks": fallbacks,
           "fid_self_newton_schulz": self_fid,
           "trace_sigma": [float(np.trace(s1)), float(np.trace(s2))],
           "sigma1_eigenvalues": {"max": float(w[-1]), "min": float(w[0]),
                                  "below_1e-6_of_max":
                                      int((w < 1e-6 * w[-1]).sum())},
           "kernel_launches": launches}
    emit(res)
    check(drawn <= 1e-4, f"fid: activations off float64 by {drawn:.3g} "
                         f"of their max")
    check(calibrated <= 1e-3, f"fid: calibrated activations off float64 by "
                              f"{calibrated:.3g} of their max")
    want = values["scipy"]
    check(np.isfinite(want), "fid: scipy FID is not finite")
    for method in ("newton-schulz", "eigh"):
        # tests/test_fid_split.py's bar: rtol 1e-3, atol 1e-3
        err = abs(values[method] - want)
        check(err <= 1e-3 + 1e-3 * abs(want),
              f"fid: {method} {values[method]} vs scipy {want} "
              f"(off by {err:.3g})")
        check(fallbacks[method] == 0,
              f"fid: {method} fell back to scipy on full-rank statistics")
    # with S1 = S2 the eps offset (z_fid.py's eps, kept on the device path)
    # makes the trace exactly Tr(S1) + eps * n: a set's FID against itself
    # is -2 eps n, -0.0041 at 2048 features
    want_self = -2.0 * 1e-6 * len(m1)
    check(abs(self_fid - want_self) <= 1e-3,
          f"fid: FID of a set against itself {self_fid}, not {want_self}")
    return res


# ---------------------------------------------------------------------------
# phase 8: the VAE-GAN reconstruction attack at full width
# ---------------------------------------------------------------------------

def seeded_vaegan(torch, seed: int):
    """Encoder and Generator (z_dim 100, d 64) with every weight drawn from
    a ``torch.Generator``: conv and linear weights and biases uniform in
    +-1/sqrt(fan_in), BatchNorm scale N(1, 0.02), bias N(0, 0.02), running
    mean N(0, 0.1) and var U(0.5, 1.5), spectral vectors unit normal draws,
    the self-attention gamma 0.5 (nonzero, so the attention path counts)."""
    from ganleaks_tpu_torch.models.vaegan import Encoder, Generator
    from ganleaks_tpu_torch.ops.nn import (BatchNormTorch, SelfAttention,
                                           SNConvTranspose2d, l2normalize)
    g = torch.Generator().manual_seed(seed)
    models = (Encoder(100, 64), Generator(100, 64))
    with torch.no_grad():
        for model in models:
            for mod in model.modules():
                if isinstance(mod, BatchNormTorch):
                    mod.weight.normal_(1.0, 0.02, generator=g)
                    mod.bias.normal_(0.0, 0.02, generator=g)
                    mod.running_mean.normal_(0.0, 0.1, generator=g)
                    mod.running_var.uniform_(0.5, 1.5, generator=g)
                elif isinstance(mod, SelfAttention):
                    mod.gamma.fill_(0.5)
                elif hasattr(mod, "weight") and mod.weight is not None:
                    # torch's default fan_in: weight[0] is (in, k, k) of a
                    # conv, (out, k, k) of a transposed conv, (in,) of a
                    # linear layer
                    bound = 1.0 / mod.weight[0].numel() ** 0.5
                    mod.weight.uniform_(-bound, bound, generator=g)
                    mod.bias.uniform_(-bound, bound, generator=g)
                if isinstance(mod, SNConvTranspose2d):
                    mod.u.copy_(l2normalize(torch.randn(mod.u.shape,
                                                        generator=g)))
                    mod.v.copy_(l2normalize(torch.randn(mod.v.shape,
                                                        generator=g)))
    return tuple(m.eval() for m in models)


def phase_reconstruction(torch, tmp: str) -> dict:
    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.reconstruction import (
        batch_generator, run_reconstruction_attack)
    from ganleaks_tpu_torch.config import EvalConfig, ReconstructionConfig
    from ganleaks_tpu_torch.io.npz import load_npz_images
    from ganleaks_tpu_torch.ops.distance import l2_pair
    from ganleaks_tpu_torch.ops.lpips import default_lpips_params, lpips_pair
    from ganleaks_tpu_torch.utils.checkpoint import (load_variables,
                                                     save_params_npz)
    from ganleaks_tpu_torch.weights import (dump_jax_tree,
                                            vaegan_from_jax_variables)
    enc, gen = seeded_vaegan(torch, SEED + 8)
    paths = {}
    for name, model in (("netE", enc), ("netG", gen)):
        paths[name] = os.path.join(tmp, f"{name}.npz")
        save_params_npz(paths[name], dump_jax_tree(model))
    rng = np.random.default_rng(SEED + 8)
    pos = make_images(rng, RECON_N, RES)
    for name, arr in (("pos", pos), ("neg", make_images(rng, RECON_N, RES))):
        paths[name] = os.path.join(tmp, f"recon_{name}.npz")
        np.savez(paths[name], images=arr)
    cfg = ReconstructionConfig(
        exp_name="smoke_recon", pos_data_dir=paths["pos"],
        neg_data_dir=paths["neg"], netE=paths["netE"], netG=paths["netG"],
        z_dim=100, d=64, distance="l2-lpips", batch=RECON_BATCH,
        save_plots=False, seed=SEED, save_root=os.path.join(tmp, "runs"))
    reset_launches()
    t0 = time.perf_counter()
    out = run_reconstruction_attack(cfg, DEVICE)
    e2e = time.perf_counter() - t0
    launches = read_launches()
    ev = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    for name in ("pos", "neg"):
        loss = np.load(os.path.join(out["save_dir"], f"{name}_loss.npy"))
        idx = np.load(os.path.join(out["save_dir"], f"{name}_idx.npy"))
        check(loss.shape == (RECON_N, 1) and loss.dtype == np.float64
              and bool(np.isfinite(loss).all()) and bool((loss > 0).all()),
              f"recon: {name}_loss not {RECON_N} finite positive float64")
        check(bool((idx.ravel() == np.arange(RECON_N)).all()),
              f"recon: {name}_idx is not the sequential counter")

    # the first queries of the first batch on the CPU in float64, the same
    # eps (the batch's draw on the card from its generator, as the encoder
    # makes it, cut to those rows)
    t0 = time.perf_counter()
    x = torch.from_numpy(load_npz_images(paths["pos"], RES,
                                         limit=RECON_CHECK)).double()
    enc64, gen64 = (vaegan_from_jax_variables(
        kind, load_variables(paths[name])).double()
        for kind, name in (("encoder", "netE"), ("generator", "netG")))
    eps = torch.randn((RECON_BATCH, 100),
                      generator=batch_generator(SEED, 0, 0, DEVICE),
                      device=DEVICE)[:RECON_CHECK].cpu().double()
    lp64 = default_lpips_params().double().eval()
    with torch.inference_mode():
        mu, logvar = enc64.encode(x.permute(0, 3, 1, 2))
        rec = gen64(eps * torch.exp(logvar) + mu).permute(0, 2, 3, 1)
        want = (l2_pair(rec, x) + 0.2 * lpips_pair(lp64, rec, x)).numpy()
    ref_s = time.perf_counter() - t0
    got = out["pos_loss"][:RECON_CHECK].astype(np.float64)
    check(got.shape == want.shape, f"recon: losses {got.shape} against "
                                   f"the reference's {want.shape}")
    rel = float((np.abs(got - want) / np.abs(want)).max())
    res = {"phase": "reconstruction", "z_dim": 100, "d": 64, "res": RES,
           "distance": "l2-lpips", "n_pos": RECON_N, "n_neg": RECON_N,
           "batch": RECON_BATCH, "end_to_end_s": e2e,
           "queries_per_sec": out["queries_per_sec"],
           "auroc": ev["auc"], "checked_queries": RECON_CHECK,
           "first_batch_max_rel_err_vs_cpu_f64": rel,
           "cpu_f64_reference_s": ref_s, "kernel_launches": launches}
    emit(res)
    check(rel <= 1e-4, f"recon: first batch off float64 by rel {rel:.3g}")
    return res


# ---------------------------------------------------------------------------
# phase 9: the tabular fbb attack at MIMIC-III width
# ---------------------------------------------------------------------------

def binary_rows(rng):
    """Sparse binary code matrices: each of the D columns a code with its
    own frequency (mostly rare, exponential with mean 0.03, capped at 0.5);
    half the members planted in the synthetic set with 3 codes flipped."""
    p = np.clip(rng.exponential(0.03, TAB_D), 0.001, 0.5)

    def rows(n):
        return (rng.random((n, TAB_D)) < p).astype(np.float32)
    pos, neg, syn = rows(TAB_Q), rows(TAB_Q), rows(TAB_SYN)
    slots = rng.permutation(TAB_SYN)[:TAB_Q // 2]
    syn[slots] = pos[:TAB_Q // 2]
    cols = rng.integers(0, TAB_D, (TAB_Q // 2, 3))
    for j in range(3):
        syn[slots, cols[:, j]] = 1.0 - syn[slots, cols[:, j]]
    return syn, pos, neg


def phase_tabular(torch, tmp: str) -> dict:
    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
    from ganleaks_tpu_torch.config import EvalConfig, TabularAttackConfig
    from ganleaks_tpu_torch.ops.distance import rows_embedding
    from ganleaks_tpu_torch.ops.knn_fused import knn_argmin_fused
    syn, pos, neg = binary_rows(np.random.default_rng(SEED + 9))
    paths = {}
    for name, arr in (("syn", syn), ("pos", pos), ("neg", neg)):
        paths[name] = os.path.join(tmp, f"tab_{name}.npy")
        np.save(paths[name], arr)
    # float64 distances of the float32 embeddings the attack searches
    emb = {name: rows_embedding(torch.from_numpy(arr).to(DEVICE))
           for name, arr in (("syn", syn), ("pos", pos), ("neg", neg))}
    s64 = emb["syn"].double()
    rs64 = (s64 ** 2).sum(1)
    runs = {}
    for engine in ("pallas", "gemm"):
        cfg = TabularAttackConfig(
            exp_name=f"smoke_tab_{engine}", syn_data_path=paths["syn"],
            pos_data_path=paths["pos"], neg_data_path=paths["neg"],
            engine=engine, save_root=os.path.join(tmp, "runs"))
        reset_launches()
        t0 = time.perf_counter()
        out = run_tabular_attack(cfg, DEVICE)
        e2e = time.perf_counter() - t0
        launches = read_launches()
        ev = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
        worst, mism, gap = 0.0, 0, 0.0
        for name in ("pos", "neg"):
            q64 = emb[name].double()
            rq64 = (q64 ** 2).sum(1)
            d64 = rq64[:, None] + rs64[None, :] - 2.0 * (q64 @ s64.T)
            idx = torch.from_numpy(out[f"{name}_nn_idx"]).long().to(DEVICE)
            loss = torch.from_numpy(out[f"{name}_loss"]).to(DEVICE)
            lim = TOL * (rq64 + rs64[idx])
            pick = d64.gather(1, idx[:, None])[:, 0]
            err = (loss - pick).abs()
            check(bool((err <= lim).all()),
                  f"tabular {engine} {name}: losses off float64 by "
                  f"{float((err / lim).max()):.3g} x the bound")
            best, first = torch.min(d64, dim=1)
            diff = idx != first
            # two distances each off by at most the bound: a pick may
            # differ from the float64 argmin only within twice of it
            ok = (pick - best) <= 2.0 * lim
            check(bool((ok | ~diff).all()),
                  f"tabular {engine} {name}: {int((diff & ~ok).sum())} "
                  f"indices off the float64 argmin beyond the bound")
            worst = max(worst, float((err / (rq64 + rs64[idx])).max()))
            mism += int(diff.sum())
            gaps = ((pick - best) / (rq64 + rs64[idx]))[diff]
            gap = max([gap] + gaps.tolist())
            del d64
        runs[engine] = r = {
            "end_to_end_s": e2e,
            "query_pairs_per_sec": out["query_pairs_per_sec"],
            "auroc": ev["auc"], "kernel_launches": launches,
            "loss_err_over_norms": worst,
            "index_differs_from_f64_argmin": mism,
            "max_gap_over_norms_where_differs": gap}
        emit({"phase": "tabular", "engine": engine, "d": TAB_D,
              "n_syn": TAB_SYN, "n_pos": TAB_Q, "n_neg": TAB_Q, **r})
    check(runs["pallas"]["kernel_launches"]["knn_argmin.tf32x3"] >= 1,
          "tabular: engine='pallas' never launched K1")
    check(sum(runs["gemm"]["kernel_launches"].values()) == 0,
          "tabular: engine='gemm' launched a kernel")
    check(runs["pallas"]["auroc"] > 0.6,
          f"tabular: AUROC {runs['pallas']['auroc']:.4f} with planted "
          f"member copies")
    check(abs(runs["pallas"]["auroc"] - runs["gemm"]["auroc"]) <= 1e-3,
          "tabular: AUROC of 'pallas' and 'gemm' differ")

    # K1 at the tabular shape: against its plain version, then timed
    q, s = emb["pos"].contiguous(), emb["syn"].contiguous()
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_plain, route,
                                                  sq_norms)
    rq, rs = sq_norms(q), sq_norms(s)
    held = hold_against_plain(torch, "tabular_k1071", q, s, rq, rs, [])
    emit({"phase": "kernel", **held})
    timing = {}
    if DEVICE == "cuda":
        def library():  # one composition of PyTorch calls, timed only
            return torch.min(torch.addmm(rs[None, :], q, s.T, alpha=-2.0)
                             + rq[:, None], dim=1)
        ms = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs),
                     10)
        plain_ms = time_ms(torch, lambda: knn_argmin_plain(q, s, rq, rs), 10)
        library_ms = time_ms(torch, library, 10)
        ms2 = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs),
                      10)
        n_q, k_dim = q.shape
        flops = 2.0 * n_q * TAB_SYN * k_dim
        nbytes = (n_q + TAB_SYN) * k_dim * 4 + (n_q + TAB_SYN) * 4 + n_q * 8
        timing = {"kernel": "knn_argmin", "tile": route(q.dtype),
                  "n_q": n_q, "n_s": TAB_SYN, "k": k_dim, "dtype": "float32",
                  "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "max_abs_err": held["max_abs_err"],
                  **float32_bounds(flops, nbytes, min(ms, ms2)),
                  "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12}
        emit({"phase": "timing", "case": "tabular_k1071", **timing})
    return {"runs": runs, "held": held, "timing": timing}


# ---------------------------------------------------------------------------
# phase 10: the north star — 20,000 x 100,000 at 64 px
# ---------------------------------------------------------------------------

def north_star_images(torch, gen, n: int):
    """``make_images``' distribution drawn on the card: an 8x8 random
    layout upsampled to RES, plus pixel noise (uint8 NHWC, on the card)."""
    base = torch.randint(0, 256, (n, 8, 8, 3), generator=gen, device=DEVICE,
                         dtype=torch.int16)
    up = base.repeat_interleave(RES // 8, 1).repeat_interleave(RES // 8, 2)
    noise = torch.randint(-24, 25, up.shape, generator=gen, device=DEVICE,
                          dtype=torch.int16)
    return (up + noise).clamp_(0, 255).to(torch.uint8)


def north_star_data(torch) -> dict:
    """10,000 members, 10,000 non-members and 100,000 synthetic images
    with the members' noisy copies planted (as ``attack_data``), drawn on
    the card from SEED and brought to the host as a user's arrays."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    pos = north_star_images(torch, gen, NS_POS)
    neg = north_star_images(torch, gen, NS_POS)
    syn = north_star_images(torch, gen, NS_SYN)
    slots = torch.randperm(NS_SYN, generator=gen, device=DEVICE)[:NS_POS]
    noise = torch.randint(-8, 9, pos.shape, generator=gen, device=DEVICE,
                          dtype=torch.int16)
    syn[slots] = (pos.to(torch.int16) + noise).clamp_(0, 255).to(torch.uint8)
    out = {"pos": pos.cpu().numpy(), "neg": neg.cpu().numpy(),
           "syn": syn.cpu().numpy()}
    del pos, neg, syn, noise
    torch.cuda.empty_cache()
    out["data_s"] = time.perf_counter() - t0
    return out


def north_star_run(torch, data: dict, label: str, cfg, want: dict,
                   sweep_cache: dict | None = None) -> dict:
    """``attack_arrays`` once on the north-star sets (with
    ``sweep_cache``, as ``run_attack`` passes it to each subdir of a
    hyperparameter search); checks the kernels of ``want`` (name -> exact
    launches, or True for some) launched and no other, and prints the
    run's seconds, rate, memory, plan and launches."""
    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = attack_arrays(cfg, data["syn"], data["pos"], data["neg"],
                        device=DEVICE, sweep_cache=sweep_cache)
    e2e = time.perf_counter() - t0
    launches = read_launches()
    for name, n in launches.items():
        w = want.get(name, 0)
        check(n > 0 if w is True else n == w,
              f"north star {label}: {name} launched {n} times, want {w}")
    idx = np.concatenate([out["pos_nn_idx"], out["neg_nn_idx"]])
    loss = np.concatenate([out["pos_loss"], out["neg_loss"]])
    check(loss.shape == (2 * NS_POS,) and bool(np.isfinite(loss).all()),
          f"north star {label}: not {2 * NS_POS} finite losses")
    # 1.47 GB of sets fit beside every plan here: copied to the card once
    check(out["sets_on_device"],
          f"north star {label}: the image sets stayed in host memory")
    plan = out["plan"]
    r = {"out": out, "idx": idx, "loss": loss, "launches": launches,
         "peak_bytes": torch.cuda.max_memory_allocated(), "e2e": e2e,
         "cfg": cfg}
    emit({"phase": "north_star", "run": label, "engine": cfg.engine,
          "auto_plan": cfg.auto_plan, "n_q": 2 * NS_POS, "n_syn": NS_SYN,
          "featurize_s": out["featurize_s"], "fold_s": out["fold_s"],
          "lpips_init_s": out["lpips_init_s"],
          "host_copy_s": out["host_copy_s"],
          "sets_on_device": out["sets_on_device"], "end_to_end_s": e2e,
          "query_pairs_per_sec": out["query_pairs_per_sec"],
          "peak_mem_gb": r["peak_bytes"] / 1e9,
          "plan": {"cache_gib": plan["cache_bytes"] / 2 ** 30,
                   "s_block": plan["s_block"], "q_block": plan["q_block"],
                   "sweeps": plan["sweeps"],
                   "query_reused": plan["query_reused"]},
          "oom_resumes": out["oom_resumes"], "kernel_launches": launches})
    return r


def f64_embeddings(torch, embed, images: np.ndarray, chunk: int = 256):
    """float64 embeddings of ``images`` through ``embed`` on the card."""
    with torch.inference_mode():
        return torch.cat([embed(torch.from_numpy(images[lo:lo + chunk])
                                .to(DEVICE)).double()
                          for lo in range(0, len(images), chunk)])


def north_star_hold(torch, data: dict, runs: dict) -> dict:
    """The runs on the bf16 tower against float64 on NS_SAMPLE sampled
    queries: each loss within the certificate's bound of the float64
    distance to its returned image, and no image of an NS_SUBSET-image
    sample closer than that by more than the two pairs' bounds. Then the
    bf16 tower's own error on those queries and the 'auto' run's returned
    images: the largest |d_bf16 - d_f32| / (rq + rs) and the largest
    ||phi_bf16(x) - phi(x)|| / ||phi(x)||, beside the certificate's eta."""
    from dataclasses import replace

    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.ops.knn import _default_cert_eta
    rng = np.random.default_rng(SEED + 11)
    queries = np.concatenate([data["pos"], data["neg"]])
    sample = np.sort(rng.choice(len(queries), NS_SAMPLE, replace=False))
    subset = np.sort(rng.choice(NS_SYN, NS_SUBSET, replace=False))
    base = AttackConfig(distance="l2-lpips", resolution=RES,
                        dtype="float32")
    embed = build_embed_fn(base, DEVICE)
    eq = f64_embeddings(torch, embed, queries[sample])
    rq = (eq ** 2).sum(1)
    rq_h = rq.cpu().numpy()
    eta = _default_cert_eta(True)
    res = {}
    for label, r in runs.items():
        ret = r["idx"][sample]
        er = f64_embeddings(torch, embed, data["syn"][ret])
        d_ret = ((eq - er) ** 2).sum(1).cpu().numpy()
        rs_ret = (er ** 2).sum(1).cpu().numpy()
        del er
        cfg = r["cfg"]
        if cfg.engine == "auto":  # what attack_arrays resolved it to
            cfg = replace(cfg, engine="taps-int8", **BF16)
        eps_ret, abs_err = cert_error_bound(torch, cfg, rq_h, rs_ret,
                                            cfg.engine == "taps-int8")

        def eps(rs: np.ndarray) -> np.ndarray:
            s = np.sqrt(rq_h)[:, None] + np.sqrt(rs)[None, :]
            a = eta * s + 2.0 * abs_err
            return a * (2.0 * s + a)

        loss = r["loss"][sample]
        check(bool((np.abs(loss - d_ret) <= eps_ret).all()),
              f"north star {label}: sampled losses outside the "
              f"certificate's bound of float64")
        worst = np.inf
        for lo in range(0, NS_SUBSET, 256):
            es = f64_embeddings(torch, embed, data["syn"][subset[lo:lo + 256]])
            rs = (es ** 2).sum(1)
            d = (rq[:, None] + rs[None, :] - 2.0 * eq @ es.T).cpu().numpy()
            slack = d - (d_ret - eps_ret)[:, None] + eps(rs.cpu().numpy())
            worst = min(worst, float(slack.min()))
            del es
        check(worst >= 0.0, f"north star {label}: a subset image is closer "
                            f"than the returned one by more than the bound")
        res[label] = {"max_loss_err_over_bound": float(
            (np.abs(loss - d_ret) / eps_ret).max()),
            "subset_min_slack": worst, "int8_abs_err": abs_err}
        if label == "auto":
            d_f32, rs_auto, ret_auto = d_ret, rs_ret, ret
    lo_embed = build_embed_fn(replace(base, **BF16), DEVICE)
    lq = f64_embeddings(torch, lo_embed, queries[sample])
    lr = f64_embeddings(torch, lo_embed, data["syn"][ret_auto])
    d_lo = ((lq - lr) ** 2).sum(1).cpu().numpy()
    er = f64_embeddings(torch, embed, data["syn"][ret_auto])
    rel = torch.cat([((lq - eq) ** 2).sum(1) / rq,
                     ((lr - er) ** 2).sum(1) / (er ** 2).sum(1)]).sqrt()
    tower = {"max_abs_d_bf16_minus_f32_over_norms": float(
        (np.abs(d_lo - d_f32) / (rq_h + rs_auto)).max()),
        "max_rel_embedding_err": float(rel.max()), "cert_eta": eta}
    check(np.isfinite(tower["max_rel_embedding_err"]),
          "north star: bf16 tower error not finite")
    emit({"phase": "north_star_check", "sample": NS_SAMPLE,
          "subset": NS_SUBSET, "runs": res, "bf16_tower": tower})
    return tower


def phase_north_star(torch) -> dict:
    """Phase 10: the attack at the reference study's 20,000 x 100,000 on
    the planner's one-sweep schedule, against fixed configs and a forced
    out-of-memory resume."""
    from dataclasses import replace

    from ganleaks_tpu_torch.config import AttackConfig
    data = north_star_data(torch)
    emit({"phase": "north_star_data", "n_pos": NS_POS, "n_neg": NS_POS,
          "n_syn": NS_SYN, "data_s": data["data_s"]})
    base = AttackConfig(distance="l2-lpips", resolution=RES,
                        query_block=NS_BLOCK, syn_block=NS_BLOCK,
                        save_plots=False)
    n_q = 2 * NS_POS
    q_blocks = -(-n_q // NS_BLOCK)
    s_blocks = -(-NS_SYN // NS_BLOCK)
    taps = 5  # VGG16's taps: one K2 launch each per featurised block
    runs = {}
    # 'auto' (taps-int8, bf16 tower) planned: one sweep, so K2 runs for
    # 120,000 images' worth of blocks, not the 220,000 of the 8 GiB
    # request's two sweeps
    sweep: dict = {}
    a = runs["auto"] = north_star_run(
        torch, data, "auto", replace(base, engine="auto"),
        {"tap_epilogue": taps * (q_blocks + s_blocks)}, sweep_cache=sweep)
    check(a["out"]["plan"]["sweeps"] == 1 and a["out"]["oom_resumes"] == 0,
          f"north star auto: plan {a['out']['plan']}, not one sweep")
    # the next subdir of a hyperparameter search: the held query cache is
    # planned as budget and reused, so K2 runs for the synthetic set only
    r = north_star_run(torch, data, "auto_reused",
                       replace(base, engine="auto"),
                       {"tap_epilogue": taps * s_blocks}, sweep_cache=sweep)
    check(r["out"]["plan"]["query_reused"]
          and r["out"]["plan"]["sweeps"] == 1,
          f"north star auto_reused: plan {r['out']['plan']}")
    check(bool((r["idx"] == a["idx"]).all() and (r["loss"] == a["loss"])
               .all()), "north star: the reused run's results differ from "
                        "the planned run's")
    sweep.clear()
    del r
    blk = 2048
    b = runs["taps_bf16"] = north_star_run(
        torch, data, "taps_bf16",
        replace(base, engine="taps", query_block=blk, syn_block=blk, **BF16),
        {"tap_epilogue": taps * (-(-n_q // blk) + -(-NS_SYN // blk)),
         "knn_argmin.wgmma": True})
    check(b["out"]["plan"]["sweeps"] == 1,
          f"north star taps_bf16: plan {b['out']['plan']}, not one sweep")
    # the same blocks without the planner: the 8 GiB cache takes two
    # sweeps; int8 products are exact, so the results are identical
    c = north_star_run(torch, data, "auto_no_plan",
                       replace(base, engine="auto", auto_plan=False),
                       {"tap_epilogue": taps * (q_blocks + 2 * s_blocks)})
    check(c["out"]["plan"]["sweeps"] == 2, f"north star auto_no_plan: plan "
                                           f"{c['out']['plan']}")
    check(bool((c["idx"] == a["idx"]).all() and (c["loss"] == a["loss"])
               .all()), "north star: the unplanned run's results differ "
                        "from the planned run's")
    # forced OOM: cap the process below the planned run's peak by a third
    # of its cache — the one-sweep cache allocation fails, the halved
    # chunk fits at the same blocks
    cache = a["out"]["plan"]["cache_bytes"]
    total = torch.cuda.get_device_properties(0).total_memory
    allowed = a["peak_bytes"] - cache // 3
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(allowed / total)
    try:
        d = north_star_run(torch, data, "auto_forced_oom",
                           replace(base, engine="auto"),
                           {"tap_epilogue": True})
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    emit({"phase": "north_star_oom", "allowed_gb": allowed / 1e9,
          "planned_peak_gb": a["peak_bytes"] / 1e9,
          "halvings": d["out"]["oom_resumes"]})
    check(d["out"]["oom_resumes"] >= 1,
          "north star: the capped run raised no OOM to resume from")
    check(bool((d["idx"] == a["idx"]).all() and (d["loss"] == a["loss"])
               .all()), "north star: the resumed run's results differ from "
                        "the planned run's")
    tower = north_star_hold(torch, data, {"auto": a, "taps_bf16": b})
    return {"launches": {"auto": a["launches"],
                         "taps_bf16": b["launches"]}, "tower": tower,
            "plan": a["out"]["plan"],
            "data": data, "auto": {k: a[k] for k in ("idx", "loss",
                                                     "launches")}}


# ---------------------------------------------------------------------------
# phase 11: PNG ingest at the north star
# ---------------------------------------------------------------------------

class RssPeak:
    """The process's peak resident set (GB) over a ``with`` block, read
    from ``/proc/self/status`` every 20 ms by a thread."""

    def __enter__(self):
        import threading
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())

    @staticmethod
    def _rss() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
        return 0.0

    def _poll(self) -> None:
        while not self._stop.wait(0.02):
            self.peak = max(self.peak, self._rss())


def ingest_run(torch, label: str, cfg, auto: dict) -> dict:
    """``run_attack`` once from the PNG directories; its indices and
    losses must equal phase 10's 'auto' ``attack_arrays`` run on the same
    arrays exactly, and K2 must launch as often as there."""
    from ganleaks_tpu_torch.attack.fbb import run_attack
    torch.cuda.empty_cache()
    reset_launches()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        out = run_attack(cfg, device=DEVICE)[0]
        e2e = time.perf_counter() - t0
    launches = read_launches()
    idx = np.concatenate([out["pos_nn_idx"], out["neg_nn_idx"]])
    loss = np.concatenate([out["pos_loss"], out["neg_loss"]])
    check(bool((idx == auto["idx"]).all() and (loss == auto["loss"]).all()),
          f"ingest {label}: results differ from attack_arrays' on the "
          f"same arrays")
    check(launches == auto["launches"], f"ingest {label}: launches "
                                        f"{launches}, phase 10 'auto' "
                                        f"{auto['launches']}")
    n_img = 2 * NS_POS + NS_SYN
    rec = {"phase": "ingest", "run": label,
           "decode_cache": cfg.decode_cache, "host_stream": cfg.host_stream,
           "ingest_s": out["ingest_s"], "end_to_end_s": e2e,
           "query_pairs_per_sec_e2e": 2 * NS_POS * NS_SYN / e2e,
           "query_pairs_per_sec": out["query_pairs_per_sec"],
           "featurize_s": out["featurize_s"], "fold_s": out["fold_s"],
           "host_copy_s": out["host_copy_s"],
           "sets_on_device": out["sets_on_device"],
           "peak_host_rss_gb": rss.peak, "kernel_launches": launches}
    # cold decodes every image (and writes the cache), warm reads the
    # cache's memmap; streamed decodes the synthetic set inside the
    # search, outside ingest_s
    rate = {"cold": "decode_images_per_sec",
            "warm": "cache_read_images_per_sec"}.get(label)
    if rate:
        rec[rate] = n_img / out["ingest_s"]
    emit(rec)
    return rec


def phase_ingest(torch, data: dict, auto: dict, tmp: str) -> dict:
    """Phase 11: phase 10's 10,000 + 10,000 queries and 100,000 synthetic
    images encoded as PNG directories by the port's encoder, then the
    'auto' attack from them through ``run_attack``: cold (no decode cache
    yet: every image decoded, the cache written), warm (the cache read),
    and with ``host_stream=True`` and no disk cache (``HostImageSet``: the
    synthetic set decoded block by block as the search reads it)."""
    import shutil
    from dataclasses import replace

    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.io.native import save_png_batch_native
    raw = sum(data[k].nbytes for k in ("pos", "neg", "syn"))
    free = shutil.disk_usage(tmp).free
    # PNGs of noisy images are about the raw size, the decode cache
    # exactly; twice that again as margin
    check(free > 4 * raw, f"ingest: {free / 1e9:.1f} GB free under {tmp}, "
                          f"the PNG dirs and the decode cache need about "
                          f"{2 * raw / 1e9:.1f}")
    dirs = {}
    t0 = time.perf_counter()
    for name in ("pos", "neg", "syn"):
        d = dirs[name] = os.path.join(tmp, name)
        os.makedirs(d)
        save_png_batch_native(data[name], [
            os.path.join(d, f"image_{i:06d}.png")
            for i in range(len(data[name]))])
    enc_s = time.perf_counter() - t0
    png_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for d in dirs.values() for f in os.listdir(d))
    n_img = 2 * NS_POS + NS_SYN
    emit({"phase": "ingest_encode", "images": n_img, "seconds": enc_s,
          "encode_images_per_sec": n_img / enc_s,
          "png_gb": png_bytes / 1e9, "raw_gb": raw / 1e9,
          "disk_free_gb": free / 1e9})
    base = AttackConfig(syn_data_path=dirs["syn"], pos_data_dir=dirs["pos"],
                        neg_data_dir=dirs["neg"], data_num=NS_POS,
                        distance="l2-lpips", resolution=RES, engine="auto",
                        query_block=NS_BLOCK, syn_block=NS_BLOCK,
                        save_root=os.path.join(tmp, "fbb"), save_plots=False)
    # cold: no decode cache exists yet, so the sets are decoded and the
    # cache written; warm: the next run reads it
    runs = {label: ingest_run(torch, label, replace(
        base, exp_name=label, decode_cache="auto"), auto)
        for label in ("cold", "warm")}
    runs["streamed"] = ingest_run(torch, "streamed", replace(
        base, exp_name="streamed", decode_cache=False, host_stream=True,
        save_plots=True), auto)
    emit({"phase": "ingest_summary", "encode_s": enc_s,
          **{f"{k}_ingest_s": r["ingest_s"] for k, r in runs.items()},
          **{f"{k}_end_to_end_s": r["end_to_end_s"]
             for k, r in runs.items()}})
    return {"encode_s": enc_s, "runs": runs}


# ---------------------------------------------------------------------------
# phase 12: the first victims at full width
# ---------------------------------------------------------------------------

def victim_state_arrays(torch, state, grads: bool = False) -> dict:
    """Every parameter and BatchNorm statistic of both nets (with
    ``grads``: the parameters' gradients), float64 on the host, keyed
    '<net>.<state-dict key>'."""
    out = {}
    for net, model in (("gen", state.gen), ("disc", state.disc)):
        items = ([(k, p.grad) for k, p in model.named_parameters()]
                 if grads else model.state_dict().items())
        out.update({f"{net}.{k}": v.detach().cpu().numpy().astype(
            np.float64) for k, v in items})
    return out


def rel_l2(card: dict, ref: dict, base: dict | None, keys) -> float:
    """||card - ref|| / ||ref - base|| over ``keys`` (``base`` None: over
    ||ref||); 0 where both are 0 (a net a step did not update)."""
    diff = sum(float(((card[k] - ref[k]) ** 2).sum()) for k in keys)
    norm = sum(float(((ref[k] - (0.0 if base is None else base[k])) ** 2)
                     .sum()) for k in keys)
    if norm == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return (diff / norm) ** 0.5


def grad_by_conv(card_lr0: dict, ref_lr0: dict, init: dict) -> dict:
    """Each convolution kernel's lr-0 gradient off float64 on the CPU
    (L2, relative, the worst step), keyed '<net>.<name>'."""
    convs = [k for k, v in init.items() if v.ndim == 4]
    return {k: max(rel_l2(c, r, None, [k]) for c, r in
                   zip(card_lr0["grads"], ref_lr0["grads"])) for k in convs}


def emit_conv_table(victim: str, tables: dict) -> dict:
    """One line: every convolution's gradient error with cuDNN (the
    trainers' numerics) and without it (``tables``: label -> layer ->
    error), and the layer each reads worst at."""
    rec = {"phase": "grad_by_conv", "victim": victim,
           "layers": {k: {lab: t[k] for lab, t in tables.items()}
                      for k in next(iter(tables.values()))},
           "worst": {lab: max(t, key=t.get) for lab, t in tables.items()},
           "worst_err": {lab: max(t.values()) for lab, t in tables.items()}}
    emit(rec)
    return rec


# (label, dtype, TF32 on, cuDNN on) of the card's runs of the held steps:
# the trainers' numerics, the same modules in float64, and two controls
# that show what the float32 bounds can see
HOLD_VARIANTS = (("f32", "float32", False, True),
                 ("f64", "float64", False, True),
                 ("f32_tf32", "float32", True, True),
                 ("f32_no_cudnn", "float32", False, False))
# the variants whose gradient error per convolution is printed: which
# layer cuDNN's float32 algorithms move off float64, against the native
# convolutions
CONV_TABLE_VARIANTS = ("f32", "f32_no_cudnn")


def adam_ratio_bound(beta1: float, beta2: float, t: int) -> float:
    """The most |m_hat / sqrt(v_hat)| can be at Adam's step ``t`` (eps
    left out, which only shrinks it): Cauchy-Schwarz over the two moments'
    weights, sqrt(sum_i a_i^2 / b_i)."""
    a = [(1 - beta1) * beta1 ** (t - i) / (1 - beta1 ** t)
         for i in range(1, t + 1)]
    b = [(1 - beta2) * beta2 ** (t - i) / (1 - beta2 ** t)
         for i in range(1, t + 1)]
    return sum(x * x / y for x, y in zip(a, b)) ** 0.5


class Numerics:
    """TF32 and cuDNN set for a ``with`` block, restored after."""

    def __init__(self, torch, tf32: bool, cudnn: bool):
        self.b, self.want = torch.backends, (tf32, tf32, cudnn)

    def _get(self):
        b = self.b
        return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
                b.cudnn.enabled)

    def _set(self, v):
        b = self.b
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled = v

    def __enter__(self):
        self.before = self._get()
        self._set(self.want)

    def __exit__(self, *exc):
        self._set(self.before)


def victim_steps(torch, kind: str, cfg, steps, dev: str, dtype):
    """The held steps of ``kind`` from ``build_state(cfg)`` on ``dev`` in
    ``dtype``: per step its losses and (with lr 0, so every step starts
    from the same parameters) the gradients of both nets and their
    BatchNorm statistics; at the end every parameter and statistic."""
    from ganleaks_tpu_torch.train import dcgan, wgangp
    mod = dcgan if kind == "dcgan" else wgangp
    state = mod.build_state(cfg, dev, dtype)
    hist, grads, stats = [], [], []

    def t(a):
        return torch.from_numpy(a).to(dev, dtype)

    t0 = time.perf_counter()
    for st in steps:
        if kind == "dcgan":
            m = mod.dcgan_train_step(state, t(st["real"]),
                                     noise=t(st["noise"][0]))
        else:
            m = mod.wgangp_train_step(
                state, t(st["real"]), cfg.critic_iter, cfg.lambda_gp,
                noise=[t(z) for z in st["noise"]],
                eps=[t(e) for e in st["eps"]])
        hist.append([float(v) for v in m.values()])
        if cfg.lr == 0.0:
            grads.append(victim_state_arrays(torch, state, grads=True))
            stats.append(victim_state_arrays(torch, state))
    secs = time.perf_counter() - t0
    return {"losses": np.array(hist), "grads": grads, "stats": stats,
            "final": victim_state_arrays(torch, state), "seconds": secs}


def hold_errors(card: dict, ref: dict, init: dict, lr: float) -> dict:
    """One card variant's lr-0 and trained runs against float64 on the
    CPU: losses (relative, absolute below 1: a loss may cross 0); at lr 0
    each net's gradients and the BatchNorm statistics' change (L2,
    relative, the worst step); trained, each net's update (L2, relative),
    the statistics' change, and the largest parameter difference in units
    of lr."""
    params = [k for k in init if "running" not in k
              and "num_batches" not in k]
    stat_keys = [k for k in init if "running" in k]
    nets = ("gen.", "disc.")

    def loss_err(mode):
        c, r = card[mode]["losses"], ref[mode]["losses"]
        return float((np.abs(c - r) / np.maximum(np.abs(r), 1.0)).max())

    def stats_err(cs, rs):
        return max((rel_l2(c, r, init, stat_keys) for c, r in zip(cs, rs)),
                   default=0.0) if stat_keys else 0.0

    c0, r0 = card["lr0"], ref["lr0"]
    fc, fr = card["trained"]["final"], ref["trained"]["final"]
    return {
        "lr0_loss": loss_err("lr0"),
        "lr0_grad": {net: max(rel_l2(gc, gr, None, [
            k for k in params if k.startswith(net)])
            for gc, gr in zip(c0["grads"], r0["grads"])) for net in nets},
        "lr0_bn_stats": stats_err(c0["stats"], r0["stats"]),
        "trained_loss": loss_err("trained"),
        "trained_update": {net: rel_l2(fc, fr, init, [
            k for k in params if k.startswith(net)]) for net in nets},
        "trained_bn_stats": stats_err([fc], [fr]),
        "trained_max_param_diff_lr": {net: max(
            float(np.abs(fc[k] - fr[k]).max()) for k in params
            if k.startswith(net)) / lr for net in nets}}


def victim_hold(torch, kind: str) -> dict:
    """VICTIM_HOLD_STEPS train steps of ``kind`` ('dcgan', or 'wgangp'
    with critic_iter 5) at full width on the CPU in float64 and on the
    card in each of HOLD_VARIANTS, from the same seeded weights with the
    same batches, noise and eps, at lr 0 (each step from the same
    parameters) and at the configured lr.

    The batch is VICTIM_HOLD_BATCH, not the configs' 128: float64 on the
    host's cores takes about 6.5 s for both victims' held steps at batch
    8, so about 100 s per pass at 128.

    * float64 on the card: the same function as on the CPU — losses,
      gradients, statistics and updates within VICTIM_F64_RTOL, and every
      trained parameter within VICTIM_F64_STEP of one Adam step (lr).
    * float32 on the card (the trainers' numerics, TF32 off): at lr 0
      losses within VICTIM_LOSS_RTOL, gradients within VICTIM_GRAD_RTOL
      and the BatchNorm statistics within VICTIM_STAT_RTOL. Gradients of
      ReLU nets jump where a pre-activation lies within rounding of the
      kink, so float32 and float64 can take different branches: at batch
      8 the WGAN-GP generator's gradient read 7.0e-3 off float64 on the
      card and 2.8e-4 on the CPU in float32 at its second step, 4.5e-6
      and 2.4e-6 at the first and third (H100). Trained: losses within
      VICTIM_TRAJ_RTOL[kind]; each net's update and the statistics'
      change within VICTIM_UPDATE_RTOL of float64's in L2 (a missing or
      reversed update is 1 or 2); every parameter within two of Adam's
      largest steps per Adam step its net took (``adam_ratio_bound``;
      the critic takes critic_iter a train step) of float64's: the most
      two runs can part when float32's rounding flips the sign of a
      gradient below its noise, which in Adam's sign-like first steps
      moves the weight by a whole step, so a tighter per-element bound
      cannot hold in float32 (the generators' worst element reads 3.7 and
      7.8 lr, against 6.4 and 8.0).
    * the controls (TF32 on; convolutions off cuDNN) are printed, not
      held."""
    from dataclasses import replace

    from ganleaks_tpu_torch.config import DCGANConfig, WGANGPConfig
    from ganleaks_tpu_torch.io.native import LUT_CROP
    from ganleaks_tpu_torch.train import dcgan, wgangp
    cfg = (DCGANConfig(seed=SEED) if kind == "dcgan"
           else WGANGPConfig(seed=SEED, critic_iter=5))
    iters = 1 if kind == "dcgan" else cfg.critic_iter
    rng = np.random.default_rng(SEED + 12)
    steps = []
    for _ in range(VICTIM_HOLD_STEPS):
        steps.append({
            "real": LUT_CROP[make_images(rng, VICTIM_HOLD_BATCH, RES)
                             ].transpose(0, 3, 1, 2).copy(),
            "noise": rng.standard_normal(
                (iters, VICTIM_HOLD_BATCH, cfg.nz)).astype(np.float32),
            "eps": rng.random((iters, VICTIM_HOLD_BATCH, 1, 1, 1)
                              ).astype(np.float32)})
    modes = {"lr0": replace(cfg, lr=0.0), "trained": cfg}
    ref = {m: victim_steps(torch, kind, c, steps, "cpu", torch.float64)
           for m, c in modes.items()}
    init = victim_state_arrays(torch, (dcgan if kind == "dcgan" else wgangp)
                               .build_state(cfg))
    errs, card_s, by_conv = {}, {}, {}
    for label, dtype, tf32, cudnn in HOLD_VARIANTS:
        with Numerics(torch, tf32, cudnn):
            card = {m: victim_steps(torch, kind, c, steps, DEVICE,
                                    getattr(torch, dtype))
                    for m, c in modes.items()}
        errs[label] = hold_errors(card, ref, init, cfg.lr)
        card_s[label] = card["trained"]["seconds"]
        if label in CONV_TABLE_VARIANTS:
            by_conv[label] = grad_by_conv(card["lr0"], ref["lr0"], init)
        if label == "f32":
            card_losses = card["trained"]["losses"].tolist()
    # Adam steps each net took: the critic updates critic_iter times a step
    step_bound = {net: 2 * sum(adam_ratio_bound(cfg.beta1, cfg.beta2, t)
                               for t in range(1, n * VICTIM_HOLD_STEPS + 1))
                  for net, n in (("gen.", 1), ("disc.", iters))}
    moved = max(float(np.abs(ref["trained"]["final"][k] - init[k]).max())
                for k in init if "running" not in k
                and "num_batches" not in k)
    rec = {"phase": "victim_hold", "victim": kind,
           "batch": VICTIM_HOLD_BATCH, "steps": VICTIM_HOLD_STEPS,
           "critic_iter": iters, "lr": cfg.lr,
           "betas": [cfg.beta1, cfg.beta2],
           "param_bound_lr": step_bound, "errors_vs_cpu_f64": errs,
           "losses_card_f32": card_losses,
           "losses_f64": ref["trained"]["losses"].tolist(),
           "max_moved_f64": moved,
           "card_s": card_s, "cpu_f64_s": ref["trained"]["seconds"]}
    emit(rec)
    rec["grad_by_conv"] = emit_conv_table(kind, by_conv)
    f64, f32 = errs["f64"], errs["f32"]
    f64_worst = max(f64["lr0_loss"], *f64["lr0_grad"].values(),
                    f64["lr0_bn_stats"], f64["trained_loss"],
                    *f64["trained_update"].values(),
                    f64["trained_bn_stats"])
    check(f64_worst <= VICTIM_F64_RTOL
          and max(f64["trained_max_param_diff_lr"].values())
          <= VICTIM_F64_STEP,
          f"victim {kind}: float64 on the card is not the CPU's float64 "
          f"function: {f64}")
    check(f32["lr0_loss"] <= VICTIM_LOSS_RTOL,
          f"victim {kind}: lr-0 losses off float64 by {f32['lr0_loss']:.3g}")
    check(max(f32["lr0_grad"].values()) <= VICTIM_GRAD_RTOL,
          f"victim {kind}: gradients {f32['lr0_grad']} off float64 (L2, "
          f"relative)")
    check(f32["lr0_bn_stats"] <= VICTIM_STAT_RTOL,
          f"victim {kind}: BatchNorm statistics {f32['lr0_bn_stats']:.3g} "
          f"off float64 (L2, relative)")
    check(f32["trained_loss"] <= VICTIM_TRAJ_RTOL[kind],
          f"victim {kind}: trained losses off float64 by "
          f"{f32['trained_loss']:.3g} relative")
    check(max(*f32["trained_update"].values(), f32["trained_bn_stats"])
          <= VICTIM_UPDATE_RTOL,
          f"victim {kind}: trained updates {f32['trained_update']} / "
          f"statistics {f32['trained_bn_stats']:.3g} off float64's")
    check(all(f32["trained_max_param_diff_lr"][net] <= step_bound[net]
              for net in step_bound),
          f"victim {kind}: a parameter {f32['trained_max_param_diff_lr']} "
          f"lr off float64, over the {step_bound} lr two runs of Adam can "
          f"part by")
    check(moved > 0.5 * cfg.lr, f"victim {kind}: the steps barely moved "
                                f"the weights ({moved:.3g})")
    return rec


def victim_step_rate(torch, kind: str, cfg) -> float:
    """Train steps per second of ``kind`` on the card at the configs'
    batch: VICTIM_TIMED_STEPS steps after a warm-up step, synchronised,
    from a fresh state on one seeded batch (the entry point's wall time
    also holds the decode, the set-up, the sample grid and the saves)."""
    from ganleaks_tpu_torch.train import dcgan, wgangp
    state = (dcgan if kind == "dcgan" else wgangp).build_state(cfg, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    real = torch.rand(VICTIM_BATCH, 3, RES, RES, generator=gen,
                      device=DEVICE) * 2 - 1

    def step():
        if kind == "dcgan":
            dcgan.dcgan_train_step(state, real, generator=gen)
        else:
            wgangp.wgangp_train_step(state, real, cfg.critic_iter,
                                     cfg.lambda_gp, generator=gen)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VICTIM_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    return VICTIM_TIMED_STEPS / (time.perf_counter() - t0)


def victim_run(torch, kind: str, tmp: str, dirs: dict) -> dict:
    """``kind`` through its entry points on the card: ``train`` from the
    training PNG directory (one epoch at batch 128), ``generate`` its
    ``num_generated`` images as the artifact triplet, VICTIM_PLANT
    training PNGs planted in the PNG dump, ``run_attack`` ('auto') on the
    dump with the training and held-out directories as members and
    non-members, ``evaluate``."""
    import shutil

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import run_attack
    from ganleaks_tpu_torch.config import (AttackConfig, DCGANConfig,
                                           EvalConfig, WGANGPConfig)
    from ganleaks_tpu_torch.io.native import decode_png
    from ganleaks_tpu_torch.train import dcgan, wgangp
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    mod = dcgan if kind == "dcgan" else wgangp
    common = dict(data_path=dirs["train"], batch_size=VICTIM_BATCH,
                  num_epochs=1, seed=SEED, PATH=os.path.join(tmp, "model"),
                  PATH_syn_data=os.path.join(tmp, "syn"))
    cfg = (DCGANConfig(**common) if kind == "dcgan"
           else WGANGPConfig(critic_iter=5, **common))
    grids = os.path.join(tmp, f"grids_{kind}")
    logger = MetricsLogger(os.path.join(tmp, f"{kind}.jsonl"), echo=False,
                           image_dir=grids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = mod.train(cfg, logger=logger, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    logger.close()
    with open(os.path.join(tmp, f"{kind}.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    check(state.step == -(-VICTIM_TRAIN // VICTIM_BATCH)
          and np.isfinite(rec["loss_gen"]),
          f"victim {kind}: {state.step} steps, record {rec}")
    grid = decode_png(os.path.join(grids, os.listdir(grids)[0]))
    t0 = time.perf_counter()
    out_dirs = mod.generate(cfg, state, run_dir="run", device=DEVICE)
    gen_s = time.perf_counter() - t0
    png = out_dirs["png_images"]
    fake = np.load(os.path.join(out_dirs["npz_images"],
                                f"{kind}_synthetic_data.npz"))["fake"]
    noise = np.load(os.path.join(out_dirs["npz_noise"],
                                 f"{kind}_noise.npz"))["noise"]
    n_gen = cfg.num_generated
    check(fake.shape == (n_gen, 3, RES, RES) and bool(np.isfinite(fake)
                                                        .all())
          and noise.shape == (n_gen, cfg.nz, 1, 1)
          and len(os.listdir(png)) == n_gen,
          f"victim {kind}: artifacts {fake.shape}, {noise.shape}, "
          f"{len(os.listdir(png))} PNGs")
    members = sorted(f for f in os.listdir(dirs["train"])
                     if f.endswith(".png"))
    for i, f in enumerate(members[:VICTIM_PLANT]):
        shutil.copy(os.path.join(dirs["train"], f),
                    os.path.join(png, f"image_{n_gen + i}.png"))
    reset_launches()
    t0 = time.perf_counter()
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=dirs["train"],
        neg_data_dir=dirs["heldout"], data_num=VICTIM_TRAIN,
        distance="l2-lpips", resolution=RES, engine="auto",
        save_root=os.path.join(tmp, "fbb"), exp_name=kind), device=DEVICE)[0]
    attack_s = time.perf_counter() - t0
    launches = read_launches()
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    rate = victim_step_rate(torch, kind, cfg)
    caught = int((out["pos_loss"] < out["neg_loss"].min()).sum())
    r = {"phase": "victim", "victim": kind, "train_images": VICTIM_TRAIN,
         "batch": VICTIM_BATCH, "steps": state.step, "train_s": train_s,
         "steps_per_sec": rate, "images_per_sec": rate * VICTIM_BATCH,
         "losses": {k: rec[k] for k in rec if k.startswith("loss")},
         "grid_shape": list(grid.shape), "generated": n_gen,
         "generate_s": gen_s, "generate_images_per_sec": n_gen / gen_s,
         "planted": VICTIM_PLANT, "attack_s": attack_s,
         "ingest_s": out["ingest_s"],
         "query_pairs_per_sec": out["query_pairs_per_sec"],
         "members_below_all_nonmembers": caught, "auroc": res["auc"],
         "kernel_launches": launches}
    emit(r)
    check(bool(np.isfinite(out["pos_loss"]).all()
               and np.isfinite(out["neg_loss"]).all()),
          f"victim {kind}: non-finite attack losses")
    check(caught >= VICTIM_PLANT and res["auc"] > 0.5,
          f"victim {kind}: the planted members were not found "
          f"({caught} below every non-member, AUROC {res['auc']:.4f})")
    check(launches["tap_epilogue"] > 0,
          f"victim {kind}: 'auto' did not launch K2")
    return r


def victim_data(tmp: str) -> dict:
    """VICTIM_TRAIN seeded training and as many held-out 64-px PNGs, in
    ``<tmp>/train`` and ``<tmp>/heldout``."""
    from ganleaks_tpu_torch.io.native import save_png_batch_native
    rng = np.random.default_rng(SEED + 13)
    dirs = {}
    t0 = time.perf_counter()
    for name in ("train", "heldout"):
        d = dirs[name] = os.path.join(tmp, name)
        os.makedirs(d)
        save_png_batch_native(make_images(rng, VICTIM_TRAIN, RES), [
            os.path.join(d, f"{i:05d}.png") for i in range(VICTIM_TRAIN)])
    emit({"phase": "victim_data", "images": 2 * VICTIM_TRAIN,
          "seconds": time.perf_counter() - t0})
    return dirs


def phase_victims(torch, tmp: str) -> dict:
    """Phase 12: DCGAN and WGAN-GP at full width (nz 100, ngf 64, ndf 64,
    64 px, batch 128): the float64 hold of their first steps, then
    training, sampling, the attack on the PNG dump, and ``bench --metric
    gen``."""
    import contextlib
    import io

    from ganleaks_tpu_torch import bench
    dirs = victim_data(tmp)
    out = {}
    for kind in ("dcgan", "wgangp"):
        out[f"{kind}_hold"] = victim_hold(torch, kind)
        out[kind] = victim_run(torch, kind, tmp, dirs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(bench.main(["--metric", "gen"], device=DEVICE) == 0,
              "bench --metric gen failed")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit({"phase": "bench_gen", **line})
    out["gen_images_per_sec"] = line["value"]
    out["dirs"] = dirs
    return out


# ---------------------------------------------------------------------------
# phase 13: VAE-GAN, medGAN and PGGAN at the reference's widths
# ---------------------------------------------------------------------------

def v2_config(kind: str, **kw):
    from ganleaks_tpu_torch.config import (MedGANConfig, PGGANConfig,
                                           VAEGANConfig)
    cls = {"vaegan": VAEGANConfig, "medgan": MedGANConfig,
           "pggan": PGGANConfig}[kind]
    return cls(seed=SEED, **kw)


def v2_state(torch, kind: str, dev: str, dtype):
    """``kind``'s seeded train state on ``dev`` in ``dtype``, its nets by
    name, its optimisers and the Adam updates each net takes a step."""
    from ganleaks_tpu_torch.train import medgan, pggan, vaegan
    if kind == "vaegan":
        st = vaegan.build_state(v2_config(kind), dev, dtype)
        nets = st.nets()
        opts = list(st.optimizers().values())
        updates = {"enc": 1, "gen": 1, "disc": 2, "disc_l": 1}
    elif kind == "medgan":
        st = medgan.build_state(v2_config(kind), TAB_D, dev, dtype)
        nets = {"gen": st.gen, "disc": st.disc, "ae": st.ae}
        opts = [st.opt_gen, st.opt_disc, st.opt_ae_g]
        updates = dict.fromkeys(nets, 1)
    else:
        st = pggan.build_state(v2_config(kind), dev, dtype, V2_PGGAN_TOP)
        nets = {"gen": st.gen, "disc": st.disc}
        opts = [st.opt_gen, st.opt_disc]
        updates = dict.fromkeys(nets, 1)
    return st, nets, opts, updates


def v2_inputs(kind: str, res_steps: int = V2_PGGAN_CPU_STEPS) -> list:
    # res_steps: PGGAN's resolution index
    """V2_HOLD_STEPS steps' seeded batches and draws (numpy float32)."""
    from ganleaks_tpu_torch.io.native import LUT_CROP
    rng = np.random.default_rng(SEED + 14)
    b = V2_HOLD_BATCH[kind]
    cfg = v2_config(kind)

    def images(res):
        return LUT_CROP[make_images(rng, b, res)].transpose(0, 3, 1, 2).copy()

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    out = []
    for _ in range(V2_HOLD_STEPS):
        if kind == "vaegan":
            z = cfg.z_dim
            out.append({"real": [images(RES) for _ in range(4)],
                        "eps_dl": normal(b, z), "noise_dl": normal(b, z),
                        "noise_d": [normal(b, z), normal(b, z)],
                        "eps_g": normal(b, z)})
        elif kind == "medgan":
            out.append({"real": (rng.random((b, TAB_D)) < 0.05).astype(
                np.float32), "noise": normal(b, cfg.latent_dim)})
        else:
            out.append({"real": images(4 * 2 ** res_steps),
                        "noise": normal(b, cfg.nz),
                        "eps": rng.random((b, 1, 1, 1)).astype(np.float32)})
    return out


def v2_arrays(torch, nets: dict, grads: bool = False) -> dict:
    """Every parameter and buffer (with ``grads``: every parameter's
    gradient), float64 on the host, keyed '<net>.<name>'."""
    out = {}
    for net, model in nets.items():
        items = ([(k, p.grad) for k, p in model.named_parameters()]
                 if grads else [*model.named_parameters(),
                                *model.named_buffers()])
        out.update({f"{net}.{k}": (np.zeros(1) if v is None else
                                   v.detach().float().cpu().numpy()
                                   .astype(np.float64)
                                   if v.dtype == torch.bfloat16 else
                                   v.detach().cpu().numpy().astype(
                                       np.float64)) for k, v in items})
    return out


def v2_steps(torch, kind: str, inputs: list, dev: str, dtype, lr0: bool,
             compute: str | None = None,
             res_steps: int = V2_PGGAN_CPU_STEPS):
    """The held steps of ``kind`` on ``dev`` with parameters in ``dtype``
    (PGGAN's activations in ``compute``, default the parameters' dtype):
    per step the losses and, at lr 0 (every step from the same
    parameters), the gradients and buffers; at the end every parameter and
    buffer."""
    from ganleaks_tpu_torch.train import medgan, pggan, vaegan
    st, nets, opts, _ = v2_state(torch, kind, dev, dtype)
    if lr0:
        for opt in opts:
            for group in opt.param_groups:
                group["lr"] = 0.0
    cdt = compute or str(dtype).split(".")[-1]
    tdt = getattr(torch, cdt) if kind == "pggan" else dtype

    def t(a, d=dtype):
        return torch.from_numpy(a).to(dev, d)

    hist, grads, bufs = [], [], []
    t0 = time.perf_counter()
    for inp in inputs:
        if kind == "vaegan":
            m = vaegan.vaegan_train_step(
                st, *[t(r) for r in inp["real"]], draws={
                    "eps_dl": t(inp["eps_dl"]), "noise_dl": t(inp["noise_dl"]),
                    "noise_d": [t(z) for z in inp["noise_d"]],
                    "eps_g": t(inp["eps_g"])})
        elif kind == "medgan":
            m = medgan.medgan_train_step(st, t(inp["real"]),
                                         noise=t(inp["noise"]))
        else:
            m = pggan.pggan_train_step(
                st, t(inp["real"]), V2_ALPHA, res_steps, compute_dtype=cdt,
                noise=t(inp["noise"], tdt), eps=t(inp["eps"], tdt))
        hist.append([float(v) for v in m.values()])
        if lr0:
            grads.append(v2_arrays(torch, nets, grads=True))
            bufs.append({k: v for k, v in v2_arrays(torch, nets).items()
                         if k in v2_buffer_keys(nets)})
    if dev != "cpu":
        torch.cuda.synchronize()
    return {"losses": np.array(hist), "grads": grads, "bufs": bufs,
            "final": v2_arrays(torch, nets),
            "seconds": time.perf_counter() - t0}


def v2_buffer_keys(nets: dict) -> set:
    return {f"{net}.{k}" for net, m in nets.items()
            for k, _ in m.named_buffers()}


def v2_errors(card: dict, ref: dict, init: dict, nets: dict, lrs: dict
              ) -> dict:
    """One variant's lr-0 and trained runs against a reference run:
    losses (relative, absolute below 1); at lr 0 each net's gradients and
    the buffers' change (L2, relative, the worst step); trained, each
    net's update and the buffers' change (L2, relative) and the largest
    parameter difference in units of the net's lr."""
    bufs = v2_buffer_keys(nets)
    params = [k for k in init if k not in bufs]

    def keys(net):
        return [k for k in params if k.split(".")[0] == net]

    def loss_err(mode):
        c, r = card[mode]["losses"], ref[mode]["losses"]
        return float((np.abs(c - r) / np.maximum(np.abs(r), 1.0)).max())

    def buf_err(cs, rs):
        moved = [k for k in bufs if any(
            np.abs(r[k] - init[k]).max() > 0 for r in rs)]
        return max((rel_l2(c, r, init, moved) for c, r in zip(cs, rs)),
                   default=0.0) if moved else 0.0

    c0, r0 = card["lr0"], ref["lr0"]
    fc, fr = card["trained"]["final"], ref["trained"]["final"]
    return {
        "lr0_loss": loss_err("lr0"),
        "lr0_grad": {n: max(rel_l2(gc, gr, None, keys(n))
                            for gc, gr in zip(c0["grads"], r0["grads"]))
                     for n in nets},
        "lr0_buffers": buf_err(c0["bufs"], r0["bufs"]),
        "trained_loss": loss_err("trained"),
        "trained_update": {n: rel_l2(fc, fr, init, keys(n)) for n in nets},
        "trained_buffers": buf_err([fc], [fr]),
        "trained_max_param_diff_lr": {n: max(
            float(np.abs(fc[k] - fr[k]).max()) for k in keys(n)) / lrs[n]
            for n in nets}}


def v2_lrs(kind: str, opts) -> dict:
    return dict(zip({"vaegan": ("enc", "gen", "disc", "disc_l"),
                     "medgan": ("gen", "disc", "ae"),
                     "pggan": ("gen", "disc")}[kind],
                    (o.param_groups[0]["lr"] for o in opts)))


def v2_check_f64(kind: str, err: dict, what: str) -> None:
    worst = max(err["lr0_loss"], *err["lr0_grad"].values(),
                err["lr0_buffers"], err["trained_loss"],
                *err["trained_update"].values(), err["trained_buffers"])
    check(worst <= VICTIM_F64_RTOL and max(
        err["trained_max_param_diff_lr"].values()) <= V2_F64_STEP,
        f"{kind}: {what} is not the same function: {err}")


def v2_check_f32(kind: str, err: dict, bound: dict, what: str) -> None:
    """The float32 bars of ``victim_hold``, with ``kind``'s trajectory
    bound."""
    check(err["lr0_loss"] <= VICTIM_LOSS_RTOL,
          f"{kind} {what}: lr-0 losses off by {err['lr0_loss']:.3g}")
    check(max(err["lr0_grad"].values()) <= VICTIM_GRAD_RTOL,
          f"{kind} {what}: gradients {err['lr0_grad']} (L2, relative)")
    check(err["lr0_buffers"] <= VICTIM_STAT_RTOL,
          f"{kind} {what}: buffers {err['lr0_buffers']:.3g} (L2, relative)")
    check(err["trained_loss"] <= V2_TRAJ_RTOL[kind],
          f"{kind} {what}: trained losses off by {err['trained_loss']:.3g}")
    check(max(*err["trained_update"].values(), err["trained_buffers"])
          <= VICTIM_UPDATE_RTOL,
          f"{kind} {what}: updates {err['trained_update']} / buffers "
          f"{err['trained_buffers']:.3g}")
    check(all(err["trained_max_param_diff_lr"][n] <= bound[n]
              for n in bound),
          f"{kind} {what}: parameters {err['trained_max_param_diff_lr']} "
          f"lr apart, over Adam's {bound}")


def v2_hold(torch, kind: str) -> dict:
    """V2_HOLD_STEPS train steps of ``kind`` at the reference's widths
    from the same seeded weights, batches and draws, at lr 0 and at the
    configs' lr: on the CPU in float64 (the reference), on the card in
    float64 (the same function: losses, gradients, buffers and updates
    within VICTIM_F64_RTOL, parameters within V2_F64_STEP lr) and in
    float32 (``victim_hold``'s bars; trained losses within
    V2_TRAJ_RTOL[kind]; every parameter within two of Adam's largest
    steps per update its net took). Batches: VAE-GAN 8, medGAN 256, PGGAN
    8 (float64 on the host's cores is the limit). PGGAN's CPU reference
    runs at 8 px (steps 1, full channel width; 64 px would take minutes a
    step there); at 64 px (steps 4) the card's float32 is held to its own
    float64, and its bfloat16 step (parameters and activations cast,
    losses and Adam in float32) to float64 within V2_BF16_LOSS (lr-0
    losses), V2_BF16_GRAD (lr-0 gradients), V2_BF16_TRAJ (trained losses:
    float32 itself drifts 2% from float64 in three steps at lr 1e-3, as
    Adam's sign-like first steps flip on gradients under its rounding, and
    bf16's gradients are 7-16% off) and V2_BF16_UPDATE (trained updates);
    against float32 it is printed."""
    inputs = v2_inputs(kind)
    _, nets, opts, updates = v2_state(torch, kind, "cpu", torch.float64)
    init = v2_arrays(torch, nets)
    lrs = v2_lrs(kind, opts)
    betas = opts[0].param_groups[0]["betas"]
    # two runs can part by Adam's largest step each way per update, plus
    # float32's rounding of weights up to ~4 (N(0, 1) WSConv kernels):
    # 5e-4 lr a rounding at PGGAN's lr 1e-3
    bound = {n: 2 * sum(adam_ratio_bound(betas[0], betas[1], t)
                        for t in range(1, k * V2_HOLD_STEPS + 1)) + 0.01
             for n, k in updates.items()}

    def runs(dev, dtype, inp=inputs, **kw):
        return {m: v2_steps(torch, kind, inp, dev, dtype, m == "lr0", **kw)
                for m in ("lr0", "trained")}

    ref = runs("cpu", torch.float64)
    card = {"f64": runs(DEVICE, torch.float64),
            "f32": runs(DEVICE, torch.float32)}
    errs = {k: v2_errors(c, ref, init, nets, lrs) for k, c in card.items()}
    rec = {"phase": "victim2_hold", "victim": kind,
           "batch": V2_HOLD_BATCH[kind], "steps": V2_HOLD_STEPS, "lrs": lrs,
           "betas": list(betas), "param_bound_lr": bound,
           "errors_vs_cpu_f64": errs,
           "losses_f64": ref["trained"]["losses"].tolist(),
           "losses_card_f32": card["f32"]["trained"]["losses"].tolist(),
           "cpu_f64_s": ref["trained"]["seconds"],
           "card_f32_s": card["f32"]["trained"]["seconds"]}
    if kind == "pggan":
        rec["cpu_resolution"] = 4 * 2 ** V2_PGGAN_CPU_STEPS
        top = v2_inputs(kind, V2_PGGAN_TOP)
        kw = {"inp": top, "res_steps": V2_PGGAN_TOP}
        hi = {"f64": runs(DEVICE, torch.float64, **kw),
              "f32": runs(DEVICE, torch.float32, **kw),
              "bf16": runs(DEVICE, torch.float32, compute="bfloat16", **kw)}
        rec["top_resolution"] = 4 * 2 ** V2_PGGAN_TOP
        rec["top_errors"] = {
            "f32_vs_f64": v2_errors(hi["f32"], hi["f64"], init, nets, lrs),
            "bf16_vs_f64": v2_errors(hi["bf16"], hi["f64"], init, nets, lrs),
            "bf16_vs_f32": v2_errors(hi["bf16"], hi["f32"], init, nets,
                                     lrs)}
        rec["top_losses"] = {k: v["trained"]["losses"].tolist()
                             for k, v in hi.items()}
    emit(rec)
    v2_check_f64(kind, errs["f64"], "the card's float64")
    v2_check_f32(kind, errs["f32"], bound, "the card's float32")
    moved = max(float(np.abs(ref["trained"]["final"][k] - init[k]).max())
                for k in init if k not in v2_buffer_keys(nets))
    check(moved > 0.5 * min(lrs.values()),
          f"{kind}: the steps barely moved the weights ({moved:.3g})")
    if kind == "pggan":
        top = rec["top_errors"]
        v2_check_f32(kind, top["f32_vs_f64"], bound, "64 px float32")
        e = top["bf16_vs_f64"]
        check(e["lr0_loss"] <= V2_BF16_LOSS
              and e["trained_loss"] <= V2_BF16_TRAJ
              and max(e["lr0_grad"].values()) <= V2_BF16_GRAD
              and max(e["trained_update"].values()) <= V2_BF16_UPDATE,
              f"pggan bf16 at 64 px against float64: {e}")
    return rec


def v2_rate(torch, fn, warm: int = 1, reps: int = VICTIM_TIMED_STEPS
            ) -> float:
    """Calls of ``fn`` per second on the card, synchronised, after
    ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return reps / (time.perf_counter() - t0)


def v2_step_rates(torch) -> dict:
    """Train steps per second at the configs' batches on one seeded batch
    (iterations for VAE-GAN: four batches each); PGGAN at its top
    resolution in bfloat16 and in float32."""
    from ganleaks_tpu_torch.train import medgan, pggan, vaegan
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def images(b, res=RES):
        return torch.rand(b, 3, res, res, generator=gen,
                          device=DEVICE) * 2 - 1

    out = {}
    st, *_ = v2_state(torch, "vaegan", DEVICE, torch.float32)
    b = v2_config("vaegan").batch_size
    reals = [images(b) for _ in range(4)]
    out["vaegan_iterations_per_sec"] = v2_rate(
        torch, lambda: vaegan.vaegan_train_step(st, *reals, generator=gen))
    st, *_ = v2_state(torch, "medgan", DEVICE, torch.float32)
    rows = (torch.rand(v2_config("medgan").batch_size, TAB_D,
                       generator=gen, device=DEVICE) < 0.05).float()
    out["medgan_steps_per_sec"] = v2_rate(
        torch, lambda: medgan.medgan_train_step(st, rows, generator=gen))
    cfg = v2_config("pggan")
    real = images(cfg.batch_sizes[-1], cfg.image_size)
    for cdt in ("bfloat16", "float32"):
        st, *_ = v2_state(torch, "pggan", DEVICE, torch.float32)
        out[f"pggan_{cfg.image_size}px_{cdt}_steps_per_sec"] = v2_rate(
            torch, lambda: pggan.pggan_train_step(
                st, real, 1.0, V2_PGGAN_TOP, cfg.lambda_gp, cfg.drift, cdt,
                generator=gen))
    return out


def v2_subset(src: str, dst: str, n: int) -> str:
    """A directory holding links to the first ``n`` PNGs of ``src``."""
    os.makedirs(dst)
    for f in sorted(f for f in os.listdir(src) if f.endswith(".png"))[:n]:
        os.link(os.path.join(src, f), os.path.join(dst, f))
    return dst


def v2_vaegan(torch, tmp: str, dirs: dict, queries: dict) -> dict:
    """``train`` on the training PNGs for two epochs of eight iterations
    (a checkpoint after each), the same run stopped after one epoch and
    resumed, held against it within VICTIM_UPDATE_RTOL (cuDNN's backward
    is not deterministic, and Adam's sign-like steps carry its rounding:
    a second uninterrupted run is printed beside it); ``sample``; ``run_reconstruction_attack``
    with the trained ``netE`` / ``netG`` on the query sets, ``evaluate``."""
    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.reconstruction import \
        run_reconstruction_attack
    from ganleaks_tpu_torch.config import EvalConfig, ReconstructionConfig
    from ganleaks_tpu_torch.train import vaegan
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        kw = {"data_path": dirs["train"], "steps_per_epoch": 8,
              "checkpoint_every": 1, "num_samples": 2048}
        quiet = MetricsLogger(echo=False)
        init = v2_arrays(torch, v2_state(torch, "vaegan", "cpu",
                                         torch.float32)[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = vaegan.train(v2_config("vaegan", exp_name="full", nepoch=2,
                                      **kw), logger=quiet, device=DEVICE)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        again = vaegan.train(v2_config("vaegan", exp_name="again", nepoch=2,
                                       **kw), logger=quiet, device=DEVICE)
        vaegan.train(v2_config("vaegan", exp_name="resumed", nepoch=1, **kw),
                     logger=quiet, device=DEVICE)
        resumed = vaegan.train(v2_config("vaegan", exp_name="resumed",
                                         nepoch=2, **kw),
                               logger=quiet, device=DEVICE)
        a = v2_arrays(torch, full.nets())
        b = v2_arrays(torch, resumed.nets())
        params = [k for k in init if k not in v2_buffer_keys(full.nets())]
        resume_rel = rel_l2(b, a, init, params)
        rerun_rel = rel_l2(v2_arrays(torch, again.nets()), a, init, params)
        bit_exact = all(np.array_equal(a[k], b[k]) for k in a)
        t0 = time.perf_counter()
        vaegan.sample(v2_config("vaegan", exp_name="full", **kw), full,
                      os.path.join(tmp, "vaegan_samples"), device=DEVICE)
        sample_s = time.perf_counter() - t0
        gen = np.load(os.path.join(tmp, "vaegan_samples", "generated.npz"))
        noise, imgs = gen["noise"], gen["img_r01"]
        run = os.path.join(tmp, "results", "full")
        t0 = time.perf_counter()
        cfg = v2_config("vaegan")
        out = run_reconstruction_attack(ReconstructionConfig(
            pos_data_dir=queries["train"], neg_data_dir=queries["heldout"],
            netE=os.path.join(run, "netE.npz"),
            netG=os.path.join(run, "netG.npz"), z_dim=cfg.z_dim, d=cfg.d,
            reader="resize", distance="l2-lpips", batch=RECON_BATCH,
            save_plots=False, exp_name="vaegan2"), DEVICE)
        attack_s = time.perf_counter() - t0
        res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    finally:
        os.chdir(cwd)
    r = {"phase": "victim2", "victim": "vaegan", "iterations": full.step,
         "train_s": train_s, "resume_rel_l2": resume_rel,
         "rerun_rel_l2": rerun_rel, "resume_bit_exact": bit_exact, "sampled": len(noise),
         "sample_s": sample_s, "attack_s": attack_s, "auroc": res["auc"],
         "queries": 2 * V2_TRAIN_PNGS}
    emit(r)
    check(full.step == resumed.step == 16 and resumed.epoch == 2,
          f"vaegan: {full.step} / {resumed.step} iterations")
    check(resume_rel <= VICTIM_UPDATE_RTOL,
          f"vaegan: the resumed run is {resume_rel:.3g} (L2, relative to "
          f"its update) off the uninterrupted one")
    check(noise.shape == (2048, cfg.z_dim)
          and imgs.shape == (2048, RES, RES, 3)
          and bool(np.isfinite(imgs).all()),
          f"vaegan samples {noise.shape} {imgs.shape}")
    check(out["pos_loss"].shape == (V2_TRAIN_PNGS,)
          and bool(np.isfinite(out["pos_loss"]).all()
                   and np.isfinite(out["neg_loss"]).all()),
          "vaegan: the reconstruction attack's losses")
    return r


def v2_csv(path: str, rng) -> None:
    """TAB2_ROWS seeded binary records of TAB_D codes with a header row,
    one field in a thousand missing (an empty field)."""
    p = np.clip(rng.exponential(0.03, TAB_D), 0.001, 0.5)
    rows = np.where(rng.random((TAB2_ROWS, TAB_D)) < p, b"1", b"0")
    rows[rng.random(rows.shape) < 1e-3] = b""
    with open(path, "wb") as f:
        f.write(b",".join(f"c{i}".encode() for i in range(TAB_D)) + b"\n")
        f.write(b"\n".join(b",".join(r) for r in rows) + b"\n")


def v2_medgan(torch, tmp: str) -> dict:
    """``train`` from a seeded CSV (two pretrain and two GAN epochs at
    batch 2,000), ``generate`` 10,000 records, ``run_tabular_attack``
    ('pallas': K1 on the 3xTF32 tile, launches counted) with the CSV's own
    split as members and non-members, ``evaluate``."""
    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
    from ganleaks_tpu_torch.config import EvalConfig, TabularAttackConfig
    from ganleaks_tpu_torch.train import medgan
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    csv = os.path.join(tmp, "mimic.csv")
    t0 = time.perf_counter()
    v2_csv(csv, np.random.default_rng(SEED + 15))
    csv_s = time.perf_counter() - t0
    cfg = v2_config("medgan", DATASETPATH=csv, n_epochs=2,
                    n_epochs_pretrain=2, generate_N=TAB2_ROWS,
                    PATH=os.path.join(tmp, "medgan"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = medgan.train(cfg, logger=MetricsLogger(echo=False),
                         device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    syn = medgan.generate(cfg, state, device=DEVICE)
    gen_s = time.perf_counter() - t0
    reset_launches()
    out = run_tabular_attack(TabularAttackConfig(
        syn_data_path=os.path.join(cfg.PATH, "synthetic.npy"),
        dataset_csv=csv, engine="pallas",
        save_root=os.path.join(tmp, "fbb"), exp_name="medgan2"), DEVICE)
    launches = read_launches()
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    r = {"phase": "victim2", "victim": "medgan", "steps": state.step,
         "csv_write_s": csv_s, "train_s": train_s, "generate_s": gen_s,
         "synthetic": list(syn.shape), "ones_share": float(syn.mean()),
         "auroc": res["auc"], "kernel_launches": launches}
    emit(r)
    check(syn.shape == (TAB2_ROWS, TAB_D)
          and set(np.unique(syn)) <= {0.0, 1.0},
          f"medgan synthetic {syn.shape}")
    n_train = TAB2_ROWS - TAB2_ROWS // 10
    check(state.step == 2 * (n_train // cfg.batch_size),
          f"medgan: {state.step} GAN steps")
    check(bool(np.isfinite(out["pos_loss"]).all())
          and out["pos_nn_idx"].shape == (n_train,),
          "medgan: the tabular attack's losses")
    check(launches["knn_argmin.tf32x3"] > 0,
          f"medgan: the tabular attack did not launch K1 ({launches})")
    return r


def v2_pggan(torch, tmp: str, queries: dict) -> dict:
    """The progressive ``train`` at 4 -> 64 px (one epoch a resolution on
    V2_TRAIN_PNGS training PNGs: 8 batches of 32, the fade-in active,
    bfloat16, flips), ``generate`` 2,040 images, V2_PLANT training PNGs
    planted in the PNG dump, ``run_attack`` ('auto': K2 launches
    counted) with the training and held-out query sets, ``evaluate``."""
    import shutil

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import run_attack
    from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
    from ganleaks_tpu_torch.train import pggan
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    cfg = v2_config("pggan", data_path=queries["train"], num_epochs=1,
                    num_generated=2040, PATH=os.path.join(tmp, "model"),
                    PATH_syn_data=os.path.join(tmp, "syn"),
                    sample_grid_dir=os.path.join(tmp, "grids_pggan"))
    logger = MetricsLogger(os.path.join(tmp, "pggan.jsonl"), echo=False,
                           image_dir=cfg.sample_grid_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = pggan.train(cfg, logger=logger, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    logger.close()
    with open(os.path.join(tmp, "pggan.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    t0 = time.perf_counter()
    dirs = pggan.generate(cfg, state, run_dir="run", device=DEVICE)
    gen_s = time.perf_counter() - t0
    png = dirs["png_images"]
    fake = np.load(os.path.join(dirs["npz_images"],
                                "pggan_synthetic_data.npz"))["fake"]
    members = sorted(os.listdir(queries["train"]))
    for i, f in enumerate(members[:V2_PLANT]):
        shutil.copy(os.path.join(queries["train"], f),
                    os.path.join(png, f"image_{2040 + i}.png"))
    reset_launches()
    t0 = time.perf_counter()
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=queries["train"],
        neg_data_dir=queries["heldout"], data_num=V2_TRAIN_PNGS,
        distance="l2-lpips", resolution=cfg.image_size, engine="auto",
        save_root=os.path.join(tmp, "fbb"), exp_name="pggan2"),
        device=DEVICE)[0]
    attack_s = time.perf_counter() - t0
    launches = read_launches()
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    caught = int((out["pos_loss"] < out["neg_loss"].min()).sum())
    r = {"phase": "victim2", "victim": "pggan", "steps": state.step,
         "train_s": train_s, "resolutions": [x["resolution"] for x in recs],
         "final_alpha": recs[-1]["alpha"],
         "losses": {k: recs[-1][k] for k in ("loss_critic", "loss_gen")},
         "grids": len(os.listdir(cfg.sample_grid_dir)),
         "generate_s": gen_s, "generated": int(fake.shape[0]),
         "attack_s": attack_s, "planted": V2_PLANT,
         "members_below_all_nonmembers": caught, "auroc": res["auc"],
         "kernel_launches": launches}
    emit(r)
    check(r["resolutions"] == [4 * 2 ** s for s in range(V2_PGGAN_TOP + 1)]
          and state.step == (V2_PGGAN_TOP + 1)
          * -(-V2_TRAIN_PNGS // cfg.batch_sizes[-1])
          and all(np.isfinite(x["loss_critic"]) for x in recs),
          f"pggan: {state.step} steps, records {recs}")
    check(fake.shape == (2040, 3, cfg.image_size, cfg.image_size)
          and bool(np.isfinite(fake).all()),
          f"pggan artifacts {fake.shape}")
    check(caught >= V2_PLANT and res["auc"] > 0.5,
          f"pggan: {caught} members below every non-member")
    check(launches["tap_epilogue"] > 0,
          f"pggan: 'auto' did not launch K2 ({launches})")
    return r


def phase_victims2(torch, tmp: str, dirs: dict) -> dict:
    """Phase 13: VAE-GAN (d 64, z 100, 64 px, batch 64), medGAN (D =
    1,071 codes, latent 128, batch 2,000) and PGGAN (nz 512, in_channels
    512, 4 -> 64 px, batch 32, bfloat16) — the hold of their first steps,
    their entry points through to the attack each feeds, and step
    rates."""
    queries = {k: v2_subset(dirs[k], os.path.join(tmp, f"{k}_q"),
                            V2_TRAIN_PNGS) for k in ("train", "heldout")}
    out = {"queries": queries}
    for kind in ("vaegan", "medgan", "pggan"):
        t0 = time.perf_counter()
        out[f"{kind}_hold"] = v2_hold(torch, kind)
        out[f"{kind}_hold"]["seconds"] = time.perf_counter() - t0
    out["vaegan"] = v2_vaegan(torch, tmp, dirs, queries)
    out["medgan"] = v2_medgan(torch, tmp)
    out["pggan"] = v2_pggan(torch, tmp, queries)
    out["rates"] = v2_step_rates(torch)
    emit({"phase": "victim2_rates", **out["rates"],
          "hold_s": {k: out[f"{k}_hold"]["seconds"]
                     for k in ("vaegan", "medgan", "pggan")}})
    return out


# ---------------------------------------------------------------------------
# phase 14: the privGAN victims at full width
# ---------------------------------------------------------------------------

def priv_config(kind: str, **kw):
    from ganleaks_tpu_torch.config import DCGANConfig, PGGANConfig
    cls = DCGANConfig if kind == "privdcgan" else PGGANConfig
    return cls(seed=SEED, **kw)


def priv_pcfg(**kw):
    from ganleaks_tpu_torch.config import PrivGANConfig
    return PrivGANConfig(N_splits=PRIV_SPLITS, privacy_ratio=PRIV_RATIO,
                         **kw)


def priv_state(torch, kind: str, dev: str, dtype):
    """``kind``'s seeded state on ``dev`` in ``dtype`` (privPGGAN with
    every layer to 64 px) and its three nets by name."""
    from ganleaks_tpu_torch.train import priv
    if kind == "privdcgan":
        st = priv.build_privdcgan_state(priv_config(kind), priv_pcfg(), dev,
                                        dtype)
    else:
        st = priv.build_privpggan_state(priv_config(kind), priv_pcfg(), dev,
                                        dtype, PRIV_PGGAN_TOP)
    return st, {"gen": st.genS, "disc": st.discS, "priv": st.priv}


def priv_inputs(kind: str, res: int, n_steps: int) -> list:
    """``n_steps`` steps' seeded (S, B) batches at ``res`` px, noise, eps
    and target labels (uniform over the other splits), numpy."""
    from ganleaks_tpu_torch.io.native import LUT_CROP
    rng = np.random.default_rng(SEED + 16)
    s, b, nz = PRIV_SPLITS, PRIV_HOLD_BATCH, priv_config(kind).nz
    out = []
    for _ in range(n_steps):
        real = LUT_CROP[make_images(rng, s * b, res)].transpose(0, 3, 1, 2)
        r = rng.integers(0, s - 1, (s, b))
        out.append({"real": real.reshape(s, b, 3, res, res).copy(),
                    "noise": rng.standard_normal((s, b, nz)).astype(
                        np.float32),
                    "eps": rng.random((s, b, 1, 1, 1)).astype(np.float32),
                    "gen_y": r + (r >= np.arange(s)[:, None])})
    return out


def priv_steps(torch, kind: str, inputs: list, dps, dev: str, dtype,
               lr0: bool, res_steps: int = 1) -> dict:
    """The held steps of ``kind`` (gates ``dps``) on ``dev`` in ``dtype``,
    as ``v2_steps``: per step the losses and, at lr 0, every net's
    gradients and buffers; at the end every parameter and buffer."""
    from ganleaks_tpu_torch.train import priv
    st, nets = priv_state(torch, kind, dev, dtype)
    if lr0:
        for opt in (st.opt_gen, st.opt_disc, st.opt_priv):
            for group in opt.param_groups:
                group["lr"] = 0.0
    cfg = priv_config(kind)

    def t(a):
        return torch.from_numpy(a).to(dev, dtype)

    hist, grads, bufs = [], [], []
    t0 = time.perf_counter()
    for inp, dp in zip(inputs, dps):
        y = torch.from_numpy(inp["gen_y"]).to(dev)
        if kind == "privdcgan":
            m = priv.privdcgan_train_step(st, t(inp["real"]), PRIV_RATIO, dp,
                                          noise=t(inp["noise"]), gen_y=y)
        else:
            m = priv.privpggan_train_step(
                st, t(inp["real"]), V2_ALPHA, res_steps, PRIV_RATIO, dp,
                cfg.lambda_gp, cfg.drift, noise=t(inp["noise"]),
                eps=t(inp["eps"]), gen_y=y)
        hist.append([float(v) for v in m.values()])
        if lr0:
            grads.append(v2_arrays(torch, nets, grads=True))
            bufs.append({k: v for k, v in v2_arrays(torch, nets).items()
                         if k in v2_buffer_keys(nets)})
    if dev != "cpu":
        torch.cuda.synchronize()
    return {"losses": np.array(hist), "grads": grads, "bufs": bufs,
            "final": v2_arrays(torch, nets),
            "seconds": time.perf_counter() - t0}


def priv_hold(torch, kind: str) -> dict:
    """``kind``'s first steps at full width from the same seeded weights,
    batches and draws, at lr 0 and at the config's lr, with phase 12's
    bars (``victim_hold``, through ``v2_check_f64`` / ``v2_check_f32``;
    parameters within two of Adam's largest steps per update each net
    took, plus 0.01 lr of float32 rounding).

    privDCGAN: PRIV_DP's three steps (the classifier's gate off, then
    on), batch PRIV_HOLD_BATCH per split at 64 px, on the CPU in float64
    and on the card in each of HOLD_VARIANTS; every net's BatchNorm
    statistics are among the held buffers (each generator's advanced
    twice a step, the classifier's by its own update only), and the
    per-convolution gradient table is printed as phase 12's. privPGGAN:
    one step with the gate on at 8 px on the CPU in float64 against the
    card's float64 and float32 (the CPU's float64 at 64 px would take
    minutes), then one at 64 px, the card's float32 against its float64."""
    dcgan_kind = kind == "privdcgan"
    cfg = priv_config(kind)
    dps = PRIV_DP if dcgan_kind else (True,)
    inputs = priv_inputs(kind, RES if dcgan_kind else 8, len(dps))
    _, nets = priv_state(torch, kind, "cpu", torch.float64)
    init = v2_arrays(torch, nets)
    lrs = dict.fromkeys(nets, cfg.lr)
    betas = (cfg.beta1, cfg.beta2) if dcgan_kind else (0.0, 0.99)
    updates = {"gen": len(dps), "disc": len(dps), "priv": sum(dps)}
    bound = {n: 2 * sum(adam_ratio_bound(*betas, t)
                        for t in range(1, k + 1)) + 0.01
             for n, k in updates.items()}

    def runs(dev, dtype, inp=inputs, res_steps=1):
        return {m: priv_steps(torch, kind, inp, dps, dev, dtype, m == "lr0",
                              res_steps) for m in ("lr0", "trained")}

    ref = runs("cpu", torch.float64)
    variants = (HOLD_VARIANTS if dcgan_kind else
                (("f32", "float32", False, True),
                 ("f64", "float64", False, True)))
    errs, card_s, by_conv = {}, {}, {}
    for label, dtype, tf32, cudnn in variants:
        with Numerics(torch, tf32, cudnn):
            card = runs(DEVICE, getattr(torch, dtype))
        errs[label] = v2_errors(card, ref, init, nets, lrs)
        card_s[label] = card["trained"]["seconds"]
        if label in CONV_TABLE_VARIANTS and dcgan_kind:
            by_conv[label] = grad_by_conv(card["lr0"], ref["lr0"], init)
        if label == "f32":
            card_losses = card["trained"]["losses"].tolist()
    rec = {"phase": "privgan_hold", "victim": kind, "splits": PRIV_SPLITS,
           "batch_per_split": PRIV_HOLD_BATCH, "gates": list(dps),
           "resolution": RES if dcgan_kind else 8, "lr": cfg.lr,
           "betas": list(betas), "param_bound_lr": bound,
           "errors_vs_cpu_f64": errs, "losses_card_f32": card_losses,
           "losses_f64": ref["trained"]["losses"].tolist(),
           "card_s": card_s, "cpu_f64_s": ref["trained"]["seconds"]}
    if not dcgan_kind:
        top = priv_inputs(kind, RES, 1)
        hi = {k: runs(DEVICE, dt, top, PRIV_PGGAN_TOP) for k, dt in
              (("f64", torch.float64), ("f32", torch.float32))}
        rec["top_resolution"] = RES
        rec["top_errors_f32_vs_f64"] = v2_errors(hi["f32"], hi["f64"], init,
                                                 nets, lrs)
        rec["top_losses"] = {k: v["trained"]["losses"].tolist()
                             for k, v in hi.items()}
    emit(rec)
    if by_conv:
        rec["grad_by_conv"] = emit_conv_table(kind, by_conv)
    v2_check_f64(kind, errs["f64"], "the card's float64")
    v2_check_f32(kind, errs["f32"], bound, "the card's float32")
    if not dcgan_kind:
        v2_check_f32(kind, rec["top_errors_f32_vs_f64"], bound,
                     "64 px float32")
    moved = max(float(np.abs(ref["trained"]["final"][k] - init[k]).max())
                for k in init if k not in v2_buffer_keys(nets))
    check(moved > 0.5 * cfg.lr,
          f"{kind}: the steps barely moved the weights ({moved:.3g})")
    return rec


def priv_statistics(torch) -> dict:
    """On the card in float32, one privDCGAN step with the gate off: each
    generator's running statistics are those of two train-mode forwards
    on the step's noise (within PRIV_STAT_RTOL of the change, L2), and
    the generator step's train-mode classifier forwards leave its buffers
    bit for bit."""
    import copy

    from ganleaks_tpu_torch.train import priv
    st, _ = priv_state(torch, "privdcgan", DEVICE, torch.float32)
    inp = priv_inputs("privdcgan", RES, 1)[0]
    noise = torch.from_numpy(inp["noise"]).to(DEVICE)
    gens = {n: copy.deepcopy(st.genS[0]) for n in ("once", "twice")}
    with torch.no_grad():
        for n, g in gens.items():
            for _ in range(1 if n == "once" else 2):
                g(noise[0])
    before = {k: v.clone() for k, v in st.priv.named_buffers()}

    def stats(m):
        return {k: v.double().cpu().numpy() for k, v in m.named_buffers()}

    init = stats(st.genS[0])
    priv.privdcgan_train_step(
        st, torch.from_numpy(inp["real"]).to(DEVICE), PRIV_RATIO, False,
        noise=noise, gen_y=torch.from_numpy(inp["gen_y"]).to(DEVICE))
    got = stats(st.genS[0])
    rec = {"phase": "privgan_statistics",
           "gen_vs_two_forwards": rel_l2(got, stats(gens["twice"]), init,
                                         list(init)),
           "gen_vs_one_forward": rel_l2(got, stats(gens["once"]), init,
                                        list(init)),
           "classifier_buffers_bit_for_bit": all(
               torch.equal(v, before[k]) for k, v in
               st.priv.named_buffers())}
    emit(rec)
    check(rec["classifier_buffers_bit_for_bit"],
          "privdcgan: the generator step moved the classifier's statistics")
    check(rec["gen_vs_two_forwards"] <= PRIV_STAT_RTOL
          < rec["gen_vs_one_forward"],
          f"privdcgan: the generators' statistics did not advance twice "
          f"({rec})")
    return rec


def priv_attack(torch, kind: str, png: str, n_gen: int, queries: dict,
                n_q: int, plant: int, tmp: str) -> dict:
    """``plant`` of split 0's training PNGs (the first of the sorted
    training set) copied into the PNG dump, ``run_attack`` ('auto': K2
    launches counted) with the training and held-out PNGs as members and
    non-members, ``evaluate``; every planted member must lie below every
    non-member."""
    import shutil

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import run_attack
    from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
    members = sorted(f for f in os.listdir(queries["train"])
                     if f.endswith(".png"))[:n_q // PRIV_SPLITS]
    for i, f in enumerate(members[:plant]):
        shutil.copy(os.path.join(queries["train"], f),
                    os.path.join(png, f"image_{n_gen + i}.png"))
    reset_launches()
    t0 = time.perf_counter()
    out = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=queries["train"],
        neg_data_dir=queries["heldout"], data_num=n_q, distance="l2-lpips",
        resolution=RES, engine="auto", save_root=os.path.join(tmp, "fbb"),
        exp_name=kind), device=DEVICE)[0]
    attack_s = time.perf_counter() - t0
    launches = read_launches()
    res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
    caught = int((out["pos_loss"] < out["neg_loss"].min()).sum())
    check(bool(np.isfinite(out["pos_loss"]).all()
               and np.isfinite(out["neg_loss"]).all()),
          f"{kind}: non-finite attack losses")
    check(caught >= plant and res["auc"] > 0.5,
          f"{kind}: {caught} members below every non-member, AUROC "
          f"{res['auc']:.4f}")
    check(launches["tap_epilogue"] > 0,
          f"{kind}: 'auto' did not launch K2 ({launches})")
    return {"planted": plant, "attack_s": attack_s,
            "query_pairs_per_sec": out["query_pairs_per_sec"],
            "members_below_all_nonmembers": caught, "auroc": res["auc"],
            "kernel_launches": launches}


def priv_run(torch, kind: str, tmp: str, queries: dict) -> dict:
    """``kind`` through its entry points on the card: ``train_priv*`` on
    the training PNGs (2 splits; privDCGAN 2 epochs at batch 32 with the
    gate opening in the second, privPGGAN 4 -> 64 px one epoch a
    resolution at batch 32 with flips, the gate from 8 px), then
    ``generate_priv*`` 2,040 images from split 0 as the triplet under the
    JAX package's ``privDCGAN`` / ``privPGGAN`` roots, then
    :func:`priv_attack`."""
    from ganleaks_tpu_torch.train import priv
    from ganleaks_tpu_torch.utils.logging import MetricsLogger
    dcgan_kind = kind == "privdcgan"
    n_q = len([f for f in os.listdir(queries["train"])
               if f.endswith(".png")])
    common = dict(data_path=queries["train"], num_generated=PRIV_GENERATED,
                  PATH=os.path.join(tmp, "model"),
                  PATH_syn_data=os.path.join(tmp, "syn"))
    if dcgan_kind:
        cfg = priv_config(kind, batch_size=PRIV_DCGAN_BATCH,
                          num_epochs=PRIV_DCGAN_EPOCHS, **common)
        pcfg = priv_pcfg(dp_delay=0, disc_epochs=1)
        train, generate = priv.train_privdcgan, priv.generate_privdcgan
    else:
        cfg = priv_config(kind, num_epochs=1, **common)
        pcfg = priv_pcfg(dp_delay=PRIV_PGGAN_DP_DELAY, disc_epochs=1)
        train, generate = priv.train_privpggan, priv.generate_privpggan
    log = os.path.join(tmp, f"{kind}.jsonl")
    logger = MetricsLogger(log, echo=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(cfg, pcfg, logger=logger, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    logger.close()
    with open(log) as f:
        recs = [json.loads(ln) for ln in f]
    t0 = time.perf_counter()
    dirs = generate(cfg, pcfg, state, run_dir="run", device=DEVICE)
    gen_s = time.perf_counter() - t0
    prefix = "dcgan" if dcgan_kind else "pggan"
    fake = np.load(os.path.join(dirs["npz_images"],
                                f"{prefix}_synthetic_data.npz"))["fake"]
    noise = np.load(os.path.join(dirs["npz_noise"],
                                 f"{prefix}_noise.npz"))["noise"]
    per_split = n_q // PRIV_SPLITS
    if dcgan_kind:
        want_steps = PRIV_DCGAN_EPOCHS * (per_split // PRIV_DCGAN_BATCH)
        gates = [r["loss_dp"] > 0 for r in recs]
        want_gates = [e > 0 for e in range(PRIV_DCGAN_EPOCHS)]
    else:
        want_steps = (PRIV_PGGAN_TOP + 1) * (per_split // cfg.batch_sizes[-1])
        gates = [r["loss_dp"] > 0 for r in recs]
        want_gates = [4 * 2 ** s >= PRIV_PGGAN_DP_DELAY
                      for s in range(PRIV_PGGAN_TOP + 1)]
    r = {"phase": "privgan", "victim": kind, "train_images": n_q,
         "splits": PRIV_SPLITS, "steps": state.step, "train_s": train_s,
         "records": recs, "generate_s": gen_s,
         "generated": int(fake.shape[0]),
         "root": os.path.relpath(dirs["png_images"], cfg.PATH_syn_data)}
    check(state.step == want_steps and gates == want_gates
          and all(np.isfinite(v) for rec in recs for k, v in rec.items()
                  if k.startswith("loss")),
          f"{kind}: {state.step} steps (want {want_steps}), gates {gates} "
          f"(want {want_gates}), records {recs}")
    check(fake.shape == (PRIV_GENERATED, 3, RES, RES)
          and bool(np.isfinite(fake).all())
          and noise.shape == (PRIV_GENERATED, cfg.nz, 1, 1)
          and len(os.listdir(dirs["png_images"])) == PRIV_GENERATED
          and r["root"] == os.path.join(
              "privDCGAN" if dcgan_kind else "privPGGAN", "png_images",
              "run"),
          f"{kind}: artifacts {fake.shape} {noise.shape} under {r['root']}")
    r.update(priv_attack(torch, kind, dirs["png_images"], PRIV_GENERATED,
                         queries, n_q, PRIV_PLANT[kind], tmp))
    emit(r)
    return r


def priv_rates(torch, known: dict) -> dict:
    """Train steps per second on the card in float32, synchronised, after
    a warm-up step, on one seeded batch per split: privDCGAN at
    PRIV_RATE_BATCHES per split and DCGAN at the first of them, privPGGAN
    and PGGAN at 64 px, batch 32 (a split); ``known``: phases 12-13's
    rates, printed beside them."""
    from ganleaks_tpu_torch.train import dcgan, pggan, priv
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def images(*shape):
        return torch.rand(*shape, generator=gen, device=DEVICE) * 2 - 1

    out = dict(known)
    for b in PRIV_RATE_BATCHES:
        st, _ = priv_state(torch, "privdcgan", DEVICE, torch.float32)
        real = images(PRIV_SPLITS, b, 3, RES, RES)
        out[f"privdcgan_b{b}_steps_per_sec"] = v2_rate(
            torch, lambda: priv.privdcgan_train_step(
                st, real, PRIV_RATIO, True, generator=gen))
    b = PRIV_RATE_BATCHES[0]
    st = dcgan.build_state(priv_config("privdcgan"), DEVICE)
    real = images(b, 3, RES, RES)
    out[f"dcgan_b{b}_steps_per_sec"] = v2_rate(
        torch, lambda: dcgan.dcgan_train_step(st, real, generator=gen))
    cfg = priv_config("privpggan")
    b = cfg.batch_sizes[-1]
    st, _ = priv_state(torch, "privpggan", DEVICE, torch.float32)
    real = images(PRIV_SPLITS, b, 3, RES, RES)
    out["privpggan_64px_steps_per_sec"] = v2_rate(
        torch, lambda: priv.privpggan_train_step(
            st, real, 1.0, PRIV_PGGAN_TOP, PRIV_RATIO, True, cfg.lambda_gp,
            cfg.drift, generator=gen))
    emit({"phase": "privgan_rates", **out})
    return out


def phase_privgan(torch, tmp: str, dirs: dict, queries: dict,
                  known_rates: dict) -> dict:
    """Phase 14: privDCGAN (nz 100, ngf / ndf 64, 64 px) on phase 12's
    1,024 training PNGs and privPGGAN (nz 512, in_channels 512, 4 -> 64
    px, float32) on phase 13's 256, each with 2 splits: the holds of their
    first steps, the statistics discipline, the entry points through to
    the attack, and step rates."""
    out = {}
    for kind in ("privdcgan", "privpggan"):
        t0 = time.perf_counter()
        out[f"{kind}_hold"] = priv_hold(torch, kind)
        out[f"{kind}_hold"]["seconds"] = time.perf_counter() - t0
    out["statistics"] = priv_statistics(torch)
    out["privdcgan"] = priv_run(torch, "privdcgan", tmp, dirs)
    out["privpggan"] = priv_run(torch, "privpggan", tmp, queries)
    out["rates"] = priv_rates(torch, known_rates)
    return out


# ---------------------------------------------------------------------------
# phase 15: the pipeline from the split to AUROC at the split's default size
# ---------------------------------------------------------------------------

def celeba_images(rng, n: int) -> np.ndarray:
    """``n`` seeded 178x218 CelebA-sized images: a 28x23 random layout
    upsampled 8x and cropped, plus pixel noise (uint8 NHWC)."""
    base = rng.integers(0, 256, (n, 28, 23, 3), dtype=np.int16)
    up = base.repeat(8, 1).repeat(8, 2)[:, :218, :178]
    noise = rng.integers(-8, 9, up.shape, dtype=np.int16)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def celeba_sources(tmp: str) -> dict:
    """A synthetic CelebA: PIPE_MEMBER_IDS identities of exactly
    PIPE_SAME_ID images (the member pool) and PIPE_PUBLIC_IDS of
    PIPE_PUBLIC_PER_ID, their files numbered in a seeded shuffled order,
    written as JPEGs by Pillow (on threads), with ``<identity>
    <filename>`` annotations in file order."""
    from concurrent.futures import ThreadPoolExecutor

    import PIL.Image
    rng = np.random.default_rng(SEED + 15)
    owners = ([f"m{i:04d}" for i in range(PIPE_MEMBER_IDS)
               for _ in range(PIPE_SAME_ID)]
              + [f"p{i:04d}" for i in range(PIPE_PUBLIC_IDS)
                 for _ in range(PIPE_PUBLIC_PER_ID)])
    owners = [owners[i] for i in rng.permutation(len(owners))]
    names = [f"{i + 1:06d}.jpg" for i in range(len(owners))]
    src = os.path.join(tmp, "img_align_celeba")
    os.makedirs(src)
    t0 = time.perf_counter()

    def save(item):
        name, arr = item
        PIL.Image.fromarray(arr).save(os.path.join(src, name), quality=90)

    with ThreadPoolExecutor(16) as pool:
        for lo in range(0, len(names), 512):
            imgs = celeba_images(rng, min(512, len(names) - lo))
            list(pool.map(save, zip(names[lo:lo + 512], imgs)))
    ann = os.path.join(tmp, "identities_ann.txt")
    with open(ann, "w") as f:
        f.writelines(f"{o} {n}\n" for o, n in zip(owners, names))
    emit({"phase": "pipeline_sources", "jpegs": len(names),
          "identities": PIPE_MEMBER_IDS + PIPE_PUBLIC_IDS,
          "seconds": time.perf_counter() - t0})
    return {"src": src, "ann": ann, "owners": owners, "names": names}


def split_check(src: dict, dirs: dict) -> dict:
    """The split's directories against the sources: the file names,
    PIPE_CHECK sampled PNGs per directory bit for bit against their crop of
    the JPEG decode (the ``_a1`` crops at the draws of ``default_rng(seed)``
    made member by member, x then y), every pack against its sorted PNGs.
    The expected member and non-member lists are rebuilt here from the
    annotations (identities in first-appearance order)."""
    import PIL.Image

    from ganleaks_tpu_torch.io.native import decode_exact, decode_png
    per_id: dict = {}
    for o, n in zip(src["owners"], src["names"]):
        per_id.setdefault(o, []).append(n)
    want = PIPE_IMAGES // 3
    members = [n for ns in per_id.values() if len(ns) == PIPE_SAME_ID
               for n in ns][:want]
    public = [n for ns in per_id.values() if len(ns) < PIPE_SAME_ID
              for n in ns][:want]
    draw = np.random.default_rng(SEED)
    a1_at = {}
    for n in members:
        x = int(draw.integers(0, 178 - 128))
        y = int(draw.integers(0, 218 - 128))
        a1_at[n.split(".")[0]] = (y, x)
    stems = {"train": sorted(f"{n.split('.')[0]}{s}" for n in members
                             for s in ("", "_a1", "_a2")),
             "pos": sorted(n.split(".")[0] for n in members),
             "neg": sorted(n.split(".")[0] for n in public)}
    rng = np.random.default_rng(SEED + 16)
    out = {}
    for key, d in dirs.items():
        files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        check(files == [s + ".png" for s in stems[key]],
              f"pipeline split: {key} holds {len(files)} PNGs, not the "
              f"{len(stems[key])} expected names")
        for f in rng.choice(files, PIPE_CHECK, replace=False):
            stem = f[:-4]
            base = stem.split("_")[0]
            with PIL.Image.open(os.path.join(src["src"],
                                             base + ".jpg")) as im:
                raw = np.asarray(im)
            crop = raw[121 - 64:121 + 64, 89 - 64:89 + 64]
            if stem.endswith("_a1"):
                y, x = a1_at[base]
                ref = raw[y:y + 128, x:x + 128]
            else:
                ref = crop[:, ::-1] if stem.endswith("_a2") else crop
            check(np.array_equal(decode_png(os.path.join(d, f)), ref),
                  f"pipeline split: {key}/{f} differs from its crop of "
                  f"{base}.jpg")
        pack = np.load(os.path.join(d, f"_packed_{key}.npy"))
        pngs, other = decode_exact([os.path.join(d, f) for f in files], 128)
        check(other.size == 0 and np.array_equal(pack, pngs),
              f"pipeline split: _packed_{key}.npy differs from its sorted "
              f"PNGs")
        out[key] = len(files)
    check(len(members) == want and len(public) == want,
          f"pipeline split: {len(members)} members, {len(public)} "
          f"non-members expected")
    return out


def phase_pipeline(torch, tmp: str, north_plan: dict) -> dict:
    """Phase 15: the reference study's first steps at the split's default
    size — a synthetic CelebA, ``cli.split`` (10,020 images, 30 a member
    identity) and its check, DCGAN at full width for one epoch at batch
    128 on the 128-px training PNGs (the reader resizes them),
    ``generate`` 10,000 images, PIPE_PLANT positive PNGs planted, the
    'auto' attack with the positive and negative directories as members
    and non-members (K2's launches counted), ``evaluate``; the plots where
    matplotlib imports; ``tools.profile_attack`` at its defaults ('auto');
    ``tools.hbm_projection`` at phase 10's configuration and budget,
    which must give phase 10's plan."""
    import contextlib
    import io
    import shutil

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import run_attack
    from ganleaks_tpu_torch.cli import split
    from ganleaks_tpu_torch.config import (AttackConfig, DCGANConfig,
                                           EvalConfig)
    from ganleaks_tpu_torch.tools import hbm_projection, profile_attack
    from ganleaks_tpu_torch.train import dcgan
    t_phase = time.perf_counter()
    sec = {}
    src = celeba_sources(tmp)
    dirs = {k: os.path.join(tmp, k) for k in ("train", "pos", "neg")}
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counts = split.main([
            f"identity_annotations={src['ann']}", f"input_dir={src['src']}",
            f"output_dir0={dirs['train']}", f"output_dir1={dirs['pos']}",
            f"output_dir2={dirs['neg']}", f"num_images={PIPE_IMAGES}",
            f"num_same_id={PIPE_SAME_ID}", f"seed={SEED}"])
    sec["split_s"] = time.perf_counter() - t0
    check(counts == {"members": PIPE_IMAGES // 3,
                     "non_members": PIPE_IMAGES // 3},
          f"pipeline split: {counts} ({buf.getvalue().strip()})")
    t0 = time.perf_counter()
    files = split_check(src, dirs)
    sec["split_check_s"] = time.perf_counter() - t0
    emit({"phase": "pipeline_split", "printed": buf.getvalue().strip(),
          **counts, "files": files, "seconds": sec["split_s"],
          "check_seconds": sec["split_check_s"]})

    cfg = DCGANConfig(data_path=dirs["train"], batch_size=PIPE_BATCH,
                      num_epochs=1, seed=SEED, image_size=RES,
                      num_generated=PIPE_GENERATED,
                      PATH=os.path.join(tmp, "model"),
                      PATH_syn_data=os.path.join(tmp, "syn"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = dcgan.train(cfg, device=DEVICE)
    torch.cuda.synchronize()
    sec["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_dirs = dcgan.generate(cfg, state, run_dir="run", device=DEVICE)
    sec["generate_s"] = time.perf_counter() - t0
    png = out_dirs["png_images"]
    fake = np.load(os.path.join(out_dirs["npz_images"],
                                "dcgan_synthetic_data.npz"))["fake"]
    check(state.step == -(-files["train"] // PIPE_BATCH)
          and fake.shape == (PIPE_GENERATED, 3, RES, RES)
          and bool(np.isfinite(fake).all())
          and len(os.listdir(png)) == PIPE_GENERATED,
          f"pipeline DCGAN: {state.step} steps, {fake.shape} samples, "
          f"{len(os.listdir(png))} PNGs")
    members = sorted(f for f in os.listdir(dirs["pos"])
                     if f.endswith(".png"))
    for i, f in enumerate(members[:PIPE_PLANT]):
        shutil.copy(os.path.join(dirs["pos"], f),
                    os.path.join(png, f"image_{PIPE_GENERATED + i}.png"))

    reset_launches()
    t0 = time.perf_counter()
    res = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=dirs["pos"],
        neg_data_dir=dirs["neg"], distance="l2-lpips", resolution=RES,
        engine="auto", save_root=os.path.join(tmp, "fbb"),
        exp_name="pipeline"), device=DEVICE)[0]
    sec["attack_s"] = time.perf_counter() - t0
    launches = read_launches()
    plan = res["plan"]
    n_q, n_s = files["pos"] + files["neg"], PIPE_GENERATED + PIPE_PLANT
    taps = 5  # VGG16's taps: one K2 launch each per featurised block
    want = taps * (-(-n_q // plan["q_block"])
                   + plan["sweeps"] * -(-n_s // plan["s_block"]))
    for name, n in launches.items():
        w = want if name == "tap_epilogue" else 0
        check(n == w, f"pipeline attack: {name} launched {n} times, want "
                      f"{w} (plan {plan})")
    roc = evaluate(EvalConfig(result_load_dir=res["save_dir"]))
    caught = int((res["pos_loss"][:PIPE_PLANT] < res["neg_loss"].min())
                 .sum())
    check(bool(np.isfinite(res["pos_loss"]).all()
               and np.isfinite(res["neg_loss"]).all())
          and caught == PIPE_PLANT,
          f"pipeline attack: {caught} of {PIPE_PLANT} planted members "
          f"below every non-member")
    emit({"phase": "pipeline", "train_images": files["train"],
          "batch": PIPE_BATCH, "steps": state.step,
          "generated": PIPE_GENERATED, "planted": PIPE_PLANT,
          "n_pos": files["pos"], "n_neg": files["neg"],
          "ingest_s": res["ingest_s"],
          "query_pairs_per_sec": res["query_pairs_per_sec"],
          "plan": {k: plan[k] for k in ("q_block", "s_block", "sweeps")},
          "planted_below_all_nonmembers": caught, "auroc": roc["auc"],
          "kernel_launches": launches, **sec})

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        emit({"phase": "pipeline_plots", "plots": "matplotlib absent",
              "note": "host-side helper, not the device path"})
    else:
        from ganleaks_tpu_torch.attack.viz import (visualize_gt,
                                                   visualize_samples)
        from ganleaks_tpu_torch.io.native import decode_exact
        gt = decode_exact([os.path.join(dirs["pos"], f)
                           for f in members[:10]], 128)[0]
        paths = [visualize_samples(fake[:64].transpose(0, 2, 3, 1), tmp),
                 visualize_gt(gt / 127.5 - 1.0, tmp)]
        check(all(os.path.getsize(p) > 0 for p in paths),
              f"pipeline plots: {paths}")
        emit({"phase": "pipeline_plots", "plots": paths})

    t0 = time.perf_counter()
    prof = profile_attack.profile(
        engine="auto", device=DEVICE,
        emit=lambda rec: emit({"phase": "pipeline_profile", **rec}))
    sec["profile_s"] = time.perf_counter() - t0
    p = prof["profile"]
    check(p["launches_counted"]["tap_epilogue"] > 0
          and p["launches_profiled"]["tap_epilogue"]
          == p["launches_counted"]["tap_epilogue"],
          f"pipeline profile: the profiler saw {p['launches_profiled']} "
          f"launches, the counters {p['launches_counted']}")
    e2e = prof["end_to_end"]

    t0 = time.perf_counter()
    proj = hbm_projection.project(
        2 * NS_POS, NS_SYN, RES, engine="auto", store="uint8",
        q_block=NS_BLOCK, s_block=NS_BLOCK,
        capacity_bytes=north_plan["capacity_bytes"])
    sec["projection_s"] = time.perf_counter() - t0
    got = {k: proj[k] for k in ("cache_bytes", "s_block", "q_block",
                                "sweeps")}
    check(got == {k: north_plan[k] for k in got},
          f"pipeline projection: {got}, phase 10 planned {north_plan}")
    sec["phase_s"] = time.perf_counter() - t_phase
    r = {"phase": "pipeline_summary", "auroc": roc["auc"],
         "profile_projected_s": e2e["projected_s"],
         "profile_measured_s": e2e["measured_s"],
         "profile_gap_s": e2e["gap_s"],
         "profile_idle_share": p["idle_share"],
         "profile_k2_launches": p["launches_counted"]["tap_epilogue"],
         "profile_top_kernels": [[k["name"], k["launches"], k["total_ms"]]
                                 for k in p["kernels"][:5]],
         "projection": got,
         "projection_capacity_bytes": north_plan["capacity_bytes"], **sec}
    emit(r)
    return r


# ---------------------------------------------------------------------------
# phase 16: the attack on ranks (parallel/knn_shard through attack_arrays)
# ---------------------------------------------------------------------------

RANKS = 2           # ranks of the gloo launch, all on cuda:0
RANK_LAUNCH_S = 600
# (label, layout, engine, two_pass, extra config, phase 5's run of the
# same search on one process)
RANK_RUNS = [
    ("sharded_auto", "sharded", "auto", False, {}, "auto"),
    ("sharded_pallas", "sharded", "pallas", False, {}, "pallas"),
    ("sharded_pallas_two_pass", "sharded", "pallas", True, {},
     "pallas_two_pass"),
    ("ring_auto", "ring", "auto", False, {}, "auto"),
    ("ring_taps_bf16", "ring", "taps", False, BF16, "taps_bf16"),
]
# the same search twice: the second shows what a fresh process's first
# cuDNN calls cost the first
NCCL_RUNS = [("nccl_sharded_auto", "sharded", "auto", False, {}, "auto"),
             ("nccl_sharded_auto_again", "sharded", "auto", False, {},
              "auto")]
# the kernels each rank runs per search (K1 and K3 per tile, K2)
RANK_WANT = {
    "sharded_auto": ("tap_epilogue",),
    "sharded_pallas": ("knn_argmin.tf32x3",),
    "sharded_pallas_two_pass": ("knn_topk.wgmma", "knn_argmin.tf32x3"),
    "ring_auto": ("tap_epilogue",),
    "ring_taps_bf16": ("tap_epilogue", "knn_argmin.wgmma"),
    "nccl_sharded_auto": ("tap_epilogue",),
    "nccl_sharded_auto_again": ("tap_epilogue",),
}
TAPS = 5  # VGG16's LPIPS taps: K2 launches per featurised block


def rank_attacks(paths: dict, runs: list, base: dict, device: str) -> dict:
    """On each rank of a launch: ``attack_arrays`` on the group's mesh
    for every run (each rank's launches counted from 0, the ranks lined
    up by a barrier first); returns, from rank 0, each run's results and
    every rank's launches, seconds, plan and shard."""
    import torch
    import torch.distributed as dist

    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    from ganleaks_tpu_torch.parallel.multihost import local_device

    mesh = pmesh.mesh_of(local_device())

    def sync() -> None:
        if device == "cuda":
            torch.cuda.synchronize()

    pos, neg, syn = (np.load(paths[k])["images"] for k in ("pos", "neg",
                                                          "syn"))
    out = {"mesh": {"size": mesh.size, "backend": mesh.backend,
                    "share": mesh.share, "device": str(mesh.device)}}
    for label, layout, engine, two_pass, extra, _ in runs:
        cfg = AttackConfig(exp_name=f"ranks_{label}", engine=engine,
                           two_pass=two_pass, shard_layout=layout,
                           **{**base, **extra})
        sync()
        reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        r = attack_arrays(cfg, syn, pos, neg, device=device, mesh=mesh)
        sync()
        call_s = time.perf_counter() - t0
        n_q = len(pos) + len(neg)
        q_rows = pmesh.shard_rows(n_q, mesh, cfg.query_block)
        s_rows = pmesh.shard_rows(len(syn), mesh, cfg.syn_block)
        ranks = pmesh.gather_objects({
            "rank": mesh.rank, "launches": read_launches(), "call_s": call_s,
            "search_s": n_q * len(syn) / r["query_pairs_per_sec"],
            "plan": r["plan"], "oom_resumes": r["oom_resumes"],
            "featurize_s": r["featurize_s"], "fold_s": r["fold_s"],
            "q_rows": q_rows, "s_rows": s_rows, **r["ranks"]}, mesh)
        out[label] = {"idx": np.concatenate([r["pos_nn_idx"],
                                             r["neg_nn_idx"]]),
                      "loss": np.concatenate([r["pos_loss"],
                                              r["neg_loss"]]),
                      "fallbacks": r.get("two_pass_fallbacks"),
                      "ranks": ranks}
    return out


def rank_want_launches(label: str, rank: dict, n_q: int, size: int) -> dict:
    """The launches the plan gives one rank: K2 per featurised block
    (its shares of the query blocks, or its query shard's blocks on the
    ring, then its home synthetic blocks per sweep), K1 per synthetic
    block on the sharded 'pallas' search and per hop holding rows on the
    ring, K3 per synthetic block of two-pass's pass 1; None where the
    count depends on the data (two-pass's re-rank)."""
    plan = rank["plan"]
    qb, sb, sweeps = plan["q_block"], plan["s_block"], plan["sweeps"]
    s_local = rank["s_rows"][1] - rank["s_rows"][0]
    s_blocks = sweeps * -(-s_local // sb)
    if label.startswith("ring"):
        q_blocks = -(-rank["q_rows"][2] // qb)
    else:  # each query block's share of this rank, where it holds rows
        per = -(-qb // size)
        q_blocks = sum(1 for qs in range(0, n_q, qb)
                       if qs + rank["rank"] * per < n_q)
    want = {}
    if "tap_epilogue" in RANK_WANT[label]:
        want["tap_epilogue"] = TAPS * (q_blocks + s_blocks)
    if label == "sharded_pallas":
        want["knn_argmin.tf32x3"] = s_blocks
    if label == "sharded_pallas_two_pass":
        want["knn_topk.wgmma"] = s_blocks
        want["knn_argmin.tf32x3"] = None
    if label == "ring_taps_bf16":
        # every hop of every home step folds a block holding rows
        want["knn_argmin.wgmma"] = sweeps * size * -(-rank["s_rows"][2]
                                                     // sb)
    return want


def hold_rank_run(torch, label: str, got: dict, single: dict, embed,
                  data: dict, cfg, smi: str) -> dict:
    """One rank run against its one-process run of phase 5: the indices
    (where they differ, both picks' float64 distances within the engine's
    bar of each other: a near-tie), every loss within the engine's bar of
    its pair's float64 distance, every planted member below every
    non-member, each rank's launches against the plan."""
    idx, loss = got["idx"], got["loss"]
    mm = idx != single["idx"]
    d64, norms = single["d64"].copy(), single["norms"].copy()
    if mm.any():  # the float64 distances of the picks that differ
        d64[mm], rq, rs = pair_distances(torch, embed, data["queries"][mm],
                                         data["syn"], idx[mm], DEVICE)
        norms[mm] = rq + rs
    bounded = "eps" in single  # bf16 or int8 single pass: bounded error
    if bounded:
        eps = single["eps"].copy()
        if mm.any():
            eps[mm] = cert_error_bound(torch, cfg, rq, rs,
                                       cfg.engine == "taps-int8")[0]
        bar = eps
        near = eps + single["eps"]
    else:
        bar = TOL * norms
        near = 2.0 * TOL * np.maximum(norms, single["norms"])
    gap = np.abs(d64 - single["d64"])
    check(bool((gap[mm] <= near[mm]).all()),
          f"ranks {label}: {int(mm.sum())} index mismatches with the "
          f"one-process run, not all near-ties")
    err = np.abs(loss - d64)
    check(bool((err <= bar).all()),
          f"ranks {label}: losses off float64 by up to "
          f"{float((err / bar).max()):.3g} x the engine's bar")
    n_pos = N_POS
    check(float(loss[:n_pos].max()) < float(loss[n_pos:].min()),
          f"ranks {label}: a planted member's loss "
          f"{float(loss[:n_pos].max()):.4g} not below every non-member's "
          f"{float(loss[n_pos:].min()):.4g}")
    size = len(got["ranks"])
    launches = []
    for r, rank in enumerate(got["ranks"]):
        check(rank["oom_resumes"] == 0,
              f"ranks {label}: rank {r} resumed {rank['oom_resumes']} OOMs")
        want = rank_want_launches(label, rank, len(idx), size)
        for name, n in rank["launches"].items():
            if name not in RANK_WANT[label]:
                check(n == 0, f"ranks {label}: rank {r} launched {name} "
                              f"{n} times")
            elif want.get(name) is None:
                check(n > 0, f"ranks {label}: rank {r} never launched "
                             f"{name}")
            else:
                check(n == want[name], f"ranks {label}: rank {r} launched "
                                       f"{name} {n} times, the plan "
                                       f"{want[name]}")
        launches.append(rank["launches"])
    single_s = len(idx) * N_SYN / single["out"]["query_pairs_per_sec"]
    record = {
        "phase": "ranks", "run": label, "card": smi, "ranks": size,
        "backend": got["ranks"][0]["backend"],
        "layout": got["ranks"][0]["layout"],
        "index_mismatches": int(mm.sum()),
        "max_loss_diff_vs_one_process": float(
            np.abs(loss - single["loss"]).max()),
        "max_err_over_bar": float((err / bar).max()),
        "two_pass_fallbacks": got["fallbacks"],
        "kernel_launches_per_rank": launches,
        "search_s_per_rank": [r["search_s"] for r in got["ranks"]],
        "call_s_per_rank": [r["call_s"] for r in got["ranks"]],
        "one_process_search_s": single_s,
        "featurize_s_per_rank": [r["featurize_s"] for r in got["ranks"]],
        "fold_s_per_rank": [r["fold_s"] for r in got["ranks"]],
        "staging_s_per_rank": [r["staging_s"] for r in got["ranks"]],
        "staged_gb_per_rank": [r["staged_bytes"] / 1e9
                               for r in got["ranks"]],
        "collective_s_per_rank": [r["collective_s"]
                                  for r in got["ranks"]],
        "collectives_per_rank": [r["collectives"] for r in got["ranks"]],
        "plan_rank0": got["ranks"][0]["plan"]}
    emit(record)
    return record


def phase_ranks(torch, data: dict, single: dict, smi: str) -> dict:
    """Phase 16: phase 5's sets through ``attack_arrays`` on a mesh — one
    ``launch`` of ``RANKS`` ranks on cuda:0 over ``gloo`` (its collectives
    staged through host memory) running every ``RANK_RUNS`` search, one
    NCCL launch at world size 1, then ``dryrun_multichip`` on two ranks
    of the card; each run held against its one-process run of phase 5."""
    from dataclasses import replace

    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.dryrun import dryrun_multichip
    from ganleaks_tpu_torch.parallel.multihost import launch

    base = dict(resolution=RES, distance="l2-lpips", lpips_net="vgg",
                dtype="float32", query_block=2048, syn_block=2048,
                two_pass_k=TOPK_K, save_plots=False)
    embed = build_embed_fn(AttackConfig(distance="l2-lpips",
                                        dtype="float32"), DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks plan from what the card has
    seconds = {}
    results = {}
    nccl = "nccl" if DEVICE == "cuda" else "gloo"
    for name, n, runs, backend in (("gloo", RANKS, RANK_RUNS, "gloo"),
                                   ("nccl", 1, NCCL_RUNS, nccl)):
        t0 = time.perf_counter()
        out = launch(rank_attacks, n, data["paths"], runs, base, DEVICE,
                     devices=[f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE]
                     * n, backend=backend, timeout_s=RANK_LAUNCH_S)
        seconds[f"launch_{name}_s"] = time.perf_counter() - t0
        check(out["mesh"]["backend"] == backend and out["mesh"]["size"] == n
              and out["mesh"]["share"] == n,
              f"ranks: the {name} launch ran on {out['mesh']}")
        for label, layout, engine, two_pass, extra, ref in runs:
            cfg = AttackConfig(engine=engine, two_pass=two_pass,
                               **{**base, **extra})
            if engine == "auto":
                cfg = replace(cfg, engine="taps-int8", **BF16)
            results[label] = hold_rank_run(torch, label, out[label],
                                           single[ref], embed, data, cfg,
                                           smi)
    t0 = time.perf_counter()
    dry = dryrun_multichip(RANKS, device=DEVICE, timeout_s=RANK_LAUNCH_S)
    seconds["dryrun_s"] = time.perf_counter() - t0
    emit({"phase": "ranks", "run": "dryrun_multichip", "card": smi, **dry,
          **seconds})
    return results


# ---------------------------------------------------------------------------
# phase 17: the trainers' layouts on ranks (parallel/dp and parallel/ep)
# ---------------------------------------------------------------------------

TRAIN_RANK_S = 600         # each phase-17 launch's limit
TRAIN_RANK_STEPS = 3       # timed steps per trainer, after a warm-up step
# (label, victim, compute dtype) of the data-parallel runs on two ranks
TRAIN_RANK_RUNS = (("dcgan", "dcgan", "float32"),
                   ("wgangp", "wgangp", "float32"),
                   ("vaegan", "vaegan", "float32"),
                   ("medgan", "medgan", "float32"),
                   ("pggan_f32", "pggan", "float32"),
                   ("pggan_bf16", "pggan", "bfloat16"))
# (label, victim, the classifier's gate) of the expert-parallel runs, 2
# steps each: with the gate off EP computes the all-splits step; with it
# on the classifier normalises (privPGGAN: its minibatch std) each rank's
# fakes alone, so that run is held on its losses and its updates printed
EP_RANK_RUNS = (("privdcgan", "privdcgan", False),
                ("privpggan", "privpggan", False),
                ("privpggan_gate_on", "privpggan", True))
EP_GATE_ON_LOSS_RTOL = V2_TRAJ_RTOL["privpggan"]
EP_RANK_STEPS = 2
RANK_TRAJ_RTOL = {"dcgan": VICTIM_TRAJ_RTOL["dcgan"],
                  "wgangp": VICTIM_TRAJ_RTOL["wgangp"], **V2_TRAJ_RTOL}


def tr_config(kind: str, dtype: str):
    """The config of a phase-17 run: phases 12-13's widths and batches
    (DCGAN / WGAN-GP nz 100, ngf / ndf 64, batch 128; VAE-GAN batch 64;
    medGAN 1,071 codes, batch 2,000; PGGAN to 64 px, batch 32)."""
    from ganleaks_tpu_torch.config import DCGANConfig, WGANGPConfig
    if kind == "dcgan":
        return DCGANConfig(seed=SEED, batch_size=VICTIM_BATCH)
    if kind == "wgangp":
        return WGANGPConfig(seed=SEED, batch_size=VICTIM_BATCH,
                            critic_iter=5)
    if kind == "pggan":
        return v2_config(kind, compute_dtype=dtype)
    return v2_config(kind)


def tr_state(torch, kind: str, cfg, dev: str):
    """``kind``'s seeded state on ``dev`` (float32 parameters), its nets by
    name, the optimisers its steps use and each net's updates a step."""
    from ganleaks_tpu_torch.train import dcgan, wgangp
    if kind in ("dcgan", "wgangp"):
        st = (dcgan if kind == "dcgan" else wgangp).build_state(cfg, dev)
        iters = 1 if kind == "dcgan" else cfg.critic_iter
        return (st, {"gen": st.gen, "disc": st.disc},
                [st.opt_gen, st.opt_disc], {"gen": 1, "disc": iters})
    return v2_state(torch, kind, dev, torch.float32)


def tr_batches(kind: str, cfg, step: int) -> list:
    """Step ``step``'s seeded global batches (numpy): NCHW images in
    [-1, 1] (VAE-GAN's four), or medGAN's binary records."""
    from ganleaks_tpu_torch.io.native import LUT_CROP
    rng = np.random.default_rng(SEED + 1700 + step)
    batch = (cfg.batch_sizes[-1] if kind == "pggan" else cfg.batch_size)
    if kind == "medgan":
        return [(rng.random((batch, TAB_D)) < 0.1).astype(np.float32)]
    return [LUT_CROP[make_images(rng, batch, RES)].transpose(0, 3, 1, 2)
            .copy() for _ in range(4 if kind == "vaegan" else 1)]


def tr_step(torch, kind: str, cfg, state, batches, gen, dp):
    """One step of ``kind`` on the global ``batches`` (device tensors):
    data-parallel on this rank's shares with ``dp``, else on one device.
    Returns the global batch's losses."""
    from ganleaks_tpu_torch.train import dcgan, medgan, pggan, vaegan
    from ganleaks_tpu_torch.train import wgangp
    if kind == "dcgan":
        fn, kw = dcgan.dcgan_train_step, {}
    elif kind == "wgangp":
        fn, kw = wgangp.wgangp_train_step, dict(
            critic_iter=cfg.critic_iter, lambda_gp=cfg.lambda_gp)
    elif kind == "vaegan":
        fn, kw = vaegan.vaegan_train_step, {}
    elif kind == "medgan":
        fn, kw = medgan.medgan_train_step, {}
    else:
        fn, kw = pggan.pggan_train_step, dict(
            alpha=V2_ALPHA, steps=V2_PGGAN_TOP, lambda_gp=cfg.lambda_gp,
            drift=cfg.drift, compute_dtype=cfg.compute_dtype)
    m = dcgan.run_step(dp, fn, state, batches, generator=gen, **kw)
    if dp is not None:
        m = dp.metrics(m)
    return [float(v) for v in m.values()]


def tr_run(torch, kind: str, cfg, dev: str, dp_mesh=None) -> dict:
    """A warm-up step, then TRAIN_RANK_STEPS timed ones (synchronised), of
    ``kind`` from its seeded state on the same batches and draws: on the
    mesh ``dp_mesh`` (data-parallel) or on one device. Returns the losses,
    every parameter and buffer (float64, host), steps/s and the mesh's
    collective seconds and staged bytes a timed step."""
    import torch.distributed as dist

    from ganleaks_tpu_torch.parallel.dp import DataParallel
    st, nets, opts, updates = tr_state(torch, kind, cfg, dev)
    dp = None if dp_mesh is None else DataParallel(dp_mesh, nets.values(),
                                                   opts)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    batches = [[torch.from_numpy(b).to(dev) for b in tr_batches(kind, cfg,
                                                                 i)]
               for i in range(1 + TRAIN_RANK_STEPS)]
    losses = [tr_step(torch, kind, cfg, st, batches[0], gen, dp)]
    torch.cuda.synchronize()
    if dp is not None:
        dist.barrier()
        before = dict(dp_mesh.stats)
    t0 = time.perf_counter()
    for b in batches[1:]:
        losses.append(tr_step(torch, kind, cfg, st, b, gen, dp))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {"losses": np.array(losses), "final": v2_arrays(torch, nets),
           "steps_per_sec": TRAIN_RANK_STEPS / secs, "updates": updates,
           "betas": {n: o.param_groups[0]["betas"]
                     for n, o in zip(nets, opts)},
           "lrs": {n: o.param_groups[0]["lr"] for n, o in zip(nets, opts)},
           "buffers": sorted(v2_buffer_keys(nets))}
    if dp is not None:
        out["per_step"] = {k: (dp_mesh.stats[k] - before[k])
                           / TRAIN_RANK_STEPS for k in before}
        dp.close()
    return out


def tr_errors(got: dict, ref: dict, init: dict, steps: int) -> dict:
    """A run against a reference run from the same state: losses
    (relative, absolute below 1), each net's update and the buffers'
    change (L2, relative), each net's largest parameter difference in
    its lr, and the bound two runs of Adam can part by there (twice the
    most each of its steps can move a weight, ``adam_ratio_bound``)."""
    bufs = set(ref["buffers"])
    params = [k for k in init if k not in bufs]
    nets = got["lrs"]

    def keys(net):
        return [k for k in params if k.split(".")[0] == net]

    moved = [k for k in bufs if np.abs(ref["final"][k] - init[k]).max() > 0]
    fc, fr = got["final"], ref["final"]
    return {
        "loss": float((np.abs(got["losses"] - ref["losses"])
                       / np.maximum(np.abs(ref["losses"]), 1.0)).max()),
        "update": {n: rel_l2(fc, fr, init, keys(n)) for n in nets},
        "buffers": rel_l2(fc, fr, init, moved) if moved else 0.0,
        "max_param_diff_lr": {n: max(float(np.abs(fc[k] - fr[k]).max())
                                     for k in keys(n)) / got["lrs"][n]
                              for n in nets},
        "param_bound_lr": {n: 2 * sum(adam_ratio_bound(
            *got["betas"][n], t) for t in range(
                1, got["updates"][n] * steps + 1)) for n in nets}}


def rank_trainers(dirs: dict, tmp: str) -> dict:
    """On each rank of phase 17's launch: every TRAIN_RANK_RUNS trainer
    data-parallel (rank 0 then runs it on its own, the one-process
    reference, while the others wait), the EP_RANK_RUNS expert-parallel
    steps (rank 0 then the all-splits reference), and ``dcgan.train`` +
    ``generate`` on the group (rank 0 samples). Returns, from rank 0,
    every run's errors, digests, rates and collective figures."""
    import torch
    import torch.distributed as dist

    from ganleaks_tpu_torch.device import set_f32_numerics
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    from ganleaks_tpu_torch.parallel.multihost import local_device

    set_f32_numerics()
    dev = local_device()
    mesh = pmesh.mesh_of(dev, axis="data")
    out = {"mesh": {"size": mesh.size, "backend": mesh.backend,
                    "share": mesh.share}}
    for label, kind, dtype in TRAIN_RANK_RUNS:
        cfg = tr_config(kind, dtype)
        got = tr_run(torch, kind, cfg, dev, mesh)
        rec = {"digests": pmesh.gather_objects(hashlib_of(got["final"]),
                                               mesh),
               "rates": pmesh.gather_objects(got["steps_per_sec"], mesh),
               "per_step": pmesh.gather_objects(got["per_step"], mesh)}
        if mesh.is_main:  # one process's run, and again: cuDNN's own spread
            init = v2_arrays(torch, tr_state(torch, kind, cfg, "cpu")[1])
            ref = tr_run(torch, kind, cfg, dev)
            again = tr_run(torch, kind, cfg, dev)
            rec.update(one_process_steps_per_sec=ref["steps_per_sec"],
                       errors=tr_errors(got, ref, init,
                                        1 + TRAIN_RANK_STEPS),
                       one_process_repeat=tr_errors(again, ref, init,
                                                    1 + TRAIN_RANK_STEPS),
                       losses=got["losses"].tolist())
            del init, ref, again
        dist.barrier()
        out[label] = rec
        del got
        torch.cuda.empty_cache()
    for label, kind, dp_on in EP_RANK_RUNS:
        out[label] = ep_rank_run(torch, kind, dp_on, mesh)
        dist.barrier()
        torch.cuda.empty_cache()
    out["ep_rate"] = ep_rank_rate(torch, mesh)
    dist.barrier()
    out["train"] = rank_train_run(torch, dirs, tmp, mesh)
    return out


def hashlib_of(arrays: dict) -> str:
    import hashlib
    h = hashlib.sha1()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(arrays[k].tobytes())
    return h.hexdigest()


def ep_rank_run(torch, kind: str, dp_on: bool, mesh) -> dict:
    """EP_RANK_STEPS expert-parallel steps of ``kind`` (one split a rank,
    phase 14's widths and held inputs: batch 8 a split, 64 px) and the
    all-splits steps on rank 0 on the same inputs: the losses, every
    split's nets' and the classifier's errors, and every rank's digest of
    the classifier."""
    from ganleaks_tpu_torch.parallel import ep
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    dev = mesh.device
    res_steps = 1 if kind == "privdcgan" else PRIV_PGGAN_TOP
    inputs = priv_inputs(kind, RES, EP_RANK_STEPS)
    st, _ = priv_state(torch, kind, dev, torch.float32)
    st = ep.shard_split_state(st, mesh)
    cfg = priv_config(kind)
    if kind == "privdcgan":
        step = ep.make_ep_privdcgan_step(mesh, PRIV_SPLITS, PRIV_RATIO, dp_on)
    else:
        step = ep.make_ep_privpggan_step(mesh, PRIV_SPLITS, PRIV_RATIO, dp_on,
                                         res_steps, cfg.lambda_gp, cfg.drift)

    def t(a):
        return torch.from_numpy(a).to(dev)

    losses = []
    torch.cuda.synchronize()
    before = dict(mesh.stats)
    t0 = time.perf_counter()
    for inp in inputs:
        draws = {"noise": t(inp["noise"]), "gen_y": t(inp["gen_y"])}
        if kind == "privdcgan":
            m = step(st, t(inp["real"]), **draws)
        else:
            m = step(st, t(inp["real"]), V2_ALPHA, eps=t(inp["eps"]),
                     **draws)
        losses.append([float(v) for v in m.values()])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    mine = {k: v.astype(np.float32) for k, v in v2_arrays(torch, {
        f"gen.{mesh.rank}": st.genS[0],
        f"disc.{mesh.rank}": st.discS[0]}).items()}
    splits = pmesh.gather_objects(mine, mesh)
    priv_digests = pmesh.gather_objects(
        hashlib_of(v2_arrays(torch, {"priv": st.priv})), mesh)
    per_step = {k: (mesh.stats[k] - before[k]) / EP_RANK_STEPS
                for k in before}
    rec = {"priv_digests": priv_digests, "seconds": secs,
           "collective_s_per_step": per_step["collective_s"],
           "staged_bytes_per_step": per_step["staged_bytes"]}
    if not mesh.is_main:
        return rec
    ref = priv_steps(torch, kind, inputs, [dp_on] * EP_RANK_STEPS, dev,
                     torch.float32, False, res_steps)
    got = {k: v.astype(np.float64) for s in splits for k, v in s.items()}
    got.update(v2_arrays(torch, {"priv": st.priv}))
    _, nets = priv_state(torch, kind, "cpu", torch.float32)
    init = v2_arrays(torch, nets)
    bufs = v2_buffer_keys(nets)
    lrs = {"gen": cfg.lr, "disc": cfg.lr, "priv": cfg.lr}
    betas = ((cfg.beta1, cfg.beta2) if kind == "privdcgan" else (0.0, 0.99))
    errs = tr_errors(
        {"losses": np.array(losses), "final": got, "lrs": lrs,
         "betas": dict.fromkeys(lrs, betas),
         "updates": dict.fromkeys(lrs, 1)},
        {"losses": ref["losses"], "final": ref["final"],
         "buffers": sorted(bufs)}, init, EP_RANK_STEPS)
    rec.update(errors=errs, losses=losses, one_process_s=ref["seconds"],
               priv_moved=max(float(np.abs(got[k] - init[k]).max())
                              for k in init if k.startswith("priv.")))
    return rec


def ep_rank_rate(torch, mesh) -> dict:
    """EP privDCGAN's steps/s a rank at phase 14's rate batch (128 a
    split, the gate on), a warm-up step then TRAIN_RANK_STEPS timed, and
    on rank 0 the all-splits step's likewise (one process runs the
    splits one after another)."""
    import torch.distributed as dist

    from ganleaks_tpu_torch.parallel import ep
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    from ganleaks_tpu_torch.train import priv
    dev, b = mesh.device, PRIV_RATE_BATCHES[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    real = torch.rand(PRIV_SPLITS, b, 3, RES, RES, generator=gen,
                      device=dev) * 2 - 1
    st = ep.shard_split_state(priv_state(torch, "privdcgan", dev,
                                         torch.float32)[0], mesh)
    step = ep.make_ep_privdcgan_step(mesh, PRIV_SPLITS, PRIV_RATIO, True)
    step(st, real, generator=gen)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(TRAIN_RANK_STEPS):
        step(st, real, generator=gen)
    torch.cuda.synchronize()
    out = {"batch_per_split": b, "ep_steps_per_sec": pmesh.gather_objects(
        TRAIN_RANK_STEPS / (time.perf_counter() - t0), mesh)}
    if mesh.is_main:
        one, _ = priv_state(torch, "privdcgan", dev, torch.float32)
        out["all_splits_steps_per_sec"] = v2_rate(
            torch, lambda: priv.privdcgan_train_step(
                one, real, PRIV_RATIO, True, generator=gen),
            reps=TRAIN_RANK_STEPS)
    return out


def rank_train_run(torch, dirs: dict, tmp: str, mesh) -> dict:
    """``dcgan.train`` with ``mesh_shape=(2,)`` one epoch at batch 128 on
    phase 12's training PNGs, then ``generate`` on rank 0; every rank's
    checkpoint files."""
    import torch.distributed as dist

    from ganleaks_tpu_torch.config import DCGANConfig
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    from ganleaks_tpu_torch.train import dcgan
    written = []
    real_save = dcgan.save_state_dict

    def counting(path, net):
        written.append(os.path.basename(path))
        real_save(path, net)

    dcgan.save_state_dict = counting
    cfg = DCGANConfig(data_path=dirs["train"], batch_size=VICTIM_BATCH,
                      num_epochs=1, seed=SEED, mesh_shape=(mesh.size,),
                      PATH=os.path.join(tmp, "model17"),
                      PATH_syn_data=os.path.join(tmp, "syn17"),
                      sample_grid_dir=None)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = dcgan.train(cfg, device=mesh.device.type)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        dcgan.save_state_dict = real_save
    out = {"written": pmesh.gather_objects(sorted(written), mesh),
           "steps": state.step, "train_s": train_s,
           "digests": pmesh.gather_objects(hashlib_of(v2_arrays(
               torch, {"gen": state.gen, "disc": state.disc})), mesh)}
    if mesh.is_main:
        t0 = time.perf_counter()
        out["dirs"] = dcgan.generate(cfg, state, run_dir="run",
                                     device=mesh.device.type)
        out["generate_s"] = time.perf_counter() - t0
        out["num_generated"] = cfg.num_generated
    dist.barrier()
    return out


def nccl_dp_step() -> dict:
    """One rank over NCCL: the DCGAN data-parallel steps at full width on
    an explicit mesh of size 1 (its collectives cross NCCL on the card)
    against the same steps on one device."""
    import torch

    from ganleaks_tpu_torch.device import set_f32_numerics
    from ganleaks_tpu_torch.parallel import mesh as pmesh
    from ganleaks_tpu_torch.parallel.multihost import local_device

    set_f32_numerics()
    dev = local_device()
    mesh = pmesh.mesh_of(dev, axis="data")
    cfg = tr_config("dcgan", "float32")
    got = tr_run(torch, "dcgan", cfg, dev, mesh)
    ref = tr_run(torch, "dcgan", cfg, dev)
    _, nets, _, _ = tr_state(torch, "dcgan", cfg, dev)
    return {"mesh": {"size": mesh.size, "backend": mesh.backend},
            "errors": tr_errors(got, ref, v2_arrays(torch, nets),
                                1 + TRAIN_RANK_STEPS),
            "steps_per_sec": got["steps_per_sec"],
            "one_process_steps_per_sec": ref["steps_per_sec"],
            "per_step": got["per_step"]}


def check_rank_errors(label: str, kind: str, dtype: str, err: dict) -> None:
    """Phases 12-13's bars for a trained run (float32, or PGGAN's bf16),
    here against one process's run."""
    traj = V2_BF16_TRAJ if dtype == "bfloat16" else RANK_TRAJ_RTOL[kind]
    update = V2_BF16_UPDATE if dtype == "bfloat16" else VICTIM_UPDATE_RTOL
    check(err["loss"] <= traj,
          f"train_ranks {label}: losses off one process's by "
          f"{err['loss']:.3g} (bar {traj})")
    check(max(*err["update"].values(), err["buffers"]) <= update,
          f"train_ranks {label}: updates {err['update']} / buffers "
          f"{err['buffers']:.3g} off one process's (bar {update})")
    check(all(err["max_param_diff_lr"][n] <= err["param_bound_lr"][n]
              for n in err["param_bound_lr"]),
          f"train_ranks {label}: parameters {err['max_param_diff_lr']} lr "
          f"off one process's, over Adam's {err['param_bound_lr']}")


def phase_train_ranks(torch, tmp: str, dirs: dict, smi: str) -> dict:
    """Phase 17: the trainers on two ranks of the card over ``gloo`` (one
    ``launch``: the five victims data-parallel at their configs' widths,
    PGGAN in float32 and bf16, against one process; EP privDCGAN and
    privPGGAN against the all-splits step; ``train`` + ``generate`` of
    DCGAN), the attack of that DCGAN's samples ('auto': K2), and one NCCL
    rank's data-parallel DCGAN steps."""
    import shutil

    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import run_attack
    from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
    from ganleaks_tpu_torch.parallel.multihost import launch
    t_phase = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    dev0 = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
    t0 = time.perf_counter()
    out = launch(rank_trainers, RANKS, dirs, tmp, devices=[dev0] * RANKS,
                 backend="gloo", timeout_s=TRAIN_RANK_S)
    launch_s = time.perf_counter() - t0
    check(out["mesh"] == {"size": RANKS, "backend": "gloo", "share": RANKS},
          f"train_ranks: the launch ran on {out['mesh']}")
    for label, kind, dtype in TRAIN_RANK_RUNS:
        r = out[label]
        check(len(set(r["digests"])) == 1,
              f"train_ranks {label}: the replicas differ across ranks")
        check_rank_errors(label, kind, dtype, r["errors"])
        emit({"phase": "train_ranks", "run": label, "card": smi,
              "ranks": RANKS, "backend": "gloo",
              "steps_per_sec_per_rank": r["rates"],
              "one_process_steps_per_sec": r["one_process_steps_per_sec"],
              "collective_s_per_step": [p["collective_s"]
                                        for p in r["per_step"]],
              "staging_s_per_step": [p["staging_s"] for p in r["per_step"]],
              "staged_bytes_per_step": [p["staged_bytes"]
                                        for p in r["per_step"]],
              "collectives_per_step": [p["collectives"]
                                       for p in r["per_step"]],
              "errors_vs_one_process": r["errors"],
              "one_process_repeat": r["one_process_repeat"],
              "losses": r["losses"]})
    for label, kind, dp_on in EP_RANK_RUNS:
        r = out[label]
        check(len(set(r["priv_digests"])) == 1,
              f"train_ranks EP {label}: the classifier's replicas differ")
        if dp_on:  # the classifier's local statistics: losses held alone
            check(r["errors"]["loss"] <= EP_GATE_ON_LOSS_RTOL
                  and r["priv_moved"] > 0,
                  f"train_ranks EP {label}: {r['errors']}")
        else:
            check_rank_errors(f"EP {label}", kind, "float32", r["errors"])
        emit({"phase": "train_ranks", "run": f"ep_{label}", "card": smi,
              "splits": PRIV_SPLITS, "dp_on": dp_on,
              "seconds": r["seconds"], "one_process_s": r["one_process_s"],
              "collective_s_per_step": r["collective_s_per_step"],
              "staged_bytes_per_step": r["staged_bytes_per_step"],
              "errors_vs_all_splits": r["errors"], "losses": r["losses"],
              "classifier_moved": r["priv_moved"]})
    emit({"phase": "train_ranks", "run": "ep_rate", "card": smi,
          **out["ep_rate"]})
    tr = out["train"]
    check(tr["written"][0] == ["discriminator.pth", "generator.pth"]
          and all(w == [] for w in tr["written"][1:]),
          f"train_ranks: checkpoint writes per rank {tr['written']}")
    check(len(set(tr["digests"])) == 1 and tr["steps"] == -(
        -VICTIM_TRAIN // VICTIM_BATCH),
          f"train_ranks: train() on ranks gave {tr['steps']} steps, "
          f"digests {tr['digests']}")
    png = tr["dirs"]["png_images"]
    n_gen = tr["num_generated"]
    check(len(os.listdir(png)) == n_gen,
          f"train_ranks: {len(os.listdir(png))} PNGs of {n_gen}")
    members = sorted(f for f in os.listdir(dirs["train"])
                     if f.endswith(".png"))
    for i, f in enumerate(members[:VICTIM_PLANT]):
        shutil.copy(os.path.join(dirs["train"], f),
                    os.path.join(png, f"image_{n_gen + i}.png"))
    reset_launches()
    t0 = time.perf_counter()
    att = run_attack(AttackConfig(
        syn_data_path=png, pos_data_dir=dirs["train"],
        neg_data_dir=dirs["heldout"], data_num=VICTIM_TRAIN,
        distance="l2-lpips", resolution=RES, engine="auto",
        save_root=os.path.join(tmp, "fbb17"), exp_name="dcgan_ranks"),
        device=DEVICE)[0]
    attack_s = time.perf_counter() - t0
    launches = read_launches()
    res = evaluate(EvalConfig(result_load_dir=att["save_dir"]))
    caught = int((att["pos_loss"] < att["neg_loss"].min()).sum())
    emit({"phase": "train_ranks", "run": "train_generate_attack",
          "card": smi, "ranks": RANKS, "steps": tr["steps"],
          "train_s": tr["train_s"], "generate_s": tr["generate_s"],
          "written_per_rank": tr["written"], "attack_s": attack_s,
          "auroc": res["auc"], "members_below_all_nonmembers": caught,
          "kernel_launches": launches})
    check(caught >= VICTIM_PLANT and res["auc"] > 0.5,
          f"train_ranks: the planted members were not found ({caught} "
          f"below every non-member, AUROC {res['auc']:.4f})")
    check(launches["tap_epilogue"] > 0,
          "train_ranks: 'auto' did not launch K2")
    nccl = "nccl" if DEVICE == "cuda" else "gloo"
    t0 = time.perf_counter()
    nc = launch(nccl_dp_step, 1, devices=[dev0], backend=nccl,
                timeout_s=TRAIN_RANK_S)
    nccl_s = time.perf_counter() - t0
    check(nc["mesh"] == {"size": 1, "backend": nccl},
          f"train_ranks: the NCCL launch ran on {nc['mesh']}")
    check_rank_errors("nccl dcgan", "dcgan", "float32", nc["errors"])
    rec = {"phase": "train_ranks", "run": "nccl_dcgan", "card": smi,
           "steps_per_sec": nc["steps_per_sec"],
           "one_process_steps_per_sec": nc["one_process_steps_per_sec"],
           "collective_s_per_step": nc["per_step"]["collective_s"],
           "collectives_per_step": nc["per_step"]["collectives"],
           "errors_vs_one_process": nc["errors"], "launch_gloo_s": launch_s,
           "launch_nccl_s": nccl_s,
           "phase_s": time.perf_counter() - t_phase}
    emit(rec)
    return {"launches": launches, **rec}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from ganleaks_tpu_torch.device import set_f32_numerics
        from ganleaks_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the ganleaks_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    set_f32_numerics()

    smi = nvidia_smi_line()
    build_s = cuda_build.build_all()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": {name: [ln.strip() for ln in
                           cuda_build.build_log(name).splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name in cuda_build.SOURCES}})

    phase_s = {}
    clock = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        phase_s[name] = now - clock
        clock = now

    k1_err = phase_kernel(torch)
    lap("kernel")
    k3_err = phase_topk(torch)
    lap("topk")
    k2_err = phase_epilogue(torch)
    lap("epilogue")
    with tempfile.TemporaryDirectory() as tmp:
        data = attack_data(tmp)
        launches, single = phase_attack(torch, data)
        lap("attack")
        phase_attack_towers(torch, data)
        lap("attack_towers")
        phase_ranks(torch, data, single, smi)
        lap("ranks")
        del data, single
    t_k1 = {name: timing_k1(torch, dt) for name, dt in
            (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
    t_k3 = {name: timing_k3(torch, dt) for name, dt in
            (("bfloat16", torch.bfloat16), ("float32", torch.float32))}
    t_k2 = {mode: timing_k2(torch, mode) for mode in ("bf16_int8", "f32")}
    for net in ("alex", "squeeze"):
        for mode in ("bf16_int8", "f32"):
            timing_k2(torch, mode, net)
    lap("timing")
    phase_scores(torch)
    lap("scores")
    phase_train(torch)
    lap("train")
    phase_fid(torch)
    lap("fid")
    with tempfile.TemporaryDirectory() as tmp:
        phase_reconstruction(torch, tmp)
        lap("reconstruction")
        tab = phase_tabular(torch, tmp)
        lap("tabular")
    north = phase_north_star(torch)
    lap("north_star")
    with tempfile.TemporaryDirectory() as tmp:
        phase_ingest(torch, north.pop("data"), north.pop("auto"), tmp)
        lap("ingest")
    with tempfile.TemporaryDirectory() as tmp:
        victims = phase_victims(torch, tmp)
        lap("victims")
        v2 = phase_victims2(torch, tmp, victims["dirs"])
        lap("victims2")
        phase_privgan(torch, tmp, victims["dirs"], v2["queries"], {
            "dcgan_b128_steps_per_sec": victims["dcgan"]["steps_per_sec"],
            "pggan_64px_float32_steps_per_sec":
                v2["rates"]["pggan_64px_float32_steps_per_sec"]})
        lap("privgan")
        phase_train_ranks(torch, tmp, victims["dirs"], smi)
        lap("train_ranks")
    with tempfile.TemporaryDirectory() as tmp:
        phase_pipeline(torch, tmp, north["plan"])
        lap("pipeline")
    emit({"phase": "seconds", "build_s": build_s, **phase_s})

    # launches: each kernel's count in the run of the path it serves — K1
    # on the 3xTF32 tile in the float32 engine='pallas' run, K1 on the wgmma
    # tile in phase 10's bf16 'taps' run at 20,000 x 100,000 (the recipe
    # 'auto' degrades to), K3 on the wgmma tile in the two-pass run on
    # that engine (pass 1 on bf16 embeddings), K3 on the 3xTF32 tile in the
    # float32 top-k search, K2 in phase 10's engine='auto' run (taps-int8
    # on a bf16 tower: the main path on the card at the north star); the
    # timed rows are phase 6's block shapes and types
    k1_src = ("ganleaks_tpu_torch/csrc/knn_argmin.cu",
              "ganleaks_tpu/ops/knn_pallas.py:269")
    k3_src = ("ganleaks_tpu_torch/csrc/knn_topk.cu",
              "ganleaks_tpu/ops/knn_pallas.py:340")
    rows = [
        ("knn_argmin.tf32x3", *k1_src,
         launches["pallas"]["knn_argmin.tf32x3"],
         max(k1_err["float32"], t_k1["float32"]["max_abs_err"],
             tab["held"]["max_abs_err"]),
         t_k1["float32"]),
        ("knn_argmin.wgmma", *k1_src,
         north["launches"]["taps_bf16"]["knn_argmin.wgmma"],
         max(k1_err["bfloat16"], t_k1["bfloat16"]["max_abs_err"]),
         t_k1["bfloat16"]),
        ("knn_topk.tf32x3", *k3_src, launches["topk_f32"]["knn_topk.tf32x3"],
         max(k3_err["float32"], t_k3["float32"]["max_abs_err"]),
         t_k3["float32"]),
        ("knn_topk.wgmma", *k3_src,
         launches["pallas_two_pass"]["knn_topk.wgmma"],
         max(k3_err["bfloat16"], t_k3["bfloat16"]["max_abs_err"]),
         t_k3["bfloat16"]),
        ("tap_epilogue", "ganleaks_tpu_torch/csrc/tap_epilogue.cu",
         "ganleaks_tpu/ops/lpips/epilogue_pallas.py:114",
         north["launches"]["auto"]["tap_epilogue"],
         max(k2_err, t_k2["bf16_int8"]["max_abs_err"]), t_k2["bf16_int8"]),
    ]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": n, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    } for name, source, replaces, n, err, t in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
