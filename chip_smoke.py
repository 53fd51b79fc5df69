#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (superdiff_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --kernels [--root DIR]`` runs phases 1-3a and
3d-3e alone (about 70 s with the builds) and prints their kernels line:
B1 at the path shapes and at the SD call's, and B4 at the SD call's
chains, with their times and bounds. ``--root`` imports the package of
another checkout (a parent unpacked beside this one) under this file's
checks, for before / after times in one call; a package with no
``sd21base`` preset gives no SD rows.

Phases (any failure raises and exits non-zero; nothing is skipped):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the four kernel sources (csrc/flash_attn_fwd.cu,
   csrc/flash_attn_fwd_wgmma.cu, csrc/flash_attn_bwd.cu,
   csrc/group_norm_silu.cu), one nvcc each, and
   the data layer's three host libraries (the shard loader, the PNG row
   unfilter, the JPEG decoder), one g++ each, all started together; print
   the build time and the ptxas reports;
3. kernels vs their plain versions on the card, bf16 and f32:
   (a) the forward (B1) at the path's shapes (batch 16, and the CFG 2B batch)
       and at shapes with several K tiles, a ragged edge and D=128 (bf16
       out within 2e-2 of the plain output's largest entry, ``out_tol``);
       a rerun must give the same bits; each row carries the design B1 picks
       (ops/flash_attention.py::_fwd_design), its launch geometry
       (_fwd_geometry or _fwd_wgmma_geometry) and the instantiation's
       registers, spills and resident blocks per SM, and the device time of
       the other design where it takes the shape;
   (b) the backward kernels dQ (B2) and dK/dV (B3) at the three path shapes
       and a ragged D=128 shape, with a non-contiguous dO; a rerun must
       give the same bits; each row carries the launch geometry
       (ops/flash_attention.py::_bwd_geometry) and the instantiation's
       registers, spills and resident blocks per SM, the device time of
       the delta = rowsum(dO o O) expression that feeds both kernels, and
       B2 + B3 + delta beside SDPA's whole backward (which has its own
       delta pass);
   (c) the fused GroupNorm+FiLM+SiLU (B4) in its folded mode (the
       RefUNet's) at the RefUNet's batch-16 shapes (C, G) = (1, 1),
       (64, 4), (128, 4), FiLM cases, group widths 3 and 12, a ragged 7x9
       image; a rerun must give the same bits;
   (d) B1 at Stable Diffusion 2.1-base's launches of its 16-row call (8
       images under guidance): self-attention at S 4096 / 1024 / 256 / 64
       with 5 / 10 / 20 / 20 heads of 64, and cross-attention of the same
       queries to 77 keys (the K/V loop's masked partial tile), q from its
       own projection and k, v from theirs (the layout Attention hands
       the kernel); bf16 and f32 against the plain version as in (a), a
       rerun the same bits; the design, geometry and other design's time as in (a);
   (e) one full-width sd21base call at 16 rows under the bf16 sampling
       policy (default-initialised weights, seeded latents and contexts):
       32 B1 launches (16 self, 16 cross, at 3d's shapes) and 45 B4
       chains counted through the wrappers; then B4 at each of those chain
       shapes (C 320-2560, 32 groups: 10-80 channels a group, no FiLM) in
       the regime launch_geometry picks against the plain chain (bf16
       ulps and the share of elements differing), with its device time
       and bound; and the call's own time;
   CUDA-event times of each kernel, its plain version and the library
   yardstick (F.scaled_dot_product_attention forward / backward for B1-B3;
   F.group_norm + F.silu for B4; timed only as yardsticks, the port never
   calls them), each kernel's own device time from the profiler, and for
   B1-B3 the device time of all kernels of the SDPA call (one
   torch.autograd.grad for the backward), so that kernel and yardstick
   compare device time with device time;
4. the sampling slice through the user entry points: the full-width wide256
   CondUNet with seeded random weights on every leaf, written as an exported
   run dir and loaded back through superdiff_torch.inference.load_run:
   (a) superdiff_torch.cli.sample DDPM-1000 at 256², batch 16, label 0,
       once with each sampler step run eagerly (the "before", through
       cli.sample's Python API) and once through its CUDA graph (the main
       path: one graph of one step, replayed per step): the same samples
       bit for bit; s per batch, capture s and peak memory of both;
       (a') DDPM at batch 16 and 4: ms per step eagerly over 100 steps and
       graphed over 1000; eager and graphed plans run the last 100 steps
       (the t=0 step, which keeps no noise, included) from one state and
       must end equal bit for bit; and
       a torch.profiler window over graph replays (device busy and idle
       share per step, B1 kernels per replay);
   (b) one denoiser call at batch 2, bf16 kernel path on the card against the
       float32 plain path on the CPU; then the denoiser call's time at batch
       16 and a torch.profiler breakdown at batch 16 and 4; then the
       standing check of B4 on the CondUNet's path: every
       GroupNorm->(FiLM)->SiLU chain of one batch-16 call (51, counted by
       shape through B4's wrapper), and at each shape policy-mode B4 in
       both of its regimes against the plain chain (within 2 bf16 ulps,
       under 1 % of elements differing; the counts printed), with B4's
       device time, the bound, the plain chain's and the F.group_norm +
       F.silu yardstick's; the training chain (float32 norm dtype): B4's
       backward kernel in both regimes against the plain closed form, and
       B4's forward + backward device time beside the bound, the plain
       chain's and the library's under autograd;
       and the attention blocks' GroupNorm (no SiLU, not routed to B4);
   (c) superdiff_torch.cli.sample SuperDiff OR and AND of two differently
       seeded wide256 models, batch 4, T=1000, graphed; OR also eagerly
       (samples and logq bit for bit); AND's eager and graphed plans over
       the last 100 steps from one state, as in (a') (x and logq bit for
       bit), and ms per step of both;
   every run checks finite outputs and 8 B1 and 51 B4 launches per
   denoiser call through the wrappers (an eager run: every call; a graphed
   run: the diffusion/graphed.py WARMUP_STEPS warm-up calls and the
   captured one). A graph's replays launch B1 and B4 without the wrappers:
   a graphed run's launches are the wrapper's launches outside the capture
   plus the launches it recorded into the graph times the replays that
   diffusion/graphed.py counted in the run (run_launches: 51 B4 per DDPM
   replay), and the profiler counts the kernels of graph replays as a
   cross-check;
5. the training slice, full-width wide256 at 256², bf16 compute, float32
   norm dtype (the benchmark's training policy) in (b)-(e):
   (a) one loss at batch 2: gradients through the kernels against gradients
       through their plain versions on the card (relative L2 over all leaves,
       and per leaf for every attention block's qkv and proj weights);
   (b) superdiff_torch.cli.train --synthetic --device cuda at batch 16, 3
       epochs of 10 optimizer steps (the first is warm-up): images per
       second and ms per step of the last two, peak memory, validation loss
       finite and falling on the fixed stream; the train step one CUDA
       graph (one eager warm-up step, one capture holding exactly 8/8/8
       launches of B1/B2/B3, replays for the other steps, the replayed
       share of each epoch's steps) and 8 of B1 per validation batch; 51
       B4 forward and 51 B4 backward launches in the captured train step
       and 51 B4 per validation batch;
   (c) a short leg with model.remat=true and training.grad_accum=2 (16 B1
       launches per microbatch; B4 51 forward, 50 recomputed and 51
       backward per microbatch), and one in which this script swaps the
       backward kernels for autograd of the plain softmax attention, for its
       time only (the package has no such switch);
   (d) a train step alone on a fixed batch, replayed from its graph:
       CUDA-event time and a torch.profiler breakdown (device busy, idle
       share, B1+B2+B3 share);
   (e) resume at batch 4: 2 steps + checkpoint + 2 steps against 4 straight
       steps, every saved tensor bit for bit
       (torch.backends.cudnn.deterministic=True);
   (f) superdiff_torch.cli.export of the trained run, then cli.sample
       (DDIM, 20 steps) from it: finite samples;
6. the reference-model slice, full-width RefUNet (base 64, 256², float32):
   two reference-layout checkpoints (this script's torch rebuild of the
   reference UNet, seeds 1 and 2, saved as ema_epoch1.pt) through
   superdiff_torch.cli.import_torch, then
   (a) cli.sample DDPM-1000 at batch 16 through the CUDA graph: finite,
       10 B4 launches per wrapped call, 10 of them captured, 1000 replays
       and no B1;
   (b) one call at batch 2, B4 against the plain version on the card (10 B4
       launches, counted eagerly), and the same call bit-equal with
       PyTorch's cuDNN TF32 off and on (the RefUNet pins its convolutions to
       IEEE float32 itself); the call's time at batch 16 and a profile
       (device busy, idle, B4 share); DDPM steps eagerly and graphed (100
       each), with 10 B4 per graph replay from the profiler;
   (c) cli.sample SuperDiff OR of the two runs (TB x PNEUMONIA), batch 4,
       T=1000, graphed: finite samples and logq;
   (d) one wide256 call without gradients: 51 B4 launches (the
       CondUNet's chains) and 8 B1;
   (e) cli.train --synthetic on model.preset=ref, batch 4: loss finite and
       falling, 10 B4 launches in the captured train step (one capture,
       replays for the rest) and per validation batch; gradients of one
       loss at batch 2 with B4 against the plain version;
   these legs run under PyTorch's default (cuDNN TF32 on), as a user's
   CLI run does; the RefUNet's convolutions ignore it;
7. serving: superdiff_torch.cli.serve's loading (load_service) of the two
   wide256 run dirs at batch 16, the SamplerService and its HTTP app on an
   ephemeral port: warm-up DDIM-50 (one capture, 51 B4 in it); three
   concurrent unseeded requests (num 4, 4, 8; labels 0, 1 and the null
   label) that must coalesce into one batch of 50 replays (51 B4 each); one seeded request twice (the same bytes, and
   the eager sampler's bits); DPM++-10; SuperDiff OR with logq; then a
   second service on the imported RefUNet run, one DDIM-50 request (B4
   inside the graph); latencies, samples/s, captures and the graph pool;
8. the data layer and evaluation (under PyTorch's default cuDNN TF32):
   (a) a flat tree of 2 x 224 grayscale PNGs, 512-1024 px a side and not
       square, written by the port's own PNG writer with every row filter,
       some 16-bit and some RGB, plus 2 copies of each committed JPEG
       fixture (tests/torch_jpeg/: gray, YCbCr 4:2:0 / 4:2:2 / 4:4:4,
       progressive, restart markers, CMYK, YCCK), split 70/15/15 by
       superdiff_torch.data.split (the train split must hold JPEGs); every
       fixture decoded by the port's own JPEG decoder (this machine has no
       PIL) against the manifest's shape and SHA-256, ms per image by form;
       host decode ms per image by size (the
       C++ row unfilter, and the numpy plain version's time at 1024²
       Paeth), host_resize and CLAHE ms, BatchIterator images/s in its
       decode epoch and cached epoch at batch 16, 256², the native shard's
       build s and NativeBatchIterator images/s (the DataModule must hand
       out the native iterator);
   (b) superdiff_torch.cli.train on the tree (--dataset-root, native
       loader) and --synthetic, full-width wide256 at 256², batch 16, two
       epochs of the train split's steps each, validation after the second
       (the tree's val split, wrap-padded): images/s and ms per step of the
       second epoch, the profiled device idle share, the val loss, 8/8/8
       B1/B2/B3 in the captured train step (one capture, replays for the
       rest), 51 B4 forward and 51 backward per train step (float32 norm
       dtype) and 51 per validation batch;
   (c) superdiff_torch.cli.evaluate on the tree run: DDIM-100 graphed, 64
       samples at batch 16, FID against the test split under the
       classifier (artifacts/extractors/smallcnn_trained_256.npz),
       resnet18 (resnet18_rand_seed1234.npz), random and diffusion
       extractors, each finite; the seconds of sampling and of each
       extractor; B4 launches counted in the run (sampler warm-up and
       capture, 5 per classifier batch, 3 per random batch, 51 per
       diffusion batch), and per batch of each extractor alone (5, 3, 51
       B4 and 8 B1);
   (d) B4 at the SmallCNN's five chain shapes (float32, G=8, eps 1e-6,
       batch 16) against the plain chain (max abs < 1e-4) and a rerun
       (same bits), with its device time (profiler, and CUDA events over a
       captured graph of 20 calls, which the plain chain and the library
       chain also get), bound, plain and library times;
       the extractor's features of the 64 real and 64 generated images and
       their FID through B4 and through the plain chain (relative L2 <
       1e-4, FID within 1e-3 relative);
9. progressive distillation (under PyTorch's default cuDNN TF32): the
   tree-trained run of 8b exported (cli.export), then
   (a) superdiff_torch.cli.distill --dataset-root on the tree, students of
       4, 2 and 1 steps, one epoch per phase, batch 16, wide256 at 256²
       (bf16 compute): per phase ms per step and images/s over the steps
       after the first, first and last loss (finite), peak memory; the
       launches over the run, exactly 24 B1, 8 B2, 8 B3, 153 B4 and 51 B4
       backward per step; then a distillation step alone on a tree batch:
       the same counts in one step, 16 B1 and 102 B4 in the teacher's two
       calls alone (so 51 B4 forward and 51 backward from the student, the
       tree run's float32 norm dtype), CUDA-event ms, and a profiler
       window over 3 steps and over 3 teacher rollouts (device busy, idle
       share, the teacher calls' share of the step's device time);
   (d) one step at batch 2, kernels (B1-B4) against their plain versions
       on the card: the loss and the gradients (Adam's first moment after
       one update, pooled relative L2 < 1e-2);
   (b) superdiff_torch.cli.sample of each student with no --method (the
       stamp must resolve to trailing DDIM-N with clip_x0 off), graphed at
       batch 16, finite; s4 also eagerly, bit for bit;
   (c) superdiff_torch.cli.evaluate, classifier extractor, 64 samples, on
       s4 by its stamp and on the teacher at DDIM-4 trailing: finite FIDs
       (a check of the path after one epoch per phase, not of quality);
10. the visual slice (under PyTorch's default cuDNN TF32), on 8b's tree and
   its tree-trained wide256 run:
   (a) superdiff_torch.cli.inspect_data with every viz toggle, 120 images
       at 256², batch 16, Grad-CAM through the SmallCNN it trains (150
       steps) and, in a second leg, through the committed ResNet-18
       (--gradcam-backbone resnet18); seconds, calls and B1 / B4 launches
       per stage (functions of the package wrapped by this script), t-SNE
       seconds at N=120, B4 launches exact by stage (3 per random-extractor
       batch, 3 per classifier step, 3 per Grad-CAM image), every file
       with its size; then the 8 CAMs through B4 against the plain chain
       (max abs < 1e-5, the same classes);
   (b) superdiff_torch.cli.visualize --trajectory --forward-strip
       --real-vs-generated --tsne --dashboard, 8 samples: DDPM-1000 through
       one CUDA graph with 8 frames copied between replays (8 B1 and 51 B4
       per replay; the run's launches exact, the diffusion extractor's two
       calls and the dashboard's random-extractor batches included), then
       the same sampling eagerly: samples and frames bit for bit;
   (c) cli.visualize --compare on phase 4's two runs, batch 4: DDPM-1000 of
       each and their SuperDiff OR, seconds and launches per run, a finite
       mean logq gap;
   (d) superdiff_torch.cli.train --synthetic with training.vis_every at its
       default: samples_epoch5.png and loss_curve.png, drawn without
       matplotlib; matplotlib, sklearn and PIL must not be in sys.modules
       after the phase;
11. the parallel modes (``superdiff_torch/parallel/``), after a line that
   names what one card cannot hold (a second NCCL rank: EP's world-2 leg,
   DP / TP / FSDP at world > 1, scaling over cards; those run only in the
   CPU gloo tests):
   (a) a world-1 NCCL group joined through the launch contract
       (SUPERDIFF_TPU_MULTIHOST=1 and the coordinator / process-count /
       process-id triple on 127.0.0.1) in one subprocess
       (``chip_smoke.py --parallel-worker``): cli.train --synthetic wide256
       batch 16, 10 steps, on the data-parallel path; 10 FSDP2 train steps
       of the library's step; cli.sample --data-parallel DDPM-1000 batch
       16; against, here, the same cli.train and train steps without a
       mesh (params and EMA: bits expected, a 1-rank mean is exact; any
       difference printed, and above 1e-4 relative L2 a failure) and phase
       4a's samples (bit for bit); ms per step of each, 8/8/8 B1/B2/B3
       launches per step;
   (b) tensor parallelism's arithmetic: both model-axis parts (m=2) of
       every wide256 ResBlock, sliced by parallel/tp.py, run one after the
       other with their conv_1 partial sums added, against the unsplit
       block at batch 16 (bf16, 2e-2 of the largest output); B4 at every
       split chain shape (C/2 channels, G/2 groups) against the plain
       chain, with its times and bound;
   (c) stacked SuperDiff (stack_eps_fns: one vmap over both runs' stacked
       weights, B1 and B4 through their registered ops) against the
       sequential calls at batch 4: one call (2e-2 relative L2; 8 B1
       launches, each over both models' rows, and 102 B4), then OR and AND
       over 100 graphed steps of a T=100 schedule from one seed (samples
       and logq), ms per step of each;
   (d) the two-stage pipeline on (cuda:0, cuda:0), 2 microbatches at batch
       16, against the full call (8 B1 and 51 B4 per microbatch), ms of
       each;
   (e) ring attention's hop arithmetic in one process, 4 chunks: B1 per
       K/V chunk merged by lse, B2/B3 per chunk with the merged lse and
       delta, against B1/B2/B3 on the whole sequence at (16, 1024, 4, 32)
       and (1, 16384, 4, 32) bf16: errors, device ms, peak memory beside
       the S^2 * 4 bytes of a score matrix;
   (f) utils/profiling.trace around one wide256 call names B1's and B4's
       kernels, and timed gives its time;
12. a JSON line per kernel shape, the card line, the kernels line, and last
   the result line {"ok": true, "device": {...}}. The kernels line holds
   B1 at the path shapes, B2 / B3 (their launches from 5b), policy-mode
   B4 at the 18 chain shapes of wide256 (13 sizes, FiLM or not; the
   regime launch_geometry picks, timed in 4b) and folded-mode B4 at the
   RefUNet's three, and folded-mode B4 at the SmallCNN's five (launches
   counted in 8c's cli.evaluate run), and the SD call's B1 at its eight
   launch shapes and B4 at its chain shapes (3d, 3e; `sd_call_launches`
   is their launches in one 16-row call). A B1/B4 row's
   `launches` is its main-path run's (4a, 6a) launches at that shape,
   run_launches of three counts taken in that run and printed beside it:
   `wrapper_launches`, `captured_per_replay` and `graph_replays`. B1-B3
   and policy-mode B4 rows also carry `distill_launches`, their launches
   at that shape in 9a's cli.distill run; B1 and policy-mode B4 rows
   `visualize_launches`, their launches at that shape in 10b's
   cli.visualize run, and the SmallCNN rows `inspect_launches`, in 10a's
   cli.inspect_data run (SmallCNN leg).

float32 comparisons run with TF32 off (cudnn.allow_tf32=False, matmul
precision "highest"); phase 6 turns cuDNN's TF32 back on, PyTorch's default.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the package under test: this checkout's, or with ``--kernels --root DIR``
# another checkout's
PKG_ROOT = (os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
            if "--root" in sys.argv[1:-1] else HERE)
IN_CHECKOUT = os.path.isdir(os.path.join(PKG_ROOT, "superdiff_torch"))
if IN_CHECKOUT:
    sys.path.insert(0, PKG_ROOT)
    from superdiff_torch.tools.timing import (cuda_time_ms, graph_time_ms,
                                              kernel_device_ms)
KERNEL_SRC = "superdiff_torch/csrc/flash_attn_fwd.cu"
WGMMA_SRC = "superdiff_torch/csrc/flash_attn_fwd_wgmma.cu"
TPU_KERNEL = "superdiff_tpu/ops/flash_attention.py:56"
BWD_SRC = "superdiff_torch/csrc/flash_attn_bwd.cu"
TPU_BWD_DQ = "superdiff_tpu/ops/flash_attention.py:189"
TPU_BWD_DKV = "superdiff_tpu/ops/flash_attention.py:221"
# H100 SXM peaks (NVIDIA data sheet): HBM, dense bf16 tensor core, f32 FMA;
# SFU exponentials: 16 per clock per SM.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_PER_CLK_PER_SM = 16
NUM_SMS = 132
PATH_SHAPES = [(16, 1024, 4, 32), (16, 256, 4, 64), (16, 64, 4, 64)]
EXTRA_SHAPES = [(32, 1024, 4, 32), (2, 4096, 4, 64), (2, 1000, 2, 128)]
TOL = {"bfloat16": dict(out=2e-2, lse=2e-3), "float32": dict(out=1e-4,
                                                              lse=1e-4)}
SLICE_REL_TOL = 5e-2     # bf16 path vs float32 plain path, relative L2
BWD_SHAPES = PATH_SHAPES + [(2, 1000, 2, 128)]
# B1 in Stable Diffusion 2.1-base's 16-row call, (B, Sq, Skv, H, D): at each
# transformer level a self-attention and a cross-attention to the 77-token
# text context
SD_ATTN_SHAPES = [(16, S, kv, H, 64)
                  for S, H in ((4096, 5), (1024, 10), (256, 20), (64, 20))
                  for kv in (S, 77)]
SD_CALL_B1 = 32          # 16 transformer blocks, a self- and a cross-attention
SD_CALL_B1_WGMMA = 10    # of them B1's wgmma design: self at 64² and 32²
SD_CALL_B4 = 45          # 22 ResBlocks' two GroupNorm->SiLU chains, the head's
# dQ/dK/dV against the plain version, relative to the gradient's largest
# entry: bf16 rounds P, dS and the result (2^-8 each); f32 differs only in
# summation order and exp2 vs exp.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# model gradients, kernels vs plain versions (bf16): all leaves pooled, and
# each attention block's qkv / proj weight on its own, so that a wrong dQ, dK
# or dV at one level cannot hide in the global norm
GRAD_REL_TOL = 1e-2
ATTN_LEAF_REL_TOL = 2e-2
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")
WIDE256 = ["--set", "model.preset=wide256", "--set",
           "training.resolution=256", "--set", "training.vis_every=0"]
GN_SRC = "superdiff_torch/csrc/group_norm_silu.cu"
TPU_GN = "superdiff_tpu/ops/fused_norm.py:78"
# B4's kernels: one gn_cluster per call in the cluster regime, gn_stats,
# gn_finalize and gn_apply in the three-pass one (B4_CALL_KERNELS: one of
# them per call, in both)
GN_KERNELS = ("gn_cluster", "gn_stats", "gn_finalize", "gn_apply")
B4_CALL_KERNELS = ("gn_cluster", "gn_apply")
# B4 shapes (B, H, W, C, G, film): the RefUNet path at batch 16 (first three,
# no FiLM), FiLM at a wide256 shape, group widths 3 and 12, ragged 7x9
GN_PATH_SHAPES = [(16, 256, 256, 1, 1, False), (16, 256, 256, 64, 4, False),
                  (16, 256, 256, 128, 4, False)]
GN_EXTRA_SHAPES = [(16, 128, 128, 128, 32, True), (4, 64, 64, 48, 16, True),
                   (16, 32, 32, 384, 32, True), (2, 7, 9, 64, 4, True),
                   (1, 7, 9, 1, 1, False)]
# B4 vs plain: f32 sums in another order and __expf; bf16 rounds the output
# once, a value near a rounding boundary may land one ulp away
GN_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
REF = ["--set", "model.preset=ref", "--set", "model.conditional=false",
       "--set", "training.resolution=256", "--set", "training.vis_every=0"]
REF_CALLS_B4 = 10        # GroupNorm->SiLU prologues per RefUNet call
WIDE256_CALLS_B4 = 51    # GroupNorm->(FiLM)->SiLU chains per wide256 call
# RefUNet kernel path vs plain path, one call / one gradient, float32 (its
# convolutions IEEE): only B4's summation order differs
REF_REL_TOL = 1e-4
REF_GRAD_REL_TOL = 1e-3
# phase 8: the PNG tree (images per class), and the SmallCNN extractor's
# GroupNorm->SiLU chains (B, H, W, C) at batch 16 on 256² inputs, G=8,
# eps 1e-6, float32; B4 against the plain chain (max abs), the whole
# extractor's features (relative L2) and their FID (relative)
TREE_PER_CLASS = 224
SMALLCNN_SHAPES = [(16, 128, 128, 32), (16, 64, 64, 64), (16, 32, 32, 128),
                   (16, 16, 16, 256), (16, 8, 8, 256)]
SMALLCNN_B4_TOL = 1e-4
SMALLCNN_FEAT_TOL = 1e-4
SMALLCNN_FID_TOL = 1e-3
# phase 8a: the committed JPEG fixtures (copied into the tree as well)
JPEG_FIXTURES = os.path.join(HERE, "tests", "torch_jpeg")
# the training legs' norm dtype (the benchmark's training policy): the
# chains of a train step run B4's forward and its backward kernel, 51 each
TRAIN_NORM = ["--set", "model.norm_dtype=float32"]
# phase 9: progressive distillation of the tree-trained wide256 run; per
# distillation step (conditional, batch 16): B1 8 per teacher call (2) and 8
# in the student's forward; B2 / B3 8 in its backward; B4 51 per teacher
# call and 51 in the student's forward, and 51 B4 backward launches
DISTILL_STEPS = (4, 2, 1)
DISTILL_PER_STEP = (24, 8, 8, 3 * WIDE256_CALLS_B4, WIDE256_CALLS_B4)
TEACHER_CALLS_PER_STEP = (16, 2 * WIDE256_CALLS_B4)    # (B1, B4)


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def bound(B, S, H, D, dtype, sm_clock_hz, tensors=4, stats=1, products=2,
          Skv=None):
    """Least time for the function: bytes (each (B,S,H,D) tensor and each
    per-row f32 statistic moved once), tensor/FMA flops (2*S*Skv*D per head
    and product), and exponentials on the SFUs (S*Skv per head). Defaults:
    the forward (q, k, v, out; lse; 2 products) of self-attention (Skv =
    S). dQ: 5 tensors, lse and delta, 3 products; dK/dV: 6 tensors, 4
    products. A forward with ``Skv`` keys moves k and v as (B,Skv,H,D)."""
    elt = 2 if dtype == "bfloat16" else 4
    Skv = S if Skv is None else Skv
    kv_tensors = 2 if Skv != S else 0
    nbytes = (((tensors - kv_tensors) * S + kv_tensors * Skv) * B * H * D
              * elt + stats * 4 * B * H * S)
    t_bytes = nbytes / HBM_BPS
    t_flops = 2 * products * B * H * S * Skv * D / PEAK_FLOPS[dtype]
    t_exp = B * H * S * Skv / (SFU_PER_CLK_PER_SM * NUM_SMS * sm_clock_hz)
    t = max(t_bytes, t_flops, t_exp)
    by = "bytes" if t == t_bytes else "operations"
    detail = {t_bytes: "hbm", t_flops: "mma", t_exp: "exp"}[t]
    return t * 1e3, by, detail


def phase_kernels(fa, sm_clock_hz):
    """Kernel vs plain version at every listed shape and dtype."""
    import torch
    import torch.nn.functional as F

    rows = {}
    dev = torch.device("cuda")
    for (B, S, H, D) in PATH_SHAPES + EXTRA_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            g = torch.Generator(device=dev).manual_seed(B * S + D)
            # q/k/v as strided views of one fused projection, the layout
            # SelfAttention2D hands the kernel
            qkv = torch.randn((B, S, 3 * H * D), generator=g,
                              device=dev).to(dtype)
            q, k, v = (a.view(B, S, H, D) for a in qkv.split(H * D, dim=-1))
            n0 = fa.launches
            out, lse = fa._flash_forward(q, k, v)
            torch.cuda.synchronize()
            if fa.launches != n0 + 1:
                raise AssertionError("kernel launch was not counted")
            ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
            err = (out.float() - ref_out.float()).abs().max().item()
            tol = out_tol(dname, ref_out)
            lse_err = (lse - ref_lse).abs().max().item()
            if not (torch.isfinite(out.float()).all() and err <= tol and
                    lse_err <= TOL[dname]["lse"]):
                raise AssertionError(
                    f"flash kernel disagrees with plain at {(B, S, H, D)} "
                    f"{dname}: out err {err:.3e} (tolerance {tol:.3e}), lse "
                    f"err {lse_err:.3e}")
            out2, lse2 = fa._flash_forward(q, k, v)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash kernel rerun at {(B, S, H, D)} "
                                     f"{dname} gave other bits")
            plain_iters = 5 if S >= 4096 else 20
            ms = cuda_time_ms(lambda: fa._flash_forward(q, k, v), 50)
            dev_ms = kernel_device_ms(lambda: fa._flash_forward(q, k, v))
            plain_ms = cuda_time_ms(
                lambda: fa._flash_forward_plain(q, k, v), plain_iters)
            qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = cuda_time_ms(sdpa, 50)
            lib_dev_ms = kernel_device_ms(sdpa, kernel=None)
            b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz)
            row = dict(shape=[B, S, H, D], dtype=dname, max_abs_err=err,
                       out_tol=tol, lse_max_abs_err=lse_err,
                       rerun_bit_equal=True, ms=ms,
                       kernel_device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_device_ms=lib_dev_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       bound_resource=b_detail, roofline_share=b_ms / ms,
                       device_roofline_share=b_ms / dev_ms
                       if isinstance(dev_ms, float) else "not measured",
                       geometry=b1_geometry(fa, q, k),
                       other_design_device_ms=b1_other_design_ms(fa, q, k,
                                                                 v))
            rows[(B, S, H, D, dname)] = row
            log("kernel_check " + json.dumps(row))
    return rows


def phase_bwd_kernels(fa, sm_clock_hz):
    """dQ (B2) and dK/dV (B3) vs their plain versions at BWD_SHAPES."""
    import torch
    import torch.nn.functional as F

    rows = {}
    dev = torch.device("cuda")
    for (B, S, H, D) in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            gen = torch.Generator(device=dev).manual_seed(B * S + D + 1)
            fused = torch.randn((2, B, S, 3 * H * D), generator=gen,
                                device=dev).to(dtype)
            q, k, v = (a.view(B, S, H, D)
                       for a in fused[0].split(H * D, dim=-1))
            g = fused[1].split(H * D, dim=-1)[1].view(B, S, H, D)
            if g.is_contiguous():
                raise AssertionError("dO was meant to be a strided view")
            out, lse = fa._flash_forward(q, k, v)
            n_dq, n_dkv = fa.bwd_dq_launches, fa.bwd_dkv_launches
            got = fa._flash_backward(q, k, v, out, lse, g)
            torch.cuda.synchronize()
            if (fa.bwd_dq_launches, fa.bwd_dkv_launches) != (n_dq + 1,
                                                             n_dkv + 1):
                raise AssertionError("backward launches were not counted")
            ref = fa._flash_backward_plain(q, k, v, out, lse, g)
            errs = {}
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                err = (a.float() - b.float()).abs().max().item()
                peak = b.float().abs().max().item()
                errs[name] = err
                if not (torch.isfinite(a.float()).all()
                        and err <= BWD_TOL[dname] * peak):
                    raise AssertionError(
                        f"{name} disagrees with plain at {(B, S, H, D)} "
                        f"{dname}: err {err:.3e}, largest entry {peak:.3e}")
            delta = fa._bwd_delta(out, g)
            delta_dev_ms = kernel_device_ms(lambda: fa._bwd_delta(out, g),
                                            kernel=None)
            plain_iters = 10
            qh, kh, vh = (a.transpose(1, 2).contiguous().requires_grad_()
                          for a in (q, k, v))
            oh = F.scaled_dot_product_attention(qh, kh, vh)
            gh = g.transpose(1, 2).contiguous()
            sdpa_bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), gh,
                                                   retain_graph=True)
            lib_ms = cuda_time_ms(sdpa_bwd, 30)
            lib_dev_ms = kernel_device_ms(sdpa_bwd, kernel=None)
            shape_rows = []
            for kern, kname, launch, plain, shape_kw, mine in (
                    ("dq", "flash_bwd_dq_kernel", fa._flash_bwd_dq_cuda,
                     fa._flash_bwd_dq_plain,
                     dict(tensors=5, stats=2, products=3), got[:1]),
                    ("dkv", "flash_bwd_dkv_kernel", fa._flash_bwd_dkv_cuda,
                     fa._flash_bwd_dkv_plain,
                     dict(tensors=6, stats=2, products=4), got[1:])):
                call = lambda: launch(q, k, v, g, lse, delta)
                again = call()
                again = (again,) if kern == "dq" else again
                if not all(torch.equal(a, b) for a, b in zip(mine, again)):
                    raise AssertionError(f"{kern} rerun at {(B, S, H, D)} "
                                         f"{dname} gave other bits")
                ms = cuda_time_ms(call, 50)
                dev_ms = kernel_device_ms(call, kernel=(kname,))
                plain_ms = cuda_time_ms(
                    lambda: plain(q, k, v, g, lse, delta), plain_iters)
                b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz,
                                             **shape_kw)
                warps, bt, mt, grid, _ = fa._bwd_geometry(
                    kern, B, S, H, D, q.element_size())
                err = errs["dq"] if kern == "dq" else max(errs["dk"],
                                                          errs["dv"])
                row = dict(kernel=kern, shape=[B, S, H, D], dtype=dname,
                           max_abs_err=err, rerun_bit_equal=True, ms=ms,
                           kernel_device_ms=dev_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_device_ms=lib_dev_ms,
                           library="SDPA backward (dQ, dK and dV together)",
                           bound_ms=b_ms, bound_by=b_by,
                           bound_resource=b_detail, roofline_share=b_ms / ms,
                           device_roofline_share=b_ms / dev_ms
                           if isinstance(dev_ms, float) else "not measured",
                           delta_device_ms=delta_dev_ms,
                           geometry=dict(warps=warps, bt=bt, mt=mt,
                                         grid=list(grid),
                                         **fa.bwd_kernel_info(
                                             kern, D, dtype, warps, bt, mt)))
                rows[(kern, B, S, H, D, dname)] = row
                shape_rows.append(row)
            # B2 + B3 + delta against SDPA's whole backward, which includes
            # its own delta pass: device time against device time
            parts = [r["kernel_device_ms"] for r in shape_rows]
            parts.append(delta_dev_ms)
            total = (sum(parts) if all(isinstance(x, float) for x in parts)
                     else "not measured")
            for row in shape_rows:
                row["b2_b3_delta_device_ms"] = total
                row["ratio_to_library_device"] = (
                    total / lib_dev_ms if isinstance(total, float)
                    and isinstance(lib_dev_ms, float) else "not measured")
                log("bwd_kernel_check " + json.dumps(row))
    return rows


def phase_gn_kernels(fn):
    """B4 against its plain version at every listed shape, f32 and bf16:
    times of the kernel (events and device), the plain version and the
    library chain, the bound (x read once, y written once) and the error."""
    import torch

    from superdiff_torch.tools.tune_group_norm import chain_inputs, gn_library

    rows = {}
    for (B, H, W, C, G, film) in GN_PATH_SHAPES + GN_EXTRA_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            x, gamma, beta, scale, shift = chain_inputs(B, H, W, C, film,
                                                        dtype, seed=C + G)
            call = lambda: fn.fused_groupnorm_silu(x, gamma, beta, G, scale,
                                                   shift)
            n0 = fn.launches
            y = call()
            torch.cuda.synchronize()
            if fn.launches != n0 + 1:
                raise AssertionError("B4 launch was not counted")
            ref = fn.gn_silu_plain(x, gamma, beta, G, scale, shift)
            err = (y.float() - ref.float()).abs().max().item()
            tol = GN_TOL[dname] * (1 + ref.float().abs()).max().item()
            if not (torch.isfinite(y.float()).all() and err <= tol
                    and torch.equal(y, call())):
                raise AssertionError(
                    f"B4 disagrees with plain (or with itself) at "
                    f"{(B, H, W, C, G, film)} {dname}: err {err:.3e}")
            big = x.numel() > 1 << 24
            row = dict(
                shape=[B, H, W, C], groups=G, film=film, dtype=dname,
                max_abs_err=err, ms=cuda_time_ms(call, 20 if big else 50),
                kernel_device_ms=kernel_device_ms(call, kernel=GN_KERNELS),
                plain_ms=cuda_time_ms(
                    lambda: fn.gn_silu_plain(x, gamma, beta, G, scale, shift),
                    5 if big else 20),
                library_ms=cuda_time_ms(
                    lambda: gn_library(x, gamma, beta, G, scale, shift),
                    20 if big else 50),
                library="F.group_norm + F.silu (+ FiLM FMA); no single "
                        "torch call computes the chain",
                bound_ms=2 * x.numel() * x.element_size() / HBM_BPS * 1e3,
                bound_by="bytes")
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            rows[(B, H, W, C, G, film, dname)] = row
            log("gn_kernel_check " + json.dumps(row))
            del x, y, ref
    torch.cuda.empty_cache()
    return rows


def sd_supported():
    """Whether the package under test has the ``sd21base`` preset (and so
    a B1 that takes keys of their own length)."""
    from superdiff_torch.models import presets

    return "sd21base" in getattr(presets, "_SD_PRESETS", {})


def phase_sd_kernels(fa, sm_clock_hz):
    """B1 against its plain version at SD_ATTN_SHAPES, bf16 and f32 (3d of
    the module docstring), with times, the bound and SDPA's time."""
    import torch
    import torch.nn.functional as F

    rows = {}
    dev = torch.device("cuda")
    for (B, S, Skv, H, D) in SD_ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            g = torch.Generator(device=dev).manual_seed(B * S + Skv + D)
            # q from its own projection, k and v from theirs: (B, L, H*D)
            # rows viewed as heads, as Attention hands them to the kernel
            q = torch.randn((B, S, H * D), generator=g, device=dev).to(
                dtype).view(B, S, H, D)
            k, v = (torch.randn((B, Skv, H * D), generator=g,
                                device=dev).to(dtype).view(B, Skv, H, D)
                    for _ in range(2))
            n0 = fa.launches
            out, lse = fa._flash_forward(q, k, v)
            torch.cuda.synchronize()
            if fa.launches != n0 + 1:
                raise AssertionError("kernel launch was not counted")
            ref_out, ref_lse = fa._flash_forward_plain(q, k, v)
            err = (out.float() - ref_out.float()).abs().max().item()
            tol = out_tol(dname, ref_out)
            lse_err = (lse - ref_lse).abs().max().item()
            del ref_out, ref_lse
            if not (torch.isfinite(out.float()).all() and err <= tol and
                    lse_err <= TOL[dname]["lse"]):
                raise AssertionError(
                    f"flash kernel disagrees with plain at "
                    f"{(B, S, H, D)} Skv {Skv} {dname}: out err {err:.3e} "
                    f"(tolerance {tol:.3e}), lse err {lse_err:.3e}")
            out2, lse2 = fa._flash_forward(q, k, v)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise AssertionError(f"flash kernel rerun at {(B, S, H, D)} "
                                     f"Skv {Skv} {dname} gave other bits")
            big = S * Skv >= 4096 * 4096
            call = lambda: fa._flash_forward(q, k, v)
            ms = cuda_time_ms(call, 20 if big else 50)
            dev_ms = kernel_device_ms(call)
            plain_ms = cuda_time_ms(
                lambda: fa._flash_forward_plain(q, k, v), 3 if big else 20)
            torch.cuda.empty_cache()
            qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh)
            lib_ms = cuda_time_ms(sdpa, 50)
            lib_dev_ms = kernel_device_ms(sdpa, kernel=None)
            b_ms, b_by, b_detail = bound(B, S, H, D, dname, sm_clock_hz,
                                         Skv=Skv)
            timed = isinstance(dev_ms, float)
            row = dict(shape=[B, S, H, D], Skv=Skv, dtype=dname,
                       max_abs_err=err, out_tol=tol, lse_max_abs_err=lse_err,
                       rerun_bit_equal=True, ms=ms, kernel_device_ms=dev_ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_device_ms=lib_dev_ms, bound_ms=b_ms,
                       bound_by=b_by, bound_resource=b_detail,
                       roofline_share=b_ms / ms,
                       device_roofline_share=b_ms / dev_ms if timed
                       else "not measured",
                       device_tflops=4 * B * H * S * Skv * D / dev_ms / 1e9
                       if timed else "not measured",
                       geometry=b1_geometry(fa, q, k),
                       other_design_device_ms=b1_other_design_ms(fa, q, k,
                                                                 v))
            rows[(B, S, Skv, H, D, dname)] = row
            log("sd_kernel_check " + json.dumps(row))
            del q, k, v, qh, kh, vh, out, out2
        torch.cuda.empty_cache()
    return rows


def out_tol(dname, ref):
    """B1's ``out`` tolerance against the plain version: float32 1e-4;
    bf16 2e-2 of the reference's largest entry, and never above 2e-2. Both
    sides round once to bf16 from sums that P's rounding offsets part by
    a bf16 ulp or two of that entry (2^-7 of it at most each), while a
    dropped or misread 128-key V tile moves out by several times more."""
    if dname != "bfloat16":
        return TOL[dname]["out"]
    return TOL[dname]["out"] * min(1.0, ref.float().abs().max().item())


def two_designs(fa):
    """Whether the package has B1's two designs and their counters. This
    checkout's must: only another package (``--kernels --root``, a parent
    timed beside the change) may have one design."""
    if hasattr(fa, "_fwd_design") and hasattr(fa, "launches_by_design"):
        return True
    if PKG_ROOT == HERE:
        raise AssertionError("ops/flash_attention.py lacks _fwd_design or "
                             "launches_by_design")
    return False


def b1_geometry(fa, q, k):
    """The design B1 picks for a launch (``"mma_sync"`` in a package with
    one design) and its launch geometry, with what the compiler says of
    the instantiation."""
    B, S, H, D = q.shape
    design = (fa._fwd_design(S, k.shape[1], D, q.dtype)
              if two_designs(fa) else "mma_sync")
    if design == "wgmma":
        rows, grid = fa._fwd_wgmma_geometry(B, S, H)
        return dict(design=design, rows=rows, grid=list(grid),
                    **fa.fwd_wgmma_kernel_info())
    warps, bk, mt, grid, _ = fa._fwd_geometry(B, S, H, D, q.element_size())
    return dict(design=design, warps=warps, bk=bk, mt=mt, grid=list(grid),
                **fa.fwd_kernel_info(D, q.dtype, warps, bk, mt))


def b1_other_design_ms(fa, q, k, v):
    """Device ms of the design B1 does not pick for this launch, where the
    package has two and the other one takes the shape (the wgmma design:
    bf16, D = 64, whole 128-key tiles), else None: both designs side by
    side at every shape either can run."""
    import torch

    if not two_designs(fa):
        return None
    B, S, H, D = q.shape
    if fa._fwd_design(S, k.shape[1], D, q.dtype) == "wgmma":
        warps, bk, mt, _, _ = fa._fwd_geometry(B, S, H, D, q.element_size())
        run = lambda: fa._launch_fwd(q, k, v, warps, bk, mt)
    elif (q.dtype == torch.bfloat16 and D == fa._WGMMA_D
          and k.shape[1] % fa._WGMMA_BN == 0):
        run = lambda: fa._launch_fwd_wgmma(q, k, v)
    else:
        return None
    return kernel_device_ms(run)


def b1_by_design(fa):
    """B1's launches since the last reset by design name (empty in a
    package with one design)."""
    by = {}
    for key, n in (fa.launches_by_design if two_designs(fa) else {}).items():
        by[key[-1]] = by.get(key[-1], 0) + n
    return by


def sd_b1_key(S, Skv, D, dname="bfloat16"):
    """B1's counter key of a launch (``ops/flash_attention.py``)."""
    return (S, D, dname) + (() if Skv == S else (Skv,))


def phase_sd_call(fa, fn):
    """One full-width sd21base call at 16 rows under the bf16 sampling
    policy: B1 and B4 launches counted through the wrappers against the
    call's shapes, the call's time, then B4 at each chain shape against the
    plain chain (3e of the module docstring)."""
    import torch

    from superdiff_torch.inference import apply_sampling_policy
    from superdiff_torch.models.presets import build_model
    from superdiff_torch.tools import tune_group_norm as tg

    torch.manual_seed(16)
    model = build_model("sd21base", num_classes=0,
                        compute_dtype=torch.bfloat16, device="cuda").eval()
    apply_sampling_policy(model)
    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((16, 64, 64, 4), generator=g, device="cuda")
    t = torch.full((16,), 500, dtype=torch.long, device="cuda")
    ctx = torch.randn((16, 77, 1024), generator=g, device="cuda")

    def call():
        with torch.no_grad():
            return model(x, t, ctx)

    fa.reset_launches()
    fn.reset_launches()
    out = call()
    torch.cuda.synchronize()
    b1, b4 = dict(fa.launches_by_shape), dict(fn.launches_by_shape)
    # transformer blocks per level: 5 at 64², 32² and 16², 1 at 8² (mid)
    want = {}
    for (_, S, Skv, _, D) in SD_ATTN_SHAPES:
        want[sd_b1_key(S, Skv, D)] = 1 if S == 64 else 5
    if b1 != want or sum(b1.values()) != SD_CALL_B1:
        raise AssertionError(f"one sd21base call launched B1 {b1}, expected "
                             f"{want}")
    designs = b1_by_design(fa)
    if two_designs(fa) and designs != {
            "wgmma": SD_CALL_B1_WGMMA,
            "mma_sync": SD_CALL_B1 - SD_CALL_B1_WGMMA}:
        raise AssertionError(f"one sd21base call launched B1's designs "
                             f"{designs}, expected {SD_CALL_B1_WGMMA} of the "
                             "wgmma design (the S = 4096 and 1024 "
                             "self-attentions)")
    if sum(b4.values()) != SD_CALL_B4:
        raise AssertionError(f"one sd21base call launched B4 "
                             f"{sum(b4.values())} times, expected "
                             f"{SD_CALL_B4}: {b4}")
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise AssertionError(f"sd21base call gave {tuple(out.shape)}, finite "
                             "or not")
    call_ms = cuda_time_ms(call, 10)
    rows = []
    for key, count in sorted(b4.items()):
        H, W, C, G, film, dname = key
        picked = fn.launch_geometry(16, H * W, C, G, getattr(torch, dname),
                                    model.norm_dtype, True).regime
        row = tg.chain_row(fn, 16, key, count, model.norm_dtype, (picked,))
        if row.get("failed"):
            raise AssertionError(f"policy-mode B4 disagrees with the plain "
                                 f"chain at SD's {key}: {json.dumps(row)}")
        rows.append(row)
        log("sd_chain " + json.dumps(row))
    del model, out
    torch.cuda.empty_cache()
    return dict(b1={str(k): n for k, n in b1.items()}, b1_by_design=designs,
                b4={str(k): n for k, n in b4.items()}, call_ms_16_rows=call_ms,
                rows=rows, summary=tg.summarize(rows, ()),
                b1_counts=b1)


def b1_time_row(row, name):
    """The times and bound of one B1 kernel-check row, for the kernels
    line."""
    design = row["geometry"]["design"]
    return dict(name=name, route="cuda",
                source=WGMMA_SRC if design == "wgmma" else KERNEL_SRC,
                replaces=TPU_KERNEL, design=design,
                other_design_device_ms=row["other_design_device_ms"],
                max_abs_err=row["max_abs_err"],
                ms=row["ms"], kernel_device_ms=row["kernel_device_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"],
                bound_resource=row["bound_resource"],
                device_roofline_share=row["device_roofline_share"],
                library_ms=row["library_ms"],
                library_device_ms=row["library_device_ms"])


def sd_kernel_rows(sd_rows, sd_call):
    """The kernels line's rows of the SD call: B1 at each launch shape
    (bf16) and B4 at each chain shape, each with its launches per call."""
    kernels = []
    for (B, S, Skv, H, D) in SD_ATTN_SHAPES:
        kernels.append(dict(
            b1_time_row(sd_rows[(B, S, Skv, H, D, "bfloat16")],
                        f"flash_attn_fwd[bf16 B{B} Sq{S} Skv{Skv} H{H} D{D} "
                        "SD]"),
            sd_call_launches=sd_call["b1_counts"].get(sd_b1_key(S, Skv, D),
                                                      0)))
    for r in sd_call["rows"]:
        B, H, W, C = r["shape"]
        picked = next(v for k, v in r.items() if k.endswith("*"))
        kernels.append(dict(
            name=f"group_norm_silu_policy[bf16 B{B} {H}x{W} C{C} "
                 f"G{r['groups']} SD]",
            route="cuda", source=GN_SRC, replaces=TPU_GN,
            sd_call_launches=r["launches_per_call"],
            regime=picked["geometry"]["regime"],
            max_abs_err=picked["max_abs_err"], max_ulps=picked["max_ulps"],
            share_differing=picked["share_differing"], ms=picked["ms"],
            kernel_device_ms=picked["device_ms"], plain_ms=r["plain_ms"],
            plain_device_ms=r["plain_device_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"]))
    return kernels


def kernels_only(fa, fn, card_line, sm_clock_hz):
    """``--kernels``: phases 3a, 3d and 3e alone, and their kernels line
    (B1 at the path shapes and, where the package has them, the SD call's
    B1 and B4 rows)."""
    import torch

    rows = phase_kernels(fa, sm_clock_hz)
    log(f"phase 3a forward kernel checks: {len(rows)} shape/dtype cases "
        "agree")
    kernels = [b1_time_row(rows[(B, S, H, D, "bfloat16")],
                           f"flash_attn_fwd[bf16 B{B} S{S} H{H} D{D}]")
               for (B, S, H, D) in PATH_SHAPES]
    if sd_supported():
        sd_rows = phase_sd_kernels(fa, sm_clock_hz)
        log(f"phase 3d SD B1 checks: {len(sd_rows)} shape/dtype cases agree")
        sd_call = phase_sd_call(fa, fn)
        log(f"phase 3e sd21base call at 16 rows ({card_line}): "
            + json.dumps({k: v for k, v in sd_call.items()
                          if k not in ("rows", "b1_counts")}))
        kernels += sd_kernel_rows(sd_rows, sd_call)
    else:
        log(f"phase 3d-3e: the package at {PKG_ROOT} has no sd21base")
    print(card_line)
    print(json.dumps({"kernels": kernels, "package": PKG_ROOT}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def wide256_norm_chains(fn, model):
    """Phase 4b's standing check of B4 on the CondUNet's path: every
    GroupNorm->(FiLM)->SiLU chain one wide256 call runs at batch 16 under
    the bf16 sampling policy (ResBlock norm_0 / norm_1 + FiLM and out_norm;
    the attention norm has no SiLU), counted through B4's wrapper (51 in
    all); then at each shape policy-mode B4 in both regimes against the
    plain chain (tools/tune_group_norm.py::chain_row: bf16 ulps and the
    share of elements that differ at all), with B4's device time, the
    bound, the plain chain's and the F.group_norm + F.silu yardstick's; and
    the training chain (float32 norm dtype, a gradient wanted:
    tools/tune_group_norm.py::train_chain_row): B4's backward kernel in
    both regimes against the plain closed form, and the device time of B4's
    forward + backward beside the bound, the plain chain's and the
    library's under autograd; and the attention blocks' GroupNorm (no SiLU,
    not routed to B4): shapes, calls and device time."""
    import torch

    from superdiff_torch.models.layers import SelfAttention2D
    from superdiff_torch.tools import tune_group_norm as tg
    from superdiff_torch.tools.timing import kernel_device_ms

    attn = {}

    def seen(mod, args):
        key = (tuple(args[0].shape), str(args[0].dtype))
        attn.setdefault(key, [mod, 0])[1] += 1

    hooks = [m.norm.register_forward_pre_hook(seen)
             for m in model.modules() if isinstance(m, SelfAttention2D)]
    try:
        shapes = tg.wide256_chain_shapes(fn, model, 16)
    finally:
        for h in hooks:
            h.remove()
    attn_rows = []
    for (shape, dname), (mod, count) in sorted(attn.items()):
        x = torch.randn(shape, device="cuda").to(getattr(torch, dname[6:]))
        with torch.no_grad():
            ms = kernel_device_ms(lambda: mod(x, model.norm_dtype),
                                  kernel=None)
        attn_rows.append(dict(shape=list(shape), dtype=dname[6:],
                              calls=count, device_ms=ms))
    if sum(shapes.values()) != WIDE256_CALLS_B4:
        raise AssertionError(f"one wide256 call launched B4 "
                             f"{sum(shapes.values())} times, expected "
                             f"{WIDE256_CALLS_B4}: {shapes}")
    regimes = ("cluster", "three_pass")
    rows = []
    for key, count in sorted(shapes.items()):
        row = tg.chain_row(fn, 16, key, count, model.norm_dtype, regimes)
        if row.get("failed"):
            raise AssertionError(f"policy-mode B4 disagrees with the plain "
                                 f"chain at {key}: {json.dumps(row)}")
        row["train"] = tg.train_chain_row(fn, 16, key, count)
        if row["train"].get("failed"):
            raise AssertionError(f"B4's backward disagrees with the plain "
                                 f"closed form at {key}: "
                                 f"{json.dumps(row['train'])}")
        rows.append(row)
        log("wide256_chain " + json.dumps(row))
    summary = tg.summarize(rows, regimes)
    summary["train"] = tg.summarize_train([r["train"] for r in rows])
    summary["attention_norm"] = dict(
        rows=attn_rows, calls=sum(r["calls"] for r in attn_rows),
        device_ms_per_call=(sum(r["calls"] * r["device_ms"]
                                for r in attn_rows)
                            if all(isinstance(r["device_ms"], float)
                                   for r in attn_rows)
                            else "not measured"))
    return dict(rows=rows, chains_per_call=sum(shapes.values()),
                summary=summary)


def reference_state_dict(seed, base=64, time_emb_dim=256):
    """A state dict in the reference trainer's own key layout
    (``downs.N.block.{0,2,3,5}``, ``mid``, ``ups.N``, ``time_mlp.{1,3}``,
    ``time_emb``), from this script's torch rebuild of its UNet: torch's
    default initialisation from ``seed``, GroupNorm affines moved off 1 / 0."""
    import torch
    from torch import nn

    torch.manual_seed(seed)

    def block(i, o):
        m = nn.Module()
        m.block = nn.Sequential(
            nn.GroupNorm(min(4, i), i), nn.SiLU(),
            nn.Conv2d(i, o, 3, padding=1), nn.GroupNorm(min(4, o), o),
            nn.SiLU(), nn.Conv2d(o, o, 3, padding=1))
        m.time_emb = nn.Linear(time_emb_dim, o)
        return m

    net = nn.Module()
    net.time_mlp = nn.Sequential(
        nn.Identity(), nn.Linear(time_emb_dim, 4 * time_emb_dim), nn.SiLU(),
        nn.Linear(4 * time_emb_dim, time_emb_dim))
    net.downs = nn.ModuleList([block(1, base), block(base, 2 * base)])
    net.mid = block(2 * base, 2 * base)
    net.ups = nn.ModuleList([block(2 * base, base), block(base, 1)])
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.add_(0.1 * torch.randn_like(m.weight))
                m.bias.add_(0.1 * torch.randn_like(m.bias))
    return net.state_dict()


def flash_counts(fa):
    return (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)


def run_train_cli(train_cli, work, run_id, batch, epochs, steps, extra=(),
                  model_args=WIDE256):
    """cli.train at 256² with the synthetic stream (full-width wide256
    unless ``model_args`` names another model); returns (run dir,
    metrics.jsonl rows)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main([
            "--synthetic", "--device", "cuda", "--experiment-id", "smoke",
            "--run-id", run_id, *model_args,
            "--set", f"training.batch_size={batch}",
            "--set", f"training.num_epochs={epochs}",
            "--set", f"training.steps_per_epoch={steps}",
            "--set", "training.save_every=0",
            "--set", "logging.stdout=false",
            "--set", f"paths.local_base={work}",
            "--set", f"paths.cluster_base={work}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    run_dir = os.path.join(work, "outputs", "PNEUMONIA",
                           f"experiment_smoke_run_{run_id}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return run_dir, metrics


def epoch_rows(metrics, key):
    return [m for m in metrics if key in m]


def model_grad_check(fa, load_run, make_schedule, p_losses, run_dir):
    """One wide256 loss at batch 2 (bf16 compute, random weights on every
    leaf): parameter gradients through the kernels against gradients through
    their plain versions, both on the card."""
    import torch

    _, model, schedule = load_run(run_dir, device="cuda")
    model.train()
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    noise = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    t = torch.tensor([700, 20], device="cuda")
    y = torch.tensor([1, 2], device="cuda")
    names, params = zip(*model.named_parameters())

    def grads():
        loss = p_losses(schedule, model, x, t, y=y, noise=noise)
        return loss.item(), torch.autograd.grad(loss, params)

    fa.reset_launches()
    loss_k, g_kernel = grads()
    if flash_counts(fa) != (8, 8, 8):
        raise AssertionError(f"gradient check launched {flash_counts(fa)}, "
                             "expected (8, 8, 8)")
    with flash_swapped_for_plain(fa):
        loss_p, g_plain = grads()
    if flash_counts(fa) != (8, 8, 8):
        raise AssertionError("the plain-version pass launched a kernel")
    num = sum(((a.float() - b.float()) ** 2).sum() for a, b in
              zip(g_kernel, g_plain)).sqrt().item()
    den = sum((b.float() ** 2).sum() for b in g_plain).sqrt().item()
    zero_leaves = sum(1 for b in g_plain if not b.abs().sum().item())
    rel = num / den
    if not (rel == rel and rel < GRAD_REL_TOL and zero_leaves == 0):
        raise AssertionError(f"model gradients, kernels vs plain: rel L2 "
                             f"{rel:.4e} (tolerance {GRAD_REL_TOL}), "
                             f"{zero_leaves} leaves with zero gradient")
    attn = {n: (torch.linalg.norm(a.float() - b.float())
                / torch.linalg.norm(b.float())).item()
            for n, a, b in zip(names, g_kernel, g_plain)
            if n.endswith((".qkv.weight", ".proj.weight"))}
    worst = max(attn, key=attn.get)
    if len(attn) != 16 or not attn[worst] < ATTN_LEAF_REL_TOL:
        raise AssertionError(f"attention leaves, kernels vs plain: "
                             f"{len(attn)} leaves (expected 16), worst "
                             f"{worst} rel L2 {attn[worst]:.4e} (tolerance "
                             f"{ATTN_LEAF_REL_TOL})")
    return dict(rel_l2=rel, loss_kernels=loss_k, loss_plain=loss_p,
                leaves=len(params), attn_leaves=len(attn),
                attn_leaf_worst=worst, attn_leaf_worst_rel_l2=attn[worst])


def math_backward(q, k, v, o, lse, g):
    """(dq, dk, dv) by autograd of the plain softmax attention: what the A/B
    leg puts in the backward kernels' place."""
    import torch

    from superdiff_torch.ops.attention import _math_attention

    with torch.enable_grad():
        qkv = [a.detach().requires_grad_() for a in (q, k, v)]
        return torch.autograd.grad(_math_attention(*qkv), qkv, g)


def train_step_alone(fa, tcfg, model_from_config, make_schedule, training,
                     synthetic_xray_batch, batch=16, timed=10, profiled=3):
    """A train step on one fixed batch, through the package's own state and
    step constructors: CUDA-event time per step, then a torch.profiler breakdown
    (device busy, idle share, the flash kernels' share, top kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tcfg.load_config(None, [a for a in WIDE256 + TRAIN_NORM
                                  if a != "--set"])
    model = model_from_config(cfg, device="cuda").init_parameters(0)
    schedule = make_schedule(1000, device="cuda")
    state = training.create_train_state(
        model, torch.Generator(device="cuda").manual_seed(0))
    step_fn = training.make_train_step(
        schedule, conditional=True, cfg_drop_prob=0.1,
        null_label=model.null_label)
    imgs, labels = synthetic_xray_batch(batch, 256, seed=0)
    data = {"image": torch.from_numpy(imgs).cuda(),
            "label": torch.from_numpy(labels).long().cuda()}
    for _ in range(3):            # warm-up step, capture, replay
        step_fn(state, data)
    fa.reset_launches()
    replays = training.steps.replays
    step_ms = cuda_time_ms(lambda: step_fn(state, data), timed, warmup=0)
    if (flash_counts(fa) != (0, 0, 0)
            or training.steps.replays != replays + timed):
        raise AssertionError(f"{timed} train steps launched "
                             f"{flash_counts(fa)} from Python and replayed "
                             f"{training.steps.replays - replays} times, "
                             f"expected none and {timed}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(profiled):
            step_fn(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3 / profiled
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / profiled
    flash = {k: sum(v for n, v in by_name.items() if k in n) / 1e3 / profiled
             for k in FLASH_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    n_aten = sum(a.count for a in prof.key_averages()
                 if a.key.startswith("aten::"))
    return dict(
        batch=batch, step_ms_events=step_ms,
        images_per_s_step_alone=batch / step_ms * 1e3,
        wall_ms_per_step_profiled=wall_ms,
        device_busy_ms_per_step=busy_ms if busy_ms else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else
        "not measured",
        flash_kernels_ms_per_step=flash,
        flash_share_of_device=(sum(flash.values()) / busy_ms) if busy_ms
        else "not measured",
        aten_ops_per_step=n_aten / profiled,
        kernels_per_step=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / profiled,
        top_kernels_ms_per_step=[[k[:80], v / 1e3 / profiled]
                                 for k, v in top])


def phase_training(fa, fn, work, run1, tcfg, model_from_config, load_run,
                   sample):
    """The training slice (phase 5 of the module docstring)."""
    import numpy as np
    import torch

    from superdiff_torch import training
    from superdiff_torch.checkpoint import load_checkpoint_file
    from superdiff_torch.cli import export as export_cli
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.data.synthetic import synthetic_xray_batch
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.diffusion.graphed import WARMUP_STEPS
    from superdiff_torch.diffusion.process import p_losses

    out = {}
    out["grad_check"] = model_grad_check(fa, load_run, make_schedule,
                                         p_losses, run1)
    log("phase 5a model gradients, kernels vs plain versions on the card: "
        + json.dumps(out["grad_check"]))

    # (b) the main training leg: 3 epochs x 10 steps at batch 16
    B, EPOCHS, STEPS, VAL = 16, 3, 10, 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fn.reset_launches()
    training.steps.reset_counts()
    tic = time.time()
    main_dir, metrics = run_train_cli(
        train_cli, work, "main", B, EPOCHS, STEPS,
        ["--set", f"training.eval_batches={VAL}", *TRAIN_NORM])
    main_s = time.time() - tic
    counts = flash_counts(fa)
    train_launches = dict(fwd=dict(fa.launches_by_shape),
                          dq=dict(fa.bwd_dq_launches_by_shape),
                          dkv=dict(fa.bwd_dkv_launches_by_shape))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = EPOCHS * STEPS
    # B1-B3 launch from Python in the warm-up step and the capture only
    expect = (8 * (2 + EPOCHS * VAL), 16, 16)
    if counts != expect:
        raise AssertionError(f"training launched (B1, B2, B3) = {counts}, "
                             f"expected {expect}")
    check_train_graph(fa, training.steps, n_steps, (8, 8, 8), "training")
    # B4 forward and backward in the warm-up step and the capture (51 each),
    # forward alone in the validation batches
    C4 = WIDE256_CALLS_B4
    check_train_b4(fn, C4 * (2 + EPOCHS * VAL), 2 * C4, (C4, C4), "training")
    tr, va = epoch_rows(metrics, "avg_loss"), epoch_rows(metrics, "val_loss")
    losses = [m["avg_loss"] for m in tr] + [m["val_loss"] for m in va]
    if len(tr) != EPOCHS or len(va) != EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"training metrics incomplete or not finite: "
                             f"{metrics}")
    if not (va[-1]["val_loss"] < va[0]["val_loss"]
            and tr[-1]["avg_loss"] < tr[0]["avg_loss"]):
        raise AssertionError(f"loss did not fall: train {tr}, val {va}")
    ips = [m["images_per_sec"] for m in tr[1:]]
    out["train"] = dict(
        batch=B, steps=n_steps, steps_after_warmup=(EPOCHS - 1) * STEPS,
        images_per_s_by_epoch=[m["images_per_sec"] for m in tr],
        images_per_s=float(np.mean(ips)),
        ms_per_step=float(np.mean([B / v * 1e3 for v in ips])),
        train_loss_by_epoch=[m["avg_loss"] for m in tr],
        val_loss_by_epoch=[m["val_loss"] for m in va],
        graph_replay_share_by_epoch=[m["graph_replay_share"] for m in tr],
        grad_norm_last=tr[-1]["grad_norm"], peak_mem_gb=peak_gb,
        launches=dict(B1=counts[0], B2=counts[1], B3=counts[2],
                      B4=fn.launches, B4_backward=fn.bwd_launches),
        launches_by_shape={k: {str(s): n for s, n in v.items()}
                           for k, v in train_launches.items()},
        whole_leg_s=main_s)
    log("phase 5b cli.train wide256 256² batch 16: "
        + json.dumps(out["train"]))

    # (c) remat + grad_accum=2, then the math backward, for their times
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fn.reset_launches()
    training.steps.reset_counts()
    _, m_remat = run_train_cli(
        train_cli, work, "remat", B, 2, 4,
        ["--set", "model.remat=true", "--set", "training.grad_accum=2",
         "--set", "training.eval_every=0", *TRAIN_NORM])
    counts = flash_counts(fa)
    if counts != (2 * 32, 2 * 16, 2 * 16):
        raise AssertionError(f"remat + grad_accum=2 launched {counts} in its "
                             "warm-up step and capture, expected (64, 32, "
                             "32)")
    check_train_graph(fa, training.steps, 8, (32, 16, 16),
                      "remat + grad_accum=2")
    # per microbatch 51 forward, 50 recomputed (the ResBlocks'; out_norm is
    # outside the checkpointed blocks) and 51 backward; two a step
    check_train_b4(fn, 2 * 2 * (2 * C4 - 1), 2 * 2 * C4,
                   (2 * (2 * C4 - 1), 2 * C4), "remat + grad_accum=2")
    tr = epoch_rows(m_remat, "avg_loss")
    out["remat_accum2"] = dict(
        batch=B, ms_per_step=B / tr[-1]["images_per_sec"] * 1e3,
        images_per_s=tr[-1]["images_per_sec"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_per_step=dict(B1=32, B2=16, B3=16, B4=2 * (2 * C4 - 1),
                               B4_backward=2 * C4),
        train_loss_by_epoch=[m["avg_loss"] for m in tr])
    log("phase 5c remat + grad_accum=2: " + json.dumps(out["remat_accum2"]))
    fa.reset_launches()
    training.steps.reset_counts()
    with swapped(fa, _flash_backward_cuda=math_backward):
        _, m_math = run_train_cli(train_cli, work, "mathbwd", B, 2, 10,
                                  ["--set", "training.eval_every=0"])
    if flash_counts(fa) != (16, 0, 0):
        raise AssertionError(f"math-backward leg launched "
                             f"{flash_counts(fa)}, expected (16, 0, 0)")
    check_train_graph(fa, training.steps, 20, (8, 0, 0), "math backward")
    tr = epoch_rows(m_math, "avg_loss")
    out["math_backward"] = dict(
        batch=B, ms_per_step=B / tr[-1]["images_per_sec"] * 1e3,
        images_per_s=tr[-1]["images_per_sec"])
    log("phase 5c math backward (time only): "
        + json.dumps(out["math_backward"]))

    # (d) a train step alone, timed and profiled
    out["step_profile"] = train_step_alone(
        fa, tcfg, model_from_config, make_schedule, training,
        synthetic_xray_batch)
    log("train_profile " + json.dumps(out["step_profile"]))
    torch.cuda.empty_cache()

    # (e) resume: 2 + 2 steps against 4 straight, bit for bit
    torch.backends.cudnn.deterministic = True
    try:
        straight, _ = run_train_cli(train_cli, work, "straight", 4, 2, 2,
                                    ["--set", "training.eval_every=0",
                                     *TRAIN_NORM])
        run_train_cli(train_cli, work, "resumed", 4, 1, 2,
                      ["--set", "training.eval_every=0", *TRAIN_NORM])
        resumed, _ = run_train_cli(train_cli, work, "resumed", 4, 2, 2,
                                   ["--set", "training.eval_every=0",
                                    *TRAIN_NORM])
    finally:
        torch.backends.cudnn.deterministic = False
    a = load_checkpoint_file(os.path.join(straight, "checkpoints"), 4)
    b = load_checkpoint_file(os.path.join(resumed, "checkpoints"), 4)
    n_cmp = 0
    for part in ("params", "ema_params"):
        for key in a[part]:
            n_cmp += 1
            if not torch.equal(a[part][key], b[part][key]):
                raise AssertionError(f"resume differs in {part}/{key}")
    for part in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(a["opt_state"][part],
                                       b["opt_state"][part])):
            n_cmp += 1
            if not torch.equal(x, y):
                raise AssertionError(f"resume differs in Adam {part}[{i}]")
    if not (all(torch.equal(a["rng"][k], b["rng"][k]) for k in a["rng"])
            and a["step"] == b["step"] == 4
            and a["opt_state"]["count"] == b["opt_state"]["count"] == 4):
        raise AssertionError("resume differs in rng, step or Adam count")
    moved = sum(1 for k, v in a["params"].items()
                if not torch.equal(v, a["ema_params"][k]))
    if not moved:
        raise AssertionError("parameters and EMA are identical after 4 steps")
    out["resume"] = dict(steps="2+2 vs 4", batch=4, tensors_equal=n_cmp,
                         bit_exact=True)
    log("phase 5e resume: " + json.dumps(out["resume"]))

    # (f) export the trained run and sample from it
    exported = os.path.join(work, "exported")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_cli.main(["--run-dir", main_dir, "--out", exported,
                              "--device", "cuda"])
    log(buf.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.export returned {rc}")
    out_f = os.path.join(work, "trained_samples")
    fa.reset_launches()
    secs, cap_s = run_cli(sample, [
        "--run-dir", exported, "--method", "ddim", "--num-steps", "20",
        "--batch-size", "4", "--label", "1", "--seed", "3", "--out", out_f,
        "--device", "cuda"])
    check_launches(fa.launches, WARMUP_STEPS + 1, "graphed DDIM-20 from the "
                   "trained run")
    xs = np.load(os.path.join(out_f, "samples.npy"))
    if xs.shape != (4, 256, 256, 1) or not np.isfinite(xs).all():
        raise AssertionError(f"samples from the trained run {xs.shape} not "
                             "finite/shaped")
    out["trained_sample"] = dict(method="ddim", steps=20, batch=4,
                                 s_per_batch=secs, capture_s=cap_s,
                                 abs_max=float(np.abs(xs).max()))
    log("phase 5f export + DDIM-20 from the trained run: "
        + json.dumps(out["trained_sample"]))
    return out, train_launches


def write_run(path, seed, fp, tcfg, model_from_config):
    """An exported run dir: config.yaml + ema_params.npz of the full-width
    wide256 with seeded random values on every leaf."""
    cfg = tcfg.Config()
    cfg.model.preset = "wide256"
    cfg.model.num_classes = 2
    cfg.model.conditional = True
    cfg.model.compute_dtype = "bfloat16"
    cfg.training.resolution = 256
    cfg.training.num_timesteps = 1000
    os.makedirs(path, exist_ok=True)
    tcfg.save_config(cfg, os.path.join(path, "config.yaml"))
    shapes = fp.flax_shapes(model_from_config(cfg, device="meta"))
    n = fp.export_params(fp.random_params(shapes, seed),
                         os.path.join(path, fp.EXPORT_FILE))
    return n


def run_cli(sample, argv, eager=False):
    """cli.sample: seconds of batch 0 (the capture before it not counted),
    and the capture's seconds (None for an eager run)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sample.main(argv, eager=eager)
    text = buf.getvalue()
    log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"cli.sample returned {rc}")
    secs = float(re.search(r"batch 0: ([0-9.]+)s", text).group(1))
    cap = re.search(r"CUDA graph in ([0-9.]+)s", text)
    if eager != (cap is None):
        raise AssertionError(f"cli.sample eager={eager} but the run "
                             f"{'did' if cap else 'did not'} capture a graph")
    return secs, None if cap is None else float(cap.group(1))


def sample_pair(sample, argv, what):
    """The same cli.sample run eagerly ("before") and through its CUDA
    graph, with the same seed: outputs equal bit for bit. Returns a row of
    both runs' s per batch, capture s, peak GB and B1 / B4 launches, and
    each run's counts: the wrappers' B1 / B4 launches by shape (all, and
    those made under capture), the graphs captured and replayed, and the
    run's B1 / B4 launches by shape (:func:`run_launches`)."""
    import numpy as np
    import torch

    from superdiff_torch.diffusion import graphed
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.ops import fused_norm as fn

    out_dir = argv[argv.index("--out") + 1]
    row, outs, counts = {}, {}, {}
    for eager in (True, False):
        tag = "eager" if eager else "graph"
        run_argv = argv[:]
        run_argv[run_argv.index("--out") + 1] = f"{out_dir}_{tag}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        fn.reset_launches()
        graphed.reset_counts()
        secs, cap = run_cli(sample, run_argv, eager=eager)
        counts[tag] = dict(b1=fa.launches, b4=fn.launches,
                           b1_by_shape=dict(fa.launches_by_shape),
                           b1_captured=dict(fa.captured_by_shape),
                           b1_run=run_launches(fa.launches_by_shape,
                                               fa.captured_by_shape),
                           b4_by_shape=dict(fn.launches_by_shape),
                           b4_captured=dict(fn.captured_by_shape),
                           b4_run=run_launches(fn.launches_by_shape,
                                               fn.captured_by_shape),
                           captures=graphed.captures,
                           replays=graphed.replays)
        row[tag] = dict(s_per_batch=secs, capture_s=cap,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                        b1_wrapper_launches=fa.launches,
                        b1_run_launches=sum(counts[tag]["b1_run"].values()),
                        b4_wrapper_launches=fn.launches,
                        b4_captured_per_replay=sum(
                            fn.captured_by_shape.values()),
                        b4_run_launches=sum(counts[tag]["b4_run"].values()),
                        graph_replays=graphed.replays)
        d = f"{out_dir}_{tag}"
        outs[tag] = [np.load(os.path.join(d, "samples.npy"))]
        if os.path.exists(os.path.join(d, "logq.json")):
            with open(os.path.join(d, "logq.json")) as f:
                lq = json.load(f)
            outs[tag].append(np.array([lq["logq_model1"],
                                       lq["logq_model2"]]))
            row[tag]["logq_gap_mean"] = lq["logq_gap_mean"]
        if not all(np.isfinite(a).all() for a in outs[tag]):
            raise AssertionError(f"{what} ({tag}): output not finite")
    equal = all(np.array_equal(a, b) for a, b in zip(outs["eager"],
                                                     outs["graph"]))
    if not equal:
        errs = [float(np.abs(a - b).max()) for a, b in zip(outs["eager"],
                                                           outs["graph"])]
        raise AssertionError(f"{what}: graphed run differs from the eager "
                             f"run (max abs {errs})")
    row["graph_equals_eager_bit_for_bit"] = equal
    row["speedup"] = row["eager"]["s_per_batch"] / row["graph"]["s_per_batch"]
    row["shape"] = list(outs["graph"][0].shape)
    return row, outs["graph"], counts


def profile_denoiser(model, batch, calls=5, kernels=FLASH_KERNELS[:1]):
    """Host wall time vs device busy time of ``calls`` denoiser calls
    (torch.profiler kernel events), the device's idle share, the share of
    device time of the kernels named in ``kernels`` (B1 by default), and the
    top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((batch, 256, 256, 1), device="cuda")
    t = torch.full((batch,), 500, device="cuda", dtype=torch.long)
    y = ([torch.zeros((batch,), device="cuda", dtype=torch.long)]
         if getattr(model, "num_classes", 0) else [])
    with torch.no_grad():
        for _ in range(3):
            model(x, t, *y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            for _ in range(calls):
                model(x, t, *y)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3 / calls
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3 / calls
    share_ms = sum(v for k, v in by_name.items()
                   if any(n in k for n in kernels)) / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    cpu_ops = sorted(((a.key, a.self_cpu_time_total, a.count)
                      for a in prof.key_averages()
                      if a.key.startswith("aten::")), key=lambda r: -r[1])
    return dict(
        aten_ops_per_call=sum(r[2] for r in cpu_ops) / calls,
        top_aten_self_cpu_ms_per_call=[
            [k, v / 1e3 / calls, n // calls] for k, v, n in cpu_ops[:8]],
        batch=batch, wall_ms_per_call=wall_ms,
        device_busy_ms_per_call=busy_ms if busy_ms else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else
        "not measured",
        kernels_share_of_device={"+".join(kernels): (
            share_ms / busy_ms) if busy_ms else "not measured"},
        kernels_per_call=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA) / calls,
        top_kernels_ms_per_call=[[k[:80], v / 1e3 / calls] for k, v in top])


def graph_replay_profile(sampler, replays=20, windows=3):
    """torch.profiler over ``replays`` steps of a captured sampler (the
    step's draw + one replay each): wall and device-busy ms per step, the
    device's idle share, and kernels per replay (all; B1; B4: one
    gn_cluster or gn_apply per call). The profiler loses kernel events now
    and then, which only lowers the counts: of ``windows`` windows the one
    with the most kernel events is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plan = sampler.plan
    g = torch.Generator(device="cuda").manual_seed(0)
    best = None
    for _ in range(windows):
        with torch.no_grad():
            plan.start(torch.randn(plan.shape, generator=g, device="cuda"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            for _ in range(replays):
                if plan.draws_noise:
                    plan.draw(g)
                sampler.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3 / replays
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if best is None or len(kern) > len(best[0]):
            best = (kern, wall_ms)
    kern, wall_ms = best
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / replays
    count = lambda name: sum(name in e.name for e in kern) / replays
    return dict(replays=replays, wall_ms_per_step=wall_ms,
                device_busy_ms_per_step=busy_ms if kern else "not measured",
                device_idle_share=(1 - busy_ms / wall_ms) if kern
                else "not measured",
                kernels_per_replay=len(kern) / replays,
                b1_per_replay=count("flash_fwd_kernel"),
                b4_per_replay=sum(count(k) for k in B4_CALL_KERNELS))


def ddpm_plan(model, batch, label=0):
    """A factory of DDPM-1000 plans of ``model`` at ``batch``, 256²
    (``label`` for a conditional model)."""
    from superdiff_torch.diffusion.samplers import DDPMPlan
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.inference import make_eps_fn_p

    schedule = make_schedule(1000, device="cuda")
    applyp = make_eps_fn_p(model, label if getattr(model, "num_classes", 0)
                           else None)
    return lambda: DDPMPlan(schedule, lambda x, t: applyp(model, x, t),
                            (batch, 256, 256, 1))


def superdiff_plan(models, batch, mode):
    """A factory of SuperDiff plans (T=1000, 256², null label) of
    ``models`` at ``batch``, as cli.sample builds them."""
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import make_eps_fn_p

    def eps(m):
        f = make_eps_fn_p(m)
        return lambda x, t: f(m, x, t)

    schedule = make_schedule(1000, device="cuda")
    fns = [eps(m) for m in models]
    return lambda: SuperDiffPlan(schedule, fns, (batch, 256, 256, 1),
                                 mode=mode)


def graph_steps(make_plan, eager_steps=100, timed_steps=None):
    """One sampler (``make_plan()`` builds a fresh plan) eagerly and
    through its CUDA graph over its last ``eager_steps`` steps, from the
    same state and seed: the state at the end (x, and logq for SuperDiff)
    equal bit for bit; ms per step of the eager run and of the graph over
    the first ``timed_steps`` (default all), the capture's seconds, and a
    profile of graph replays."""
    import torch

    from superdiff_torch.diffusion.graphed import GraphedSampler

    def run(sampler, steps, first=0):
        plan = sampler.plan
        g = torch.Generator(device="cuda").manual_seed(7)
        with torch.no_grad():
            plan.start(torch.randn(plan.shape, generator=g, device="cuda"))
            plan.pos.fill_(first)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(steps):
            plan.draw(g)
            sampler.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - tic) * 1e3 / steps

    state = lambda plan: [t.clone() for t in (
        plan.result() if isinstance(plan.result(), tuple)
        else (plan.result(),))]
    eager = GraphedSampler(make_plan(), capture=False)
    first = eager.num_steps - eager_steps
    eager_ms = run(eager, eager_steps, first)
    want = state(eager.plan)
    del eager
    tic = time.perf_counter()
    graphed = GraphedSampler(make_plan())
    capture_s = time.perf_counter() - tic
    run(graphed, eager_steps, first)
    for got, ref in zip(state(graphed.plan), want):
        if not torch.equal(got, ref):
            err = (got - ref).abs().max().item()
            raise AssertionError(f"graphed {type(graphed.plan).__name__} "
                                 f"differs from eager over steps {first}-"
                                 f"{first + eager_steps - 1} ({err:.3e})")
    timed_steps = timed_steps or graphed.num_steps
    graph_ms = run(graphed, timed_steps)
    return dict(sampler=type(graphed.plan).__name__,
                batch=graphed.plan.shape[0], eager_ms_per_step=eager_ms,
                eager_steps_timed=eager_steps, graph_ms_per_step=graph_ms,
                graph_steps_timed=timed_steps, capture_s=capture_s,
                speedup=eager_ms / graph_ms,
                bit_equal_over_steps=[first, first + eager_steps - 1],
                profile=graph_replay_profile(graphed))


def _post(base, body, timeout=600):
    import urllib.request

    tic = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"{base}/sample", data=json.dumps(body).encode(),
            method="POST"), timeout=timeout) as resp:
        out = json.load(resp)
    return out, time.perf_counter() - tic


def _get(base, path):
    import urllib.request

    with urllib.request.urlopen(f"{base}{path}", timeout=60) as resp:
        return json.load(resp)


def _npy(resp):
    import base64

    import numpy as np

    return np.load(io.BytesIO(base64.b64decode(resp["data"])))


def _serve_http(service, info):
    """Start the HTTP app on an ephemeral port in a thread; returns
    ``(base url, stop)``."""
    import threading

    from superdiff_torch.serve import make_http_server

    httpd = make_http_server(service, "127.0.0.1", 0, info=info)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        service.close()
        th.join(timeout=30)

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def phase_serving(fa, fn, run1, run2, ref_run):
    """The serving slice (phase 7 of the module docstring)."""
    import threading

    import numpy as np
    import torch

    from superdiff_torch.cli import serve as serve_cli
    from superdiff_torch.diffusion import graphed
    from superdiff_torch.diffusion.samplers import ddim_sample
    from superdiff_torch.inference import make_eps_fn_p

    out = {}
    args = serve_cli.build_parser().parse_args([
        "--run-dir", run1, "--run-dir2", run2, "--batch-size", "16",
        "--max-wait-ms", "500", "--device", "cuda"])
    tic = time.time()
    service, cfg, spec = serve_cli.load_service(args)
    fa.reset_launches()
    fn.reset_launches()
    warm_s = service.warmup(spec)
    out["load_s"] = time.time() - tic - warm_s
    b4_captured = sum(fn.captured_by_shape.values())
    out["warmup"] = dict(spec=spec.__dict__, s=warm_s,
                         b1_launches=fa.launches, b4_launches=fn.launches,
                         b4_captured_per_replay=b4_captured)
    check_b4(b4_captured, 1, "the captured serving step")
    base, stop = _serve_http(service, {"run_dir": run1,
                                       "preset": cfg.model.preset})
    try:
        health = _get(base, "/healthz")
        if health != {"status": "ok", "backend": "cuda", "devices":
                      torch.cuda.device_count()}:
            raise AssertionError(f"/healthz: {health}")

        # three concurrent unseeded requests, one spec: one coalesced batch
        before = dict(service.stats)
        graphed.reset_counts()
        b4_wrapper = fn.launches
        bodies = [dict(num=4, label=0), dict(num=4, label=1),
                  dict(num=8)]          # the last: the null label
        results = [None] * 3

        def client(i):
            results[i] = _post(base, dict(bodies[i], method="ddim",
                                          steps=50, format="npy"))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        tic = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - tic
        st = service.stats
        if not (st["batches"] - before["batches"] == 1
                and st["coalesced"] - before["coalesced"] == 2
                and st["samples"] - before["samples"] == 16
                and all(r is not None for r in results)):
            raise AssertionError(f"three requests did not coalesce into one "
                                 f"batch: {before} -> {st}")
        for (resp, _), body in zip(results, bodies):
            x = _npy(resp)
            if x.shape != (body["num"], 256, 256, 1) or not np.isfinite(
                    x).all():
                raise AssertionError(f"coalesced response {x.shape}")
        out["coalesced"] = dict(
            requests=bodies, latency_s=[r[1] for r in results],
            batch_wall_s=wall, samples_per_s=16 / wall,
            graph_replays=graphed.replays,
            b4_run_launches=fn.launches - b4_wrapper
            + b4_captured * graphed.replays)
        if fn.launches != b4_wrapper or graphed.replays != 50:
            raise AssertionError(f"coalesced DDIM-50: {graphed.replays} "
                                 f"replays, {fn.launches - b4_wrapper} B4 "
                                 f"launches outside the graph")

        # one seeded request, twice: the same bytes, and the eager sampler's
        seeded = dict(num=3, label=1, method="ddim", steps=50, seed=1234,
                      format="npy")
        (a, lat_a), (b, lat_b) = _post(base, seeded), _post(base, seeded)
        if a["data"] != b["data"]:
            raise AssertionError("seeded request gave other bytes twice")
        model, schedule = service._model, service._schedule
        applyp = make_eps_fn_p(model, "per_sample")
        y = torch.full((16,), model.null_label, dtype=torch.long,
                       device="cuda")
        y[:3] = 1
        want = ddim_sample(schedule, lambda *z: applyp(model, *z),
                           (16, 256, 256, 1),
                           torch.Generator(device="cuda").manual_seed(1234),
                           num_steps=50, y=y,
                           null_label=model.null_label)[:3].cpu().numpy()
        got = _npy(a)
        if not np.array_equal(got, want):
            raise AssertionError(f"seeded request differs from the eager "
                                 f"sampler: max abs "
                                 f"{np.abs(got - want).max():.3e}")
        out["seeded"] = dict(latency_s=[lat_a, lat_b], equal_bytes=True,
                             equal_to_eager_bit_for_bit=True)

        # DPM++-10 twice: the first request pays its spec's capture
        lats = []
        for _ in range(2):
            resp, lat = _post(base, dict(num=2, label=0, method="dpmpp",
                                         steps=10))
            lats.append(lat)
            if resp["shape"] != [2, 256, 256, 1] or resp["content_type"] \
                    != "image/png":
                raise AssertionError(f"dpmpp response {resp['shape']}")
        out["dpmpp10"] = dict(latency_s=lats)

        resp, lat = _post(base, dict(num=4, method="superdiff", mode="or",
                                     format="npy"))
        logq = np.array(resp["logq"])
        if (logq.shape != (2, 4) or not np.isfinite(logq).all()
                or not np.isfinite(_npy(resp)).all()):
            raise AssertionError(f"superdiff response logq {logq.shape}")
        out["superdiff_or"] = dict(latency_s=lat,
                                   logq_gap_mean=float(
                                       (logq[0] - logq[1]).mean()))
        metrics = _get(base, "/metrics")
        out["metrics"] = metrics
        if metrics["compiles"] != 3:
            raise AssertionError(f"captures: {metrics['compiles']}, "
                                 "expected 3 (ddim-50, dpmpp-10, superdiff)")
    finally:
        stop()
    del service

    # the imported RefUNet run: B4 inside a graph
    args = serve_cli.build_parser().parse_args([
        "--run-dir", ref_run, "--batch-size", "16", "--device", "cuda"])
    service, cfg, spec = serve_cli.load_service(args)
    fn.reset_launches()
    fa.reset_launches()
    warm_s = service.warmup(spec)
    warm = fn.launches
    per_replay = sum(fn.captured_by_shape.values())
    base, stop = _serve_http(service, {"run_dir": ref_run})
    try:
        graphed.reset_counts()
        resp, lat = _post(base, dict(num=4, method="ddim", steps=50,
                                     format="npy"))
        x = _npy(resp)
        if (x.shape != (4, 256, 256, 1) or not np.isfinite(x).all()
                or fn.launches != warm or per_replay != REF_CALLS_B4
                or graphed.replays != 50 or fa.launches):
            raise AssertionError(f"ref serving: {x.shape}, B4 launches "
                                 f"{warm} at warm-up ({per_replay} "
                                 f"captured), {fn.launches} after a "
                                 f"request of {graphed.replays} replays, "
                                 f"B1 {fa.launches}")
        out["ref_ddim50"] = dict(warmup_s=warm_s, latency_s=lat,
                                 b4_wrapper_launches_at_warmup=warm,
                                 b4_captured_per_replay=per_replay,
                                 graph_replays=graphed.replays,
                                 b4_run_launches=per_replay
                                 * graphed.replays,
                                 samples_per_s=4 / lat,
                                 graph_pool_gb=service.stats[
                                     "graph_pool_gb"])
    finally:
        stop()
    return out


def phase_ref(fa, fn, work, sample, load_run, wide_model):
    """The reference-model slice (phase 6 of the module docstring): two
    reference-layout checkpoints through cli.import_torch, then cli.sample
    (DDPM, SuperDiff OR) and cli.train on the full-width RefUNet, every
    GroupNorm->SiLU through B4."""
    import numpy as np
    import torch

    from superdiff_torch.cli import import_torch
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.diffusion import graphed
    from superdiff_torch.diffusion.process import p_losses
    from superdiff_torch.inference import apply_sampling_policy
    from superdiff_torch.models.layers import GroupNormSiLU
    from superdiff_torch.training import steps as train_steps

    out, runs = {}, {}
    tic = time.time()
    for seed, task in ((1, "TB"), (2, "PNEUMONIA")):
        ckpt_dir = os.path.join(work, f"reference_{task}")
        os.makedirs(ckpt_dir, exist_ok=True)
        pt = os.path.join(ckpt_dir, "ema_epoch1.pt")
        torch.save(reference_state_dict(seed), pt)
        runs[task] = os.path.join(work, f"imported_{task}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = import_torch.main(["--checkpoint", pt, "--out", runs[task],
                                    "--task", task])
        log(buf.getvalue().rstrip())
        if rc != 0:
            raise AssertionError(f"cli.import_torch returned {rc}")
    log(f"phase 6 setup: two reference checkpoints imported in "
        f"{time.time() - tic:.3f} s")

    # (a) DDPM-1000, 256², batch 16, unconditional: the main path
    out_a = os.path.join(work, "ref_ddpm")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fn.reset_launches()
    graphed.reset_counts()
    secs, cap_s = run_cli(sample, ["--run-dir", runs["TB"], "--method",
                                   "ddpm", "--batch-size", "16", "--seed",
                                   "0", "--out", out_a, "--device", "cuda"])
    calls = graphed.WARMUP_STEPS + 1
    main_launches = run_launches(fn.launches_by_shape, fn.captured_by_shape)
    main_counts = dict(run=main_launches, wrapper=dict(fn.launches_by_shape),
                       captured=dict(fn.captured_by_shape),
                       replays=graphed.replays)
    captured = sum(fn.captured_by_shape.values())
    if (fn.launches != REF_CALLS_B4 * calls or fa.launches
            or captured != REF_CALLS_B4 or graphed.captures != 1
            or graphed.replays != 1000
            or sum(main_launches.values())
            != REF_CALLS_B4 * (1000 + graphed.WARMUP_STEPS)):
        raise AssertionError(
            f"graphed ref DDPM-1000: {fn.launches} B4 launches through the "
            f"wrapper ({captured} captured) and {fa.launches} B1, "
            f"{graphed.captures} captures, {graphed.replays} replays; "
            f"expected {REF_CALLS_B4 * calls} ({REF_CALLS_B4}), 0, 1, 1000")
    x = np.load(os.path.join(out_a, "samples.npy"))
    if x.shape != (16, 256, 256, 1) or not np.isfinite(x).all():
        raise AssertionError(f"ref DDPM samples {x.shape} not finite/shaped")
    out["ddpm"] = dict(s_per_batch=secs, capture_s=cap_s, batch=16, T=1000,
                       b4_wrapper_launches=fn.launches,
                       b4_captured_per_replay=captured,
                       graph_replays=graphed.replays,
                       b4_run_launches=sum(main_launches.values()),
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       abs_max=float(np.abs(x).max()))
    log("phase 6a ref DDPM-1000 batch 16: " + json.dumps(out["ddpm"]))

    # (b) one call at batch 2, kernel path vs plain path on the card, and
    # the kernel path again with cuDNN's TF32 off (the phase runs with it
    # on), then the call's time and profile at batch 16
    _, model, _ = load_run(runs["TB"], device="cuda")
    strided = []               # norm inputs that GroupNormSiLU had to copy
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: strided.append(1) if not args[0].is_contiguous()
        else None) for m in model.modules() if isinstance(m, GroupNormSiLU)]
    g = torch.Generator(device="cuda").manual_seed(5)
    xb = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    tb = torch.tensor([999, 10], device="cuda")
    with torch.no_grad():
        fn.reset_launches()
        got = model(xb, tb)
        n_kernel = fn.launches
        with tf32(False):
            same_without_tf32 = torch.equal(got, model(xb, tb))
        with b4_swapped_for_plain(fn):
            expect = model(xb, tb)
    for h in hooks:
        h.remove()
    rel = (torch.linalg.norm(got - expect)
           / torch.linalg.norm(expect)).item()
    if not (n_kernel == REF_CALLS_B4
            and fn.launches == 2 * REF_CALLS_B4
            and torch.isfinite(got).all() and rel < REF_REL_TOL
            and not strided and same_without_tf32):
        raise AssertionError(f"RefUNet kernel path vs plain path: rel L2 "
                             f"{rel:.3e} (tolerance {REF_REL_TOL}), "
                             f"{n_kernel} B4 launches, {len(strided)} "
                             f"strided norm inputs; bit-equal without TF32: "
                             f"{same_without_tf32}")
    apply_sampling_policy(model)
    x16 = torch.randn((16, 256, 256, 1), device="cuda")
    t16 = torch.full((16,), 500, device="cuda", dtype=torch.long)
    with torch.no_grad():
        call_ms = cuda_time_ms(lambda: model(x16, t16), 20)
    out["call"] = dict(rel_l2_kernel_vs_plain=rel,
                       bit_equal_tf32_on_off=same_without_tf32,
                       batch16_ms=call_ms,
                       profile=profile_denoiser(model, 16,
                                                kernels=GN_KERNELS))
    log("phase 6b RefUNet call: " + json.dumps(out["call"]))
    out["steps"] = graph_steps(ddpm_plan(model, 16), timed_steps=100)
    if round(out["steps"]["profile"]["b4_per_replay"]) != REF_CALLS_B4:
        raise AssertionError(f"RefUNet graph replay runs "
                             f"{out['steps']['profile']['b4_per_replay']} "
                             f"B4 per step, expected {REF_CALLS_B4}")
    log("phase 6b RefUNet DDPM steps, eager vs graphed: "
        + json.dumps(out["steps"]))
    del model

    # (c) SuperDiff OR of the two imported runs, batch 4, T=1000
    out_c = os.path.join(work, "ref_or")
    fn.reset_launches()
    secs, cap_s = run_cli(sample, ["--run-dir", runs["TB"], "--run-dir2",
                                   runs["PNEUMONIA"], "--mode", "or",
                                   "--batch-size", "4", "--seed", "1",
                                   "--out", out_c, "--device", "cuda"])
    xs = np.load(os.path.join(out_c, "samples.npy"))
    with open(os.path.join(out_c, "logq.json")) as f:
        lq = json.load(f)
    logq = np.array([lq["logq_model1"], lq["logq_model2"]])
    if (fn.launches != 2 * REF_CALLS_B4 * calls
            or xs.shape != (4, 256, 256, 1) or not np.isfinite(xs).all()
            or logq.shape != (2, 4) or not np.isfinite(logq).all()):
        raise AssertionError(f"ref SuperDiff OR: {fn.launches} B4 launches, "
                             f"samples {xs.shape}, logq {logq.shape}")
    out["superdiff_or"] = dict(s_per_batch=secs, capture_s=cap_s, batch=4,
                               T=1000,
                               b4_launches=fn.launches,
                               logq_gap_mean=lq["logq_gap_mean"])
    log("phase 6c ref SuperDiff OR TB x PNEUMONIA: "
        + json.dumps(out["superdiff_or"]))

    # (d) the CondUNet's chains go through B4: one wide256 call without
    # gradients launches 51 B4 (and 8 B1)
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        wide_model(torch.randn((2, 256, 256, 1), device="cuda"),
                   torch.tensor([5, 900], device="cuda"),
                   torch.tensor([0, 1], device="cuda"))
    torch.cuda.synchronize()
    if (fn.launches != WIDE256_CALLS_B4 or fa.launches != 8
            or b1_by_design(fa).get("wgmma")):
        raise AssertionError(f"wide256 call: {fn.launches} B4 and "
                             f"{fa.launches} B1 launches ({b1_by_design(fa)} "
                             f"by design), expected {WIDE256_CALLS_B4} and 8, "
                             "none of B1's wgmma design")
    log(f"phase 6d wide256 call: {WIDE256_CALLS_B4} B4 launches, 8 B1 "
        f"{b1_by_design(fa)}")

    # (e) cli.train on the ref preset, then gradients kernel vs plain
    STEPS, EPOCHS, VAL = 8, 3, 2
    fn.reset_launches()
    train_steps.reset_counts()
    _, metrics = run_train_cli(
        train_cli, work, "ref", 4, EPOCHS, STEPS,
        ["--set", f"training.eval_batches={VAL}"], model_args=REF)
    # from Python: the train step's warm-up and capture, and validation
    expect_n = REF_CALLS_B4 * (2 + EPOCHS * VAL)
    graph = (train_steps.captures, train_steps.replays,
             sum(fn.captured_by_shape.values()))
    tr, va = epoch_rows(metrics, "avg_loss"), epoch_rows(metrics, "val_loss")
    losses = [m["avg_loss"] for m in tr] + [m["val_loss"] for m in va]
    if (fn.launches != expect_n
            or graph != (1, EPOCHS * STEPS - 1, REF_CALLS_B4)
            or not np.isfinite(losses).all()):
        raise AssertionError(f"ref training: {fn.launches} B4 launches "
                             f"(expected {expect_n}), (captures, replays, "
                             f"captured B4) = {graph}, losses {losses}")
    if not (va[-1]["val_loss"] < va[0]["val_loss"]
            and tr[-1]["avg_loss"] < tr[0]["avg_loss"]):
        raise AssertionError(f"ref loss did not fall: train {tr}, val {va}")
    out["train"] = dict(
        batch=4, steps=EPOCHS * STEPS, b4_launches=fn.launches,
        train_loss_by_epoch=[m["avg_loss"] for m in tr],
        val_loss_by_epoch=[m["val_loss"] for m in va],
        images_per_s_last_epoch=tr[-1]["images_per_sec"])
    log("phase 6e cli.train ref: " + json.dumps(out["train"]))

    _, model, schedule = load_run(runs["PNEUMONIA"], device="cuda")
    model.train()
    g = torch.Generator(device="cuda").manual_seed(11)
    x0 = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    noise = torch.randn((2, 256, 256, 1), generator=g, device="cuda")
    t = torch.tensor([700, 20], device="cuda")
    params = list(model.parameters())

    def grads():
        loss = p_losses(schedule, model, x0, t, noise=noise)
        return torch.autograd.grad(loss, params)

    fn.reset_launches()
    g_kernel = grads()
    n_kernel = fn.launches
    with b4_swapped_for_plain(fn):
        g_plain = grads()
    num = sum(((a - b) ** 2).sum() for a, b in zip(g_kernel, g_plain))
    den = sum((b ** 2).sum() for b in g_plain)
    rel = (num.sqrt() / den.sqrt()).item()
    if not (n_kernel == REF_CALLS_B4 and fn.launches == REF_CALLS_B4
            and rel < REF_GRAD_REL_TOL):
        raise AssertionError(f"RefUNet gradients, kernel vs plain: rel L2 "
                             f"{rel:.3e} (tolerance {REF_GRAD_REL_TOL}), "
                             f"{n_kernel} B4 launches")
    out["grad_check"] = dict(rel_l2=rel, leaves=len(params))
    log("phase 6e RefUNet gradients, B4 vs plain: "
        + json.dumps(out["grad_check"]))
    return out, main_counts


def xray_like(rng, h, w):
    """A smooth chest-X-ray-like uint8 image: a vertical gradient, two
    bright elliptical fields and fine noise."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    img = 40 + 60 * yy
    for cx in (0.3, 0.7):
        r2 = ((xx - cx) / 0.17) ** 2 + ((yy - 0.5) / 0.3) ** 2
        img += 110 * np.exp(-r2 * rng.uniform(1.5, 3.0))
    img += rng.normal(0, 6, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_xray_tree(root, per_class, rng):
    """A flat source tree root/{NORMAL,TB}/*.png written with the port's PNG
    writer (no PIL): non-square sizes from 512 to 1024 px a side, row
    filters None/Sub/Up/Average/Paeth and mixed, every 7th image 16-bit
    grayscale, every 11th RGB. Returns the bytes written."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from superdiff_torch.utils.visualization import png_bytes

    def write(job):
        cls, i, seed = job
        r = np.random.default_rng(seed)
        h, w = (int(v) for v in r.integers(512, 1025, 2))
        img = xray_like(r, h, w)
        if i % 7 == 3:
            img = img.astype(np.uint16) * 257
        elif i % 11 == 5:
            img = np.dstack([img, img, img])
        data = png_bytes(img, filter="cycle" if i % 6 == 5 else i % 6)
        with open(os.path.join(root, cls, f"{cls}_{i:04d}.png"), "wb") as f:
            f.write(data)
        return len(data)

    jobs = []
    for cls in ("NORMAL", "TB"):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        jobs += [(cls, i, int(s)) for i, s in enumerate(
            rng.integers(0, 2 ** 31, per_class))]
    # zlib and most numpy kernels release the GIL: threads write in parallel
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return sum(pool.map(write, jobs))


def add_jpeg_fixtures(flat):
    """Copy each committed JPEG fixture into both classes of the flat tree
    under new names, so that the splits, the decode epochs, training and
    the native shard build decode JPEG too. Returns the number of copies."""
    import shutil

    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        names = [e["name"] for e in json.load(f)["files"]]
    for cls in ("NORMAL", "TB"):
        for i, name in enumerate(names):
            shutil.copyfile(os.path.join(JPEG_FIXTURES, name),
                            os.path.join(flat, cls, f"{cls}_jpg_{i:02d}.jpg"))
    return 2 * len(names)


def jpeg_fixture_check(image_io):
    """Decode every committed JPEG fixture (no PIL on this machine): shape
    and SHA-256 of the gray bytes against the manifest, and ms per image
    (mean of 5 decodes after one) by form."""
    import hashlib

    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        entries = json.load(f)["files"]
    rows = {}
    for e in entries:
        path = os.path.join(JPEG_FIXTURES, e["name"])
        img = image_io.read_gray(path)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        if list(img.shape) != e["shape"] or digest != e["sha256"]:
            raise AssertionError(f"JPEG fixture {e['name']}: shape "
                                 f"{img.shape}, sha256 {digest}; manifest "
                                 f"{e['shape']} {e['sha256']}")
        tic = time.perf_counter()
        for _ in range(5):
            image_io.read_gray(path)
        rows[e["form"]] = dict(file=e["name"], shape=e["shape"],
                               ms=(time.perf_counter() - tic) * 200,
                               sha256_matches=True)
    return rows


def trace_idle_share(path):
    """Device busy ms and idle share of a torch.profiler chrome trace:
    the union of kernel, memcpy and memset intervals against the span of
    all the trace's events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return "not measured", "not measured"
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    return busy / 1e3, 1.0 - busy / window


def phase_data_eval(fa, fn, work, card_line):
    """The data and evaluation slice (phase 8 of the module docstring)."""
    import numpy as np
    import torch

    from superdiff_torch import config as tcfg
    from superdiff_torch.analysis import FeatureExtractor, load_classifier
    from superdiff_torch.analysis.fid import _stats, frechet_distance
    from superdiff_torch.cli import evaluate as evaluate_cli
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.data import DataModule, image_io, split_dataset
    from superdiff_torch.data.dataset import BatchIterator
    from superdiff_torch.data.native_loader import NativeBatchIterator
    from superdiff_torch.data.transforms import clahe, host_resize
    from superdiff_torch.diffusion import graphed
    from superdiff_torch.inference import load_run
    from superdiff_torch.tools.tune_group_norm import chain_inputs, gn_library
    from superdiff_torch.training import steps as train_steps
    from superdiff_torch.utils.visualization import png_bytes

    out = {"card": card_line}
    rng = np.random.default_rng(8)
    # (a) a PNG tree, split 70/15/15; host decode, resize, CLAHE, loaders
    tic = time.time()
    flat, root = os.path.join(work, "xray_flat"), os.path.join(work, "xray")
    nbytes = make_xray_tree(flat, TREE_PER_CLASS, rng)
    n_jpeg = add_jpeg_fixtures(flat)
    counts = split_dataset(flat, os.path.join(root, "TB"))
    jpeg_by_split = {sp: sum(n.endswith(".jpg") for cls in ("NORMAL", "TB")
                             for n in os.listdir(os.path.join(root, "TB", sp,
                                                              cls)))
                     for sp in ("train", "val", "test")}
    out["tree"] = dict(images=2 * TREE_PER_CLASS + n_jpeg, png=2 *
                       TREE_PER_CLASS, jpeg=n_jpeg,
                       jpeg_by_split=jpeg_by_split, mb=nbytes / 1e6,
                       split=counts, write_s=time.time() - tic)
    if not jpeg_by_split["train"]:
        raise AssertionError("no JPEG landed in the train split")
    if image_io.unfilter_backend() != "native":
        raise AssertionError("PNG rows are not unfiltered by the C++ library")
    out["jpeg_fixtures"] = jpeg_fixture_check(image_io)
    log(f"phase 8a JPEG fixtures decoded without PIL, hashes match "
        f"({card_line}): " + json.dumps(out["jpeg_fixtures"]))
    files = sorted(os.path.join(flat, "NORMAL", n)
                   for n in os.listdir(os.path.join(flat, "NORMAL")))
    by_size = {}
    for path in files[:48]:
        tic = time.perf_counter()
        img = image_io.read_gray(path)
        dt = time.perf_counter() - tic
        side = "<=768" if max(img.shape) <= 768 else ">768"
        by_size.setdefault(side, []).append(dt * 1e3)
    big = xray_like(rng, 1024, 1024)
    big_png = os.path.join(work, "paeth_1024.png")
    with open(big_png, "wb") as f:
        f.write(png_bytes(big, filter=4))
    # the numpy plain version, over 16 Paeth rows of 1024 bytes
    raw_rows = np.zeros(16 * 1025, np.uint8)
    raw_rows[::1025] = 4
    tic = time.perf_counter()
    for _ in range(5):
        image_io.read_gray(big_png)
    paeth_ms = (time.perf_counter() - tic) * 200
    tic = time.perf_counter()
    image_io.unfilter_plain(raw_rows, 16, 1024, 1)
    plain_ms = (time.perf_counter() - tic) * 1e3 * 1024 / 16
    tic = time.perf_counter()
    for _ in range(5):
        r256 = host_resize(big, 256, "pad")
    resize_ms = (time.perf_counter() - tic) * 200
    tic = time.perf_counter()
    for _ in range(5):
        clahe(r256)
    clahe_ms = (time.perf_counter() - tic) * 200
    cfg = tcfg.load_config(None, ["training.resolution=256",
                                  "training.batch_size=16"])
    cfg.task = "TB"
    dm = DataModule(cfg, root)
    idx = dm.index("train")
    it = BatchIterator(idx, 16, 256, seed=0)
    rates = []
    for _ in range(2):                      # decode epoch, cached epoch
        tic = time.perf_counter()
        n = sum(len(b["label"]) for b in it)
        rates.append(n / (time.perf_counter() - tic))
    tic = time.perf_counter()
    native_it = dm.iterator("train")        # builds the shard
    shard_s = time.perf_counter() - tic
    if not isinstance(native_it, NativeBatchIterator):
        raise AssertionError(f"DataModule gave {type(native_it).__name__}, "
                             "not the native loader")
    tic = time.perf_counter()
    n = sum(len(b["label"]) for b in native_it)
    native_rate = n / (time.perf_counter() - tic)
    out["host"] = dict(
        decode_ms_by_side={k: float(np.mean(v)) for k, v in by_size.items()},
        decode_images_by_side={k: len(v) for k, v in by_size.items()},
        decode_ms_1024_paeth=paeth_ms,
        unfilter_plain_ms_1024_paeth_from_16_rows=plain_ms,
        host_resize_pad_ms_1024_to_256=resize_ms, clahe_ms_256=clahe_ms,
        batch_iterator_images_per_s=dict(decode_epoch=rates[0],
                                         cached_epoch=rates[1]),
        native_shard_build_s=shard_s,
        native_images_per_s=native_rate)
    log(f"phase 8a host data path ({card_line}): " + json.dumps(out["tree"])
        + " " + json.dumps(out["host"]))

    # (b) cli.train on the tree (native loader) and on --synthetic, wide256
    steps = len(native_it)
    n_val = -(-len(dm.index("val")) // 16)
    legs = {}
    for leg in ("tree", "synthetic"):
        fa.reset_launches()
        fn.reset_launches()
        train_steps.reset_counts()
        src = (["--dataset", "TB", "--dataset-root", root] if leg == "tree"
               else ["--synthetic", "--set",
                     f"training.steps_per_epoch={steps}", "--set",
                     f"training.eval_batches={n_val}"])
        buf = io.StringIO()
        tic = time.time()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main([
                *src, "--device", "cuda", "--experiment-id", "smoke8",
                "--run-id", leg, *WIDE256, *TRAIN_NORM,
                "--set", "training.batch_size=16",
                "--set", "training.num_epochs=2",
                "--set", "training.eval_every=2",
                "--set", "training.save_every=0",
                "--set", "logging.profile_steps=5",
                "--set", "logging.stdout=false",
                "--set", f"paths.local_base={work}"])
        if rc != 0:
            raise AssertionError(f"cli.train ({leg}) returned {rc}")
        run_dir = os.path.join(work, "outputs", "TB" if leg == "tree"
                               else "PNEUMONIA",
                               f"experiment_smoke8_run_{leg}")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        tr, va = epoch_rows(metrics, "avg_loss"), epoch_rows(metrics,
                                                             "val_loss")
        busy, idle = trace_idle_share(os.path.join(run_dir, "profile",
                                                   "trace.json"))
        vb = n_val
        counts = flash_counts(fa)
        expect = (8 * (2 + vb), 16, 16)
        if counts != expect:
            raise AssertionError(f"{leg} training launched (B1, B2, B3) = "
                                 f"{counts}, expected {expect}")
        check_train_graph(fa, train_steps, 2 * steps, (8, 8, 8),
                          f"{leg} training")
        C4 = WIDE256_CALLS_B4
        check_train_b4(fn, C4 * (2 + vb), 2 * C4, (C4, C4),
                       f"{leg} training")
        if len(tr) != 2 or len(va) != 1 or not np.isfinite(
                [m["avg_loss"] for m in tr] + [va[0]["val_loss"]]).all():
            raise AssertionError(f"{leg} training metrics: {metrics}")
        ips = tr[1]["images_per_sec"]
        legs[leg] = dict(
            steps_per_epoch=steps, images_per_s_by_epoch=[
                m["images_per_sec"] for m in tr],
            images_per_s=ips, ms_per_step=16 / ips * 1e3,
            val_loss=va[0]["val_loss"], val_batches=vb,
            train_loss_by_epoch=[m["avg_loss"] for m in tr],
            profiled_device_busy_ms=busy, device_idle_share=idle,
            b4_per_train_step=C4, b4_backward_per_train_step=C4,
            b4_per_val_batch=(fn.launches - 2 * C4) // vb,
            whole_leg_s=time.time() - tic)
        if leg == "tree":
            tree_run = run_dir
    legs["tree_over_synthetic_images_per_s"] = (
        legs["tree"]["images_per_s"] / legs["synthetic"]["images_per_s"])
    out["train"] = legs
    log(f"phase 8b cli.train wide256 256² batch 16 on the tree vs "
        f"--synthetic ({card_line}): " + json.dumps(legs))

    # (c) cli.evaluate on the tree run: DDIM-100, 64 samples, 4 extractors
    ext = os.path.join(HERE, "artifacts", "extractors")
    cls_npz = os.path.join(ext, "smallcnn_trained_256.npz")
    r18_npz = os.path.join(ext, "resnet18_rand_seed1234.npz")
    fa.reset_launches()
    fn.reset_launches()
    graphed.reset_counts()
    record = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = evaluate_cli.main([
            "--run-dir", tree_run, "--dataset-root", root,
            "--num-samples", "64", "--batch-size", "16",
            "--extractor", "classifier,resnet18,random,diffusion",
            "--extractor-checkpoint",
            f"classifier={cls_npz},resnet18={r18_npz}",
            "--out", os.path.join(work, "eval.json"), "--device", "cuda"],
            record=record)
    if rc != 0:
        raise AssertionError(f"cli.evaluate returned {rc}")
    eval_b4 = run_launches(dict(fn.launches_by_shape),
                           dict(fn.captured_by_shape))
    eval_b4_wrapper = dict(fn.launches_by_shape)
    with open(os.path.join(work, "eval.json")) as f:
        results = json.load(f)
    fids = results["fid_by_extractor"]
    if not all(np.isfinite(v) for v in fids.values()) or len(fids) != 4:
        raise AssertionError(f"FIDs {fids}")
    if graphed.captures != 1 or graphed.replays != 400:
        raise AssertionError(f"evaluate sampling: {graphed.captures} "
                             f"captures, {graphed.replays} replays")
    # 8 feature batches per extractor (64 real + 64 generated, batch 16):
    # classifier 5 B4 each, random 3, diffusion 51 (+ 8 B1); the sampler's
    # warm-up and captured steps 51 each
    wrapper_b4 = sum(eval_b4_wrapper.values())
    expect_b4 = 8 * (5 + 3 + WIDE256_CALLS_B4) + WIDE256_CALLS_B4 * (
        graphed.WARMUP_STEPS + 1)
    if wrapper_b4 != expect_b4:
        raise AssertionError(f"evaluate: {wrapper_b4} B4 wrapper launches, "
                             f"expected {expect_b4}")
    # per batch, each extractor alone, on a batch of the test split
    run_cfg, f_model, sched = load_run(tree_run, device="cuda")
    real = next(iter(DataModule(run_cfg, root).device_batches(
        "test", None, device="cuda")))["image"]
    per_batch = {}
    probe_t = min(100, run_cfg.training.num_timesteps - 1)
    for name, kw in (("classifier", dict(checkpoint=cls_npz)),
                     ("random", {}),
                     ("diffusion", dict(model=f_model, schedule=sched,
                                        timestep=probe_t))):
        ex = FeatureExtractor(name, device="cuda", **kw)
        ex.extract(real)                    # warm
        fa.reset_launches()
        fn.reset_launches()
        ex.extract(real)
        torch.cuda.synchronize()
        per_batch[name] = dict(B4=fn.launches, B1=fa.launches,
                               by_shape={str(k): v for k, v in
                                         fn.launches_by_shape.items()})
    if (per_batch["classifier"]["B4"], per_batch["random"]["B4"],
            per_batch["diffusion"]["B4"], per_batch["diffusion"]["B1"]) != (
                5, 3, WIDE256_CALLS_B4, 8):
        raise AssertionError(f"B4/B1 launches per feature batch: {per_batch}")
    n_feat = 2 * results["num_generated"]
    out["evaluate"] = dict(
        fid_by_extractor=fids, sample_s=record["sample_s"],
        sampler=results["sampler"], sampler_steps=results["sampler_steps"],
        extract_s=record["extract_s"],
        features_per_s={k: n_feat / v for k, v in
                        record["extract_s"].items()},
        graph_replays=graphed.replays, b4_wrapper_launches=wrapper_b4,
        launches_per_batch=per_batch)
    log(f"phase 8c cli.evaluate ({card_line}): " + json.dumps(out["evaluate"]))

    # (d) B4 at the SmallCNN's chain shapes against the plain chain, then the
    # whole extractor's features and FID with B4 and with the plain chain
    rows = {}
    for (B, H, W, C) in SMALLCNN_SHAPES:
        x, gamma, beta, _, _ = chain_inputs(B, H, W, C, False, torch.float32,
                                            seed=C + H)
        call = lambda: fn.fused_groupnorm_silu(x, gamma, beta, 8, eps=1e-6)
        y = call()
        ref = fn.gn_silu_plain(x, gamma, beta, 8, eps=1e-6)
        err = (y - ref).abs().max().item()
        if not (torch.isfinite(y).all() and err < SMALLCNN_B4_TOL
                and torch.equal(y, call())):
            raise AssertionError(f"B4 at the SmallCNN shape {(B, H, W, C)}: "
                                 f"max abs err {err:.3e} or rerun differs")
        dev = kernel_device_ms(call, kernel=GN_KERNELS)
        plain = lambda: fn.gn_silu_plain(x, gamma, beta, 8, eps=1e-6)
        library = lambda: gn_library(x, gamma, beta, 8, None, None)
        row = dict(shape=[B, H, W, C], groups=8, eps=1e-6, max_abs_err=err,
                   ms=cuda_time_ms(call, 50), kernel_device_ms=dev,
                   graph_ms=graph_time_ms(call),
                   plain_ms=cuda_time_ms(plain, 20),
                   plain_graph_ms=graph_time_ms(plain),
                   library_ms=cuda_time_ms(library, 50),
                   library_graph_ms=graph_time_ms(library),
                   bound_ms=2 * x.numel() * 4 / HBM_BPS * 1e3,
                   bound_by="bytes",
                   regime=fn.launch_geometry(B, H * W, C, 8, torch.float32,
                                             torch.float32, True).regime)
        rows[(H, W, C)] = row
        log("smallcnn_b4_check " + json.dumps(row))
        del x, y, ref
    model = load_classifier(cls_npz, device="cuda")
    gen = torch.from_numpy(record["samples"]).cuda()
    reals = torch.cat([b["image"] for b in DataModule(run_cfg, root)
                       .device_batches("test", None, device="cuda")])[:64]

    def feats(images):
        with torch.no_grad():
            return torch.cat([model(images[i:i + 16],
                                    return_features=True)[1].mean((1, 2))
                              for i in range(0, len(images), 16)]
                             ).cpu().numpy().astype(np.float64)

    with tf32(False):
        k_real, k_gen = feats(reals), feats(gen)
        with b4_swapped_for_plain(fn):
            p_real, p_gen = feats(reals), feats(gen)
    rel = float(np.linalg.norm(np.concatenate([k_real, k_gen])
                               - np.concatenate([p_real, p_gen]))
                / np.linalg.norm(np.concatenate([p_real, p_gen])))
    fid_k = frechet_distance(*_stats(k_real), *_stats(k_gen))
    fid_p = frechet_distance(*_stats(p_real), *_stats(p_gen))
    fid_rel = abs(fid_k - fid_p) / abs(fid_p)
    if not (rel < SMALLCNN_FEAT_TOL and fid_rel < SMALLCNN_FID_TOL):
        raise AssertionError(f"SmallCNN B4 vs plain: features rel L2 "
                             f"{rel:.3e}, FID rel {fid_rel:.3e}")
    out["smallcnn_b4"] = dict(
        rows=[rows[k] for k in sorted(rows, reverse=True)],
        b4_device_ms_5_chains=(
            sum(r["kernel_device_ms"] for r in rows.values())
            if all(isinstance(r["kernel_device_ms"], float)
                   for r in rows.values()) else "not measured"),
        graph_ms_5_chains=sum(r["graph_ms"] for r in rows.values()),
        plain_graph_ms_5_chains=sum(r["plain_graph_ms"]
                                    for r in rows.values()),
        library_graph_ms_5_chains=sum(r["library_graph_ms"]
                                      for r in rows.values()),
        plain_ms_5_chains=sum(r["plain_ms"] for r in rows.values()),
        bound_ms_5_chains=sum(r["bound_ms"] for r in rows.values()),
        features_rel_l2=rel, fid_b4=fid_k, fid_plain=fid_p,
        fid_rel_diff=fid_rel)
    log(f"phase 8d SmallCNN B4 vs plain chain ({card_line}): "
        + json.dumps({k: v for k, v in out["smallcnn_b4"].items()
                      if k != "rows"}))
    return out, rows, eval_b4, (tree_run, root)


def distill_counts(fa, fn):
    """(B1, B2, B3, B4, B4 backward) launches through the wrappers since
    the reset."""
    return flash_counts(fa) + (fn.launches, fn.bwd_launches)


def phase_distill(fa, fn, work, card_line, tree_run, root):
    """The distillation slice (phase 9 of the module docstring)."""
    import copy

    import numpy as np
    import torch

    from superdiff_torch.cli import distill as distill_cli
    from superdiff_torch.cli import evaluate as evaluate_cli
    from superdiff_torch.cli import export as export_cli
    from superdiff_torch.cli import sample
    from superdiff_torch.config import load_config
    from superdiff_torch.data import DataModule
    from superdiff_torch.diffusion import graphed
    from superdiff_torch.diffusion.distill import make_distill_step
    from superdiff_torch.diffusion.graphed import WARMUP_STEPS
    from superdiff_torch.inference import (load_run, make_eps_fn_p,
                                           resolve_sampler_spec)
    from superdiff_torch.models.presets import model_from_config
    from superdiff_torch.training.loop import _uint8_batch
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)

    out = {"card": card_line}
    teacher_dir = os.path.join(work, "tree_export")
    base = os.path.join(work, "distill")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if export_cli.main(["--run-dir", tree_run, "--out", teacher_dir,
                            "--device", "cuda"]):
            raise AssertionError("cli.export of the tree run failed")

    # (a) cli.distill on the tree: 4 -> 2 -> 1 steps, one epoch per phase,
    # batch 16; launches counted over the whole run
    fa.reset_launches()
    fn.reset_launches()
    tic = time.time()
    with contextlib.redirect_stdout(buf):
        rc = distill_cli.main([
            "--run-dir", teacher_dir, "--dataset-root", root, "--steps",
            ",".join(map(str, DISTILL_STEPS)), "--phase-epochs", "1",
            "--batch-size", "16", "--out", base, "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"cli.distill returned {rc}")
    cli_s = time.time() - tic
    with open(os.path.join(base, "summary.json")) as f:
        summary = json.load(f)
    steps = sum(p["steps"] for p in summary["phases"])
    counts = distill_counts(fa, fn)
    expect = tuple(n * steps for n in DISTILL_PER_STEP)
    if counts != expect:
        raise AssertionError(f"cli.distill launched (B1, B2, B3, B4, B4 "
                             f"backward) = "
                             f"{counts} over {steps} steps, expected "
                             f"{expect}")
    launches = dict(fwd=dict(fa.launches_by_shape),
                    dq=dict(fa.bwd_dq_launches_by_shape),
                    dkv=dict(fa.bwd_dkv_launches_by_shape),
                    b4=dict(fn.launches_by_shape))
    for p in summary["phases"]:
        if not np.isfinite([p["first_loss"], p["last_loss"]]).all():
            raise AssertionError(f"distillation phase {p}: loss not finite")
    out["cli"] = dict(
        seconds=cli_s, steps=steps, steps_per_phase=summary["steps_per_epoch"],
        launches_per_step=dict(zip(("B1", "B2", "B3", "B4", "B4_backward"),
                                   (n // steps for n in counts))),
        phases=[{k: v for k, v in p.items() if k != "out"}
                for p in summary["phases"]])
    log(f"phase 9a cli.distill wide256 256² batch 16 on the tree, steps "
        f"{DISTILL_STEPS} ({card_line}): " + json.dumps(out["cli"]))

    # a distillation step alone, as cli.distill's first phase builds it, on
    # one batch of the tree: launches of a step and of the teacher's two
    # calls alone, CUDA-event ms, and a profiler window over 3 steps and
    # over 3 teacher rollouts (device busy, idle share, teacher share)
    cfg, teacher, schedule = load_run(teacher_dir, device="cuda")
    teacher.requires_grad_(False)
    s_cfg = copy.deepcopy(cfg)
    s_cfg.model.parameterization = "v"
    s_cfg.training.batch_size = 16
    tfn = make_eps_fn_p(teacher, "per_sample", schedule=schedule)

    def fresh_state():
        student = model_from_config(s_cfg, device="cuda")
        student.load_state_dict(teacher.state_dict())
        return create_train_state(
            student, torch.Generator(device="cuda").manual_seed(0),
            tx=make_optimizer(learning_rate=1e-4),
            ema_decay=cfg.training.ema_decay)

    step_fn = make_distill_step(
        schedule, tfn, DISTILL_STEPS[0], conditional=True,
        parameterization="v", null_prob=0.5, null_label=teacher.null_label,
        normalization=cfg.training.normalization, clip_x0=True)
    batch = _uint8_batch(next(iter(DataModule(s_cfg, root).iterator(
        "train", epoch=0))), "cuda")
    state = fresh_state()
    x0 = batch["image"].float() / 127.5 - 1.0
    t_hi = torch.full((16,), schedule.num_timesteps - 1, device="cuda")
    t_mid = torch.full((16,), schedule.num_timesteps // 2, device="cuda")

    def step():
        step_fn(state, teacher, batch)

    def teacher_rollout():
        with torch.no_grad():
            tfn(teacher, x0, t_hi, batch["label"])
            tfn(teacher, x0, t_mid, batch["label"])

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    fa.reset_launches()
    fn.reset_launches()
    step()
    torch.cuda.synchronize()
    per_step = distill_counts(fa, fn)
    fa.reset_launches()
    fn.reset_launches()
    teacher_rollout()
    torch.cuda.synchronize()
    per_teacher = (fa.launches, fn.launches)
    if (per_step != DISTILL_PER_STEP
            or per_teacher != TEACHER_CALLS_PER_STEP):
        raise AssertionError(f"a distillation step launched (B1, B2, B3, B4,"
                             f" B4 backward)"
                             f" = {per_step} (expected {DISTILL_PER_STEP}); "
                             f"its teacher calls (B1, B4) = {per_teacher} "
                             f"(expected {TEACHER_CALLS_PER_STEP})")
    step_ms = cuda_time_ms(step, 5, warmup=1)
    teacher_ms = cuda_time_ms(teacher_rollout, 5, warmup=1)
    from torch.profiler import ProfilerActivity, profile
    windows = {}
    for name, fn_ in (("step", step), ("teacher", teacher_rollout)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn_()
            torch.cuda.synchronize()
        path = os.path.join(work, f"distill_{name}_trace.json")
        prof.export_chrome_trace(path)
        windows[name] = trace_idle_share(path)
    busy, idle = windows["step"]
    t_busy = windows["teacher"][0]
    out["step"] = dict(
        batch=16, ms_per_step_events=step_ms,
        teacher_two_calls_ms_events=teacher_ms,
        device_busy_ms_per_step=(busy / 3 if isinstance(busy, float)
                                 else busy),
        device_idle_share=idle,
        teacher_device_busy_ms_per_step=(t_busy / 3 if isinstance(
            t_busy, float) else t_busy),
        teacher_share_of_device_busy=(
            t_busy / busy if isinstance(busy, float)
            and isinstance(t_busy, float) else "not measured"),
        launches_per_step=dict(zip(("B1", "B2", "B3", "B4", "B4_backward"),
                                   per_step)),
        teacher_launches_per_step=dict(zip(("B1", "B4"), per_teacher)),
        student_launches_per_step=dict(
            B1=per_step[0] - per_teacher[0], B2=per_step[1],
            B3=per_step[2], B4=per_step[3] - per_teacher[1],
            B4_backward=per_step[4]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"phase 9a distillation step alone ({card_line}): "
        + json.dumps(out["step"]))
    del state

    # (d) one step at batch 2, kernels against their plain versions: the
    # loss, and the gradients through Adam's first moment (mu = 0.1 g after
    # one update from zero), pooled relative L2
    g = torch.Generator(device="cuda").manual_seed(9)
    draws = {"drop": torch.tensor([False, True], device="cuda"),
             "i": torch.tensor([0, DISTILL_STEPS[0] - 1], device="cuda"),
             "noise": torch.randn((2, 256, 256, 1), generator=g,
                                  device="cuda")}
    small = {k: v[:2] for k, v in batch.items()}
    res = {}
    for tag in ("kernels", "plain"):
        st = fresh_state()
        fa.reset_launches()
        fn.reset_launches()
        with contextlib.ExitStack() as plain:
            if tag == "plain":
                plain.enter_context(flash_swapped_for_plain(fa))
                plain.enter_context(b4_policy_swapped_for_plain(fn))
            _, m = step_fn(st, teacher, small, draws)
        torch.cuda.synchronize()
        res[tag] = (m["loss"].item(), [a.float() for a in
                                       st.opt_state["mu"]],
                    distill_counts(fa, fn))
        del st
    if res["kernels"][2] != DISTILL_PER_STEP or res["plain"][2] != (0,) * 5:
        raise AssertionError(f"kernel / plain passes launched "
                             f"{res['kernels'][2]} / {res['plain'][2]}")
    (loss_k, mu_k, _), (loss_p, mu_p, _) = res["kernels"], res["plain"]
    rel = (sum(((a - b) ** 2).sum() for a, b in zip(mu_k, mu_p)).sqrt()
           / sum((b ** 2).sum() for b in mu_p).sqrt()).item()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not (rel < GRAD_REL_TOL and loss_rel < GRAD_REL_TOL):
        raise AssertionError(f"distillation step, kernels vs plain: "
                             f"gradients rel L2 {rel:.4e}, loss rel "
                             f"{loss_rel:.4e} (tolerance {GRAD_REL_TOL})")
    out["kernels_vs_plain"] = dict(batch=2, loss_kernels=loss_k,
                                   loss_plain=loss_p, loss_rel=loss_rel,
                                   grad_rel_l2=rel, tolerance=GRAD_REL_TOL)
    log("phase 9d distillation step at batch 2, kernels vs plain: "
        + json.dumps(out["kernels_vs_plain"]))
    del teacher

    # (b) cli.sample of each student, no --method: the stamp picks trailing
    # DDIM-N with clip_x0 off; graphed at batch 16; s4 also eagerly (the
    # same bits)
    samples = {}
    for n in DISTILL_STEPS:
        sdir = os.path.join(base, f"s{n}")
        spec = resolve_sampler_spec(load_config(os.path.join(sdir,
                                                             "config.yaml")))
        if spec != ("ddim", n, "trailing", False):
            raise AssertionError(f"student s{n} resolves to {spec}")
        out_dir = os.path.join(work, f"distill_s{n}")
        argv = ["--run-dir", sdir, "--batch-size", "16", "--seed", "3",
                "--out", out_dir, "--device", "cuda"]
        if n == DISTILL_STEPS[0]:
            row, _, c = sample_pair(sample, argv, f"student s{n}")
            c = c["graph"]
        else:
            fa.reset_launches()
            fn.reset_launches()
            graphed.reset_counts()
            secs, cap = run_cli(sample, argv)
            x = np.load(os.path.join(out_dir, "samples.npy"))
            if x.shape != (16, 256, 256, 1) or not np.isfinite(x).all():
                raise AssertionError(f"student s{n} samples {x.shape}, "
                                     "finite or not")
            row = dict(graph=dict(s_per_batch=secs, capture_s=cap))
            c = dict(b1=fa.launches, b4=fn.launches,
                     replays=graphed.replays)
        if c["replays"] != n:
            raise AssertionError(f"student s{n}: {c['replays']} replays")
        check_launches(c["b1"], WARMUP_STEPS + 1, f"student s{n} graph")
        check_b4(c["b4"], WARMUP_STEPS + 1, f"student s{n} graph")
        row["sampler"] = list(spec)
        samples[f"s{n}"] = row
    out["sample"] = samples
    log(f"phase 9b cli.sample of each student, batch 16 ({card_line}): "
        + json.dumps(samples))

    # (c) cli.evaluate, classifier extractor, 64 samples: s4 by its stamp
    # and the teacher at DDIM-4 trailing (its own clip policy)
    cls_npz = os.path.join(HERE, "artifacts", "extractors",
                           "smallcnn_trained_256.npz")
    evals = {}
    for tag, run, extra in (
            ("s4", os.path.join(base, "s4"), []),
            ("teacher_ddim4_trailing", teacher_dir,
             ["--method", "ddim", "--num-steps", "4", "--spacing",
              "trailing"])):
        record = {}
        path = os.path.join(work, f"eval_{tag}.json")
        with contextlib.redirect_stdout(buf):
            rc = evaluate_cli.main([
                "--run-dir", run, "--dataset-root", root, "--num-samples",
                "64", "--batch-size", "16", "--extractor", "classifier",
                "--extractor-checkpoint", cls_npz, "--out", path,
                "--device", "cuda", *extra], record=record)
        if rc != 0:
            raise AssertionError(f"cli.evaluate ({tag}) returned {rc}")
        with open(path) as f:
            results = json.load(f)
        fid = results["fid_by_extractor"]["classifier"]
        if not np.isfinite(fid) or (results["sampler"],
                                    results["sampler_steps"]) != ("ddim", 4):
            raise AssertionError(f"cli.evaluate ({tag}): {results}")
        evals[tag] = dict(fid_classifier=fid, sample_s=record["sample_s"],
                          extract_s=record["extract_s"]["classifier"])
    out["evaluate"] = evals
    log(f"phase 9c cli.evaluate, classifier FID, 64 samples ({card_line}): "
        + json.dumps(evals))
    return out, launches


# phase 10: the visual slice. Every viz toggle of cli.inspect_data; the
# SmallCNN of the random extractor and of the Grad-CAM classifier has 3
# GroupNorm->SiLU chains (widths 32, 64, 128), all through B4 in float32
VIZ_TOGGLES = ("show_class_counts", "show_batch", "show_augmented", "tsne",
               "tsne_thumbnails", "tsne_umap_thumbnails", "projection_3d",
               "projection_3d_thumbnails", "projection_3d_plotly", "gradcam",
               "histograms", "image_grid")
INSPECT_FILES = ["augmented.png", "batch.png", "hist.png", "projection3d.png",
                 "tsne.png", "tsne_thumbs.png", "tsne_vs_umap.png"] + [
                     f"gradcam/gradcam_{i}.png" for i in range(8)]
VISUALIZE_FILES = ["dashboard.html", "forward_strip.png", "generated.png",
                   "real_vs_generated.png", "trajectory.png",
                   "tsne_real_vs_gen.png"]
SMALLCNN_RANDOM_CHAINS = 3
CLASSIFIER_STEPS = 150           # cli.inspect_data's train_classifier
CAM_TOL = 1e-5                   # CAM through B4 vs the plain chain
NOT_ON_THE_CARD = ("matplotlib", "sklearn", "PIL")


@contextlib.contextmanager
def counted(module, names, fa, fn, rows):
    """Wrap ``module``'s functions ``names``: each call appends its stage
    name, seconds (the device synchronised on both sides) and the B1 / B4
    launches made through the wrappers during it to ``rows``."""
    import torch

    def wrap(name, f):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            b1, b4, tic = fa.launches, fn.launches, time.time()
            result = f(*args, **kwargs)
            torch.cuda.synchronize()
            rows.append(dict(stage=name, s=time.time() - tic,
                             b1=fa.launches - b1, b4=fn.launches - b4))
            return result
        return call

    with swapped(module, **{n: wrap(n, getattr(module, n)) for n in names}):
        yield


def launch_snapshot(fa, fn):
    """Wrapper launches, launches recorded into graphs, and graph replays
    so far (B1 and B4)."""
    from superdiff_torch.diffusion import graphed

    return (fa.launches, sum(fa.captured_by_shape.values()), fn.launches,
            sum(fn.captured_by_shape.values()), graphed.replays)


def run_delta(before, after):
    """(B1, B4) launches of one graphed run between two snapshots: the
    wrapper's launches outside its capture plus the captured ones times the
    run's replays."""
    d = [a - b for a, b in zip(after, before)]
    replays = d[4]
    return (d[0] - d[1] + d[1] * replays, d[2] - d[3] + d[3] * replays)


def files_written(root):
    """Every file under ``root`` with its size in bytes."""
    return {os.path.relpath(os.path.join(dp, f), root):
            os.path.getsize(os.path.join(dp, f))
            for dp, _, fs in os.walk(root) for f in fs}


def phase_viz(fa, fn, work, card_line, tree_run, root, run1, run2):
    """The visual slice (phase 10 of the module docstring)."""
    import numpy as np
    import torch

    from superdiff_torch import analysis
    from superdiff_torch.analysis import classifier, compare, gradcam
    from superdiff_torch.analysis import projection
    from superdiff_torch.cli import inspect_data, visualize
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.diffusion import graphed
    from superdiff_torch.diffusion.graphed import WARMUP_STEPS
    from superdiff_torch.inference import load_run
    from superdiff_torch.utils import visualization

    out = {"card": card_line}
    buf = io.StringIO()
    # (a) cli.inspect_data on 8b's tree, every viz toggle, Grad-CAM through
    # the SmallCNN it trains, then through the committed ResNet-18
    r18 = os.path.join(HERE, "artifacts", "extractors",
                       "resnet18_rand_seed1234.npz")
    kept = {}

    def keep(name, f):
        def call(*args, **kwargs):
            result = f(*args, **kwargs)
            kept[name] = (args, result)
            return result
        return call

    legs = {}
    for leg, extra in (("smallcnn", ()),
                       ("resnet18", ("--gradcam-backbone", "resnet18",
                                     "--gradcam-checkpoint", r18))):
        dst = os.path.join(work, f"inspect_{leg}")
        argv = ["--dataset-root", root, "--task", "TB", "--out", dst,
                "--device", "cuda", "--max-samples", "120",
                "--set", "training.resolution=256",
                "--set", "training.batch_size=16", *extra]
        for v in (VIZ_TOGGLES if leg == "smallcnn" else ("gradcam",)):
            argv += ["--set", f"viz.{v}=true"]
        rows = []
        fa.reset_launches()
        fn.reset_launches()
        tic = time.time()
        with contextlib.ExitStack() as stack:
            stack.enter_context(counted(analysis, (
                "extract_features", "run_projection",
                "run_projection_with_thumbnails",
                "compare_tsne_umap_thumbnails", "run_projection_3d",
                "run_gradcam"), fa, fn, rows))
            stack.enter_context(counted(projection, ("tsne",), fa, fn, rows))
            stack.enter_context(counted(gradcam, ("run_gradcam_backbone",),
                                        fa, fn, rows))
            stack.enter_context(counted(visualization, (
                "save_image_grid", "save_pixel_histogram"), fa, fn, rows))
            stack.enter_context(swapped(classifier, train_classifier=keep(
                "classifier", classifier.train_classifier)))
            stack.enter_context(counted(classifier, ("train_classifier",),
                                        fa, fn, rows))
            stack.enter_context(swapped(analysis, run_gradcam=keep(
                "cam", analysis.run_gradcam)))
            stack.enter_context(contextlib.redirect_stdout(buf))
            rc = inspect_data.main(argv)
        total_s = time.time() - tic
        if rc != 0:
            raise AssertionError(f"cli.inspect_data ({leg}) returned {rc}")
        files = files_written(dst)
        want = (INSPECT_FILES if leg == "smallcnn" else
                [f"gradcam/gradcam_{i}.png" for i in range(8)])
        if sorted(files) != sorted(want) or min(files.values()) == 0:
            raise AssertionError(f"cli.inspect_data ({leg}) wrote {files}")
        stages = {}
        for r in rows:
            st = stages.setdefault(r["stage"], dict(calls=0, s=0.0, b1=0,
                                                    b4=0))
            st["calls"] += 1
            st["s"] += r["s"]
            st["b1"] += r["b1"]
            st["b4"] += r["b4"]
        if fa.launches:
            raise AssertionError(f"cli.inspect_data ({leg}) launched B1")
        if leg == "smallcnn":
            n_batches = -(-120 // 16)
            expect = {"extract_features": SMALLCNN_RANDOM_CHAINS * n_batches,
                      "train_classifier": SMALLCNN_RANDOM_CHAINS
                      * CLASSIFIER_STEPS,
                      "run_gradcam": SMALLCNN_RANDOM_CHAINS * 8}
            got = {k: stages[k]["b4"] for k in expect}
            if got != expect or fn.launches != sum(expect.values()):
                raise AssertionError(f"cli.inspect_data B4 launches by stage "
                                     f"{got} (total {fn.launches}), "
                                     f"expected {expect}")
            inspect_b4 = dict(fn.launches_by_shape)
        elif fn.launches:
            raise AssertionError("the ResNet-18 Grad-CAM leg launched B4")
        legs[leg] = dict(seconds=total_s, stages=stages,
                         b4_launches=fn.launches, files=files,
                         tsne_s_n120=[r["s"] for r in rows
                                      if r["stage"] == "tsne"])
    # the CAMs of the 8 images through B4 against the plain chain, with
    # cuDNN's TF32 off as every float32 comparison here (with it on, the
    # convolutions after the chain round to TF32 and the gap is theirs;
    # printed beside it)
    model = kept["classifier"][1][0]
    imgs = kept["cam"][0][1]

    def cam_gap():
        fn.reset_launches()
        cams = [gradcam.compute_gradcam(model, img) for img in imgs]
        per_image = fn.launches / len(imgs)
        with b4_swapped_for_plain(fn):
            plain = [gradcam.compute_gradcam(model, img) for img in imgs]
        return cams, plain, per_image, max(
            float(np.abs(a[0] - b[0]).max()) for a, b in zip(cams, plain))

    gap_tf32 = cam_gap()[3]
    with tf32(False):
        cams, plain, b4_per_cam, gap = cam_gap()
    if b4_per_cam != SMALLCNN_RANDOM_CHAINS or gap >= CAM_TOL or any(
            a[1] != b[1] for a, b in zip(cams, plain)):
        raise AssertionError(f"Grad-CAM through B4 vs the plain chain: max "
                             f"abs {gap:.3e} (tol {CAM_TOL}), "
                             f"{b4_per_cam} B4 per image, classes "
                             f"{[c[1] for c in cams]} / "
                             f"{[c[1] for c in plain]}")
    legs["cam_b4_vs_plain"] = dict(max_abs=gap, max_abs_tf32_on=gap_tf32,
                                   b4_per_image=b4_per_cam,
                                   cam_shape=list(cams[0][0].shape))
    out["inspect_data"] = legs
    log(f"phase 10a cli.inspect_data, every viz toggle, 120 images at 256² "
        f"({card_line}): " + json.dumps(legs))

    # (b) cli.visualize on the tree-trained wide256 run: DDPM-1000 graphed at
    # batch 8 with 8 trajectory frames (the main path of this phase), then
    # the same run eagerly: samples and frames bit for bit
    vdir = os.path.join(work, "visualize")
    record = {}
    fa.reset_launches()
    fn.reset_launches()
    graphed.reset_counts()
    tic = time.time()
    with contextlib.redirect_stdout(buf):
        rc = visualize.main([
            "--run-dir", tree_run, "--dataset-root", root, "--out", vdir,
            "--num-samples", "8", "--device", "cuda", "--trajectory",
            "--forward-strip", "--real-vs-generated", "--tsne",
            "--dashboard"], record=record)
    viz_s = time.time() - tic
    if rc != 0:
        raise AssertionError(f"cli.visualize returned {rc}")
    b1_run = run_launches(fa.launches_by_shape, fa.captured_by_shape)
    b4_run = run_launches(fn.launches_by_shape, fn.captured_by_shape)
    b1_replay = sum(fa.captured_by_shape.values())
    b4_replay = sum(fn.captured_by_shape.values())
    dash_batches = -(-96 // 16)           # build_static_dashboard's defaults
    expect_b1 = 8 * (1000 + WARMUP_STEPS) + 8 * 2
    expect_b4 = (WIDE256_CALLS_B4 * (1000 + WARMUP_STEPS + 2)
                 + SMALLCNN_RANDOM_CHAINS * dash_batches)
    if (graphed.captures, graphed.replays) != (1, 1000) or (
            b1_replay, b4_replay) != (8, WIDE256_CALLS_B4) or (
            sum(b1_run.values()), sum(b4_run.values())) != (expect_b1,
                                                            expect_b4):
        raise AssertionError(
            f"cli.visualize: {graphed.captures} captures, {graphed.replays} "
            f"replays, {b1_replay} B1 and {b4_replay} B4 per replay, "
            f"{sum(b1_run.values())} B1 and {sum(b4_run.values())} B4 in the "
            f"run, expected {expect_b1} and {expect_b4}")
    files = files_written(vdir)
    if sorted(files) != VISUALIZE_FILES:
        raise AssertionError(f"cli.visualize wrote {files}")
    gen, frames = record["samples"], record["frames"]
    if gen.shape != (8, 256, 256, 1) or frames.shape != (8, 8, 256, 256, 1) \
            or not torch.isfinite(gen).all():
        raise AssertionError(f"cli.visualize samples {tuple(gen.shape)}, "
                             f"frames {tuple(frames.shape)}")
    _, model, schedule = load_run(tree_run, device="cuda")
    tic = time.time()
    ex, eframes = visualize.sample_trajectory(model, schedule,
                                              (8, 256, 256, 1), 0, eager=True)
    torch.cuda.synchronize()
    eager_s = time.time() - tic
    del model
    if not (torch.equal(ex, gen) and torch.equal(eframes, frames)):
        raise AssertionError("cli.visualize's graphed samples / frames differ "
                             "from the eager run's")
    out["visualize"] = dict(
        seconds=viz_s, stage_s=record["seconds"],
        ms_per_replay=record["seconds"]["sample"] * 1e3 / 1000,
        eager_sample_s=eager_s, graphed_equals_eager=True,
        b1_per_replay=b1_replay, b4_per_replay=b4_replay,
        b1_run=sum(b1_run.values()), b4_run=sum(b4_run.values()),
        b1_by_shape={str(k): v for k, v in b1_run.items()},
        b4_by_shape={str(k): v for k, v in b4_run.items()}, files=files)
    log(f"phase 10b cli.visualize wide256 DDPM-1000 batch 8 graphed, 8 "
        f"frames ({card_line}): " + json.dumps(out["visualize"]))

    # (c) --compare on the two wide256 runs of phase 4, batch 4: DDPM-1000
    # of each and their SuperDiff OR, one graph each
    runs = []

    def timed_run(f):
        def call(plan, seed, draws=None):
            torch.cuda.synchronize()
            before, tic = launch_snapshot(fa, fn), time.time()
            result = f(plan, seed, draws)
            torch.cuda.synchronize()
            b1, b4 = run_delta(before, launch_snapshot(fa, fn))
            runs.append(dict(plan=type(plan).__name__,
                             s=time.time() - tic, b1=b1, b4=b4))
            return result
        return call

    record = {}
    cdir = os.path.join(work, "compare")
    with swapped(compare, _run=timed_run(compare._run)), \
            contextlib.redirect_stdout(buf):
        rc = visualize.main(["--run-dir", run1, "--run-dir2", run2,
                             "--out", cdir, "--num-samples", "4",
                             "--device", "cuda", "--compare"], record=record)
    if rc != 0:
        raise AssertionError(f"cli.visualize --compare returned {rc}")
    stats = record["compare"]
    calls = (1, 1, 2)
    for r, n in zip(runs, calls):
        if (r["b1"], r["b4"]) != (8 * n * (1000 + WARMUP_STEPS),
                                  WIDE256_CALLS_B4 * n
                                  * (1000 + WARMUP_STEPS)):
            raise AssertionError(f"compare_runs {r}: expected {n} denoiser "
                                 "calls per step")
    if len(runs) != 3 or not np.isfinite(
            [stats["mean_logq_gap"]] + stats["logq_model_a"]
            + stats["logq_model_b"]).all():
        raise AssertionError(f"compare_runs: {runs}, {stats}")
    out["compare"] = dict(runs=runs, mean_logq_gap=stats["mean_logq_gap"],
                          compare_s=record["seconds"]["compare"],
                          panel_bytes=os.path.getsize(stats["panel"]))
    log(f"phase 10c cli.visualize --compare, wide256 batch 4 ({card_line}): "
        + json.dumps(out["compare"]))

    # (d) cli.train with training.vis_every at its default (5): the epoch-5
    # samples PNG and the loss curve, drawn without matplotlib
    tic = time.time()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main([
            "--synthetic", "--device", "cuda", "--experiment-id", "smoke10",
            "--run-id", "vis", "--set", "model.preset=small64",
            "--set", "training.resolution=64",
            "--set", "training.batch_size=8",
            "--set", "training.num_timesteps=100",
            "--set", "training.num_epochs=5",
            "--set", "training.steps_per_epoch=2",
            "--set", "training.save_every=0",
            "--set", "logging.stdout=false",
            "--set", f"paths.local_base={work}"])
    if rc != 0:
        raise AssertionError(f"cli.train (default vis_every) returned {rc}")
    run_dir = os.path.join(work, "outputs", "PNEUMONIA",
                           "experiment_smoke10_run_vis")
    pngs = {f: os.path.getsize(os.path.join(run_dir, f))
            for f in ("samples_epoch5.png", "loss_curve.png")
            if os.path.exists(os.path.join(run_dir, f))}
    if len(pngs) != 2 or min(pngs.values()) == 0:
        raise AssertionError(f"cli.train with vis_every=5 wrote {pngs}")
    out["train_default_vis"] = dict(seconds=time.time() - tic, pngs=pngs)
    log(f"phase 10d cli.train, training.vis_every at its default: "
        + json.dumps(out["train_default_vis"]))

    loaded = [m for m in NOT_ON_THE_CARD if m in sys.modules]
    if loaded:
        raise AssertionError(f"imported on the card: {loaded}")
    return out, dict(b1=b1_run, b4=b4_run, inspect_b4=inspect_b4)


# ----------------------------------------------------------------- phase 11
# the parallel modes on one card. Leg (a) runs in a subprocess that joins a
# world-1 NCCL group through the launch contract (the SUPERDIFF_TPU_* triple
# on 127.0.0.1); the rest in this process.

PARALLEL_LIMITS = ("one card holds one NCCL rank: ensemble parallelism's "
                   "world-2 leg, DP / TP / FSDP at world > 1 and any scaling "
                   "over cards run only in the CPU gloo tests "
                   "(tests/test_torch_parallel_*.py); not measured here")
TP_TOL = 2e-2            # bf16: each rank's conv_1 partial sum rounded once
STACKED_TOL = 2e-2       # bf16: one stacked call against two calls
CP_SHAPES = [(16, 1024, 4, 32), (1, 16384, 4, 32)]
CP_CHUNKS = 4
PARALLEL_TRAIN = (16, 2, 5)          # batch, epochs, steps per epoch


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fsdp_train(work, name, mesh, steps=10):
    """wide256 at 256², batch 16, ``steps`` train steps of the library's
    step on the synthetic stream, under FSDP2 over ``mesh`` (None: the
    unsharded step). Saves the whole params and EMA to ``work/name.pt``;
    returns ms per step (CUDA events over steps 3..) and the B1/B2/B3
    launches per step."""
    import torch

    from superdiff_torch import config as tcfg
    from superdiff_torch.diffusion import make_schedule
    from superdiff_torch.models.presets import model_from_config
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.parallel import fsdp, shard_batch
    from superdiff_torch.training.loop import _synthetic_batches
    from superdiff_torch.training.state import (create_train_state,
                                                make_optimizer)
    from superdiff_torch.training.steps import make_train_step

    cfg = tcfg.Config()
    cfg.model.preset = "wide256"
    cfg.training.resolution, cfg.training.batch_size = 256, 16
    cfg.training.steps_per_epoch = steps
    model = model_from_config(cfg, device="cuda").init_parameters(0)
    state = create_train_state(model,
                               torch.Generator("cuda").manual_seed(0),
                               tx=make_optimizer(2e-4, grad_clip_norm=1.0))
    sh = None
    if mesh is not None:
        sh = fsdp.state_shardings(state, mesh)
        fsdp.shard_state(state, mesh)
    step = make_train_step(make_schedule(1000, device="cuda"), mesh=mesh,
                           conditional=True, cfg_drop_prob=0.1,
                           null_label=model.null_label, state_shardings=sh)
    batches = list(_synthetic_batches(cfg, 0, "cuda"))
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for i, batch in enumerate(batches):
        if i == 2:
            start.record()
        state, m = step(state, batch if mesh is None
                        else shard_batch(batch, mesh))
    end.record()
    torch.cuda.synchronize()
    counts = [c / steps for c in flash_counts(fa)]
    if mesh is None:
        full = {"params": state.model.state_dict(),
                "ema_params": state.ema_model.state_dict()}
    else:
        full = fsdp.gather_state(state, mesh, sh)
    torch.save({k: {n: v.detach().cpu() for n, v in full[k].items()}
                for k in ("params", "ema_params")},
               os.path.join(work, f"{name}.pt"))
    return dict(ms_per_step=start.elapsed_time(end) / (steps - 2),
                launches_per_step=counts, loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]))


def parallel_worker(spec):
    """Leg (a) in the subprocess: join the world-1 NCCL group, then
    cli.train (data-parallel), the FSDP train steps and cli.sample
    --data-parallel through it. Prints one ``PARALLEL {json}`` line."""
    import torch
    import torch.distributed as dist

    from superdiff_torch.cli import sample
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.ops import fused_norm as fn
    from superdiff_torch.parallel import make_mesh, maybe_init_distributed
    from superdiff_torch.parallel.mesh import leave_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    joined = maybe_init_distributed("cuda")
    if not (joined and dist.get_backend() == "nccl"
            and dist.get_world_size() == 1):
        raise AssertionError("leg (a) did not join a world-1 NCCL group")
    work = spec["work"]
    out = {}
    batch, epochs, steps = PARALLEL_TRAIN
    fa.reset_launches()
    run_dir, metrics = run_train_cli(
        train_cli, work, "dp", batch, epochs, steps,
        ["--set", "training.eval_every=0", "--set", "training.seed=7"])
    rows = epoch_rows(metrics, "images_per_sec")
    out["dp_train"] = dict(run_dir=run_dir,
                           ms_per_step=1e3 * batch / rows[-1]["images_per_sec"],
                           launches_per_step=[c / (epochs * steps)
                                              for c in flash_counts(fa)])
    out["fsdp_train"] = fsdp_train(work, "fsdp", make_mesh())
    fa.reset_launches()
    fn.reset_launches()
    secs, cap = run_cli(sample, [
        "--run-dir", spec["run1"], "--method", "ddpm", "--batch-size", "16",
        "--label", "0", "--guidance", "1.0", "--seed", "0", "--out",
        os.path.join(work, "dp_ddpm"), "--device", "cuda",
        "--data-parallel"])
    out["dp_sample"] = dict(s_per_batch=secs, capture_s=cap,
                            b1_wrapper=fa.launches, b4_wrapper=fn.launches)
    leave_distributed(joined)
    print("PARALLEL " + json.dumps(out), flush=True)


def _tensors_equal(a, b):
    """(bit-equal, max abs difference, relative L2) over two
    ``{part: {name: tensor}}`` dicts."""
    import torch

    num = den = 0.0
    worst, same = 0.0, True
    for part in a:
        for k, x in a[part].items():
            y = b[part][k].to(x.dtype)
            same = same and torch.equal(x, y)
            d = (x.double() - y.double())
            worst = max(worst, d.abs().max().item())
            num += d.square().sum().item()
            den += y.double().square().sum().item()
    return same, worst, (num / max(den, 1e-30)) ** 0.5


def leg_world1(work, run1, card_line):
    """(a): the subprocess's DP and FSDP training and DP sampling against
    the same work with no mesh, here."""
    import numpy as np
    import torch

    from superdiff_torch.checkpoint import load_checkpoint_file
    from superdiff_torch.cli import train as train_cli
    from superdiff_torch.diffusion.graphed import WARMUP_STEPS
    from superdiff_torch.ops import flash_attention as fa

    env = dict(os.environ, SUPERDIFF_TPU_MULTIHOST="1",
               SUPERDIFF_TPU_COORDINATOR=f"127.0.0.1:{_free_port()}",
               SUPERDIFF_TPU_NUM_PROCESSES="1", SUPERDIFF_TPU_PROCESS_ID="0")
    tic = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--parallel-worker",
         json.dumps({"work": work, "run1": run1})],
        env=env, capture_output=True, text=True, timeout=600)
    worker_s = time.time() - tic
    if proc.returncode != 0:
        raise AssertionError(f"leg (a) worker exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    got = json.loads(next(line for line in proc.stdout.splitlines()
                          if line.startswith("PARALLEL "))[9:])
    # the same training with no mesh, here
    torch.backends.cudnn.deterministic = True
    try:
        batch, epochs, steps = PARALLEL_TRAIN
        fa.reset_launches()
        nomesh_dir, metrics = run_train_cli(
            train_cli, work, "nomesh", batch, epochs, steps,
            ["--set", "training.eval_every=0", "--set", "training.seed=7"])
        nomesh_counts = [c / (epochs * steps) for c in flash_counts(fa)]
        rows = epoch_rows(metrics, "images_per_sec")
        nomesh_ms = 1e3 * batch / rows[-1]["images_per_sec"]
        fsdp_ref = fsdp_train(work, "nomesh_fsdp", None)
    finally:
        torch.backends.cudnn.deterministic = False
    last = epochs * steps
    dp = load_checkpoint_file(os.path.join(got["dp_train"]["run_dir"],
                                           "checkpoints"), last)
    ref = load_checkpoint_file(os.path.join(nomesh_dir, "checkpoints"), last)
    parts = ("params", "ema_params")
    dp_eq = _tensors_equal({p: dp[p] for p in parts},
                           {p: ref[p] for p in parts})
    fs_eq = _tensors_equal(torch.load(os.path.join(work, "fsdp.pt")),
                           torch.load(os.path.join(work, "nomesh_fsdp.pt")))
    for what, (same, worst, rel), counts in (
            ("DP cli.train", dp_eq, got["dp_train"]["launches_per_step"]),
            ("FSDP train steps", fs_eq,
             got["fsdp_train"]["launches_per_step"])):
        if counts != [8.0, 8.0, 8.0]:
            raise AssertionError(f"{what}: B1/B2/B3 launches per step "
                                 f"{counts}, expected 8/8/8")
        if not same:
            log(f"phase 11a {what}: params/EMA not bit-equal to the run "
                f"without a mesh (max abs {worst:.3e}, rel L2 {rel:.3e}). "
                "The 1-rank mean is exact; what differs is where the "
                "forward and backward read the parameters: FSDP2 runs them "
                "on copies all-gathered into one flat buffer per unit, at "
                "other addresses than the unsharded model's, where cuDNN "
                "may pick other kernels (a likely cause, not traced)")
            if rel > 1e-4:
                raise AssertionError(f"{what} differs from the run without "
                                     f"a mesh: rel L2 {rel:.3e}")
    dp_x = np.load(os.path.join(work, "dp_ddpm", "samples.npy"))
    ref_x = np.load(os.path.join(work, "ddpm_graph", "samples.npy"))
    if not np.array_equal(dp_x, ref_x):
        raise AssertionError(
            f"cli.sample --data-parallel differs from phase 4a's graphed "
            f"samples: max abs {np.abs(dp_x - ref_x).max():.3e}")
    check_launches(got["dp_sample"]["b1_wrapper"], WARMUP_STEPS + 1,
                   "cli.sample --data-parallel (graphed)")
    check_b4(got["dp_sample"]["b4_wrapper"], WARMUP_STEPS + 1,
             "cli.sample --data-parallel (graphed)")
    return dict(card=card_line, worker_s=worker_s,
                dp_train=dict(ms_per_step=got["dp_train"]["ms_per_step"],
                              nomesh_ms_per_step=nomesh_ms,
                              launches_per_step=got["dp_train"][
                                  "launches_per_step"],
                              nomesh_launches_per_step=nomesh_counts,
                              bit_equal=dp_eq[0], max_abs=dp_eq[1]),
                fsdp_train=dict(got["fsdp_train"], nomesh=fsdp_ref,
                                bit_equal=fs_eq[0], max_abs=fs_eq[1],
                                rel_l2=fs_eq[2]),
                dp_sample=dict(got["dp_sample"], bit_equal_to_4a=True))


def leg_tp(fn, model):
    """(b): both model-axis parts (m=2) of every wide256 ResBlock, sliced by
    parallel/tp.py, run one after the other in this process with their
    conv_1 partial sums added, against the unsplit block at batch 16; then
    B4 at every split chain shape (C/2 channels, G/2 groups) against the
    plain chain, with its times."""
    import copy

    import torch

    from superdiff_torch.models.layers import ResBlock
    from superdiff_torch.parallel import tp
    from superdiff_torch.parallel.mesh import Mesh
    from superdiff_torch.tools.timing import kernel_device_ms

    inputs = {}

    def grab(name):
        def hook(mod, args):
            inputs[name] = tuple(a.detach().clone() for a in args)
        return hook

    blocks = {n: m for n, m in model.named_modules() if isinstance(m, ResBlock)}
    hooks = [m.register_forward_pre_hook(grab(n)) for n, m in blocks.items()]
    g = torch.Generator("cuda").manual_seed(11)
    try:
        with torch.no_grad():
            model(torch.randn((16, 256, 256, 1), device="cuda", generator=g),
                  torch.full((16,), 500, device="cuda"),
                  torch.zeros((16,), dtype=torch.long, device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    mesh = Mesh(None, {"data": 1, "model": 2}, "cuda")
    worst, split_shapes = 0.0, {}
    fn.reset_launches()
    with torch.no_grad():
        for name, block in blocks.items():
            x, emb = inputs[name]
            parts = [tp.shard_params(copy.deepcopy(block), mesh, rank=r)
                     for r in range(2)]
            if not all(p.tp is not None for p in parts):
                raise AssertionError(f"{name} was not split over model=2")
            partial = []
            parts[1].tp.reduce = lambda h: partial.append(h) or h
            parts[1](x, emb)
            parts[0].tp.reduce = lambda h: h + partial[0]
            got, want = parts[0](x, emb).float(), block(x, emb).float()
            err = ((got - want).abs().max() / want.abs().max()).item()
            worst = max(worst, err)
            if not (torch.isfinite(got).all() and err < TP_TOL):
                raise AssertionError(f"TP parts of {name}: max abs error "
                                     f"{err:.3e} of the block's largest "
                                     f"(tolerance {TP_TOL})")
            key = (x.shape[1], x.shape[2], parts[0].conv_0.weight.shape[0],
                   parts[0].norm_1.num_groups)
            split_shapes[key] = split_shapes.get(key, 0) + 1
    launches = dict(fn.launches_by_shape)
    rows = []
    for (H, W, C, G), count in sorted(split_shapes.items()):
        n = launches.get((H, W, C, G, True, "bfloat16"), 0)
        if n != 2 * count:
            raise AssertionError(f"B4 at the split shape {(H, W, C, G)}: "
                                 f"{n} launches, expected {2 * count}")
        xs = torch.randn((16, H, W, C), device="cuda",
                         generator=g).to(torch.bfloat16)
        gamma, beta = (torch.randn(C, device="cuda", generator=g)
                       for _ in range(2))
        scale, shift = (0.1 * torch.randn((16, C), device="cuda",
                                          generator=g) for _ in range(2))
        kern = lambda: fn._launch(xs, gamma, beta, G, scale, shift, 1e-5,
                                  torch.bfloat16, policy=True)
        plain = lambda: fn.gn_film_silu_policy_plain(
            xs, gamma, beta, G, torch.bfloat16, scale, shift)
        err = (kern().float() - plain().float()).abs().max().item()
        if err > GN_TOL["bfloat16"] * plain().float().abs().max().item():
            raise AssertionError(f"B4 at the split shape {(H, W, C, G)}: "
                                 f"max abs error {err:.3e}")
        rows.append(dict(
            shape=[16, H, W, C], groups=G, film=True, blocks=count,
            max_abs_err=err, ms=cuda_time_ms(kern, 50),
            device_ms=kernel_device_ms(kern, kernel=GN_KERNELS),
            plain_ms=cuda_time_ms(plain, 20),
            bound_ms=2 * xs.numel() * 2 / HBM_BPS * 1e3, bound_by="bytes"))
        log("tp_b4 " + json.dumps(rows[-1]))
    return dict(blocks_split=len(blocks), max_rel_err=worst, b4_rows=rows)


def leg_stacked(fa, fn, models):
    """(c): SuperDiff OR and AND of the two wide256 runs at batch 4, graphed,
    the stacked call (stack_eps_fns: one vmap over both models' stacked
    weights) against the sequential calls: one call, then 100 steps of a
    T=100 schedule from the same seed; ms per step of each."""
    import torch

    from superdiff_torch.diffusion.graphed import GraphedSampler
    from superdiff_torch.diffusion.schedules import make_schedule
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import make_eps_fn, make_stacked_eps_fn

    stacked = make_stacked_eps_fn(list(models))
    seq = [make_eps_fn(m) for m in models]
    g = torch.Generator("cuda").manual_seed(3)
    x = torch.randn((4, 256, 256, 1), device="cuda", generator=g)
    t = torch.full((4,), 400, device="cuda")
    fa.reset_launches()
    fn.reset_launches()
    with torch.no_grad():
        one = stacked(x, t)
        torch.cuda.synchronize()
        b1, b4 = fa.launches, fn.launches
        b1_rows = dict(fa.launches_by_shape)
        two = torch.stack([f(x, t) for f in seq])
    if b1 != 8 or b4 != 2 * WIDE256_CALLS_B4:
        raise AssertionError(f"one stacked call: {b1} B1 and {b4} B4 "
                             f"launches, expected 8 (each over both models' "
                             f"rows) and {2 * WIDE256_CALLS_B4}")
    call_err = (torch.linalg.norm((one - two).float())
                / torch.linalg.norm(two.float())).item()
    if call_err > STACKED_TOL:
        raise AssertionError(f"stacked call vs two calls: rel L2 "
                             f"{call_err:.3e}")
    schedule = make_schedule(100, device="cuda")
    out = dict(call_rel_l2=call_err, b1_per_call=b1, b4_per_call=b4,
               b1_shapes={str(k): v for k, v in b1_rows.items()})
    for mode in ("or", "and"):
        res = {}
        for kind, fns, kw in (("stacked", stacked, dict(num_models=2)),
                              ("sequential", seq, {})):
            sampler = GraphedSampler(SuperDiffPlan(schedule, fns,
                                                   (4, 256, 256, 1),
                                                   mode=mode, **kw))
            xs, lq = sampler(torch.Generator("cuda").manual_seed(5))
            # timing: 100 more replays from a restarted state (the step
            # index must stay inside the plan's tables)
            sampler.plan.start(torch.zeros((4, 256, 256, 1), device="cuda"))
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(100):
                sampler.step()
            end.record()
            torch.cuda.synchronize()
            res[kind] = (xs.float(), lq, start.elapsed_time(end) / 100)
        (xa, la, ma), (xb, lb, mb) = res["stacked"], res["sequential"]
        x_rel = (torch.linalg.norm(xa - xb) / torch.linalg.norm(xb)).item()
        lq_rel = (torch.linalg.norm(la - lb) / torch.linalg.norm(lb)).item()
        if not (torch.isfinite(xa).all() and torch.isfinite(la).all()
                and x_rel < 0.1 and lq_rel < 0.05):
            raise AssertionError(f"stacked SuperDiff {mode}: samples rel L2 "
                                 f"{x_rel:.3e}, logq rel L2 {lq_rel:.3e}")
        out[mode] = dict(stacked_ms_per_step=ma, sequential_ms_per_step=mb,
                         samples_rel_l2=x_rel, logq_rel_l2=lq_rel)
    return out


def leg_pp(fa, fn, model):
    """(d): the two-stage pipeline on (cuda:0, cuda:0), 2 microbatches at
    batch 16, against the full call."""
    import torch

    from superdiff_torch.parallel import pp

    pipe = pp.make_pp_denoiser(model, devices=("cuda:0", "cuda:0"),
                               num_microbatches=2)
    g = torch.Generator("cuda").manual_seed(7)
    x = torch.randn((16, 256, 256, 1), device="cuda", generator=g)
    t = torch.full((16,), 300, device="cuda")
    y = torch.zeros((16,), dtype=torch.long, device="cuda")
    fa.reset_launches()
    fn.reset_launches()
    got = pipe(x, t, y)
    torch.cuda.synchronize()
    b1, b4 = fa.launches, fn.launches
    with torch.no_grad():
        want = model(x, t, y)
        rel = (torch.linalg.norm((got - want).float())
               / torch.linalg.norm(want.float())).item()
        full_ms = cuda_time_ms(lambda: model(x, t, y), 10)
    if b1 != 16 or b4 != 2 * WIDE256_CALLS_B4:
        raise AssertionError(f"pipelined call: {b1} B1 and {b4} B4 launches,"
                             f" expected 8 and {WIDE256_CALLS_B4} per "
                             "microbatch")
    if not (torch.isfinite(got).all() and rel < STACKED_TOL):
        raise AssertionError(f"pipeline vs full call: rel L2 {rel:.3e}")
    return dict(rel_l2=rel, b1_per_microbatch=b1 // 2,
                b4_per_microbatch=b4 // 2, ms=cuda_time_ms(
                    lambda: pipe(x, t, y), 10), full_ms=full_ms)


def leg_cp(fa):
    """(e): the ring's hop arithmetic in one process: the sequence in 4
    chunks, each query chunk's hops through B1 merged by lse
    (parallel/cp.py::merge), and the backward's hops through B2/B3 with the
    merged lse and delta, against B1/B2/B3 on the whole sequence."""
    import torch

    from superdiff_torch.parallel import cp

    rows = []
    for (B, S, H, D) in CP_SHAPES:
        g = torch.Generator("cuda").manual_seed(S)
        q, k, v, dout = (torch.randn((B, S, H, D), device="cuda",
                                     generator=g).to(torch.bfloat16)
                         for _ in range(4))
        n, per = CP_CHUNKS, S // CP_CHUNKS
        chunk = lambda a, i: a[:, i * per:(i + 1) * per]

        def forward():
            outs = []
            for i in range(n):
                out = lse = None
                for j in range(n):
                    o_j = fa._flash_forward(chunk(q, i), chunk(k, (i + j) % n),
                                            chunk(v, (i + j) % n))
                    out, lse = cp.merge(out, lse, *o_j)
                outs.append((out.to(q.dtype), lse))
            return outs

        def backward(outs):
            dq = [None] * n
            dk = [torch.zeros((B, per, H, D), device="cuda") for _ in range(n)]
            dv = [torch.zeros((B, per, H, D), device="cuda") for _ in range(n)]
            for i, (out, lse) in enumerate(outs):
                gi = chunk(dout, i)
                delta = fa._bwd_delta(out, gi)
                acc = torch.zeros((B, per, H, D), device="cuda")
                for j in range(n):
                    s = (i + j) % n
                    a, b, c = fa.flash_backward_hop(chunk(q, i), chunk(k, s),
                                                    chunk(v, s), gi, lse,
                                                    delta)
                    acc += a.float()
                    dk[s] += b.float()
                    dv[s] += c.float()
                dq[i] = acc
            return [torch.cat(a, dim=1) for a in (dq, dk, dv)]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launches()
        outs = forward()
        grads = backward(outs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        out_w, lse_w = fa._flash_forward(q, k, v)
        grads_w = fa._flash_backward(q, k, v, out_w, lse_w, dout)
        got = torch.cat([o for o, _ in outs], dim=1).float()
        err = (got - out_w.float()).abs().max().item()
        lse = torch.cat([l.view(B, H, per) for _, l in outs], dim=2)
        lse_err = (lse - lse_w.view(B, H, S)).abs().max().item()
        gerr = max(((a - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(grads, grads_w))
        if not (err < TOL["bfloat16"]["out"] and lse_err < TOL["bfloat16"][
                "lse"] and gerr < BWD_TOL["bfloat16"]):
            raise AssertionError(f"ring hops at {(B, S, H, D)}: out {err:.3e}"
                                 f", lse {lse_err:.3e}, grads {gerr:.3e}")
        if launches != (n * n, n * n, n * n):
            raise AssertionError(f"ring hops at {(B, S, H, D)}: launches "
                                 f"{launches}, expected {n * n} each")
        rows.append(dict(
            shape=[B, S, H, D], chunks=n, max_abs_err=err,
            lse_max_abs_err=lse_err, grad_max_rel_err=gerr,
            launches=list(launches),
            fwd_ms=cuda_time_ms(forward, 5),
            whole_fwd_ms=cuda_time_ms(lambda: fa._flash_forward(q, k, v), 5),
            fwd_bwd_ms=cuda_time_ms(lambda: backward(forward()), 3),
            whole_fwd_bwd_ms=cuda_time_ms(lambda: fa._flash_backward(
                q, k, v, *fa._flash_forward(q, k, v), dout), 3),
            peak_bytes=peak, score_matrix_bytes=B * H * S * S * 4))
        log("cp_hops " + json.dumps(rows[-1]))
    return rows


def leg_profiling(model, work):
    """(f): utils/profiling.trace around one wide256 call names B1's and
    B4's kernels; timed gives a time."""
    import torch

    from superdiff_torch.utils import profiling

    x = torch.randn((16, 256, 256, 1), device="cuda")
    t = torch.full((16,), 500, device="cuda")
    y = torch.zeros((16,), dtype=torch.long, device="cuda")
    log_dir = os.path.join(work, "trace")
    with torch.no_grad():
        with profiling.trace(log_dir):
            model(x, t, y)
        sec, _ = profiling.timed(model, x, t, y, warmup=1, iters=5)
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    seen = sorted(k for k in FLASH_KERNELS[:1] + GN_KERNELS
                  if any(k in nm for nm in names))
    if FLASH_KERNELS[0] not in seen or not set(seen) & set(B4_CALL_KERNELS):
        raise AssertionError(f"the trace names {seen}, not B1 and B4")
    if not sec > 0:
        raise AssertionError(f"timed gave {sec}")
    return dict(kernels_in_trace=seen, timed_s_per_call=sec,
                trace_bytes=os.path.getsize(os.path.join(log_dir,
                                                         "trace.json")))


def phase_parallel(fa, fn, work, card_line, run1, run2):
    """Phase 11 (module docstring)."""
    import torch

    from superdiff_torch.inference import apply_sampling_policy, load_run

    log("phase 11 " + PARALLEL_LIMITS)
    tic = time.time()
    out = {"world1": leg_world1(work, run1, card_line)}
    log("phase 11a world-1 NCCL group through the entry points "
        f"({card_line}): " + json.dumps(out["world1"]))
    _, model, _ = load_run(run1, device="cuda")
    apply_sampling_policy(model)
    out["tp"] = leg_tp(fn, model)
    log(f"phase 11b TP parts (m=2) of every wide256 ResBlock ({card_line}): "
        + json.dumps({k: v for k, v in out["tp"].items() if k != "b4_rows"}))
    _, model2, _ = load_run(run2, device="cuda")
    apply_sampling_policy(model2)
    out["stacked"] = leg_stacked(fa, fn, (model, model2))
    log(f"phase 11c stacked SuperDiff vs sequential, batch 4 ({card_line}): "
        + json.dumps(out["stacked"]))
    del model2
    out["pp"] = leg_pp(fa, fn, model)
    log(f"phase 11d PP on (cuda:0, cuda:0), 2 microbatches at batch 16 "
        f"({card_line}): " + json.dumps(out["pp"]))
    out["cp"] = leg_cp(fa)
    out["profiling"] = leg_profiling(model, work)
    log(f"phase 11f profiling ({card_line}): "
        + json.dumps(out["profiling"]))
    del model
    torch.cuda.empty_cache()
    out["s"] = time.time() - tic
    log(f"phase 11 parallel: {out['s']:.3f} s")
    return out


@contextlib.contextmanager
def swapped(obj, **attrs):
    """Set attributes of ``obj`` (a module of the package) inside the block
    and restore them after. The package has no switch from a kernel to its
    plain version on CUDA tensors, so the kernel-vs-plain checks set the
    wrapper's private launcher here, and only here; phase 10 wraps the
    slice's functions here to time and count them."""
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


def flash_swapped_for_plain(fa):
    """B1, B2 and B3 run their plain versions inside the block."""
    return swapped(fa, _flash_forward_cuda=fa._flash_forward_plain,
                   _flash_backward_cuda=fa._flash_backward_plain)


def b4_swapped_for_plain(fn):
    """B4's wrapper runs its plain version inside the block."""
    return swapped(fn, _gn_silu_cuda=(
        lambda x, gamma, beta, G, scale, shift, eps:
        fn.gn_silu_plain(x, gamma, beta, G, scale, shift, eps)))


def b4_policy_swapped_for_plain(fn):
    """B4 in the sampling policy's mode (the CondUNet's chains with their
    bf16 roundings) runs its plain version inside the block."""
    return swapped(fn, gn_film_silu_policy=(
        lambda x, gamma, beta, G, nd, scale=None, shift=None, eps=1e-5:
        fn.gn_film_silu_policy_plain(x, gamma, beta, G, nd, scale, shift,
                                     eps)))


@contextlib.contextmanager
def tf32(on):
    """cuDNN's TF32 for float32 convolutions (PyTorch's default is on)."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def run_launches(by_shape, captured_by_shape):
    """A run's kernel launches by shape, from counts taken in the run: the
    wrapper's launches made outside a capture, plus each launch it recorded
    into the run's one CUDA graph times that graph's replays (a replay
    launches the graph's kernels without the wrapper)."""
    from superdiff_torch.diffusion import graphed

    if graphed.captures > 1:
        raise AssertionError(f"{graphed.captures} graphs captured in one run")
    return {k: n - captured_by_shape.get(k, 0)
            + captured_by_shape.get(k, 0) * graphed.replays
            for k, n in by_shape.items()}


def check_launches(launches, calls, what):
    """8 B1 launches per wide256 denoiser call through the wrapper (a
    graphed run: its warm-up and captured calls, not its replays)."""
    expect = 8 * calls
    if launches != expect:
        raise AssertionError(f"{what}: {launches} flash launches for "
                             f"{calls} denoiser calls, expected {expect}")


def check_train_graph(fa, train_steps, n_steps, per_step, what):
    """A run of ``n_steps`` train steps on one card: one eager warm-up
    step, one capture and a replay for every other step, the captured step
    holding ``per_step`` launches of B1/B2/B3."""
    got = (train_steps.captures, train_steps.replays, train_steps.eager_steps)
    if got != (1, n_steps - 1, 1):
        raise AssertionError(f"{what}: (captures, replays, eager steps) = "
                             f"{got}, expected (1, {n_steps - 1}, 1)")
    captured = tuple(sum(d.values()) for d in (
        fa.captured_by_shape, fa.bwd_dq_captured_by_shape,
        fa.bwd_dkv_captured_by_shape))
    if captured != tuple(per_step):
        raise AssertionError(f"{what}: the captured step holds (B1, B2, B3) "
                             f"= {captured}, expected {tuple(per_step)}")


def check_train_b4(fn, fwd, bwd, captured, what):
    """B4 in a training run at the float32 norm dtype: ``fwd`` forward and
    ``bwd`` backward launches through the wrappers, and the captured train
    step holding ``captured`` = (forward, backward) launches."""
    got = (fn.launches, fn.bwd_launches, sum(fn.captured_by_shape.values()),
           sum(fn.bwd_captured_by_shape.values()))
    if got != (fwd, bwd, *captured):
        raise AssertionError(f"{what}: B4 (forward, backward, captured "
                             f"forward, captured backward) = {got}, "
                             f"expected {(fwd, bwd, *captured)}")


def check_b4(launches, calls, what):
    """51 B4 launches per wide256 denoiser call without gradients."""
    expect = WIDE256_CALLS_B4 * calls
    if launches != expect:
        raise AssertionError(f"{what}: {launches} B4 launches for {calls} "
                             f"denoiser calls, expected {expect}")


def main() -> int:
    if not IN_CHECKOUT:
        print("chip_smoke.py must run from a checkout of the repository "
              "(no superdiff_torch/ beside it)", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card",
              file=sys.stderr)
        return 2
    t_start = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card_line = nvidia_smi("name,power.limit")
    max_clock = nvidia_smi("clocks.max.sm")
    sm_clock_hz = float(re.findall(r"[0-9.]+", max_clock)[0]) * 1e6
    log(f"phase 1 device: {card_line}; max SM clock {max_clock}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for f32")

    from superdiff_torch import config as tcfg
    from superdiff_torch.cli import sample
    from superdiff_torch.compat import flax_params as fp
    from superdiff_torch.inference import apply_sampling_policy, load_run
    from superdiff_torch.models.presets import model_from_config
    from superdiff_torch.ops import _build
    from superdiff_torch.ops import flash_attention as fa
    from superdiff_torch.ops import fused_norm as fn

    from superdiff_torch.diffusion.graphed import WARMUP_STEPS

    tic = time.time()
    sos = _build.build_all(verbose=True)
    build_s = time.time() - tic
    log(f"phase 2 build: {sorted(so.name for so in sos.values())} in "
        f"{build_s:.3f} s (one nvcc per source, started together)")
    if "--kernels" in sys.argv[1:]:
        return kernels_only(fa, fn, card_line, sm_clock_hz)

    rows = phase_kernels(fa, sm_clock_hz)
    log(f"phase 3a forward kernel checks: {len(rows)} shape/dtype cases "
        "agree")
    bwd_rows = phase_bwd_kernels(fa, sm_clock_hz)
    log(f"phase 3b backward kernel checks: {len(bwd_rows)} kernel/shape/"
        "dtype cases agree")
    gn_rows = phase_gn_kernels(fn)
    log(f"phase 3c B4 checks: {len(gn_rows)} shape/dtype cases agree")
    sd_rows = phase_sd_kernels(fa, sm_clock_hz)
    log(f"phase 3d SD B1 checks: {len(sd_rows)} shape/dtype cases agree")
    sd_call = phase_sd_call(fa, fn)
    log(f"phase 3e sd21base call at 16 rows ({card_line}): "
        + json.dumps({k: v for k, v in sd_call.items()
                      if k not in ("rows", "b1_counts")}))

    work = tempfile.mkdtemp(prefix="superdiff_smoke_")
    run1, run2 = os.path.join(work, "run1"), os.path.join(work, "run2")
    tic = time.time()
    n_arrays = write_run(run1, 1, fp, tcfg, model_from_config)
    write_run(run2, 2, fp, tcfg, model_from_config)
    log(f"phase 4 setup: two wide256 run dirs ({n_arrays} arrays each) in "
        f"{time.time() - tic:.3f} s")

    # (a) DDPM-1000, 256², batch 16, label 0 — the main path: cli.sample
    # eagerly ("before"; 8 B1 launches per denoiser call, counted), then
    # through its CUDA graph (the main path; the wrapper counts the
    # warm-up and captured steps' launches, the replays run in the graph)
    ddpm, _, ddpm_counts = sample_pair(sample, [
        "--run-dir", run1, "--method", "ddpm", "--batch-size", "16",
        "--label", "0", "--guidance", "1.0", "--seed", "0", "--out",
        os.path.join(work, "ddpm"), "--device", "cuda"], "DDPM-1000")
    main_counts = ddpm_counts["graph"]
    main_launches = main_counts["b1_run"]
    eager_launches = ddpm_counts["eager"]["b1_run"]
    check_launches(ddpm_counts["eager"]["b1"], 1000, "eager DDPM-1000")
    check_launches(main_counts["b1"], WARMUP_STEPS + 1, "graphed DDPM")
    check_launches(sum(main_counts["b1_captured"].values()), 1,
                   "the captured DDPM step")
    if main_counts["captures"] != 1 or main_counts["replays"] != 1000:
        raise AssertionError(f"graphed DDPM-1000: {main_counts['captures']} "
                             f"captures, {main_counts['replays']} replays")
    check_launches(sum(main_launches.values()), 1000 + WARMUP_STEPS,
                   "graphed DDPM-1000 (replays and warm-up)")
    check_b4(ddpm_counts["eager"]["b4"], 1000, "eager DDPM-1000")
    check_b4(main_counts["b4"], WARMUP_STEPS + 1, "graphed DDPM")
    check_b4(sum(main_counts["b4_captured"].values()), 1,
             "the captured DDPM step")
    check_b4(sum(main_counts["b4_run"].values()), 1000 + WARMUP_STEPS,
             "graphed DDPM-1000 (replays and warm-up)")
    if ddpm["shape"] != [16, 256, 256, 1]:
        raise AssertionError(f"DDPM samples {ddpm['shape']}")
    log("phase 4a DDPM-1000 batch 16, eager then graphed (s per batch = ms "
        "per sampler step): " + json.dumps(ddpm))

    # (b) one denoiser call at batch 2: bf16 kernel path vs f32 plain path
    _, model, _ = load_run(run1, device="cuda")
    apply_sampling_policy(model)
    _, ref, _ = load_run(run1, device="cpu")
    g = torch.Generator().manual_seed(5)
    xb = torch.randn((2, 256, 256, 1), generator=g)
    tb = torch.tensor([999, 10])
    yb = torch.tensor([0, 2])
    fa.reset_launches()
    with torch.no_grad():
        got = model(xb.cuda(), tb.cuda(), yb.cuda()).float().cpu()
        torch.cuda.synchronize()
        check_launches(fa.launches, 1, "denoiser call")
        expect = ref(xb, tb, yb)
    rel = (torch.linalg.norm(got - expect) / torch.linalg.norm(expect)).item()
    if not (torch.isfinite(got).all() and rel < SLICE_REL_TOL):
        raise AssertionError(f"bf16 kernel path vs f32 plain path: rel L2 "
                             f"{rel:.4e} (tolerance {SLICE_REL_TOL})")
    x16 = torch.randn((16, 256, 256, 1), device="cuda")
    t16 = torch.full((16,), 500, device="cuda", dtype=torch.long)
    y16 = torch.zeros((16,), device="cuda", dtype=torch.long)
    with torch.no_grad():
        step_ms = cuda_time_ms(lambda: model(x16, t16, y16), 20)
    log(f"phase 4b denoiser batch 2 bf16 vs f32 plain: rel L2 {rel:.4e} "
        f"(tol {SLICE_REL_TOL}); denoiser call at batch 16: "
        f"{step_ms:.4f} ms")
    profiles = [profile_denoiser(model, b) for b in (16, 4)]
    for p in profiles:
        log("profile " + json.dumps(p))
    del ref
    chains = wide256_norm_chains(fn, model)
    log(f"phase 4b wide256 GroupNorm->(FiLM)->SiLU chains through B4 "
        f"({card_line}): " + json.dumps({k: v for k, v in chains.items()
                                        if k != "rows"}))

    # (a') DDPM at batch 4: eager over 100 steps, graphed over all 1000;
    # and the graph replays' profile at batch 16 and 4
    graph_rows = [graph_steps(ddpm_plan(model, 16), timed_steps=200),
                  graph_steps(ddpm_plan(model, 4))]
    for row in graph_rows:
        prof = row["profile"]
        # the profiler may lose an event in a window: round per replay
        if round(prof["b1_per_replay"]) != 8:
            raise AssertionError(f"graph replay runs {prof['b1_per_replay']}"
                                 " B1 kernels per step, expected 8")
        if round(prof["b4_per_replay"]) != WIDE256_CALLS_B4:
            raise AssertionError(f"graph replay runs {prof['b4_per_replay']}"
                                 f" B4 kernels per step, expected "
                                 f"{WIDE256_CALLS_B4}")
        log("phase 4a' DDPM steps, eager vs graphed: " + json.dumps(row))

    # (c) SuperDiff OR and AND, batch 4, T=1000, two models, graphed. OR
    # also eagerly, the "before": samples and logq bit for bit. AND: the
    # eager and graphed plans over the last 100 steps from one state, x and
    # logq bit for bit (a whole eager AND batch would add ~60-95 s of
    # host-bound time)
    _, model2, _ = load_run(run2, device="cuda")
    apply_sampling_policy(model2)
    superdiff = {}
    for mode in ("or", "and"):
        out_c = os.path.join(work, mode)
        argv = ["--run-dir", run1, "--run-dir2", run2, "--mode", mode,
                "--batch-size", "4", "--seed", "1", "--out", out_c,
                "--device", "cuda"]
        if mode == "or":
            row, (xs, logq), counts = sample_pair(sample, argv,
                                                  "SuperDiff or")
            check_launches(counts["eager"]["b1"], 2000, "eager SuperDiff or")
            check_b4(counts["eager"]["b4"], 2000, "eager SuperDiff or")
            check_b4(sum(counts["graph"]["b4_run"].values()),
                     2 * (1000 + WARMUP_STEPS), "graphed SuperDiff or")
            graph_b1, graph_b4 = counts["graph"]["b1"], counts["graph"]["b4"]
        else:
            fa.reset_launches()
            fn.reset_launches()
            secs, cap_s = run_cli(sample, argv)
            graph_b1, graph_b4 = fa.launches, fn.launches
            xs = np.load(os.path.join(out_c, "samples.npy"))
            with open(os.path.join(out_c, "logq.json")) as f:
                lq = json.load(f)
            logq = np.array([lq["logq_model1"], lq["logq_model2"]])
            row = dict(graph=dict(s_per_batch=secs, capture_s=cap_s,
                                  logq_gap_mean=lq["logq_gap_mean"]),
                       steps=graph_steps(superdiff_plan((model, model2), 4,
                                                        mode),
                                         timed_steps=100))
        check_launches(graph_b1, 2 * (WARMUP_STEPS + 1),
                       f"graphed SuperDiff {mode}")
        check_b4(graph_b4, 2 * (WARMUP_STEPS + 1), f"graphed SuperDiff {mode}")
        if (xs.shape != (4, 256, 256, 1) or logq.shape != (2, 4)
                or not (np.isfinite(xs).all() and np.isfinite(logq).all())):
            raise AssertionError(f"SuperDiff {mode}: samples {xs.shape}, "
                                 f"logq {logq.shape}, finite or not")
        superdiff[mode] = row
        log(f"phase 4c SuperDiff {mode.upper()} T=1000 batch 4 (graphed; "
            "eager against it): " + json.dumps(row))
    del model2

    training_out, train_launches = phase_training(
        fa, fn, work, run1, tcfg, model_from_config, load_run, sample)

    # the reference-model slice runs under PyTorch's default cuDNN TF32 (on),
    # as a user's cli.sample / cli.train would; the RefUNet's convolutions
    # run IEEE float32 whatever it says, which phase 6b checks
    with tf32(True):
        ref_out, ref_counts = phase_ref(fa, fn, work, sample, load_run,
                                          model)
    del model

    # (7) serving: cli.serve's loading, the service and the HTTP app
    with tf32(True):
        serving = phase_serving(fa, fn, run1, run2,
                                os.path.join(work, "imported_TB"))
    log(f"phase 7 serving ({card_line}): " + json.dumps(serving))

    # (8) the data layer and evaluation: cli.train on a PNG tree, then
    # cli.evaluate's FIDs, under PyTorch's default cuDNN TF32 (a user's run)
    with tf32(True):
        data_eval, smallcnn_rows, eval_b4, (tree_run, root) = \
            phase_data_eval(fa, fn, work, card_line)

    # (9) progressive distillation of the tree-trained run (cli.distill),
    # its students sampled and evaluated, under PyTorch's default TF32
    with tf32(True):
        distill, distill_launches = phase_distill(fa, fn, work, card_line,
                                                  tree_run, root)

    # (10) the visual slice: cli.inspect_data, cli.visualize (and --compare)
    # and cli.train's figures, under PyTorch's default TF32
    with tf32(True):
        viz, viz_launches = phase_viz(fa, fn, work, card_line, tree_run, root,
                                      run1, run2)

    # (11) the parallel modes: a world-1 NCCL group through the entry
    # points, and what one card can hold of TP, stacked models, PP and CP
    parallel = phase_parallel(fa, fn, work, card_line, run1, run2)

    summary = dict(card=card_line, build_s=build_s, training=training_out,
                   ddpm1000_batch16=ddpm, graph_steps=graph_rows,
                   denoiser_ms_batch16=step_ms,
                   slice_rel_l2_bf16_vs_f32=rel, superdiff=superdiff,
                   profiles=profiles, wide256_norm_chains=chains,
                   ref_slice=ref_out, serving=serving,
                   data_eval=data_eval, distill=distill, viz=viz,
                   parallel=parallel, total_s=time.time() - t_start)
    log("slice " + json.dumps(summary))

    kernels = []
    for (B, S, H, D) in PATH_SHAPES:
        row = rows[(B, S, H, D, "bfloat16")]
        kernels.append(dict(
            name=f"flash_attn_fwd[bf16 B{B} S{S} H{H} D{D}]", route="cuda",
            source=KERNEL_SRC, replaces=TPU_KERNEL,
            launches=main_launches.get((S, D, "bfloat16"), 0),
            wrapper_launches=main_counts["b1_by_shape"].get(
                (S, D, "bfloat16"), 0),
            captured_per_replay=main_counts["b1_captured"].get(
                (S, D, "bfloat16"), 0),
            graph_replays=main_counts["replays"],
            eager_launches=eager_launches.get((S, D, "bfloat16"), 0),
            train_launches=train_launches["fwd"].get((S, D, "bfloat16"), 0),
            distill_launches=distill_launches["fwd"].get((S, D, "bfloat16"),
                                                         0),
            visualize_launches=viz_launches["b1"].get((S, D, "bfloat16"), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            kernel_device_ms=row["kernel_device_ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_device_ms=row["library_device_ms"]))
        if not (kernels[-1]["captured_per_replay"]
                and kernels[-1]["train_launches"]):
            raise AssertionError(f"path shape {(B, S, H, D)} never launched "
                                 "in the graph or in training")
    for kern, name, replaces in (("dq", "flash_attn_bwd_dq", TPU_BWD_DQ),
                                 ("dkv", "flash_attn_bwd_dkv", TPU_BWD_DKV)):
        for (B, S, H, D) in PATH_SHAPES:
            row = bwd_rows[(kern, B, S, H, D, "bfloat16")]
            kernels.append(dict(
                name=f"{name}[bf16 B{B} S{S} H{H} D{D}]", route="cuda",
                source=BWD_SRC, replaces=replaces,
                launches=train_launches[kern].get((S, D, "bfloat16"), 0),
                distill_launches=distill_launches[kern].get(
                    (S, D, "bfloat16"), 0),
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                kernel_device_ms=row["kernel_device_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                library_device_ms=row["library_device_ms"]))
            if kernels[-1]["launches"] == 0:
                raise AssertionError(f"{name} never launched at path shape "
                                     f"{(B, S, H, D)} in training")
    chain_rows = {tuple(r["shape"][1:]) + (r["groups"], r["film"]): r
                  for r in chains["rows"]}
    for key, n_run in sorted(main_counts["b4_run"].items()):
        H, W, C, G, film, dname = key
        row = chain_rows[(H, W, C, G, film)]
        picked = next(v for k, v in row.items() if k.endswith("*"))
        kernels.append(dict(
            name=f"group_norm_silu_policy[bf16 B16 {H}x{W} C{C} G{G}"
                 f"{' FiLM' if film else ''}]",
            route="cuda", source=GN_SRC, replaces=TPU_GN, launches=n_run,
            wrapper_launches=main_counts["b4_by_shape"].get(key, 0),
            captured_per_replay=main_counts["b4_captured"].get(key, 0),
            graph_replays=main_counts["replays"],
            distill_launches=distill_launches["b4"].get(key, 0),
            visualize_launches=viz_launches["b4"].get(key, 0),
            launches_per_call=row["launches_per_call"],
            regime=picked["geometry"]["regime"],
            max_abs_err=picked["max_abs_err"], max_ulps=picked["max_ulps"],
            share_differing=picked["share_differing"], ms=picked["ms"],
            kernel_device_ms=picked["device_ms"], plain_ms=row["plain_ms"],
            plain_device_ms=row["plain_device_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"],
            library_device_ms=row["library_device_ms"]))
        if kernels[-1]["captured_per_replay"] == 0:
            raise AssertionError(f"B4 never launched at path shape {key} "
                                 "in the DDPM graph")
    for (B, H, W, C, G, film) in GN_PATH_SHAPES:
        row = gn_rows[(B, H, W, C, G, film, "float32")]
        kernels.append(dict(
            name=f"group_norm_silu[f32 B{B} {H}x{W} C{C} G{G}]",
            route="cuda", source=GN_SRC, replaces=TPU_GN,
            launches=ref_counts["run"].get((H, W, C, G, film, "float32"), 0),
            wrapper_launches=ref_counts["wrapper"].get(
                (H, W, C, G, film, "float32"), 0),
            captured_per_replay=ref_counts["captured"].get(
                (H, W, C, G, film, "float32"), 0),
            graph_replays=ref_counts["replays"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
        if kernels[-1]["captured_per_replay"] == 0:
            raise AssertionError(f"B4 never launched at path shape "
                                 f"{(B, H, W, C, G)} in the ref DDPM graph")
    for (B, H, W, C) in SMALLCNN_SHAPES:
        row = smallcnn_rows[(H, W, C)]
        kernels.append(dict(
            name=f"group_norm_silu[f32 B{B} {H}x{W} C{C} G8 eps1e-6 "
                 "SmallCNN]",
            route="cuda", source=GN_SRC, replaces=TPU_GN,
            launches=eval_b4.get((H, W, C, 8, False, "float32"), 0),
            inspect_launches=viz_launches["inspect_b4"].get(
                (H, W, C, 8, False, "float32"), 0),
            regime=row["regime"], max_abs_err=row["max_abs_err"],
            ms=row["ms"], kernel_device_ms=row["kernel_device_ms"],
            graph_ms=row["graph_ms"], plain_ms=row["plain_ms"],
            plain_graph_ms=row["plain_graph_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            library_graph_ms=row["library_graph_ms"]))
        if kernels[-1]["launches"] == 0:
            raise AssertionError(f"B4 never launched at the SmallCNN shape "
                                 f"{(B, H, W, C)} in cli.evaluate")
    kernels += sd_kernel_rows(sd_rows, sd_call)
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        # phase 11a's subprocess (started by leg_world1, never by hand)
        parallel_worker(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
