#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py                        # every phase below
    python3 chip_smoke.py --plant-fault          # the block-backward check,
                                                 # against a kernel with a
                                                 # planted fault
    python3 chip_smoke.py --plant-fault policy   # the dPolicy check, the same
    python3 chip_smoke.py --plant-fault int8     # the int8 block check, the same
    python3 chip_smoke.py --plant-fault cls      # the CLS fold's check, the same
    python3 chip_smoke.py --plant-fault droppath    # the branch scales' check
    python3 chip_smoke.py --plant-fault attn_block  # the half-block backward's
    python3 chip_smoke.py --plant-fault variant     # the variants' check against v0
    python3 chip_smoke.py --plant-fault attn_core   # the block's attention-core check
    python3 chip_smoke.py --plant-fault scatter     # the scatter's bit-equality
    python3 chip_smoke.py --plant-fault gemm        # the block's qkv-stage check
    python3 chip_smoke.py --plant-fault qgemm       # the int8 block's qkv-stage check
    python3 chip_smoke.py --plant-fault ln_bwd      # the LayerNorm backward's check
    python3 chip_smoke.py --plant-fault colsum      # the column sums' check
    python3 chip_smoke.py --plant-fault attn_bwd    # the attention core backward's check
    python3 chip_smoke.py --plant-fault predictor   # the score predictor's check
    python3 chip_smoke.py --plant-fault head_width  # phase 35's check at head width 12
    python3 chip_smoke.py --plant-fault head_width_bwd  # its backward check at width 12
    python3 chip_smoke.py --plant-fault mode_plain  # phase 33's launch check
    python3 chip_smoke.py --plant-fault remat       # phase 33's remat check
    python3 chip_smoke.py --plant-fault bn_eval     # phase 33's BatchNorm eval check

Phases (each prints JSON lines; any failure raises and exits non-zero):
  1. build       the CUDA kernels of dense2sparse_vit_torch/csrc (nvcc, sm_90a);
  2. serve       batches of 1, 8 and 256 random NHWC images through the
                 headline student (DeiT-S/16, 224 px, bf16, pruning
                 0.7/0.49/0.343 at blocks 3/6/9, small predictor) built by
                 `create_model`, check the outputs and that each forward
                 launched 12 block, 3 predictor and 3 gather kernels;
  3. check       walk the model stage by stage at B=256 and hold every
                 serving kernel against its plain torch version on the same
                 activations (the block stage by stage: see `check_block`;
                 the predictor against its plain version and the plain
                 split form, two launches bit-equal: `check_predictor`),
                 then the unpruned forward against the plain torch model;
  4. time        each serving kernel against its plain version at every
                 main-path shape (the predictor also from a CUDA graph; its
                 device time is phase 31's), and the whole B=256 forward
                 with kernels against without;
  5. train       three B=128 train steps of the headline student with its
                 live teacher (DeiT-S, bf16), built by `create_model`,
                 `make_optimizer` and `make_train_step`, at epoch 6 with the
                 optimizer's count past the warmup; check every metric is
                 finite, each step's launches per kernel (PER_TRAIN_STEP),
                 that every trained parameter moved and cls_token and
                 pos_embed did not;
  6. check_train hold the training kernels against their plain versions on
                 a train step's own activations: the block backward at every
                 block's input (`check_block_backward`), the scatter at every
                 stage (bit-equal), the teacher's CLS rows at every block;
  7. time_train  the training kernels against their plain versions (and the
                 one torch call that computes the same function, where there
                 is one; the scatter and index_add_ also replayed from a
                 CUDA graph, without the host's launch cost), and the whole
                 train step with kernels against without;
  8. serve_threshold  batches of 1, 8 and 256 through the same student in
                 threshold mode (patch_score_threshold 0.5): per forward 3
                 plain and 9 policy-mode blocks, 3 predictors, no gather;
                 walk it stage by stage at B=256 holding every block against
                 its plain version (policy blocks at eps 1e-6 and 0.1), and
                 time the policy block and the whole forward;
  9. train_threshold, 10. train_gumbel  three B=128 steps each, with the
                 live teacher, of the threshold student (`make_train_step`)
                 and of the gumbel baseline (`default_dynamic_vit_small_
                 patch16_224_student`, `make_dynamic_vit_train_step`): per
                 step 3 plain and 9 policy blocks each way; every trained
                 parameter (the gumbel predictors included) moves; the block
                 backward at every block of a step's own activations, the
                 policy ones with dPolicy at eps 1e-6 and 0.1 (the gumbel
                 run once more on an input with planted exact ties), and the
                 policy backward and each step timed;
 11. serve_gumbel  a B=8 eval forward of the gumbel baseline (top-k gathers,
                 plain blocks);
 12. serve_int8  batches of 1, 8 and 256 through the headline student with
                 quant="int8": per forward 12 int8 blocks, 3 predictors, 3
                 gathers and no bf16 block;
 13. check_int8  walk its B=256 forward stage by stage and hold every int8
                 block against its plain version (`check_int8_block`); the
                 int8 logits against the bf16-kernel model's;
 14. time_int8   the int8 block against its plain version and the bf16 block
                 kernel at N=197/138/97/68, and the whole B=256 forward int8,
                 bf16 kernels and plain;
 15. serve_export  `ServingModel.export` of the int8 student (symbolic, or
                 buckets 1/8/32/256: printed), saved and loaded in a fresh
                 process that never imports the model code, serving ragged
                 batches of 1, 5, 37, 256 and 300; the bf16 top-k, threshold
                 and gumbel students the same at one bucket of 8: the live
                 model's logits and launch counts;
 16. eval        one `make_eval_step` of the headline student (bf16 and int8)
                 and one `make_dynamic_vit_eval_step` at B=64, 8 rows padded
                 with label -1: finite metrics, n_valid 56, and the launches
                 of the teacher's, the pruned and the unpruned forwards;
 17. train_attn  three B=128 train steps of the attn-selection student
                 (the headline student ranking by its own CLS rows, no
                 predictors) with its live teacher: per step
                 PER_ATTN_TRAIN_STEP, finite metrics, every trained tensor
                 moves and cls_token and pos_embed do not;
 18. check_attn  on a step's own activations at every block, the packed
                 attention both ways and the MLP half both ways against
                 their plain versions (`check_attn_block`), the CLS fold alone
                 (g = 0) where the rows rank a stage; the packed attention's
                 policy mode at N=197 on a threshold student's keep mask, eps
                 1e-6 and 0.1;
 19. time_attn   each of the four against its plain version at N=197, 138,
                 97, 68 (the packed core beside torch's
                 scaled_dot_product_attention, also from a CUDA graph; its
                 backward beside the library's backward alone, forward and
                 backward less the forward), and the whole attn train step
                 with kernels against without;
 20. serve_attn  a B=8 eval forward of the attn student: 12 CLS-row blocks and
                 3 gathers, 12 CLS-row widths, logits against the plain model;
 21-24. serve_t2t, train_t2t, check_droppath, time_droppath  the pruned
                 T2T-ViT-14 served at B=8 and 128 and trained at B=128 with
                 drop path 0.1, the DropPath branch-scale kernels held against
                 their plain versions at every scaled block, and timed;
 25. attn_block  the attention half-block x + proj(MHA(qkv(LN1 x))) on the
                 headline student's own block inputs and weights at N=197,
                 138, 97, 68: the forward (plain; policy at eps 1e-6 and 0.1
                 on a threshold student's keep mask; the CLS rows) stage by
                 stage (`check_attn_half`) and the backward (plain; policy
                 with dPolicy) against their plain versions at B=128
                 (`check_attn_half_backward`), the forward again at B=256;
                 the trainable half-block through autograd (its launches
                 checked); each plain version timed (forward B=256, backward
                 B=128), and the packed attention's policy mode beside its
                 plain version;
 26. kernel_sweep  `scripts.kernel_sweep.main` at its defaults, its rows as
                 JSON lines (a main-path run of the half-block's kernels:
                 its rows' launches, and per launch their times, go into
                 the kernels line);
 27. attn_variants  `scripts.attn_variants.main` at B=256, C=384, 6 heads,
                 N=197/138/97/68, v0-v3 (the other main-path run, counted
                 the same way): every variant within the forward check's
                 tolerance of v0, then against its plain version
                 (`check_variant`), timed;
 28. gemm        the shared GEMM engine (`ops.gemm`, csrc/ln_gemm.cuh) alone
                 at the main path's shapes: the block forward's four
                 products at B=256, N=197, the backward's four dX products
                 and four weight gradients at B=128, each held against its
                 plain version and timed by CUDA events and from a CUDA
                 graph beside one torch call (`F.linear`, `torch.matmul`);
                 its int8 instantiation (`ops.quant.qgemm`) at the int8
                 block's four products at B=256, N=197, bit-equal to its
                 plain version (through GELU within one bf16 rounding),
                 timed the same way beside `torch._int_mm` (int8 in, int32
                 out, no dequantization); the built library's SASS: every
                 GEMM kernel (the engine's three bf16 modes and its int8
                 one, nothing else) with wgmma (HGMMA bf16, IGMMA int8) and
                 no mma.sync (HMMA, IMMA);
 29. norm        the block backward's LayerNorm backward (csrc/norm.cu,
                 `ops.norm.ln_backward`) and bias column sums on a B=128
                 top-k step's own activations at N=197/138/97/68 (its two
                 calls per block backward; the column-sum kernel on the
                 bf16 g, dy, dqkv and the fp32 da; the bf16 sums folded into
                 the weight gradients, dW's bits unchanged), each against
                 its plain version, then timed beside it, one torch call
                 (native_layer_norm_backward; a.sum(0, dtype=float32)) and
                 its bound;
 30. attn_bwd    the attention core's backward (attention_bwd_kernel, inside
                 every backward with attention) through
                 `ops.fused_attention_backward_packed`, which launches it
                 beside the forward recompute and dPolicy's head sum: held
                 against its plain version at every block of a B=128 top-k
                 step, at a threshold step's first and last policy blocks
                 (with dPolicy, eps 1e-6 and 0.1, and on planted exact ties)
                 and at an attn step's stage-feeding blocks (with the CLS
                 rows' cotangent), a second call bit-equal each time; the
                 built library's SASS (wgmma in every instantiation,
                 mma.sync in the policy ones alone); the kernel timed at
                 N=197/138/97/68 by the profiler's device time, its plain
                 version and SDPA's backward from CUDA graphs, beside its
                 bound, and at N=197 in policy mode and with the fold;
 31. predictor   the score predictor's kernel (csrc/predictor.cu) alone on
                 phase 3's three stage inputs, with the student's small
                 predictors and a seeded large one: `check_predictor` at
                 each, then the profiler's device time and a CUDA graph's
                 time beside the plain version and the plain split form
                 (CUDA graphs) and its bound;
 32. train_loop  the training entry point, `cli.parse_config` ->
                 `train.loop.run_experiment`, on the headline student at
                 B=128 with 2 spawned decode workers over a synthetic
                 folder of 720 JPEGs (12 classes, sides 256-400 px, from a
                 numpy seed; 576 train and 144 val images): (a) the default
                 recipe (RandAugment, random erasing 0.25, mixup 0.8, cutmix
                 1.0) with --epochs 3, preempted after 2 epochs of 4 steps,
                 each step's launches PER_TRAIN_STEP, no synchronizing CUDA
                 operation in a step or the batch's finish, each eval 128 +
                 16 valid rows (112 padded), every logged number finite,
                 best/ and latest/ written; (e, f) --eval-only with
                 --export-serving on its workdir, the artifact against the
                 best checkpoint's live model; (b) --resume of its third
                 epoch, bit-equal to a straight 3-epoch run (parameters,
                 moments, counts, best metric); (c) --teacher-cache, resident
                 on the card with its images, each step PER_CACHED_TRAIN_STEP,
                 and a cached step's loss against a live-teacher step's
                 within CACHE_LOSS_TOL; (d) --grad-accum-steps 2, the
                 parameters moving on every second micro-step alone. Prints
                 the loop's train_img_per_s beside the bare step's rate
                 (phase 5's `build_trainer`) and the host's decode ms a batch.
 33. student_modes  the student's other modes (`mode_specs`) at full width:
                 soft top-k (`dino_small_student`, nS=500, epoch 0), random
                 and teacher-CLS selection, the BatchNorm predictor, the
                 early-exit head, dropout 0.1, remat (at drop path 0.1) and
                 attn with a stage at block 0 (0/6/9). Each: one B=128 train
                 step with the live teacher, its launches
                 (PER_MODE_TRAIN_STEP) and peak memory, against the same
                 step on the plain model with the same weights, draws and
                 kept tokens (loss, and the predictors', the early-exit
                 head's and blocks 0, 3 and 11's gradients, `compare_steps`);
                 the soft top-k backward against float64 on the step's own
                 noise (`check_soft_topk_backward`); the BatchNorm running
                 statistics moved, then used in eval (`check_bn_eval`);
                 remat's gradients against the step without it
                 (`check_remat`); a second step, timed; one B=256 eval step
                 (PER_MODE_EVAL_STEP). Then one CLI epoch each of
                 `--random-drop --early-exit --predictor-bn` and
                 `--cls-from-teacher` over phase 32's folder.
 34. deit_family  the DeiT, ViT and DINO backbones and 384-px training
                 (`phase_deit_family`): (b) one B=64 train step each in
                 top-k, threshold and attn selection of
                 `dynamic_vit_base_patch16_224_student` at img_size=384
                 (N = 577 / 404 / 283 / 198) with its teacher, launches
                 (the attention core backward's long path: 6, 12, 6) and
                 memory, against its plain twin's step on the same weights,
                 draws and kept tokens (`compare_steps`), a second step
                 timed; the predictor kernel on that student's stage
                 inputs (N = 576 / 403 / 282); one CLI epoch of
                 `--arch deit_base --img-size 384 --eval-crop 384` at B=32
                 over phase 32's folder, ending in a checkpoint and an
                 eval, and a teacher-cache step against a live one at 384
                 px; (a) attention_bwd_kernel's long path on those steps'
                 activations (plain at N = 577 and 404, policy with dPolicy
                 at eps 1e-6 and 0.1 and on planted ties, the CLS fold) and
                 at N = 785 (dino_small, patch 8), each against its plain
                 version, two launches bit-equal (`check_attn_bwd`), timed
                 at N = 577 and 404 beside its bound and SDPA's backward;
                 (c) one model of each family class at full width, fused
                 against its plain twin (FAMILY_MODELS, B=32), every other
                 DeiT, ViT and DINO name at depth 2, and a B=64 forward of
                 `deit_base_patch16_384` and `vit_large_patch16_384` timed
                 with the device's busy share; (d) the int8 ViT-L/16 at 384
                 px: the int8 block at C = 1024, hidden 4096, N = 577
                 against its plain version, its logits against the bf16
                 kernels'.
 35. head_width  head widths other than 64 and the rest of the zoo
                 (`phase_head_widths`): (a) at d = 12 (32 heads, C = 384) and
                 d = 96 (8 heads, C = 768) on seeded B=64 activations at
                 N = 197, 138, 97, 68 (and 577, 785 for the block and the
                 packed attention both ways), the block forward stage by
                 stage in plain, policy (eps 0.1, and 1e-6 at N = 197),
                 branch-scale and CLS-row mode, its backward in plain,
                 policy (with dPolicy; planted ties at N = 197) and
                 branch-scale mode, the packed attention both ways with the
                 CLS fold (two backward launches bit-equal), the half-block
                 both ways and the int8 block at d = 96, each against its
                 plain version; (b) vit_small_patch16_224 (8 heads of 96)
                 and t2t_vit_14_resnext (32 heads of 12) at full width and
                 depth, bf16: a fused B=32 eval forward against the plain
                 twin (the block kernel and the attention_hd core once a
                 block), one cross-entropy backward against the twin
                 (resnext at drop path 0.1: the branch-scale mode at
                 d = 12), vit_small with quant="int8"; (c) the other seven
                 new names (t2t_vit_14_wide, _se, 16_ghost, dense, TNT-S/B,
                 drop_resnet50) at full width, B=8 bf16 against fp32, no
                 kernel launched; (d) the new path's kernels timed at
                 N = 197 and 577 beside their plain versions, SDPA and their
                 bounds, and a B=64 forward of (b)'s models in img/s.
 36. distributed  distributed training (`phase_distributed`): (a) a NCCL
                 process group of one rank in this process; one B=128 step
                 of the headline student under DDP (`train_step.wrap_ddp`)
                 bit-equal to the unwrapped step from the same weights and
                 batch (loss and every updated parameter), its launches
                 PER_TRAIN_STEP; (b) step ms with and without DDP (CUDA
                 events, medians); (c) `run_experiment` under that group
                 over phase 32's folder, one epoch of 2 steps and its eval,
                 one checkpoint, then --resume continuing at step 2; (d)
                 two spawned processes on the one card in a gloo group,
                 each with half of a B=64 batch, against one process on
                 the whole batch.
 37. experiments  the users' experiment entry points over phase 32's
                 folder, each against its plain run (`phase_experiments`):
                 (a) `eval_imagenet.evaluate` of a DeiT-S checkpoint at
                 B=128 (720 images, a padded tail of 80; 24 block, 3
                 predictor, 3 gather launches a batch; counts within 1% of
                 the images, the first batch's unpruned logits within
                 LOGITS_TOL; img/s); (b) `display_patch_drop` on dino_small
                 and DeiT-S at B=16 (11 blocks and the CLS-row block a
                 forward, the rows within STAGE_TOL, the 18 keep masks
                 equal where the rows' error does not explain a flip, 18
                 PNGs); (c) `run_optimized_mask`, DeiT-S, B=16, mask_block
                 7, 5 epochs (5 block backwards an epoch, epoch 0's loss
                 within 2% of the plain run's, ms an epoch); (d) the loop
                 with --visualize-patch-drop --visualize-cls-attn-evo (both
                 PNGs, parameters bit-equal to the run without); (e) the
                 native normaliser (built, used, within 2 ulps of numpy,
                 host ms); (f) three B=128 steps with fused AdamW, their
                 gradients also through --no-flat-optimizer's loop on a twin
                 (parameters within 1e-5; launches, host and device ms of an
                 optimizer step).
The build phase fails if ptxas reports a spill in a GEMM kernel, in
attention_bwd_kernel or in an instantiation of the head-width cores
(attention_hd_kernel, attention_hd_bwd_kernel: each of the 16 of each
must be in its log), or reports on no int8 one, or if it serializes
attention_bwd_kernel's wgmma products; it prints that kernel's C75xx
notices (`wgmma_notices`).
The pruning student runs its serving, timing and export phases without
capturing its own CLS rows (collect_cls_attns=False), as the JAX package's
callers do.
The kernels summary holds two rows more than the kernels: the part of
attention_bwd_kernel's launches on its long path and the int8 block at
hidden 4096 (SUB_ROWS), each with phase 34's launches and times.
The line before the last two is the kernels summary, then the card's name
and power limit, then {"ok": true, "device": {...}}. Without a CUDA device
it exits 1 at once.

--plant-fault builds a copy of the kernels whose block backward drops the
rowsum(dO * O) term of the softmax backward, runs phase 6's block-backward
check with it, prints whether the check rejected it, and exits 0 only if it
did; it prints no "ok" line. --plant-fault policy does the same with a
block backward whose dPolicy keeps the diagonal (which the policy softmax
leaves out), on a gumbel train step's policy blocks; --plant-fault int8
with an int8 block whose fc2 takes fc1's column scales, on phase 13's walk
at B=64; --plant-fault cls with a packed attention backward that leaves
sum_j gcls_j P_0j out of D_0, on phase 18's checks at the blocks whose CLS
rows rank a stage; --plant-fault droppath with a residual epilogue that
ignores the branch scales, on phase 23's checks; --plant-fault attn_block
with a half-block backward whose dx leaves out the residual cotangent g on
row 0 of each sample, on phase 25's backward checks; --plant-fault variant
with a v2 that recovers head b's scores as (S+ + S-) / 2, on phase 27's
comparison with v0; --plant-fault attn_core with an attention core whose
P.V and row sums stop one 16-key block short of N, on phase 3's walk (the
core stage of `check_block`); --plant-fault scatter with a scatter that
leaves out each row's last matching index, on phase 6's bit-equality check;
--plant-fault gemm with a GEMM whose consumers skip the last K slice's
products (`ln_gemm.cuh`), on phase 3's walk (the qkv stage of
`check_block`); --plant-fault qgemm with an int8 GEMM whose consumers skip
the last K slice's products (`ln_gemm.cuh`), on phase 13's walk at B=64
(the qkv stage of `check_int8_block`); --plant-fault ln_bwd with a
LayerNorm backward that leaves z mean(dz z) out of dx, and --plant-fault
colsum with column sums that leave out the last split's rows (`norm.cu`),
on phase 29's checks; --plant-fault attn_bwd with an attention core
backward whose dQ leaves out the last key block's products
(`block_bwd.cu`), on phase 30's checks; --plant-fault predictor with a
predictor whose tail takes each sample's pooled mean from the next
sample's sums (`predictor.cu`), on phase 3's walk. --plant-fault
mode_plain, remat and bn_eval plant phase 33's faults in the port's Python
for the run (`mode_fault`): the dropout mode's packed attention core
swapped for plain attention (rejected by its launch check), remat's
recompute drawing anew from where the forward left the generator (by
`check_remat`), an eval-mode BatchNorm normalising with the batch's
statistics (by `check_bn_eval`). --plant-fault head_width with the core at
head widths other than 64 (`block.cu`'s attention_hd_kernel) leaving the
last key block out of P.V (not out of the row sums), on phase 35's block
check at d = 12, N = 197 (its attn stage); --plant-fault head_width_bwd
with its backward (`block_bwd.cu`'s attention_hd_bwd_kernel) leaving the
last key block out of dQ, on the same run's block-backward check (the
q third of the qkv weight's gradient).
"""

from __future__ import annotations

import contextlib
import json
import shutil
import statistics
import sys
import time

SERVE_BATCHES = (1, 8, 256)
B_CHECK = 256
B_TRAIN = 128
TRAIN_STEPS = 3
TRAIN_EPOCH = 6  # past TrainConfig's 5 warmup epochs
STEPS_PER_EPOCH = 10
# Tolerances, bf16. Kernel and plain version round to bf16 (2^-8 relative)
# at different points (qkv, probabilities, the GELU input), so a few
# roundings compound. Each is relative to the largest magnitude of what is
# compared.
STAGE_TOL = 2e-2  # a block stage, the predictor's scores, the CLS rows
# a residual stage x + branch: the kernel's error beyond the one bf16
# rounding of the sum, relative to the largest magnitude of the branch
BRANCH_TOL = 1e-2
BF16_U = 2.0 ** -8  # round-to-nearest bf16: |rn(z) - z| <= 2^-8 |z|
BLOCK_TOL = 2e-2  # the whole block output
LOGITS_TOL = 3e-2  # twelve blocks of such differences, unpruned forward
# the block backward: dx and each of the twelve gradients, relative to that
# tensor's largest magnitude; the plain version (autograd through the plain
# block) rounds every intermediate gradient to bf16, the kernel keeps the
# LayerNorm and residual ones in fp32
BWD_TOL = 3e-2
# a CLS row's sum: N probabilities each rounded to bf16
ROWSUM_TOL = 1e-2
# dPolicy (the policy backward's gradient of the keep policy), relative to
# its largest magnitude: fp32 sums on both sides over bf16 products
DPOL_TOL = 3e-2
EPS_CHECKS = (1e-6, 0.1)  # the policy softmax's smoothing: the model's, and visible
# The int8 block (check_int8_block). A quantization whose input the kernel
# and the plain version compute alike (the attention output, the GELU
# activation) gives the same codes; one fed a LayerNorm (LN1(x), LN2(x_mid))
# may move a code by one step where h / s lies within rounding of a half:
# at most CODE_FLIP_SHARE of the codes, by at most one step. The stages fed
# the kernel's own codes (qkv, x_mid, GELU(fc1), fc2's output) repeat its
# exact integer products: within one bf16 rounding of each element, beyond
# which INT8_ULP_TOL of the tensor's largest magnitude (erf near zero);
# x_mid (fp32) within INT8_MID_TOL of its branch.
CODE_FLIP_SHARE = 1e-3
INT8_ULP_TOL = 1e-3
INT8_MID_TOL = 1e-5
SCALE_TOL = 1e-6  # a row scale, relative: one fp32 rounding of the absmax
KERNEL_NAMES = (
    "fused_transformer_block", "fused_transformer_block[policy]",
    "fused_transformer_block_cls", "fused_transformer_block_backward",
    "fused_transformer_block_backward[policy]", "fused_predictor_lg",
    "fused_gather_tokens", "fused_scatter_tokens", "fused_transformer_block_int8",
    "fused_attention_packed", "fused_attention_backward_packed", "fused_mlp_residual",
    "fused_mlp_residual_backward", "fused_transformer_block[scaled]",
    "fused_transformer_block_backward[scaled]", "attention_block_forward",
    "attention_block_backward", "attention_block_backward_policy", "attention_variant",
    "ln_bwd", "column_sums", "attention_bwd", "attention_hd", "attention_hd_bwd",
)
NO_LAUNCHES = dict.fromkeys(KERNEL_NAMES, 0)
# rows of the kernels line that are a part of a kernel's launches, at the
# shapes of phase 34: attention_bwd_kernel's long path (N past 384, policy
# mode 352; counted by the library, `ops.attention.ATTENTION_BWD_LONG`) and
# the int8 block at ViT-L's MLP width (hidden 4096)
SUB_ROWS = ("attention_bwd[long]", "fused_transformer_block_int8[4096]")


def norm_launches(blocks=0, halves=0) -> dict:
    """The LayerNorm backward's and the column sums' launches inside `blocks`
    whole-block backwards (two LayerNorm backwards and dbproj's fp32 column
    sums each; the bf16 bias sums ride on the weight gradients) and `halves`
    half-block backwards (the MLP half's or the attention half's: one
    LayerNorm backward, no column-sum kernel)."""
    return {"ln_bwd": 2 * blocks + halves, "column_sums": blocks}


def core_launches(backwards=0) -> dict:
    """The attention core backward's launches inside `backwards` backwards
    with attention (whole-block, packed attention and attention half-block
    backwards: one each; an MLP half's backward has none)."""
    return {"attention_bwd": backwards}


PER_FORWARD = {**NO_LAUNCHES, "fused_transformer_block": 12, "fused_predictor_lg": 3,
               "fused_gather_tokens": 3}
# one train step: the teacher's 12 blocks with their CLS rows; the student's
# 12 block forwards and backwards, 3 gathers and their 3 scatters; the
# predictors train through their plain layers
PER_TRAIN_STEP = {**NO_LAUNCHES, "fused_transformer_block": 12,
                  "fused_transformer_block_cls": 12, "fused_transformer_block_backward": 12,
                  "fused_gather_tokens": 3, "fused_scatter_tokens": 3, **norm_launches(12),
                  **core_launches(12)}
# threshold serving: 3 plain blocks before the first stage, 9 policy blocks
# from it on, 3 predictors, nothing gathered
PER_THRESHOLD_FORWARD = {**NO_LAUNCHES, "fused_transformer_block": 3,
                         "fused_transformer_block[policy]": 9, "fused_predictor_lg": 3}
# a threshold or gumbel train step: the teacher's 12 CLS-row blocks; the
# student's 3 plain and 9 policy blocks in each direction
PER_POLICY_TRAIN_STEP = {**NO_LAUNCHES, "fused_transformer_block": 3,
                         "fused_transformer_block[policy]": 9,
                         "fused_transformer_block_cls": 12,
                         "fused_transformer_block_backward": 3,
                         "fused_transformer_block_backward[policy]": 9, **norm_launches(12),
                         **core_launches(12)}
# the gumbel baseline's eval forward: 3 gathers, 12 plain blocks (its
# predictor has no kernel)
PER_GUMBEL_FORWARD = {**NO_LAUNCHES, "fused_transformer_block": 12, "fused_gather_tokens": 3}
# the int8 student's eval forward: every block int8
PER_INT8_FORWARD = {**NO_LAUNCHES, "fused_transformer_block_int8": 12, "fused_predictor_lg": 3,
                    "fused_gather_tokens": 3}
# an eval step: the teacher's 12 CLS-row blocks, the pruned forward, and the
# unpruned one (12 blocks, no gather; the LN predictors do not run)
PER_EVAL_STEP = {
    "topk": {**NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_transformer_block": 24,
             "fused_predictor_lg": 3, "fused_gather_tokens": 3},
    "int8": {**NO_LAUNCHES, "fused_transformer_block_cls": 12,
             "fused_transformer_block_int8": 24, "fused_predictor_lg": 3,
             "fused_gather_tokens": 3},
    "gumbel": {**NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_transformer_block": 24,
               "fused_gather_tokens": 3},
}
# a train step of the attn-selection student, which captures its own CLS
# rows: the teacher's 12 CLS-row blocks; the student's 12 blocks as packed
# attention with CLS rows and the MLP half, each way; 3 gathers and their 3
# scatters; no whole-block kernel and no predictor
PER_ATTN_TRAIN_STEP = {**NO_LAUNCHES, "fused_transformer_block_cls": 12,
                       "fused_attention_packed": 12, "fused_attention_backward_packed": 12,
                       "fused_mlp_residual": 12, "fused_mlp_residual_backward": 12,
                       "fused_gather_tokens": 3, "fused_scatter_tokens": 3,
                       **norm_launches(halves=12), **core_launches(12)}
# its eval forward: 12 CLS-row blocks, 3 gathers
PER_ATTN_FORWARD = {**NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_gather_tokens": 3}
ATTN_STAGE_FEEDERS = (2, 5, 8)  # the blocks whose CLS rows rank a stage's tokens
B_EVAL, EVAL_PADDING = 64, 8
EXPORT_BUCKETS = (1, 8, 32, 256)
EXPORT_BATCHES = (1, 5, 37, 256, 300)
SOURCES = {
    "fused_transformer_block": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:198"),
    "fused_transformer_block[policy]": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:88"),
    "fused_transformer_block_cls": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:285"),
    "fused_transformer_block_backward": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:729"),
    "fused_transformer_block_backward[policy]": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:484"),
    "fused_predictor_lg": (
        "dense2sparse_vit_torch/csrc/predictor.cu",
        "dense2sparse_vit_tpu/ops/pallas/predictor.py:242"),
    "fused_gather_tokens": (
        "dense2sparse_vit_torch/csrc/gather.cu",
        "dense2sparse_vit_tpu/ops/pallas/gather.py:121"),
    "fused_scatter_tokens": (
        "dense2sparse_vit_torch/csrc/gather.cu",
        "dense2sparse_vit_tpu/ops/pallas/gather.py:143"),
    "fused_transformer_block_int8": (
        "dense2sparse_vit_torch/csrc/quant_block.cu",
        "dense2sparse_vit_tpu/ops/pallas/quant.py:179"),
    "fused_attention_packed": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:171"),
    "fused_attention_backward_packed": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:554"),
    "fused_mlp_residual": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/mlp.py:93"),
    "fused_mlp_residual_backward": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/mlp.py:305"),
    "fused_transformer_block[scaled]": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:39"),
    "fused_transformer_block_backward[scaled]": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:408"),
    "attention_block_forward": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:1014"),
    "attention_block_backward": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:1354"),
    "attention_block_backward_policy": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:1655"),
    "attention_variant": (
        "dense2sparse_vit_torch/csrc/attn_variants.cu",
        "scripts/attn_variants.py:171"),
    "ln_bwd": (
        "dense2sparse_vit_torch/csrc/norm.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:663"),
    "column_sums": (
        "dense2sparse_vit_torch/csrc/norm.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:679"),
    "attention_bwd": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/attention.py:626"),
    "attention_hd": (
        "dense2sparse_vit_torch/csrc/block.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:226"),
    "attention_hd_bwd": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:753"),
    "attention_bwd[long]": (
        "dense2sparse_vit_torch/csrc/block_bwd.cu",
        "dense2sparse_vit_tpu/ops/pallas/block.py:729"),
    "fused_transformer_block_int8[4096]": (
        "dense2sparse_vit_torch/csrc/quant_block.cu",
        "dense2sparse_vit_tpu/ops/pallas/quant.py:179"),
}
# the H100 SXM's published peaks (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations
# the faults --plant-fault puts into a copy of a kernel source: (block_bwd.cu)
# rowsum(dO * O) dropped, (policy) dPolicy's diagonal kept, or (cls) the CLS
# fold's sum_j gcls_j P_0j left out of D_0; (quant_block.cu) fc2 dequantized
# with fc1's column scales; (ln_gemm.cuh) the DropPath branch scales ignored
# in the residual epilogue; (block_bwd.cu, attn_block) the attention
# half-block's dx without the residual cotangent g on row 0 of each sample;
# (attn_variants.cu) v2 recovering head b's scores as (S+ + S-) / 2, head a's;
# (block.cu, attn_core) pass 2 of the attention core stopping one 16-key block
# short of N; (gather.cu) the scatter leaving out each row's last source;
# (ln_gemm.cuh, gemm) the GEMM's consumers skipping the last K slice's
# products, (qgemm) the int8 ones alone; (norm.cu) the LayerNorm backward
# without z mean(dz z) (ln_bwd), the column sums without the last split's
# rows (colsum); (block_bwd.cu, attn_bwd) the attention core backward's dQ
# without the last key block's products; (predictor.cu) the means launch taking
# each sample's pooled mean from the next sample's sums; (block.cu,
# head_width) the core at other head widths leaving the last key block out of
# P.V; (block_bwd.cu, head_width_bwd) its backward leaving the last key block
# out of dQ; and the stage whose check must reject it
FAULTS = {
    "rowsum": ("block_bwd.cu", "    Ds[r] = acc;\n", "    Ds[r] = 0.f * acc;\n", "wqkv"),
    "policy": ("block_bwd.cu", "if (key != q) dpa[e & 1]", "if (true) dpa[e & 1]", "dpolicy"),
    "int8": ("quant_block.cu", "q.col_s = f(s2);  // fc2's column scales",
             "q.col_s = f(s1);  // fc2's column scales", "fc2_out"),
    "cls": ("block_bwd.cu", "      Ds[0] += s0;\n", "      Ds[0] += 0.f * s0;\n", "gcls_only"),
    "droppath": ("ln_gemm.cuh", "for (int j = 0; j < 8; ++j) v[j] *= sc;",
                 "for (int j = 0; j < 8; ++j) v[j] *= 1.f + 0.f * sc;", "mid"),
    "attn_block": ("block_bwd.cu", "  const bf16* res = gb;  // dx's residual term, g itself\n",
                   "  const bf16* res = s.dattn;\n"
                   "  cudaMemcpyAsync(s.dattn, gb, (size_t)M * C * sizeof(bf16),\n"
                   "                  cudaMemcpyDeviceToDevice, st);\n"
                   "  cudaMemset2DAsync(s.dattn, (size_t)N * C * sizeof(bf16), 0,\n"
                   "                    (size_t)C * sizeof(bf16), B, st);\n", "'dx'"),
    "variant": ("attn_variants.cu", "sd[j][e] = 0.5f * (sum - dif);  // head b's",
                "sd[j][e] = 0.5f * (sum + dif);  // head b's", "v2 "),
    "attn_core": ("block.cu", "k0 < np; k0 += 16", "k0 < np - 16; k0 += 16", "attn"),
    "scatter": ("gather.cu", "k <= last; ++k", "k < last; ++k", "scatter"),
    "gemm": ("ln_gemm.cuh", "const int mma_slices = slices;", "const int mma_slices = slices - 1;",
             "'qkv'"),
    "qgemm": ("ln_gemm.cuh", "wgmma_m64n128k32_s8(acc, ",
              "if (kb + 1 < slices) wgmma_m64n128k32_s8(acc, ", "'qkv'"),
    "ln_bwd": ("norm.cu", "rs * (dz - mdz - z * mdzz)", "rs * (dz - mdz)", "ln_bwd"),
    "colsum": ("norm.cu", "const int m1 = min(M, m0 + rows);",
               "const int m1 = blockIdx.y + 1 == gridDim.y ? m0 : min(M, m0 + rows);",
               "column_sums"),
    "attn_bwd": ("block_bwd.cu", "          wgmma_m64n64k16_rs<1>(dq[qq], da[c], ",
                 "          if (j + 1 < QB) wgmma_m64n64k16_rs<1>(dq[qq], da[c], ", "attn_bwd"),
    "head_width": ("block.cu", "HdMma<DP>::template rs<1>(o, pa[kk], ",
                   "if (j + 1 < nkb) HdMma<DP>::template rs<1>(o, pa[kk], ", "attn"),
    "head_width_bwd": ("block_bwd.cu", "                da[jq >> 1][2 * (jq & 1) + r];",
                       "                jb + 1 == nb ? 0u : da[jq >> 1][2 * (jq & 1) + r];",
                       "qkv.q"),
    "predictor": ("predictor.cu",
                  "  const int src = smp;  // the sample whose partial sums are added\n",
                  "  const int src = (smp + 1) % p.samples;  // the next sample's\n",
                  "predictor"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `iters` calls, CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Time per call of `iters` calls captured in one CUDA graph and replayed
    between CUDA events: the card's time without the host's launch cost,
    which events around a loop of small calls also take in."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(torch, graph.replay, iters=1) / iters


def paired_ms(torch, kernel_fn, plain_fn, iters: int, rounds: int = 2, repeats: int = 5):
    """Kernel and plain times, measured in turns: plain, kernel, kernel, plain."""
    k, p = [], []
    for _ in range(rounds):
        p.append(cuda_ms(torch, plain_fn, iters, repeats))
        k.append(cuda_ms(torch, kernel_fn, iters, repeats))
        k.append(cuda_ms(torch, kernel_fn, iters, repeats))
        p.append(cuda_ms(torch, plain_fn, iters, repeats))
    return statistics.median(k), statistics.median(p)


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) in fp32."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite values")
    return (got - want).abs().max().item(), want.abs().max().item()


def branch_excess(got, res, a, wt, b, s=None) -> float:
    """A residual stage got = res + s (a wt^T + b), the branch in fp32: the
    error beyond the one bf16 rounding of the sum, relative to the branch's
    largest magnitude."""
    branch = a.float() @ wt.float().t() + b
    if s is not None:
        branch = s.float()[:, None, None] * branch
    z = res.float() + branch
    excess = ((got.float() - z).abs() - BF16_U * z.abs()).clamp(min=0)
    return excess.max().item() / max(branch.abs().max().item(), 1e-30)


# ---- the least time the card could take: max(operations, bytes) ----------


def bound(flops: float, nbytes: float) -> dict:
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops_ms": ops_ms, "bytes_ms": bytes_ms}


def block_bound(B, N, C, H, hidden, cls=False) -> dict:
    """One block forward: the four projections and QK^T, PV; x read, out
    (and the CLS rows) written, the weights read once."""
    M = B * N
    flops = 2 * M * C * (4 * C + 2 * hidden) + 4 * B * H * N * N * (C // H)
    weights = 2 * (4 * C * C + 2 * C * hidden) + 4 * (8 * C + hidden)
    return bound(flops, 2 * M * C * 2 + weights + (B * H * N * 2 if cls else 0))


def block_backward_bound(B, N, C, H, hidden) -> dict:
    """dx and the 12 gradients from x and g alone: the forward up to fc1
    recomputed (three projections, QK^T, PV), then each projection's dX and
    dW and the attention core's dV, dP, dQ, dK; x and g read, dx written,
    the weights read, the fp32 gradients written."""
    M, hd = B * N, C // H
    flops = (2 * M * (4 * C * C + C * hidden) + 4 * B * H * N * N * hd
             + 4 * M * (4 * C * C + 2 * C * hidden) + 8 * B * H * N * N * hd)
    params = 4 * C * C + 2 * C * hidden
    vectors = 8 * C + hidden
    nbytes = 3 * M * C * 2 + 2 * params + 4 * vectors + 4 * (params + vectors)
    return bound(flops, nbytes)


def int8_block_bound(B, N, C, H, hidden) -> dict:
    """The int8 block: the four projections at the int8 rate, QK^T and PV
    at the bf16 rate; x read and out written (bf16), the int8 weights, their
    scales, the biases and LayerNorms read once."""
    M = B * N
    ops_ms = (2 * M * C * (4 * C + 2 * hidden) / INT8_OPS_PER_S
              + 4 * B * H * N * N * (C // H) / BF16_FLOPS_PER_S) * 1e3
    nbytes = 2 * M * C * 2 + (4 * C * C + 2 * C * hidden) + 4 * (2 * (4 * C + hidden) + 8 * C)
    return {"ops_ms": ops_ms, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def predictor_bound(B, N, D, w) -> dict:
    flops, c_in, weights = 0, D, 0
    for _, _, weight, _ in w["units"]:
        flops += 2 * B * N * c_in * weight.shape[0]
        weights += weight.numel() * 2
        c_in = weight.shape[0]
    return bound(flops + 2 * B * N * c_in, B * N * D * 2 + weights + B * N * 2)


def attention_bound(B, N, C, H, cls=False, policy=False) -> dict:
    """The packed attention core: QK^T and PV; qkv read, the output (and the
    CLS rows) written, the policy read."""
    flops = 4 * B * H * N * N * (C // H)
    nbytes = B * N * 3 * C * 2 + B * N * C * 2 + (B * H * N * 2 if cls else 0)
    return bound(flops, nbytes + (policy_bytes(B, N) if policy else 0))


def attention_backward_bound(B, N, C, H, gcls=False, policy=False) -> dict:
    """dqkv from qkv and g alone: the scores recomputed, then dP, dV, dQ and
    dK; qkv and g read (and the fp32 gcls, the policy), dqkv (and dPolicy)
    written."""
    flops = 10 * B * H * N * N * (C // H)
    nbytes = 2 * B * N * 3 * C * 2 + B * N * C * 2 + (B * H * N * 4 if gcls else 0)
    return bound(flops, nbytes + (2 * policy_bytes(B, N) if policy else 0))


def mlp_bound(B, N, C, hidden) -> dict:
    """The MLP half: fc1 and fc2; x read, out written, the weights read."""
    M = B * N
    return bound(4 * M * C * hidden, 2 * M * C * 2 + 2 * 2 * C * hidden + 4 * (3 * C + hidden))


def mlp_backward_bound(B, N, C, hidden) -> dict:
    """dx and the six gradients from x and g alone: fc1 recomputed, then dW2,
    dH, dW1 and dX; x and g read, dx written, the weights read, the fp32
    gradients written."""
    M = B * N
    vectors = 3 * C + hidden
    return bound(10 * M * C * hidden,
                 3 * M * C * 2 + 2 * 2 * C * hidden + 4 * vectors + 4 * (2 * C * hidden + vectors))


def rows_bound(B, K, D, out_rows, elt) -> dict:
    """A gather or a scatter: K rows read (or written), out_rows written, the
    indices read."""
    return bound(0, B * K * D * elt + B * out_rows * D * elt + B * K * 8)


class Tally:
    """Per kernel: main-path launches and, per main-path run, the kernel's,
    the plain version's, the library call's and the bound's milliseconds."""

    def __init__(self):
        self.rows = {n: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                         "library_ms": None, "ops_ms": 0.0, "bytes_ms": 0.0}
                     for n in KERNEL_NAMES + SUB_ROWS}

    def add(self, name, calls, k_ms, p_ms, b, lib_ms=None):
        r = self.rows[name]
        r["ms"] += calls * k_ms
        r["plain_ms"] += calls * p_ms
        r["ops_ms"] += calls * b["ops_ms"]
        r["bytes_ms"] += calls * b["bytes_ms"]
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + calls * lib_ms

    def err(self, name, e):
        self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"], e)

    def line(self):
        out = []
        for n in KERNEL_NAMES + SUB_ROWS:
            r = self.rows[n]
            by = "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes"
            out.append({
                "name": n, "route": "cuda", "source": SOURCES[n][0],
                "replaces": SOURCES[n][1], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": max(r["ops_ms"], r["bytes_ms"]), "bound_by": by,
                "library_ms": r["library_ms"],
            })
        return {"kernels": out}


# ---- the serving checks ----------------------------------------------------


def check_block(torch, x, w, num_heads, scale, ln_eps, block=None, policy=None, eps=1e-6,
                branch_scales=None, phase="check"):
    """Hold the block kernel against its plain version, stage by stage (in
    policy mode with a (B, N) keep `policy` and smoothing `eps`; with
    DropPath's (sa, sm) `branch_scales`, each residual branch scaled per
    sample).

    The block's output is x plus two branches, and at the init's weight
    scale the residual x is tens of times larger than the attention branch,
    so a wrong attention core would hide inside a tolerance on the output.
    Each stage of the kernel is compared with its plain version fed the
    kernel's own input to that stage:
      qkv, attn, hid: the LN1-qkv projection, the attention core and the
        GELU(fc1) activation, within STAGE_TOL;
      mid, out: x + sa proj(attn) and mid + sm fc2(hid), with the branch
        computed in fp32, within BRANCH_TOL once the one bf16 rounding of the
        sum is allowed for.
    The whole output is held against the plain block too (BLOCK_TOL). Prints
    the results, raises if a stage is out of tolerance, and returns the
    kernel's output and its max abs error.
    """
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import (
        attention_reference, layer_norm, linear, transformer_block_reference)

    y, st = ops.fused_transformer_block(
        x, w, num_heads, policy, scale=scale, eps=eps, ln_eps=ln_eps, stages=True,
        branch_scales=branch_scales)
    sa, sm = (None, None) if branch_scales is None else branch_scales
    h2 = layer_norm(st["mid"], w["ln2_w"], w["ln2_b"], ln_eps)
    pol = {} if policy is None else {"policy": policy, "eps": eps}
    plain = {
        "qkv": linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"]),
        "attn": attention_reference(st["qkv"], num_heads, scale, **pol),
        "hid": F.gelu(linear(h2, w["w1"], w["b1"]).float()).to(x.dtype),
    }
    rel = {}
    for name, want in plain.items():
        err, ref = rel_err(torch, st[name], want)
        rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
    residual = {"mid": (st["mid"], x, st["attn"], w["wproj"], w["bproj"], sa),
                "out": (y, st["mid"], st["hid"], w["w2"], w["b2"], sm)}
    for name, args in residual.items():
        rel[name] = (branch_excess(*args), BRANCH_TOL)
    err, ref = rel_err(torch, y, transformer_block_reference(
        x, w, num_heads, scale, ln_eps, branch_scales=branch_scales, **pol))
    rel["block"] = (err / ref, BLOCK_TOL)
    emit({"phase": phase, "kernel": block_kernel_name("fused_transformer_block", pol,
                                                     branch_scales),
          "block": block, **({"eps": eps} if pol else {}),
          "shape": list(x.shape), "max_abs_err": err, "max_abs_ref": ref,
          "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"block kernel out of tolerance: {bad}")
    return y, err


def check_unpruned(torch, model, plain, images) -> None:
    """The unpruned forward has no selection, so the kernel model and the
    plain one agree up to bf16 rounding: hold the logits against each other."""
    got = model(images, unpruned=True, collect_cls_attns=False).logits
    want = plain(images, unpruned=True, collect_cls_attns=False).logits
    err, scale = rel_err(torch, got, want)
    emit({"phase": "serve_vs_plain", "batch": images.shape[0], "unpruned": True,
          "max_abs_err": err, "max_abs_ref": scale, "tol_rel": LOGITS_TOL})
    if err > LOGITS_TOL * max(scale, 1e-3):
        raise AssertionError(f"unpruned logits: max err {err} vs scale {scale}")


# ---- the training checks --------------------------------------------------


def block_kernel_name(name, policy, branch_scales):
    """The counter a block launch counts in: with branch scales [scaled],
    else in policy mode [policy]."""
    if branch_scales is not None:
        return name + "[scaled]"
    return name + ("[policy]" if policy else "")


def check_block_backward(torch, x, g, w, num_heads, scale, ln_eps, block=None, policy=None,
                         eps=1e-6, branch_scales=None, phase="check_train"):
    """Hold the block-backward kernel against its plain version (autograd
    through the plain block) on the same x, g and weights (and in policy
    mode the (B, N) keep `policy`, smoothing `eps`; with `branch_scales`,
    DropPath's per-sample scales of the two branches): dx and each of the
    twelve gradients, and the thirds of the qkv weight's (q, k, v) and
    bias's (q, v) apart, within BWD_TOL of that tensor's largest magnitude;
    in policy mode dPolicy too, within DPOL_TOL. Prints the relative errors,
    raises naming every tensor out of tolerance, and returns the largest
    absolute error."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import transformer_block_backward_reference

    pol = {} if policy is None else {"policy": policy, "eps": eps}
    dx, dw, dpol = ops.fused_transformer_block_backward(
        x, g, w, num_heads, scale=scale, ln_eps=ln_eps, branch_scales=branch_scales, **pol)
    want = transformer_block_backward_reference(x, g, w, num_heads, scale, ln_eps,
                                                branch_scales=branch_scales, **pol)
    head = {"phase": phase,
            "kernel": block_kernel_name("fused_transformer_block_backward", pol, branch_scales),
            "block": block, **({"eps": eps} if pol else {}), "shape": list(x.shape)}
    return hold_gradients(torch, head, (dx, dw, dpol), want, "block backward")


def hold_gradients(torch, head, got, want, what):
    """The check of a backward kernel's (dx, {name: gradient}, dPolicy or
    None) against its plain version's: dx and each gradient, and the thirds
    of the qkv weight's (q, k, v) and bias's (q, v) apart, within BWD_TOL of
    that tensor's largest magnitude; dPolicy within DPOL_TOL. Prints `head`
    with the relative errors, raises naming every tensor out of tolerance
    (after `what`), and returns the largest absolute error."""
    (dx, dw, dpol), (want_dx, want_dw, want_dpol) = got, want
    pairs = {"dx": (dx, want_dx)}
    if want_dpol is not None:
        pairs["dpolicy"] = (dpol, want_dpol)
    for k in dw:
        if dw[k] is None:
            continue
        pairs[k] = (dw[k], want_dw[k])
        if k in ("wqkv", "bqkv"):
            # q, k and v apart too: the values' gradient is the largest, and
            # a fault in the scores' gradient (dQ, dK) would hide under it.
            # Not the key bias's: it is zero in exact arithmetic (softmax
            # ignores a shift of a row's scores), rounding noise on both sides
            for part, a, b in zip("qkv", dw[k].chunk(3), want_dw[k].chunk(3)):
                if k + part != "bqkvk":
                    pairs[f"{k}.{part}"] = (a, b)
    rel, worst = {}, 0.0
    for name, (a, b) in pairs.items():
        err, ref = rel_err(torch, a, b)
        rel[name] = err / max(ref, 1e-30)
        worst = max(worst, err)
    tol = {k: DPOL_TOL if k == "dpolicy" else BWD_TOL for k in rel}
    emit({**head, "rel_err": rel, "tol_rel": BWD_TOL,
          **({"dpolicy_tol_rel": DPOL_TOL} if want_dpol is not None else {})})
    bad = {k: r for k, r in rel.items() if not r <= tol[k]}
    if bad:
        raise AssertionError(f"{what} out of tolerance: {bad}")
    return worst


def build_trainer(torch, dev, fused: bool, mode: str = "topk"):
    """The headline student (mode "topk"; "threshold": the same in
    threshold mode; "attn": the same ranking by its own CLS rows, with no
    predictors; "gumbel": the gumbel baseline at the same widths and
    ratios, with the ratio and token-distillation losses on, as the JAX
    package's bench_train.py runs it) and its teacher, from seeded
    generators, with AdamW past the warmup and the train step:
    (student, teacher, step)."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import (
        ATTN_KWARGS, GUMBEL_KWARGS, GUMBEL_MODEL, HEADLINE_KWARGS, HEADLINE_MODEL,
        HEADLINE_TEACHER, THRESHOLD_KWARGS, create_model)
    from dense2sparse_vit_torch.train import (
        make_dynamic_vit_train_step, make_optimizer, make_train_step)

    name, kwargs, train = {
        "topk": (HEADLINE_MODEL, HEADLINE_KWARGS, TrainConfig()),
        "threshold": (HEADLINE_MODEL, THRESHOLD_KWARGS, TrainConfig()),
        "attn": (HEADLINE_MODEL, ATTN_KWARGS, TrainConfig()),
        "gumbel": (GUMBEL_MODEL, GUMBEL_KWARGS,
                   TrainConfig(use_ratio_loss=True, use_token_dist_loss=True)),
    }[mode]
    student = create_model(name, use_fused_attention=fused, device=dev,
                           generator=torch.Generator().manual_seed(0), **kwargs)
    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=fused, device=dev,
                           dtype="bfloat16", generator=torch.Generator().manual_seed(2))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=train)
    # the gumbel baseline trains its backbone from epoch 0 (JAX train/loop.py)
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH,
                         backbone_warmup_freeze=mode != "gumbel")
    opt.count = cfg.train.warmup_epochs * STEPS_PER_EPOCH
    if mode == "gumbel":
        noise = torch.Generator(device=dev).manual_seed(7)
        return student, teacher, make_dynamic_vit_train_step(student, teacher, opt, cfg,
                                                             generator=noise)
    return student, teacher, make_train_step(student, teacher, opt, cfg)


def train_batch(torch, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randn((B_TRAIN, 224, 224, 3), generator=gen, device=dev)
    labels = torch.randint(0, 1000, (B_TRAIN,), generator=gen, device=dev)
    return images, labels


def capture_train_step(torch, student, teacher, step, images, labels):
    """Run one more train step with hooks: every student block's input, keep
    policy (None for a plain block) and weights (before the update), the
    cotangent of the last block's output, every gather's input, indices and
    output cotangent, and every teacher block's input."""
    import dense2sparse_vit_torch.models.student as student_module

    bf16 = torch.bfloat16
    rec = {"block_in": {}, "policy": {}, "gathers": [], "teacher_in": {}, "last_g": None}
    with torch.no_grad():
        rec["weights"] = [{k: None if v is None else v.detach().clone()
                           for k, v in blk.kernel_weights(bf16).items()}
                          for blk in student.blocks]
        rec["teacher_weights"] = [blk.kernel_weights(bf16) for blk in teacher.blocks]
    handles = []
    def block_hook(m, args, i):
        rec["block_in"][i] = args[0].detach()
        policy = args[1] if len(args) > 1 else None
        rec["policy"][i] = None if policy is None else policy.detach().reshape(args[0].shape[:2])

    for i, blk in enumerate(student.blocks):
        handles.append(blk.register_forward_pre_hook(
            lambda m, args, i=i: block_hook(m, args, i)))
    for i, blk in enumerate(teacher.blocks):
        handles.append(blk.register_forward_pre_hook(
            lambda m, args, i=i: rec["teacher_in"].__setitem__(i, args[0].detach())))

    def last_hook(m, args, out):
        out = out[0] if isinstance(out, tuple) else out  # (x, cls rows) with CLS capture
        out.register_hook(lambda g: rec.__setitem__("last_g", g.detach()))

    handles.append(student.blocks[-1].register_forward_hook(last_hook))
    real_gather = student_module.fused_gather_tokens

    def gather_spy(x, idx):
        out = real_gather(x, idx)
        entry = {"x": x.detach(), "idx": idx}
        out.register_hook(lambda g: entry.__setitem__("g", g.detach()))
        rec["gathers"].append(entry)
        return out

    student_module.fused_gather_tokens = gather_spy
    try:
        step(images, labels, TRAIN_EPOCH)
        torch.cuda.synchronize()
    finally:
        student_module.fused_gather_tokens = real_gather
        for h in handles:
            h.remove()
    return rec


def check_block_backwards(torch, student, rec, tally=None, plain_blocks=True):
    """Kernel C at every student block's input: the real cotangent at the
    last block, a seeded one of the same scale at the others; a policy
    block with its step's policy, at every eps of EPS_CHECKS. With
    `plain_blocks` False, the policy blocks alone."""
    gen = torch.Generator(device=rec["last_g"].device).manual_seed(4)
    scale_g = rec["last_g"].float().std().item()
    for i, blk in enumerate(student.blocks):
        x, policy = rec["block_in"][i], rec["policy"][i]
        if i == len(student.blocks) - 1:
            g = rec["last_g"].contiguous()
        else:
            g = (torch.randn(x.shape, generator=gen, device=x.device) * scale_g).to(x.dtype)
        if policy is None and not plain_blocks:
            continue
        args = (rec["weights"][i], blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
        with torch.no_grad():
            if policy is None:
                err = check_block_backward(torch, x, g, *args, block=i)
            else:
                err = max(check_block_backward(torch, x, g, *args, block=i, policy=policy,
                                               eps=eps) for eps in EPS_CHECKS)
        if tally is not None:
            tally.err("fused_transformer_block_backward" + ("" if policy is None else "[policy]"),
                      err)


# phase 33's faults, planted in the port's Python for the run: (mode_plain)
# the dropout mode's attention core runs plain attention where the path
# takes the packed kernel; (remat) remat's recompute draws anew, the
# generator left where the forward left it; (bn_eval) an eval-mode
# BatchNorm normalises with the batch's statistics; and the word the
# rejecting check's message holds
MODE_FAULTS = {"mode_plain": "launches", "remat": "remat gradients", "bn_eval": "bn_eval"}


def mode_fault(kind: str):
    """(object, attribute, replacement) that plants MODE_FAULTS' `kind`,
    and the mode of phase 33 it reaches."""
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    import dense2sparse_vit_torch.nn.layers as layers
    import dense2sparse_vit_torch.nn.predictor as predictor
    import dense2sparse_vit_torch.train.train_step as train_step
    from dense2sparse_vit_torch.ops.block import attention_reference

    def plain_core(qkv, num_heads, policy, scale):
        return attention_reference(qkv, num_heads, scale, policy=policy)

    def redraw(run, generator, *args):
        return checkpoint(run, *args, use_reentrant=False)

    real_bn = predictor.BatchNormLayer.forward

    def batch_stats_forward(self, x):  # in eval mode alone
        if self.training:
            return real_bn(self, x)
        bn = self.bn
        y = F.batch_norm(x.float().reshape(-1, x.shape[-1]), bn.running_mean.clone(),
                         bn.running_var.clone(), bn.weight, bn.bias, training=True,
                         momentum=bn.momentum, eps=bn.eps)
        return y.view(x.shape).to(x.dtype)

    return {"mode_plain": (layers, "fused_attention_packed_trainable", plain_core, "dropout"),
            "remat": (train_step, "remat_forward", redraw, "remat"),
            "bn_eval": (predictor.BatchNormLayer, "forward", batch_stats_forward,
                        "predictor_bn")}[kind]


def plant_mode_fault(torch, dev, kind: str) -> int:
    """Run phase 33's mode that the fault `kind` of MODE_FAULTS reaches with
    the fault planted, and report whether a check rejected it."""
    from dense2sparse_vit_torch.models import HEADLINE_TEACHER, create_model

    obj, attr, replacement, mode = mode_fault(kind)
    saved = getattr(obj, attr)
    setattr(obj, attr, replacement)
    teachers = {fused: create_model(HEADLINE_TEACHER, use_fused_attention=fused, device=dev,
                                    dtype="bfloat16", generator=torch.Generator().manual_seed(2))
                for fused in (True, False)}
    try:
        run_mode(torch, dev, mode, teachers, Tally(), "")
    except AssertionError as e:
        rejected = MODE_FAULTS[kind] in str(e)
        emit({"phase": "plant_fault", "fault": kind, "rejected": rejected,
              "message": str(e)[:400]})
        return 0 if rejected else 1
    finally:
        setattr(obj, attr, saved)
    emit({"phase": "plant_fault", "fault": kind, "rejected": False})
    return 1


def plant_fault(dev, kind: str) -> int:
    """Build the kernels with the fault `kind` of FAULTS, run the
    block-backward check on a train step's activations (for "policy" the
    gumbel baseline's policy blocks), and report whether it rejected the
    fault on the tensor the fault reaches. A kind of MODE_FAULTS is
    planted in the port's Python instead (`plant_mode_fault`)."""
    import torch
    from pathlib import Path

    from dense2sparse_vit_torch.ops import _cuda

    if kind in MODE_FAULTS:
        _cuda.library()
        return plant_mode_fault(torch, dev, kind)

    source, pattern, replacement, reaches = FAULTS[kind]
    faulty = _cuda.BUILD_DIR / "fault_csrc"
    shutil.rmtree(faulty, ignore_errors=True)
    shutil.copytree(_cuda.CSRC, faulty)
    src = Path(faulty) / source
    text = src.read_text()
    if text.count(pattern) != 1:
        raise AssertionError(f"the fault's pattern is not in {source} once")
    src.write_text(text.replace(pattern, replacement))
    _cuda.CSRC = faulty
    _cuda.library()
    try:
        if kind in ("int8", "qgemm"):
            model = build_int8_student(torch, dev)
            images = torch.randn((64, 224, 224, 3), device=dev, dtype=torch.bfloat16,
                                 generator=torch.Generator(device=dev).manual_seed(13))
            with torch.inference_mode():
                walk_int8(torch, model, images)
        elif kind == "droppath":
            student, teacher, step = build_t2t_trainer(torch, dev, fused=True)
            images, labels = train_batch(torch, dev)
            rec = capture_train_step(torch, student, teacher, step, images, labels)
            check_droppath(torch, dev, student, rec)
        elif kind == "attn_block":
            inputs, _, (H, scale, ln_eps) = capture_half_blocks(torch, dev)
            with torch.no_grad():
                for n, (i, x256, w6) in inputs.items():
                    x = x256[:B_TRAIN].contiguous()
                    check_attn_half_backward(torch, x, half_block_grad(torch, x, dev, 41 + i),
                                             w6, H, scale, ln_eps, block=i)
        elif kind == "variant":
            phase_attn_variants(torch, dev, None, None)
        elif kind in ("attn_core", "gemm", "predictor"):
            model, plain, images, outputs = phase_serve(torch, dev, Tally())
            phase_check(torch, model, plain, images, outputs, Tally())
        elif kind in ("ln_bwd", "colsum"):
            cases = capture_norm_cases(torch, dev)
            with torch.no_grad():
                check_norm(torch, cases)
        elif kind == "attn_bwd":
            check_attn_bwd_cases(torch, capture_attn_bwd_cases(torch, dev))
        elif kind in ("head_width", "head_width_bwd"):
            check_head_widths(torch, dev, None, widths=HD_WIDTHS[:1], tokens=(197,))
        elif kind == "scatter":
            student, teacher, step = build_trainer(torch, dev, fused=True)
            images, labels = train_batch(torch, dev)
            check_scatters(torch, capture_train_step(torch, student, teacher, step, images,
                                                     labels))
        elif kind == "cls":
            student, teacher, step = build_trainer(torch, dev, fused=True, mode="attn")
            images, labels = train_batch(torch, dev)
            rec = capture_attn_step(torch, step, images, labels)
            for i in ATTN_STAGE_FEEDERS:
                check_attn_block(torch, rec["attn"][i], rec["mlp"][i], block=i)
        else:
            mode = "gumbel" if kind == "policy" else "topk"
            student, teacher, step = build_trainer(torch, dev, fused=True, mode=mode)
            images, labels = train_batch(torch, dev)
            rec = capture_train_step(torch, student, teacher, step, images, labels)
            check_block_backwards(torch, student, rec, plain_blocks=kind != "policy")
    except AssertionError as e:
        rejected = reaches in str(e)
        emit({"phase": "plant_fault", "fault": kind, "rejected": rejected,
              "message": str(e)[:400]})
        return 0 if rejected else 1
    emit({"phase": "plant_fault", "fault": kind, "rejected": False})
    return 1


# ---- phases ----------------------------------------------------------------


def phase_serve(torch, dev, tally):
    """Phase 2; returns (model, plain, images, outputs)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, create_model

    gen = torch.Generator(device=dev).manual_seed(1)
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0),
                         **HEADLINE_KWARGS).eval()
    plain = create_model(HEADLINE_MODEL, use_fused_attention=False, device=dev,
                         **HEADLINE_KWARGS).eval()
    plain.load_state_dict(model.state_dict())
    N = model.cfg.num_patches
    C = model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    images = {b: torch.randn((b, 224, 224, 3), generator=gen, device=dev,
                             dtype=torch.bfloat16) for b in SERVE_BATCHES}
    outputs = {}
    with torch.inference_mode():
        ops.reset_launch_counts()
        for b in SERVE_BATCHES:
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = model(images[b], collect_cls_attns=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            delta = {k: v - before[k] for k, v in ops.launch_counts().items()}
            if delta != PER_FORWARD:
                raise AssertionError(f"B={b}: launches {delta}, expected {PER_FORWARD}")
            shapes_ok = (
                out.logits.shape == (b, 1000)
                and out.features.shape == (b, keep[-1], C)
                and [t.shape[1] for t in out.pred_logits] == [N, keep[0], keep[1]]
                and int(out.kept_idx_orig.max()) < N
                and bool(torch.isfinite(out.logits.float()).all())
                and bool(torch.isfinite(out.features.float()).all())
            )
            if not shapes_ok:
                raise AssertionError(f"B={b}: bad outputs {out.logits.shape} "
                                     f"{out.features.shape}")
            outputs[b] = out
            emit({"phase": "serve", "batch": b, "launches": delta,
                  "logits": list(out.logits.shape),
                  "features": list(out.features.shape),
                  "pred_logits": [t.shape[1] for t in out.pred_logits],
                  "first_call_s": round(seconds, 4)})
        for k, v in ops.launch_counts().items():
            tally.rows[k]["launches"] += v
    return model, plain, images, outputs


def check_predictor(torch, xs, w, what, phase):
    """Hold `ops.fused_predictor_lg` on spatial tokens xs against its plain
    version and the plain split form it computes, both within STAGE_TOL of
    the plain version's largest score, and a second launch bit-equal; print
    the errors, raise naming the predictor where one fails, and return
    (scores, largest absolute error)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.predictor import (
        predictor_lg_reference, predictor_lg_split_reference)

    got = ops.fused_predictor_lg(xs, w)
    same = bool(torch.equal(got, ops.fused_predictor_lg(xs, w)))
    err, scale = rel_err(torch, got, predictor_lg_reference(xs, w))
    split_err, _ = rel_err(torch, got, predictor_lg_split_reference(xs, w))
    emit({"phase": phase, "kernel": "fused_predictor_lg", "case": what,
          "shape": list(xs.shape), "act": w["act"], "max_abs_err": err,
          "split_max_abs_err": split_err, "max_abs_ref": scale, "tol_rel": STAGE_TOL,
          "bit_equal": same})
    if not (err <= STAGE_TOL * scale and split_err <= STAGE_TOL * scale and same):
        raise AssertionError(f"predictor {what}: err {err}, split form {split_err}, scale "
                             f"{scale}; two launches bit-equal: {same}")
    return got, max(err, split_err)


def phase_check(torch, model, plain, images, outputs, tally, b=B_CHECK, phase="check"):
    """Phase 3 (and serve_t2t's walk at `b`); returns the shapes phase 4
    times."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.gather import gather_tokens_reference
    from dense2sparse_vit_torch.ops.topk import topk_keep_indices

    bf16 = torch.bfloat16
    keep = model.pruning.keep_counts(model.cfg.num_patches)
    block_shapes, pred_shapes, gather_shapes = [], [], []
    with torch.inference_mode():
        x = model.embed(images[b])
        p = 0
        for i, blk in enumerate(model.blocks):
            if i in model.pruning.pruning_locs:
                w = model.score_predictor[p].kernel_weights(bf16)
                xs = x[:, 1:]
                s_k, err = check_predictor(torch, xs, w, f"stage {p}", phase)
                tally.err("fused_predictor_lg", err)
                pred_shapes.append((xs, w))
                probs = torch.softmax(s_k.float(), dim=-1).to(bf16)
                kept, _ = topk_keep_indices(probs, keep[p])
                idx = torch.cat([kept.new_zeros(b, 1), kept + 1], dim=1)
                g_k = ops.fused_gather_tokens(x, idx)
                g_p = gather_tokens_reference(x, idx)
                if not torch.equal(g_k, g_p):
                    raise AssertionError(f"gather stage {p}: not bit-equal")
                gather_shapes.append((x, idx))
                emit({"phase": phase, "kernel": "fused_gather_tokens",
                      "shape": list(x.shape), "k": idx.shape[1],
                      "bit_equal": True})
                x = g_k
                p += 1
            w = blk.kernel_weights(bf16)
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            y, err = check_block(torch, x, w, *args, block=i, phase=phase)
            tally.err("fused_transformer_block", err)
            if not block_shapes or block_shapes[-1][0].shape != x.shape:
                block_shapes.append((x, w, args))
            x = y
        # the walk ran the same kernels on the same inputs as the forward
        logits = model.head(model.norm(x)[:, 0])
        if not torch.equal(logits, outputs[b].logits):
            raise AssertionError("stage walk and model forward disagree")
        emit({"phase": phase, "walk_equals_forward": True})
        # the whole model against the plain one, where no selection can differ
        check_unpruned(torch, model, plain, images[8])
    return block_shapes, pred_shapes, gather_shapes


def phase_time(torch, model, plain, images, shapes, tally, smi):
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import transformer_block_reference
    from dense2sparse_vit_torch.ops.gather import gather_tokens_reference
    from dense2sparse_vit_torch.ops.predictor import predictor_lg_reference

    block_shapes, pred_shapes, gather_shapes = shapes
    hidden = model.blocks[0].mlp.fc1.out_features
    with torch.inference_mode():
        for x, w, args in block_shapes:  # 3 blocks at each width
            k_ms, p_ms = paired_ms(
                torch,
                lambda: ops.fused_transformer_block(x, w, args[0], scale=args[1], ln_eps=args[2]),
                lambda: transformer_block_reference(x, w, *args), iters=10)
            b = block_bound(*x.shape, args[0], hidden)
            tally.add("fused_transformer_block", 3, k_ms, p_ms, b)
            emit({"phase": "time", "kernel": "fused_transformer_block",
                  "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": max(b.values())})
        for xs, w in pred_shapes:  # the kernels line takes phase 31's device times
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_predictor_lg(xs, w),
                lambda: predictor_lg_reference(xs, w), iters=10)
            b = predictor_bound(*xs.shape, w)
            emit({"phase": "time", "kernel": "fused_predictor_lg",
                  "shape": list(xs.shape), "ms": k_ms, "plain_ms": p_ms,
                  "graph_ms": graph_ms(torch, lambda: ops.fused_predictor_lg(xs, w)),
                  "bound_ms": max(b.values())})
        for x, idx in gather_shapes:
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_gather_tokens(x, idx),
                lambda: gather_tokens_reference(x, idx), iters=20)
            # one torch call for the same function: the indices are in range
            full = idx[..., None].expand(-1, -1, x.shape[2])
            lib_ms = cuda_ms(torch, lambda: torch.gather(x, 1, full), iters=20)
            b = rows_bound(x.shape[0], idx.shape[1], x.shape[2], idx.shape[1], 2)
            tally.add("fused_gather_tokens", 1, k_ms, p_ms, b, lib_ms)
            emit({"phase": "time", "kernel": "fused_gather_tokens",
                  "shape": list(x.shape), "k": idx.shape[1],
                  "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                  "bound_ms": max(b.values()),
                  "graph_ms": graph_ms(torch, lambda: ops.fused_gather_tokens(x, idx)),
                  "library_graph_ms": graph_ms(torch, lambda: torch.gather(x, 1, full))})
        imgs = images[B_CHECK]
        f_ms, p_ms = paired_ms(torch, lambda: model(imgs, collect_cls_attns=False),
                               lambda: plain(imgs, collect_cls_attns=False), iters=5)
        emit({"phase": "time", "forward": "B=256 pruned student",
              "kernels_ms": f_ms, "plain_ms": p_ms,
              "kernels_img_per_s": B_CHECK / f_ms * 1e3,
              "plain_img_per_s": B_CHECK / p_ms * 1e3, "card": smi})


def phase_train(torch, dev, tally, mode="topk"):
    """Phase 5 (mode "attn": phase 17); returns (student, teacher, step,
    images, labels)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.train import label_params

    phase, per_step = {"topk": ("train", PER_TRAIN_STEP),
                       "attn": ("train_attn", PER_ATTN_TRAIN_STEP)}[mode]
    student, teacher, step = build_trainer(torch, dev, fused=True, mode=mode)
    images, labels = train_batch(torch, dev)
    groups = label_params(student)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    for s in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(images, labels, TRAIN_EPOCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != per_step:
            raise AssertionError(f"{phase} step {s}: launches {counts}, expected {per_step}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        values = {k: v.item() for k, v in metrics.items()}
        bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"{phase} step {s}: non-finite metrics {bad}")
        emit({"phase": phase, "step": s, "batch": B_TRAIN, "epoch": TRAIN_EPOCH,
              "launches": counts, "metrics": values, "seconds": round(seconds, 4)})
    moved = {n: not torch.equal(p, before[n]) for n, p in student.named_parameters()}
    stuck = [n for n, m in moved.items() if groups[n] != "frozen" and not m]
    drifted = [n for n, m in moved.items() if groups[n] == "frozen" and m]
    emit({"phase": phase, "trained_tensors": sum(groups[n] != "frozen" for n in moved),
          "unchanged": stuck, "frozen_changed": drifted})
    if stuck or drifted:
        raise AssertionError(f"parameters not updated: {stuck}; frozen but changed: {drifted}")
    return student, teacher, step, images, labels


def phase_check_train(torch, student, teacher, step, images, labels, tally):
    """Phase 6; returns the recorded activations for phase 7."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import transformer_block_reference

    rec = capture_train_step(torch, student, teacher, step, images, labels)
    check_block_backwards(torch, student, rec, tally)
    check_scatters(torch, rec)
    with torch.no_grad():
        for i, blk in enumerate(teacher.blocks):
            x, w = rec["teacher_in"][i], rec["teacher_weights"][i]
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            out, cls = ops.fused_transformer_block_cls(x, w, args[0], scale=args[1],
                                                       ln_eps=args[2])
            want_out, want_cls = transformer_block_reference(x, w, *args, return_cls=True)
            err, ref = rel_err(torch, cls, want_cls)
            out_err, out_ref = rel_err(torch, out, want_out)
            rowsum = (cls.float().sum(-1) - 1).abs().max().item()
            emit({"phase": "check_train", "kernel": "fused_transformer_block_cls",
                  "block": i, "shape": list(x.shape), "cls_rel_err": err / ref,
                  "out_rel_err": out_err / out_ref, "rowsum_err": rowsum,
                  "tol_rel": STAGE_TOL, "rowsum_tol": ROWSUM_TOL})
            if err > STAGE_TOL * ref or out_err > BLOCK_TOL * out_ref or rowsum > ROWSUM_TOL:
                raise AssertionError(f"teacher block {i}: CLS rows out of tolerance")
            tally.err("fused_transformer_block_cls", err)
    return rec


def check_scatters(torch, rec):
    """The scatter at every stage of a recorded train step, on that step's
    cotangents and kept indices, bit-equal to its plain version."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.gather import scatter_tokens_reference

    with torch.no_grad():
        for p, entry in enumerate(rec["gathers"]):
            n = entry["x"].shape[1]
            got = ops.fused_scatter_tokens(entry["g"], entry["idx"], n)
            if not torch.equal(got, scatter_tokens_reference(entry["g"], entry["idx"], n)):
                raise AssertionError(f"scatter stage {p}: not bit-equal")
            emit({"phase": "check_train", "kernel": "fused_scatter_tokens",
                  "shape": list(entry["g"].shape), "n": n, "bit_equal": True})


def phase_time_train(torch, dev, student, rec, tally, smi):
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import (
        transformer_block_backward_reference, transformer_block_reference)
    from dense2sparse_vit_torch.ops.gather import scatter_tokens_reference

    hidden = student.blocks[0].mlp.fc1.out_features
    gen = torch.Generator(device=dev).manual_seed(5)
    scale_g = rec["last_g"].float().std().item()
    with torch.no_grad():
        widths = {}
        for i, x in rec["block_in"].items():
            widths.setdefault(x.shape[1], []).append(i)
        for n, idxs in widths.items():
            i = idxs[0]
            x, w, blk = rec["block_in"][i], rec["weights"][i], student.blocks[i]
            g = rec["last_g"] if i == len(student.blocks) - 1 else (
                torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            k_ms, p_ms = paired_ms(
                torch,
                lambda: ops.fused_transformer_block_backward(
                    x, g, w, args[0], scale=args[1], ln_eps=args[2]),
                lambda: transformer_block_backward_reference(x, g, w, *args),
                iters=3, repeats=3)
            b = block_backward_bound(*x.shape, args[0], hidden)
            tally.add("fused_transformer_block_backward", len(idxs), k_ms, p_ms, b)
            emit({"phase": "time_train", "kernel": "fused_transformer_block_backward",
                  "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": max(b.values()), "calls_per_step": len(idxs)})
        x, w = rec["teacher_in"][0], rec["teacher_weights"][0]
        blk = student.blocks[0]
        args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
        k_ms, p_ms = paired_ms(
            torch,
            lambda: ops.fused_transformer_block_cls(x, w, args[0], scale=args[1],
                                                    ln_eps=args[2]),
            lambda: transformer_block_reference(x, w, *args, return_cls=True),
            iters=5, repeats=3)
        b = block_bound(*x.shape, args[0], hidden, cls=True)
        tally.add("fused_transformer_block_cls", len(rec["teacher_in"]), k_ms, p_ms, b)
        emit({"phase": "time_train", "kernel": "fused_transformer_block_cls",
              "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
              "bound_ms": max(b.values()), "calls_per_step": len(rec["teacher_in"])})
        for entry in rec["gathers"]:
            x, idx = entry["x"], entry["idx"]
            full = idx[..., None].expand(-1, -1, x.shape[2])
            emit({"phase": "time_train", "kernel": "fused_gather_tokens",
                  "shape": list(x.shape), "k": idx.shape[1],
                  "graph_ms": graph_ms(torch, lambda: ops.fused_gather_tokens(x, idx)),
                  "library_graph_ms": graph_ms(torch, lambda: torch.gather(x, 1, full))})
            g, idx, n = entry["g"], entry["idx"], entry["x"].shape[1]
            B, K, D = g.shape
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_scatter_tokens(g, idx, n),
                lambda: scatter_tokens_reference(g, idx, n), iters=20)
            # one torch call for the same function: index_add_ into zero rows
            rows = (idx + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
            buf = torch.zeros((B * n, D), dtype=g.dtype, device=dev)
            flat = g.reshape(B * K, D)
            lib_ms = cuda_ms(torch, lambda: buf.index_add_(0, rows, flat), iters=20)
            b = rows_bound(B, K, D, n, g.element_size())
            tally.add("fused_scatter_tokens", 1, k_ms, p_ms, b, lib_ms)
            emit({"phase": "time_train", "kernel": "fused_scatter_tokens",
                  "shape": list(g.shape), "n": n, "ms": k_ms, "plain_ms": p_ms,
                  "library_ms": lib_ms, "bound_ms": max(b.values()),
                  "graph_ms": graph_ms(torch, lambda: ops.fused_scatter_tokens(g, idx, n)),
                  "library_graph_ms": graph_ms(torch, lambda: buf.index_add_(0, rows, flat))})

    # the whole train step, with the kernels and without, on the same weights
    f_student, f_teacher, f_step = build_trainer(torch, dev, fused=True)
    p_student, p_teacher, p_step = build_trainer(torch, dev, fused=False)
    p_student.load_state_dict(f_student.state_dict())
    p_teacher.load_state_dict(f_teacher.state_dict())
    images, labels = train_batch(torch, dev)
    f_ms, p_ms = paired_ms(torch, lambda: f_step(images, labels, TRAIN_EPOCH),
                           lambda: p_step(images, labels, TRAIN_EPOCH), iters=2, repeats=3)
    emit({"phase": "time_train", "train_step": f"B={B_TRAIN} headline student + teacher",
          "kernels_ms": f_ms, "plain_ms": p_ms,
          "kernels_img_per_s": B_TRAIN / f_ms * 1e3,
          "plain_img_per_s": B_TRAIN / p_ms * 1e3, "card": smi})


# ---- the policy-masked paths: threshold pruning and the gumbel baseline ----


def policy_bytes(B, N) -> int:
    """The keep policy read (fp32), for a policy block's bound."""
    return B * N * 4


def phase_serve_threshold(torch, dev, tally, smi):
    """Phase 8: serve, walk and time the threshold-mode student."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import HEADLINE_MODEL, THRESHOLD_KWARGS, create_model
    from dense2sparse_vit_torch.ops.block import transformer_block_reference
    from dense2sparse_vit_torch.ops.topk import threshold_keep_mask

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **THRESHOLD_KWARGS).eval()
    plain = create_model(HEADLINE_MODEL, use_fused_attention=False, device=dev,
                         **THRESHOLD_KWARGS).eval()
    plain.load_state_dict(model.state_dict())
    N, C = model.cfg.num_patches, model.cfg.embed_dim
    threshold = model.pruning.patch_score_threshold
    images = {b: torch.randn((b, 224, 224, 3), generator=gen, device=dev, dtype=bf16)
              for b in SERVE_BATCHES}
    outputs = {}
    with torch.inference_mode():
        for b in SERVE_BATCHES:
            ops.reset_launch_counts()
            out = model(images[b], collect_cls_attns=False)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if counts != PER_THRESHOLD_FORWARD:
                raise AssertionError(f"threshold B={b}: launches {counts}, "
                                     f"expected {PER_THRESHOLD_FORWARD}")
            ratios = out.keep_ratios.float()
            ok = (out.logits.shape == (b, 1000) and out.features.shape == (b, N, C)
                  and [t.shape[1] for t in out.pred_logits] == [N] * 3
                  and len(out.keep_masks) == 3
                  and bool(torch.isfinite(out.logits.float()).all())
                  and bool(torch.isfinite(out.features.float()).all())
                  and bool(((ratios > 0) & (ratios <= 1)).all()))
            if not ok:
                raise AssertionError(f"threshold B={b}: bad outputs {out.logits.shape} "
                                     f"{out.features.shape} keep ratios {ratios.tolist()[:8]}")
            for k, v in counts.items():
                tally.rows[k]["launches"] += v
            outputs[b] = out
            emit({"phase": "serve_threshold", "batch": b, "launches": counts,
                  "features": list(out.features.shape),
                  "keep_ratio_mean": ratios.mean().item(),
                  "keep_ratio_min": ratios.min().item(),
                  "keep_ratio_max": ratios.max().item()})

        # the walk: each stage's predictor and mask, each block against its
        # plain version, the policy blocks at each eps of EPS_CHECKS
        x = model.embed(images[B_CHECK])
        policy, p, first_policy = None, 0, None
        for i, blk in enumerate(model.blocks):
            if i in model.pruning.pruning_locs:
                w = model.score_predictor[p].kernel_weights(bf16)
                s_k, err = check_predictor(torch, x[:, 1:], w, f"threshold stage {p}",
                                           "serve_threshold")
                tally.err("fused_predictor_lg", err)
                probs = torch.softmax(s_k.float(), dim=-1).to(bf16)
                mask, _ = threshold_keep_mask(probs, threshold)
                policy = torch.cat([mask.new_ones(B_CHECK, 1), mask], dim=1)
                p += 1
            w = blk.kernel_weights(bf16)
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            if policy is None:
                y, err = check_block(torch, x, w, *args, block=i)
                tally.err("fused_transformer_block", err)
            else:
                for eps in EPS_CHECKS:
                    out_eps, err = check_block(torch, x, w, *args, block=i, policy=policy, eps=eps)
                    tally.err("fused_transformer_block[policy]", err)
                    if eps == 1e-6:
                        y = out_eps
                if first_policy is None:
                    first_policy = (x, w, args, policy)
            x = y
        logits = model.head(model.norm(x)[:, 0])
        if not torch.equal(logits, outputs[B_CHECK].logits):
            raise AssertionError("threshold stage walk and model forward disagree")
        emit({"phase": "check", "threshold_walk_equals_forward": True})

        # time the policy block against its plain version and the plain-mode
        # kernel on the same input, and the whole forward
        x, w, args, policy = first_policy
        hidden = model.blocks[0].mlp.fc1.out_features
        k_ms, p_ms = paired_ms(
            torch, lambda: ops.fused_transformer_block(x, w, args[0], policy, scale=args[1],
                                                       ln_eps=args[2]),
            lambda: transformer_block_reference(x, w, *args, policy=policy), iters=10)
        plain_mode_ms = cuda_ms(torch, lambda: ops.fused_transformer_block(
            x, w, args[0], scale=args[1], ln_eps=args[2]), iters=10)
        b = block_bound(*x.shape, args[0], hidden)
        b["bytes_ms"] += policy_bytes(*x.shape[:2]) / HBM_BYTES_PER_S * 1e3
        tally.add("fused_transformer_block[policy]", 9, k_ms, p_ms, b)
        emit({"phase": "time_threshold", "kernel": "fused_transformer_block[policy]",
              "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
              "plain_mode_kernel_ms": plain_mode_ms, "bound_ms": max(b.values()),
              "calls_per_forward": 9})
        imgs = images[B_CHECK]
        f_ms, p_ms = paired_ms(torch, lambda: model(imgs, collect_cls_attns=False),
                               lambda: plain(imgs, collect_cls_attns=False), iters=5)
        emit({"phase": "time_threshold", "forward": "B=256 threshold student",
              "kernels_ms": f_ms, "plain_ms": p_ms,
              "kernels_img_per_s": B_CHECK / f_ms * 1e3,
              "plain_img_per_s": B_CHECK / p_ms * 1e3, "card": smi})


def planted_ties(torch, x, w, num_heads, scale, ln_eps):
    """x with the token that is most often a row's argmax copied into five
    other positions, so that those rows reach their max at six columns with
    bit-equal keys, and how many (sample, head, query) rows then have their
    max in that group (in exact arithmetic, each such row ties six ways)."""
    from dense2sparse_vit_torch.ops.block import layer_norm, linear

    def scores(xx):
        qkv = linear(layer_norm(xx, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"])
        B, N, C3 = qkv.shape
        q, k, _ = qkv.view(B, N, 3, num_heads, C3 // 3 // num_heads).permute(
            2, 0, 3, 1, 4).unbind(0)
        return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale

    s = scores(x)
    top = int(torch.mode(s.argmax(-1)[:, :, 1:].flatten()).values)
    others = [j for j in range(1, x.shape[1]) if j != top][:5]
    x = x.clone()
    x[:, others] = x[:, top:top + 1]
    group = torch.tensor([top] + others, device=x.device)
    return x, int(torch.isin(scores(x).argmax(-1), group).sum())


def phase_train_policy(torch, dev, tally, smi, mode):
    """Phases 9 and 10: three steps of the threshold student or the gumbel
    baseline, the block backward checked at every block of a step, the
    policy backward and the step timed."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import transformer_block_backward_reference
    from dense2sparse_vit_torch.train import label_params

    phase = f"train_{mode}"
    student, teacher, step = build_trainer(torch, dev, fused=True, mode=mode)
    images, labels = train_batch(torch, dev)
    groups = label_params(student)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    for s in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(images, labels, TRAIN_EPOCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != PER_POLICY_TRAIN_STEP:
            raise AssertionError(f"{phase} step {s}: launches {counts}, "
                                 f"expected {PER_POLICY_TRAIN_STEP}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        values = {k: v.item() for k, v in metrics.items()}
        bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"{phase} step {s}: non-finite metrics {bad}")
        emit({"phase": phase, "step": s, "batch": B_TRAIN, "epoch": TRAIN_EPOCH,
              "launches": counts, "metrics": values, "seconds": round(seconds, 4)})
    moved = {n: not torch.equal(p, before[n]) for n, p in student.named_parameters()}
    stuck = [n for n, m in moved.items() if groups[n] != "frozen" and not m]
    drifted = [n for n, m in moved.items() if groups[n] == "frozen" and m]
    predictors = [n for n in moved if groups[n] == "predictor"]
    emit({"phase": phase, "trained_tensors": sum(groups[n] != "frozen" for n in moved),
          "predictor_tensors_moved": sum(moved[n] for n in predictors),
          "predictor_tensors": len(predictors), "unchanged": stuck, "frozen_changed": drifted})
    if stuck or drifted or not predictors:
        raise AssertionError(f"{phase}: parameters not updated: {stuck}; "
                             f"frozen but changed: {drifted}")

    rec = capture_train_step(torch, student, teacher, step, images, labels)
    check_block_backwards(torch, student, rec, tally)
    first = min(i for i, pol in rec["policy"].items() if pol is not None)
    x, policy, w = rec["block_in"][first], rec["policy"][first], rec["weights"][first]
    blk = student.blocks[first]
    args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
    gen = torch.Generator(device=dev).manual_seed(6)
    g = (torch.randn(x.shape, generator=gen, device=dev)
         * rec["last_g"].float().std().item()).to(x.dtype)
    with torch.no_grad():
        if mode == "gumbel":
            x_tie, ties = planted_ties(torch, x, w, *args)
            emit({"phase": phase, "planted_ties": {"block": first, "tied_rows": ties}})
            if ties == 0:
                raise AssertionError("the planted ties reach no row's max")
            check_block_backward(torch, x_tie, g, w, *args, block=first, policy=policy, eps=0.1)

        # the policy backward with dPolicy and without, the plain version,
        # and the plain-mode kernel on the same input
        hidden = blk.mlp.fc1.out_features
        k_ms, p_ms = paired_ms(
            torch,
            lambda: ops.fused_transformer_block_backward(x, g, w, args[0], policy, scale=args[1],
                                                         ln_eps=args[2]),
            lambda: transformer_block_backward_reference(x, g, w, *args, policy=policy),
            iters=3, repeats=3)
        no_dpol_ms = cuda_ms(torch, lambda: ops.fused_transformer_block_backward(
            x, g, w, args[0], policy, scale=args[1], ln_eps=args[2], policy_grad=False),
            iters=3, repeats=3)
        plain_mode_ms = cuda_ms(torch, lambda: ops.fused_transformer_block_backward(
            x, g, w, args[0], scale=args[1], ln_eps=args[2]), iters=3, repeats=3)
    b = block_backward_bound(*x.shape, args[0], hidden)
    b["bytes_ms"] += 2 * policy_bytes(*x.shape[:2]) / HBM_BYTES_PER_S * 1e3
    if mode == "gumbel":  # the path that asks for dPolicy
        tally.add("fused_transformer_block_backward[policy]", 9, k_ms, p_ms, b)
    emit({"phase": f"time_{mode}", "kernel": "fused_transformer_block_backward[policy]",
          "shape": list(x.shape), "ms": k_ms, "no_dpolicy_ms": no_dpol_ms, "plain_ms": p_ms,
          "plain_mode_kernel_ms": plain_mode_ms, "bound_ms": max(b.values()),
          "calls_per_step": 9})
    del student, teacher, step, rec

    f_student, f_teacher, f_step = build_trainer(torch, dev, fused=True, mode=mode)
    p_student, p_teacher, p_step = build_trainer(torch, dev, fused=False, mode=mode)
    p_student.load_state_dict(f_student.state_dict())
    p_teacher.load_state_dict(f_teacher.state_dict())
    f_ms, p_ms = paired_ms(torch, lambda: f_step(images, labels, TRAIN_EPOCH),
                           lambda: p_step(images, labels, TRAIN_EPOCH), iters=2, repeats=3)
    emit({"phase": f"time_{mode}", "train_step": f"B={B_TRAIN} {mode} student + teacher",
          "kernels_ms": f_ms, "plain_ms": p_ms,
          "kernels_img_per_s": B_TRAIN / f_ms * 1e3,
          "plain_img_per_s": B_TRAIN / p_ms * 1e3, "card": smi})


def phase_serve_gumbel(torch, dev, tally):
    """Phase 11: the gumbel baseline's eval forward (top-k gathers)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import GUMBEL_KWARGS, GUMBEL_MODEL, create_model

    model = create_model(GUMBEL_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **GUMBEL_KWARGS).eval()
    N, C = model.cfg.num_patches, model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    x = torch.randn((8, 224, 224, 3), generator=torch.Generator(device=dev).manual_seed(12),
                    device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = model(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    if counts != PER_GUMBEL_FORWARD:
        raise AssertionError(f"gumbel eval: launches {counts}, expected {PER_GUMBEL_FORWARD}")
    ok = (out.logits.shape == (8, 1000) and out.features.shape == (8, keep[-1], C)
          and int(out.kept_idx_orig.max()) < N and out.decisions is None
          and bool(torch.isfinite(out.logits.float()).all())
          and bool(torch.isfinite(out.features.float()).all()))
    if not ok:
        raise AssertionError(f"gumbel eval: bad outputs {out.logits.shape} {out.features.shape}")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    emit({"phase": "serve_gumbel", "batch": 8, "launches": counts,
          "features": list(out.features.shape),
          "pred_keep_probs": [t.shape[1] for t in out.pred_keep_probs]})


# ---- training with the student's own CLS rows: attn selection --------------


def capture_attn_step(torch, step, images, labels):
    """Run one more train step of the attn student with spies on its packed
    attention cores and MLP halves: per block, in order, {"qkv", "heads",
    "scale", "g", "gcls"} (the core's input and its two outputs' cotangents;
    gcls None where the CLS rows get no gradient) and {"x", "w", "eps", "g"}
    (the MLP half's input, weights before the update and output's
    cotangent)."""
    import dense2sparse_vit_torch.nn.layers as layers

    rec = {"attn": [], "mlp": []}
    real_attn = layers.fused_attention_packed_with_cls_trainable
    real_mlp = layers.fused_mlp_residual

    def attn_spy(qkv, num_heads, policy=None, scale=None):
        out, cls = real_attn(qkv, num_heads, policy, scale)
        e = {"qkv": qkv.detach(), "heads": num_heads, "scale": scale, "g": None, "gcls": None}
        out.register_hook(lambda g: e.__setitem__("g", g.detach().contiguous()))
        # a row that feeds no loss gets no gradient: the hook sees None
        cls.register_hook(lambda g: e.__setitem__("gcls", None if g is None else g.detach()))
        rec["attn"].append(e)
        return out, cls

    def mlp_spy(x, *weights_eps):
        y = real_mlp(x, *weights_eps)
        e = {"x": x.detach(), "w": [t.detach().clone() for t in weights_eps[:6]],
             "eps": weights_eps[6], "g": None}
        y.register_hook(lambda g: e.__setitem__("g", g.detach().contiguous()))
        rec["mlp"].append(e)
        return y

    layers.fused_attention_packed_with_cls_trainable = attn_spy
    layers.fused_mlp_residual = mlp_spy
    try:
        step(images, labels, TRAIN_EPOCH)
        torch.cuda.synchronize()
    finally:
        layers.fused_attention_packed_with_cls_trainable = real_attn
        layers.fused_mlp_residual = real_mlp
    return rec


def _thirds(torch, name, got, want, rel):
    """q, k and v of a packed dqkv apart: dV is the largest, and a fault in
    the scores' gradient (dQ, dK) would hide under it."""
    worst = 0.0
    for part, a, b in zip("qkv", got.chunk(3, -1), want.chunk(3, -1)):
        err, ref = rel_err(torch, a, b)
        rel[f"{name}.{part}"] = (err / max(ref, 1e-30), BWD_TOL)
        worst = max(worst, err)
    return worst


def check_attn_block(torch, e, m, block=None):
    """Hold the packed attention and the MLP half against their plain
    versions on a train step's own activations at one block (`e`, `m` from
    `capture_attn_step`):
      out, cls: the packed forward's output and CLS rows against
        `attention_reference` (STAGE_TOL), each CLS row summing to 1
        (ROWSUM_TOL);
      dqkv.{q,k,v}: the packed backward with the step's g and gcls against
        autograd through the plain version (BWD_TOL);
      gcls_only[step|offset].{q,k,v}: where the CLS rows get a gradient,
        the backward with g = 0, so that the fold stands alone: with the
        step's gcls, and with a seeded one plus a constant (which the
        softmax's row sum cancels in exact arithmetic, and a fold that
        leaves sum_j gcls_j P_0j out of D_0 does not);
      mlp_out: the MLP half's output (BLOCK_TOL), and mlp_branch: its
        fc2(GELU(fc1(LN x))) beyond the one bf16 rounding of the sum, relative
        to the branch (BRANCH_TOL);
      mlp.{dx,ln_w,ln_b,w1,b1,w2,b2}: its backward (BWD_TOL).
    Prints the relative errors, raises naming every tensor out of tolerance,
    and returns the largest absolute errors per kernel."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_backward_reference
    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm
    from dense2sparse_vit_torch.ops.mlp import (
        mlp_residual_backward_reference, mlp_residual_reference)

    qkv, H, scale, g, gcls = e["qkv"], e["heads"], e["scale"], e["g"], e["gcls"]
    rel, worst = {}, dict.fromkeys(("fwd", "bwd", "mlp", "mlp_bwd"), 0.0)
    with torch.no_grad():
        out, cls = ops.fused_attention_packed(qkv, H, scale=scale, return_cls=True)
        want_out, want_cls = attention_reference(qkv, H, scale, return_cls=True)
        for name, got, want in (("out", out, want_out), ("cls", cls, want_cls)):
            err, ref = rel_err(torch, got, want)
            rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
            worst["fwd"] = max(worst["fwd"], err)
        rel["cls_rowsum"] = ((cls.float().sum(-1) - 1).abs().max().item(), ROWSUM_TOL)
        cases = {"dqkv": (g, gcls)}
        if gcls is not None:
            gen = torch.Generator(device=qkv.device).manual_seed(17 + (block or 0))
            sd = gcls.float().std().item()
            offset = ((torch.randn(gcls.shape, generator=gen, device=qkv.device) + 1.0)
                      * sd).to(gcls.dtype)
            cases["gcls_only[step]"] = (torch.zeros_like(g), gcls)
            cases["gcls_only[offset]"] = (torch.zeros_like(g), offset)
        for name, (gg, gc) in cases.items():
            got = ops.fused_attention_backward_packed(qkv, gg, H, gcls=gc, scale=scale)
            want, _ = attention_backward_reference(qkv, gg, H, scale, gcls=gc)
            worst["bwd"] = max(worst["bwd"], _thirds(torch, name, got, want, rel))

        x, w, eps, gm = m["x"], m["w"], m["eps"], m["g"]
        y = ops.fused_mlp_residual(x, *w, eps)
        err, ref = rel_err(torch, y, mlp_residual_reference(x, *w, eps))
        rel["mlp_out"] = (err / ref, BLOCK_TOL)
        worst["mlp"] = err
        ln_w, ln_b, w1, b1, w2, b2 = w
        pre = layer_norm(x, ln_w, ln_b, eps).float() @ w1.float().t() + b1
        branch = F.gelu(pre).to(x.dtype).float() @ w2.float().t() + b2
        z = x.float() + branch
        excess = ((y.float() - z).abs() - BF16_U * z.abs()).clamp(min=0)
        rel["mlp_branch"] = (excess.max().item() / max(branch.abs().max().item(), 1e-30),
                             BRANCH_TOL)
        got = ops.fused_mlp_residual_backward(x, gm, *w[:5], eps=eps)
        want = mlp_residual_backward_reference(x, gm, *w[:5], eps)
        for name, a, b in zip(("dx", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), got, want):
            err, ref = rel_err(torch, a, b)
            rel[f"mlp.{name}"] = (err / max(ref, 1e-30), BWD_TOL)
            worst["mlp_bwd"] = max(worst["mlp_bwd"], err)
    emit({"phase": "check_attn", "block": block, "shape": list(qkv.shape),
          "gcls": gcls is not None, "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"block {block}: packed attention / MLP half out of tolerance: {bad}")
    return worst


def check_attn_policy(torch, qkv, policy, g, gcls, H, scale, eps):
    """The packed attention's policy mode, which no model path reaches yet:
    the forward (out, CLS rows) against its plain version (STAGE_TOL), the
    backward's dqkv (BWD_TOL) and dPolicy (DPOL_TOL) with g and gcls
    against autograd through the plain version."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_backward_reference
    from dense2sparse_vit_torch.ops.block import attention_reference

    rel = {}
    with torch.no_grad():
        out, cls = ops.fused_attention_packed(qkv, H, policy, scale=scale, eps=eps,
                                              return_cls=True)
        want = attention_reference(qkv, H, scale, policy=policy, eps=eps, return_cls=True)
        for name, a, b in (("out", out, want[0]), ("cls", cls, want[1])):
            err, ref = rel_err(torch, a, b)
            rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
        dqkv, dpol = ops.fused_attention_backward_packed(qkv, g, H, policy=policy, gcls=gcls,
                                                         scale=scale, eps=eps)
        want_dqkv, want_dpol = attention_backward_reference(qkv, g, H, scale, policy=policy,
                                                            gcls=gcls, eps=eps)
        _thirds(torch, "dqkv", dqkv, want_dqkv, rel)
        err, ref = rel_err(torch, dpol, want_dpol)
        rel["dpolicy"] = (err / max(ref, 1e-30), DPOL_TOL)
    emit({"phase": "check_attn", "kernel": "packed attention [policy]", "eps": eps,
          "shape": list(qkv.shape), "kept_share": policy.float().mean().item(),
          "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"packed attention, policy mode, eps {eps}: out of tolerance: {bad}")


def phase_check_attn(torch, dev, step, images, labels, tally):
    """Phase 18; returns the recorded activations for phase 19."""
    from dense2sparse_vit_torch.models import HEADLINE_MODEL, THRESHOLD_KWARGS, create_model

    rec = capture_attn_step(torch, step, images, labels)
    fed = [i for i, e in enumerate(rec["attn"]) if e["gcls"] is not None]
    emit({"phase": "check_attn", "blocks": len(rec["attn"]), "cls_rows_with_gradient": fed})
    if len(rec["attn"]) != 12 or len(rec["mlp"]) != 12 or fed != list(ATTN_STAGE_FEEDERS):
        raise AssertionError(f"attn step: {len(rec['attn'])} cores, {len(rec['mlp'])} MLP "
                             f"halves, CLS rows with a gradient at {fed}")
    for i, (e, m) in enumerate(zip(rec["attn"], rec["mlp"])):
        worst = check_attn_block(torch, e, m, block=i)
        for name, key in (("fused_attention_packed", "fwd"),
                          ("fused_attention_backward_packed", "bwd"),
                          ("fused_mlp_residual", "mlp"), ("fused_mlp_residual_backward", "mlp_bwd")):
            tally.err(name, worst[key])

    # policy mode at N=197: a threshold student's first-stage keep mask
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **THRESHOLD_KWARGS).eval()
    with torch.inference_mode():
        mask = model(images, collect_cls_attns=False).keep_masks[0]
    del model
    e = rec["attn"][ATTN_STAGE_FEEDERS[0]]
    qkv = e["qkv"]
    policy = torch.cat([mask.new_ones(mask.shape[0], 1), mask], dim=1).float()
    gen = torch.Generator(device=dev).manual_seed(16)
    gcls = (torch.randn(e["gcls"].shape, generator=gen, device=dev)
            * e["gcls"].float().std()).to(e["gcls"].dtype)
    for eps in EPS_CHECKS:
        check_attn_policy(torch, qkv, policy, e["g"], gcls, e["heads"], e["scale"], eps)
    return rec


def sdpa_inputs(torch, qkv, g, H):
    """q, k, v (B, H, N, d), contiguous leaves with gradients, and the
    output's cotangent in the same layout, for the library call."""
    B, N, C3 = qkv.shape
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.detach().view(B, N, 3, H, C3 // 3 // H).permute(2, 0, 3, 1, 4).unbind(0))
    return q, k, v, g.view(B, N, H, -1).transpose(1, 2).contiguous()


def phase_time_attn(torch, dev, rec, tally, smi, images, labels):
    """Phase 19: each new kernel against its plain version at every width
    of the step (and the library's attention beside the packed core), and
    the whole attn train step with kernels against without."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_backward_reference
    from dense2sparse_vit_torch.ops.block import attention_reference
    from dense2sparse_vit_torch.ops.mlp import (
        mlp_residual_backward_reference, mlp_residual_reference)

    widths = {}
    for i, e in enumerate(rec["attn"]):
        widths.setdefault(e["qkv"].shape[1], []).append(i)
    for n, idxs in widths.items():
        e = rec["attn"][idxs[0]]
        qkv, H, scale, g = e["qkv"], e["heads"], e["scale"], e["g"]
        fed = [i for i in idxs if rec["attn"][i]["gcls"] is not None]
        B, N, C3 = qkv.shape
        C = C3 // 3
        q, k, v, g4 = sdpa_inputs(torch, qkv, g, H)
        with torch.no_grad():
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_attention_packed(qkv, H, scale=scale, return_cls=True),
                lambda: attention_reference(qkv, H, scale, return_cls=True), iters=10)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                             iters=10)
            k_graph_ms = graph_ms(
                torch, lambda: ops.fused_attention_packed(qkv, H, scale=scale, return_cls=True))
            lib_graph_ms = graph_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        b = attention_bound(B, N, C, H, cls=True)
        tally.add("fused_attention_packed", len(idxs), k_ms, p_ms, b, lib_ms)
        emit({"phase": "time_attn", "kernel": "fused_attention_packed", "shape": list(qkv.shape),
              "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": max(b.values()),
              "graph_ms": k_graph_ms, "library_graph_ms": lib_graph_ms,
              "calls_per_step": len(idxs)})

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
            torch.autograd.grad(out, (q, k, v), g4)

        # the library's backward alone: its forward and backward less its forward
        lib_fwd_bwd_ms = cuda_ms(torch, sdpa_fwd_bwd, iters=5)
        lib_ms = lib_fwd_bwd_ms - lib_ms
        for gcls, calls in ((None, len(idxs) - len(fed)),
                            (rec["attn"][fed[0]]["gcls"] if fed else None, len(fed))):
            if calls == 0:
                continue
            with torch.no_grad():
                k_ms, p_ms = paired_ms(
                    torch, lambda: ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls,
                                                                       scale=scale),
                    lambda: attention_backward_reference(qkv, g, H, scale, gcls=gcls),
                    iters=5, repeats=3)
            b = attention_backward_bound(B, N, C, H, gcls=gcls is not None)
            tally.add("fused_attention_backward_packed", calls, k_ms, p_ms, b, lib_ms)
            emit({"phase": "time_attn", "kernel": "fused_attention_backward_packed",
                  "shape": list(qkv.shape), "gcls": gcls is not None, "ms": k_ms,
                  "plain_ms": p_ms, "library_ms": lib_ms, "library_fwd_bwd_ms": lib_fwd_bwd_ms,
                  "bound_ms": max(b.values()), "calls_per_step": calls})

        m = rec["mlp"][idxs[0]]
        x, w, eps, gm = m["x"], m["w"], m["eps"], m["g"]
        hidden = w[2].shape[0]
        with torch.no_grad():
            k_ms, p_ms = paired_ms(torch, lambda: ops.fused_mlp_residual(x, *w, eps),
                                   lambda: mlp_residual_reference(x, *w, eps), iters=10)
            b = mlp_bound(B, N, C, hidden)
            tally.add("fused_mlp_residual", len(idxs), k_ms, p_ms, b)
            emit({"phase": "time_attn", "kernel": "fused_mlp_residual", "shape": list(x.shape),
                  "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                  "bound_ms": max(b.values()), "calls_per_step": len(idxs)})
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_mlp_residual_backward(x, gm, *w[:5], eps=eps),
                lambda: mlp_residual_backward_reference(x, gm, *w[:5], eps), iters=5, repeats=3)
            b = mlp_backward_bound(B, N, C, hidden)
            tally.add("fused_mlp_residual_backward", len(idxs), k_ms, p_ms, b)
            emit({"phase": "time_attn", "kernel": "fused_mlp_residual_backward",
                  "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                  "bound_ms": max(b.values()), "calls_per_step": len(idxs)})

    f_student, f_teacher, f_step = build_trainer(torch, dev, fused=True, mode="attn")
    p_student, p_teacher, p_step = build_trainer(torch, dev, fused=False, mode="attn")
    p_student.load_state_dict(f_student.state_dict())
    p_teacher.load_state_dict(f_teacher.state_dict())
    f_ms, p_ms = paired_ms(torch, lambda: f_step(images, labels, TRAIN_EPOCH),
                           lambda: p_step(images, labels, TRAIN_EPOCH), iters=2, repeats=3)
    emit({"phase": "time_attn", "train_step": f"B={B_TRAIN} attn student + teacher",
          "kernels_ms": f_ms, "plain_ms": p_ms,
          "kernels_img_per_s": B_TRAIN / f_ms * 1e3,
          "plain_img_per_s": B_TRAIN / p_ms * 1e3, "card": smi})


def phase_serve_attn(torch, dev, tally):
    """Phase 20: a B=8 eval forward of the attn student: its launches, the
    widths of its CLS rows, and its logits against the plain model's, with
    the plain model's stage scores pinned to the kernel model's (a near tie
    among CLS-attention scores may rank differently in bf16; how many kept
    indices the plain model's own ranking moves is printed)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import ATTN_KWARGS, HEADLINE_MODEL, create_model

    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **ATTN_KWARGS).eval()
    plain = create_model(HEADLINE_MODEL, use_fused_attention=False, device=dev,
                         **ATTN_KWARGS).eval()
    plain.load_state_dict(model.state_dict())
    N, C = model.cfg.num_patches, model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    x = torch.randn((8, 224, 224, 3), generator=torch.Generator(device=dev).manual_seed(18),
                    device=dev, dtype=torch.bfloat16)
    scores = []
    real_scores = type(model)._stage_scores

    def record(self, p, *args):
        out = real_scores(self, p, *args)
        scores.append(out)
        return out

    with torch.inference_mode():
        ops.reset_launch_counts()
        model._stage_scores = record.__get__(model)
        out = model(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        del model._stage_scores
        own = plain(x)
        plain._stage_scores = lambda p, *args: scores[p]
        pinned = plain(x)
    widths = [t.shape[-1] for t in out.cls_attns]
    want_widths = [N] * 3 + [keep[0]] * 3 + [keep[1]] * 3 + [keep[2]] * 3
    moved = [(a != b).float().mean().item() for a, b in zip(out.kept_idx, own.kept_idx)]
    err, scale = rel_err(torch, out.logits, pinned.logits)
    emit({"phase": "serve_attn", "batch": 8, "launches": counts, "cls_attn_widths": widths,
          "kept_idx_moved_by_plain_ranking": moved, "max_abs_err": err, "max_abs_ref": scale,
          "tol_rel": LOGITS_TOL})
    if counts != PER_ATTN_FORWARD:
        raise AssertionError(f"attn eval: launches {counts}, expected {PER_ATTN_FORWARD}")
    ok = (widths == want_widths and out.logits.shape == (8, 1000)
          and out.features.shape == (8, keep[-1], C) and out.pred_logits[0].shape == (8, N)
          and bool(torch.isfinite(out.logits.float()).all()))
    if not ok:
        raise AssertionError(f"attn eval: bad outputs, CLS-row widths {widths}")
    if err > LOGITS_TOL * max(scale, 1e-3):
        raise AssertionError(f"attn eval: logits max err {err} vs scale {scale}")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v


# ---- int8 serving, export, eval -------------------------------------------


def ulp_excess(got, want) -> float:
    """How far got strays beyond one bf16 rounding of each element of want,
    relative to want's largest magnitude."""
    got, want = got.float(), want.float()
    if not (got.isfinite().all() and want.isfinite().all()):
        raise AssertionError("non-finite values")
    excess = ((got - want).abs() - 2 * BF16_U * want.abs()).clamp(min=0)
    return excess.max().item() / max(want.abs().max().item(), 1e-30)


def check_int8_block(torch, x, qw, num_heads, scale, ln_eps, block=None):
    """Hold the int8 block kernel against its plain version, stage by stage,
    each stage's plain version fed the kernel's own input to it:
      codes1..codes4: the four quantizations (LN1(x), the attention output,
        LN2(x_mid), the GELU activation): the share of codes that differ and
        by how many steps, and the row scales (CODE_FLIP_SHARE, SCALE_TOL);
      qkv, act, fc2_out: the dequantized products of the kernel's codes (fc1
        through GELU, fc2 plus x_mid) within one bf16 rounding
        (INT8_ULP_TOL); x_mid within INT8_MID_TOL of its branch;
      attn: the attention core on the kernel's qkv (STAGE_TOL);
      block: the whole output against `quant_block_reference` (BLOCK_TOL).
    Prints the results, raises if a stage is out of tolerance, and returns
    the kernel's output and its largest absolute error against the plain
    block."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import attention_reference
    from dense2sparse_vit_torch.ops.quant import (
        dequantize, int_dot, layer_norm_f32, quant_block_reference, quantize_rows)

    y, st = ops.fused_transformer_block_int8(x, qw, num_heads, scale=scale, ln_eps=ln_eps,
                                             stages=True)

    def product(i, codes, scales, bias):
        return dequantize(int_dot(st[f"q{i}"], qw[codes]), st[f"s{i}"][..., None], qw[scales],
                          qw[bias])

    rel, codes, bad = {}, {}, {}
    inputs = {1: layer_norm_f32(x.float(), qw["ln1_w"], qw["ln1_b"], ln_eps),
              2: st["attn"].float(),
              3: layer_norm_f32(st["mid"], qw["ln2_w"], qw["ln2_b"], ln_eps),
              4: st["act"].float()}
    for i, h in inputs.items():
        q, s = quantize_rows(h)
        step = (st[f"q{i}"].int() - q.int()).abs()
        c = codes[f"codes{i}"] = {
            "share": (step > 0).float().mean().item(), "max_step": step.max().item(),
            "scale_rel_err": ((st[f"s{i}"] - s[..., 0]).abs() / s[..., 0]).max().item()}
        flips = CODE_FLIP_SHARE if i in (1, 3) else 0.0  # the LayerNorm-fed ones
        if c["share"] > flips or c["max_step"] > 1 or c["scale_rel_err"] > SCALE_TOL:
            bad[f"codes{i}"] = c
    dtype = x.dtype
    branch = product(2, "wproj_q", "sproj", "bproj")
    mid_err = (st["mid"] - (x.float() + branch)).abs().max().item()
    rel["x_mid"] = (mid_err / max(branch.abs().max().item(), 1e-30), INT8_MID_TOL)
    rel["qkv"] = (ulp_excess(st["qkv"], product(1, "wqkv_q", "sqkv", "bqkv").to(dtype)),
                  INT8_ULP_TOL)
    act = F.gelu(product(3, "w1_q", "s1", "b1").to(dtype).float()).to(dtype)
    rel["act"] = (ulp_excess(st["act"], act), INT8_ULP_TOL)
    rel["fc2_out"] = (ulp_excess(y, (st["mid"] + product(4, "w2_q", "s2", "b2")).to(dtype)),
                      INT8_ULP_TOL)
    err, ref = rel_err(torch, st["attn"], attention_reference(st["qkv"], num_heads, scale))
    rel["attn"] = (err / max(ref, 1e-30), STAGE_TOL)
    err, ref = rel_err(torch, y, quant_block_reference(x, qw, num_heads, scale, ln_eps))
    rel["block"] = (err / ref, BLOCK_TOL)
    emit({"phase": "check_int8", "kernel": "fused_transformer_block_int8", "block": block,
          "shape": list(x.shape), "codes": codes, "max_abs_err": err, "max_abs_ref": ref,
          "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()},
          "tol_codes": {"share_ln": CODE_FLIP_SHARE, "share_other": 0.0, "max_step": 1,
                        "scale_rel": SCALE_TOL}})
    bad.update({k: r for k, (r, t) in rel.items() if not r <= t})
    if bad:
        raise AssertionError(f"int8 block kernel out of tolerance: {bad}")
    return y, err


def build_int8_student(torch, dev, quant="int8"):
    """The headline student from seed 0 with the kernels, eval mode, int8
    (quant="none": the bf16 kernels, on the same weights)."""
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, create_model

    return create_model(HEADLINE_MODEL, use_fused_attention=True, quant=quant, device=dev,
                        generator=torch.Generator().manual_seed(0), **HEADLINE_KWARGS).eval()


def walk_int8(torch, model, images, tally=None):
    """The int8 student's forward stage by stage, every block held against
    its plain version (`check_int8_block`); returns the logits and, per
    width, the first block's input, int8 weights and arguments."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.topk import topk_keep_indices

    bf16 = torch.bfloat16
    keep = model.pruning.keep_counts(model.cfg.num_patches)
    shapes = []
    x = model.embed(images)
    p = 0
    for i, blk in enumerate(model.blocks):
        if i in model.pruning.pruning_locs:
            _, probs = model.score_predictor[p](x[:, 1:])
            kept, _ = topk_keep_indices(probs, keep[p])
            x = ops.fused_gather_tokens(x, torch.cat([kept.new_zeros(x.shape[0], 1), kept + 1],
                                                     dim=1))
            p += 1
        qw = blk.int8_weights(bf16)
        args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
        y, err = check_int8_block(torch, x, qw, *args, block=i)
        if tally is not None:
            tally.err("fused_transformer_block_int8", err)
        if not shapes or shapes[-1][0].shape != x.shape:
            shapes.append((x, qw, blk.kernel_weights(bf16), args))
        x = y
    return model.head(model.norm(x)[:, 0]), shapes


def phase_serve_int8(torch, dev, tally):
    """Phase 12; returns (model, images, outputs)."""
    from dense2sparse_vit_torch import ops

    model = build_int8_student(torch, dev)
    N, C = model.cfg.num_patches, model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    gen = torch.Generator(device=dev).manual_seed(14)
    images = {b: torch.randn((b, 224, 224, 3), generator=gen, device=dev, dtype=torch.bfloat16)
              for b in SERVE_BATCHES}
    outputs = {}
    with torch.inference_mode():
        for b in SERVE_BATCHES:
            ops.reset_launch_counts()
            out = model(images[b], collect_cls_attns=False)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            if counts != PER_INT8_FORWARD:
                raise AssertionError(f"int8 B={b}: launches {counts}, expected {PER_INT8_FORWARD}")
            ok = (out.logits.shape == (b, 1000) and out.features.shape == (b, keep[-1], C)
                  and int(out.kept_idx_orig.max()) < N
                  and bool(torch.isfinite(out.logits.float()).all())
                  and bool(torch.isfinite(out.features.float()).all()))
            if not ok:
                raise AssertionError(f"int8 B={b}: bad outputs {out.logits.shape} "
                                     f"{out.features.shape}")
            for k, v in counts.items():
                tally.rows[k]["launches"] += v
            outputs[b] = out
            emit({"phase": "serve_int8", "batch": b, "launches": counts,
                  "logits": list(out.logits.shape), "features": list(out.features.shape)})
    return model, images, outputs


def phase_check_int8(torch, dev, model, images, outputs, tally):
    """Phase 13; returns (the bf16-kernel model on the same weights, the
    shapes phase 14 times)."""
    bf16_model = build_int8_student(torch, dev, quant="none")
    bf16_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        logits, shapes = walk_int8(torch, model, images[B_CHECK], tally)
        if not torch.equal(logits, outputs[B_CHECK].logits):
            raise AssertionError("int8 stage walk and model forward disagree")
        ref = bf16_model(images[B_CHECK], collect_cls_attns=False).logits.float()
    got = logits.float()
    rms = ((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    top1 = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    emit({"phase": "check_int8", "int8_walk_equals_forward": True,
          "logits_vs_bf16_kernels": {"batch": B_CHECK, "rel_rms": rms, "top1_agreement": top1}})
    return bf16_model, shapes


def phase_time_int8(torch, dev, model, bf16_model, images, shapes, tally, smi):
    """Phase 14."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, create_model
    from dense2sparse_vit_torch.ops.quant import quant_block_reference

    hidden = model.blocks[0].mlp.fc1.out_features
    with torch.inference_mode():
        for x, qw, w, args in shapes:  # 3 blocks at each width
            k_ms, p_ms = paired_ms(
                torch,
                lambda: ops.fused_transformer_block_int8(x, qw, args[0], scale=args[1],
                                                         ln_eps=args[2]),
                lambda: quant_block_reference(x, qw, *args), iters=10)
            bf16_ms = cuda_ms(torch, lambda: ops.fused_transformer_block(
                x, w, args[0], scale=args[1], ln_eps=args[2]), iters=10)
            b = int8_block_bound(*x.shape, args[0], hidden)
            tally.add("fused_transformer_block_int8", 3, k_ms, p_ms, b)
            emit({"phase": "time_int8", "kernel": "fused_transformer_block_int8",
                  "shape": list(x.shape), "ms": k_ms, "plain_ms": p_ms,
                  "bf16_kernel_ms": bf16_ms, "bound_ms": max(b.values()),
                  "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes"})
        plain = create_model(HEADLINE_MODEL, use_fused_attention=False, device=dev,
                             **HEADLINE_KWARGS).eval()
        plain.load_state_dict(model.state_dict())
        imgs = images[B_CHECK]
        i_ms, b_ms = paired_ms(torch, lambda: model(imgs, collect_cls_attns=False),
                               lambda: bf16_model(imgs, collect_cls_attns=False), iters=5)
        i2_ms, p_ms = paired_ms(torch, lambda: model(imgs, collect_cls_attns=False),
                               lambda: plain(imgs, collect_cls_attns=False), iters=5)
    emit({"phase": "time_int8", "forward": "B=256 pruned student",
          "int8_kernels_ms": i_ms, "bf16_kernels_ms": b_ms, "plain_ms": p_ms,
          "int8_kernels_ms_beside_plain": i2_ms,
          "int8_img_per_s": B_CHECK / i_ms * 1e3, "bf16_img_per_s": B_CHECK / b_ms * 1e3,
          "plain_img_per_s": B_CHECK / p_ms * 1e3, "card": smi})


# The serving process of phase 15: loads each saved artifact directory and
# serves seeded batches; imports the port's op library, never its models.
LOADER = r"""
import json, sys, torch
from dense2sparse_vit_torch import ops
from dense2sparse_vit_torch.utils.serving import ServingModel
jobs, out = json.loads(sys.argv[1]), sys.argv[2]
dev = torch.device("cuda", 0)
res = {}
for name, path, batches, seed in jobs:
    sm = ServingModel.load(path)
    entry = {"symbolic": sm.symbolic, "buckets": list(sm.buckets), "counts": {}, "logits": {}}
    for b in batches:
        gen = torch.Generator(device=dev).manual_seed(seed + b)
        x = torch.randn((b, 224, 224, 3), generator=gen, device=dev)
        ops.reset_launch_counts()
        y = sm(x)
        torch.cuda.synchronize()
        entry["counts"][b], entry["logits"][b] = ops.launch_counts(), y.cpu()
    res[name] = entry
res["models_imported"] = sorted(m for m in sys.modules
                                if m.startswith("dense2sparse_vit_torch.models"))
torch.save(res, out)
"""


def phase_serve_export(torch, dev, int8_model):
    """Phase 15."""
    import subprocess
    from pathlib import Path

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import (
        GUMBEL_KWARGS, GUMBEL_MODEL, HEADLINE_KWARGS, HEADLINE_MODEL, THRESHOLD_KWARGS,
        create_model)
    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.utils.serving import ServingModel

    root = _cuda.BUILD_DIR / "serving"
    shutil.rmtree(root, ignore_errors=True)
    students = {"int8": (int8_model, PER_INT8_FORWARD, EXPORT_BUCKETS, EXPORT_BATCHES, True)}
    for name, model, kwargs, per in (
        ("topk", HEADLINE_MODEL, HEADLINE_KWARGS, PER_FORWARD),
        ("threshold", HEADLINE_MODEL, THRESHOLD_KWARGS, PER_THRESHOLD_FORWARD),
        ("gumbel", GUMBEL_MODEL, GUMBEL_KWARGS, PER_GUMBEL_FORWARD),
    ):
        m = create_model(model, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **kwargs).eval()
        students[name] = (m, per, (8,), (1, 5, 8, 9), False)
    jobs, served = [], {}
    for name, (model, per, buckets, batches, try_symbolic) in students.items():
        t0 = time.perf_counter()
        sm = ServingModel.export(model, buckets=buckets, try_symbolic=try_symbolic)
        path = root / name
        sm.save(str(path))
        served[name] = sm
        emit({"phase": "serve_export", "student": name, "symbolic": sm.symbolic,
              "buckets": list(sm.buckets), "symbolic_error": sm.symbolic_error,
              "export_s": round(time.perf_counter() - t0, 2),
              "artifact_bytes": sum(f.stat().st_size for f in Path(path).iterdir())})
        jobs.append((name, str(path), list(batches), 100))
    out = root / "served.pt"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", LOADER, json.dumps(jobs), str(out)],
                   cwd=str(Path(__file__).resolve().parent), check=True, timeout=900)
    res = torch.load(out)
    if res["models_imported"]:
        raise AssertionError(f"the serving process imported {res['models_imported']}")
    emit({"phase": "serve_export", "loaded_in_fresh_process_s": round(time.perf_counter() - t0, 2),
          "models_imported": res["models_imported"]})
    for name, (model, per, buckets, batches, _) in students.items():
        entry, sm = res[name], served[name]
        if entry["symbolic"] != sm.symbolic or tuple(entry["buckets"]) != sm.buckets:
            raise AssertionError(f"{name}: the loaded artifact is not the one saved")
        dtype = getattr(torch, model.cfg.dtype)
        for b in batches:
            gen = torch.Generator(device=dev).manual_seed(100 + b)
            x = torch.randn((b, 224, 224, 3), generator=gen, device=dev)
            with torch.inference_mode():
                ops.reset_launch_counts()
                kw = {} if name == "gumbel" else {"collect_cls_attns": False}
                want = model(x.to(dtype), **kw).logits.float().cpu()
                torch.cuda.synchronize()
                live = ops.launch_counts()
            if live != per:
                raise AssertionError(f"{name} B={b}: live launches {live}, expected {per}")
            calls, i = 0, 0
            while i < b:  # the artifact calls ServingModel makes for b rows
                i += sm._bucket_for(b - i) if not sm.symbolic else sm.max_batch
                calls += 1
            expect = {k: v * calls for k, v in per.items()}
            got = entry["logits"][b]
            err, scale = rel_err(torch, got, want)
            top1 = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
            emit({"phase": "serve_export", "student": name, "batch": b,
                  "artifact_calls": calls, "launches": entry["counts"][b],
                  "bit_equal": bool(torch.equal(got, want)), "top1_equal": top1,
                  "max_abs_err": err, "max_abs_ref": scale, "tol_rel": LOGITS_TOL})
            if entry["counts"][b] != expect:
                raise AssertionError(f"{name} B={b}: artifact launches {entry['counts'][b]}, "
                                     f"expected {expect}")
            if got.shape != want.shape or not top1 or err > LOGITS_TOL * max(scale, 1e-3):
                raise AssertionError(f"{name} B={b}: served logits differ from the live "
                                     f"model's (max err {err}, top-1 equal {top1})")


def phase_eval(torch, dev, tally):
    """Phase 16."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.core import ExperimentConfig
    from dense2sparse_vit_torch.models import (
        GUMBEL_KWARGS, GUMBEL_MODEL, HEADLINE_KWARGS, HEADLINE_MODEL, HEADLINE_TEACHER,
        create_model)
    from dense2sparse_vit_torch.train import make_dynamic_vit_eval_step, make_eval_step

    gen = torch.Generator(device=dev).manual_seed(15)
    images = torch.randn((B_EVAL, 224, 224, 3), generator=gen, device=dev)
    labels = torch.randint(0, 1000, (B_EVAL,), generator=gen, device=dev)
    labels[-EVAL_PADDING:] = -1
    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=True, device=dev,
                           dtype="bfloat16", generator=torch.Generator().manual_seed(2))
    for name, model, kwargs, make in (
        ("topk", HEADLINE_MODEL, HEADLINE_KWARGS, make_eval_step),
        ("int8", HEADLINE_MODEL, dict(HEADLINE_KWARGS, quant="int8"), make_eval_step),
        ("gumbel", GUMBEL_MODEL, GUMBEL_KWARGS, make_dynamic_vit_eval_step),
    ):
        student = create_model(model, use_fused_attention=True, device=dev,
                               generator=torch.Generator().manual_seed(0), **kwargs)
        step = make(student, teacher, ExperimentConfig(model=student.cfg, pruning=student.pruning))
        ops.reset_launch_counts()
        metrics = step(images, labels)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        values = {k: v.item() for k, v in metrics.items()}
        emit({"phase": "eval", "student": name, "batch": B_EVAL, "padded_rows": EVAL_PADDING,
              "launches": counts, "metrics": values})
        if counts != PER_EVAL_STEP[name]:
            raise AssertionError(f"eval {name}: launches {counts}, expected {PER_EVAL_STEP[name]}")
        bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
        if bad or values["n_valid"] != B_EVAL - EVAL_PADDING:
            raise AssertionError(f"eval {name}: non-finite {bad}, n_valid {values['n_valid']}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v


# ---- the T2T-ViT-14 family, trained with stochastic depth ------------------

B_T2T = 128
T2T_DROP_PATH = 0.1
# T2T serving (bench_zoo.py's config 4): 14 plain blocks, the full-size LN
# predictor at 3 stages, 3 gathers
PER_T2T_FORWARD = {**NO_LAUNCHES, "fused_transformer_block": 14, "fused_predictor_lg": 3,
                   "fused_gather_tokens": 3}
# a T2T train step at drop path 0.1: the teacher's 14 CLS-row blocks; the
# student's block 0 (rate 0: no draw) plain and blocks 1-13 with their
# branch scales, each way; 3 gathers and their 3 scatters
PER_T2T_TRAIN_STEP = {**NO_LAUNCHES, "fused_transformer_block_cls": 14,
                      "fused_transformer_block": 1, "fused_transformer_block[scaled]": 13,
                      "fused_transformer_block_backward": 1,
                      "fused_transformer_block_backward[scaled]": 13,
                      "fused_gather_tokens": 3, "fused_scatter_tokens": 3, **norm_launches(14),
                      **core_launches(14)}
# the dense t2t_vit_14's forward and backward at the same rate
PER_T2T_DENSE_STEP = {**NO_LAUNCHES, "fused_transformer_block": 1,
                      "fused_transformer_block[scaled]": 13,
                      "fused_transformer_block_backward": 1,
                      "fused_transformer_block_backward[scaled]": 13, **norm_launches(14),
                      **core_launches(14)}
B_T2T_DENSE = 64
# check_droppath's scales: Bernoulli(0.7)/0.7, so that both values occur often
DROPPATH_CHECK_RATE = 0.3
# train step 1, kernels against the plain model from the same draws and the
# same kept tokens: the loss relative to its size, and all trained
# gradients as one vector, relative L2 (bf16 through 14 blocks and the stem)
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2


def build_t2t_trainer(torch, dev, fused: bool):
    """The pruned T2T-ViT-14 (`T2T_KWARGS`) at drop path 0.1 and the teacher
    the JAX loop pairs with a student (a `ViTTeacher` of its ModelConfig,
    `train/loop.py:219-220`), from seeded generators, with AdamW past the
    warmup and the train step drawing from a generator seeded 11:
    (student, teacher, step)."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import T2T_KWARGS, T2T_MODEL, ViTTeacher, create_model
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    student = create_model(T2T_MODEL, device=dev, generator=torch.Generator().manual_seed(0),
                           **dict(T2T_KWARGS, use_fused_attention=fused,
                                  drop_path_rate=T2T_DROP_PATH))
    teacher = ViTTeacher(student.cfg).init_weights(torch.Generator().manual_seed(2)).to(dev)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = cfg.train.warmup_epochs * STEPS_PER_EPOCH
    draws = torch.Generator(device=dev).manual_seed(11)
    return student, teacher, make_train_step(student, teacher, opt, cfg, generator=draws)


def phase_serve_t2t(torch, dev, tally):
    """Phase 21: B=8 and B=128 through the pruned T2T-ViT-14 in eval mode
    (`collect_cls_attns=False`, as the eval step runs it), launches and
    outputs checked; the B=128 forward walked stage by stage with every
    serving kernel held against its plain version, and the unpruned logits
    against the plain model's. Returns (model, plain, images)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import T2T_KWARGS, T2T_MODEL, create_model

    model = create_model(T2T_MODEL, device=dev, generator=torch.Generator().manual_seed(0),
                         **T2T_KWARGS).eval()
    plain = create_model(T2T_MODEL, device=dev,
                         **dict(T2T_KWARGS, use_fused_attention=False)).eval()
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=dev).manual_seed(21)
    images = {b: torch.randn((b, 224, 224, 3), generator=gen, device=dev, dtype=torch.bfloat16)
              for b in (8, B_T2T)}
    N, C = model.cfg.num_patches, model.cfg.embed_dim
    keep = model.pruning.keep_counts(N)
    outputs = {}
    with torch.inference_mode():
        for b, x in images.items():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = model(x, collect_cls_attns=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            if counts != PER_T2T_FORWARD:
                raise AssertionError(f"T2T B={b}: launches {counts}, expected {PER_T2T_FORWARD}")
            ok = (out.logits.shape == (b, 1000) and out.features.shape == (b, keep[-1], C)
                  and [t.shape[1] for t in out.pred_logits] == [N, keep[0], keep[1]]
                  and int(out.kept_idx_orig.max()) < N
                  and bool(torch.isfinite(out.logits.float()).all())
                  and bool(torch.isfinite(out.features.float()).all()))
            if not ok:
                raise AssertionError(f"T2T B={b}: bad outputs {out.logits.shape} "
                                     f"{out.features.shape}")
            for k, v in counts.items():
                tally.rows[k]["launches"] += v
            outputs[b] = out
            emit({"phase": "serve_t2t", "batch": b, "launches": counts,
                  "logits": list(out.logits.shape), "features": list(out.features.shape),
                  "pred_logits": [t.shape[1] for t in out.pred_logits],
                  "first_call_s": round(seconds, 4)})
    phase_check(torch, model, plain, images, outputs, tally, b=B_T2T, phase="serve_t2t")
    return model, plain, images


def train_step_grads(torch, student):
    return {n: p.grad.detach().float().clone() for n, p in student.named_parameters()
            if p.grad is not None}


def phase_train_t2t(torch, dev, tally):
    """Phase 22: three B=128 steps of the pruned T2T-ViT-14 at drop path 0.1
    with its live teacher (PER_T2T_TRAIN_STEP each); finite metrics; every
    trained tensor moves and the frozen ones (the performer's projections
    among them) do not. Step 1 again on the plain model with the same
    weights, draws and kept tokens: its loss and gradients against the
    kernels'. Then the dense t2t_vit_14's forward and backward at B=64 and
    the same rate, kernels against plain. Returns (student, teacher, step,
    images, labels)."""
    import dense2sparse_vit_torch.models.student as student_module
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import label_params

    student, teacher, step = build_t2t_trainer(torch, dev, fused=True)
    p_student, p_teacher, p_step = build_t2t_trainer(torch, dev, fused=False)
    p_student.load_state_dict(student.state_dict())
    p_teacher.load_state_dict(teacher.state_dict())
    images, labels = train_batch(torch, dev)
    groups = label_params(student)
    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    real_topk = student_module.topk_keep_indices
    kept = []

    def record_topk(scores, k):
        kept.append(real_topk(scores, k))
        return kept[-1]

    for s in range(TRAIN_STEPS):
        if s == 0:  # record the kept tokens, for the plain step to replay
            student_module.topk_keep_indices = record_topk
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            metrics = step(images, labels, TRAIN_EPOCH)
            torch.cuda.synchronize()
        finally:
            student_module.topk_keep_indices = real_topk
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != PER_T2T_TRAIN_STEP:
            raise AssertionError(f"train_t2t step {s}: launches {counts}, "
                                 f"expected {PER_T2T_TRAIN_STEP}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        values = {k: v.item() for k, v in metrics.items()}
        bad = [k for k, v in values.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"train_t2t step {s}: non-finite metrics {bad}")
        if s == 0:
            step1 = (values["loss"], train_step_grads(torch, student))
        emit({"phase": "train_t2t", "step": s, "batch": B_TRAIN, "epoch": TRAIN_EPOCH,
              "drop_path_rate": T2T_DROP_PATH, "launches": counts, "metrics": values,
              "seconds": round(seconds, 4)})
    moved = {n: not torch.equal(p, before[n]) for n, p in student.named_parameters()}
    stuck = [n for n, m in moved.items() if groups[n] != "frozen" and not m]
    drifted = [n for n, m in moved.items() if groups[n] == "frozen" and m]
    emit({"phase": "train_t2t", "trained_tensors": sum(groups[n] != "frozen" for n in moved),
          "frozen": sorted(n for n in moved if groups[n] == "frozen"),
          "unchanged": stuck, "frozen_changed": drifted})
    if stuck or drifted:
        raise AssertionError(f"parameters not updated: {stuck}; frozen but changed: {drifted}")

    # step 1 on the plain model: the same weights, draws (seed 11) and kept tokens
    queue = list(kept)
    student_module.topk_keep_indices = lambda sc, k: queue.pop(0)
    try:
        p_values = {k: v.item() for k, v in p_step(images, labels, TRAIN_EPOCH).items()}
    finally:
        student_module.topk_keep_indices = real_topk
    compare_steps(torch, "train_t2t", step1,
                  (p_values["loss"], train_step_grads(torch, p_student)),
                  {n for n in groups if groups[n] != "frozen"})
    del p_student, p_teacher, p_step

    # the dense t2t_vit_14, forward and backward at the same rate (the JAX pin's route)
    x = images[:B_T2T_DENSE]
    runs = []
    for fused in (True, False):
        model = create_model("t2t_vit_14", device=dev,
                             generator=torch.Generator().manual_seed(5), dtype="bfloat16",
                             use_fused_attention=fused, drop_path_rate=T2T_DROP_PATH).train()
        ops.reset_launch_counts()
        logits = model(x, generator=torch.Generator(device=dev).manual_seed(12))
        loss = logits.float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = PER_T2T_DENSE_STEP if fused else NO_LAUNCHES
        if counts != want:
            raise AssertionError(f"dense t2t_vit_14 (fused={fused}): launches {counts}")
        if fused:
            for k, v in counts.items():
                tally.rows[k]["launches"] += v
        runs.append((loss.item(), train_step_grads(torch, model)))
        del model
    compare_steps(torch, "train_t2t_dense", *runs, set(runs[0][1]))
    return student, teacher, step, images, labels


def compare_steps(torch, phase, kernels, plain, names):
    """(loss, grads) of the kernels' run against the plain run's: the loss
    within STEP_LOSS_TOL of its size, the gradients of `names` as one
    vector within STEP_GRAD_TOL (relative L2); each tensor's relative L2
    printed."""
    (k_loss, k_grads), (p_loss, p_grads) = kernels, plain
    names = sorted(n for n in names if n in p_grads)
    per = {n: ((k_grads[n] - p_grads[n]).norm() / p_grads[n].norm().clamp_min(1e-30)).item()
           for n in names}
    diff = torch.stack([(k_grads[n] - p_grads[n]).square().sum() for n in names]).sum().sqrt()
    ref = torch.stack([p_grads[n].square().sum() for n in names]).sum().sqrt()
    grad_rel = (diff / ref).item()
    loss_rel = abs(k_loss - p_loss) / max(abs(p_loss), 1e-30)
    worst = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": phase, "vs_plain": True, "loss": k_loss, "plain_loss": p_loss,
          "loss_rel_err": loss_rel, "grad_rel_l2": grad_rel, "tensors": len(names),
          "worst_tensors_rel_l2": worst, "tol": {"loss": STEP_LOSS_TOL, "grad": STEP_GRAD_TOL}})
    if not (loss_rel <= STEP_LOSS_TOL and grad_rel <= STEP_GRAD_TOL and len(names) > 0):
        raise AssertionError(f"{phase}: kernels vs plain: loss {loss_rel}, gradients {grad_rel}")


def droppath_scales(torch, B, gen):
    from dense2sparse_vit_torch.nn import draw_branch_scales

    return draw_branch_scales(B, DROPPATH_CHECK_RATE, gen)


def check_droppath(torch, dev, student, rec, tally=None):
    """The branch-scale kernels at every scaled block (1-13) of a T2T train
    step's own activations (N = 197, 138, 97, 68; C 384, hidden 1152, no
    qkv bias), with seeded scales in {0, 1/0.7}: the forward stage by stage
    (`check_block`) and the backward (`check_block_backward`) against their
    plain versions; the policy mode too at the first scaled block of each
    width, on a random keep policy. Raises on the first failure."""
    gen = torch.Generator(device=dev).manual_seed(31)
    scale_g = rec["last_g"].float().std().item()
    last = len(student.blocks) - 1
    seen_widths = set()
    with torch.no_grad():
        for i, blk in enumerate(student.blocks):
            if blk.drop_path.rate == 0:
                continue
            x, w = rec["block_in"][i], rec["weights"][i]
            B, N, _ = x.shape
            g = rec["last_g"].contiguous() if i == last else (
                torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
            args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
            scales = droppath_scales(torch, B, gen)
            modes = [None]
            if N not in seen_widths:
                seen_widths.add(N)
                pol = (torch.rand((B, N), generator=gen, device=dev) < 0.6).float()
                pol[:, 0] = 1.0
                modes.append(pol)
            for pol in modes:
                _, f_err = check_block(torch, x, w, *args, block=i, policy=pol,
                                       branch_scales=scales, phase="check_droppath")
                b_err = check_block_backward(torch, x, g, w, *args, block=i, policy=pol,
                                             branch_scales=scales, phase="check_droppath")
                if tally is not None:
                    tally.err("fused_transformer_block[scaled]", f_err)
                    tally.err("fused_transformer_block_backward[scaled]", b_err)


def phase_check_droppath(torch, dev, student, teacher, step, images, labels, tally):
    """Phase 23: `check_droppath` on a captured T2T step; at block 1 the
    kernels with scales of one, both ways, bit-equal to the kernels without
    scales. Returns the captured step for phase 24."""
    from dense2sparse_vit_torch import ops

    rec = capture_train_step(torch, student, teacher, step, images, labels)
    check_droppath(torch, dev, student, rec, tally)
    x, w, blk = rec["block_in"][1], rec["weights"][1], student.blocks[1]
    kw = dict(scale=blk.attn.scale, ln_eps=blk.norm1.eps)
    ones = (x.new_ones(x.shape[0], dtype=torch.float32),) * 2
    g = (torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(32), device=dev)
         * rec["last_g"].float().std()).to(x.dtype)
    with torch.no_grad():
        same_fwd = torch.equal(ops.fused_transformer_block(x, w, blk.attn.num_heads, **kw),
                               ops.fused_transformer_block(x, w, blk.attn.num_heads,
                                                           branch_scales=ones, **kw))
        a = ops.fused_transformer_block_backward(x, g, w, blk.attn.num_heads, **kw)
        b = ops.fused_transformer_block_backward(x, g, w, blk.attn.num_heads,
                                                 branch_scales=ones, **kw)
        same_bwd = torch.equal(a[0], b[0]) and all(
            a[1][k] is None or torch.equal(a[1][k], b[1][k]) for k in a[1])
    emit({"phase": "check_droppath", "block": 1, "shape": list(x.shape),
          "ones_equal_none": {"forward": same_fwd, "backward": same_bwd}})
    if not (same_fwd and same_bwd):
        raise AssertionError("scales of one do not reproduce the unscaled kernels bit for bit")
    return rec


def phase_time_droppath(torch, dev, student, rec, serve, tally, smi):
    """Phase 24: at each width of the T2T step, the block forward and
    backward with scales against the same kernel without them (in turns, on
    the same input) and against the plain version with them; the T2T train
    step with kernels against without, and its stem's forward and backward;
    the B=128 serving forward against plain, and its stem's share."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import (
        transformer_block_backward_reference, transformer_block_reference)

    hidden = student.blocks[0].mlp.fc1.out_features
    gen = torch.Generator(device=dev).manual_seed(33)
    scale_g = rec["last_g"].float().std().item()
    widths = {}
    for i, x in rec["block_in"].items():
        if student.blocks[i].drop_path.rate > 0:
            widths.setdefault(x.shape[1], []).append(i)
    with torch.no_grad():
        for n, idxs in widths.items():
            i = idxs[0]
            x, w, blk = rec["block_in"][i], rec["weights"][i], student.blocks[i]
            B = x.shape[0]
            H, kw = blk.attn.num_heads, dict(scale=blk.attn.scale, ln_eps=blk.norm1.eps)
            args = (H, blk.attn.scale, blk.norm1.eps)
            sc = droppath_scales(torch, B, gen)
            g = (torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
            s_ms, u_ms = paired_ms(
                torch, lambda: ops.fused_transformer_block(x, w, H, branch_scales=sc, **kw),
                lambda: ops.fused_transformer_block(x, w, H, **kw), iters=10)
            p_ms = cuda_ms(torch, lambda: transformer_block_reference(
                x, w, *args, branch_scales=sc), iters=10)
            b = block_bound(B, n, x.shape[2], H, hidden)
            b["bytes_ms"] += 2 * B * 4 / HBM_BYTES_PER_S * 1e3  # the two scale vectors
            tally.add("fused_transformer_block[scaled]", len(idxs), s_ms, p_ms, b)
            emit({"phase": "time_droppath", "kernel": "fused_transformer_block[scaled]",
                  "shape": list(x.shape), "ms": s_ms, "unscaled_ms": u_ms, "plain_ms": p_ms,
                  "bound_ms": max(b.values()), "calls_per_step": len(idxs)})
            s_ms, u_ms = paired_ms(
                torch, lambda: ops.fused_transformer_block_backward(x, g, w, H, branch_scales=sc,
                                                                    **kw),
                lambda: ops.fused_transformer_block_backward(x, g, w, H, **kw),
                iters=3, repeats=3)
            p_ms = cuda_ms(torch, lambda: transformer_block_backward_reference(
                x, g, w, *args, branch_scales=sc), iters=3, repeats=3)
            b = block_backward_bound(B, n, x.shape[2], H, hidden)
            b["bytes_ms"] += 2 * B * 4 / HBM_BYTES_PER_S * 1e3
            tally.add("fused_transformer_block_backward[scaled]", len(idxs), s_ms, p_ms, b)
            emit({"phase": "time_droppath", "kernel": "fused_transformer_block_backward[scaled]",
                  "shape": list(x.shape), "ms": s_ms, "unscaled_ms": u_ms, "plain_ms": p_ms,
                  "bound_ms": max(b.values()), "calls_per_step": len(idxs)})

    # the whole train step, with the kernels and without, and the stem's share
    f_student, _, f_step = build_t2t_trainer(torch, dev, fused=True)
    p_student, p_teacher, p_step = build_t2t_trainer(torch, dev, fused=False)
    p_student.load_state_dict(f_student.state_dict())
    images, labels = train_batch(torch, dev)
    f_ms, p_ms = paired_ms(torch, lambda: f_step(images, labels, TRAIN_EPOCH),
                           lambda: p_step(images, labels, TRAIN_EPOCH), iters=2, repeats=3)
    draws = torch.Generator(device=dev).manual_seed(34)

    def stem_fwd_bwd():
        f_student.embed(images, draws).float().sum().backward()

    f_student.train()
    stem_ms = cuda_ms(torch, stem_fwd_bwd, iters=2, repeats=3)
    emit({"phase": "time_droppath", "train_step": f"B={B_TRAIN} pruned T2T-ViT-14 + teacher, "
          f"drop path {T2T_DROP_PATH}", "kernels_ms": f_ms, "plain_ms": p_ms,
          "kernels_img_per_s": B_TRAIN / f_ms * 1e3, "plain_img_per_s": B_TRAIN / p_ms * 1e3,
          "stem_fwd_bwd_ms": stem_ms, "stem_share": stem_ms / f_ms, "card": smi})
    del f_student, f_step, p_student, p_teacher, p_step

    model, plain, imgs = serve
    x = imgs[B_T2T]
    with torch.inference_mode():
        f_ms, p_ms = paired_ms(torch, lambda: model(x, collect_cls_attns=False),
                               lambda: plain(x, collect_cls_attns=False), iters=5)
        stem_ms = cuda_ms(torch, lambda: model.embed(x), iters=5)
    emit({"phase": "time_droppath", "forward": f"B={B_T2T} pruned T2T-ViT-14",
          "kernels_ms": f_ms, "plain_ms": p_ms, "kernels_img_per_s": B_T2T / f_ms * 1e3,
          "plain_img_per_s": B_T2T / p_ms * 1e3, "stem_ms": stem_ms,
          "stem_share": stem_ms / f_ms, "card": smi})


# ---- the attention half-block and the kernel-timing entry points ----------

# the trainable half-block's forward and backward, in plain and in policy mode
PER_ATTN_BLOCK_TRAINABLE = {**NO_LAUNCHES, "attention_block_forward": 2,
                            "attention_block_backward": 1, "attention_block_backward_policy": 1,
                            **norm_launches(halves=2), **core_launches(2)}
HALF_BLOCK_KEYS = ("ln1_w", "ln1_b", "wqkv", "bqkv", "wproj", "bproj")
# this slice's kernels and the main path that runs them: the launches of the
# kernel_sweep and attn_variants runs (phases 26, 27), each row's time per call
# times its launches; the sweep's launches of earlier slices' kernels are not
# their main paths', and the trainable half-block of phase 25 is a check
SLICE_KERNELS = ("attention_block_forward", "attention_block_backward",
                 "attention_block_backward_policy", "attention_variant")
SWEEP_KERNELS = {"attn_half_fwd": "attention_block_forward",
                 "attn_half_bwd": "attention_block_backward",
                 "attn_half_bwd[policy]": "attention_block_backward_policy"}
# kernel_sweep's rows at its defaults: six kernels at four widths
SWEEP_ROWS = 24


def half_block_bound(B, N, C, H, cls=False, policy=False) -> dict:
    """The half-block forward: qkv and proj (8 B N C^2), QK^T and PV
    (4 B N^2 C); x read, out (and the CLS rows) written, the two matrices,
    LayerNorm and biases read once (and the policy)."""
    M = B * N
    nbytes = 2 * M * C * 2 + 2 * 4 * C * C + 4 * 6 * C
    nbytes += (B * H * N * 2 if cls else 0) + (policy_bytes(B, N) if policy else 0)
    return bound(8 * M * C * C + 4 * B * N * N * C, nbytes)


def half_block_backward_bound(B, N, C, H, policy=False) -> dict:
    """dx and the six gradients from x and g alone: qkv, QK^T and PV
    recomputed, then proj's and qkv's dX and dW and the core's dV, dP, dQ,
    dK; x and g read, dx written, the weights read, the fp32 gradients
    written (and the policy read, dPolicy written)."""
    M = B * N
    flops = 2 * M * 3 * C * C + 4 * B * N * N * C + 4 * M * 4 * C * C + 8 * B * N * N * C
    nbytes = 3 * M * C * 2 + 2 * 4 * C * C + 4 * 5 * C + 4 * (4 * C * C + 6 * C)
    return bound(flops, nbytes + (2 * policy_bytes(B, N) if policy else 0))


def check_attn_half(torch, x, w6, num_heads, scale, ln_eps, block=None, policy=None, eps=1e-6,
                    cls=False, phase="attn_block"):
    """Hold the half-block forward kernel against its plain version, stage
    by stage as `check_block` does the block's: the LN1-qkv projection and
    the attention core (fed the kernel's qkv) within STAGE_TOL; out =
    x + proj(attn) beyond the one bf16 rounding of the sum, relative to the
    branch, within BRANCH_TOL; the whole output against the plain half-block
    within BLOCK_TOL; with `cls`, the CLS rows within STAGE_TOL and their
    sums within ROWSUM_TOL. Prints, raises if a stage is out of tolerance,
    and returns the largest absolute error."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_block_reference
    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm, linear

    ln_w, ln_b, wqkv, bqkv, wproj, bproj = w6
    pol = {} if policy is None else {"policy": policy, "eps": eps}
    res = ops.fused_attention_block(x, *w6, num_heads, scale=scale, ln_eps=ln_eps,
                                    return_cls=cls, stages=True, **pol)
    y, st = res[0], res[-1]
    core = attention_reference(st["qkv"], num_heads, scale, return_cls=cls, **pol)
    plain = {"qkv": linear(layer_norm(x, ln_w, ln_b, ln_eps), wqkv, bqkv),
             "attn": core[0] if cls else core}
    if cls:
        plain["cls"] = core[1]
        st = dict(st, cls=res[1])
    rel = {}
    for name, want in plain.items():
        err, ref = rel_err(torch, st[name], want)
        rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
    if cls:
        rel["cls_rowsum"] = ((res[1].float().sum(-1) - 1).abs().max().item(), ROWSUM_TOL)
    rel["out"] = (branch_excess(y, x, st["attn"], wproj, bproj), BRANCH_TOL)
    err, ref = rel_err(torch, y, attention_block_reference(x, *w6, num_heads, scale=scale,
                                                           ln_eps=ln_eps, **pol))
    rel["block"] = (err / ref, BLOCK_TOL)
    emit({"phase": phase, "kernel": "attention_block_forward" + ("[policy]" if pol else ""),
          "block": block, **({"eps": eps} if pol else {}), "cls": cls, "shape": list(x.shape),
          "max_abs_err": err, "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"block {block}: half-block forward out of tolerance: {bad}")
    return err


def check_attn_half_backward(torch, x, g, w6, num_heads, scale, ln_eps, block=None, policy=None,
                             eps=1e-6, phase="attn_block"):
    """Hold the half-block's backward kernel against autograd through its
    plain version on the same x, g and weights (in policy mode with dPolicy),
    as `hold_gradients` holds the block's."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import (
        ATTN_BLOCK_KEYS, attention_block_backward_reference)

    kw = dict(scale=scale, ln_eps=ln_eps)
    if policy is None:
        dx, *grads = ops.fused_attention_block_backward(x, g, *w6[:5], num_heads, **kw)
        dpol = None
    else:
        dx, dpol, *grads = ops.fused_attention_block_backward_policy(
            x, g, policy, *w6[:5], num_heads, eps=eps, **kw)
    want = attention_block_backward_reference(x, g, *w6[:5], num_heads, policy=policy, eps=eps,
                                              **kw)
    head = {"phase": phase,
            "kernel": "attention_block_backward" + ("" if policy is None else "_policy"),
            "block": block, **({} if policy is None else {"eps": eps}), "shape": list(x.shape)}
    return hold_gradients(torch, head, (dx, dict(zip(ATTN_BLOCK_KEYS, grads)), dpol), want,
                          f"block {block}: half-block backward")


def capture_half_blocks(torch, dev):
    """The headline student's block inputs at B=256 (its first block at each
    width, N = 197, 138, 97, 68) from one eval forward, with those blocks'
    half-block weights, and a threshold student's first keep mask over the
    197 tokens (CLS kept) from the same images: ({N: (block, x, w6)},
    keep policy (256, 197), (heads, scale, ln_eps))."""
    from dense2sparse_vit_torch.models import (
        HEADLINE_KWARGS, HEADLINE_MODEL, THRESHOLD_KWARGS, create_model)

    gen = torch.Generator(device=dev).manual_seed(40)
    images = torch.randn((B_CHECK, 224, 224, 3), generator=gen, device=dev, dtype=torch.bfloat16)
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **HEADLINE_KWARGS).eval()
    seen = {}

    def first_at_its_width(i, x):  # returns None: the block's input stays as it is
        seen.setdefault(x.shape[1], (i, x.detach()))

    handles = [blk.register_forward_pre_hook(lambda m, args, i=i: first_at_its_width(i, args[0]))
               for i, blk in enumerate(model.blocks)]
    # no_grad, not inference_mode: the backward's plain version runs autograd
    with torch.no_grad():
        model(images, collect_cls_attns=False)
        inputs = {}
        for n, (i, x) in seen.items():
            w = model.blocks[i].kernel_weights(torch.bfloat16)
            inputs[n] = (i, x, [None if w[k] is None else w[k].detach().clone()
                                for k in HALF_BLOCK_KEYS])
    for h in handles:
        h.remove()
    blk = model.blocks[0]
    args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
    del model
    model = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                         generator=torch.Generator().manual_seed(0), **THRESHOLD_KWARGS).eval()
    with torch.no_grad():
        mask = model(images, collect_cls_attns=False).keep_masks[0]
    keep = torch.cat([mask.new_ones(B_CHECK, 1), mask], dim=1).float()
    return inputs, keep, args


def half_block_grad(torch, x, dev, seed):
    """A seeded cotangent for a half-block's output: N(0, 0.01^2) in bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(x.shape, generator=gen, device=dev) * 0.01).to(x.dtype)


def phase_attn_block(torch, dev, tally, smi):
    """Phase 25: the attention half-block on the headline student's own
    weights and block inputs at N = 197, 138, 97, 68: the forward (plain;
    policy at eps 1e-6 and 0.1 on a threshold student's keep mask, cut to
    the width; the CLS rows) and the backward (plain; policy with dPolicy at
    both eps) held against their plain versions at B=128; the trainable
    half-block forward and backward through autograd at N=197, its launches
    counted and its dx and dPolicy against the plain version; each kernel
    timed against its plain version (the forward at B=256, the backward at
    B=128), and the packed attention's policy mode beside its plain version
    at B=128 (a threshold keep mask; no torch call computes the eps/N
    policy softmax). The forward is also held at B=256, the batch the
    timing scripts run it at. Returns {(kernel, N): (plain ms, bound)} for
    the half-block's three kernels at the scripts' batches."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import (
        attention_backward_reference, attention_block_backward_reference,
        attention_block_reference)
    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm, linear

    inputs, keep, (H, scale, ln_eps) = capture_half_blocks(torch, dev)
    kw = dict(scale=scale, ln_eps=ln_eps)
    with torch.no_grad():
        for n, (i, x256, w6) in inputs.items():
            x = x256[:B_TRAIN].contiguous()
            pol = keep[:B_TRAIN, :n].contiguous()
            g = half_block_grad(torch, x, dev, 41 + i)
            for xb, pb in ((x, pol), (x256, keep[:, :n].contiguous())):
                f_err = max([check_attn_half(torch, xb, w6, H, scale, ln_eps, block=i),
                             check_attn_half(torch, xb, w6, H, scale, ln_eps, block=i,
                                             cls=True)]
                            + [check_attn_half(torch, xb, w6, H, scale, ln_eps, block=i,
                                               policy=pb, eps=eps) for eps in EPS_CHECKS])
                tally.err("attention_block_forward", f_err)
            tally.err("attention_block_backward",
                      check_attn_half_backward(torch, x, g, w6, H, scale, ln_eps, block=i))
            tally.err("attention_block_backward_policy", max(
                check_attn_half_backward(torch, x, g, w6, H, scale, ln_eps, block=i, policy=pol,
                                         eps=eps) for eps in EPS_CHECKS))

    # the trainable half-block, forward and backward through autograd
    i, x256, w6 = inputs[max(inputs)]
    x = x256[:B_TRAIN].contiguous()
    pol = keep[:B_TRAIN].contiguous()
    g = half_block_grad(torch, x, dev, 49)
    leaves = [t.detach().clone().requires_grad_() for t in (x, *w6)]
    pol_leaf = pol.clone().requires_grad_()
    ops.reset_launch_counts()
    with torch.enable_grad():
        out = ops.fused_attention_block_trainable(leaves[0], *leaves[1:], H, **kw)
        grads = torch.autograd.grad(out, leaves, g)
        out = ops.fused_attention_block_trainable(leaves[0], *leaves[1:], H, pol_leaf, **kw)
        grads_p = torch.autograd.grad(out, leaves + [pol_leaf], g)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with torch.no_grad():
        want_dx = attention_block_backward_reference(x, g, *w6[:5], H, **kw)[0]
        want_p = attention_block_backward_reference(x, g, *w6[:5], H, policy=pol, **kw)
    rel = {}
    for name, got, want in (("dx", grads[0], want_dx), ("dx[policy]", grads_p[0], want_p[0]),
                            ("dpolicy", grads_p[-1], want_p[2])):
        err, ref = rel_err(torch, got, want)
        rel[name] = err / max(ref, 1e-30)
    emit({"phase": "attn_block", "trainable": list(x.shape), "launches": counts,
          "rel_err": rel, "tol_rel": {"dx": BWD_TOL, "dpolicy": DPOL_TOL}})
    if counts != PER_ATTN_BLOCK_TRAINABLE:
        raise AssertionError(f"trainable half-block: launches {counts}, expected "
                             f"{PER_ATTN_BLOCK_TRAINABLE}")
    if not (rel["dx"] <= BWD_TOL and rel["dx[policy]"] <= BWD_TOL and rel["dpolicy"] <= DPOL_TOL):
        raise AssertionError(f"trainable half-block gradients out of tolerance: {rel}")

    # times, at every width
    plain = {}
    with torch.no_grad():
        for n, (i, x256, w6) in inputs.items():
            C = x256.shape[2]
            x = x256[:B_TRAIN].contiguous()
            pol256, pol = keep[:, :n].contiguous(), keep[:B_TRAIN, :n].contiguous()
            g = half_block_grad(torch, x, dev, 41 + i)
            k_ms, p_ms = paired_ms(torch, lambda: ops.fused_attention_block(x256, *w6, H, **kw),
                                   lambda: attention_block_reference(x256, *w6, H, **kw),
                                   iters=10)
            b = half_block_bound(B_CHECK, n, C, H)
            plain["attention_block_forward", n] = (p_ms, b)
            kp_ms, pp_ms = paired_ms(
                torch, lambda: ops.fused_attention_block(x256, *w6, H, pol256, **kw),
                lambda: attention_block_reference(x256, *w6, H, policy=pol256, **kw), iters=10)
            emit({"phase": "attn_block", "kernel": "attention_block_forward",
                  "shape": list(x256.shape), "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": max(b.values()), "policy_ms": kp_ms, "policy_plain_ms": pp_ms,
                  "policy_bound_ms": max(half_block_bound(B_CHECK, n, C, H,
                                                          policy=True).values()),
                  "library_ms": None})
            for name, pl in (("attention_block_backward", None),
                             ("attention_block_backward_policy", pol)):
                if pl is None:
                    fn = lambda: ops.fused_attention_block_backward(x, g, *w6[:5], H, **kw)
                else:
                    fn = lambda: ops.fused_attention_block_backward_policy(x, g, pl, *w6[:5], H,
                                                                           **kw)
                k_ms, p_ms = paired_ms(
                    torch, fn, lambda: attention_block_backward_reference(
                        x, g, *w6[:5], H, policy=pl, **kw), iters=5, repeats=3)
                b = half_block_backward_bound(B_TRAIN, n, C, H, policy=pl is not None)
                plain[name, n] = (p_ms, b)
                emit({"phase": "attn_block", "kernel": name, "shape": list(x.shape), "ms": k_ms,
                      "plain_ms": p_ms, "bound_ms": max(b.values()), "library_ms": None})
            # the packed attention's policy mode (table row 6), on this block's qkv
            qkv = linear(layer_norm(x, w6[0], w6[1], ln_eps), w6[2], w6[3])
            gc = half_block_grad(torch, x, dev, 45 + i)
            k_ms, p_ms = paired_ms(
                torch, lambda: ops.fused_attention_packed(qkv, H, pol, scale=scale,
                                                          return_cls=True),
                lambda: attention_reference(qkv, H, scale, policy=pol, return_cls=True),
                iters=10)
            kb_ms, pb_ms = paired_ms(
                torch, lambda: ops.fused_attention_backward_packed(qkv, gc, H, policy=pol,
                                                                   scale=scale),
                lambda: attention_backward_reference(qkv, gc, H, scale, policy=pol), iters=5,
                repeats=3)
            emit({"phase": "attn_block", "kernel": "packed attention [policy]",
                  "shape": list(qkv.shape), "kept_share": pol.mean().item(),
                  "forward_ms": k_ms, "forward_plain_ms": p_ms,
                  "forward_bound_ms": max(attention_bound(B_TRAIN, n, C, H, cls=True,
                                                          policy=True).values()),
                  "backward_ms": kb_ms, "backward_plain_ms": pb_ms,
                  "backward_bound_ms": max(attention_backward_bound(B_TRAIN, n, C, H,
                                                                    policy=True).values()),
                  "library_ms": None, "card": smi})
    return plain


def phase_kernel_sweep(torch, dev, tally, smi, plain):
    """Phase 26: `scripts.kernel_sweep.main` at its defaults (the attention
    half forward and backward, plain and policy, the MLP half, the block
    both ways, at N = 197, 138, 97, 68), its rows printed as JSON lines; a
    main-path run of the half-block's kernels: each row of theirs adds its
    launches and, per launch, its time, the plain version's at that width
    (`plain`, from phase 25) and the bound to the kernels line."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.scripts import kernel_sweep

    out = _cuda.BUILD_DIR / "kernel_sweep.md"
    ops.reset_launch_counts()
    rows = kernel_sweep.main(["--out", str(out)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for r in rows:
        emit({"phase": "kernel_sweep", **r})
    emit({"phase": "kernel_sweep", "launches": {k: v for k, v in counts.items() if v},
          "card": smi})
    seen = dict.fromkeys(SWEEP_KERNELS.values(), 0)
    for r in rows:
        if r["kernel"] in SWEEP_KERNELS:
            seen[SWEEP_KERNELS[r["kernel"]]] += r["launches"]
    if (len(rows) != SWEEP_ROWS or any(counts[k] == 0 or counts[k] != v for k, v in seen.items())
            or counts["attention_variant"]):
        raise AssertionError(f"kernel_sweep: {len(rows)} rows, launches {counts}, by row {seen}")
    for r in rows:
        if r["kernel"] in SWEEP_KERNELS:
            name = SWEEP_KERNELS[r["kernel"]]
            tally.rows[name]["launches"] += r["launches"]
            tally.add(name, r["launches"], r["ms"], *plain[name, r["N"]])


def check_variant(torch, v, x, params, num_heads):
    """Hold variant v's half-block kernel against its plain version, stage by
    stage: qkv and the attention core (v2: the head-pair algebra, fed the
    kernel's qkv) within STAGE_TOL, out beyond the bf16 rounding of the sum
    within BRANCH_TOL of the branch, the whole output within BLOCK_TOL.
    Returns the largest absolute error."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import (
        attention_variant_reference, paired_attention_reference)
    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm, linear

    ln_w, ln_b, wqkv, bqkv, wproj, bproj = params
    scale = (x.shape[2] // num_heads) ** -0.5
    y, st = ops.fused_attention_variant(v, x, *params, num_heads, stages=True)
    core = paired_attention_reference if v == 2 else attention_reference
    rel = {}
    for name, want in (("qkv", linear(layer_norm(x, ln_w, ln_b, 1e-6), wqkv, bqkv)),
                       ("attn", core(st["qkv"], num_heads, scale))):
        err, ref = rel_err(torch, st[name], want)
        rel[name] = (err / max(ref, 1e-30), STAGE_TOL)
    rel["out"] = (branch_excess(y, x, st["attn"], wproj, bproj), BRANCH_TOL)
    err, ref = rel_err(torch, y, attention_variant_reference(v, x, *params, num_heads))
    rel["block"] = (err / ref, BLOCK_TOL)
    emit({"phase": "attn_variants", "variant": v, "shape": list(x.shape), "max_abs_err": err,
          "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad:
        raise AssertionError(f"attention_variant v{v} N={x.shape[1]}: out of tolerance against "
                             f"its plain version: {bad}")
    return err


def phase_attn_variants(torch, dev, tally, smi, plain=None):
    """Phase 27: `scripts.attn_variants.main` at B=256, C=384, 6 heads,
    N = 197, 138, 97, 68, variants 0-3 (a main-path run of the variants'
    kernels and of the half-block forward, v0, whose launches it counts),
    its rows printed; every variant within STAGE_TOL of v0 in its attention
    core and BLOCK_TOL in its output; then each against its plain version
    (`check_variant`, with its plain time). Each row adds its launches and,
    per launch, its time, the plain version's (v0's from phase 25, `plain`)
    and the bound to the kernels line. With tally None (the planted fault),
    the comparison with v0 alone."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_variant_reference
    from dense2sparse_vit_torch.scripts import attn_variants as av

    ops.reset_launch_counts()
    rows = av.main(["--iters", "20"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for r in rows:
        emit({"phase": "attn_variants", **r})
    emit({"phase": "attn_variants", "launches": {k: v for k, v in counts.items() if v},
          "card": smi})
    ran = [r for r in rows if not r.get("skipped")]
    bad = [f"v{r['variant']} N={r['N']}: core {r['core_rel_vs_v0']}, out {r['out_rel_vs_v0']}"
           for r in ran if not (r["core_rel_vs_v0"] <= STAGE_TOL
                                and r["out_rel_vs_v0"] <= BLOCK_TOL)]
    if bad:
        raise AssertionError("attention variants against v0 out of tolerance: "
                             + "; ".join(f"{b} " for b in bad))
    by_row = {"attention_block_forward": sum(r["launches"] for r in ran if r["variant"] == 0),
              "attention_variant": sum(r["launches"] for r in ran if r["variant"])}
    if (any(counts[k] == 0 or counts[k] != v for k, v in by_row.items())
            or sum(counts.values()) != sum(by_row.values())):
        raise AssertionError(f"attn_variants: launches {counts}, by row {by_row}")
    if tally is None:
        return
    params = av.make_params(av.C, dev)
    with torch.no_grad():
        for r in ran:
            v, n = r["variant"], r["N"]
            if v == 0:
                tally.rows["attention_block_forward"]["launches"] += r["launches"]
                tally.add("attention_block_forward", r["launches"], r["ms"],
                          *plain["attention_block_forward", n])
                continue
            x = av.make_input(av.B, n, av.C, dev)
            tally.err("attention_variant", check_variant(torch, v, x, params, av.HEADS))
            p_ms = cuda_ms(torch, lambda: attention_variant_reference(v, x, *params, av.HEADS),
                           iters=5, repeats=3)
            b = half_block_bound(av.B, n, av.C, av.HEADS)
            tally.rows["attention_variant"]["launches"] += r["launches"]
            tally.add("attention_variant", r["launches"], r["ms"], p_ms, b)
            emit({"phase": "attn_variants", "variant": v, "N": n, "ms": r["ms"],
                  "plain_ms": p_ms, "bound_ms": max(b.values()), "library_ms": None})



# ---- the shared GEMM engine alone -----------------------------------------

# the main path's products, phase 28: (name, N, K, the epilogue's options);
# the forward's four at B=256, N=197 in the (N, K) weight layout, the
# backward's dX products at B=128 in the (K, N) layout (dy = g W2 with
# GELU'(y), dLN2 = dy W1, dO = da Wproj, dLN1 = dqkv Wqkv), then its weight
# gradients dW (I, J) = P^T Q over the B=128 step's rows
GEMM_FWD = (("qkv", 1152, 384, ("ln", "bias")), ("proj", 384, 384, ("bias", "residual")),
            ("fc1", 1536, 384, ("ln", "bias", "gelu")), ("fc2", 384, 1536, ("bias", "residual")))
GEMM_DX = (("dy", 1536, 384, ("gelu_in",)), ("dln2", 384, 1536, ("out_f32",)),
           ("do", 384, 384, ()), ("dln1", 384, 1152, ("out_f32",)))
GEMM_DW = (("dw2", 384, 1536), ("dw1", 1536, 384), ("dwproj", 384, 384), ("dwqkv", 1152, 384))
GEMM_TOL = 1e-2  # one bf16 rounding of the output and the LayerNorm's roundings
WGRAD_TOL = 1e-4  # bf16 products summed in fp32 on both sides, in other orders
# the int8 block's four products at B=256, N=197 (`ops.quant.qgemm`): (name,
# N, K, options): qkv bf16; x_mid = x + proj in fp32; GELU(fc1) bf16; the
# output x_mid + fc2 in bf16
QGEMM_FWD = (("qkv", 1152, 384, ("bias",)), ("proj", 384, 384, ("bias", "residual", "out_f32")),
             ("fc1", 1536, 384, ("bias", "gelu")), ("fc2", 384, 1536, ("bias", "residual_f32")))
# the GEMM kernels the library must hold, as (mode, operand type): the
# engine's three bf16 modes and its int8 GEMM_NK, each with wgmma (HGMMA for
# bf16, IGMMA for int8) and none of the other three tensor-core opcodes
GEMM_KERNELS = {("0", "bf16"): "HGMMA", ("1", "bf16"): "HGMMA", ("2", "bf16"): "HGMMA",
                ("0", "int8"): "IGMMA"}
SASS_OPS = ("HGMMA", "HMMA", "IGMMA", "IMMA")


def gemm_sass(torch, lib_path, holds="gemm_kernel") -> dict:
    """Per GEMM kernel of the built library (every function whose name
    holds `holds`, by default `gemm_kernel`), its wgmma (HGMMA, IGMMA) and
    mma.sync (HMMA, IMMA) instructions, from `cuobjdump -sass`."""
    import subprocess
    from pathlib import Path

    from dense2sparse_vit_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
        elif name is not None and holds in name:
            c = counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
            for word in line.replace(";", " ").split():
                if word.split(".")[0] in c:
                    c[word.split(".")[0]] += 1
    return counts


def gemm_kernel_kind(name: str):
    """(mode, operand type) of a `gemm_kernel<MODE, T>` instantiation from
    its mangled name, T "bf16" or "int8"; None for any other kernel."""
    if "11gemm_kernelILi" not in name:
        return None
    rest = name.split("11gemm_kernelILi")[1]
    typ = rest[2:]
    if typ.startswith("a"):  # int8_t: signed char
        return rest[0], "int8"
    if typ.startswith("13__nv_bfloat16"):
        return rest[0], "bf16"
    return rest[0], typ[:24]


def gemm_sass_faults(counts: dict) -> list:
    """What the GEMM kernels' SASS counts break of GEMM_KERNELS: a kernel
    missing, one more, or one without its wgmma or with another
    tensor-core opcode."""
    kinds = {gemm_kernel_kind(n): n for n in counts}
    faults = [f"missing {k}" for k in GEMM_KERNELS if k not in kinds]
    for name, c in counts.items():
        want = GEMM_KERNELS.get(gemm_kernel_kind(name))
        if want is None:
            faults.append(f"not an engine kernel: {name}")
        elif c[want] == 0 or any(c[op] for op in SASS_OPS if op != want):
            faults.append(f"{name}: {c}")
    return faults


def gemm_inputs(torch, gen, M, N, K, kn, opts):
    """Seeded operands of an `ops.gemm.ln_gemm` call over M rows, the weight
    (K, N) with `kn` else (N, K), with the epilogue options named in `opts`
    ("ln", "bias", "gelu", "relu", "preact", "residual", "row_scale",
    "gelu_in", "out_f32"): (a, w, kwargs, the bytes the call moves)."""
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)

    a = rnd(M, K)
    w = rnd(*((K, N) if kn else (N, K)), scale=K ** -0.5)
    kw = {"out_f32": "out_f32" in opts}
    nbytes = 2 * M * K + 2 * N * K + (4 if kw["out_f32"] else 2) * M * N
    if "ln" in opts:
        kw["ln"] = (1 + rnd(K, scale=0.1, dtype=f32), rnd(K, scale=0.1, dtype=f32), 1e-6)
        nbytes += 8 * K
    if "bias" in opts:
        kw["bias"] = rnd(N, dtype=f32)
        nbytes += 4 * N
    for act in ("gelu", "relu"):
        if act in opts:
            kw["act"] = act
    if "preact" in opts:
        kw["preact"] = True
        nbytes += 2 * M * N
    if "row_scale" in opts and M % 4 == 0:  # one scale for each quarter of the rows
        kw["row_scale"] = torch.rand((4,), generator=gen, device=gen.device) * 2
    for key in ("residual", "gelu_in"):
        if key in opts:
            kw[key] = rnd(M, N)
            nbytes += 2 * M * N
    return a, w, kw, nbytes


def phase_gemm(torch, dev, smi):
    """Phase 28: the GEMM engine alone at the main path's shapes, each
    product held against its plain version and timed (events, graph) beside
    one torch call, the bf16 ones, then the int8 block's (`run_qgemm`); then
    the built library's SASS (`gemm_sass_faults`)."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.ops.gemm import (
        ln_gemm, ln_gemm_reference, weight_grad, weight_grad_reference)

    gen = torch.Generator(device=dev).manual_seed(28)

    def run(name, kind, flops, nbytes, kernel, plain, library, tol):
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            got, want = got[0], want[0]
        err, ref = rel_err(torch, got, want)
        k_ms, p_ms = paired_ms(torch, kernel, plain, iters=10)
        lib_ms = cuda_ms(torch, library, iters=10)
        b = bound(flops, nbytes)
        g_ms, lg_ms = graph_ms(torch, kernel), graph_ms(torch, library)
        emit({"phase": "gemm", "product": name, "kind": kind, "shape": list(got.shape),
              "ms": k_ms, "graph_ms": g_ms, "plain_ms": p_ms, "library_ms": lib_ms,
              "library_graph_ms": lg_ms, "bound_ms": max(b.values()),
              "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
              "tflops": flops / k_ms * 1e-9, "graph_tflops": flops / g_ms * 1e-9,
              "max_abs_err": err, "max_abs_ref": ref, "tol_rel": tol, "card": smi})
        if not err <= tol * ref:
            raise AssertionError(f"gemm {name}: err {err} against {ref}")

    with torch.inference_mode():
        for kind, M, products in (("forward", B_CHECK * 197, GEMM_FWD),
                                  ("dx", B_TRAIN * 197, GEMM_DX)):
            kn = kind == "dx"
            for name, N, K, opts in products:
                a, w, kw, nbytes = gemm_inputs(torch, gen, M, N, K, kn, opts)
                w_lin = w.t() if kn else w  # F.linear's (N, K) view of the same weight
                bias = kw.get("bias")
                run(name, kind, 2 * M * N * K, nbytes,
                    lambda: ln_gemm(a, w, w_kn=kn, **kw),
                    lambda: ln_gemm_reference(a, w, w_kn=kn, **kw),
                    lambda: F.linear(a, w_lin, None if bias is None else bias.to(a.dtype)),
                    GEMM_TOL)
        M = B_TRAIN * 197
        for name, I, J in GEMM_DW:
            p, q = (torch.randn((M, n), generator=gen, device=dev).to(torch.bfloat16)
                    for n in (I, J))
            run(name, "dw", 2 * M * I * J, 2 * M * (I + J) + 4 * I * J,
                lambda: weight_grad(p, q), lambda: weight_grad_reference(p, q),
                lambda: torch.matmul(p.t(), q), WGRAD_TOL)
        for name, N, K, opts in QGEMM_FWD:
            run_qgemm(torch, gen, name, B_CHECK * 197, N, K, opts, smi)
    counts = gemm_sass(torch, _cuda.library()._name)
    emit({"phase": "gemm", "sass": counts})
    faults = gemm_sass_faults(counts)
    if faults:
        raise AssertionError(f"GEMM kernels' SASS: {faults}")


def qgemm_inputs(torch, gen, M, N, K, opts):
    """Seeded operands of an `ops.quant.qgemm` call: codes (M, K) and the
    weight's (N, K) uniform in [-127, 127], row and column scales that put
    the output near unit scale, and the options named in `opts` ("bias",
    "residual" bf16, "residual_f32", "gelu", "out_f32"): (codes, row_s, w_q,
    col_s, kwargs, the bytes the call moves)."""
    dev = gen.device

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    a, w = codes(M, K), codes(N, K)
    row_s = (torch.rand((M,), generator=gen, device=dev) + 0.5) * (4 / 127)
    col_s = (torch.rand((N,), generator=gen, device=dev) + 0.5) * (0.1 / 127 / (K / 384) ** 0.5)
    out_f32 = "out_f32" in opts
    kw = {"gelu": "gelu" in opts, "out_dtype": torch.float32 if out_f32 else torch.bfloat16}
    nbytes = M * K + N * K + 4 * (M + N) + (4 if out_f32 else 2) * M * N
    if "bias" in opts:
        kw["bias"] = torch.randn((N,), generator=gen, device=dev)
        nbytes += 4 * N
    for key, dtype in (("residual", torch.bfloat16), ("residual_f32", torch.float32)):
        if key in opts:
            kw["residual"] = torch.randn((M, N), generator=gen, device=dev).to(dtype)
            nbytes += kw["residual"].element_size() * M * N
    return a, row_s, w, col_s, kw, nbytes


def qgemm_bound(M, N, K, nbytes) -> dict:
    """An int8 product: 2MNK operations at the int8 rate; its bytes."""
    return {"ops_ms": 2 * M * N * K / INT8_OPS_PER_S * 1e3,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def run_qgemm(torch, gen, name, M, N, K, opts, smi):
    """One int8 product of phase 28: the kernel against its plain version
    (bit-equal; through GELU within one bf16 rounding, INT8_ULP_TOL beyond
    it), then timed by events and from a CUDA graph beside torch._int_mm on
    the same codes (the int32 product alone)."""
    from dense2sparse_vit_torch.ops.quant import qgemm, qgemm_reference

    a, row_s, w, col_s, kw, nbytes = qgemm_inputs(torch, gen, M, N, K, opts)
    kernel = lambda: qgemm(a, row_s, w, col_s, **kw)  # noqa: E731
    plain = lambda: qgemm_reference(a, row_s, w, col_s, **kw)  # noqa: E731
    got, want = kernel(), plain()
    equal = bool(torch.equal(got, want))
    excess = ulp_excess(got, want)
    k_ms, p_ms = paired_ms(torch, kernel, plain, iters=10)
    g_ms = graph_ms(torch, kernel)
    lib = {"library_ms": None, "library_graph_ms": None}
    w_t = w.t()
    try:
        torch._int_mm(a, w_t)
        lib = {"library_ms": cuda_ms(torch, lambda: torch._int_mm(a, w_t), iters=10),
               "library_graph_ms": graph_ms(torch, lambda: torch._int_mm(a, w_t))}
    except RuntimeError as e:  # the card's build may refuse a shape
        lib["library_refused"] = str(e)[:300]
    b = qgemm_bound(M, N, K, nbytes)
    ops = 2 * M * N * K
    emit({"phase": "gemm", "product": name, "kind": "int8", "shape": [M, N, K], "ms": k_ms,
          "graph_ms": g_ms, "plain_ms": p_ms, **lib, "bound_ms": max(b.values()),
          "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
          "tops": ops / k_ms * 1e-9, "graph_tops": ops / g_ms * 1e-9,
          "bit_equal": equal, "ulp_excess": excess, "gelu": kw["gelu"], "card": smi})
    if not (equal or (kw["gelu"] and excess <= INT8_ULP_TOL)):
        raise AssertionError(f"qgemm {name}: bit-equal {equal}, beyond one bf16 rounding {excess}")


# ---- 29. the LayerNorm backward and the bias column sums ------------------

# dx's fp32 copy, relative to its largest magnitude, and a column sum (d_ln_w,
# d_ln_b, a bias gradient), relative to the sum of its terms' magnitudes:
# fp32 sums in other orders on both sides
LN_TOL = 1e-5
SUM_TOL = 1e-5
FP32_FLOPS_PER_S = 67e12  # the H100 SXM's fp32 rate outside the tensor cores


def norm_inputs(torch, x, g, w, num_heads, scale, ln_eps):
    """The inputs of a block backward's two LayerNorm backwards and four bias
    sums at a block's input x and output cotangent g, from plain torch
    autograd through the block's forward (plain mode, no branch scales):
    {"ln": {"ln2": (dy, x_mid, stats, ln2_w, g: the residual, fp32_copy),
            "ln1": (dy, x, stats, ln1_w, dx_mid fp32, fp32_copy)},
     "sums": {"g": g, "dy": fc1's cotangent, "dqkv": qkv's, "da": dx_mid fp32},
     "wgrad": {name: (P, Q)} of the three weight gradients the bf16 sums ride on}.
    The LayerNorms' cotangents enter in fp32, as the kernel's GEMMs give them."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch.ops import norm
    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm, linear

    B, N, C = x.shape
    rows = lambda t: t.reshape(B * N, -1).contiguous()  # noqa: E731
    with torch.enable_grad():
        h1 = layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps).requires_grad_()
        qkv = linear(h1, w["wqkv"], w["bqkv"])
        qkv_l = qkv.detach().requires_grad_()
        attn = attention_reference(qkv_l, num_heads, scale)
        attn_l = attn.detach().requires_grad_()
        branch = linear(attn_l, w["wproj"], w["bproj"])
        mid = (x + branch).detach()
        h2 = layer_norm(mid, w["ln2_w"], w["ln2_b"], ln_eps).requires_grad_()
        pre = linear(h2, w["w1"], w["b1"])
        pre_l = pre.detach().requires_grad_()
        hid = F.gelu(pre_l.float()).to(x.dtype)
        hid_l = hid.detach().requires_grad_()
        (dhid,) = torch.autograd.grad(linear(hid_l, w["w2"], w["b2"]), hid_l, g)
        (dy,) = torch.autograd.grad(hid, pre_l, dhid)
        (dln2,) = torch.autograd.grad(pre, h2, dy)
        st2 = norm.ln_stats(mid, ln_eps)
        ln2 = (rows(dln2).float(), rows(mid), st2, w["ln2_w"], rows(g), True)
        dmid_b, dmid_f, _, _ = norm.ln_backward_reference(*ln2[:5], fp32_copy=True)
        (dattn,) = torch.autograd.grad(branch, attn_l, dmid_b.reshape(B, N, C))
        (dqkv,) = torch.autograd.grad(attn, qkv_l, dattn)
        (dln1,) = torch.autograd.grad(qkv, h1, dqkv)
    ln1 = (rows(dln1).float(), rows(x), norm.ln_stats(x, ln_eps), w["ln1_w"], dmid_f, False)
    return {"ln": {"ln2": ln2, "ln1": ln1},
            "sums": {"g": rows(g), "dy": rows(dy), "dqkv": rows(dqkv), "da": dmid_f},
            "wgrad": {"w2": (rows(g), rows(hid)), "w1": (rows(dy), rows(h2.detach())),
                      "wqkv": (rows(dqkv), rows(h1.detach()))}}


def capture_norm_cases(torch, dev):
    """One B=128 top-k train step's own activations at the first block of
    each width (N = 197, 138, 97, 68; the real output cotangent at the last
    block, a seeded one of its scale at the others, as
    `check_block_backwards`): [(N, block backwards at that width, inputs)]."""
    student, teacher, step = build_trainer(torch, dev, fused=True)
    images, labels = train_batch(torch, dev)
    rec = capture_train_step(torch, student, teacher, step, images, labels)
    gen = torch.Generator(device=dev).manual_seed(29)
    scale_g = rec["last_g"].float().std().item()
    widths = {}
    for i, x in rec["block_in"].items():
        widths.setdefault(x.shape[1], []).append(i)
    cases = []
    for n, idxs in widths.items():
        i = idxs[-1]
        x, blk = rec["block_in"][i], student.blocks[i]
        g = rec["last_g"].contiguous() if i == len(student.blocks) - 1 else (
            torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
        inputs = norm_inputs(torch, x, g, rec["weights"][i], blk.attn.num_heads,
                             blk.attn.scale, blk.norm1.eps)
        cases.append((n, len(idxs), inputs))
    return cases


def check_ln_bwd(torch, case, n, which):
    """Hold the LayerNorm backward kernel against its plain version on one
    call's inputs: dx's fp32 copy within LN_TOL, its bf16 dx that copy
    rounded, d_ln_w and d_ln_b within SUM_TOL; returns dx's largest error."""
    from dense2sparse_vit_torch.ops import norm

    dy, x, st, ln_w, res, _ = case
    dx, dx_f, d_w, d_b = norm.ln_backward(dy, x, st, ln_w, res, fp32_copy=True)
    _, want_f, want_w, want_b = norm.ln_backward_reference(dy, x, st, ln_w, res, fp32_copy=True)
    err, ref = rel_err(torch, dx_f, want_f)
    rounded = bool(torch.equal(dx, dx_f.to(torch.bfloat16)))
    z = (x.float() - st[:, :1]) * st[:, 1:]
    sums = {k: ((got - want).abs() / (terms.abs().sum(0) + 1e-30)).max().item()
            for k, got, want, terms in (("d_ln_w", d_w, want_w, dy * z),
                                        ("d_ln_b", d_b, want_b, dy))}
    emit({"phase": "norm", "kernel": "ln_bwd", "call": which, "shape": list(x.shape), "N": n,
          "dx_rel_err": err / ref, "bf16_dx_rounded": rounded, "sum_rel_err": sums,
          "tol": {"dx": LN_TOL, "sums": SUM_TOL}})
    if not (err <= LN_TOL * ref and rounded and all(v <= SUM_TOL for v in sums.values())):
        raise AssertionError(f"ln_bwd N={n} {which}: dx {err / ref}, bf16 dx the rounded fp32 "
                             f"dx {rounded}, sums {sums}")
    return err


def check_column_sums(torch, a, n, name):
    """Hold the column-sum kernel against its plain version: each column
    within SUM_TOL of the sum of its terms' magnitudes; returns the largest
    error."""
    from dense2sparse_vit_torch.ops import norm

    got, want = norm.column_sums(a), norm.column_sums_reference(a)
    errs = (got - want).abs()
    rel = (errs / (a.float().abs().sum(0) + 1e-30)).max().item()
    emit({"phase": "norm", "kernel": "column_sums", "tensor": name, "shape": list(a.shape),
          "dtype": str(a.dtype), "N": n, "rel_err": rel, "tol": SUM_TOL})
    if not rel <= SUM_TOL:
        raise AssertionError(f"column_sums N={n} {name} {tuple(a.shape)}: {rel}")
    return errs.max().item()


def check_folded_sums(torch, p, q, n, name):
    """The bias sums folded into the weight gradient: db within SUM_TOL of
    the plain column sums, dW the bits of the product without them."""
    from dense2sparse_vit_torch.ops.gemm import weight_grad

    dw, db = weight_grad(p, q, bias=True)
    same = bool(torch.equal(dw, weight_grad(p, q)))
    rel = ((db - p.float().sum(0)).abs() / (p.float().abs().sum(0) + 1e-30)).max().item()
    emit({"phase": "norm", "kernel": "wgrad+bias", "weight": name, "shape": list(p.shape),
          "N": n, "db_rel_err": rel, "dw_bits_unchanged": same, "tol": SUM_TOL})
    if not (rel <= SUM_TOL and same):
        raise AssertionError(f"wgrad bias sums N={n} {name}: {rel}, dW unchanged {same}")


def check_norm(torch, cases, tally=None):
    """Every check of phase 29 on the captured cases."""
    for n, _, inputs in cases:
        for which, case in inputs["ln"].items():
            err = check_ln_bwd(torch, case, n, which)
            if tally is not None:
                tally.err("ln_bwd", err)
        for name, a in inputs["sums"].items():
            err = check_column_sums(torch, a, n, name)
            if tally is not None and name == "da":
                tally.err("column_sums", err)
        for name, (p, q) in inputs["wgrad"].items():
            check_folded_sums(torch, p, q, n, name)


def ln_bwd_bound(M, C, res_bytes, fp32_copy) -> dict:
    """dy (fp32), x and the residual read, dx written (bf16, and fp32 with
    the copy), the row statistics and gamma read, d_ln_w and d_ln_b written;
    ~12 fp32 operations an element."""
    nbytes = M * C * (4 + 2 + res_bytes + 2 + (4 if fp32_copy else 0)) + 8 * M + 12 * C
    return {"ops_ms": 12 * M * C / FP32_FLOPS_PER_S * 1e3,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def sums_bound(a) -> dict:
    M, N = a.shape
    return {"ops_ms": M * N / FP32_FLOPS_PER_S * 1e3,
            "bytes_ms": (M * N * a.element_size() + 4 * N) / HBM_BYTES_PER_S * 1e3}


def phase_norm(torch, dev, tally, smi):
    """Phase 29: the LayerNorm backward and the bias column sums on the B=128
    top-k step's own activations at N = 197, 138, 97, 68, C = 384: each held
    against its plain version (`check_norm`: both LayerNorm backwards of a
    block backward, the column-sum kernel on g, dy, dqkv in bf16 and da in
    fp32, the bias sums folded into the three weight gradients), then timed
    beside its plain version, one torch call and its bound: the LayerNorm
    backward beside torch.ops.aten.native_layer_norm_backward (dy, x and
    gamma in fp32, x widened outside the timing; no residual add), the
    column sums beside a.sum(0, dtype=torch.float32), the folded sums as
    the weight gradient's time with them less its time without. Times by
    CUDA events and from a CUDA graph; the kernels line takes the graph's
    (on the main path the block backward launches both kernels from its C
    entry, without the standalone wrappers' host cost, which the events'
    times of these ~10-60 us calls carry)."""
    from dense2sparse_vit_torch.ops import norm
    from dense2sparse_vit_torch.ops.gemm import weight_grad

    def timed(kernel, plain, library):
        k_ms, p_ms = paired_ms(torch, kernel, plain, iters=20)
        return {"ms": k_ms, "graph_ms": graph_ms(torch, kernel), "plain_ms": p_ms,
                "plain_graph_ms": graph_ms(torch, plain),
                "library_ms": cuda_ms(torch, library, iters=20),
                "library_graph_ms": graph_ms(torch, library)}

    cases = capture_norm_cases(torch, dev)
    with torch.no_grad():
        check_norm(torch, cases, tally)
        step = dict.fromkeys(("ln_bwd", "ln_bwd_plain", "ln_bwd_library", "ln_bwd_bound",
                              "column_sums", "column_sums_plain", "column_sums_library",
                              "column_sums_bound", "folded_sums", "bf16_sums_standalone",
                              "bf16_sums_library", "bf16_sums_bound"), 0.0)
        for n, calls, inputs in cases:
            pair = {"k": 0.0, "p": 0.0, "l": 0.0, "b": {"ops_ms": 0.0, "bytes_ms": 0.0}}
            for which, (dy, x, st, ln_w, res, fp32_copy) in inputs["ln"].items():
                M, C = x.shape
                xf, mean, rstd = x.float(), st[:, :1].contiguous(), st[:, 1:].contiguous()
                zeros = torch.zeros_like(ln_w)
                t = timed(lambda: norm.ln_backward(dy, x, st, ln_w, res, fp32_copy),
                          lambda: norm.ln_backward_reference(dy, x, st, ln_w, res, fp32_copy),
                          lambda: torch.ops.aten.native_layer_norm_backward(
                              dy, xf, [C], mean, rstd, ln_w, zeros, [True, True, True]))
                b = ln_bwd_bound(M, C, res.element_size(), fp32_copy)
                emit({"phase": "norm", "kernel": "ln_bwd", "call": which, "shape": [M, C],
                      "N": n, "fp32_copy": fp32_copy, "residual": str(res.dtype), **t,
                      "bound_ms": max(b.values()), "calls_per_step": calls, "card": smi})
                pair["k"] += t["graph_ms"]
                pair["p"] += t["plain_graph_ms"]
                pair["l"] += t["library_graph_ms"]
                pair["b"] = {k: pair["b"][k] + b[k] for k in b}
            tally.add("ln_bwd", calls, pair["k"], pair["p"], pair["b"], pair["l"])
            step["ln_bwd"] += calls * pair["k"]
            step["ln_bwd_plain"] += calls * pair["p"]
            step["ln_bwd_library"] += calls * pair["l"]
            step["ln_bwd_bound"] += calls * max(pair["b"].values())
            for name, a in inputs["sums"].items():
                t = timed(lambda: norm.column_sums(a), lambda: norm.column_sums_reference(a),
                          lambda: a.sum(0, dtype=torch.float32))
                b = sums_bound(a)
                emit({"phase": "norm", "kernel": "column_sums", "tensor": name,
                      "shape": list(a.shape), "dtype": str(a.dtype), "N": n, **t,
                      "bound_ms": max(b.values()), "card": smi})
                if name == "da":  # the main path's column-sum launch: dbproj
                    tally.add("column_sums", calls, t["graph_ms"], t["plain_graph_ms"], b,
                              t["library_graph_ms"])
                    step["column_sums"] += calls * t["graph_ms"]
                    step["column_sums_plain"] += calls * t["plain_graph_ms"]
                    step["column_sums_library"] += calls * t["library_graph_ms"]
                    step["column_sums_bound"] += calls * max(b.values())
                else:
                    step["bf16_sums_standalone"] += calls * t["graph_ms"]
                    step["bf16_sums_library"] += calls * t["library_graph_ms"]
                    step["bf16_sums_bound"] += calls * max(b.values())
            for name, (p, q) in inputs["wgrad"].items():
                without, with_ = [], []
                for _ in range(2):  # in turns: without, with, with, without
                    without.append(graph_ms(torch, lambda: weight_grad(p, q)))
                    with_.append(graph_ms(torch, lambda: weight_grad(p, q, bias=True)))
                    with_.append(graph_ms(torch, lambda: weight_grad(p, q, bias=True)))
                    without.append(graph_ms(torch, lambda: weight_grad(p, q)))
                w_ms, wo_ms = statistics.median(with_), statistics.median(without)
                step["folded_sums"] += calls * (w_ms - wo_ms)
                emit({"phase": "norm", "kernel": "wgrad+bias", "weight": name,
                      "shape": list(p.shape), "N": n, "graph_ms": w_ms,
                      "without_bias_graph_ms": wo_ms, "card": smi})
    emit({"phase": "norm", "per_step_graph_ms": step, "card": smi})


# ---- 30. the attention core's backward alone --------------------------------

# attention_bwd_kernel's instantiations: (policy mode, query blocks a warpgroup),
# each with one CTA a sample-head and split (the long path)
ATTN_BWD_KERNELS = ((False, 1), (False, 3), (True, 1), (True, 3))


def attn_bwd_kind(name: str):
    """(policy mode, query blocks a warpgroup) of an `attention_bwd_kernel<
    POLICY, QPW, SPLIT>` instantiation from its mangled name; None for
    another."""
    if "attention_bwd_kernelILb" not in name:
        return None
    rest = name.split("attention_bwd_kernelILb")[1]  # e.g. "1ELi2EE..."
    return rest[0] == "1", int(rest[4])


def attn_bwd_sass_faults(counts: dict) -> list:
    """What the attention core backward's SASS counts break: each of its
    four kinds of instantiation present, each with wgmma (HGMMA); mma.sync (HMMA)
    in the policy-mode ones alone, whose scores stay on mma.sync for the
    tie test (the kernel's notes); no int8 opcode."""
    kinds = {attn_bwd_kind(n): n for n in counts}
    faults = [f"missing {k}" for k in ATTN_BWD_KERNELS if k not in kinds]
    for name, c in counts.items():
        kind = attn_bwd_kind(name)
        if kind not in ATTN_BWD_KERNELS:
            faults.append(f"not an instantiation: {name}")
        elif c["HGMMA"] == 0 or c["IGMMA"] or c["IMMA"] or (c["HMMA"] and not kind[0]):
            faults.append(f"{name}: {c}")
    return faults


def attn_bwd_inputs(torch, x, g, w, num_heads, scale, ln_eps, policy=None, eps=1e-6):
    """The attention core backward's inputs inside a block backward at a
    block's input x and output cotangent g, from plain torch autograd
    through the block's forward (no branch scales): (qkv (B, N, 3C), dO
    (B, N, C), the cotangent of the attention output)."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch.ops.block import attention_reference, layer_norm, linear

    kw = {} if policy is None else {"policy": policy, "eps": eps}
    with torch.enable_grad():
        qkv = linear(layer_norm(x, w["ln1_w"], w["ln1_b"], ln_eps), w["wqkv"], w["bqkv"])
        attn = attention_reference(qkv.detach(), num_heads, scale, **kw).requires_grad_()
        mid = x + linear(attn, w["wproj"], w["bproj"])
        pre = linear(layer_norm(mid, w["ln2_w"], w["ln2_b"], ln_eps), w["w1"], w["b1"])
        out = mid + linear(F.gelu(pre.float()).to(x.dtype), w["w2"], w["b2"])
        (dattn,) = torch.autograd.grad(out, attn, g)
    return qkv.detach().contiguous(), dattn.contiguous()


def capture_attn_bwd_cases(torch, dev):
    """Phase 30's cases, from three B=128 train steps' own activations, each
    {"what", "block", "qkv", "g" (the attention output's cotangent), "heads",
    "scale", "policy", "gcls", "eps"}: "topk" at every block of a top-k step
    (the real output cotangent at the last block, a seeded one of its scale
    at the others, as `check_block_backwards`); "threshold" at the first
    and the last policy block of a threshold step with its keep policy, and
    "ties" at the first on planted exact ties (`planted_ties`), each at
    every eps of EPS_CHECKS; "gcls" at the attn step's blocks whose CLS rows
    rank a stage, with the step's g and gcls."""
    cases = []
    for mode in ("topk", "threshold"):
        student, teacher, step = build_trainer(torch, dev, fused=True, mode=mode)
        images, labels = train_batch(torch, dev)
        rec = capture_train_step(torch, student, teacher, step, images, labels)
        gen = torch.Generator(device=dev).manual_seed(30)
        scale_g = rec["last_g"].float().std().item()
        last = len(student.blocks) - 1
        policy_blocks = [i for i in range(last + 1) if rec["policy"][i] is not None]
        for i, blk in enumerate(student.blocks):
            x = rec["block_in"][i]
            g = rec["last_g"].contiguous() if i == last else (
                torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
            w, H, scale = rec["weights"][i], blk.attn.num_heads, blk.attn.scale
            ln_eps = blk.norm1.eps
            base = {"block": i, "heads": H, "scale": scale, "gcls": None}
            if mode == "topk":
                qkv, do = attn_bwd_inputs(torch, x, g, w, H, scale, ln_eps)
                cases.append({**base, "what": "topk", "qkv": qkv, "g": do, "policy": None,
                              "eps": 1e-6})
                continue
            if i not in (policy_blocks[0], policy_blocks[-1]):
                continue
            pol = rec["policy"][i].float().contiguous()
            inputs = [("threshold", x)]
            if i == policy_blocks[0]:
                x_tie, tied = planted_ties(torch, x, w, H, scale, ln_eps)
                emit({"phase": "attn_bwd", "planted_ties": {"block": i, "tied_rows": tied}})
                inputs.append(("ties", x_tie))
            for what, xx in inputs:
                for eps in EPS_CHECKS:
                    qkv, do = attn_bwd_inputs(torch, xx, g, w, H, scale, ln_eps, pol, eps)
                    cases.append({**base, "what": what, "qkv": qkv, "g": do, "policy": pol,
                                  "eps": eps})
        del student, teacher, step, rec
    student, teacher, step = build_trainer(torch, dev, fused=True, mode="attn")
    images, labels = train_batch(torch, dev)
    rec = capture_attn_step(torch, step, images, labels)
    for i in ATTN_STAGE_FEEDERS:
        e = rec["attn"][i]
        cases.append({"what": "gcls", "block": i, "qkv": e["qkv"], "g": e["g"],
                      "heads": e["heads"], "scale": e["scale"], "policy": None,
                      "gcls": e["gcls"], "eps": 1e-6})
    return cases


def check_attn_bwd(torch, case):
    """Hold the attention core's backward kernel, launched by `ops.fused_
    attention_backward_packed` (the main path's packed backward: the forward
    core recomputed, then the kernel, then dPolicy's head sum), against its
    plain version, `attention_backward_reference`: dqkv's q, k and v apart
    within BWD_TOL and dPolicy within DPOL_TOL, each relative to its largest
    magnitude; a second call on the same inputs bit-equal in dqkv and
    dPolicy. Prints the relative errors, raises naming what is out of
    tolerance, and returns the largest absolute error."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_backward_reference

    qkv, g, H, scale = case["qkv"], case["g"], case["heads"], case["scale"]
    pol, gcls, eps = case["policy"], case["gcls"], case["eps"]
    kw = {} if pol is None else {"policy": pol, "eps": eps}
    with torch.no_grad():
        runs = [ops.fused_attention_backward_packed(qkv, g, H, gcls=gcls, scale=scale, **kw)
                for _ in range(2)]
        want = attention_backward_reference(qkv, g, H, scale, gcls=gcls, **kw)
    (dqkv, dpol), (dqkv2, dpol2) = [r if pol is not None else (r, None) for r in runs]
    rel = {}
    worst = _thirds(torch, "dqkv", dqkv, want[0], rel)
    if pol is not None:
        err, ref = rel_err(torch, dpol, want[1])
        rel["dpolicy"] = (err / max(ref, 1e-30), DPOL_TOL)
    same = bool(torch.equal(dqkv, dqkv2)) and (dpol is None or bool(torch.equal(dpol, dpol2)))
    n = qkv.shape[1]
    emit({"phase": "attn_bwd", "case": case["what"], "block": case["block"], "N": n,
          "shape": list(qkv.shape), "eps": None if pol is None else eps,
          "gcls": gcls is not None, "rel_err": {k: r for k, (r, _) in rel.items()},
          "tol_rel": {k: t for k, (_, t) in rel.items()}, "bit_equal": same})
    bad = {k: r for k, (r, t) in rel.items() if not r <= t}
    if bad or not same:
        raise AssertionError(f"attn_bwd {case['what']} block {case['block']} N={n}: out of "
                             f"tolerance {bad}; two launches bit-equal: {same}")
    return worst


def check_attn_bwd_cases(torch, cases, tally=None):
    """`check_attn_bwd` at every case; the largest error into the tally."""
    worst = max(check_attn_bwd(torch, c) for c in cases)
    if tally is not None:
        tally.err("attention_bwd", worst)


def phase_attn_bwd(torch, dev, tally, smi):
    """Phase 30: the attention core's backward kernel (attention_bwd_kernel)
    through `ops.fused_attention_backward_packed`, which launches it alone
    besides the forward recompute. Checks at every case of
    `capture_attn_bwd_cases` (`check_attn_bwd`: plain mode at every block of
    a top-k step; policy mode with dPolicy at a threshold step's blocks and
    on planted ties, eps 1e-6 and 0.1; the CLS fold at an attn step's
    stage-feeding blocks) and the built library's SASS
    (`attn_bwd_sass_faults`); then, at N = 197, 138, 97, 68 on the top-k
    step's last block of each width, and at N=197 in policy mode (with
    dPolicy) and with the fold, times the kernel by the profiler's device
    time inside the packed backward (`checkout_ab.device_ms`: the device ms
    per call of each kernel, over 10 calls), and from CUDA graphs the whole
    packed backward, the plain version and, in plain mode,
    scaled_dot_product_attention's backward (its forward and backward less
    its forward); each beside `attention_backward_bound`. The kernels line
    takes the device time and the graph times: none of them holds the
    host's launch cost."""
    from dense2sparse_vit_torch.ops import _cuda

    counts = gemm_sass(torch, _cuda.library()._name, holds="attention_bwd_kernel")
    emit({"phase": "attn_bwd", "sass": counts})
    faults = attn_bwd_sass_faults(counts)
    if faults:
        raise AssertionError(f"attn_bwd SASS: {faults}")
    cases = capture_attn_bwd_cases(torch, dev)
    check_attn_bwd_cases(torch, cases, tally)

    step = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    widths = {}
    for c in cases:
        if c["what"] == "topk":
            widths.setdefault(c["qkv"].shape[1], []).append(c)
    for n, cs in widths.items():
        c = cs[-1]
        qkv, g, H, scale = c["qkv"], c["g"], c["heads"], c["scale"]
        B, N, C3 = qkv.shape
        t = attn_bwd_times(torch, c)
        lib_ms, lib_fwd_bwd_ms, lib_fwd_ms = sdpa_backward_ms(torch, qkv, g, H, scale)
        b = attention_backward_bound(B, N, C3 // 3, H)
        tally.add("attention_bwd", len(cs), t["ms"], t["plain_ms"], b, lib_ms)
        step["ms"] += len(cs) * t["ms"]
        step["plain_ms"] += len(cs) * t["plain_ms"]
        step["library_ms"] += len(cs) * lib_ms
        step["bound_ms"] += len(cs) * max(b.values())
        emit({"phase": "attn_bwd", "kernel": "attention_bwd", "mode": "plain",
              "shape": list(qkv.shape), **t, "library_ms": lib_ms,
              "library_fwd_bwd_ms": lib_fwd_bwd_ms, "library_fwd_ms": lib_fwd_ms,
              "bound_ms": max(b.values()),
              "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
              "calls_per_step": len(cs), "card": smi})
    for what in ("threshold", "gcls"):
        c = next(c for c in cases if c["what"] == what)
        B, N, C3 = c["qkv"].shape
        b = attention_backward_bound(B, N, C3 // 3, c["heads"], gcls=c["gcls"] is not None,
                                     policy=c["policy"] is not None)
        emit({"phase": "attn_bwd", "kernel": "attention_bwd", "mode": what,
              "block": c["block"], "eps": c["eps"], "shape": [B, N, C3], **attn_bwd_times(torch, c),
              "bound_ms": max(b.values()), "card": smi})
    emit({"phase": "attn_bwd", "per_topk_step": step, "card": smi})


def attn_bwd_times(torch, case) -> dict:
    """The attention core backward on a case of `capture_attn_bwd_cases`'s
    form: the kernel's device ms per call by the profiler inside
    `ops.fused_attention_backward_packed` (`checkout_ab.device_ms`; on the
    long path attention_bwd_kernel and its reduce_kv_kernel), the whole
    packed backward and the plain version from CUDA graphs."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops import attention as att
    from dense2sparse_vit_torch.scripts.checkout_ab import ATTN_BWD_GROUPS, device_ms

    qkv, g, H, scale = case["qkv"], case["g"], case["heads"], case["scale"]
    pol, gcls = case["policy"], case["gcls"]
    kw = {} if pol is None else {"policy": pol, "eps": case["eps"]}
    packed = lambda: ops.fused_attention_backward_packed(  # noqa: E731
        qkv, g, H, gcls=gcls, scale=scale, **kw)
    with torch.no_grad():
        dev_ms = device_ms(packed, groups=ATTN_BWD_GROUPS)
        return {"ms": dev_ms["attention_bwd_kernel"] + dev_ms["reduce_kv"], "device_ms": dev_ms,
                "packed_graph_ms": graph_ms(torch, packed),
                "plain_ms": graph_ms(torch, lambda: att.attention_backward_reference(
                    qkv, g, H, scale, gcls=gcls, **kw), iters=5)}


def sdpa_backward_ms(torch, qkv, g, H, scale):
    """scaled_dot_product_attention's backward on the same q, k, v and
    output cotangent, from CUDA graphs: (forward and backward less the
    forward, forward and backward, forward) ms."""
    import torch.nn.functional as F

    q, k, v, g4 = sdpa_inputs(torch, qkv, g, H)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(q, k, v, scale=scale)
        torch.autograd.grad(o, (q, k, v), g4)

    fwd_bwd = graph_ms(torch, sdpa_fwd_bwd)
    with torch.no_grad():
        fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    return fwd_bwd - fwd, fwd_bwd, fwd


# ---- 31. the score predictor alone ------------------------------------------


def phase_predictor(torch, dev, pred_cases, tally, smi):
    """Phase 31: the score predictor's kernel alone, on the three stages'
    own inputs from phase 3 (the spatial tokens x[:, 1:] at B=256, N = 196,
    137, 96), with the headline student's small predictors and with a
    seeded large one (`checkout_ab.seeded_predictor`: matrices N(0,
    1/fan_in), LayerNorm scales 1 +- 0.1, biases 0.1 N(0, 1)): held against
    both plain versions
    with two launches bit-equal (`check_predictor`), then timed by the
    profiler's device time (`checkout_ab.device_ms`, over 10 calls) and
    from a CUDA graph, beside the plain version and the plain split form
    (CUDA graphs) and `predictor_bound` (the function's work unsplit, as
    the table's row 3 has always counted it). The kernels line takes the
    small predictor's device time and plain graph time."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.predictor import (
        predictor_lg_reference, predictor_lg_split_reference)
    from dense2sparse_vit_torch.scripts.checkout_ab import device_ms, seeded_predictor

    large = seeded_predictor(pred_cases[0][0].shape[2], False, 31, dev).kernel_weights(
        torch.bfloat16)
    with torch.inference_mode():
        for kind in ("small", "large"):
            for i, (xs, small) in enumerate(pred_cases):
                w = small if kind == "small" else large
                check_predictor(torch, xs, w, f"{kind} stage {i}", "predictor")
                fn = lambda: ops.fused_predictor_lg(xs, w)  # noqa: E731
                dev_ms = device_ms(fn, groups=("predictor_kernel",))
                t = {"ms": dev_ms["predictor_kernel"], "device_ms": dev_ms,
                     "graph_ms": graph_ms(torch, fn),
                     "plain_ms": graph_ms(torch, lambda: predictor_lg_reference(xs, w), iters=5),
                     "split_plain_ms": graph_ms(
                         torch, lambda: predictor_lg_split_reference(xs, w), iters=5)}
                b = predictor_bound(*xs.shape, w)
                if kind == "small":
                    tally.add("fused_predictor_lg", 1, t["ms"], t["plain_ms"], b)
                emit({"phase": "predictor", "kernel": "fused_predictor_lg", "predictor": kind,
                      "stage": i, "shape": list(xs.shape), **t, "bound_ms": max(b.values()),
                      "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
                      "card": smi})


# ---- 32. the training entry point: CLI -> run_experiment --------------------

LOOP_CLASSES, LOOP_IMAGES, LOOP_SIDES = 12, 60, (256, 400)  # 720 JPEGs: 576 train, 144 val
LOOP_BATCH, LOOP_WORKERS, LOOP_STEPS = 128, 2, 4
# the headline student through the CLI, with the default recipe (RandAugment,
# random erasing 0.25, mixup 0.8, cutmix 1.0); the backbone trains from
# epoch 1
LOOP_FLAGS = ("--arch deit_small --dtype bfloat16 --pruning-locs 3 6 9 --keep-ratios 0.7 0.49 "
              "0.343 --small-predictor --topk-selection --use-fused-attention --batch-size 128 "
              "--warmup-steps 1 --seed 0").split()
# a cached step: PER_TRAIN_STEP without the teacher's 12 CLS-row blocks
PER_CACHED_TRAIN_STEP = {**PER_TRAIN_STEP, "fused_transformer_block_cls": 0}
LOOP_EVAL_ROWS = (128, 16)  # the valid rows of each eval batch (the second padded by 112)
# a cached step's loss against a live-teacher step's on the same batch and
# weights, relative: the cache stores the teacher's rows in bf16
CACHE_LOSS_TOL = 1e-2
BARE_STEPS = 5


def write_image_folder(root, classes=LOOP_CLASSES, images=LOOP_IMAGES, sides=LOOP_SIDES,
                       seed=0) -> int:
    """A class-per-folder JPEG set from a numpy seed: `classes` folders of
    `images` images, each side in [sides[0], sides[1]]; returns the count."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c:02d}")
        os.makedirs(d, exist_ok=True)
        for i in range(images):
            h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
            # smooth colour fields plus noise: JPEG-like content, not pure noise
            base = rng.integers(0, 256, (1, 1, 3)).astype(np.float32)
            ramp = np.linspace(0, 1, w, dtype=np.float32)[None, :, None] * rng.integers(
                -128, 128, (1, 1, 3)).astype(np.float32)
            noise = rng.normal(0, 24, (h, w, 3)).astype(np.float32)
            arr = np.clip(base + ramp + noise, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:04d}.jpg"), quality=90)
    return classes * images


def loop_config(root, *extra):
    """(cfg, args) of the CLI for LOOP_FLAGS + `extra` over `root`, with
    LOOP_WORKERS decode processes (the CLI has no flag for them)."""
    from dense2sparse_vit_torch import cli

    cfg, args = cli.parse_config([*LOOP_FLAGS, "--imgnet-val-dir", root, *extra])
    return cfg.replace(data=cfg.data.replace(num_workers=LOOP_WORKERS)), args


class Preempted(Exception):
    """Raised in place of a train step, as a preempted job stops."""


SYNC_WARNING = "called a synchronizing CUDA operation"


class LoopSpy:
    """Wraps the training loop's step factories: per train step the kernel
    launches it made (and, with `track`, whether any parameter of the
    student moved), per eval step its launches and valid rows. With
    `stop_after`, the train step after that many raises Preempted. With
    `count_syncs`, every train step and the loop's per-step finish of the
    batch (normalize, random erasing, mixup) run under
    torch.cuda.set_sync_debug_mode("warn"), and `syncs` counts the
    synchronizing operations it reports there."""

    def __init__(self, torch, track=False, stop_after=None, count_syncs=False):
        self.torch, self.track, self.stop_after = torch, track, stop_after
        self.count_syncs, self.syncs, self.sync_sites = count_syncs, 0, {}
        self.steps, self.moved, self.evals, self.valid = [], [], [], []

    def __enter__(self):
        from dense2sparse_vit_torch import ops
        from dense2sparse_vit_torch.train import loop

        self.loop, self.ops = loop, ops
        names = ("make_train_step", "make_eval_step", "device_normalize",
                 "device_random_erasing", "Mixup")
        self.saved = {n: getattr(loop, n) for n in names}
        loop.make_train_step = self._train(self.saved["make_train_step"])
        loop.make_eval_step = self._eval(self.saved["make_eval_step"])
        if self.count_syncs:
            loop.device_normalize = self._synced(self.saved["device_normalize"])
            loop.device_random_erasing = self._synced(self.saved["device_random_erasing"])
            spy, mixup = self, self.saved["Mixup"]

            class CountedMixup(mixup):
                def __call__(self, *args):
                    return spy._synced(super().__call__)(*args)
            loop.Mixup = CountedMixup
        return self

    def _synced(self, fn):
        import warnings

        def run(*args, **kw):
            if not self.count_syncs:
                return fn(*args, **kw)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                self.torch.cuda.set_sync_debug_mode("warn")
                try:
                    return fn(*args, **kw)
                finally:
                    self.torch.cuda.set_sync_debug_mode(0)
                    for w in caught:
                        if SYNC_WARNING in str(w.message):
                            self.syncs += 1
                            site = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
                            self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
        return run

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.loop, n, fn)

    def _delta(self, before):
        after = self.ops.launch_counts()
        return {k: after[k] - before[k] for k in after}

    def _train(self, real):
        def build(student, *a, **k):
            step = real(student, *a, **k)

            def counted(*args, **kw):
                if self.stop_after is not None and len(self.steps) >= self.stop_after:
                    raise Preempted(f"after {self.stop_after} steps")
                prev = ([p.detach().clone() for p in student.parameters()]
                        if self.track else None)
                before = self.ops.launch_counts()
                out = self._synced(step)(*args, **kw)
                self.steps.append(self._delta(before))
                if self.track:
                    self.moved.append(any(not self.torch.equal(p, q)
                                          for p, q in zip(student.parameters(), prev)))
                return out
            return counted
        return build

    def _eval(self, real):
        def build(*a, **k):
            step = real(*a, **k)

            def counted(images, labels):
                before = self.ops.launch_counts()
                out = step(images, labels)
                self.evals.append(self._delta(before))
                self.valid.append(int((labels >= 0).sum()))
                return out
            return counted
        return build


def loop_records(workdir) -> list:
    import os

    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def check_loop_metrics(records, what) -> None:
    """Every logged number finite."""
    bad = [(r["step"], k) for r in records for k, v in r.items()
           if isinstance(v, float) and (v != v or abs(v) == float("inf"))]
    if bad or not records:
        raise AssertionError(f"{what}: non-finite metrics {bad[:8]} ({len(records)} records)")


def check_step_launches(deltas, expected, what) -> None:
    """Each step's launches per kernel equal `expected`."""
    bad = [(i, d) for i, d in enumerate(deltas) if d != expected]
    if bad or not deltas:
        raise AssertionError(f"{what}: steps {[i for i, _ in bad]} launched "
                             f"{bad[0][1] if bad else None}, expected {expected} "
                             f"({len(deltas)} steps)")


def compare_states(torch, a: dict, b: dict) -> dict:
    """Two state_dicts: their keys equal, and per tensor the max abs
    difference; bit_equal where every tensor is equal bit for bit."""
    if set(a) != set(b):
        raise AssertionError(f"state_dict keys differ: {sorted(set(a) ^ set(b))[:8]}")
    diffs = {k: (a[k].float() - b[k].float()).abs().max().item() if a[k].numel() else 0.0
             for k in a if not torch.equal(a[k], b[k])}
    return {"bit_equal": not diffs, "differ": sorted(diffs),
            "max_abs_diff": max(diffs.values(), default=0.0)}


def check_resume(torch, straight: dict, resumed: dict, best: tuple) -> dict:
    """The last checkpoints of a straight run and of a resumed one: the
    student's parameters bit for bit, the optimizer's update count, its
    moments and the micro-step count equal, and the best metrics `best`
    (straight, resumed) equal."""
    student = compare_states(torch, straight["student"], resumed["student"])
    sa, sb = straight["optimizer"], resumed["optimizer"]
    moments = compare_states(
        torch, {f"{i}.{k}": v for i, s in sa["state"].items() for k, v in s.items()},
        {f"{i}.{k}": v for i, s in sb["state"].items() for k, v in s.items()})
    out = {"student": student, "moments": moments,
           "count": (sa["schedule"]["count"], sb["schedule"]["count"]),
           "step": (straight["step"], resumed["step"]), "best_metric": best}
    if (not student["bit_equal"] or not moments["bit_equal"] or out["count"][0] != out["count"][1]
            or out["step"][0] != out["step"][1] or best[0] != best[1]):
        raise AssertionError(f"the resumed run differs from the straight one: {out}")
    return out


def host_decode_ms(torch, cfg, reps=2) -> dict:
    """In-process ms per LOOP_BATCH batch: JPEG decode with the train
    transform (RandomResizedCrop, flip, RandAugment) and with the eval view."""
    from dense2sparse_vit_torch.data import ImageFolder, eval_transform, train_transform
    from dense2sparse_vit_torch.data.pipeline import _load_batch

    out = {}
    for name, tf in (("train", train_transform(cfg.data, as_uint8=True)),
                     ("eval", eval_transform(cfg.data, normalize=False))):
        ds = ImageFolder(cfg.data.imgnet_val_dir, tf)
        times = []
        for r in range(reps):
            t0 = time.perf_counter()
            _load_batch(range(r * LOOP_BATCH, (r + 1) * LOOP_BATCH), 0, 0, ds)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def bare_step_img_per_s(torch, dev) -> float:
    """Phase 5's `build_trainer`: the headline train step on a resident B=128
    batch, wall clock per step over BARE_STEPS steps after one."""
    student, teacher, step = build_trainer(torch, dev, fused=True)
    images, labels = train_batch(torch, dev)
    step(images, labels, TRAIN_EPOCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BARE_STEPS):
        step(images, labels, TRAIN_EPOCH)
    torch.cuda.synchronize()
    return BARE_STEPS * B_TRAIN / (time.perf_counter() - t0)


def cached_step_against_live(torch, dev, cfg, root) -> dict:
    """One cached and one live-teacher step from the same weights on the
    same eval-view batch (the loop's seeds): their losses within
    CACHE_LOSS_TOL, relative, and the cached step's launches
    PER_CACHED_TRAIN_STEP."""
    import copy

    import numpy as np

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import DiffPruningStudent, ViTTeacher
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step
    from dense2sparse_vit_torch.train.teacher_cache import make_teacher_outputs_fn

    seed = cfg.train.seed
    xb, yb = host_batch(torch, cfg, root, dev, "train")
    student = DiffPruningStudent(cfg.model, cfg.pruning).init_weights(
        torch.Generator().manual_seed(seed)).to(dev)
    teacher = ViTTeacher(cfg.model).init_weights(torch.Generator().manual_seed(seed + 1)).to(dev)
    rows = make_teacher_outputs_fn(teacher, cfg)(xb)
    losses, counts = {}, {}
    for mode in ("cached", "live"):
        s = copy.deepcopy(student)
        step = make_train_step(s, teacher, make_optimizer(s, cfg.train, LOOP_STEPS), cfg,
                               cached_teacher=mode == "cached")
        ops.reset_launch_counts()
        m = step(xb, yb, cfg.train.warmup_epochs, teacher_in=rows if mode == "cached" else None,
                 generator=torch.Generator(device=dev).manual_seed(0))
        counts[mode] = ops.launch_counts()
        losses[mode] = {k: v.item() for k, v in m.items()}
    rel = abs(losses["cached"]["loss"] - losses["live"]["loss"]) / abs(losses["live"]["loss"])
    out = {"loss": {k: v["loss"] for k, v in losses.items()}, "rel_diff": rel,
           "tol_rel": CACHE_LOSS_TOL,
           "token_kl": {k: v["token_kl_loss"] for k, v in losses.items()}}
    if counts["cached"] != PER_CACHED_TRAIN_STEP or counts["live"] != PER_TRAIN_STEP:
        raise AssertionError(f"cached/live step launches {counts}")
    if not np.isfinite(rel) or rel > CACHE_LOSS_TOL:
        raise AssertionError(f"cached step's loss against the live one's: {out}")
    return out


def phase_train_loop(torch, dev, tally, smi):
    """Phase 32: the training entry point, `cli.parse_config` ->
    `train.loop.run_experiment`, on the headline student at B=128 with
    LOOP_WORKERS spawned decode processes, over a synthetic JPEG folder
    (`write_image_folder`: 576 train and 144 val images after the 80/20
    split). Runs: (a) the default recipe with --epochs 3, preempted after
    2 epochs of 4 steps (`LoopSpy`'s stop_after: the step that would be the
    ninth raises); (e, f) --eval-only with --export-serving on (a)'s
    workdir; (b) --resume of the third epoch there, against (b') a straight
    3-epoch run; (c)
    --teacher-cache without mixup and cutmix; (d) --grad-accum-steps 2.
    The main path's launches are (a)'s, whose steps and per-step batch
    finish must make no synchronizing CUDA operation (`LoopSpy`). Returns
    (the temporary directory, the folder's root), for phase 33; the caller
    cleans the directory up."""
    import os
    import tempfile

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.data import device_normalize
    from dense2sparse_vit_torch.models import DiffPruningStudent
    from dense2sparse_vit_torch.train.loop import run_experiment
    from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager
    from dense2sparse_vit_torch.utils.serving import ServingModel

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_loop_")
    root = os.path.join(tmp.name, "images")
    t0 = time.perf_counter()
    n = write_image_folder(root, LOOP_CLASSES, LOOP_IMAGES, LOOP_SIDES)
    emit({"phase": "train_loop", "images": n, "classes": LOOP_CLASSES, "sides": LOOP_SIDES,
          "decode": "PIL JPEG", "write_seconds": round(time.perf_counter() - t0, 3)})
    cfg, _ = loop_config(root)
    decode = host_decode_ms(torch, cfg)
    emit({"phase": "train_loop", "host_decode_ms_per_batch": decode, "batch": LOOP_BATCH,
          "card": smi})
    bare = bare_step_img_per_s(torch, dev)
    torch.cuda.empty_cache()

    def run(name, extra=(), track=False, expect_step=PER_TRAIN_STEP, stop_after=None,
            count_syncs=False):
        cfg, args = loop_config(root, *extra)
        workdir = os.path.join(tmp.name, name)
        seen = len(loop_records(workdir)) if os.path.exists(workdir) else 0
        ops.reset_launch_counts()
        t = time.perf_counter()
        summary = "preempted"
        with LoopSpy(torch, track, stop_after, count_syncs) as spy:
            try:
                summary = run_experiment(cfg, workdir, device=dev,
                                         resume=args.resume or args.eval_only,
                                         eval_only=args.eval_only,
                                         export_serving=args.export_serving)
            except Preempted:
                if stop_after is None:
                    raise
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        records = loop_records(workdir)[seen:]
        check_loop_metrics(records, name)
        rates = [r["time/train_img_per_s"] for r in records if "time/train_img_per_s" in r]
        emit({"phase": "train_loop", "run": name, "flags": list(extra),
              "seconds": round(time.perf_counter() - t, 3), "summary": summary,
              "train_steps": len(spy.steps), "params_moved": spy.moved,
              "syncs_in_steps": spy.syncs if count_syncs else None,
              "eval_valid_rows": spy.valid, "train_img_per_s": rates, "launches": counts,
              "card": smi})
        k = len(LOOP_EVAL_ROWS)
        if not spy.valid or any(tuple(spy.valid[i:i + k]) != LOOP_EVAL_ROWS
                                for i in range(0, len(spy.valid), k)):
            raise AssertionError(f"{name}: eval valid rows {spy.valid}, expected {LOOP_EVAL_ROWS}"
                                 " per eval")
        check_step_launches(spy.evals, PER_EVAL_STEP["topk"], f"{name} eval")
        if not args.eval_only:
            check_step_launches(spy.steps, expect_step, f"{name} train")
        return workdir, spy, counts, rates, summary

    # (a) the default recipe, a 3-epoch run preempted after its second
    # epoch: the main path's launches
    a_dir, spy, counts, rates_a, _ = run("default", ("--epochs", "3"),
                                         stop_after=2 * LOOP_STEPS, count_syncs=True)
    if len(spy.steps) != 2 * LOOP_STEPS or len(spy.valid) != 2 * len(LOOP_EVAL_ROWS):
        raise AssertionError(f"default recipe: {len(spy.steps)} steps, evals {spy.valid}")
    if spy.syncs:
        raise AssertionError(f"default recipe: {spy.syncs} synchronizing operations in the "
                             f"steps and the batch finish, at {spy.sync_sites}")
    for stream in ("best", "latest"):
        if not os.listdir(os.path.join(a_dir, "ckpt", stream)):
            raise AssertionError(f"default recipe: no checkpoint in {stream}/")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    # (e, f) --eval-only and --export-serving on (a)'s workdir: the artifact
    # against the best checkpoint's live model on one val batch
    export_dir = os.path.join(tmp.name, "serving")
    run("default", ("--eval-only", "--export-serving", export_dir))
    best = CheckpointManager(os.path.join(a_dir, "ckpt")).restore_best(map_location=dev)
    live = DiffPruningStudent(cfg.model, cfg.pruning).to(dev)
    live.load_state_dict(best["student"])
    live.eval()
    images, _ = host_batch(torch, cfg, root, dev)
    x = device_normalize(images, cfg.data)
    with torch.no_grad():
        want = live(x.to(torch.bfloat16), collect_cls_attns=False).logits.float()
    got = ServingModel.load(export_dir)(x)
    err, scale = rel_err(torch, got, want)
    top1 = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    emit({"phase": "train_loop", "export": export_dir.rsplit("/", 1)[-1],
          "bit_equal": bool(torch.equal(got, want)), "top1_equal": top1, "max_abs_err": err,
          "max_abs_ref": scale, "tol_rel": LOGITS_TOL})
    if got.shape != want.shape or not top1 or err > LOGITS_TOL * max(scale, 1e-3):
        raise AssertionError(f"served logits differ from the best checkpoint's (max err {err})")
    del live, best
    # (b) its third epoch by --resume, against a straight 3-epoch run
    _, spy_r, _, _, _ = run("default", ("--epochs", "3", "--resume"))
    s_dir, _, _, _, _ = run("straight", ("--epochs", "3"))
    resumed = CheckpointManager(os.path.join(a_dir, "ckpt"))
    straight = CheckpointManager(os.path.join(s_dir, "ckpt"))
    res = check_resume(torch, straight.restore(map_location="cpu"),
                       resumed.restore(map_location="cpu"),
                       (straight.best_metric, resumed.best_metric))
    emit({"phase": "train_loop", "resume": res, "resumed_steps": len(spy_r.steps)})
    if len(spy_r.steps) != LOOP_STEPS:
        raise AssertionError(f"the resumed run took {len(spy_r.steps)} steps")
    torch.cuda.empty_cache()
    # (c) the frozen-teacher cache: resident, no teacher block in a step
    _, spy_c, _, rates_c, summary_c = run(
        "teacher_cache", ("--epochs", "2", "--teacher-cache", "--mixup", "0", "--cutmix", "0"),
        expect_step=PER_CACHED_TRAIN_STEP)
    if not summary_c["train_device_resident"] or len(spy_c.steps) != 2 * LOOP_STEPS:
        raise AssertionError(f"teacher cache: {summary_c}, {len(spy_c.steps)} steps")
    emit({"phase": "train_loop", "cached_against_live": cached_step_against_live(
        torch, dev, loop_config(root, "--teacher-cache", "--mixup", "0", "--cutmix", "0")[0],
        root)})
    # (d) gradient accumulation: an update every second micro-step
    d_dir, spy_d, _, _, _ = run("grad_accum", ("--epochs", "1", "--grad-accum-steps", "2"),
                                track=True)
    last = CheckpointManager(os.path.join(d_dir, "ckpt")).restore(map_location="cpu")
    count = last["optimizer"]["schedule"]["count"]
    emit({"phase": "train_loop", "grad_accum": 2, "micro_steps": last["step"],
          "updates": count, "params_moved": spy_d.moved})
    if (last["step"] != LOOP_STEPS or count != LOOP_STEPS // 2
            or spy_d.moved != [i % 2 == 1 for i in range(LOOP_STEPS)]):
        raise AssertionError(f"grad accumulation: {last['step']} micro-steps, {count} updates, "
                             f"moved {spy_d.moved}")
    emit({"phase": "train_loop", "batch": LOOP_BATCH, "workers": LOOP_WORKERS,
          "loop_train_img_per_s": {"default": rates_a, "teacher_cache": rates_c},
          "bare_step_img_per_s": bare, "host_decode_ms_per_batch": decode, "card": smi})
    return tmp, root


# ---- 33. the student's other modes ------------------------------------------

# the modes, each one B=128 train step with the live teacher (twice: the
# second timed) and one B=MODE_EVAL_BATCH eval step: name -> (model,
# create_model's arguments beside HEADLINE_KWARGS' or DINO_KWARGS', epoch).
# soft_topk is the JAX zoo's config 5 (`dino_small_student`: the large
# predictor, perturbed top-k at nS=500) at epoch 0 (sigma 0.05, the warmup);
# remat's student has drop path 0.1, so that its recompute must repeat the
# forward's draws
MODE_EVAL_BATCH = 256
SOFT_SAMPLES = 500
MODE_DROP_PATH = 0.1


def mode_specs():
    from dense2sparse_vit_torch.models import DINO_KWARGS, DINO_MODEL, HEADLINE_KWARGS, HEADLINE_MODEL

    head = dict(HEADLINE_KWARGS, use_fused_attention=True)
    return {
        "soft_topk": (DINO_MODEL, dict(DINO_KWARGS, topk_num_samples=SOFT_SAMPLES), 0),
        "random": (HEADLINE_MODEL, dict(head, selection="random"), TRAIN_EPOCH),
        "cls_from_teacher": (HEADLINE_MODEL, dict(head, cls_from_teacher=True), TRAIN_EPOCH),
        "predictor_bn": (HEADLINE_MODEL, dict(head, predictor_bn=True), TRAIN_EPOCH),
        "early_exit": (HEADLINE_MODEL, dict(head, early_exit=True), TRAIN_EPOCH),
        "dropout": (HEADLINE_MODEL, dict(head, drop_rate=0.1), TRAIN_EPOCH),
        "remat": (HEADLINE_MODEL, dict(head, remat=True, drop_path_rate=MODE_DROP_PATH),
                  TRAIN_EPOCH),
        "attn_block0": (HEADLINE_MODEL, dict(head, selection="attn", pruning_locs=(0, 6, 9)),
                        TRAIN_EPOCH),
    }


# per train step: the teacher's 12 CLS-row blocks and, by mode: the
# top-k step's kernels (random, teacher-CLS, BatchNorm and early exit
# score without a kernel: the predictors train through their plain layers);
# soft top-k gathers by the indicator's product, so no gather or scatter;
# dropout leaves the whole block for the packed attention core both ways and
# the plain MLP (JAX `nn/layers.py:225-253`); remat runs the forward twice
# (the recompute), blocks 1-11 with their branch scales; attn at 0/6/9 is
# the attn student's step (its stage-0 predictor trains plainly)
PER_MODE_TRAIN_STEP = {
    "soft_topk": {**PER_TRAIN_STEP, "fused_gather_tokens": 0, "fused_scatter_tokens": 0},
    "random": PER_TRAIN_STEP,
    "cls_from_teacher": PER_TRAIN_STEP,
    "predictor_bn": PER_TRAIN_STEP,
    "early_exit": PER_TRAIN_STEP,
    "dropout": {**NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_attention_packed": 12,
                "fused_attention_backward_packed": 12, "fused_gather_tokens": 3,
                "fused_scatter_tokens": 3, **core_launches(12)},
    "remat": {**NO_LAUNCHES, "fused_transformer_block_cls": 12, "fused_transformer_block": 2,
              "fused_transformer_block[scaled]": 22, "fused_transformer_block_backward": 1,
              "fused_transformer_block_backward[scaled]": 11, "fused_gather_tokens": 6,
              "fused_scatter_tokens": 3, **norm_launches(12), **core_launches(12)},
    "attn_block0": PER_ATTN_TRAIN_STEP,
}
# per eval step: the top-k eval step's, without the predictor kernel where
# a stage scores without the LayerNorm predictor (random and teacher-CLS
# selection, the BatchNorm predictor: JAX `nn/predictor.py:141-146`); the
# attn student captures its CLS rows in both forwards and scores stage 0
# with its predictor
PER_MODE_EVAL_STEP = {
    **{m: PER_EVAL_STEP["topk"] for m in ("soft_topk", "early_exit", "dropout", "remat")},
    **{m: {**PER_EVAL_STEP["topk"], "fused_predictor_lg": 0}
       for m in ("random", "cls_from_teacher", "predictor_bn")},
    "attn_block0": {**NO_LAUNCHES, "fused_transformer_block_cls": 36, "fused_predictor_lg": 1,
                    "fused_gather_tokens": 3},
}
# the gradients phase 33 holds against the plain step: the predictors', the
# early-exit head's and blocks 0, 3 and 11's
MODE_GRAD_BLOCKS = (0, 3, 11)
# the perturbed top-k backward against float64 (the same formula on the
# same z and indices), relative to its largest magnitude: fp32 sums of
# nS k products against float64 ones
SOFT_BWD_TOL = 1e-5
# remat's gradients against the same step without remat: the recompute
# repeats the forward's kernels on the same draws
REMAT_TOL = 1e-6
# a BatchNorm student's eval scores of one image alone against its row in a
# batch of 8 (the running statistics: the same, up to the kernels' bf16
# rounding at another batch)
BN_EVAL_TOL = STAGE_TOL
# CLI epochs over phase 32's folder: (flags, per train step, per eval step)
MODE_CLI_RUNS = (
    (("--random-drop", "--early-exit", "--predictor-bn"), PER_TRAIN_STEP,
     {**PER_EVAL_STEP["topk"], "fused_predictor_lg": 0}),
    (("--cls-from-teacher",), PER_TRAIN_STEP, {**PER_EVAL_STEP["topk"], "fused_predictor_lg": 0}),
)


def check_mode_launches(counts, expected, what) -> None:
    """A mode's launches per kernel equal `expected`: a kernel launched fewer
    times ran its plain version (or nothing) where the mode's path takes it."""
    if counts != expected:
        diff = {k: (counts.get(k, 0), v) for k, v in expected.items() if counts.get(k, 0) != v}
        raise AssertionError(f"{what}: launches (got, expected) {diff}")


def check_soft_topk_backward(torch, x, z, sigma, k, g) -> float:
    """The perturbed top-k's gradient (`PerturbedTopK`, on x's device)
    against the estimator (1/(nS sigma)) sum_n sum_j 1[idx = d] g[b,j,d]
    z[b,n,d] in float64, on the same indices (the top-k of x + sigma z),
    summed by index_put_ with accumulation as the JAX function's scatter-add
    sums them; returns the relative error, raises beyond SOFT_BWD_TOL."""
    from dense2sparse_vit_torch.ops.perturbed_topk import PerturbedTopK, topk_sample_indices

    x = x.detach().float().requires_grad_()
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).clamp_min(1e-12)
    PerturbedTopK.apply(x, z, sig, k).backward(g)
    B, nS, N = z.shape
    idx = topk_sample_indices(x.detach()[:, None, :] + sig * z, k)  # (B, nS, k)
    g64 = g.double()
    g_sel = torch.gather(g64, 2, idx.transpose(1, 2)).transpose(1, 2)  # g[b, j, idx[b, n, j]]
    contrib = g_sel * torch.gather(z.double(), 2, idx) / (nS * sig.double())
    b_ix = torch.arange(B, device=x.device).view(B, 1, 1).expand_as(idx)
    want = torch.zeros((B, N), dtype=torch.float64, device=x.device)
    want.index_put_((b_ix, idx), contrib, accumulate=True)
    err = ((x.grad.double() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    emit({"phase": "student_modes", "check": "soft_topk_backward", "shape": [B, nS, N],
          "k": k, "rel_err": err, "tol_rel": SOFT_BWD_TOL})
    if not err <= SOFT_BWD_TOL:
        raise AssertionError(f"soft_topk_backward: {err} against float64")
    return err


def check_remat(torch, remat_grads, plain_grads) -> dict:
    """Every gradient of the remat step against the step without remat,
    relative to the tensor's largest magnitude, within REMAT_TOL."""
    rel = {n: ((remat_grads[n] - plain_grads[n]).abs().max()
               / plain_grads[n].abs().max().clamp_min(1e-30)).item() for n in plain_grads}
    bit_equal = all(torch.equal(remat_grads[n], plain_grads[n]) for n in plain_grads)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    emit({"phase": "student_modes", "check": "remat", "tensors": len(rel), "bit_equal": bit_equal,
          "worst": worst, "tol_rel": REMAT_TOL})
    bad = {n: r for n, r in rel.items() if not r <= REMAT_TOL}
    if bad or set(remat_grads) != set(plain_grads) or not rel:
        raise AssertionError(f"remat gradients differ from the plain step's: {worst}")
    return {"bit_equal": bit_equal, "worst": worst}


def check_bn_eval(torch, student, images) -> float:
    """A BatchNorm student in eval mode normalises with its running
    statistics: stage 0's scores of one image alone equal its row in a
    batch of 8 within BN_EVAL_TOL (batch statistics of one image's tokens
    move them by their own size). Returns the relative error."""
    student.eval()
    with torch.no_grad():
        batch = student(images[:8], collect_cls_attns=False).pred_logits[0][:1].float()
        alone = student(images[:1], collect_cls_attns=False).pred_logits[0].float()
    err, ref = rel_err(torch, alone, batch)
    emit({"phase": "student_modes", "check": "bn_eval", "rel_err": err / max(ref, 1e-30),
          "tol_rel": BN_EVAL_TOL})
    if not err <= BN_EVAL_TOL * max(ref, 1e-30):
        raise AssertionError(f"bn_eval: one image's scores move with its batch ({err} of {ref})")
    return err / max(ref, 1e-30)


def mode_grad_names(names) -> set:
    keep = tuple(f"blocks.{i}." for i in MODE_GRAD_BLOCKS) + ("score_predictor.",
                                                            "early_exit_head.")
    return {n for n in names if n.startswith(keep)}


def build_mode(torch, dev, mode, fused, teacher):
    """The mode's student (kernels or plain versions, the same seeded
    weights), its optimizer at the mode's epoch and its train step with
    `teacher`: (student, step, cfg, epoch)."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    name, kwargs, epoch = mode_specs()[mode]
    student = create_model(name, device=dev, generator=torch.Generator().manual_seed(0),
                           **dict(kwargs, use_fused_attention=fused))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = epoch * STEPS_PER_EPOCH
    return student, make_train_step(student, teacher, opt, cfg), cfg, epoch


class ModeRecorder:
    """Within the context: the kept indices of every stage, the threshold
    mode's keep masks and the perturbed top-k's sample indices are recorded
    (`replay` False) or handed out again in order (`replay` True), so that
    the plain step keeps the tokens the kernels' step kept; the soft top-k's
    inputs (scores, k, sigma, noise) are recorded."""

    def __init__(self, replay_from=None):
        self.kept, self.samples, self.soft, self.masks = [], [], [], []
        self.replay = replay_from

    def __enter__(self):
        import dense2sparse_vit_torch.models.student as student_module
        import dense2sparse_vit_torch.ops.perturbed_topk as ptk

        self.sm, self.ptk = student_module, ptk
        self.saved = (student_module.topk_keep_indices, ptk.topk_sample_indices,
                      student_module.perturbed_topk, ptk.gaussian_noise,
                      student_module.threshold_keep_mask)
        real_keep, real_samples, real_soft, real_noise, real_mask = self.saved
        kept = list(self.replay.kept) if self.replay else None
        samples = list(self.replay.samples) if self.replay else None
        masks = list(self.replay.masks) if self.replay else None

        def mask(scores, threshold):
            out = masks.pop(0) if masks is not None else real_mask(scores, threshold)
            self.masks.append(out)
            return out

        def keep(scores, k):
            out = kept.pop(0) if kept is not None else real_keep(scores, k)
            self.kept.append(out)
            return out

        def sample(perturbed, k):
            out = samples.pop(0) if samples is not None else real_samples(perturbed, k)
            self.samples.append(out)
            return out

        def soft(x, k, generator, num_samples, sigma):
            self.soft.append({"x": x.detach(), "k": k, "sigma": sigma})
            return real_soft(x, k, generator, num_samples, sigma)

        def noise(shape, generator):
            z = real_noise(shape, generator)
            self.soft[-1]["z"] = z
            return z

        student_module.topk_keep_indices, ptk.topk_sample_indices = keep, sample
        student_module.perturbed_topk, ptk.gaussian_noise = soft, noise
        student_module.threshold_keep_mask = mask
        return self

    def __exit__(self, *exc):
        (self.sm.topk_keep_indices, self.ptk.topk_sample_indices, self.sm.perturbed_topk,
         self.ptk.gaussian_noise, self.sm.threshold_keep_mask) = self.saved


def run_mode(torch, dev, mode, teachers, tally, smi):
    """Phase 33 for one mode: its kernels' step (launches, peak memory)
    against the plain step on the same weights, draws and kept tokens; the
    mode's own checks; a second, timed step; one eval step at
    MODE_EVAL_BATCH. Returns the mode's summary."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.train import make_eval_step

    student, step, cfg, epoch = build_mode(torch, dev, mode, True, teachers[True])
    plain, p_step, _, _ = build_mode(torch, dev, mode, False, teachers[False])
    images, labels = train_batch(torch, dev)
    stats = {k: v.clone() for k, v in student.state_dict().items() if "running_" in k}
    weights = ({k: v.clone() for k, v in student.state_dict().items()}
               if mode == "remat" else None)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with ModeRecorder() as rec:
        metrics = step(images, labels, epoch, generator=torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check_mode_launches(counts, PER_MODE_TRAIN_STEP[mode], f"{mode} train step")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    values = {k: v.item() for k, v in metrics.items()}
    if any(v != v or abs(v) == float("inf") for v in values.values()):
        raise AssertionError(f"{mode}: non-finite metrics {values}")
    grads = train_step_grads(torch, student)
    with ModeRecorder(replay_from=rec):
        p_values = {k: v.item() for k, v in p_step(
            images, labels, epoch, generator=torch.Generator(device=dev).manual_seed(11)).items()}
    compare_steps(torch, f"student_modes/{mode}", (values["loss"], grads),
                  (p_values["loss"], train_step_grads(torch, plain)), mode_grad_names(grads))
    # peak: the process's; step: the step's own, over what was resident
    out = {"mode": mode, "epoch": epoch, "metrics": values, "launches": counts,
           "peak_gib": peak / 2**30, "step_gib": (peak - resident) / 2**30}
    if mode == "soft_topk":
        s = rec.soft[0]
        g = torch.randn((B_TRAIN, s["k"], s["x"].shape[1]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(17))
        out["soft_bwd_rel_err"] = check_soft_topk_backward(torch, s["x"], s["z"], s["sigma"],
                                                           s["k"], g)
        out["one_hot_gib"] = B_TRAIN * SOFT_SAMPLES * s["k"] * s["x"].shape[1] * 4 / 2**30
        out["sigma"] = float(s["sigma"])
    if mode == "predictor_bn":
        moved = [k for k, v in student.state_dict().items()
                 if "running_" in k and not torch.equal(v, stats[k])]
        if len(moved) != len(stats) or not stats:
            raise AssertionError(f"predictor_bn: running statistics moved {len(moved)} of "
                                 f"{len(stats)}")
        out["bn_eval_rel_err"] = check_bn_eval(torch, student, images)
        student.train()
    if mode == "remat":
        remat_grads = train_step_grads(torch, student)
        plain_remat, plain_remat_step, _, _ = build_mode(torch, dev, mode, True, teachers[True])
        plain_remat.load_state_dict(weights)
        cfg_off = cfg.replace(model=cfg.model.replace(remat=False))
        from dense2sparse_vit_torch.train import make_optimizer, make_train_step

        opt = make_optimizer(plain_remat, cfg_off.train, STEPS_PER_EPOCH)
        opt.count = epoch * STEPS_PER_EPOCH
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        make_train_step(plain_remat, teachers[True], opt, cfg_off)(
            images, labels, epoch, generator=torch.Generator(device=dev).manual_seed(11))
        torch.cuda.synchronize()
        out["no_remat_step_gib"] = (torch.cuda.max_memory_allocated(dev) - resident) / 2**30
        out["remat"] = check_remat(torch, remat_grads, train_step_grads(torch, plain_remat))
        del plain_remat, plain_remat_step, weights
    del plain, p_step
    # a second step from the first's state, timed
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(images, labels, epoch, generator=torch.Generator(device=dev).manual_seed(12))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    check_mode_launches(counts, PER_MODE_TRAIN_STEP[mode], f"{mode} second train step")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    # one eval step at MODE_EVAL_BATCH
    x = torch.randn((MODE_EVAL_BATCH, 224, 224, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(18))
    y = torch.randint(0, 1000, (MODE_EVAL_BATCH,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(19))
    eval_step = make_eval_step(student, teachers[True], cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ev = {k: v.item() for k, v in eval_step(x, y).items()}
    torch.cuda.synchronize()
    out["eval_ms"] = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    check_mode_launches(counts, PER_MODE_EVAL_STEP[mode], f"{mode} eval step")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    if any(v != v for v in ev.values()) or ev["n_valid"] != MODE_EVAL_BATCH:
        raise AssertionError(f"{mode} eval: {ev}")
    out["eval"] = {k: ev[k] for k in ("val_acc", "val_loss", "n_valid")}
    emit({"phase": "student_modes", **out, "card": smi})
    return out


def run_cli_epoch(torch, dev, root, flags, per_step, per_eval, tally, smi):
    """One epoch of the CLI (LOOP_FLAGS + `flags`) over phase 32's folder:
    each step's and each eval's launches, every logged number finite."""
    import tempfile

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.train.loop import run_experiment

    cfg, _ = loop_config(root, "--epochs", "1", *flags)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_modes_") as workdir:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with LoopSpy(torch) as spy:
            summary = run_experiment(cfg, workdir, device=dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        records = loop_records(workdir)
        check_loop_metrics(records, f"cli {flags}")
    check_step_launches(spy.steps, per_step, f"cli {flags} train")
    check_step_launches(spy.evals, per_eval, f"cli {flags} eval")
    if len(spy.steps) != LOOP_STEPS:
        raise AssertionError(f"cli {flags}: {len(spy.steps)} steps")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    emit({"phase": "student_modes", "cli": list(flags), "seconds": time.perf_counter() - t0,
          "train_steps": len(spy.steps), "summary": summary, "card": smi,
          "train_img_per_s": [r["time/train_img_per_s"] for r in records
                              if "time/train_img_per_s" in r]})


def phase_student_modes(torch, dev, tally, smi, root):
    """Phase 33: every mode of `mode_specs` (`run_mode`), then one CLI
    epoch each of MODE_CLI_RUNS over phase 32's folder `root`."""
    from dense2sparse_vit_torch.models import HEADLINE_TEACHER, create_model

    teachers = {fused: create_model(HEADLINE_TEACHER, use_fused_attention=fused, device=dev,
                                    dtype="bfloat16",
                                    generator=torch.Generator().manual_seed(2))
                for fused in (True, False)}
    t0 = time.perf_counter()
    summary = {}
    for mode in mode_specs():
        summary[mode] = run_mode(torch, dev, mode, teachers, tally, smi)
        torch.cuda.empty_cache()
    del teachers
    torch.cuda.empty_cache()
    for flags, per_step, per_eval in MODE_CLI_RUNS:
        run_cli_epoch(torch, dev, root, flags, per_step, per_eval, tally, smi)
    emit({"phase": "student_modes", "card": smi, "seconds": time.perf_counter() - t0,
          "step_ms": {m: s["step_ms"] for m, s in summary.items()},
          "peak_gib": {m: s["peak_gib"] for m, s in summary.items()},
          "step_gib": {m: s["step_gib"] for m, s in summary.items()},
          "no_remat_step_gib": summary["remat"]["no_remat_step_gib"],
          "soft_topk_one_hot_gib": summary["soft_topk"]["one_hot_gib"]})


# ---- 34. the DeiT, ViT and DINO families; 384-px training --------------------

B_384 = 64
STUDENT_384 = "dynamic_vit_base_patch16_224_student"
TEACHER_384 = "dynamic_vit_base_patch16_224_teacher"
# per 384-px mode: the student's keyword arguments (a `models` name), its
# step's launches, and how many of its block backwards take the attention
# core backward's long path: top-k and attn the six blocks at N = 577 and
# 404 before the second stage, threshold all twelve at 577
MODES_384 = {
    "topk": ("HEADLINE_KWARGS", PER_TRAIN_STEP, 6),
    "threshold": ("THRESHOLD_KWARGS", PER_POLICY_TRAIN_STEP, 12),
    "attn": ("ATTN_KWARGS", PER_ATTN_TRAIN_STEP, 6),
}
# the training entry point at 384 px: DeiT-B/16 with the headline's stages
# (576 patches kept to 403 / 282 / 197), evaluated at crop 384 from a short
# side of 384 (DeiT's 384-px recipe, crop ratio 1)
CLI_384_FLAGS = ("--arch deit_base --img-size 384 --eval-crop 384 --eval-resize 384 "
                 "--dtype bfloat16 --pruning-locs 3 6 9 --keep-ratios 0.7 0.49 0.343 "
                 "--small-predictor --topk-selection --use-fused-attention --batch-size 32 "
                 "--warmup-steps 1 --seed 0").split()
B_FAMILY, B_FAMILY_TIME, B_FAMILY_SMALL = 32, 64, 2
# the family models held fused against plain at full width and depth, one
# of each class: (registry name, create_model keyword arguments); the
# masked ones take seeded (N, 2) mask logits
FAMILY_MODELS = (
    ("deit_base_patch16_384", {}),
    ("deit_small_distilled_patch16_224", {}),
    ("vit_large_patch16_384", {}),
    ("vit_base_patch32_384", {}),
    ("dino_small", {"patch_size": 8}),
    ("nonspatial_deit_small_patch16_224", {}),
    ("deit_small_patch16_224_masked", {}),
    ("deit_small_patch16_224_predictor", {}),
    ("base_patch16_224_hierarchical", {}),
    ("small_patch16_224_ensemble", {}),
    ("dino_small_predictor", {}),
    ("dino_small_dist", {}),
    ("dino_small_patch16_224_masked", {}),
)
MASKED_FAMILY = ("deit_small_patch16_224_masked", "dino_small_patch16_224_masked")
FAMILY_TIMED = ("deit_base_patch16_384", "vit_large_patch16_384")
INT8_FAMILY = "vit_large_patch16_384"
# the int8 ViT-L's logits against the bf16 kernels' on the same weights:
# cosine similarity at least this (tests/test_torch_deit.py's bound)
INT8_LOGITS_COS = 0.99


def plain_twin(model):
    """A copy of `model` (the same weights) that runs every plain version:
    no block, predictor or gather kernel."""
    import copy

    twin = copy.deepcopy(model)
    for m in twin.modules():
        if hasattr(m, "use_fused"):
            m.use_fused = False
        if hasattr(m, "cfg"):
            m.cfg = m.cfg.replace(use_fused_attention=False)
    return twin


class Replay:
    """Within the context, `module.name` (a function of the model's own
    choices: its Gumbel decisions, its top-k) records what it returns, or,
    given `replay_from`, returns what that recorder recorded, in order: the
    plain twin then keeps the tokens the kernels' run kept."""

    def __init__(self, module, name, replay_from=None):
        self.module, self.name, self.out = module, name, []
        self.replay = list(replay_from.out) if replay_from is not None else None

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def fn(*a, **kw):
            out = self.replay.pop(0) if self.replay is not None else self.real(*a, **kw)
            self.out.append(out)
            return out

        setattr(self.module, self.name, fn)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def output_leaves(out) -> list:
    """The tensors of a (nested tuple of) model output(s), None left out."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in output_leaves(o)]
    return [out]


def family_forward(torch, model, name, x, seed=5):
    """One eval forward of a family model on x, with seeded mask logits for
    the masked ones and its Gumbel draws from a seeded generator."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    args = ()
    if name in MASKED_FAMILY:
        n = model.cfg.num_patches
        args = (torch.randn((n, 2), device=x.device,
                            generator=torch.Generator(device=x.device).manual_seed(seed + 1)),)
    return model(x, *args, generator=gen)


def family_launches(model, name) -> dict:
    """A family model's eval forward: every block through the block kernel
    (at a head width other than 64 through the attention_hd core too), and
    the single-stage DINO student's gather."""
    out = {**NO_LAUNCHES, "fused_transformer_block": model.cfg.depth}
    if model.cfg.embed_dim != 64 * model.cfg.num_heads:  # the cores at other head widths
        out["attention_hd"] = model.cfg.depth
    if name == "dino_small_predictor":
        out["fused_gather_tokens"] = 1
    return out


def check_family_model(torch, dev, name, kwargs, tally, smi):
    """A family model at full width and depth, bf16, seeded weights: its
    fused B=32 eval forward (launches `family_launches`) against its plain
    twin on the same weights, draws and kept tokens, every output within
    LOGITS_TOL of the plain one's largest magnitude. Returns the fused
    model."""
    import dense2sparse_vit_torch.models.deit as deit_mod
    import dense2sparse_vit_torch.models.dino as dino_mod
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import create_model

    model = create_model(name, use_fused_attention=True, dtype="bfloat16", device=dev,
                         generator=torch.Generator().manual_seed(0), **kwargs).eval()
    plain = plain_twin(model)
    side = model.cfg.img_size
    x = torch.randn((B_FAMILY, side, side, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    spies = ((deit_mod, "gumbel_softmax"), (dino_mod, "gumbel_softmax"),
             (dino_mod, "topk_keep_indices"))
    with torch.inference_mode():
        with contextlib.ExitStack() as stack:
            recs = [stack.enter_context(Replay(m, n)) for m, n in spies]
            ops.reset_launch_counts()
            got = output_leaves(family_forward(torch, model, name, x))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        with contextlib.ExitStack() as stack:
            for (m, n), r in zip(spies, recs):
                stack.enter_context(Replay(m, n, r))
            ops.reset_launch_counts()
            want = output_leaves(family_forward(torch, plain, name, x))
            torch.cuda.synchronize()
            plain_counts = ops.launch_counts()
    check_mode_launches(counts, family_launches(model, name), f"{name} forward")
    check_mode_launches(plain_counts, NO_LAUNCHES, f"{name} plain forward")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    rel = []
    for a, b in zip(got, want):
        err, ref = rel_err(torch, a, b)
        rel.append(err / max(ref, 1e-30))
    worst = max(rel)
    emit({"phase": "deit_family", "model": name, "class": type(model).__name__,
          "config": {k: getattr(model.cfg, k) for k in ("img_size", "patch_size", "embed_dim",
                                                        "depth", "num_heads", "num_classes")},
          "tokens": model.cfg.num_patches + getattr(model, "num_extra_tokens", 1),
          "outputs": len(got), "shape": list(got[0].shape), "launches": counts,
          "worst_rel_err": worst, "tol_rel": LOGITS_TOL, "card": smi})
    if len(got) != len(want) or not worst <= LOGITS_TOL:
        raise AssertionError(f"{name}: fused against plain {rel}")
    tally.err("fused_transformer_block", max(rel_err(torch, a, b)[0] for a, b in zip(got, want)))
    del plain
    return model


def time_family_model(torch, dev, model, smi) -> dict:
    """A B=64 eval forward: img/s by wall clock and the device's busy share
    over 5 profiled calls (`utils.profile_forward.profile_device`)."""
    from dense2sparse_vit_torch.utils.profile_forward import profile_device

    side = model.cfg.img_size
    x = torch.randn((B_FAMILY_TIME, side, side, 3), device=dev, dtype=torch.bfloat16,
                    generator=torch.Generator(device=dev).manual_seed(6))
    with torch.inference_mode():
        out = profile_device(lambda: model(x), 5)
    return {"batch": B_FAMILY_TIME, "img_per_s": B_FAMILY_TIME / out["wall_ms"] * 1e3, **out}


def check_int8_family(torch, dev, model, tally, smi):
    """(d): the int8 twin of the fused ViT-L/16 at 384 px (quant="int8" on
    every block, the same weights): its B=32 forward's launches (24 int8
    blocks), the int8 block (C = 1024, hidden 4096, N = 577) against its
    plain int8 version at the first and the last block's input
    (`check_int8_block`), the logits against the bf16 kernels' (cosine
    similarity at least INT8_LOGITS_COS), and the block timed beside its
    plain version and the bf16 block kernel."""
    import copy

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.quant import quant_block_reference

    q = copy.deepcopy(model)
    q.cfg = q.cfg.replace(quant="int8")
    for blk in q.blocks:
        blk.quant = "int8"
    side = model.cfg.img_size
    x = torch.randn((B_FAMILY, side, side, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    inputs = {}
    last = len(q.blocks) - 1
    hooks = [q.blocks[i].register_forward_pre_hook(
        lambda m, a, i=i: inputs.__setitem__(i, a[0].detach())) for i in (0, last)]
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits = q(x)[-1].float()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ref = model(x)[-1].float()
    for h in hooks:
        h.remove()
    want = {**NO_LAUNCHES, "fused_transformer_block_int8": len(q.blocks)}
    check_mode_launches(counts, want, "int8 ViT-L forward")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    tally.rows["fused_transformer_block_int8[4096]"]["launches"] += counts[
        "fused_transformer_block_int8"]
    cos = torch.nn.functional.cosine_similarity(logits.flatten(), ref.flatten(), dim=0).item()
    rms = ((logits - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    emit({"phase": "deit_family", "int8": INT8_FAMILY, "logits_vs_bf16_kernels": {
        "cos": cos, "rel_rms": rms, "top1_agreement": top1, "tol_cos": INT8_LOGITS_COS},
        "launches": counts, "card": smi})
    if not cos >= INT8_LOGITS_COS:
        raise AssertionError(f"int8 ViT-L logits against bf16: cos {cos}")
    blk = q.blocks[0]
    args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
    with torch.inference_mode():
        qw = blk.int8_weights(torch.bfloat16)
        for i, xi in inputs.items():
            _, err = check_int8_block(torch, xi, q.blocks[i].int8_weights(torch.bfloat16), *args,
                                      block=i)
            tally.err("fused_transformer_block_int8", err)
            tally.err("fused_transformer_block_int8[4096]", err)
        x0 = inputs[0]
        kernel = lambda: ops.fused_transformer_block_int8(  # noqa: E731
            x0, qw, args[0], scale=args[1], ln_eps=args[2])
        k_ms, p_ms = paired_ms(torch, kernel, lambda: quant_block_reference(x0, qw, *args),
                               iters=3, rounds=1, repeats=3)
        w = blk.kernel_weights(torch.bfloat16)
        bf16_ms = cuda_ms(torch, lambda: ops.fused_transformer_block(
            x0, w, args[0], scale=args[1], ln_eps=args[2]), iters=3, repeats=3)
    B, N, C = x0.shape
    hidden = blk.mlp.fc1.weight.shape[0]
    b = int8_block_bound(B, N, C, args[0], hidden)
    tally.add("fused_transformer_block_int8[4096]", len(q.blocks), k_ms, p_ms, b)
    emit({"phase": "deit_family", "kernel": "fused_transformer_block_int8", "shape": [B, N, C],
          "hidden": hidden, "ms": k_ms, "plain_ms": p_ms, "bf16_block_ms": bf16_ms,
          "bound_ms": max(b.values()),
          "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
          "calls_per_forward": len(q.blocks), "card": smi})
    del q


def build_384(torch, dev, mode, teacher):
    """The 384-px DeiT-B/16 student in `mode` (fused, seeded weights) and
    its plain twin, each with AdamW past the warmup and a train step with
    `teacher` (fused) or its plain twin: ((student, step), (plain, step),
    cfg)."""
    from dense2sparse_vit_torch import models
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    kwargs = getattr(models, MODES_384[mode][0])
    student = models.create_model(STUDENT_384, img_size=384, use_fused_attention=True,
                                  device=dev, generator=torch.Generator().manual_seed(0),
                                  **kwargs)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(batch_size=B_384))
    out = []
    for s, t in ((student, teacher), (plain_twin(student), plain_twin(teacher))):
        opt = make_optimizer(s, cfg.train, STEPS_PER_EPOCH)
        opt.count = TRAIN_EPOCH * STEPS_PER_EPOCH
        out.append((s, make_train_step(s, t, opt, cfg)))
    return out[0], out[1], cfg


def run_384(torch, dev, mode, teacher, tally, smi):
    """(b) for one mode: a B=64 train step of the 384-px student (launches,
    the long path's among them, peak memory) against its plain twin's step
    on the same weights, draws and kept tokens (`compare_steps`); a second
    step, timed; a third with its activations captured for (a)'s checks.
    Returns (the summary, the captured activations)."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import ATTENTION_BWD_LONG

    _, per_step, long_per_step = MODES_384[mode]
    (student, step), (plain, p_step), cfg = build_384(torch, dev, mode, teacher)
    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randn((B_384, 384, 384, 3), generator=gen, device=dev)
    labels = torch.randint(0, 1000, (B_384,), generator=gen, device=dev)

    def counted_step(seed):
        ops.reset_launch_counts()
        ATTENTION_BWD_LONG.launches = 0
        metrics = step(images, labels, TRAIN_EPOCH,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        counts, long = ops.launch_counts(), ATTENTION_BWD_LONG.launches
        check_mode_launches(counts, per_step, f"384-px {mode} train step")
        if long != long_per_step:
            raise AssertionError(f"384-px {mode}: {long} long-path launches, expected "
                                 f"{long_per_step}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        tally.rows["attention_bwd[long]"]["launches"] += long
        return {k: v.item() for k, v in metrics.items()}

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with ModeRecorder() as rec:
        values = counted_step(11)
    peak = torch.cuda.max_memory_allocated(dev)
    if any(v != v or abs(v) == float("inf") for v in values.values()):
        raise AssertionError(f"384-px {mode}: non-finite metrics {values}")
    grads = train_step_grads(torch, student)
    with ModeRecorder(replay_from=rec):
        p_values = {k: v.item() for k, v in p_step(
            images, labels, TRAIN_EPOCH,
            generator=torch.Generator(device=dev).manual_seed(11)).items()}
    compare_steps(torch, f"deit_family/384_{mode}", (values["loss"], grads),
                  (p_values["loss"], train_step_grads(torch, plain)), mode_grad_names(grads))
    del plain, p_step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counted_step(12)
    step_ms = (time.perf_counter() - t0) * 1e3
    if mode == "attn":
        acts = capture_attn_step(torch, step, images, labels)
    else:
        acts = capture_train_step(torch, student, teacher, step, images, labels)
        acts["heads"] = student.blocks[0].attn.num_heads
        acts["scale"] = student.blocks[0].attn.scale
        acts["ln_eps"] = student.blocks[0].norm1.eps
    out = {"mode": mode, "batch": B_384, "metrics": values, "step_ms": step_ms,
           "peak_gib": peak / 2**30, "step_gib": (peak - resident) / 2**30,
           "tokens": [student.cfg.num_patches + 1] + [k + 1 for k in
                                                       student.pruning.keep_counts(576)]}
    emit({"phase": "deit_family", "train_384": out, "card": smi})
    del student, step
    return out, acts


def long_cases_384(torch, dev, acts):
    """(a)'s cases, on the 384-px steps' own activations in the form of
    `capture_attn_bwd_cases`: plain mode at the top-k step's first block of
    N = 577 and of 404; policy mode with dPolicy at the threshold step's
    first policy block (N = 577, its keep policy) at every eps of
    EPS_CHECKS, and on planted exact ties there; the CLS fold at the attn
    step's blocks feeding the first two stages (577, 404); and N = 785 from
    dino_small at patch 8 on a seeded block, each mode."""
    from dense2sparse_vit_torch.models import create_model

    cases = []
    for mode in ("topk", "threshold"):
        rec = acts[mode]
        gen = torch.Generator(device=dev).manual_seed(34)
        scale_g = rec["last_g"].float().std().item()
        H, scale, ln_eps = rec["heads"], rec["scale"], rec["ln_eps"]
        widths = {}
        for i in range(len(rec["block_in"])):
            widths.setdefault(rec["block_in"][i].shape[1], i)
        blocks = ([widths[577], widths[404]] if mode == "topk"
                  else [min(i for i, p in rec["policy"].items() if p is not None)])
        for i in blocks:
            x, w, pol = rec["block_in"][i], rec["weights"][i], rec["policy"][i]
            g = (torch.randn(x.shape, generator=gen, device=dev) * scale_g).to(x.dtype)
            base = {"block": i, "heads": H, "scale": scale, "gcls": None}
            if pol is None:
                qkv, do = attn_bwd_inputs(torch, x, g, w, H, scale, ln_eps)
                cases.append({**base, "what": "topk_384", "qkv": qkv, "g": do, "policy": None,
                              "eps": 1e-6})
                continue
            pol = pol.float().contiguous()
            x_tie, tied = planted_ties(torch, x, w, H, scale, ln_eps)
            emit({"phase": "deit_family", "planted_ties": {"block": i, "tied_rows": tied}})
            for what, xx in (("threshold_384", x), ("ties_384", x_tie)):
                for eps in EPS_CHECKS:
                    qkv, do = attn_bwd_inputs(torch, xx, g, w, H, scale, ln_eps, pol, eps)
                    cases.append({**base, "what": what, "qkv": qkv, "g": do, "policy": pol,
                                  "eps": eps})
    for i in ATTN_STAGE_FEEDERS[:2]:
        e = acts["attn"]["attn"][i]
        cases.append({"what": "gcls_384", "block": i, "qkv": e["qkv"], "g": e["g"],
                      "heads": e["heads"], "scale": e["scale"], "policy": None,
                      "gcls": e["gcls"], "eps": 1e-6})
    # N = 785: dino_small at patch 8, its first block on its own embedding
    model = create_model("dino_small", patch_size=8, depth=1, use_fused_attention=True,
                         dtype="bfloat16", device=dev, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(785)
    with torch.no_grad():
        x = model._embed(torch.randn((8, 224, 224, 3), generator=gen, device=dev))
    blk = model.blocks[0]
    H, scale = blk.attn.num_heads, blk.attn.scale
    w = blk.kernel_weights(torch.bfloat16)
    g = (torch.randn(x.shape, generator=gen, device=dev) * x.float().std()).to(x.dtype)
    pol = (torch.rand(x.shape[:2], generator=gen, device=dev) < 0.6).float()
    pol[:, 0] = 1.0
    gcls = torch.randn((x.shape[0], H, x.shape[1]), generator=gen, device=dev) * 1e-2
    base = {"block": 0, "heads": H, "scale": scale}
    qkv, do = attn_bwd_inputs(torch, x, g, w, H, scale, blk.norm1.eps)
    cases.append({**base, "what": "dino_p8", "qkv": qkv, "g": do, "policy": None,
                  "gcls": None, "eps": 1e-6})
    cases.append({**base, "what": "dino_p8_gcls", "qkv": qkv, "g": do, "policy": None,
                  "gcls": gcls, "eps": 1e-6})
    for eps in EPS_CHECKS:
        qkv, do = attn_bwd_inputs(torch, x, g, w, H, scale, blk.norm1.eps, pol, eps)
        cases.append({**base, "what": "dino_p8_policy", "qkv": qkv, "g": do, "policy": pol,
                      "gcls": None, "eps": eps})
    return cases


def time_384(torch, acts, stage_in, smi):
    """The main path's kernels at the 384-px step's own shapes (B=64, C=768),
    each beside its plain version (CUDA events, in turns), its bound and,
    where there is one, a torch call: the block forward at every stage width
    (N = 577 / 404 / 283 / 198) and its backward at 577 and 404, the
    teacher's CLS-row block at 577, the gathers and scatters (577 -> 404 ->
    283 -> 198; the kernels and torch's from CUDA graphs), the predictor at
    N = 576 / 403 / 282, the policy block both ways at 577 (threshold), the
    packed attention forward at 577 (attn)."""
    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import (
        attention_reference, transformer_block_backward_reference, transformer_block_reference)
    from dense2sparse_vit_torch.ops.gather import gather_tokens_reference, scatter_tokens_reference
    from dense2sparse_vit_torch.ops.predictor import predictor_lg_reference

    def row(kernel, shape, k_ms, p_ms, b, **extra):
        emit({"phase": "deit_family", "time_384": kernel, "shape": list(shape), "ms": k_ms,
              "plain_ms": p_ms, "bound_ms": max(b.values()),
              "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
              **extra, "card": smi})

    rec = acts["topk"]
    H, scale, ln_eps = rec["heads"], rec["scale"], rec["ln_eps"]
    kw = dict(scale=scale, ln_eps=ln_eps)
    gen = torch.Generator(device=rec["last_g"].device).manual_seed(38)
    scale_g = rec["last_g"].float().std().item()
    with torch.no_grad():
        for i in (0, 3, 6, 9):
            x, w = rec["block_in"][i], rec["weights"][i]
            hidden = w["w1"].shape[0]
            k, p = paired_ms(torch, lambda: ops.fused_transformer_block(x, w, H, **kw),
                             lambda: transformer_block_reference(x, w, H, scale, ln_eps),
                             iters=5, rounds=1, repeats=3)
            row("fused_transformer_block", x.shape, k, p, block_bound(*x.shape, H, hidden))
            if x.shape[1] <= 384:
                continue
            g = (torch.randn(x.shape, generator=gen, device=x.device) * scale_g).to(x.dtype)
            k, p = paired_ms(
                torch, lambda: ops.fused_transformer_block_backward(x, g, w, H, **kw),
                lambda: transformer_block_backward_reference(x, g, w, H, scale, ln_eps),
                iters=3, rounds=1, repeats=3)
            row("fused_transformer_block_backward", x.shape, k, p,
                block_backward_bound(*x.shape, H, hidden))
        x, w = rec["teacher_in"][0], rec["teacher_weights"][0]
        k, p = paired_ms(torch, lambda: ops.fused_transformer_block_cls(x, w, H, **kw),
                         lambda: transformer_block_reference(x, w, H, scale, ln_eps,
                                                             return_cls=True),
                         iters=5, rounds=1, repeats=3)
        row("fused_transformer_block_cls", x.shape, k, p,
            block_bound(*x.shape, H, w["w1"].shape[0], cls=True))
        for e in rec["gathers"]:
            x, idx, g = e["x"], e["idx"], e["g"]
            B, n, D = x.shape
            full = idx[..., None].expand(-1, -1, D)
            # (the plain versions by events: they are not graph-capturable)
            row("fused_gather_tokens", x.shape, graph_ms(torch, lambda: ops.fused_gather_tokens(
                x, idx)), cuda_ms(torch, lambda: gather_tokens_reference(x, idx), iters=5),
                rows_bound(B, idx.shape[1], D, idx.shape[1], 2), k=idx.shape[1],
                library_ms=graph_ms(torch, lambda: torch.gather(x, 1, full)))
            row("fused_scatter_tokens", g.shape,
                graph_ms(torch, lambda: ops.fused_scatter_tokens(g, idx, n)),
                cuda_ms(torch, lambda: scatter_tokens_reference(g, idx, n), iters=5),
                rows_bound(B, idx.shape[1], D, n, 2), n=n,
                library_ms=graph_ms(torch, lambda: torch.zeros_like(x).scatter_add_(1, full, g)))
        for xs, w in stage_in:
            B, N, D = xs.shape
            k, p = paired_ms(torch, lambda: ops.fused_predictor_lg(xs, w),
                             lambda: predictor_lg_reference(xs, w), iters=5, rounds=1,
                             repeats=3)
            row("fused_predictor_lg", xs.shape, k, p, predictor_bound(B, N, D, w))
        rt = acts["threshold"]
        i = min(j for j, pol in rt["policy"].items() if pol is not None)
        x, w, pol = rt["block_in"][i], rt["weights"][i], rt["policy"][i].float().contiguous()
        hidden = w["w1"].shape[0]
        k, p = paired_ms(torch, lambda: ops.fused_transformer_block(x, w, H, pol, **kw),
                         lambda: transformer_block_reference(x, w, H, scale, ln_eps, policy=pol),
                         iters=5, rounds=1, repeats=3)
        row("fused_transformer_block[policy]", x.shape, k, p, block_bound(*x.shape, H, hidden))
        g = (torch.randn(x.shape, generator=gen, device=x.device) * scale_g).to(x.dtype)
        k, p = paired_ms(
            torch, lambda: ops.fused_transformer_block_backward(x, g, w, H, pol, **kw),
            lambda: transformer_block_backward_reference(x, g, w, H, scale, ln_eps, policy=pol),
            iters=3, rounds=1, repeats=3)
        row("fused_transformer_block_backward[policy]", x.shape, k, p,
            block_backward_bound(*x.shape, H, hidden))
        e = acts["attn"]["attn"][0]
        qkv, Ha, sc = e["qkv"], e["heads"], e["scale"]
        B, N, C3 = qkv.shape
        q, kk, v = qkv.view(B, N, 3, Ha, C3 // 3 // Ha).permute(2, 0, 3, 1, 4).unbind(0)
        k, p = paired_ms(torch, lambda: ops.fused_attention_packed(qkv, Ha, scale=sc),
                         lambda: attention_reference(qkv, Ha, sc), iters=5, rounds=1,
                         repeats=3)
        row("fused_attention_packed", qkv.shape, k, p, attention_bound(B, N, C3 // 3, Ha),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, kk, v, scale=sc),
                               iters=5, repeats=3))


def phase_deit_family(torch, dev, tally, smi, root):
    """Phase 34: (b) 384-px training (`run_384` per mode, then one CLI epoch
    at --img-size 384 over phase 32's folder `root` ending in a checkpoint
    and an eval, and a teacher-cache step against a live one at 384 px);
    (a) attention_bwd_kernel's long path on (b)'s activations and at
    N = 785 (`long_cases_384`: `check_attn_bwd`, two launches bit-equal),
    timed at N = 577 and 404 beside its bound and SDPA's backward, the
    predictor kernel on the 384-px student's stage inputs (N = 576, 403,
    282), and the main path's other kernels at the 384-px shapes timed
    (`time_384`); (c) every family model of FAMILY_MODELS fused against plain
    (`check_family_model`), the other new names at depth 2, and a B=64
    forward of FAMILY_TIMED timed; (d) the int8 ViT-L (`check_int8_family`)."""
    import os
    import tempfile

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, create_model
    from dense2sparse_vit_torch.models.registry import list_models
    from dense2sparse_vit_torch.train.loop import run_experiment

    t0 = time.perf_counter()
    # (b) 384-px training
    teacher = create_model(TEACHER_384, img_size=384, use_fused_attention=True, device=dev,
                           dtype="bfloat16", generator=torch.Generator().manual_seed(2))
    acts, train = {}, {}
    for mode in MODES_384:
        train[mode], acts[mode] = run_384(torch, dev, mode, teacher, tally, smi)
        torch.cuda.empty_cache()
    del teacher
    # the predictor kernel on the 384-px student's stage inputs
    student = create_model(STUDENT_384, img_size=384, use_fused_attention=True, device=dev,
                           generator=torch.Generator().manual_seed(0), **HEADLINE_KWARGS).eval()
    stage_in = []
    hooks = [p.register_forward_pre_hook(lambda m, a: stage_in.append(a[0].detach()))
             for p in student.score_predictor]
    with torch.inference_mode():
        x = torch.randn((B_384, 384, 384, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8))
        student(x, collect_cls_attns=False)
        stage_in = [(xs, p.kernel_weights(xs.dtype))
                    for p, xs in zip(student.score_predictor, stage_in)]
        for xs, w in stage_in:
            _, err = check_predictor(torch, xs, w, f"384px_N{xs.shape[1]}", "deit_family")
            tally.err("fused_predictor_lg", err)
    for h in hooks:
        h.remove()
    del student
    # the CLI at 384 px, one epoch
    from dense2sparse_vit_torch import cli

    cfg, _ = cli.parse_config([*CLI_384_FLAGS, "--imgnet-val-dir", root, "--epochs", "1"])
    cfg = cfg.replace(data=cfg.data.replace(num_workers=LOOP_WORKERS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_384_") as workdir:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        with LoopSpy(torch) as spy:
            summary = run_experiment(cfg, workdir, device=dev)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        records = loop_records(workdir)
        check_loop_metrics(records, "cli 384")
        ckpts = {stream: os.listdir(os.path.join(workdir, "ckpt", stream))
                 for stream in ("best", "latest")}
    check_step_launches(spy.steps, PER_TRAIN_STEP, "cli 384 train")
    check_step_launches(spy.evals, PER_EVAL_STEP["topk"], "cli 384 eval")
    if not all(ckpts.values()) or not spy.evals:
        raise AssertionError(f"cli 384: checkpoints {ckpts}, {len(spy.evals)} evals")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    emit({"phase": "deit_family", "cli_384": CLI_384_FLAGS, "seconds": time.perf_counter() - t1,
          "train_steps": len(spy.steps), "evals": len(spy.evals), "valid_rows": spy.valid,
          "summary": summary, "checkpoints": ckpts, "card": smi,
          "train_img_per_s": [r["time/train_img_per_s"] for r in records
                              if "time/train_img_per_s" in r]})
    cache_cfg, _ = cli.parse_config([*CLI_384_FLAGS, "--imgnet-val-dir", root, "--teacher-cache",
                                     "--mixup", "0", "--cutmix", "0"])
    emit({"phase": "deit_family", "cached_against_live_384": cached_step_against_live(
        torch, dev, cache_cfg, root), "card": smi})
    torch.cuda.empty_cache()
    # the main path's kernels at the 384-px shapes, timed
    time_384(torch, acts, stage_in, smi)
    del stage_in
    # (a) the long path
    cases = long_cases_384(torch, dev, acts)
    del acts
    worst = max(check_attn_bwd(torch, c) for c in cases)
    tally.err("attention_bwd", worst)
    tally.err("attention_bwd[long]", worst)
    for c in cases:
        n = c["qkv"].shape[1]
        if c["what"] not in ("topk_384", "threshold_384", "gcls_384") or (
                c["policy"] is not None and c["eps"] != EPS_CHECKS[0]):
            continue
        B, N, C3 = c["qkv"].shape
        t = attn_bwd_times(torch, c)
        b = attention_backward_bound(B, N, C3 // 3, c["heads"], gcls=c["gcls"] is not None,
                                     policy=c["policy"] is not None)
        row = {"phase": "deit_family", "kernel": "attention_bwd[long]", "mode": c["what"],
               "block": c["block"], "shape": [B, N, C3], **t, "bound_ms": max(b.values()),
               "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
               "card": smi}
        if c["what"] == "topk_384":
            lib_ms, row["library_fwd_bwd_ms"], row["library_fwd_ms"] = sdpa_backward_ms(
                torch, c["qkv"], c["g"], c["heads"], c["scale"])
            row["library_ms"] = lib_ms
            # per top-k step: three block backwards at each of N = 577 and 404
            tally.add("attention_bwd[long]", 3, t["ms"], t["plain_ms"], b, lib_ms)
        emit(row)
    del cases
    torch.cuda.empty_cache()
    # (c) the families at full width, then every other new name at depth 2
    timed = {}
    for name, kwargs in FAMILY_MODELS:
        model = check_family_model(torch, dev, name, kwargs, tally, smi)
        if name in FAMILY_TIMED:
            timed[name] = time_family_model(torch, dev, model, smi)
            emit({"phase": "deit_family", "timed": name, **timed[name]})
        if name == INT8_FAMILY:
            check_int8_family(torch, dev, model, tally, smi)
        del model
        torch.cuda.empty_cache()
    from dense2sparse_vit_torch.models import registry

    checked = {n for n, _ in FAMILY_MODELS}
    others = [n for n in list_models()
              if registry._REGISTRY[n].__qualname__.startswith("_family")
              and n not in checked]
    for name in others:
        model = create_model(name, depth=2, use_fused_attention=True, dtype="bfloat16",
                             device=dev, generator=torch.Generator().manual_seed(0)).eval()
        side = model.cfg.img_size
        x = torch.randn((B_FAMILY_SMALL, side, side, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(9))
        with torch.inference_mode():
            ops.reset_launch_counts()
            out = output_leaves(family_forward(torch, model, name, x))
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_mode_launches(counts, family_launches(model, name), f"{name} at depth 2")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        if not all(bool(torch.isfinite(t.float()).all()) for t in out):
            raise AssertionError(f"{name} at depth 2: non-finite outputs")
        emit({"phase": "deit_family", "depth_2": name, "class": type(model).__name__,
              "shapes": [list(t.shape) for t in out]})
        del model
    emit({"phase": "deit_family", "seconds": time.perf_counter() - t0,
          "train_384": {m: {k: v[k] for k in ("step_ms", "peak_gib", "step_gib")}
                        for m, v in train.items()},
          "img_per_s": {n: t["img_per_s"] for n, t in timed.items()},
          "busy_share": {n: t["busy_share"] for n, t in timed.items()},
          "depth_2_names": len(others), "card": smi})


# ---- 35. head widths other than 64; the rest of the zoo ---------------------------

# (head width, heads, C): t2t_vit_14_resnext's and vit_small_patch16_224's
HD_WIDTHS = ((12, 32, 384), (96, 8, 768))
HD_BATCH = 64
HD_TOKENS = (197, 138, 97, 68)  # the headline student's widths
HD_LONG = (577, 785)  # the 384-px and the patch-8 sequences
HD_TIMED = (197, 577)
# the two registry models that reach the kernels at those widths, with the
# keyword arguments of their train step (stochastic depth at d = 12)
HD_MODELS = (("vit_small_patch16_224", {}), ("t2t_vit_14_resnext", {"drop_path_rate": 0.1}))
# the other new names: plain torch, no kernel
HD_OTHERS = ("t2t_vit_14_wide", "t2t_vit_14_se", "t2t_vit_16_ghost", "t2t_vit_dense",
             "tnt_s_patch16_224", "tnt_b_patch16_224", "drop_resnet50")
B_OTHERS = 8
# bf16 against fp32 through a whole network, relative to the fp32 logits'
# largest magnitude: a guard against a gross fault, not a kernel tolerance
OTHERS_TOL = 0.1
# the kernels of csrc/attention_hd.cuh by the profiler's kernel names
HD_GROUPS = ("attention_hd_kernel", "attention_hd_bwd_kernel", "sum_heads")
# (padded width, policy mode) of each instantiation of the two head-width
# cores, which the build phase finds in ptxas's log without a spill
HD_KINDS = tuple((dp, pol) for dp in range(16, 129, 16) for pol in (False, True))


def hd_kind(name: str, word: str):
    """(padded width DP, policy mode) of an `attention_hd_kernel<DP, POLICY>`
    or `attention_hd_bwd_kernel<DP, POLICY>` instantiation (`word`) from its
    mangled name; None for another."""
    if word + "ILi" not in name:
        return None
    rest = name.split(word + "ILi")[1]  # e.g. "96ELb1EEEv..."
    return int(rest.split("E")[0]), rest.split("Lb")[1][0] == "1"


def hd_block(torch, dev, C, H, seed):
    """A block at width C with H heads (MLP ratio 3) whose matrices are drawn
    at N(0, 1/fan_in), so that the softmax is peaked, and whose LayerNorms
    and biases are perturbed: its kernel weights (bf16 matrices) on the
    card."""
    from dense2sparse_vit_torch.nn.layers import Block

    blk = Block(C, H, mlp_ratio=3.0, use_fused=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5)
            else:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return blk.to(dev).eval().kernel_weights(torch.bfloat16)


def check_cls_rows(torch, x, w, H, scale, policy=None, eps=1e-6):
    """The block's CLS-row forward (`fused_transformer_block_cls`) against
    its plain version: the rows within STAGE_TOL, the output within
    BLOCK_TOL. Returns the largest absolute error of the rows."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import transformer_block_reference

    out, cls = ops.fused_transformer_block_cls(x, w, H, policy, scale=scale, eps=eps)
    want, want_cls = transformer_block_reference(x, w, H, scale, 1e-6, policy=policy, eps=eps,
                                                 return_cls=True)
    (c_err, c_ref), (o_err, o_ref) = rel_err(torch, cls, want_cls), rel_err(torch, out, want)
    rel = {"cls": c_err / c_ref, "block": o_err / o_ref}
    emit({"phase": "head_width", "kernel": "fused_transformer_block_cls", "shape": list(x.shape),
          "policy": policy is not None, "rel_err": rel,
          "tol_rel": {"cls": STAGE_TOL, "block": BLOCK_TOL}})
    if not (rel["cls"] <= STAGE_TOL and rel["block"] <= BLOCK_TOL):
        raise AssertionError(f"CLS-row block at head width {x.shape[2] // H}: {rel}")
    return c_err


def check_packed_forward(torch, qkv, H, scale, policy=None, eps=1e-6):
    """The packed core's output and CLS rows against `attention_reference`,
    within STAGE_TOL. Returns the largest absolute error."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.block import attention_reference

    kw = {} if policy is None else {"policy": policy, "eps": eps}
    out, cls = ops.fused_attention_packed(qkv, H, scale=scale, return_cls=True, **kw)
    want, want_cls = attention_reference(qkv, H, scale, return_cls=True, **kw)
    (o_err, o_ref), (c_err, c_ref) = rel_err(torch, out, want), rel_err(torch, cls, want_cls)
    rel = {"attn": o_err / o_ref, "cls": c_err / c_ref}
    emit({"phase": "head_width", "kernel": "fused_attention_packed", "shape": list(qkv.shape),
          "policy": policy is not None, "rel_err": rel, "tol_rel": STAGE_TOL})
    if not max(rel.values()) <= STAGE_TOL:
        raise AssertionError(f"packed attention at head width {qkv.shape[2] // 3 // H}: {rel}")
    return max(o_err, c_err)


def check_head_widths(torch, dev, tally, widths=HD_WIDTHS, tokens=HD_TOKENS + HD_LONG):
    """(a): the block-level kernels at each head width of `widths` on seeded
    B=64 activations at every N of `tokens`, each against its plain
    version: the block forward stage by stage (`check_block`: plain, policy
    at eps 0.1 (and 1e-6 at N = 197), branch scales), its CLS rows, its
    backward (`check_block_backward`: plain, policy with dPolicy, branch
    scales, and at N = 197 planted exact ties), the packed attention both
    ways with the CLS fold (`check_attn_bwd`: two launches bit-equal), the
    half-block both ways (`check_attn_half`, `check_attn_half_backward`)
    and, at d = 96, the int8 block (`check_int8_block`). The long sequences
    (HD_LONG) take the block both ways in plain and policy mode and the
    packed attention both ways. The largest errors go into `tally`'s
    attention_hd (forward) and attention_hd_bwd rows."""
    fwd_err = bwd_err = 0.0
    for d, H, C in widths:
        w = hd_block(torch, dev, C, H, seed=d)
        w6 = tuple(w[k] for k in HALF_BLOCK_KEYS)
        scale, ln_eps = d ** -0.5, 1e-6
        for n in tokens:
            gen = torch.Generator(device=dev).manual_seed(100 * d + n)
            x = torch.randn((HD_BATCH, n, C), generator=gen, device=dev).to(torch.bfloat16)
            g = torch.randn((HD_BATCH, n, C), generator=gen, device=dev).to(torch.bfloat16)
            pol = (torch.rand((HD_BATCH, n), generator=gen, device=dev) < 0.6).float()
            pol[:, 0] = 1.0
            gcls = torch.randn((HD_BATCH, H, n), generator=gen, device=dev)
            long = n in HD_LONG
            scales = droppath_scales(torch, HD_BATCH, gen)
            with torch.no_grad():
                modes = [{}, {"policy": pol, "eps": 0.1}]
                if n == 197:
                    modes.append({"policy": pol, "eps": 1e-6})
                if not long:
                    modes.append({"branch_scales": scales})
                for kw in modes:
                    _, err = check_block(torch, x, w, H, scale, ln_eps, phase="head_width", **kw)
                    fwd_err = max(fwd_err, err)
                    bwd_err = max(bwd_err, check_block_backward(
                        torch, x, g, w, H, scale, ln_eps, phase="head_width", **kw))
                if n == 197:
                    x_tie, tied = planted_ties(torch, x, w, H, scale, ln_eps)
                    emit({"phase": "head_width", "planted_ties": {"d": d, "tied_rows": tied}})
                    bwd_err = max(bwd_err, check_block_backward(
                        torch, x_tie, g, w, H, scale, ln_eps, policy=pol, eps=0.1,
                        phase="head_width"))
                for kw in ({}, {"policy": pol, "eps": 0.1}):
                    qkv, do = attn_bwd_inputs(torch, x, g, w, H, scale, ln_eps, **kw)
                    fwd_err = max(fwd_err, check_packed_forward(torch, qkv, H, scale, **kw))
                    bwd_err = max(bwd_err, check_attn_bwd(torch, {
                        "what": f"head_width_{d}", "block": None, "qkv": qkv, "g": do,
                        "heads": H, "scale": scale, "policy": kw.get("policy"), "gcls": gcls,
                        "eps": kw.get("eps", 1e-6)}))
                if long:
                    continue
                fwd_err = max(fwd_err, check_cls_rows(torch, x, w, H, scale))
                fwd_err = max(fwd_err, check_cls_rows(torch, x, w, H, scale, pol, 0.1))
                for kw in ({}, {"policy": pol, "eps": 0.1}):
                    fwd_err = max(fwd_err, check_attn_half(torch, x, w6, H, scale, ln_eps,
                                                           cls=True, phase="head_width", **kw))
                    bwd_err = max(bwd_err, check_attn_half_backward(
                        torch, x, g, w6, H, scale, ln_eps, phase="head_width", **kw))
                if d == 96 and n == 197:
                    from dense2sparse_vit_torch.ops.quant import quantize_block_params

                    _, err = check_int8_block(torch, x, quantize_block_params(w), H, scale, ln_eps)
                    fwd_err = max(fwd_err, err)
            torch.cuda.empty_cache()
    if tally is not None:
        tally.err("attention_hd", fwd_err)
        tally.err("attention_hd_bwd", bwd_err)


def hd_step_launches(model) -> dict:
    """One cross-entropy step of a model whose every block is fused: each
    block's forward and backward kernel (with branch scales where its drop
    path rate is not 0), the LayerNorm backwards and column sums, and at a
    head width other than 64 the attention_hd cores (the forward's and the
    backward's recompute, one backward)."""
    depth = len(model.blocks)
    scaled = sum(blk.drop_path.rate > 0 for blk in model.blocks)
    out = {**NO_LAUNCHES, **norm_launches(depth),
           "fused_transformer_block": depth - scaled,
           "fused_transformer_block[scaled]": scaled,
           "fused_transformer_block_backward": depth - scaled,
           "fused_transformer_block_backward[scaled]": scaled}
    if model.cfg.embed_dim != 64 * model.cfg.num_heads:
        out.update(attention_hd=2 * depth, attention_hd_bwd=depth)
    else:
        out["attention_bwd"] = depth
    return out


def check_hd_step(torch, dev, model, name, kwargs, tally):
    """(b): one cross-entropy backward through `model` (its `kwargs`, e.g.
    drop path) against its plain twin on the same weights, images, labels
    and draws: the loss within STEP_LOSS_TOL, the gradients within
    STEP_GRAD_TOL (`compare_steps`), the kernels' launches
    (`hd_step_launches`) and none by the twin."""
    import copy

    import torch.nn.functional as F

    from dense2sparse_vit_torch import ops

    model = copy.deepcopy(model)
    model.cfg = model.cfg.replace(**kwargs)
    rate = kwargs.get("drop_path_rate", 0.0)
    for i, blk in enumerate(model.blocks):
        blk.drop_path.rate = rate * i / max(len(model.blocks) - 1, 1)
    model.train()
    plain = plain_twin(model).train()
    side = model.cfg.img_size
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((B_FAMILY, side, side, 3), device=dev, generator=gen)
    labels = torch.randint(0, model.cfg.num_classes, (B_FAMILY,), device=dev, generator=gen)

    def step(m):
        out = m(x, generator=torch.Generator(device=dev).manual_seed(13))
        logits = (out[-1] if isinstance(out, tuple) else out).float()
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        return loss.item(), {n: p.grad.float() for n, p in m.named_parameters()
                             if p.grad is not None}

    ops.reset_launch_counts()
    got = step(model)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    want = step(plain)
    torch.cuda.synchronize()
    check_mode_launches(ops.launch_counts(), NO_LAUNCHES, f"{name} plain step")
    check_mode_launches(counts, hd_step_launches(model), f"{name} step")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    compare_steps(torch, f"head_width {name} step", got, want, set(want[1]))
    del model, plain
    return counts


def check_hd_int8(torch, dev, model, tally, smi):
    """vit_small_patch16_224 with quant="int8" on every block (the same
    weights): its B=32 forward's launches (every block int8, through the
    attention_hd core), its logits against the bf16 kernels' (cosine
    similarity at least INT8_LOGITS_COS), the int8 block against its plain
    version at the first and the last block's input (`check_int8_block`)."""
    import copy

    from dense2sparse_vit_torch import ops

    q = copy.deepcopy(model)
    q.cfg = q.cfg.replace(quant="int8")
    for blk in q.blocks:
        blk.quant = "int8"
    side = model.cfg.img_size
    x = torch.randn((B_FAMILY, side, side, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    inputs, last = {}, len(q.blocks) - 1
    hooks = [q.blocks[i].register_forward_pre_hook(
        lambda m, a, i=i: inputs.__setitem__(i, a[0].detach())) for i in (0, last)]
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits = q(x)[-1].float()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ref = model(x)[-1].float()
        for h in hooks:
            h.remove()
        blk = q.blocks[0]
        args = (blk.attn.num_heads, blk.attn.scale, blk.norm1.eps)
        err = max(check_int8_block(torch, xi, q.blocks[i].int8_weights(torch.bfloat16), *args,
                                   block=i)[1] for i, xi in inputs.items())
    want = {**NO_LAUNCHES, "fused_transformer_block_int8": len(q.blocks),
            "attention_hd": len(q.blocks)}
    check_mode_launches(counts, want, "int8 vit_small forward")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    tally.err("fused_transformer_block_int8", err)
    cos = torch.nn.functional.cosine_similarity(logits.flatten(), ref.flatten(), dim=0).item()
    emit({"phase": "head_width", "int8": "vit_small_patch16_224", "logits_vs_bf16_kernels": {
        "cos": cos, "tol_cos": INT8_LOGITS_COS}, "launches": counts, "card": smi})
    if not cos >= INT8_LOGITS_COS:
        raise AssertionError(f"int8 vit_small logits against bf16: cos {cos}")
    del q


def check_hd_others(torch, dev, smi) -> dict:
    """(c): each name of HD_OTHERS built on the card at full width (bf16,
    seeded weights), a B=8 eval forward against the same module run in fp32
    (the worst relative error printed; OTHERS_TOL guards against a gross
    fault), and no kernel launched."""
    import copy

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import create_model

    worst = {}
    for name in HD_OTHERS:
        m = create_model(name, dtype="bfloat16", device=dev,
                         generator=torch.Generator().manual_seed(0)).eval()
        m32 = copy.deepcopy(m)
        if hasattr(m32, "cfg"):
            m32.cfg = m32.cfg.replace(dtype="float32")
        else:
            m32.dtype = "float32"
        x = torch.randn((B_OTHERS, 224, 224, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(21))
        with torch.inference_mode():
            ops.reset_launch_counts()
            out = m(x)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            ref = m32(x)
        err, mag = rel_err(torch, out, ref)
        worst[name] = err / mag
        emit({"phase": "head_width", "model": name, "class": type(m).__name__,
              "params": sum(p.numel() for p in m.parameters()), "shape": list(out.shape),
              "worst_rel_err_vs_fp32": worst[name], "guard": OTHERS_TOL, "card": smi})
        check_mode_launches(counts, NO_LAUNCHES, f"{name} forward")
        if not worst[name] <= OTHERS_TOL:
            raise AssertionError(f"{name}: bf16 against fp32 {worst[name]}")
        del m, m32
        torch.cuda.empty_cache()
    return worst


def launch_ms(torch, fn, names, iters: int = 10):
    """Device ms of one launch of each kernel whose name holds one of `names`
    over `iters` calls of fn under torch.profiler: each kernel's recorded
    time over its recorded launches, so that a window which loses some of
    its launches (whole runs of this script have shown such windows, down to
    none) still reads the time of one; 0.0 where none was recorded. Returns
    ({name: ms}, {name: launches recorded})."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                       False):
            continue
        name = next((k for k in names if k in e.key), None)
        if name is not None:
            total[name] += e.self_device_time_total / 1e3
            count[name] += e.count
    return {k: total[k] / count[k] if count[k] else 0.0 for k in names}, count


def time_head_widths(torch, dev, smi) -> dict:
    """(d): at each head width and N of HD_TIMED (B = 64, seeded qkv): the
    device ms of a launch of the forward core in its own window (30 calls
    of `ops.fused_attention_packed`) and of the backward core
    (attention_hd_bwd_kernel, 10 calls of `ops.fused_attention_backward_
    packed`), read by `launch_ms`, each beside its plain version (CUDA
    graphs), SDPA's forward and backward (CUDA graphs) and its bound; each
    row keeps the launches its window recorded. A forward window with none
    takes the forward that the backward recomputes (the same launch at the
    same shape, its statistics written too; "timer": "profiler,
    recompute"); a row with none in either window says "graph": the entry's
    time from a CUDA graph. Returns {(d, N): (forward, backward)} rows."""
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.ops.attention import attention_backward_reference
    from dense2sparse_vit_torch.ops.block import attention_reference
    import torch.nn.functional as F

    out = {}
    for d, H, C in HD_WIDTHS:
        for n in HD_TIMED:
            gen = torch.Generator(device=dev).manual_seed(300 + n + d)
            qkv = torch.randn((HD_BATCH, n, 3 * C), generator=gen, device=dev).to(torch.bfloat16)
            g = torch.randn((HD_BATCH, n, C), generator=gen, device=dev).to(torch.bfloat16)
            scale = d ** -0.5
            with torch.no_grad():
                fwd = lambda: ops.fused_attention_packed(qkv, H, scale=scale)  # noqa: E731
                bwd = lambda: ops.fused_attention_backward_packed(  # noqa: E731
                    qkv, g, H, scale=scale)
                f_one, f_seen = launch_ms(torch, fwd, HD_GROUPS[:1], iters=30)
                b_one, b_seen = launch_ms(torch, bwd, HD_GROUPS[:2])
                f_ms, b_ms = f_one["attention_hd_kernel"], b_one["attention_hd_bwd_kernel"]
                timers = ["profiler", "profiler"]
                if f_ms == 0.0 and b_one["attention_hd_kernel"] > 0.0:
                    f_ms, timers[0] = b_one["attention_hd_kernel"], "profiler, recompute"
                elif f_ms == 0.0:
                    f_ms, timers[0] = graph_ms(torch, fwd), "graph"
                if b_ms == 0.0:
                    b_ms, timers[1] = graph_ms(torch, bwd), "graph"
                f_plain = graph_ms(torch, lambda: attention_reference(qkv, H, scale), iters=5)
                b_plain = graph_ms(torch, lambda: attention_backward_reference(
                    qkv, g, H, scale), iters=5)
                q, k, v, _ = sdpa_inputs(torch, qkv, g, H)
                f_lib = graph_ms(torch, lambda: F.scaled_dot_product_attention(
                    q.detach(), k.detach(), v.detach(), scale=scale))
            b_lib = sdpa_backward_ms(torch, qkv, g, H, scale)[0]
            fb, bb = attention_bound(HD_BATCH, n, C, H), attention_backward_bound(HD_BATCH, n, C, H)
            rows = (
                {"kernel": "attention_hd", "ms": f_ms, "timer": timers[0], "plain_ms": f_plain,
                 "library_ms": f_lib, "bound": fb, "launches_recorded": f_seen},
                {"kernel": "attention_hd_bwd", "ms": b_ms, "timer": timers[1],
                 "plain_ms": b_plain, "library_ms": b_lib, "bound": bb,
                 "launches_recorded": b_seen})
            for r in rows:
                b = r.pop("bound")
                emit({"phase": "head_width", "d": d, "heads": H, "shape": [HD_BATCH, n, 3 * C],
                      **r, "bound_ms": max(b.values()),
                      "bound_by": "operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes",
                      "card": smi})
                r["bound"] = b
            out[(d, n)] = rows
    return out


def phase_head_widths(torch, dev, tally, smi):
    """Phase 35: (a) the block-level kernels at head widths 12 and 96
    (`check_head_widths`); (b) vit_small_patch16_224 and t2t_vit_14_resnext
    at full width and depth, bf16, seeded weights: the fused B=32 eval
    forward against the plain twin (`check_family_model`, the block kernel
    and the attention_hd core once a block), one cross-entropy backward
    against the twin (`check_hd_step`; resnext at drop path 0.1, so the
    branch-scale mode runs at d = 12), and vit_small with quant="int8"
    (`check_hd_int8`); (c) the other new names (`check_hd_others`); (d) the
    new path's kernels timed (`time_head_widths`) and a B=64 forward of
    each of the two models in img/s. The kernels line's attention_hd rows
    take (b)'s launches, each at (d)'s N = 197 time of its width."""
    t0 = time.perf_counter()
    check_head_widths(torch, dev, tally)
    torch.cuda.empty_cache()
    launches, timed = {}, {}
    for name, kwargs in HD_MODELS:
        model = check_family_model(torch, dev, name, {}, tally, smi)
        d = model.cfg.embed_dim // model.cfg.num_heads
        counts = check_hd_step(torch, dev, model, name, kwargs, tally)
        for k in ("attention_hd", "attention_hd_bwd"):
            launches[(k, d)] = launches.get((k, d), 0) + counts[k]
        launches[("attention_hd", d)] += model.cfg.depth  # the eval forward's
        timed[name] = time_family_model(torch, dev, model, smi)
        emit({"phase": "head_width", "timed": name, **timed[name]})
        if name == "vit_small_patch16_224":
            check_hd_int8(torch, dev, model, tally, smi)
            launches[("attention_hd", d)] += model.cfg.depth
        del model
        torch.cuda.empty_cache()
    worst = check_hd_others(torch, dev, smi)
    times = time_head_widths(torch, dev, smi)
    for (kernel, d), calls in launches.items():  # (b) added the launches themselves
        r = times[(d, 197)][0 if kernel == "attention_hd" else 1]
        tally.add(kernel, calls, r["ms"], r["plain_ms"], r["bound"], r["library_ms"])
    emit({"phase": "head_width", "seconds": time.perf_counter() - t0,
          "img_per_s": {n: t["img_per_s"] for n, t in timed.items()},
          "busy_share": {n: t["busy_share"] for n, t in timed.items()},
          "others_worst_rel_err": worst, "card": smi})


# ---- 36. distributed training ----------------------------------------------

DIST_TIMED_STEPS = 5
GLOO_BATCH, GLOO_RANKS = 64, 2  # (d): two ranks of 32 on the one card
GLOO_LOSS_TOL = 1e-3  # (d)'s loss against one process's, relative
DIST_LOOP_STEPS = 2  # (c): steps an epoch (max_steps_per_epoch)


def dist_trainer(torch, dev, mesh=None):
    """The headline student and teacher of `build_trainer` (mode "topk":
    the same seeds, AdamW past the warmup); the step trains the student
    under `wrap_ddp` over `mesh`'s data group where a mesh is given:
    (student, step, optimizer)."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import (
        HEADLINE_KWARGS, HEADLINE_MODEL, HEADLINE_TEACHER, create_model)
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step
    from dense2sparse_vit_torch.train.train_step import wrap_ddp

    student = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                           generator=torch.Generator().manual_seed(0), **HEADLINE_KWARGS)
    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=True, device=dev,
                           dtype="bfloat16", generator=torch.Generator().manual_seed(2))
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning, train=TrainConfig())
    opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
    opt.count = cfg.train.warmup_epochs * STEPS_PER_EPOCH
    net = student if mesh is None else wrap_ddp(student, cfg, mesh)
    return student, make_train_step(net, teacher, opt, cfg), opt


def gloo_rank(rank, port, out_dir):
    """(d)'s rank: a gloo group of GLOO_RANKS processes on the one card,
    one DDP step on this rank's rows of the first GLOO_BATCH images of
    `train_batch`; writes the global loss, the updated parameters and the
    averaged gradients."""
    import datetime
    import os

    import torch

    from dense2sparse_vit_torch.core.mesh import local_rows, make_mesh, maybe_initialize_distributed
    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.parallel import global_batch_metrics

    _cuda.library()
    maybe_initialize_distributed(f"127.0.0.1:{port}", GLOO_RANKS, rank, device_type="cuda",
                                 backend="gloo", timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    mesh = make_mesh()
    student, step, _ = dist_trainer(torch, dev, mesh)
    images, labels = train_batch(torch, dev)
    x, y = local_rows(images[:GLOO_BATCH], mesh), local_rows(labels[:GLOO_BATCH], mesh)
    metrics = global_batch_metrics(step(x, y, TRAIN_EPOCH), mesh.data_group)
    torch.cuda.synchronize()
    torch.save({"loss": float(metrics["loss"]),
                "params": {n: p.detach().cpu() for n, p in student.named_parameters()},
                "grads": {n: p.grad.float().cpu() for n, p in student.named_parameters()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_distributed(torch, dev, tally, smi, root):
    """Phase 36: distributed training on the one card. (a) A process group
    of one rank over NCCL (`maybe_initialize_distributed` on a free
    localhost port): one B=128 step of the headline student under DDP
    (`wrap_ddp`) against the same step unwrapped from the same weights and
    batch: the loss and every updated parameter bit-equal, and the DDP
    step's launches PER_TRAIN_STEP (the kernels line takes them). (b) Step
    ms with and without DDP, CUDA events, medians of DIST_TIMED_STEPS
    alternating steps. (c) `run_experiment` under that group (DDP at world
    size 1) over phase 32's folder: one epoch of DIST_LOOP_STEPS steps and
    its eval, one checkpoint written; then --resume with --epochs 2
    continues at step DIST_LOOP_STEPS. The group is destroyed. (d) Two
    processes on the one card in a gloo group, each with half of a
    GLOO_BATCH batch: the DDP step against one process's on the whole
    batch (loss within GLOO_LOSS_TOL; the averaged gradients within
    STEP_GRAD_TOL as one vector, relative L2; the parameters within two
    Adam steps of one process's, bit-equal between the ranks). (d)'s
    processes start before (c) and run beside it (no timing there); any
    failure kills them."""
    import os
    import tempfile

    import torch.multiprocessing as mp

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.core.mesh import free_port, make_mesh, maybe_initialize_distributed
    from dense2sparse_vit_torch.train import loop
    from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    out = tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_")
    gloo = None
    maybe_initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device_type="cuda")
    try:
        mesh = make_mesh()
        # (a) the DDP step against the unwrapped one
        student, ddp_step, _ = dist_trainer(torch, dev, mesh)
        twin, step, _ = dist_trainer(torch, dev)
        images, labels = train_batch(torch, dev)
        ops.reset_launch_counts()
        got = ddp_step(images, labels, TRAIN_EPOCH)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = step(images, labels, TRAIN_EPOCH)
        if counts != PER_TRAIN_STEP:
            raise AssertionError(f"distributed: DDP step launches {counts}, "
                                 f"expected {PER_TRAIN_STEP}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        differ = [n for (n, p), q in zip(student.named_parameters(), twin.parameters())
                  if not torch.equal(p, q)]
        loss_equal = bool(torch.equal(got["loss"], want["loss"]))
        emit({"phase": "distributed", "case": "ddp_world_1_nccl", "batch": B_TRAIN,
              "loss": got["loss"].item(), "unwrapped_loss": want["loss"].item(),
              "loss_bit_equal": loss_equal, "params_not_bit_equal": differ,
              "launches": {k: v for k, v in counts.items() if v}})
        if not loss_equal or differ:
            raise AssertionError(f"distributed: the DDP step is not the unwrapped one: loss "
                                 f"{loss_equal}, parameters differ {differ[:5]}")
        # (b) step ms with and without DDP, alternating
        times = {"ddp": [], "plain": []}
        for _ in range(DIST_TIMED_STEPS):
            for key, fn in (("ddp", ddp_step), ("plain", step)):
                s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s0.record()
                fn(images, labels, TRAIN_EPOCH)
                s1.record()
                torch.cuda.synchronize()
                times[key].append(s0.elapsed_time(s1))
        med = {k: statistics.median(v) for k, v in times.items()}
        emit({"phase": "distributed", "case": "step_ms", "batch": B_TRAIN, "ddp_ms": med["ddp"],
              "plain_ms": med["plain"], "ddp_overhead_ms": med["ddp"] - med["plain"],
              "steps": DIST_TIMED_STEPS, "all_ms": times, "card": smi})
        del student, twin, ddp_step, step, images, labels, got, want
        torch.cuda.empty_cache()
        # (d)'s ranks start now and run beside (c)
        t1 = time.perf_counter()
        gloo = mp.start_processes(gloo_rank, args=(free_port(), out.name), nprocs=GLOO_RANKS,
                                  join=False, start_method="spawn")
        # (c) the training entry point under the group, and its resume
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
            workdir = os.path.join(tmp, "run")
            wrapped = []
            real_wrap = loop.wrap_ddp
            loop.wrap_ddp = lambda *a, **k: wrapped.append(1) or real_wrap(*a, **k)
            try:
                runs = []
                for epochs, resume in ((1, False), (2, True)):
                    cfg, _ = loop_config(root, "--epochs", str(epochs))
                    ops.reset_launch_counts()
                    with LoopSpy(torch) as spy:
                        summary = loop.run_experiment(cfg, workdir, device=dev, resume=resume,
                                                      max_steps_per_epoch=DIST_LOOP_STEPS)
                    torch.cuda.synchronize()
                    counts = ops.launch_counts()
                    check_step_launches(spy.steps, PER_TRAIN_STEP, "distributed loop train")
                    check_step_launches(spy.evals, PER_EVAL_STEP["topk"], "distributed loop eval")
                    for k, v in counts.items():
                        tally.rows[k]["launches"] += v
                    latest = sorted(os.listdir(os.path.join(workdir, "ckpt", "latest")))
                    runs.append({"steps": len(spy.steps), "evals": len(spy.evals),
                                 "latest": latest, "summary": summary})
            finally:
                loop.wrap_ddp = real_wrap
            last = CheckpointManager(os.path.join(workdir, "ckpt")).restore(map_location="cpu")
            emit({"phase": "distributed", "case": "run_experiment_world_1_nccl", "runs": runs,
                  "ddp_wrapped": len(wrapped), "final_step": last["step"]})
            n = DIST_LOOP_STEPS
            if (len(wrapped) != 2 or [r["steps"] for r in runs] != [n, n]
                    or runs[0]["latest"] != [f"step_{n}.json", f"step_{n}.pt"]
                    or last["step"] != 2 * n or runs[1]["summary"]["epochs"] != 2):
                raise AssertionError(f"distributed: the entry point under DDP: {runs}, "
                                     f"wrapped {len(wrapped)}, final step {last['step']}")
        torch.distributed.destroy_process_group()
        # (d) two ranks on the one card over gloo, against one process
        deadline = time.perf_counter() + 300
        while not gloo.join(timeout=1):
            if time.perf_counter() > deadline:
                raise AssertionError("distributed: the gloo ranks still run after 300 s")
        spawn_s = time.perf_counter() - t1
        ranks = [torch.load(os.path.join(out.name, f"rank{r}.pt"), weights_only=False)
                 for r in range(GLOO_RANKS)]
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        if gloo is not None:
            for proc in gloo.processes:
                if proc.is_alive():
                    proc.kill()
        out.cleanup()
    student, step, opt = dist_trainer(torch, dev)
    images, labels = train_batch(torch, dev)
    want = step(images[:GLOO_BATCH], labels[:GLOO_BATCH], TRAIN_EPOCH)
    grads = {n: p.grad.float().cpu() for n, p in student.named_parameters()}
    names = [n for n in grads if grads[n].abs().max() > 0]
    compare_steps(torch, "distributed", (ranks[0]["loss"], ranks[0]["grads"]),
                  (want["loss"].item(), grads), names)
    loss_rel = abs(ranks[0]["loss"] - want["loss"].item()) / abs(want["loss"].item())
    lr, wd = max(g["lr"] for g in opt.param_groups), opt.cfg.weight_decay
    worst = 0.0
    for n, p in student.named_parameters():
        p = p.detach().cpu()
        excess = ((ranks[0]["params"][n] - p).abs() - 2.02 * lr * (1 + wd * p.abs())).max()
        worst = max(worst, excess.item())
    ranks_equal = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n])
                      for n in ranks[0]["params"])
    emit({"phase": "distributed", "case": "gloo_2_ranks_one_card", "batch": GLOO_BATCH,
          "loss": ranks[0]["loss"], "one_process_loss": want["loss"].item(),
          "loss_rel_err": loss_rel, "tol": GLOO_LOSS_TOL, "param_excess_over_2_steps": worst,
          "ranks_bit_equal": ranks_equal, "spawn_seconds": round(spawn_s, 3)})
    if loss_rel > GLOO_LOSS_TOL or worst > 0 or not ranks_equal:
        raise AssertionError(f"distributed: two gloo ranks against one process: loss {loss_rel},"
                             f" parameters {worst}, ranks equal {ranks_equal}")
    emit({"phase": "distributed", "seconds": round(time.perf_counter() - t0, 3), "card": smi})


# ---- 37. the experiment drivers, visualization, native normaliser, flat AdamW

EXP_BATCH = 128  # (a)'s eval batch: 720 images, a padded tail of 80
EXP_PANEL = 16  # (b)'s and (c)'s images
EXP_DROP_MODELS = ("dino_small", "deit_small_patch16_224")
EXP_MASK_EPOCHS, EXP_MASK_BLOCK = 5, 7
EXP_LOOP_STEPS = 2  # (d): steps of its one epoch
EVAL_COUNT_TOL = 1e-2  # (a): kernel against plain top-1 counts, a share of the images
MASK_LOSS_TOL = 2e-2  # (c): epoch 0's loss, kernel against plain, relative
MASK_SHARE_MARGIN = 2e-3  # (b): keep-mask entries, kernel's agreement with fp32 below bf16 plain's
FLAT_PARAM_TOL = 1e-5  # (f): fused against per-parameter AdamW, relative per tensor
NATIVE_ULPS = 2  # (e): ulps of the output's largest magnitude
FLAT_STEPS = 3
NATIVE_REPS = 20  # (e): timed calls of each version at each shape
PER_EVAL_BATCH = {**NO_LAUNCHES, "fused_transformer_block": 24, "fused_predictor_lg": 3,
                  "fused_gather_tokens": 3}
PER_PATCH_DROP = {**NO_LAUNCHES, "fused_transformer_block": 11,
                  "fused_transformer_block_cls": 1}
_MASK_BWD = 12 - EXP_MASK_BLOCK
PER_MASK_EPOCH = {**NO_LAUNCHES, "fused_transformer_block": 12,
                  "fused_transformer_block_backward": _MASK_BWD,
                  **norm_launches(blocks=_MASK_BWD), **core_launches(_MASK_BWD)}
PER_TEACHER = {**NO_LAUNCHES, "fused_transformer_block": 12}


def scaled(table: dict, n: int, plus: dict = NO_LAUNCHES) -> dict:
    """n times each launch count of `table`, plus `plus`'s."""
    return {k: n * v + plus[k] for k, v in table.items()}


def check_eval_agreement(kernel: dict, plain: dict, images: int) -> dict:
    """(a): the image count and the pruned and unpruned correct counts of
    the kernel run against the plain run's, within EVAL_COUNT_TOL of the
    images. Returns the differences."""
    diff = {k: abs(kernel[f"{k}_top1"] - plain[f"{k}_top1"]) * images
            for k in ("pruned", "unpruned")}
    if (kernel["images"] != images or plain["images"] != images
            or any(d > EVAL_COUNT_TOL * images for d in diff.values())):
        raise AssertionError(f"experiments: eval_imagenet kernel {kernel} against plain {plain}")
    return diff


def keep_agreement(spatial, plain_spatial, exact_spatial) -> dict:
    """(b): the share of equal entries over the 18 (foreground, rate) keep
    masks of the kernel's (B, N) attention `spatial` against the bf16
    plain model's (`kernel_vs_plain`), and of each against the fp32 plain
    model's (`kernel_vs_fp32`, `plain_vs_fp32`). Random-weight attention is
    near-uniform, so bf16 rounding alone reorders patches at the cut;
    `masks_agree` asks the kernel's masks to agree with the fp32 ones no
    less than the bf16 plain layers' do."""
    import numpy as np

    from dense2sparse_vit_torch.experiments.display_patch_drop import patch_drop_masks

    got, plain, exact = (patch_drop_masks(s / s.sum(-1, keepdims=True))
                         for s in (spatial, plain_spatial, exact_spatial))

    def share(a, b):
        return float(np.mean([a[k] == b[k] for k in b]))

    return {"kernel_vs_plain": share(got, plain), "kernel_vs_fp32": share(got, exact),
            "plain_vs_fp32": share(plain, exact)}


def masks_agree(shares: dict) -> bool:
    """(b): the kernel's masks agree with the fp32 model's in a share of
    the entries at most MASK_SHARE_MARGIN below the bf16 plain model's."""
    return shares["kernel_vs_fp32"] >= shares["plain_vs_fp32"] - MASK_SHARE_MARGIN


class WeightGradSpy:
    """(c): within the block, counts the trainable block's backward calls
    and the weight gradients they return (None for a frozen weight)."""

    def __enter__(self):
        from dense2sparse_vit_torch.ops import block

        self.cls = block._TrainableBlock
        self.saved = self.cls.__dict__["backward"]
        real = self.saved.__func__
        self.calls = self.weight_grads = 0

        def backward(ctx, g):
            out = real(ctx, g)
            self.calls += 1
            self.weight_grads += sum(t is not None for t in out[8:])
            return out

        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = self.saved
        return False


def mask_loss(h: dict) -> float:
    """(c): the loss `kd_loss` optimises, from an epoch's metrics."""
    return h["kd_kl"] + h["kd_ce"] + h["kd_ratio_penalty"]


def check_mask_history(kernel: list, plain: list, moved: float) -> float:
    """(c): every epoch's metrics finite, the logits moved, epoch 0's loss
    within MASK_LOSS_TOL of the plain run's. Returns that relative error."""
    import math

    finite = all(math.isfinite(v) for h in kernel for v in h.values())
    rel = abs(mask_loss(kernel[0]) - mask_loss(plain[0])) / abs(mask_loss(plain[0]))
    if not finite or not moved > 0 or rel > MASK_LOSS_TOL:
        raise AssertionError(f"experiments: optimized_mask finite {finite}, logits moved "
                             f"{moved}, epoch-0 loss rel err {rel}")
    return rel


def native_ulps(got, want) -> float:
    """(e): max |got - want| in ulps of want's largest magnitude."""
    import numpy as np

    return float(np.abs(got - want).max() / np.spacing(np.abs(want).max()))


def tensor_rel_diffs(torch, a: dict, b: dict) -> dict:
    """(f): {name: max |a - b| / max |b|} over b's tensors."""
    return {k: (a[k].float() - v.float()).abs().max().item()
            / max(v.float().abs().max().item(), 1e-30) for k, v in b.items()}


def params_rel_diff(torch, a: dict, b: dict) -> float:
    """(f): the largest per-tensor max |a - b| / max |b|."""
    return max(tensor_rel_diffs(torch, a, b).values())


def write_flat_folder(root, n=EXP_PANEL, seed=5) -> None:
    """`n` JPEGs of 256-400 px in one folder, from a numpy seed."""
    import os

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(256, 401, 2))
        base = rng.integers(0, 256, (1, 1, 3)).astype(np.float32)
        blob = np.exp(-((np.arange(h)[:, None] - h / 2) ** 2 + (np.arange(w)[None] - w / 2) ** 2)
                      / (2 * (min(h, w) / 5) ** 2))[..., None] * 120
        arr = np.clip(base + blob + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"{i:03d}.jpg"), quality=90)


def exp_eval(torch, dev, tally, smi, root, tmp):
    """(a) `eval_imagenet.evaluate` of a DeiT-S checkpoint over the folder."""
    import os

    import dense2sparse_vit_torch.experiments.eval_imagenet as ev
    from dense2sparse_vit_torch import ops

    model, _ = ev.build_model("deit_small", (3, 6, 9), (0.7, 0.49, 0.343), "float32", False)
    model.init_weights(torch.Generator().manual_seed(7))
    ckpt = os.path.join(tmp, "deit_small.pth")
    torch.save({"model": {k: v for k, v in model.state_dict().items()
                          if not k.startswith("score_predictor")}}, ckpt)
    n_images = len(ev.ImageFolder(root))
    firsts = {}
    real_build = ev.build_model

    def build(*a, **k):
        m, has = real_build(*a, **k)
        calls = []

        def hook(mod, args, out):
            if len(calls) < 2:  # the first batch's pruned and unpruned logits
                calls.append(out.logits.float().clone())
                firsts[k.get("use_fused_attention", a[-1])] = calls
        m.register_forward_hook(hook)
        return m, has

    ev.build_model = build
    try:
        runs = {}
        for fused in (False, True):  # the plain run first: the kernel run's decode is warm
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[fused] = ev.evaluate(arch="deit_small", imgnet_val_dir=root, checkpoint=ckpt,
                                      batch_size=EXP_BATCH, dtype="bfloat16",
                                      use_fused_attention=fused, device=dev)
            torch.cuda.synchronize()
            runs[fused]["wall_s"] = time.perf_counter() - t0
            if fused:
                counts = ops.launch_counts()
    finally:
        ev.build_model = real_build
    batches = -(-n_images // EXP_BATCH)
    check_mode_launches(counts, scaled(PER_EVAL_BATCH, batches), "eval_imagenet")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    diff = check_eval_agreement(runs[True], runs[False], n_images)
    errs = {}
    for i, what in enumerate(("pruned", "unpruned")):
        err, scale = rel_err(torch, firsts[True][i], firsts[False][i])
        errs[what] = {"max_abs_err": err, "max_abs_ref": scale}
    u = errs["unpruned"]
    emit({"phase": "experiments", "case": "eval_imagenet", "images": n_images,
          "batch": EXP_BATCH, "kernel": runs[True], "plain": runs[False],
          "count_diff": diff, "first_batch_logits": errs, "tol_rel": LOGITS_TOL,
          "img_per_s": n_images / runs[True]["wall_s"],
          "plain_img_per_s": n_images / runs[False]["wall_s"],
          "launches_per_batch": {k: v // batches for k, v in counts.items() if v}, "card": smi})
    # the pruned logits follow the kept tokens, which may differ at near-ties
    if u["max_abs_err"] > LOGITS_TOL * max(u["max_abs_ref"], 1e-3):
        raise AssertionError(f"experiments: eval_imagenet's first-batch unpruned logits {u}")


def exp_patch_drop(torch, dev, tally, smi, tmp):
    """(b) `display_patch_drop` on dino_small and DeiT-S."""
    import os

    import dense2sparse_vit_torch.experiments.display_patch_drop as dpd
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.models import create_model

    folder = os.path.join(tmp, "flat")
    write_flat_folder(folder)
    images = dpd.load_panel(folder, EXP_PANEL, dev)
    for name in EXP_DROP_MODELS:
        model = create_model(name, device=dev, dtype="bfloat16", use_fused_attention=True).eval()
        plain, exact = (create_model(name, device=dev, dtype=dtype,
                                     use_fused_attention=False).eval()
                        for dtype in ("bfloat16", "float32"))
        plain.load_state_dict(model.state_dict())
        exact.load_state_dict(model.state_dict())
        ops.reset_launch_counts()
        with torch.no_grad():
            rows = model(images, return_selfattention=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_mode_launches(counts, PER_PATCH_DROP, f"display_patch_drop {name}")
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        with torch.no_grad():
            want = plain(images, return_selfattention=True)
        err, scale = rel_err(torch, rows, want)
        tally.err("fused_transformer_block_cls", err)
        shares = keep_agreement(*(dpd.attention_scores(m, images) for m in (model, plain, exact)))
        out = os.path.join(tmp, f"drop_{name}")
        ops.reset_launch_counts()
        files = dpd.generate_patch_drop_masked_image(model, images, out)
        counts = ops.launch_counts()
        for k, v in counts.items():
            tally.rows[k]["launches"] += v
        written = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        emit({"phase": "experiments", "case": "display_patch_drop", "model": name,
              "batch": EXP_PANEL, "cls_rows_rel_err": err / scale, "tol_rel": STAGE_TOL,
              "keep_agreement": shares, "margin": MASK_SHARE_MARGIN, "pngs": len(written)})
        if (err > STAGE_TOL * scale or not masks_agree(shares) or len(written) != 18
                or len(files) != 18 or counts != PER_PATCH_DROP):
            raise AssertionError(f"experiments: display_patch_drop {name}: rows {err / scale}, "
                                 f"masks {shares}, {len(written)} PNGs, launches {counts}")
        del model, plain, exact


def exp_optimized_mask(torch, dev, tally, smi, root):
    """(c) `optimized_mask.run_optimized_mask` on DeiT-S at B=16."""
    import numpy as np

    import dense2sparse_vit_torch.experiments.optimized_mask as om
    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.core.config import DataConfig, deit_small
    from dense2sparse_vit_torch.data import ImageFolder, eval_transform

    ds = ImageFolder(root, eval_transform(DataConfig()))
    pairs = [ds[i * 37] for i in range(EXP_PANEL)]
    images = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    labels = torch.tensor([p[1] for p in pairs], device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with WeightGradSpy() as spy:
        logits, hist = om.run_optimized_mask(images, labels, num_epochs=EXP_MASK_EPOCHS,
                                             mask_block=EXP_MASK_BLOCK, device=dev)
    t5 = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    om.run_optimized_mask(images, labels, num_epochs=1, mask_block=EXP_MASK_BLOCK, device=dev)
    t1 = time.perf_counter() - t0
    _, plain = om.run_optimized_mask(
        images, labels, num_epochs=1, mask_block=EXP_MASK_BLOCK, device=dev,
        cfg=deit_small(dtype="bfloat16", use_fused_attention=False))
    check_mode_launches(counts, scaled(PER_MASK_EPOCH, EXP_MASK_EPOCHS, PER_TEACHER),
                        "optimized_mask")
    for k, v in counts.items():
        tally.rows[k]["launches"] += v
    n = logits.shape[0]
    init = om.standard_normal((n, 2), torch.Generator().manual_seed(212 + 3)) * np.sqrt(
        2.0 / (n + 2))
    moved = (logits.cpu() - init).abs().max().item()
    rel = check_mask_history(hist, plain, moved)
    emit({"phase": "experiments", "case": "optimized_mask", "batch": EXP_PANEL,
          "mask_block": EXP_MASK_BLOCK, "epochs": EXP_MASK_EPOCHS,
          "losses": [mask_loss(h) for h in hist], "plain_loss_0": mask_loss(plain[0]),
          "loss_0_rel_err": rel, "tol_rel": MASK_LOSS_TOL, "logits_moved": moved,
          "block_backwards": spy.calls, "weight_grads_returned": spy.weight_grads,
          "ms_per_epoch": (t5 - t1) / (EXP_MASK_EPOCHS - 1) * 1e3,
          "launches": {k: v for k, v in counts.items() if v}, "card": smi})
    if spy.weight_grads or spy.calls != _MASK_BWD * EXP_MASK_EPOCHS:
        raise AssertionError(f"experiments: optimized_mask's block backwards: {spy.calls} calls "
                             f"returned {spy.weight_grads} weight gradients")


def exp_loop_viz(torch, dev, tally, root, tmp):
    """(d) the loop with --visualize-patch-drop --visualize-cls-attn-evo
    against the same run without them."""
    import os

    from dense2sparse_vit_torch import ops
    from dense2sparse_vit_torch.train import loop
    from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager

    states = {}
    for name, extra in (("viz", ["--visualize-patch-drop", "--visualize-cls-attn-evo"]),
                        ("plain", [])):
        cfg, _ = loop_config(root, "--epochs", "1", *extra)
        workdir = os.path.join(tmp, f"loop_{name}")
        ops.reset_launch_counts()
        loop.run_experiment(cfg, workdir, device=dev, max_steps_per_epoch=EXP_LOOP_STEPS)
        for k, v in ops.launch_counts().items():
            tally.rows[k]["launches"] += v
        states[name] = CheckpointManager(os.path.join(workdir, "ckpt")).restore(
            map_location="cpu")["student"]
    pngs = sorted(os.listdir(os.path.join(tmp, "loop_viz", "viz")))
    differ = [k for k in states["plain"] if not torch.equal(states["viz"][k], states["plain"][k])]
    emit({"phase": "experiments", "case": "loop_visualize", "pngs": pngs,
          "params_not_bit_equal": differ})
    if pngs != ["cls_attn_evo_epoch_0.png", "patch_drop_epoch_0.png"] or differ:
        raise AssertionError(f"experiments: the loop's visualization wrote {pngs}, "
                             f"parameters differ {differ[:4]}")


def exp_native(torch, smi):
    """(e) the native normaliser at the shapes the port's paths hand
    `data.pipeline._normalize` in uint8: one 224-px image (the eval
    transform of display_patch_drop's, optimized_mask's and
    parity_report's loaders) and a 16-image panel (the loop's
    --visualize-* panel)."""
    import numpy as np

    from dense2sparse_vit_torch.native import normalize as native

    calls = native.normalize_u8.native_calls
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rng = np.random.default_rng(9)
    rows = {}
    for what, shape in (("image", (224, 224, 3)), ("panel", (EXP_PANEL, 224, 224, 3))):
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        ulps = native_ulps(native.normalize_u8(x, mean, std),
                           native.normalize_u8_reference(x, mean, std))
        times = {}
        for key, fn in (("native", native.normalize_u8),
                        ("numpy", native.normalize_u8_reference)):
            t = []
            for _ in range(NATIVE_REPS):
                t0 = time.perf_counter()
                fn(x, mean, std)
                t.append((time.perf_counter() - t0) * 1e3)
            times[key] = statistics.median(t)
        rows[what] = {"shape": list(shape), "max_ulps": ulps, "native_ms": times["native"],
                      "numpy_ms": times["numpy"]}
    built = native.library_path().exists()
    used = native.normalize_u8.native_calls - calls
    emit({"phase": "experiments", "case": "native_normalize", **rows,
          "library": str(native.library_path().name), "built": built, "native_calls": used,
          "tol_ulps": NATIVE_ULPS, "host": "host CPU of the card's machine", "card": smi})
    if (not built or used != 2 * (1 + NATIVE_REPS)
            or any(r["max_ulps"] > NATIVE_ULPS for r in rows.values())):
        raise AssertionError(f"experiments: native normalisation built {built}, {used} calls, "
                             f"{rows}")


def optimizer_launches(torch, opt) -> tuple:
    """(f): kernel launches of one `opt.step()` (on the last gradients), from
    torch.profiler: the most that any of three windows of FLAT_STEPS steps
    records a step, and each window's count. Whole runs of this script
    have shown windows that lose some or all of their launches; it fails
    where no window records one."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(FLAT_STEPS):
                opt.step()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if str(e.device_type).endswith("CUDA")))
    if not max(counts):
        raise AssertionError("experiments: the profiler recorded no launch of the optimizer step")
    return max(counts) / FLAT_STEPS, counts


def exp_flat_optimizer(torch, dev, smi):
    """(f) fused AdamW (the default, flat_optimizer) against torch's default
    step (--no-flat-optimizer, the multi-tensor update on the card): three
    B=128 headline steps of each from the same seeded weights (`whole`:
    within FLAT_PARAM_TOL after the first), the fused run's gradients
    handed to a twin under the default step (`same_grads`: within
    FLAT_PARAM_TOL after three), a second default run (`default_rerun`:
    bit-equal), each against the fused run's parameters; each optimizer
    step's kernel launches (profiler), host enqueue ms and device ms."""
    from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
    from dense2sparse_vit_torch.models import HEADLINE_KWARGS, HEADLINE_MODEL, HEADLINE_TEACHER
    from dense2sparse_vit_torch.models import create_model
    from dense2sparse_vit_torch.train import make_optimizer, make_train_step

    teacher = create_model(HEADLINE_TEACHER, use_fused_attention=True, device=dev,
                           dtype="bfloat16", generator=torch.Generator().manual_seed(2))
    images, labels = train_batch(torch, dev)
    runs = []
    # fused, default, the default twin on fused gradients, a second default run
    for flat in (True, False, False, False):
        student = create_model(HEADLINE_MODEL, use_fused_attention=True, device=dev,
                               generator=torch.Generator().manual_seed(0), **HEADLINE_KWARGS)
        cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                               train=TrainConfig(flat_optimizer=flat))
        opt = make_optimizer(student, cfg.train, STEPS_PER_EPOCH)
        opt.count = cfg.train.warmup_epochs * STEPS_PER_EPOCH
        runs.append((student, opt, make_train_step(student, teacher, opt, cfg)))
    (fused, fused_opt, fused_step), (default, default_opt, default_step) = runs[:2]
    (twin, twin_opt, _), (rerun, _, rerun_step) = runs[2:]
    losses, whole = {True: [], False: []}, []
    for _ in range(FLAT_STEPS):
        losses[True].append(fused_step(images, labels, TRAIN_EPOCH)["loss"].item())
        losses[False].append(default_step(images, labels, TRAIN_EPOCH)["loss"].item())
        rerun_step(images, labels, TRAIN_EPOCH)
        for p, q in zip(fused.parameters(), twin.parameters()):
            q.grad = None if p.grad is None else p.grad.clone()
        twin_opt.step()
        whole.append(tensor_rel_diffs(torch, dict(default.named_parameters()),
                                      dict(fused.named_parameters())))
    torch.cuda.synchronize()
    want = dict(fused.named_parameters())
    rel = {"whole": max(whole[-1].values()),
           "same_grads": params_rel_diff(torch, dict(twin.named_parameters()), want),
           "default_rerun": params_rel_diff(torch, dict(rerun.named_parameters()),
                                            dict(default.named_parameters()))}
    worst = sorted(whole[-1].items(), key=lambda kv: -kv[1])
    out = {}
    for flat, opt in ((True, fused_opt), (False, default_opt)):  # on the last gradients
        launches, windows = optimizer_launches(torch, opt)
        host, device = [], []
        for _ in range(5):
            s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            s0.record()
            t0 = time.perf_counter()
            opt.step()
            host.append((time.perf_counter() - t0) * 1e3)
            s1.record()
            torch.cuda.synchronize()
            device.append(s0.elapsed_time(s1))
        out[flat] = {"launches": launches, "launch_windows": windows,
                     "host_ms": statistics.median(host),
                     "device_ms": statistics.median(device)}
    emit({"phase": "experiments", "case": "flat_optimizer", "batch": B_TRAIN, "steps": FLAT_STEPS,
          "params_rel_diff": rel, "tol_rel": FLAT_PARAM_TOL,
          "whole_by_step": [max(w.values()) for w in whole],
          "whole_median_tensor": statistics.median(whole[-1].values()),
          "whole_worst_tensors": worst[:6], "fused_losses": losses[True],
          "default_losses": losses[False],
          **{f"{'fused' if f else 'default'}_{k}": v for f in (True, False)
             for k, v in out[f].items()}, "card": smi})
    # past the first step the runs part: the optimizers' one-ulp differences
    # flip bf16 top-k near-ties, and Adam moves a parameter whose gradient is
    # rounding noise (the key and the predictors' shift-invariant biases) by
    # about lr either way
    if (max(whole[0].values()) > FLAT_PARAM_TOL or rel["same_grads"] > FLAT_PARAM_TOL
            or rel["default_rerun"] != 0):
        raise AssertionError(f"experiments: fused AdamW against torch's default step: {rel}, "
                             f"whole steps {[max(w.values()) for w in whole]}")


def phase_experiments(torch, dev, tally, smi, root):
    """Phase 37: the users' experiment entry points at full width over
    phase 32's folder (`root`), each held against its plain run: (a)
    `eval_imagenet.evaluate` of a DeiT-S checkpoint (the port's seeded
    weights in the reference's key layout, no predictor keys) at B=128,
    bf16, through the kernels and through the plain layers: 720 images
    counted (a padded tail of 80), the pruned and unpruned counts within
    EVAL_COUNT_TOL of the images, the first batch's unpruned logits within
    LOGITS_TOL, PER_EVAL_BATCH launches a batch, img/s; (b)
    `display_patch_drop` on dino_small and DeiT-S at B=16 from a flat
    folder of 16 JPEGs: PER_PATCH_DROP launches a forward (the last block's
    CLS-row kernel), the CLS rows within STAGE_TOL of the plain model's, the
    18 keep masks as close to an fp32 plain model's as the bf16 plain
    model's are (`keep_agreement`, `masks_agree`), 18 PNGs; (c)
    `run_optimized_mask` on DeiT-S, B=16, mask_block 7, 5 epochs: finite
    metrics, the logits moved, epoch 0's loss within MASK_LOSS_TOL of the
    plain run's (same generator seeds), PER_MASK_EPOCH launches an epoch
    (five block backwards) and the teacher's once, no weight gradient
    returned by a block backward (`WeightGradSpy`),
    ms an epoch; (d) the loop with --visualize-patch-drop
    --visualize-cls-attn-evo, one epoch of EXP_LOOP_STEPS steps: both PNGs
    under workdir/viz, the parameters bit-equal to the run without the
    flags; (e) the native normaliser built under _build/ and used, one
    224-px image and a 16-image panel within NATIVE_ULPS of numpy, host ms
    of both; (f) fused AdamW against --no-flat-optimizer's default step on
    B=128 headline steps (`exp_flat_optimizer`): the parameters within
    FLAT_PARAM_TOL after one whole step and after three on the same
    gradients, each optimizer step's kernel launches (profiler), host
    enqueue ms and device ms."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as tmp:
        exp_eval(torch, dev, tally, smi, root, tmp)
        torch.cuda.empty_cache()
        exp_patch_drop(torch, dev, tally, smi, tmp)
        torch.cuda.empty_cache()
        exp_optimized_mask(torch, dev, tally, smi, root)
        torch.cuda.empty_cache()
        exp_loop_viz(torch, dev, tally, root, tmp)
        torch.cuda.empty_cache()
    exp_native(torch, smi)
    exp_flat_optimizer(torch, dev, smi)
    emit({"phase": "experiments", "seconds": round(time.perf_counter() - t0, 3), "card": smi})


def host_batch(torch, cfg, root, dev, split="val"):
    """The first LOOP_BATCH images of the loop's train or val split in the
    eval view, uint8 on the card, with their labels."""
    from dense2sparse_vit_torch.data import ImageFolder, eval_transform, split_train_val_indices
    from dense2sparse_vit_torch.data.pipeline import _load_batch

    ds = ImageFolder(root, eval_transform(cfg.data, normalize=False))
    idx = split_train_val_indices(len(ds), 0.8, seed=cfg.train.seed)[split == "val"]
    xb, yb = _load_batch(idx[:LOOP_BATCH], cfg.train.seed, 0, ds)
    return torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev).long()


def gemm_spills(build_log: str, word: str = "11gemm_kernel") -> dict:
    """ptxas's spill line for each GEMM kernel (bf16 and int8) of the build
    log, or for each kernel whose name holds `word`."""
    lines = build_log.splitlines()
    return {ln.split("Function properties for ")[1].strip(): lines[i + 1].strip()
            for i, ln in enumerate(lines[:-1])
            if "Function properties for " in ln and word in ln}


def wgmma_notices(build_log: str, word: str = "attention_bwd_kernel") -> dict:
    """ptxas's C75xx notices on wgmma for each kernel whose name holds
    `word`: {kernel: {"injected_arrive": n, "serialized": [the notices]}}.
    C7519, "warpgroup.arrive is injected ... to allow use of registers in
    GMMA", is a wgmma fence that ptxas adds before a product whose register
    operands were written after the code's own fence; a notice that says
    "serialized" ("Potential Performance Loss: wgmma.mma_async instructions
    are serialized due to ...") means each product waits for the last."""
    out = {}
    for ln in build_log.splitlines():
        if "(C75" not in ln or "function '" not in ln:
            continue
        name = ln.split("function '")[1].split("'")[0]
        if word not in name:
            continue
        r = out.setdefault(name, {"injected_arrive": 0, "serialized": []})
        if "(C7519)" in ln and "warpgroup.arrive is injected" in ln:
            r["injected_arrive"] += 1
        elif "serialized" in ln.lower():
            r["serialized"].append(ln.strip())
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dense2sparse_vit_torch.ops import _cuda
    from dense2sparse_vit_torch.utils import card_name_and_power_limit

    dev = torch.device("cuda", 0)
    smi = card_name_and_power_limit()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(dev)})
    if "--plant-fault" in argv:
        rest = argv[argv.index("--plant-fault") + 1:]
        return plant_fault(dev, rest[0] if rest else "rowsum")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    ptxas = [ln.strip() for ln in _cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas})
    spills = gemm_spills(_cuda.build_log)
    if ({gemm_kernel_kind(n) for n in spills} != set(GEMM_KERNELS)
            or any("0 bytes spill stores, 0 bytes spill loads" not in v
                   for v in spills.values())):
        raise AssertionError(f"GEMM kernels spill, or miss from ptxas's log: {spills}")
    spills = gemm_spills(_cuda.build_log, "attention_bwd_kernel")
    if ({attn_bwd_kind(n) for n in spills} != set(ATTN_BWD_KERNELS)
            or any("0 bytes spill stores, 0 bytes spill loads" not in v
                   for v in spills.values())):
        raise AssertionError(f"attention_bwd_kernel spills, or misses from ptxas's log: {spills}")
    for word in ("attention_hd_kernel", "attention_hd_bwd_kernel"):
        spills = gemm_spills(_cuda.build_log, word)
        if ({hd_kind(n, word) for n in spills} != set(HD_KINDS)
                or any("0 bytes spill stores, 0 bytes spill loads" not in v
                       for v in spills.values())):
            raise AssertionError(f"{word} spills, or misses from ptxas's log: {spills}")
    notices = wgmma_notices(_cuda.build_log)
    emit({"phase": "build", "attention_bwd_wgmma_notices": notices})
    if any(r["serialized"] for r in notices.values()):
        raise AssertionError(f"attention_bwd_kernel's wgmma products are serialized: {notices}")

    tally = Tally()
    # ---- 2-4. serve, check, time ----------------------------------------
    model, plain, images, outputs = phase_serve(torch, dev, tally)
    shapes = phase_check(torch, model, plain, images, outputs, tally)
    phase_time(torch, model, plain, images, shapes, tally, smi)
    pred_cases = shapes[1]  # phase 31's inputs: the predictors' own stage activations
    del model, plain, images, outputs, shapes
    # ---- 5-7. train, check_train, time_train ----------------------------
    student, teacher, step, t_images, t_labels = phase_train(torch, dev, tally)
    rec = phase_check_train(torch, student, teacher, step, t_images, t_labels, tally)
    phase_time_train(torch, dev, student, rec, tally, smi)
    del student, teacher, step, rec
    # ---- 8-11. the policy-masked paths ----------------------------------
    phase_serve_threshold(torch, dev, tally, smi)
    torch.cuda.empty_cache()
    for mode in ("threshold", "gumbel"):
        phase_train_policy(torch, dev, tally, smi, mode)
        torch.cuda.empty_cache()
    phase_serve_gumbel(torch, dev, tally)
    torch.cuda.empty_cache()
    # ---- 12-16. int8 serving, export, eval -------------------------------
    model, images, outputs = phase_serve_int8(torch, dev, tally)
    bf16_model, shapes = phase_check_int8(torch, dev, model, images, outputs, tally)
    phase_time_int8(torch, dev, model, bf16_model, images, shapes, tally, smi)
    del bf16_model, images, outputs, shapes
    torch.cuda.empty_cache()
    phase_serve_export(torch, dev, model)
    del model
    torch.cuda.empty_cache()
    phase_eval(torch, dev, tally)
    torch.cuda.empty_cache()
    # ---- 17-20. training with the student's own CLS rows ----------------
    student, teacher, step, t_images, t_labels = phase_train(torch, dev, tally, mode="attn")
    rec = phase_check_attn(torch, dev, step, t_images, t_labels, tally)
    del student, teacher, step
    torch.cuda.empty_cache()
    phase_time_attn(torch, dev, rec, tally, smi, t_images, t_labels)
    del rec
    torch.cuda.empty_cache()
    phase_serve_attn(torch, dev, tally)
    torch.cuda.empty_cache()
    # ---- 21-24. the T2T-ViT-14 family, trained with stochastic depth -----
    serve = phase_serve_t2t(torch, dev, tally)
    student, teacher, step, t_images, t_labels = phase_train_t2t(torch, dev, tally)
    rec = phase_check_droppath(torch, dev, student, teacher, step, t_images, t_labels, tally)
    del teacher, step
    torch.cuda.empty_cache()
    phase_time_droppath(torch, dev, student, rec, serve, tally, smi)
    del student, rec, serve
    torch.cuda.empty_cache()
    # ---- 25-27. the attention half-block and the kernel-timing scripts ----
    plain = phase_attn_block(torch, dev, tally, smi)
    torch.cuda.empty_cache()
    phase_kernel_sweep(torch, dev, tally, smi, plain)
    phase_attn_variants(torch, dev, tally, smi, plain)
    # ---- 28. the GEMM engine alone ------------------------------------------
    torch.cuda.empty_cache()
    phase_gemm(torch, dev, smi)
    # ---- 29. the LayerNorm backward and the bias column sums ------------------
    torch.cuda.empty_cache()
    phase_norm(torch, dev, tally, smi)
    # ---- 30. the attention core's backward alone ------------------------------
    torch.cuda.empty_cache()
    phase_attn_bwd(torch, dev, tally, smi)
    # ---- 31. the score predictor alone -----------------------------------------
    torch.cuda.empty_cache()
    phase_predictor(torch, dev, pred_cases, tally, smi)
    del pred_cases
    # ---- 32. the training entry point ----------------------------------------
    torch.cuda.empty_cache()
    loop_tmp, loop_root = phase_train_loop(torch, dev, tally, smi)
    # ---- 33. the student's other modes ------------------------------------------
    torch.cuda.empty_cache()
    try:
        phase_student_modes(torch, dev, tally, smi, loop_root)
        # ---- 34. the DeiT, ViT and DINO families; 384-px training ---------------
        torch.cuda.empty_cache()
        phase_deit_family(torch, dev, tally, smi, loop_root)
        # ---- 35. head widths other than 64; the rest of the zoo ---------------
        torch.cuda.empty_cache()
        phase_head_widths(torch, dev, tally, smi)
        # ---- 36. distributed training ---------------------------------------------
        torch.cuda.empty_cache()
        phase_distributed(torch, dev, tally, smi, loop_root)
        # ---- 37. the experiment drivers, visualization, normaliser, AdamW -------
        torch.cuda.empty_cache()
        phase_experiments(torch, dev, tally, smi, loop_root)
    finally:
        loop_tmp.cleanup()

    emit(tally.line())
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
