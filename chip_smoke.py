#!/usr/bin/env python3
"""Drive the PyTorch port (rectools_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each on its
own lines; any failure exits nonzero and prints no result:

1. device  — require CUDA, print the card's name and power limit, TF32 off.
2. build   — build and load the native host ops (native/hostops.cpp, g++
             -O3 into build/hostops/; the run fails if they do not
             load: their numpy fallback must not hide here), then compile
             every CUDA kernel of the port from csrc/ (one nvcc per source, all
             at once) and print the seconds.
3. kernels — each serving kernel at the shapes the serving path gives it
             (B = 4096 sessions, L = 100, d = 128, 4 heads, 15,872-column
             catalog): held against its plain PyTorch twin on the same inputs
             on the card (the grouped top-m in every value and lane id, the
             (-inf, lane 0) slots included, on its thread-per-group kernel),
             and timed beside its twin, one PyTorch library call (a yardstick
             only; the port never calls it) and its bound.
   train kernels — the same for the training kernels at the KION training
             width (B = 512, L = 100, d = 128, 4 heads, 15,872 items, dropout
             0.2): LayerNorm backward (one launch a call by the profiler,
             its device time beside the event-timed call, the same bits on a
             rerun), attention forward with dropout (its
             keep bits checked for equality with the twin's mask) and
             backward; the streaming logsumexp three ways (kernel 6's
             per-chunk partials on the 3xTF32 tile, timed again at 65,536
             and 131,072 items; kernel 15's running max on the same tile in
             clusters of blocks; each with
             a plain-TF32 control that must fail its limit; kernel 16's fixed
             shift on the same tile at these inputs and scaled so that window
             2 serves the rows, with the share of rows in each window, held
             to the tensor-core limit against its twin and the twin in
             float64 with a plain-TF32 control, its bits on a rerun and its
             device kernel named by the profiler); the softmax
             gradients from z (kernel 12; kernels 13 + 14 at 15,872, at the
             odd catalog and at 131,072 items); the CE gradients (kernel 7) in
             one pass, and its two launches with the partials budget forced
             below the fused plan's, each with a plain-TF32 control that must
             fail the tensor-core limit; at 51,200 x 131,072 the CE gradients'
             very-large-catalog route against kernel 7's one pass on the same
             inputs (the budget lifted: 1.7 GiB of partials), and kernel 7's
             two launches and kernels 10 + 11 against their twins. Every
             gradient kernel gives the same bits on a rerun and runs 3xTF32
             tensor-core products at d = 128: its bound is counted at 495
             TFLOP/s TF32, three products per f32 product, with the FP32 bound
             beside it; the split kernels' times are printed beside their
             SIMT-tile times (``redesigned:`` lines). So are the attention
             kernels' (2 at serving and with dropout, and 5), which run
             3xTF32 tensor-core products at head dim 32 and give the same
             bits on a rerun.
4. main    — SASRecModel serving at the KION width: a synthetic KION-shaped
             frame (8,192 users, sessions of 1-300 Zipf-drawn items over
             15,871 ids) -> Dataset.construct -> load_jax_params with random
             weights in the flax layout from a seed -> recommend(k=10,
             filter_viewed=True) in two 4,096-session batches -> one
             recommend_to_items. Checks the launch counts of every kernel on
             the path, the output (k unseen items per user, scores
             non-increasing) and agreement with the port's own CPU run on 64
             users; times warm calls and profiles one (device time by kernel,
             device busy share, host functions), then (SASRec and HSTU) warm
             calls with the native host ops and with their numpy versions
             forced, in turns, with the host seconds of the collates and the
             seen lists in each.
5. train   — SASRecModel(...).fit on the same frame at the training width
             (batch 512, full-catalog softmax through the fused CE, Adam) for
             2 epochs with about 1,024 users held out for validation
             (val_recall@10). Checks the launch counts of every training
             kernel, finite losses that fall from epoch 1 to epoch 2, finite
             validation loss and recall, and recommend for 1,024 users; prints
             train examples/s over epoch 2, peak device memory and one profiled
             step, and (SASRec and HSTU) one epoch of the train loader's
             collate with the native host ops and with their numpy versions.
6. agree   — 3 train steps with dropout 0.2 on the same 64 sessions at full
             width, on the card and on the port's CPU twins from the same
             start weights and dropout seed: losses within 1e-4 relative,
             parameters within 1e-4 absolute; the gradients' agreement and the
             gradients at the parameter entry that differs most are printed.
7. HSTU    — the second model family through the same entry points, at the
             same width (d = 128, 4 heads of 32, 2 blocks, L = 100, time and
             position bias on). ``stu kernels``: the three STU attention
             kernels (forward; backward dq, dk, dv; head-summed score gradient)
             against their twins at the training width (B = 512), at a long
             context (B = 64, L = 1,024) and, checked only, at ragged lengths
             (L = 80 and 96, with a per-row mask), timed beside the twin, the
             materialized einsum-SiLU-einsum and its autograd (the yardstick)
             and the bound; the forward on its tensor-core route at heads of
             32; the backward (two tensor-core launches, dk/dv and dq, at
             heads of 32) with the share of its warps' units the masks let it
             skip; the score gradient (one tensor-core launch at heads of 32)
             timed with and without its bucket sums; out, dq, dk, dv, ds and
             the sums of ds by time bucket bit-equal on a second run. The
             forward also at the serving batch (B = 4,096, left-padded
             sessions of the frame's lengths).
             ``hstu main``: random flax-layout weights -> HSTUModel.recommend
             with a context of one later timestamp per user, all 8,192 users;
             launch counts, k unseen items, agreement with the CPU run on 64
             users, the card's time buckets equal to the CPU's; the forward
             (kernel 17) on its tensor-core route and the top-m (kernel 3) on
             its thread-per-group kernel, by their launch counts. ``hstu
             train`` and ``hstu agree``: phases 5 and 6 for HSTUModel, the
             fit's forward on the tensor-core route too.
8. mesh    — training on a (data, model) process mesh. ``mesh kernels``: the
             biased streaming lse (kernel 8: kernel 6's tensor-core tile
             with the bias, a plain-TF32 control that must fail its limit,
             and kernel 6's bits at a zero bias) and its generic VJP, fused
             (kernel 9) and split (kernels 10 + 11), against their twins at
             the shape a (1, 1) mesh gives them (51,200 x 15,872, zero bias),
             at a (2, 2) mesh's shard (25,600 x 7,936) and at the last shard of
             the 15,835-row catalog cut four ways (3,959 rows, one of them
             invalid, bias -1e30), with a cotangent of mixed sign; fused beside
             split, and both routes' bits on a second run. ``mesh fit``:
             SASRecModel with ``mesh_shape=(1, 1)`` through a one-rank process
             group on the card, the training phase's width and depth: kernel 8
             and kernel 9 once per step and none of kernels 6 and 7, the
             losses of the fit without a mesh within LOSS_RTOL, then two steps
             with the partials budget forced to 0 (kernels 10 + 11).
             ``mesh fit 4``: four ranks spawned on the one card, mesh (2, 2),
             one epoch on the odd catalog (the second model shard ends in an
             invalid row): every rank reports its launches, losses and a
             digest of its parameters; all ranks equal, and equal to the
             single-process fit of the same batches within LOSS_RTOL and
             PARAM_ATOL. The ranks share one card and talk through gloo with
             host staging, so their step time says nothing of a real mesh.
             Then, in the same ranks, one epoch with bf16 compute (kernels 8
             and 9's bf16 forms, the column-sharded tables' bf16 copies
             gathered through gloo): all ranks equal, and the single-process
             bf16 fit of the same batches within MESH_4_BF16_LOSS_RTOL and
             the parameter rule beside it. ``bf16 mesh fit`` (after ``mesh
             fit``, in its one-rank world): SASRec with bf16 compute at
             ``mesh_shape=(1, 1)``, the training width and depth: kernels 8
             and 9's bf16 forms once a step and none of kernels 6 and 7 in
             either dtype, a profiled step's device kernels, losses falling
             and within 2e-2 of the bf16 phase's fit without a mesh, then two
             steps with the partials budget forced to 0 (kernels 10 + 11 in
             bf16).
9. lse doors — ``ops``: ``streaming_lse(..., bounded_shift=True)`` with its
             backward (kernels 16 and 9) and ``softmax_grads_from_z`` (kernel
             12, and its bf16 form on the same towers in bf16) as a user calls
             them, at the training width. ``classic
             forward``: two KION train steps with ``USE_PARTIALS_FWD = False``
             (kernel 15 once a step, kernel 6 never), losses within LOSS_RTOL
             of the default's from the same start. ``mid fit`` and ``large
             fit``: SASRecModel fit at the training width on a 65,536-row and
             a 131,072-row catalog (the frame with 65,535 and 131,071 item
             ids), 2 epochs each: kernel 6 and kernel 7's two launches (mid),
             or kernels 6, 13 and 14 (large), once a step and kernel 7's one
             pass never, finite falling losses, validation loss and recall,
             train examples/s over epoch 2, peak memory, one profiled step,
             and one step's loss gradients against the twins. Then phase 16's
             ``bf16 mid fit`` and ``bf16 large fit``: the same with bf16
             compute on the 65,536-row catalog (kernel 7's two launches in
             bf16 once a step; losses within 2e-2 of the f32 mid fit's) and on
             a 196,608-row one (65,535 and 196,607 item ids; kernels 13 and
             14's bf16 forms once a step), no one pass and no f32 loss kernel
             in the profiled step, the towers' bf16 gradients the route's f32
             ones rounded once, one step's gradients against the two
             launches' twin or, through the large-catalog route, against
             kernel 7's bf16 one pass with the budget lifted (a bf16 band).
10. families — BERT4Rec, eSASRec (shared negatives, remat) and remat at an
             ML-20M-sized shape, through the same entry points, after the
             HSTU phases. ``family kernels``: kernels 2 (with dropout) and 5
             under BERT4Rec's (B, 1, L, L) key-padding bias (no causal mask,
             the diagonal kept, left-padded sessions, one of length 1), and
             causal at L = 200 with 8 heads of 32; kernels 1 and 4 at width
             256; kernel 6 and the CE gradients on BERT4Rec's 15,873-row
             catalog (15% of the rows labelled) and at 102,400 x 20,480 x 256
             (the SIMT tile; kernels 13 + 14 there), each against its twin,
             timed beside it, the library call and the bound; the remat
             shape's kernels built with 0 bytes of stack. ``bert4rec train`` /
             ``main`` / ``agree``: phases 5, 4 and 6 for BERT4RecModel
             (mask_prob 0.15, full softmax; serving from the fitted weights,
             no user gets PAD or MASK). ``esasrec train``: SASRecModel over
             LiGRLayers with the sampled softmax over 128 negatives, three
             fits of 2 epochs from the seed: positionwise negatives, shared
             negatives (``negatives_sharing="batch"``), and shared with
             ``remat=True`` (the encoder's forward kernels once more a step;
             losses and parameters equal to the shared fit's); one step of
             the shared fits in turns with its wall and peak memory; then
             ``esasrec main`` from the positionwise fit and ``esasrec agree``
             for the positionwise and the shared-with-remat options. ``remat
             fit``: SASRec at B = 512, L = 200, d = 256, 8 heads, a 20,480-row
             catalog and full softmax, one epoch without and one with remat
             from the seed: launch counts, equal loss and parameters, peak
             memory and epoch wall of each, and one step of each in turns.

11. checkpoint — after the HSTU phases, the SASRec and the HSTU model that
             phases 5 and 7 fitted: ``save_checkpoint`` -> ``load_from_checkpoint``
             -> recommend for all 8,192 users, bit-equal items and scores and
             the serving launches; ``load_weights_from_checkpoint`` into a
             model fitted from another seed and ``load_model`` of
             ``model.save``, both bit-equal; ``load_from_checkpoint(...,
             model_params_update={"device": "cpu"})`` against the card on 64
             users (SCORE_RTOL / SCORE_ATOL). Prints the checkpoint's size and
             the save and load seconds.
12. evaluate — ``cross_validate`` of SASRec at the training width (1 epoch a
             fold) with ``TimeRangeSplitter("1D", n_splits=2)`` (the frame's
             last two days), k = 10, ``filter_viewed=True``, scoring Precision,
             Recall, NDCG, MAP, MRR, Serendipity, MeanInvUserFreq,
             AvgRecPopularity, CatalogCoverage, IntraListDiversity (over a
             random 4-column item-feature table) and SufficientReco; each
             fold's metrics equal to the same folds by hand (split -> fit ->
             recommend -> calc_metrics), whose fits and recommends each
             launch what ``expected_fit_launches`` and the serving counts say;
             cross_validate's launches are their sum. Prints the metrics and
             the phase's wall time.
13. classic — after evaluate, on the same frame: PopularModel,
             PopularInCategoryModel (a second Dataset with the item category
             item id mod 12), RandomModel, EASEModel (auto solver, and exact
             beside it), PureSVDModel(factors=64) and ItemKNNModel(K=50) plain
             and bm25. Each: fit (seconds; ItemKNN's top-K truncation launches
             kernel 3 once a 4,096-row block), recommend all 8,192 users at
             k = 10 with filter_viewed (k unseen items each, no repeat; kernel 3
             once a serving batch and no other kernel; the batches sorted again
             after a failed certificate, counted; warm median of 3),
             recommend_to_items for 256 items, recommend with a 4,096-item
             whitelist, and a CPU copy of the fitted arrays on 64 users
             (identical items and scores within SCORE_RTOL / SCORE_ATOL; where
             the scores are sums of floats a user whose items differ is held
             to items equal outside TIE_GAP, and counted); RandomModel
             instead: scores n..1, a refit repeats, the next call differs.
             EASE's two solvers' weights within rtol 1e-3, atol 1e-4; one
             profiled EASE recommend. Kernel 3 at the truncation shape
             (15,871 x 15,872 plain co-counts, K = 50 candidates a group):
             bit-equal to its twin on every block at m = 50 and 128, no block
             sorted again, the top-K table bit-equal to a stable sort's; one
             block timed at both m beside the twin, the group-wise and the
             row-wise torch.topk and the bound, and the whole truncation
             beside the stable sort's and torch.topk's. ``cross_validate`` of Popular, EASE (the exact
             solver: the auto one took 65 s a fit on an H100 80GB HBM3 at
             700 W), PureSVD, ItemKNN and ALS over evaluate's two folds, equal
             to the folds by hand.
14. factorization — after classic, on the same frame and on a copy with
             seeded KION-shaped features (users: age, income, sex, kids_flg;
             items: genre = item id mod 12, content_type) and 256 warm users:
             ALSModel(factors=64, regularization=0.05, iterations=15), plain
             and with fit_features_together; BPRModel(factors=64,
             iterations=60); HybridMFModel(no_components=64, loss="warp",
             epochs=20) with both feature sets; DSSMModel(n_factors=64,
             batch_size=128, lr=0.01, max_epochs=5), which ranks by
             EUCLIDEAN. Each: fit seconds (no kernel launched), recommend all
             8,192 users (kernel 3 once a serving batch and no other kernel;
             warm median of 3), i2i, a whitelist, a CPU copy on 64 users (as
             in classic), save / load_model recommending bit-equal; BPR,
             HybridMF and DSSM fitted again from the seed, bit-equal;
             HybridMF's and DSSM's loss falls; HybridMF serves warm and cold
             users, DSSM warm ones; one epoch of HybridMF and of DSSM
             profiled (device time by kernel, busy share, host functions),
             HybridMF's host batches timed in one epoch under cProfile.
             Prints the phase's wall.
15. ranking — after factorization, on the same frame: CandidateRankingModel
             over PopularModel and ALSModel(factors=64, iterations=15), 50
             candidates each with ranks, scores and fill values,
             TimeRangeSplitter("7D", n_splits=1), 3 negatives a user, and a
             logistic regression written here (torch on the card; sklearn and
             catboost are not on the card's machine): fit (kernel 3 once a
             4,096-user batch of each generator's train candidates, no other
             kernel), the pooled candidates, labels, sampled frame and the
             reranker's fit frame equal to the pipeline by hand, recommend all
             8,192 users (k = 10, filter_viewed; the generators refitted on the
             whole frame; kernel 3 once a batch of each generator), the final
             top-k equal to scoring and sorting by hand, a CPU copy of the
             generators on 64 users (the same pooled items and ranks, scores
             within 1e-5), save / load_model bit-equal; the same pipeline
             through CatBoostReranker with a pool and a listwise ranker written
             here. ``ann``: UserToItemAnnRecommender over the fitted ALS
             factors under COSINE and DOT (all users, top 10, index_top_k 50;
             256 users with whitelists) and ItemToItemAnnRecommender (4,096
             items, self excluded): kernel 3 once a 4,096-row batch a query,
             the certificate's fallbacks equal to the batches that fail it by
             hand, 64 rows against a CPU brute force, approximate=True equal to
             exact, a pickle round trip bit-equal, users/s and items/s.
             ``compat``: translate_reference_config of a reference
             ImplicitALSWrapperModel config (warns of use_gpu and
             num_threads), fitted on the card and recommending bit-equal to
             ALSModel built directly. ``visuals``: VisualApp,
             ItemToItemVisualApp and MetricsApp built (not displayed) and
             round-tripped through CSV. Prints the phase's wall.
16. bf16  — after ranking: mixed-precision training (compute_dtype =
             "bfloat16"). (a) the bf16 forms of kernels 6 and 7 at 51,200 x
             15,872 x 128 (and checked at the odd catalog) and of kernels 2
             and 5 at B = 512, H = 4, L = 100, heads of 32, causal with
             dropout and under BERT4Rec's bias, each against its twin on the
             card, the same bits on a rerun, timed beside its f32 form on the
             same values, the library call in bf16 and its bound at 989
             TFLOP/s bf16 and 3.35 TB/s; the same for the four launches of
             kernels 17-19's bf16 forms at B = 512, H = 4, L = 100, heads of
             32, both biases, and at B = 64, L = 1,024 (a padded row gives
             zeros); the same for the bf16 forms of kernels 8-11 (``bf16 mesh
             kernels`` lines) at the three shapes of ``mesh kernels``, the
             backward fused and split, with kernel 8's bits against kernel 6's
             bf16 form at a zero bias; the same for kernel 12's bf16 form, 13
             + 14's and kernel 7's two launches (``bf16 kernels`` lines) at
             51,200 x 15,872 x 128 (the split forms with the budget forced),
             kernel 7's two launches unforced at 65,536 items, 13 + 14
             unforced at 196,608 items, where the CE route is held against
             kernel 7's bf16 one pass within a bf16 band. (b) SASRecModel.fit with bf16 compute at phase 5's
             width, batch and epochs beside phase 5's f32 fit, and
             HSTUModel.fit so beside phase 7's: every launch count (HSTU:
             the stu_*_bf16 keys at 2 a step, f32 stu_fwd only in the
             validation recall's f32 forwards), a profiled step whose device
             kernels include the bf16 forms and no f32 attention, STU or loss
             kernel and no library attention or cross-entropy, losses within
             2e-2 and HitRate@10 on the held-out last items within 0.03 of the
             f32 fit's, train examples/s of both; LayerNorm through its bf16
             forms (5 + 5 a SASRec step, 4 + 4 an HSTU step) and no f32
             LayerNorm in a bf16 step, the profiled step's copy kernels
             counted. (c) one bf16 epoch through fit of BERT4Rec and of
             eSASRec with shared negatives. (d) ``bf16 lse and layer norm``:
             the bf16 forms of kernels 15 and 16 through the public
             streaming_lse at 51,200 x 15,872 x {128, 16, 256}, and of kernels 1
             and 4 at 51,200 x {16, 128, 256} and a ragged row count, each
             against its twin (1 and 4 bit-equal to the f32 kernels on the
             widened operands), the same bits on a rerun, timed beside its f32
             form, the library call in bf16 and its bound. Prints the phase's
             wall.

Output, last lines: one JSON object with every kernel's numbers, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SEED = 20260
START, COVER_DAY = "2021-03-13", 90  # the frame's first day; the catalog-cover rows follow day 90
N_USERS = 8192
N_ITEM_IDS = 15871  # + PAD = 15,872 rows, 124 groups of 128
SESSION_MAX_LEN = 100
N_FACTORS = 128
N_HEADS = 4
N_BLOCKS = 2
K = 10
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores, data sheet
PEAK_TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores, data sheet
# the redesigned kernels' times before their redesign (PERF.md §6, NVIDIA H100 80GB HBM3 at 700 W): on the SIMT
# tile, before they moved to the tensor cores, kernels 7, 9 and 12 (kernel 7 then its two launches), the split
# kernels (7's two launches, 10, 11, 13, 14), kernels 6 and 18 (kernel 6 at 65,536 and 131,072 items: its device
# time in a one-step profile of those fits), kernels 8 (at the three mesh shapes) and 19 (with the bucket sums),
# kernels 2 (at serving, and with dropout at the training width) and 5, and kernel 17 (at the training width, at
# L = 1,024 and at serving); kernel 3 on its warp-per-group kernel (at serving); kernel 4 as two launches (its
# partials summed by a second kernel) and kernels 15 and 16 on the SIMT tile (16 in both windows); by the entry of
# `kernels` that holds this run's time; printed beside this run's times on `redesigned:` lines, never in the JSON
# line
SIMT_TILE_MS = {
    "ce_grads": 33.2298, "lse_bwd_fused": 24.6118, "grads_z_fused": 24.3758, "ce_grads_pair": 33.4354,
    "lse_bwd_ds": 17.7596, "lse_bwd_di": 16.1084, "lse_bwd_ds_shard_2x2": 5.0311, "lse_bwd_di_shard_2x2": 5.1938,
    "lse_bwd_ds_ragged_shard": 2.5195, "lse_bwd_di_ragged_shard": 5.1749, "grads_z_ds": 17.6091,
    "grads_z_di": 16.0467, "grads_z_ds_large_catalog": 146.99, "grads_z_di_large_catalog": 126.41,
    "lse_partials_fwd": 8.3204, "lse_partials_fwd_mid_catalog": 32.92, "lse_partials_fwd_large_catalog": 66.26,
    "stu_bwd": 0.8185, "stu_bwd_long_ctx": 10.7321,
    "lse_bias_fwd": 9.6292, "lse_bias_fwd_shard_2x2": 2.9302, "lse_bias_fwd_ragged_shard": 1.4812,
    "stu_ds": 0.8109, "stu_ds_long_ctx": 6.8854,
    "attention_fwd": 1.6675, "attention_fwd_train": 0.2841, "attention_bwd": 0.6189,
    "stu_fwd": 0.2795, "stu_fwd_long_ctx": 4.0498, "stu_fwd_serving": 1.9215, "group_topm": 0.6820,
    "layer_norm_bwd": 0.0894, "lse_fwd": 10.0975, "lse_shift_fwd": 8.3168, "lse_shift_fwd_window_2": 8.3156,
}
LN_TOL = 1e-5
ATTN_TOL = 1e-5
SCORE_RTOL, SCORE_ATOL, TIE_GAP = 1e-4, 1e-4, 1e-4  # GPU vs CPU run: f32 sums in another order
TRAIN_B = 512
DROPOUT = 0.2
LR = 1e-3
EPOCHS = 2
LN_BWD_TOL = 1e-5  # dx absolute; dgamma and dbeta relative to their largest entry (sums over 51,200 rows)
LSE_RTOL = 1e-5  # relative, per row: one column of 15,872 left out moves an lse of about 10 by 6e-6 relative
# kernels 6, 8, 15 and 16 on the tensor cores (3xTF32), relative per row from their twins (kernel 16 also from its
# twin in float64): below it, and plain TF32 products (their control) above it
LSE_TC_RTOL = 1e-6
CE_RTOL = 1e-4  # relative to the largest entry of ds and of di
# the same for the gradient kernels on the tensor-core tile, fused (7's one pass, 9, 12) and split (7's two
# launches, 10, 11, 13, 14) (3xTF32 products, a fresh fragment per 16 k; 4.3e-6 at most at the training shape and
# at 131,072 items): plain TF32 lands near 5e-4, and 3xTF32 accumulated straight onto the running fragment at
# 1.3-3.0e-5, both above it
TC_RTOL = 6e-6
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4  # GPU vs CPU training
AGREE_SESSIONS, AGREE_STEPS = 64, 3
RAGGED_N = N_ITEM_IDS + 1 - 37  # an odd catalog: every item tile of kernels 6 and 7 leaves a tail
LARGE_N_ITEM_IDS = 131071  # + PAD = 131,072 rows: past the 81,920 items at which the CE gradients leave kernel 7
# + PAD = 65,536 rows, a MovieLens-25M-sized catalog: kernel 7's one pass would need 928 MiB of partials, over the
# budget, and the JAX rule keeps kernel 7: its two launches
MID_N_ITEM_IDS = 65535
SHIFT_WINDOW2_SCALE = 2.5  # scales sessions and items so that kernel 16's bound gap (~11) grows to ~70: window 2
MESH_4 = (2, 2)  # the four-rank mesh; its model axis cuts the odd catalog into 7,918 + 7,917 rows
MESH_RANK_TIMEOUT_S = 420.0
STU_FWD_TOL, STU_GRAD_TOL = 1e-5, 1e-4  # absolute, times the twin's largest entry where that is above 1
LONG_CTX = dict(b=64, l=1024)  # the long-context shape the STU kernels exist for
SERVING_B = 4096  # the recommend batch
NUM_BUCKETS = 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_SPAN = "device_kernels: counted calls"  # the record_function span around the calls a capture counts
PROFILE_SPIN_CYCLES = 2_000_000  # about a millisecond of one spinning kernel at the H100's clock


def is_launch(name: str) -> bool:
    """Whether a host profiler record names a runtime or driver call that
    puts work on the card (its kernel's device record shares its id)."""
    return name.startswith("cu") and any(word in name for word in ("Launch", "Memset", "Memcpy"))


def device_kernels(torch, fn, calls: int) -> dict:
    """{device kernel name: (launches a call, mean device ms a launch)} of
    ``calls`` calls of ``fn`` after one warm-up (torch.profiler); empty
    where nothing runs on a card. The device records of a capture's first
    launches go missing now and then, whether or not the host waits before
    them (rectools_tpu_torch/tools/profiler_capture_check.py): each capture
    first runs a spinning kernel and two calls of ``fn`` that it does not
    count, then the ``calls`` calls inside a ``record_function`` span, and
    counts the device records of the launches made inside the span (a
    launch's host record and its kernel's record share a correlation id).
    While a kernel shows fewer launches than calls (now and then a capture
    keeps none of a kernel's records), a capture is taken again, up to five
    times; each kernel gets the count of the capture that kept the most of
    its records (no capture keeps more records than launches)."""
    from torch.autograd import DeviceType

    fn()
    if not torch.cuda.is_available():
        return {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best: dict = {}
    for _ in range(5):
        out = {}
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            fn()
            fn()
            torch.cuda.synchronize()
            with torch.profiler.record_function(PROFILE_SPAN):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        span = next(e.time_range for e in events if e.name == PROFILE_SPAN and e.device_type == DeviceType.CPU)
        launched = {e.id for e in events if e.device_type == DeviceType.CPU and is_launch(e.name)
                    and span.start <= e.time_range.start <= span.end}
        for e in events:
            if e.device_type == DeviceType.CUDA and e.id in launched and e.name != PROFILE_SPAN:
                n, us = out.get(e.name[:60], (0, 0.0))
                out[e.name[:60]] = (n + 1, us + e.time_range.elapsed_us())
        for name, (n, us) in out.items():  # a capture keeps no more records than launches: the most kept
            if n / calls > best.get(name, (0.0, 0.0))[0]:
                best[name] = (n / calls, us / 1e3 / n)
        if best and min(n for n, _ in best.values()) >= 1:
            break
    return best


def bound_ms(n_bytes: float, n_ops: float, tf32x3: bool = False) -> tuple:
    """(ms, "bytes" or "operations"): the bytes over the memory rate or the
    f32 operations over the FP32 rate, whichever is longer; with ``tf32x3``
    each f32 operation is three TF32 tensor-core operations at the TF32 rate
    (kernels 7, 9 and 12)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (3 * n_ops / PEAK_TF32_FLOP_PER_S if tf32x3 else n_ops / PEAK_F32_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bounds(n_bytes: float, n_ops: float) -> dict:
    """A tensor-core kernel's bound (3xTF32) and, beside it, its FP32 bound."""
    return {"bound": bound_ms(n_bytes, n_ops, tf32x3=True), "bound_f32": bound_ms(n_bytes, n_ops)}


def bound_text(r: dict) -> str:
    text = f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}"
    if "bound_f32" in r:
        text += f" (3xTF32); FP32 bound {r['bound_f32'][0]:.4f}"
    return text + ")"


# ---------------------------------------------------------------- phase 3


def kernel_phase(torch, dev, b: int = 4096) -> dict:
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import _native, attention, layer_norm, topk_select

    gen = torch.Generator(device=dev).manual_seed(SEED)
    l, h, d = SESSION_MAX_LEN, N_HEADS, N_FACTORS
    dh = d // h
    results = {}

    # LayerNorm: (B*L, d), 5 calls per batch on the path
    x = torch.randn((b * l, d), generator=gen, device=dev) * 2 + 0.5
    gamma = torch.randn((d,), generator=gen, device=dev)
    beta = torch.randn((d,), generator=gen, device=dev)
    y = layer_norm.layer_norm(x, gamma, beta, 1e-6)
    err = (y - layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)).abs().max().item()
    check(err <= LN_TOL, f"layer_norm kernel disagrees with its twin: max abs err {err}")
    n_bytes = 2 * x.numel() * 4 + 2 * d * 4
    results["layer_norm_fwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: layer_norm.layer_norm(x, gamma, beta, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)),
        library_ms=time_ms(lambda: F.layer_norm(x, (d,), gamma, beta, 1e-6)),
        bound=bound_ms(n_bytes, 8 * x.numel()),
    )
    del x, y

    # attention: (B, L, H, dh) projections read through strides, causal bias (1, 1, L, L)
    q, k, v = (torch.randn((b, l, h, dh), generator=gen, device=dev) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    scale = 1.0 / math.sqrt(dh)
    out, lse = attention.attention_fwd(qt, kt, vt, bias, scale)
    ref_out, ref_lse = attention.attention_reference(qt, kt, vt, bias, scale)
    err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    check(err <= ATTN_TOL, f"attention kernel disagrees with its twin: max abs err {err}")
    again = attention.attention_fwd(qt, kt, vt, bias, scale)
    check(bool(torch.equal(again[0], out) and torch.equal(again[1], lse)), "attention forward: other bits on a rerun")
    n_bytes = 4 * q.numel() * 4 + lse.numel() * 4 + bias.numel() * 4
    n_ops = 4 * b * h * l * l * dh  # q·kᵀ and p·v over every (query, key) pair, 2 operations per multiply-add
    results["attention_fwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attention.attention_fwd(qt, kt, vt, bias, scale)),
        plain_ms=time_ms(lambda: attention.attention_reference(qt, kt, vt, bias, scale), iters=3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=scale)),
        **tc_bounds(n_bytes, n_ops),  # head dim 32: the tensor-core kernel (attention.TC_HEAD_DIMS)
    )
    del again
    del q, k, v, qt, kt, vt, out, lse, ref_out, ref_lse

    # grouped top-m: the (B, 15,872) masked score rows, m = 12
    n_pad = (N_ITEM_IDS + 1 + 127) // 128 * 128
    m = topk_select.pick_m(n_pad, K)
    scores = torch.randn((b, n_pad), generator=gen, device=dev)
    scores[:, N_ITEM_IDS:] = float("-inf")
    before = _native.LAUNCHES["group_topm"]
    vals, lanes = topk_select.group_topm(scores, m)
    check(_native.LAUNCHES["group_topm"] == before + 1,
          f"group_topm at m={m} did not take the thread-per-group kernel")
    ref_vals, ref_lanes = topk_select.group_topm_reference(scores, m)
    finite = torch.isfinite(ref_vals)
    check(bool(torch.equal(vals, ref_vals)), "group_topm values differ from its twin")
    # every slot: past a group's finite values the TPU's rule gives (-inf, lane 0)
    check(bool(torch.equal(lanes, ref_lanes)), "group_topm lane ids differ from its twin")
    g = n_pad // 128
    n_bytes = scores.numel() * 4 + b * g * m * 8
    results["group_topm"] = dict(
        max_abs_err=(vals - ref_vals)[finite].abs().max().item(),
        ms=time_ms(lambda: topk_select.group_topm(scores, m)),
        plain_ms=time_ms(lambda: topk_select.group_topm_reference(scores, m), iters=3),
        library_ms=time_ms(lambda: torch.topk(scores, K, dim=1)),
        bound=bound_ms(n_bytes, scores.numel()),
    )
    del scores, vals, lanes, ref_vals, ref_lanes
    torch.cuda.empty_cache()
    for name, r in results.items():
        print(
            f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} {bound_text(r)}"
        )
    return results


# ---------------------------------------------------------------- phase 3, training width


def _max_rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def _row_rel(got, ref) -> float:
    """The largest error relative to the reference's entry, over the rows (in float64)."""
    return ((got.double() - ref.double()).abs() / ref.double().abs()).max().item()


def tf32(torch, x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (a product of two TF32
    values is exact in f32): the operands of a plain-TF32 control."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def ce_grads_plain_tf32(torch, softmax_lse, s, items, z, y, coeff, partials: bool = True) -> tuple:
    """Kernel 7's function with plain TF32 products: each operand of the three
    products rounded once, in the twin's chunks and the one pass's order
    (``partials``) or the two launches'."""

    def weights(logits, start: int):
        pw = torch.exp(logits - z[:, None])
        cols = torch.arange(start, start + logits.shape[1], device=s.device)
        return tf32(torch, torch.where(cols[None, :] == y[:, None], pw - coeff[:, None], pw))

    return softmax_lse._grads_reference(tf32(torch, s), tf32(torch, items), weights, softmax_lse.TWIN_CHUNK, partials)


def train_kernel_phase(torch, dev, b: int = TRAIN_B) -> dict:
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import attention, layer_norm, softmax_lse

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    l, h, d, n = SESSION_MAX_LEN, N_HEADS, N_FACTORS, N_ITEM_IDS + 1
    dh, m = d // h, b * l
    results = {}

    def grad_ms(outputs, inputs, grad_outputs, iters: int = 10) -> float:
        return time_ms(lambda: torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=True), iters=iters)

    # kernel 4, LayerNorm backward: (B*L, d), 5 calls per step
    x = torch.randn((m, d), generator=gen, device=dev) * 2 + 0.5
    gamma = torch.randn((d,), generator=gen, device=dev)
    dy = torch.randn((m, d), generator=gen, device=dev)
    got = layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6)
    ref = layer_norm.layer_norm_bwd_reference(x, gamma, dy, 1e-6)
    err_dx = (got[0] - ref[0]).abs().max().item()
    err_sums = max(_max_rel(got[1], ref[1]), _max_rel(got[2], ref[2]))
    check(err_dx <= LN_BWD_TOL and err_sums <= LN_BWD_TOL,
          f"layer_norm_bwd disagrees with its twin: dx {err_dx}, dgamma/dbeta relative {err_sums}")
    check(all(bool(torch.equal(a, b)) for a, b in zip(layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6), got)),
          "layer_norm_bwd: other bits on a rerun")
    # one launch a call, and its device time by the profiler beside the event-timed call
    ln_device = device_kernels(torch, lambda: layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6), calls=20)
    check(dev.type != "cuda" or (len(ln_device) == 1 and next(iter(ln_device.values()))[0] == 1.0),
          f"layer_norm_bwd: device kernels a call {ln_device}")
    xg, gg, bg = (t.detach().clone().requires_grad_() for t in (x, gamma, torch.zeros_like(gamma)))
    y_lib = F.layer_norm(xg, (d,), gg, bg, 1e-6)
    results["layer_norm_bwd"] = dict(
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
        ms=time_ms(lambda: layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6)),
        device_ms=sum(n * ms for n, ms in ln_device.values()),
        plain_ms=time_ms(lambda: layer_norm.layer_norm_bwd_reference(x, gamma, dy, 1e-6)),
        library_ms=grad_ms(y_lib, (xg, gg, bg), dy),
        bound=bound_ms(3 * x.numel() * 4 + 3 * d * 4, 12 * x.numel()),
    )
    print(f"train kernels: layer_norm_bwd {results['layer_norm_bwd']['ms']:.4f} ms a call (CUDA events), "
          f"{results['layer_norm_bwd']['device_ms']:.4f} ms on the device (torch.profiler, mean of 20 calls): "
          f"{ln_device}; bits equal on a rerun")
    del x, dy, got, ref, xg, y_lib

    # kernel 2 with dropout and kernel 5: (B, L, H, dh) projections, causal bias
    q, k, v, dout = (torch.randn((b, l, h, dh), generator=gen, device=dev).transpose(1, 2) for _ in range(4))
    bias = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    scale, seed = 1.0 / math.sqrt(dh), 987654321
    out, lse = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    ref_out, ref_lse = attention.attention_reference(q, k, v, bias, scale, DROPOUT, seed)
    err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    check(err <= ATTN_TOL, f"attention forward with dropout disagrees with its twin: max abs err {err}")
    again = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    check(bool(torch.equal(again[0], out) and torch.equal(again[1], lse)),
          "attention forward with dropout: other bits on a rerun")
    # keep bits: with q = k = 0 every probability is 1/L, and one-hot values
    # carry each key column's kept-or-dropped probability into the output
    zeros = torch.zeros_like(q)
    kept = torch.empty((b, h, l, l), dtype=torch.bool, device=dev)
    for c0 in range(0, l, dh):
        w = min(dh, l - c0)
        onehot = torch.zeros((b, l, h, dh), device=dev)
        onehot[:, torch.arange(c0, c0 + w), :, torch.arange(w)] = 1.0
        probe, _ = attention.attention_fwd(zeros, zeros, onehot.transpose(1, 2), None, 1.0, DROPOUT, seed)
        kept[..., c0 : c0 + w] = probe[..., :w] > 0
    mask = attention.dropout_keep_mask(seed, b, h, l, DROPOUT, dev).bool()
    check(bool(torch.equal(kept, mask)), "attention dropout keep bits differ from the twin's mask")
    print(f"train kernels: attention dropout keep bits equal the twin's on {mask.numel()} positions, "
          f"kept share {mask.float().mean().item():.4f}")
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias, scale=scale)
    flops = b * h * l * l * dh
    results["attention_fwd_train"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)),
        plain_ms=time_ms(lambda: attention.attention_reference(q, k, v, bias, scale, DROPOUT, seed), iters=3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)),
        **tc_bounds(4 * q.numel() * 4 + lse.numel() * 4 + bias.numel() * 4, 4 * flops),
    )
    delta = (dout * out).sum(-1).contiguous()
    got = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    ref = attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    check(err <= ATTN_TOL, f"attention backward disagrees with its twin: max abs err {err}")
    again = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, got)), "attention backward: other bits on a rerun")
    print("train kernels: attention forward (serving and with dropout) and backward bit-equal on a rerun")
    results["attention_bwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)),
        plain_ms=time_ms(
            lambda: attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed), iters=3
        ),
        library_ms=grad_ms(out_lib, (qg, kg, vg), dout),
        **tc_bounds(7 * q.numel() * 4 + 2 * lse.numel() * 4 + bias.numel() * 4, 10 * flops),
    )
    del q, k, v, dout, out, lse, ref_out, ref_lse, zeros, kept, mask, qg, kg, vg, out_lib, delta, got, ref, again
    torch.cuda.empty_cache()

    # kernels 6, 15, 16, 12-14 and 7: session towers (B*L, d) against the 15,872-row item table
    s = torch.randn((m, d), generator=gen, device=dev)
    items = 0.1 * torch.randn((n, d), generator=gen, device=dev)
    products = 2 * m * n * d
    lse_library_ms = time_ms(lambda: torch.logsumexp(s @ items.T, dim=1), iters=3)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    chunks_6 = -(-n // softmax_lse.LSE_CHUNK)  # kernel 6's item chunks
    forwards = {}
    for name, partials, twin in (("lse_partials_fwd", True, softmax_lse.streaming_lse_partials_reference),
                                 ("lse_fwd", False, softmax_lse.streaming_lse_reference)):
        softmax_lse.USE_PARTIALS_FWD = partials
        forwards[name] = softmax_lse.streaming_lse(s, items)
        ref = twin(s, items)
        rel = ((forwards[name] - ref).abs() / ref.abs()).max().item()
        check(rel <= LSE_RTOL, f"{name} disagrees with its twin: max relative err {rel}")
        check(bool(torch.equal(softmax_lse.streaming_lse(s, items), forwards[name])), f"{name}: other bits on a rerun")
        # both forwards again on an odd catalog, where the last item tile leaves a tail (checked, not timed)
        got_ragged, ref_ragged = softmax_lse.streaming_lse(s, items[:RAGGED_N]), twin(s, items[:RAGGED_N])
        rel_ragged = ((got_ragged - ref_ragged).abs() / ref_ragged.abs()).max().item()
        check(rel_ragged <= LSE_RTOL, f"{name} at N={RAGGED_N} disagrees with its twin: {rel_ragged}")
        lse_bytes = (m * d + n * d + (m if name == "lse_fwd" else 2 * m * chunks_6)) * 4
        results[name] = dict(
            max_abs_err=(forwards[name] - ref).abs().max().item(),
            ms=time_ms(lambda: softmax_lse.streaming_lse(s, items), iters=5),
            plain_ms=time_ms(lambda: twin(s, items), iters=3),
            library_ms=lse_library_ms,
            # kernels 6 and 15 run their product in 3xTF32 on the tensor cores at d = 128
            **tc_bounds(lse_bytes, products),
        )
        # the control: the same lse from plain TF32 products, in the twin's chunks
        plain_tf32 = twin(tf32(torch, s), tf32(torch, items))
        rel_plain = ((plain_tf32 - ref).abs() / ref.abs()).max().item()
        check(rel <= LSE_TC_RTOL < rel_plain,
              f"{name} {rel} and its plain-TF32 control {rel_plain} relative: not on either side of {LSE_TC_RTOL}")
        layout = (f"{chunks_6} item chunks" if partials else
                  "clusters of {} blocks, {} item rows a rank".format(*softmax_lse.lse_cluster_plan(n)))
        print(f"train kernels: {name} (3xTF32, {layout}) {rel:.3g} relative per row from its twin, plain TF32 "
              f"products {rel_plain:.3g} (limit {LSE_TC_RTOL}); at N={RAGGED_N} {rel_ragged:.3g}; bits equal on a "
              "rerun")
        del plain_tf32
    softmax_lse.USE_PARTIALS_FWD = True
    lse = forwards["lse_partials_fwd"]
    between = ((lse - forwards["lse_fwd"]).abs() / forwards["lse_fwd"].abs()).max().item()
    check(between <= LSE_RTOL, f"kernels 6 and 15 differ by {between} relative")
    print(f"train kernels: kernels 6 and 15 agree to {between:.3g} relative; at N={RAGGED_N} both within "
          f"{LSE_RTOL} of their twins")

    # kernel 16 on the same tile at the scale of these inputs, then scaled so that window 2 serves the rows
    for tag, scale in (("", 1.0), ("_window_2", SHIFT_WINDOW2_SCALE)):
        ss, ii = s * scale, items * scale
        got = softmax_lse.streaming_lse(ss, ii, bounded_shift=True)
        ref = softmax_lse.streaming_lse_shift_reference(ss, ii)
        kernel_6 = lse if scale == 1.0 else softmax_lse.streaming_lse(ss, ii)
        rel = max(((got - r).abs() / r.abs()).max().item() for r in (ref, kernel_6))
        check(bool(torch.isfinite(got).all()) and rel <= LSE_RTOL,
              f"lse_shift_fwd at scale {scale} disagrees with its twin or with kernel 6: {rel}")
        check(bool(torch.equal(softmax_lse.streaming_lse(ss, ii, bounded_shift=True), got)),
              f"lse_shift_fwd at scale {scale}: other bits on a rerun")
        # 3xTF32 on the tensor cores: within LSE_TC_RTOL per row of the twin in float64 (the exact function) and of
        # the f32 twin while that twin is itself within half the limit of the float64 one (window 1; in window 2
        # the logits are 6.25x larger and it is not: PERF.md §6, PR 13); plain TF32 products, in the twin's
        # arithmetic on rounded inputs, above the limit from the same references
        exact = softmax_lse.streaming_lse_shift_reference(ss.double(), ii.double())
        rel_twin, rel_exact, twin_exact = _row_rel(got, ref), _row_rel(got, exact), _row_rel(ref, exact)
        plain_tf32 = softmax_lse.streaming_lse_shift_reference(tf32(torch, ss), tf32(torch, ii))
        refs = [exact, ref] if twin_exact <= LSE_TC_RTOL / 2 else [exact]
        rel_tc = max(_row_rel(got, r) for r in refs)
        rel_plain = min(_row_rel(plain_tf32, r) for r in refs)
        check(rel_tc <= LSE_TC_RTOL < rel_plain,
              f"lse_shift_fwd at scale {scale}: {rel_twin} from its twin, {rel_exact} from the float64 twin (the "
              f"twin {twin_exact} from it), plain TF32 {rel_plain}: not on either side of {LSE_TC_RTOL}")
        shift, l_sum, _ = softmax_lse.lse_shift_sums(ss, ii)
        gap = shift - (ss @ ii.T).max(dim=1).values
        window_1 = (l_sum >= softmax_lse.WINDOW1_FLOOR).float().mean().item()
        check(window_1 >= 0.99 if scale == 1.0 else window_1 <= 0.01,
              f"kernel 16 at scale {scale}: window 1 serves {window_1} of the rows")
        print(f"train kernels: lse_shift_fwd at scale {scale}: rows in window 1 {window_1:.4f}, in window 2 "
              f"{1 - window_1:.4f}; bound gap min {gap.min().item():.1f} median {gap.median().item():.1f} max "
              f"{gap.max().item():.1f}; max relative err against its twin and kernel 6 {rel:.3g}; 3xTF32 "
              f"{rel_twin:.3g} per row from its twin, {rel_exact:.3g} from the float64 twin (the f32 twin "
              f"{twin_exact:.3g} from it; held to {len(refs)} of them), plain TF32 products {rel_plain:.3g} (limit "
              f"{LSE_TC_RTOL}); bits equal on a rerun")
        if scale == 1.0:  # the kernel that ran, by its profiler name: the tensor-core kernel at d = 128
            names = device_kernels(torch, lambda: softmax_lse.streaming_lse(ss, ii, bounded_shift=True), calls=3)
            tile = [k for k in names if "lse_partials_tc_kernel" in k]
            check(dev.type != "cuda" or (len(tile) == 1 and names[tile[0]][0] == 1.0 and
                                         not any("lse_chunk_kernel" in k for k in names)),
                  f"lse_shift_fwd at d = {d}: device kernels {names}")
            print(f"train kernels: lse_shift_fwd device kernels (torch.profiler, a call): {names}")
        results[f"lse_shift_fwd{tag}"] = dict(
            max_abs_err=(got - ref).abs().max().item(),
            ms=time_ms(lambda: softmax_lse.streaming_lse(ss, ii, bounded_shift=True), iters=5),
            plain_ms=time_ms(lambda: softmax_lse.streaming_lse_shift_reference(ss, ii), iters=3),
            library_ms=time_ms(lambda: torch.logsumexp(ss @ ii.T, dim=1), iters=3),
            # the inputs, the shift and the two (chunks, M) partials
            **tc_bounds((m * d + n * d + m + 2 * m * chunks_6) * 4, products),
        )
        del ss, ii, got, ref, kernel_6, exact, plain_tf32, shift, l_sum, gap
    torch.cuda.empty_cache()

    y = torch.randint(1, n, (m,), generator=gen, device=dev)
    pad = torch.rand((m,), generator=gen, device=dev) < 0.2  # PAD targets
    y[pad] = 0
    coeff = (y != 0).float() / (y != 0).sum()
    z = lse - torch.log(coeff)  # +inf on PAD rows

    # kernel 12: both softmax gradients from z in one pass (its partials fit the budget here)
    plan = softmax_lse.fused_bwd_plan(m, n, d, n_sms)
    check(plan[2] <= softmax_lse.FUSED_BWD_PARTIALS_BUDGET, f"kernel 12's partials {plan[2]} pass the budget")
    got = softmax_lse.softmax_grads_from_z(s, items, z)
    ref = softmax_lse.softmax_grads_from_z_reference(s, items, z, partials=True)
    rel = max(_max_rel(g, r) for g, r in zip(got, ref))
    check(rel <= TC_RTOL and not bool(got[0][pad].any()),
          f"grads_z_fused disagrees with its twin ({rel} of the largest entry) or a z = +inf row is not 0")
    again = softmax_lse.softmax_grads_from_z(s, items, z)
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, got)), "grads_z_fused: a second run gave other bits")

    def materialized(want_ds: bool = True, want_di: bool = True, s_=s, items_=items, z_=z) -> tuple:
        """P = exp(s @ itemsᵀ − z) in device memory, then its products."""
        p = (s_ @ items_.T).sub_(z_[:, None]).exp_()
        return (p @ items_ if want_ds else None), (p.T @ s_ if want_di else None)

    vectors = m * 4
    results["grads_z_fused"] = dict(
        max_abs_err=max((g - r).abs().max().item() for g, r in zip(got, ref)),
        ms=time_ms(lambda: softmax_lse.softmax_grads_from_z(s, items, z), iters=3),
        plain_ms=time_ms(lambda: softmax_lse.softmax_grads_from_z_reference(s, items, z), iters=3),
        library_ms=time_ms(materialized, iters=3),
        **tc_bounds((2 * m * d + 2 * n * d) * 4 + vectors, 3 * products),
    )
    print(f"train kernels: grads_z_fused {rel:.3g} of the largest entry from its twin (limit {TC_RTOL}), bit-equal "
          f"on a second run; partials {plan[2] / 2**20:.0f} MiB, {plan[1]} session groups of {plan[0]} tiles")
    del got, ref, again

    # kernels 13 + 14 with the budget forced to 0, at 15,872 items and at the odd catalog
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    lib = softmax_lse._native.load("softmax_lse", softmax_lse._SIGNATURES) if dev.type == "cuda" else None

    def split_pair(rows, z_, tag: str, timed: bool) -> None:
        """Kernels 13 + 14 against their twin (the split order), the same bits
        on a rerun; each kernel timed alone through the library handle (ds
        with the sum of its chunk partials)."""
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
        got_ = softmax_lse.softmax_grads_from_z(s, rows, z_)
        again_ = softmax_lse.softmax_grads_from_z(s, rows, z_)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        ref_ = softmax_lse.softmax_grads_from_z_reference(s, rows, z_, partials=False)
        errs = [_max_rel(g, r) for g, r in zip(got_, ref_)]
        n_rows = rows.shape[0]
        check(max(errs) <= TC_RTOL, f"grads_z_ds / grads_z_di at N={n_rows} disagree with their twin: {errs}")
        check(all(bool(torch.equal(a, g)) for a, g in zip(again_, got_)),
              f"grads_z_ds / grads_z_di at N={n_rows}: a second run gave other bits")
        if not timed:
            return
        plain = time_ms(lambda: softmax_lse.softmax_grads_from_z_reference(s, rows, z_, partials=False),
                        iters=1 if tag else 3, warmup=0 if tag else 2)
        n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, n_rows, d, n_sms)
        ds_part, out_di = torch.empty((n_chunks, m, d), device=dev), torch.empty_like(rows)
        ds_ms = di_ms = 0.0
        if lib is not None:
            stream = softmax_lse._native.current_stream_ptr(s.device)
            args = (s.data_ptr(), rows.data_ptr(), z_.data_ptr())

            def ds_kernel():
                lib.grads_z_ds_f32(*args, ds_part.data_ptr(), m, n_rows, d, chunk_rows, n_chunks, stream)
                return ds_part.sum(dim=0)

            ds_ms = time_ms(ds_kernel, iters=3)
            di_ms = time_ms(lambda: lib.grads_z_di_f32(*args, out_di.data_ptr(), m, n_rows, d, stream), iters=3)
            check(bool(torch.equal(ds_kernel(), got_[0])) and bool(torch.equal(out_di, got_[1])),
                  f"grads_z at N={n_rows}: the timed launches gave other bits than the wrapper's")
        n_products = 2 * m * n_rows * d
        lib_ds = time_ms(lambda: materialized(True, False, s, rows, z_), iters=1 if tag else 3)
        lib_di = time_ms(lambda: materialized(False, True, s, rows, z_), iters=1 if tag else 3)
        results[f"grads_z_ds{tag}"] = dict(
            max_abs_err=(got_[0] - ref_[0]).abs().max().item(), ms=ds_ms, plain_ms=plain, library_ms=lib_ds,
            **tc_bounds((2 * m * d + n_rows * d) * 4 + vectors, 2 * n_products))
        results[f"grads_z_di{tag}"] = dict(
            max_abs_err=(got_[1] - ref_[1]).abs().max().item(), ms=di_ms, plain_ms=plain, library_ms=lib_di,
            **tc_bounds((m * d + 2 * n_rows * d) * 4 + vectors, 2 * n_products))
        print(f"train kernels: at N={n_rows}: grads_z_ds {ds_ms:.4f} ms ({n_chunks} item chunks of {chunk_rows} rows) "
              f"+ grads_z_di {di_ms:.4f} ms; twin {plain:.1f} ms; max err relative to the largest entry "
              f"{max(errs):.3g} (limit {TC_RTOL}), bit-equal on a rerun")

    split_pair(items, z, "", timed=True)
    split_pair(items[:RAGGED_N], softmax_lse.streaming_lse(s, items[:RAGGED_N]) - torch.log(coeff), "_ragged",
               timed=False)
    print(f"train kernels: grads_z_ds / grads_z_di at N={RAGGED_N} within {TC_RTOL} of their twin")

    # kernel 7, from the same z: one pass (its partials fit the budget here), against the twin in that order
    check(softmax_lse._fused_on_the_card(m, n, d) and not softmax_lse.ce_takes_split_route(m, n, d),
          "the CE gradients at the training width do not take kernel 7's one pass")
    got = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    ref = softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=True)
    rel = max(_max_rel(got[0], ref[0]), _max_rel(got[1], ref[1]))
    check(rel <= TC_RTOL, f"CE gradients disagree with their twin: max err relative to the largest entry {rel}")
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, got)), "ce_grads_fused: a second run gave other bits")
    # the control: the same products in plain TF32 must fail the tensor-core tile's limit
    rel_plain = max(_max_rel(p, r) for p, r in zip(ce_grads_plain_tf32(torch, softmax_lse, s, items, z, y, coeff), ref))
    check(rel_plain > TC_RTOL, f"plain TF32 products read {rel_plain} of the largest entry, within TC_RTOL {TC_RTOL}")
    print(f"train kernels: CE gradients {rel:.3g} of the largest entry from their twin (limit {TC_RTOL}); the same "
          f"products in plain TF32 {rel_plain:.3g} (the SIMT kernels' limit is {CE_RTOL})")
    # again on the odd catalog, where every item tile leaves a tail (checked, not timed)
    rows, y_ragged = items[:RAGGED_N], torch.where(y < RAGGED_N, y, 0)
    z_ragged = softmax_lse.streaming_lse(s, rows) - torch.log(coeff)
    got_ragged = softmax_lse.softmax_ce_grads_from_z(s, rows, z_ragged, y_ragged, coeff)
    ref_ragged = softmax_lse.softmax_ce_grads_from_z_reference(s, rows, z_ragged, y_ragged, coeff, partials=True)
    rel_ce = max(_max_rel(g, r) for g, r in zip(got_ragged, ref_ragged))
    check(rel_ce <= TC_RTOL, f"CE gradients at N={RAGGED_N} disagree with their twin: {rel_ce}")
    print(f"kernels: at N={RAGGED_N}, CE gradients {rel_ce:.3g} of the largest entry from their twin")
    del rows, y_ragged, z_ragged, got_ragged, ref_ragged, again
    sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
    ce_lib = (F.cross_entropy(sg @ ig.T, y, reduction="none") * coeff).sum()
    ce_library_ms = grad_ms(ce_lib, (sg, ig), None, iters=3)
    ce_bytes = (2 * m * d + 2 * n * d + 3 * m) * 4
    results["ce_grads"] = dict(
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
        ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3),
        plain_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff), iters=3),
        library_ms=ce_library_ms, **tc_bounds(ce_bytes, 3 * products),
    )
    # kernel 7's two launches: a budget under the fused plan's partials and over the JAX rule's bytes
    plan = softmax_lse.fused_bwd_plan(m, n, d, n_sms)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = plan[2] - 1
    check(not softmax_lse._fused_on_the_card(m, n, d) and not softmax_lse.ce_takes_split_route(m, n, d),
          f"a budget of {plan[2] - 1} bytes does not send the CE gradients to kernel 7's two launches")
    pair = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    pair_ms = time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, pair)), "ce_grads_ds / _di: a second run gave other bits")
    ref_pair = softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=False)
    rel_pair = max(_max_rel(g, r) for g, r in zip(pair, ref_pair))
    check(rel_pair <= TC_RTOL, f"kernel 7's two launches disagree with their twin: {rel_pair}")
    # the control in the two launches' order: plain TF32 products must fail the tile's limit there too
    rel_pair_plain = max(_max_rel(p, r) for p, r in zip(
        ce_grads_plain_tf32(torch, softmax_lse, s, items, z, y, coeff, partials=False), ref_pair))
    check(rel_pair_plain > TC_RTOL,
          f"plain TF32 products in the two launches' order read {rel_pair_plain}, within TC_RTOL {TC_RTOL}")
    results["ce_grads_pair"] = dict(
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(pair, ref_pair)), ms=pair_ms,
        plain_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=False),
                         iters=3),
        library_ms=ce_library_ms, **tc_bounds(ce_bytes, 3 * products),
    )
    split_plan = softmax_lse.split_bwd_plan(m, n, d, n_sms)
    print(f"train kernels: CE gradients, one pass {results['ce_grads']['ms']:.4f} ms (bit-equal on a rerun; partials "
          f"{plan[2] / 2**20:.0f} MiB, {plan[1]} session groups of {plan[0]} tiles) beside the two launches "
          f"{pair_ms:.4f} ms (bit-equal on a rerun; ds in {split_plan[0]} item chunks of {split_plan[1]} rows); max "
          f"err relative to the largest entry {rel:.3g} / {rel_pair:.3g} (limit {TC_RTOL}); the two launches' "
          f"products in plain TF32 {rel_pair_plain:.3g}")
    del pair, ref_pair, again
    del items, lse, forwards, z, got, ref, sg, ig, ce_lib
    torch.cuda.empty_cache()

    # the very-large catalog: kernels 13 + 14, and the CE route against kernel 7 on the same inputs
    n_large = LARGE_N_ITEM_IDS + 1
    items = 0.1 * torch.randn((n_large, d), generator=gen, device=dev)
    y = torch.where(pad, 0, torch.randint(1, n_large, (m,), generator=gen, device=dev))
    z = softmax_lse.streaming_lse(s, items) - torch.log(coeff)
    # kernel 6 at the mid and the large fit's catalogs, timed beside its twin and the library call
    for tag, rows in (("_mid_catalog", items[: MID_N_ITEM_IDS + 1]), ("_large_catalog", items)):
        n_rows = rows.shape[0]
        chunks = -(-n_rows // softmax_lse.LSE_CHUNK)
        got, ref = softmax_lse.streaming_lse(s, rows), softmax_lse.streaming_lse_partials_reference(s, rows)
        rel = ((got - ref).abs() / ref.abs()).max().item()
        check(rel <= LSE_RTOL and bool(torch.equal(got, softmax_lse.streaming_lse(s, rows))),
              f"lse_partials_fwd at N={n_rows}: {rel} relative from its twin, or other bits on a rerun")
        results[f"lse_partials_fwd{tag}"] = dict(
            max_abs_err=(got - ref).abs().max().item(),
            ms=time_ms(lambda: softmax_lse.streaming_lse(s, rows), iters=3),
            plain_ms=time_ms(lambda: softmax_lse.streaming_lse_partials_reference(s, rows), iters=1, warmup=1),
            library_ms=time_ms(lambda: torch.logsumexp(s @ rows.T, dim=1), iters=1, warmup=1),
            **tc_bounds((m * d + n_rows * d + 2 * m * chunks) * 4, 2 * m * n_rows * d),
        )
        print(f"train kernels: lse_partials_fwd at N={n_rows} ({chunks} item chunks) {rel:.3g} relative per row from "
              f"its twin, bit-equal on a rerun")
        del got, ref
    torch.cuda.empty_cache()
    check(softmax_lse.ce_takes_split_route(m, n_large, d), f"the CE gradients at N={n_large} stay on kernel 7")
    split_pair(items, z, "_large_catalog", timed=True)
    route = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, route)), "the CE split route: a second run gave other bits")
    route_ms = time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62  # kernel 7's one pass at any size: 1.7 GiB of partials here
    large_plan = softmax_lse.fused_bwd_plan(m, n_large, d, n_sms)
    kernel_7 = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    kernel_7_ms = time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
    rel = max(_max_rel(a, k) for a, k in zip(route, kernel_7))
    check(rel <= CE_RTOL, f"the CE split route at N={n_large} differs from kernel 7 by {rel} of the largest entry")
    results["ce_grads_large_catalog_route"] = {"route_ms": route_ms, "kernel_7_ms": kernel_7_ms, "max_rel_diff": rel}
    print(f"train kernels: at N={n_large}: the CE split route {route_ms:.3f} ms beside kernel 7's one pass "
          f"{kernel_7_ms:.3f} ms (the budget lifted: {large_plan[2] / 2**30:.2f} GiB of partials, acceptable on an "
          f"80 GB card); they differ by {rel:.3g} of the largest entry; the route bit-equal on a rerun")
    del route, again, kernel_7
    # the other split kernels at this size (checked, not timed): kernel 7's two launches (the JAX rule set aside)
    # and kernels 10 + 11 (a zero bias, a cotangent of mixed sign), each against its twin in the split order
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
    takes_route, softmax_lse.ce_takes_split_route = softmax_lse.ce_takes_split_route, lambda *_: False
    bias, dlse = torch.zeros((n_large,), device=dev), torch.randn((m,), generator=gen, device=dev) / m
    lse_large = softmax_lse.streaming_lse(s, items)
    long_split = {
        "ce_grads_ds / _di": (softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff),
                              lambda: softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff,
                                                                                     partials=False)),
        "lse_bwd_ds / _di": (softmax_lse.streaming_lse_bwd(s, items, bias, lse_large, dlse),
                             lambda: softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse_large, dlse,
                                                                              partials=False)),
    }
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET, softmax_lse.ce_takes_split_route = budget, takes_route
    for what, (got_, twin) in long_split.items():
        rel = max(_max_rel(g, r) for g, r in zip(got_, twin()))
        check(rel <= TC_RTOL, f"{what} at N={n_large} disagree with their twin: {rel} of the largest entry")
        print(f"train kernels: at N={n_large}: {what} {rel:.3g} of the largest entry from their twin (limit {TC_RTOL})")
    del s, items, y, coeff, z, pad, bias, dlse, lse_large, long_split
    torch.cuda.empty_cache()
    for name, r in results.items():
        if "bound" not in r:
            continue
        print(
            f"train kernel {name}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} {bound_text(r)}"
        )
    return results


# ---------------------------------------------------------------- phase 7, STU attention kernels


def _stu_case(torch, dev, gen, b: int, l: int, per_row_allowed: bool = False, serving: bool = False,
              d: int = N_FACTORS // N_HEADS) -> tuple:
    """Inputs of the three STU kernels as the HSTU layer gives them: q, k, v,
    dout in (B, L, H, d) memory, the (B, L, L) time buckets and the bias of
    buckets plus positions, the causal mask (shared, or one per row with key
    padding) and a left-padded timeline whose last row is all padding. With
    ``serving`` the sessions have the frame's lengths (1-300, cut to L) as
    ``recommend`` sees them; otherwise every length is as likely."""
    from rectools_tpu_torch.ops import stu_attention

    h = N_HEADS
    q, k, v, dout = (torch.randn((b, l, h, d), generator=gen, device=dev).transpose(1, 2) for _ in range(4))
    gaps = torch.randint(1, 3 * 86400, (b, l + 2), generator=gen, device=dev)
    ts = 1_600_000_000 + torch.cumsum(gaps, dim=1)
    tw = 0.1 * torch.randn((NUM_BUCKETS + 1,), generator=gen, device=dev)
    pw = 0.1 * torch.randn((2 * l - 1,), generator=gen, device=dev)
    buckets = stu_attention.time_buckets(ts, l, NUM_BUCKETS)
    bias = stu_attention.combined_bias(buckets, tw, pw, l, dev)
    if serving:
        n_pad = (l - torch.randint(1, 301, (b,), generator=gen, device=dev)).clamp_(min=0)
    else:
        n_pad = torch.randint(0, l, (b,), generator=gen, device=dev)
    n_pad[0], n_pad[-1] = 0, l
    timeline = (torch.arange(l, device=dev)[None, :] >= n_pad[:, None]).float()
    allowed = torch.ones((l, l), device=dev).tril()[None]
    if per_row_allowed:
        allowed = torch.maximum(allowed * timeline[:, None, :], torch.eye(l, device=dev)[None]).contiguous()
    return q, k, v, dout, bias, allowed, timeline, buckets


def _stu_check(torch, args, dout, buckets, what: str, forward_only: bool = False) -> dict:
    """The three kernels (or the forward alone) against their twins on one
    case, the forward on its tensor-core route; out, dq, dk, dv, ds and the
    sums of ds by bucket bit-equal on a second run. Returns each kernel's
    largest absolute error."""
    from rectools_tpu_torch.ops import _native, stu_attention

    def worst(got, ref, tol: float, name: str) -> float:
        err = (got - ref).abs().max().item()
        limit = tol * max(1.0, ref.abs().max().item())
        check(bool(torch.isfinite(got).all()) and err <= limit, f"{name} {what}: max abs err {err} above {limit}")
        return err

    before = _native.LAUNCHES["stu_fwd"]
    out = stu_attention.stu_fwd(*args)
    check(_native.LAUNCHES["stu_fwd"] == before + 1, f"stu_fwd {what} did not take the tensor-core route")
    errs = {"stu_fwd": worst(out, stu_attention.stu_reference(*args), STU_FWD_TOL, "stu_fwd")}
    check(not bool(out[-1].any()), f"stu_fwd {what}: a fully padded row did not come out as zeros")
    check(bool(torch.equal(stu_attention.stu_fwd(*args), out)), f"stu_fwd {what}: a second run gave other bits")
    if forward_only:
        return errs
    got = stu_attention.stu_bwd(*args, dout)
    ref = stu_attention.stu_bwd_reference(*args, dout)
    errs["stu_bwd"] = max(worst(g, r, STU_GRAD_TOL, f"stu_bwd {n}") for g, r, n in zip(got, ref, ("dq", "dk", "dv")))
    ds = stu_attention.stu_ds(*args, dout, buckets, NUM_BUCKETS + 1)
    ref = stu_attention.stu_ds_reference(*args, dout, buckets, NUM_BUCKETS + 1)
    check(bool(ref[1].any()), f"stu_ds {what}: the twin's bucket sums are all zero")
    errs["stu_ds"] = max(worst(g, r, STU_GRAD_TOL, f"stu_ds {n}") for g, r, n in zip(ds, ref, ("ds", "bucket sums")))
    del ref
    again = (*stu_attention.stu_bwd(*args, dout), *stu_attention.stu_ds(*args, dout, buckets, NUM_BUCKETS + 1))
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, (*got, *ds))),
          f"stu_bwd / stu_ds {what}: a second run gave other bits")
    return errs


def _dead_unit_shares(torch, allowed, timeline, tile: int) -> tuple:
    """The shares of the warps' units, per (b, h), whose allowed * tl_q * tl_k
    is zero everywhere, so that kernel 18's tensor-core launches skip them:
    (16 keys x 32 queries of dk/dv, 16 queries x 32 keys of dq), the length
    padded to whole tiles of ``tile`` rows."""
    import torch.nn.functional as F

    b, l = timeline.shape
    n = -(-l // tile) * tile
    live = F.pad(allowed * timeline[:, :, None] * timeline[:, None, :], (0, n - l, 0, n - l)).ne(0)
    return tuple(1.0 - live.reshape(b, n // q, q, n // k, k).any(dim=4).any(dim=2).float().mean().item()
                 for q, k in ((32, 16), (16, 32)))


def stu_kernel_phase(torch, dev, b: int = TRAIN_B) -> dict:
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import stu_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    h, d = N_HEADS, N_FACTORS // N_HEADS
    results = {}

    # checked only: ragged lengths, the second with a mask that varies by row
    for l, per_row in ((80, False), (96, True)):
        q, k, v, dout, bias, allowed, timeline, buckets = _stu_case(torch, dev, gen, 8, l, per_row)
        args = (q, k, v, bias, allowed, timeline)
        errs = _stu_check(torch, args, dout, buckets, f"at L={l}")
        print(f"stu kernels: at L={l}{' with a per-row mask' if per_row else ''}, max abs err {errs}; "
              "out, dq, dk, dv, ds, bucket sums bit-equal on a second run; stu_bwd "
              f"{time_ms(lambda: stu_attention.stu_bwd(*args, dout)):.4f} ms, skipping (dk/dv, dq) "
              f"{_dead_unit_shares(torch, allowed, timeline, stu_attention.BWD_TILE)} of their units")

    def library(q, k, v, bias, allowed, timeline):
        """The materialized form: one einsum, SiLU and mask over (B, H, L, L), one einsum."""
        l = q.shape[2]
        mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
        return torch.einsum("bhqk,bhkd->bhqd", F.silu(s) / l * mask, v)

    for tag, shape in (("", dict(b=b, l=SESSION_MAX_LEN)), ("_long_ctx", LONG_CTX),
                       ("_serving", dict(b=SERVING_B, l=SESSION_MAX_LEN))):
        bb, l = shape["b"], shape["l"]
        serving = tag == "_serving"  # the shape recommend gives the forward; it runs no backward
        q, k, v, dout, bias, allowed, timeline, buckets = _stu_case(torch, dev, gen, bb, l, serving=serving)
        args = (q, k, v, bias, allowed, timeline)
        errs = _stu_check(torch, args, dout, buckets, f"at B={bb}, L={l}", forward_only=serving)
        # least work for this run's data: only pairs that the masks let through need their products
        n_pairs = h * (allowed * timeline[:, :, None] * timeline[:, None, :]).sum().item()
        qkv_bytes = 4 * 4 * bb * h * l * d  # q, k, v and one of out / dout, f32
        mask_bytes = (bias.numel() + allowed.numel() + timeline.numel()) * 4
        iters = 10 if bb * l <= TRAIN_B * SESSION_MAX_LEN else 3
        results[f"stu_fwd{tag}"] = dict(
            max_abs_err=errs["stu_fwd"],
            ms=time_ms(lambda: stu_attention.stu_fwd(*args), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_reference(*args), iters=iters),
            library_ms=time_ms(lambda: library(*args), iters=iters),
            # heads of 32: the forward's two products run in 3xTF32 on the tensor cores
            **tc_bounds(qkv_bytes + mask_bytes, 2 * n_pairs * 2 * d),
        )
        if serving:
            print(f"stu kernels: forward at B={bb}, L={l}: {n_pairs:.0f} unmasked (head, query, key) pairs of "
                  f"{bb * h * l * l}; out bit-equal on a second run")
            del q, k, v, dout, bias, allowed, timeline, buckets, args
            torch.cuda.empty_cache()
            continue
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        lib_out = library(*leaves, allowed, timeline)

        def grad_ms(inputs) -> float:
            return time_ms(lambda: torch.autograd.grad(lib_out, inputs, dout, retain_graph=True), iters=iters)

        def library_ds() -> tuple:
            """Autograd to the bias and ``index_add_`` by bucket (float atomics)."""
            (dbias,) = torch.autograd.grad(lib_out, leaves[3:], dout, retain_graph=True)
            sums = torch.zeros(NUM_BUCKETS + 1, device=dev)
            return dbias, sums.index_add_(0, buckets.reshape(-1), dbias.reshape(-1))

        tile_keys, tile_queries = stu_attention.ds_tile(d, d)
        n_partials = bb * math.ceil(l / tile_keys) * math.ceil(l / tile_queries)
        # heads of 32: the backward's products run in 3xTF32 on the tensor cores
        results[f"stu_bwd{tag}"] = dict(
            max_abs_err=errs["stu_bwd"],
            ms=time_ms(lambda: stu_attention.stu_bwd(*args, dout), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_bwd_reference(*args, dout), iters=iters),
            library_ms=grad_ms(leaves[:3]),
            **tc_bounds(qkv_bytes + 3 * 4 * bb * h * l * d + mask_bytes, 2 * n_pairs * 5 * d),
        )
        dead = _dead_unit_shares(torch, allowed, timeline, stu_attention.BWD_TILE)
        results[f"stu_ds{tag}"] = dict(
            max_abs_err=errs["stu_ds"],
            ms=time_ms(lambda: stu_attention.stu_ds(*args, dout, buckets, NUM_BUCKETS + 1), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_ds_reference(*args, dout, buckets, NUM_BUCKETS + 1),
                             iters=iters),
            library_ms=time_ms(library_ds, iters=iters),
            # reads the buckets too; writes ds, the per-block partials and their sum; s and da in 3xTF32 at heads
            # of 32
            **tc_bounds(qkv_bytes + mask_bytes + 2 * bias.numel() * 4 + (n_partials + 1) * (NUM_BUCKETS + 1) * 4,
                        2 * n_pairs * 2 * d + bias.numel()),
        )
        ds_alone_ms = time_ms(lambda: stu_attention.stu_ds(*args, dout), iters=iters)
        print(f"stu kernels: at B={bb}, L={l}: {n_pairs:.0f} unmasked (head, query, key) pairs of {bb * h * l * l}; "
              f"stu_ds without the bucket sums {ds_alone_ms:.4f} ms; stu_bwd skips (dk/dv, dq) {dead[0]:.3f}, "
              f"{dead[1]:.3f} of its warps' units; out, dq, dk, dv, ds, bucket sums bit-equal on a second run")
        del q, k, v, dout, bias, allowed, timeline, buckets, args, leaves, lib_out
        torch.cuda.empty_cache()
    for name, r in results.items():
        print(
            f"stu kernel {name}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} {bound_text(r)}"
        )
    return results



# ---------------------------------------------------------------- phase 8, the biased lse and its VJP


def mesh_kernel_phase(torch, dev, b: int = TRAIN_B) -> dict:
    """Kernels 8-11 against their twins at the shapes mesh training gives them."""
    from rectools_tpu_torch.ops import softmax_lse

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    l, d, n = SESSION_MAX_LEN, N_FACTORS, N_ITEM_IDS + 1
    ragged_shard = -(-RAGGED_N // 4)
    # tag: (session rows, item rows of the shard, invalid rows at its end)
    shapes = {"": (b * l, n, 0), "_shard_2x2": (b * l // 2, n // 2, 0),
              "_ragged_shard": (b * l // 2, ragged_shard, 4 * ragged_shard - RAGGED_N)}
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    results = {}
    for tag, (m, rows, n_invalid) in shapes.items():
        s = torch.randn((m, d), generator=gen, device=dev)
        items = 0.1 * torch.randn((rows, d), generator=gen, device=dev)
        bias = torch.zeros((rows,), device=dev)
        if n_invalid:
            items[rows - n_invalid:] = 0.0  # the zero rows a shard is padded with
            bias[rows - n_invalid:] = softmax_lse.NEG_BIG
        dlse = torch.randn((m,), generator=gen, device=dev) / m  # mixed sign
        what = f"at M={m}, N={rows}" + (f" with {n_invalid} invalid row(s)" if n_invalid else "")

        lse = softmax_lse.streaming_lse_fwd(s, items, bias)
        ref = softmax_lse.streaming_lse_bias_reference(s, items, bias)
        rel = ((lse - ref).abs() / ref.abs()).max().item()
        # the control: the same lse from plain TF32 products, in the card's chunks
        plain_tf32 = softmax_lse.streaming_lse_bias_reference(tf32(torch, s), tf32(torch, items), bias)
        rel_plain = ((plain_tf32 - ref).abs() / ref.abs()).max().item()
        check(bool(torch.isfinite(lse).all()) and rel <= LSE_TC_RTOL < rel_plain,
              f"biased lse {what}: {rel} relative from its twin and its plain-TF32 control {rel_plain}: not on "
              f"either side of {LSE_TC_RTOL}")
        check(bool(torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items, bias))),
              f"biased lse {what}: a second run gave other bits")
        if not n_invalid:  # kernel 8 is kernel 6 with a bias column
            check(bool(torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items))),
                  f"biased lse {what}: a zero bias changed the bits of the unbiased kernel 6")
        print(f"mesh kernels: biased lse {what} (3xTF32, {-(-rows // softmax_lse.LSE_CHUNK)} item chunks): {rel:.3g} "
              f"relative per row from its twin, plain TF32 products {rel_plain:.3g} (limit {LSE_TC_RTOL}), "
              f"bit-equal on a rerun{'' if n_invalid else ' and to kernel 6'}")
        del plain_tf32

        def library_lse(s_=s, items_=items):
            return torch.logsumexp(s_ @ items_.T + bias, dim=1)

        products = 2 * m * rows * d
        iters = 5 if tag == "" else 10
        results[f"lse_bias_fwd{tag}"] = dict(
            max_abs_err=(lse - ref).abs().max().item(),
            ms=time_ms(lambda: softmax_lse.streaming_lse_fwd(s, items, bias), iters=iters),
            plain_ms=time_ms(lambda: softmax_lse.streaming_lse_bias_reference(s, items, bias), iters=3),
            library_ms=time_ms(library_lse, iters=3),
            **tc_bounds((m * d + rows * d + rows + m) * 4, products),  # 3xTF32 products at d = 128
        )

        refs, got = {}, {}
        for route, forced in (("fused", 1 << 62), ("split", 0)):
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = forced
            got[route] = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
            again = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
            check(bool(torch.equal(again[0], got[route][0])) and bool(torch.equal(again[1], got[route][1])),
                  f"{route} lse backward {what}: a second run gave other bits")
            refs[route] = softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse, dlse, partials=route == "fused")
            rel = max(_max_rel(g, r) for g, r in zip(got[route], refs[route]))
            check(all(bool(torch.isfinite(g).all()) for g in got[route]) and rel <= TC_RTOL,
                  f"lse backward ({route}) {what} disagrees with its twin: {rel} of the largest entry")
            print(f"mesh kernels: lse backward ({route}) {what}: {rel:.3g} of the largest entry from its twin "
                  f"(limit {TC_RTOL}), bit-equal on a rerun")
            if n_invalid:
                check(not bool(got[route][1][rows - n_invalid:].any()),
                      f"lse backward ({route}) {what}: an invalid row's gradient is not exactly 0")
        ref_ds, ref_di = refs["fused"]
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62
        fused_ms = time_ms(lambda: softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse), iters=3)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
        # each split kernel alone, timed through the library handle (the wrapper launches the pair; ds with the
        # sum of its chunk partials)
        n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, rows, d, n_sms)
        ds_part, out_di = torch.empty((n_chunks, m, d), device=dev), torch.empty_like(items)
        ds_ms = di_ms = 0.0
        if dev.type == "cuda":
            lib = softmax_lse._native.load("softmax_lse", softmax_lse._SIGNATURES)
            stream = softmax_lse._native.current_stream_ptr(s.device)
            args = (s.data_ptr(), items.data_ptr(), bias.data_ptr(), lse.data_ptr(), dlse.data_ptr())

            def ds_kernel():
                lib.lse_bwd_ds_f32(*args, ds_part.data_ptr(), m, rows, d, chunk_rows, n_chunks, stream)
                return ds_part.sum(dim=0)

            ds_ms = time_ms(ds_kernel, iters=3)
            di_ms = time_ms(lambda: lib.lse_bwd_di_f32(*args, out_di.data_ptr(), m, rows, d, stream), iters=3)
            check(bool(torch.equal(ds_kernel(), got["split"][0])) and bool(torch.equal(out_di, got["split"][1])),
                  f"split lse backward {what}: the timed launches gave other bits than the wrapper's")
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        plain_ms = time_ms(lambda: softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse, dlse), iters=3)
        sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
        lib_out = library_lse(sg, ig)

        def grad_ms(inputs) -> float:
            return time_ms(lambda: torch.autograd.grad(lib_out, inputs, dlse, retain_graph=True), iters=3)

        vectors = (rows + 2 * m) * 4
        plan = softmax_lse.fused_bwd_plan(m, rows, d, n_sms)
        results[f"lse_bwd_fused{tag}"] = dict(
            max_abs_err=max((g - r).abs().max().item() for g, r in zip(got["fused"], (ref_ds, ref_di))),
            ms=fused_ms, plain_ms=plain_ms, library_ms=grad_ms((sg, ig)),
            **tc_bounds((2 * m * d + 2 * rows * d) * 4 + vectors, 3 * products),
        )
        # the twin computes both gradients in one walk: its time stands beside each split kernel
        results[f"lse_bwd_ds{tag}"] = dict(
            max_abs_err=(got["split"][0] - refs["split"][0]).abs().max().item(), ms=ds_ms, plain_ms=plain_ms,
            library_ms=grad_ms((sg,)), **tc_bounds((2 * m * d + rows * d) * 4 + vectors, 2 * products),
        )
        results[f"lse_bwd_di{tag}"] = dict(
            max_abs_err=(got["split"][1] - refs["split"][1]).abs().max().item(), ms=di_ms, plain_ms=plain_ms,
            library_ms=grad_ms((ig,)), **tc_bounds((m * d + 2 * rows * d) * 4 + vectors, 2 * products),
        )
        print(f"mesh kernels: {what}: fused backward {fused_ms:.4f} ms (partials {plan[2] / 2**20:.0f} MiB, "
              f"{plan[1]} session groups of {plan[0]} tiles) beside split {ds_ms + di_ms:.4f} ms "
              f"(ds {ds_ms:.4f} in {n_chunks} item chunks of {chunk_rows} rows + di {di_ms:.4f})")
        del s, items, bias, dlse, lse, ref, ref_ds, ref_di, refs, got, again, ds_part, out_di, sg, ig, lib_out
        torch.cuda.empty_cache()
    for name, r in results.items():
        print(
            f"mesh kernel {name}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} {bound_text(r)}"
        )
    return results

# ---------------------------------------------------------------- phase 4


def kion_frame(np, pd, Columns, n_item_ids: int = N_ITEM_IDS):
    """Synthetic KION-shaped interactions: session lengths 1-300, Zipf items."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, 301, size=N_USERS)
    users = np.repeat(np.arange(N_USERS), lengths)
    items = (rng.zipf(1.2, size=len(users)) - 1) % n_item_ids
    seconds = rng.integers(0, COVER_DAY * 86400, size=len(users))
    # every item id once more, last in time, so the table has all the ids
    cover_users = rng.integers(0, N_USERS, size=n_item_ids)
    users = np.concatenate([users, cover_users])
    items = np.concatenate([items, np.arange(n_item_ids)])
    seconds = np.concatenate([seconds, COVER_DAY * 86400 + np.arange(n_item_ids)])
    return pd.DataFrame(
        {
            Columns.User: users,
            Columns.Item: items,
            Columns.Weight: np.ones(len(users), np.float32),
            Columns.Datetime: pd.Timestamp(START) + pd.to_timedelta(seconds, unit="s"),
        }
    )


def flax_params(np, n_items: int, hstu: bool = False) -> dict:
    """Random weights in the JAX package's flax layout (SASRec's tree, or
    HSTU's), from the seed."""
    rng = np.random.default_rng(SEED + 1 + 10 * hstu)
    d = N_FACTORS

    def dense(fan_in, fan_out):
        return {
            "kernel": (rng.normal(size=(fan_in, fan_out)) / math.sqrt(fan_in)).astype(np.float32),
            "bias": (0.02 * rng.normal(size=(fan_out,))).astype(np.float32),
        }

    def norm():
        return {
            "scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32),
        }

    layers = {
        f"block_{i}": {
            "q_layer_norm": norm(),
            "multi_head_attn": {name: dense(d, d) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ff_layer_norm": norm(),
            "feed_forward": {"ff_linear_1": dense(d, d), "ff_linear_2": dense(d, d)},
        }
        for i in range(N_BLOCKS)
    }
    layers["last_layernorm"] = norm()
    if hstu:
        layers = {
            f"block_{i}": {
                "norm_input": norm(),
                "uvqk_proj": (rng.normal(size=(d, 4 * d)) / math.sqrt(d)).astype(np.float32),
                "rel_attn": {
                    "time_weights": (0.1 * rng.normal(size=(NUM_BUCKETS + 1,))).astype(np.float32),
                    "pos_weights": (0.1 * rng.normal(size=(2 * SESSION_MAX_LEN - 1,))).astype(np.float32),
                },
                "norm_attn_output": norm(),
                "output_mlp": dense(d, d),
            }
            for i in range(N_BLOCKS)
        }
    return {
        "item_model": {"item_net_blocks_0": {"ids_emb": (0.1 * rng.normal(size=(n_items, d))).astype(np.float32)}},
        "pos_encoding_layer": {"pos_emb": (0.1 * rng.normal(size=(SESSION_MAX_LEN, d))).astype(np.float32)},
        "transformer_layers": layers,
    }


def compare_reco(np, got, ref, k: int) -> int:
    """Per user: scores close; items equal wherever the score is separated
    from its neighbours by more than TIE_GAP (``ref`` holds k + 1 rows per
    user, so the k-th position has a neighbour below). Returns users compared."""
    n = 0
    for user, g in got.groupby("user_id", sort=False):
        r = ref[ref["user_id"] == user]
        gs, rs = g["score"].to_numpy()[:k], r["score"].to_numpy()
        check(len(gs) == k and len(rs) == k + 1, f"user {user}: {len(gs)} / {len(rs)} rows")
        check(
            np.allclose(gs, rs[:k], rtol=SCORE_RTOL, atol=SCORE_ATOL),
            f"user {user}: scores differ from the CPU run: {gs} vs {rs[:k]}",
        )
        gap = np.abs(np.diff(rs))
        separated = np.ones(k, bool)
        separated[1:] &= gap[: k - 1] > TIE_GAP
        separated &= gap[:k] > TIE_GAP
        gi, ri = g["item_id"].to_numpy()[:k], r["item_id"].to_numpy()[:k]
        check(bool(np.all(gi[separated] == ri[separated])), f"user {user}: items differ: {gi} vs {ri}")
        n += 1
    return n


def profile_phase(torch, recommend, by_kernel: bool = False) -> dict:
    """Where one warm recommend's time goes: device time by kernel name
    (torch.profiler), the device busy share of the call's wall time, and the
    host functions with the most cumulative time (cProfile; it inflates
    Python-heavy parts, so read it for where, not how much). ``by_kernel``
    adds ``device_ms_by_kernel``, {kernel name: device ms}."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        recommend()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(event) -> float:
        return float(getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0)))

    # only events that ran on the card: CPU operators report their kernels'
    # time too, and counting both would count each kernel twice
    rows = sorted(
        ((device_us(e), e.count, e.key) for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows) / 1e3
    copies = [r for r in rows if "direct_copy_kernel" in r[2]]  # dtype casts and contiguous copies
    copy_count, copy_ms = sum(r[1] for r in copies), sum(r[0] for r in copies) / 1e3
    print(f"profile: {device_ms:.2f} ms of device work in a {wall_ms:.1f} ms call, "
          f"busy share {device_ms / wall_ms:.4f}; {copy_count} copy kernels (casts, contiguous copies) "
          f"{copy_ms:.3f} ms")
    for us, count, name in rows[:12]:
        print(f"profile: device {us / 1e3:8.3f} ms x{count:<3d} {name[:90]}")

    host = cProfile.Profile()
    host.enable()
    recommend()
    host.disable()
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("cumulative").print_stats(25)
    for line in out.getvalue().splitlines():
        if "rectools_tpu_torch" in line or "{method" in line:
            print(f"profile: host {line.strip()}")
    out = {"profiled_wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
           "copy_kernels": copy_count, "copy_ms": copy_ms}
    if by_kernel:
        out["device_ms_by_kernel"] = {name: us / 1e3 for us, _, name in rows}
    return out


def later_context(np, pd, dataset):
    """The recommend context of a time-aware model: one timestamp per user,
    within a day after the frame's last interaction, through ``get_context``."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset.context import get_context

    users = dataset.user_id_map.external_ids
    seconds = (COVER_DAY + 1) * 86400 + np.random.default_rng(SEED + 4).integers(0, 86400, size=len(users))
    when = pd.Timestamp(START) + pd.to_timedelta(seconds, unit="s")
    return get_context(pd.DataFrame({Columns.User: users, Columns.Item: 0, Columns.Datetime: when}))


# the model families the script drives, by the prefix of their lines: SASRec, HSTU, BERT4Rec (PAD and MASK: a
# 15,873-row table) and eSASRec (SASRec over the LiGR stack with the sampled softmax over 128 negatives, the
# repo's "esasrec", benchmarks/quality_gate.py)
FAMILY_TAGS = {"sasrec": "", "hstu": "hstu ", "bert4rec": "bert4rec ", "esasrec": "esasrec "}
EXTRA_TOKENS = {"sasrec": 1, "hstu": 1, "bert4rec": 2, "esasrec": 1}
ESASREC_NEGATIVES = 128


def family_model(family: str, **kwargs):
    """A model of ``family`` built through its public class."""
    from rectools_tpu_torch.models import BERT4RecModel, HSTUModel, SASRecModel
    from rectools_tpu_torch.models.nn.transformers import LiGRLayers

    if family == "esasrec":
        kwargs = {**kwargs, "transformer_layers_type": LiGRLayers, "loss": "sampled_softmax",
                  "n_negatives": ESASREC_NEGATIVES}
    return {"sasrec": SASRecModel, "hstu": HSTUModel, "bert4rec": BERT4RecModel, "esasrec": SASRecModel}[family](
        **kwargs)


def forward_launches(family: str) -> dict:
    """Kernel launches of one encoder forward: per block two LayerNorms and one
    attention (HSTU: its STU attention), and SASRec's closing LayerNorm."""
    if family == "hstu":
        return {"layer_norm_fwd": 2 * N_BLOCKS, "stu_fwd": N_BLOCKS}
    return {"layer_norm_fwd": 2 * N_BLOCKS + (family == "sasrec"), "attention_fwd": N_BLOCKS}


def expected_fit_launches(port, family: str, steps: int, forwards: int, loss_keys=("lse_partials_fwd",
                          "ce_grads_fused"), recomputed: int = 0) -> dict:
    """Every launch count of a fit of ``steps`` train steps and ``forwards``
    encoder forwards (steps and validation batches), ``recomputed`` of them run
    again by remat in the backward: the loss kernels (``loss_keys``) once a
    step, the encoder's backward kernels once a step (HSTU's STU backward in its
    two tensor-core launches at heads of 32, and its score gradient)."""
    expected = {name: 0 for name in port.LAUNCHES}
    expected.update({key: steps for key in loss_keys})
    for key, n in forward_launches(family).items():
        expected[key] = n * (forwards + recomputed)
    if family == "hstu":
        expected.update(layer_norm_bwd=2 * N_BLOCKS * steps, stu_bwd=N_BLOCKS * steps, stu_bwd_dq=N_BLOCKS * steps,
                        stu_ds=N_BLOCKS * steps)
    else:
        expected.update(layer_norm_bwd=forward_launches(family)["layer_norm_fwd"] * steps,
                        attention_bwd=N_BLOCKS * steps)
    return expected


# the call sites of the native host ops (rectools_tpu_torch/native), and the collates around them
HOST_OP_FUNCTIONS = ("scatter_left_padded", "_csr_rows_to_padded_idx", "_collate_fn_train", "_collate_fn_recommend")
HOST_OP_TURNS = 3


def host_op_seconds(fn) -> dict:
    """Host seconds (cProfile, cumulative) of each function of
    HOST_OP_FUNCTIONS inside one call of ``fn``; a collate's seconds include
    the scatters it calls."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = {name: 0.0 for name in HOST_OP_FUNCTIONS}
    for (path, _, name), (_, _, _, cumulative, _) in pstats.Stats(prof).stats.items():
        if name in out and "rectools_tpu_torch" in path:
            out[name] += cumulative
    return out


def host_op_turns(np, fn, tag: str, what: str) -> dict:
    """``fn`` with the native host ops and with their numpy versions forced
    (``native.disabled()``), HOST_OP_TURNS walls of each in turns and one
    profiled call of each, in this one run."""
    from rectools_tpu_torch import native

    paths = {"native": contextlib.nullcontext, "numpy": native.disabled}
    walls = {path: [] for path in paths}
    for _ in range(HOST_OP_TURNS):
        for path, context in paths.items():
            with context():
                t0 = time.perf_counter()
                fn()
                walls[path].append(time.perf_counter() - t0)
    out = {}
    for path, context in paths.items():
        with context():
            seconds = host_op_seconds(fn)
        out[path] = {"wall_s": float(np.median(walls[path])), "wall_samples_s": walls[path], "host_s": seconds}
        print(f"{tag}: host ops {path:6s}: {what} wall median {out[path]['wall_s']:.4f} s of "
              f"{[round(t, 4) for t in walls[path]]}; host seconds (cProfile) "
              + ", ".join(f"{name} {sec:.4f}" for name, sec in seconds.items()))
    return out


def main_phase(torch, np, port, df, dataset, dev, family: str = "sasrec", model=None) -> dict:
    """The serving path of a family's model (HSTU with a recommend context):
    random flax-layout weights from the seed, or the weights of a ``model``
    fitted in this run."""
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers import state_dict_to_flax_params

    hstu = family == "hstu"
    tag = f"{FAMILY_TAGS[family]}main"
    config = dict(
        n_blocks=N_BLOCKS, n_heads=N_HEADS, n_factors=N_FACTORS, session_max_len=SESSION_MAX_LEN,
        dropout_rate=0.2, item_net_block_types=(IdEmbeddingsItemNet,),
    )
    extra = {"context": later_context(np, pd, dataset)} if hstu else {}
    n_rows = N_ITEM_IDS + EXTRA_TOKENS[family]
    if model is None:
        params = flax_params(np, n_rows, hstu)
        model = family_model(family, **config, device=dev).load_jax_params(dataset, params)
        cpu_config = {**config, "device": "cpu"}
    else:  # the fitted model's own configuration, whose validation split fixes its item ids
        params = state_dict_to_flax_params(model.training_module.full_state_dict())
        cpu_config = {**model.get_config(), "device": "cpu"}
        cpu_config.pop("cls")
    check(model.backbone.item_model.n_items == n_rows, f"item table is not {n_rows} rows")
    batch = model._effective_recommend_batch_size()
    check(batch == 4096, f"recommend batch resolved to {batch}, expected 4096")
    users = dataset.user_id_map.external_ids
    n_batches = math.ceil(len(users) / batch)

    port.reset_launches()
    t0 = time.perf_counter()
    reco = model.recommend(users, dataset, k=K, filter_viewed=True, **extra)
    first_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    expected = {name: 0 for name in port.LAUNCHES}  # no training kernel runs in recommend
    expected.update({key: n * n_batches for key, n in forward_launches(family).items()}, group_topm=n_batches)
    check(launches == expected, f"launches on the {tag} path {launches}, expected {expected}")
    print(f"{tag}: recommend {len(users)} users in {n_batches} batches, launches {launches}")
    if hstu:  # `expected` holds stu_fwd_simt and group_topm_warp at 0
        print(f"{tag}: kernel 17 on the tensor-core route, {launches['stu_fwd']} launches (SIMT route 0); kernel 3 "
              f"on the thread-per-group kernel, {launches['group_topm']} launches (warp kernel 0)")

    check(len(reco) == K * len(users), f"{len(reco)} rows, expected {K * len(users)}")
    check(bool((reco.groupby("user_id").size() == K).all()), "some user did not get k items")
    seen = set(zip(df[Columns.User].to_numpy().tolist(), df[Columns.Item].to_numpy().tolist()))
    check(not any(p in seen for p in zip(reco["user_id"].tolist(), reco["item_id"].tolist())), "a seen item came back")
    check(not bool(reco["item_id"].isin(["PAD", "MASK"]).any()), "an extra token (PAD or MASK) was recommended")
    scores = reco["score"].to_numpy().reshape(len(users), K)
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "scores not non-increasing within a user")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.recommend(users, dataset, k=K, filter_viewed=True, **extra)
        times.append(time.perf_counter() - t0)
    warm_s = float(np.median(times))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"{tag}: recommend wall first {first_s:.3f} s, warm median {warm_s:.3f} s of {[round(t, 3) for t in times]}, "
          f"{len(users) / warm_s:.0f} users/s, peak device memory {peak_mb:.0f} MiB")

    profile = profile_phase(torch, lambda: model.recommend(users, dataset, k=K, filter_viewed=True, **extra))
    host_ops = {}
    if family in ("sasrec", "hstu"):  # the serving call with the native host ops and with their numpy versions
        host_ops = host_op_turns(np, lambda: model.recommend(users, dataset, k=K, filter_viewed=True, **extra),
                                 tag, f"recommend {len(users)} users")

    if hstu:
        # the card's integer time buckets against the CPU's, on the first recommend batch of the frame
        from rectools_tpu_torch.ops import stu_attention

        u2i = model.data_preparator.transform_dataset_u2i(dataset, users, extra["context"])
        ts = torch.from_numpy(next(iter(model.data_preparator.get_dataloader_recommend(u2i, 1024)))["unix_ts"])
        ts = torch.cat([ts, ts[:, -1:]], dim=1)
        on_cpu = stu_attention.time_buckets(ts, SESSION_MAX_LEN, NUM_BUCKETS)
        on_card = stu_attention.time_buckets(ts.to(dev), SESSION_MAX_LEN, NUM_BUCKETS).cpu()
        check(bool(torch.equal(on_card, on_cpu)), "the card's time buckets differ from the CPU's")
        print(f"{tag}: {on_cpu.numel()} time buckets of the frame equal on the card and on the CPU, "
              f"{len(torch.unique(on_cpu))} distinct, largest {int(on_cpu.max())}")
    else:
        port.reset_launches()
        targets = model.data_preparator.get_known_item_ids()[:2048]
        i2i = model.recommend_to_items(targets, dataset, k=K)
        check(len(i2i) == K * len(targets), f"i2i returned {len(i2i)} rows")
        check(port.LAUNCHES["group_topm"] == 1, f"i2i launches {dict(port.LAUNCHES)}")
        print(f"{tag}: recommend_to_items {len(targets)} items, launches {dict(port.LAUNCHES)}")

    # the port's own CPU run (plain twins) on 64 users, same weights
    sample = users[:64]
    cpu_model = family_model(family, **cpu_config).load_jax_params(dataset, params)
    ref = cpu_model.recommend(sample, dataset, k=K + 1, filter_viewed=True, **extra)
    got = model.recommend(sample, dataset, k=K, filter_viewed=True, **extra)
    n_cmp = compare_reco(np, got, ref, K)
    print(f"{tag}: {n_cmp} users agree with the CPU run (score rtol {SCORE_RTOL}, atol {SCORE_ATOL})")
    return {"launches": launches, "first_s": first_s, "warm_s": warm_s, "warm_samples_s": times,
            "users_per_s": len(users) / warm_s, "peak_device_mib": peak_mb, "host_ops": host_ops, **profile}


# ---------------------------------------------------------------- phases 5 and 6


def hold_out_last(interactions):
    """Validation mask: for every eighth user (~1,024 of 8,192), the last
    interaction before the catalog-cover rows, which stay in training so that
    the item table keeps all 15,871 ids."""
    import pandas as pd

    from rectools_tpu_torch import Columns

    before = interactions[Columns.Datetime] < pd.Timestamp(START) + pd.Timedelta(days=COVER_DAY)
    last = interactions[Columns.Datetime].where(before).groupby(interactions[Columns.User]).transform("max")
    return (before & (interactions[Columns.Datetime] == last) & (interactions[Columns.User] % 8 == 0)).to_numpy()


TRAIN_CONFIG = dict(
    n_blocks=N_BLOCKS, n_heads=N_HEADS, n_factors=N_FACTORS, session_max_len=SESSION_MAX_LEN, dropout_rate=DROPOUT,
    batch_size=TRAIN_B, lr=LR, loss="softmax", seed=SEED,
)


def epoch_clock(torch, dev):
    """A training callback that reads the host clock, the device drained, at
    the start of a fit and at the end of every epoch (``times``)."""
    from rectools_tpu_torch.models.nn.transformers import TrainingCallback

    class EpochClock(TrainingCallback):
        def __init__(self) -> None:
            self.times = []

        def read(self) -> None:
            if str(dev) != "cpu":
                torch.cuda.synchronize()
            self.times.append(time.perf_counter())

        def on_train_start(self, module) -> None:
            self.read()

        def on_epoch_end(self, module, epoch, logs) -> bool:
            self.read()
            return False

    return EpochClock()


def train_phase(torch, np, port, df, dataset, dev, family: str = "sasrec") -> dict:
    """``fit`` at the training width for a family's model with the full-catalog
    softmax (SASRec, HSTU, BERT4Rec)."""
    import pandas as pd

    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch

    hstu = family == "hstu"
    tag = f"{FAMILY_TAGS[family]}train"
    clock = epoch_clock(torch, dev)
    model = family_model(
        family, **TRAIN_CONFIG, epochs=EPOCHS, item_net_block_types=(IdEmbeddingsItemNet,),
        get_val_mask_func=hold_out_last,
        get_callbacks_func=lambda: [clock], training_module_kwargs={"val_recall_k": K}, device=dev,
    )
    torch.cuda.reset_peak_memory_stats()
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tm = model.training_module
    n_rows = N_ITEM_IDS + EXTRA_TOKENS[family]
    check(model.backbone.item_model.n_items == n_rows, f"item table is not {n_rows} rows")
    check(tm._use_fused_softmax, "the full-catalog loss did not take the fused softmax-CE")
    steps = tm.global_step
    val_batches = len(model.data_preparator.get_dataloader_val())
    forwards = steps + EPOCHS * val_batches  # validation runs one forward per batch
    # kernel 7's one pass, never its two launches
    expected = expected_fit_launches(port, family, steps, forwards)
    check(launches == expected, f"launches in {tag} {launches}, expected {expected}")
    if hstu:  # `expected` holds stu_fwd_simt at 0
        print(f"{tag}: kernel 17 on the tensor-core route, {launches['stu_fwd']} launches (SIMT route 0)")
    losses, val_losses = tm.train_loss_history, tm.val_loss_history
    recall = tm.val_metric_history.get(f"val_recall@{K}", [])
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()), f"train losses {losses}")
    check(losses[1] < losses[0], f"train loss did not fall: {losses}")
    check(len(val_losses) == EPOCHS and bool(np.isfinite(val_losses).all()), f"validation losses {val_losses}")
    check(len(recall) == EPOCHS and bool(np.isfinite(recall).all()), f"val_recall@{K} {recall}")
    steps_per_epoch = steps // EPOCHS
    epoch2_s = clock.times[2] - clock.times[1]
    examples_per_s = TRAIN_B * steps_per_epoch / epoch2_s
    print(f"{tag}: fit {EPOCHS} epochs x {steps_per_epoch} steps of {TRAIN_B} in {fit_s:.2f} s, "
          f"{val_batches} validation batches per epoch; launches {launches}")
    print(f"{tag}: losses {losses}, val_loss {val_losses}, val_recall@{K} {recall}")
    print(f"{tag}: epoch 2 wall {epoch2_s:.3f} s (validation included), {examples_per_s:.0f} train examples/s, "
          f"peak device memory {peak_mb:.0f} MiB")

    users = dataset.user_id_map.external_ids[:1024]
    extra = {"context": later_context(np, pd, dataset)} if hstu else {}
    reco = model.recommend(users, dataset, k=K, filter_viewed=True, **extra)
    from rectools_tpu_torch import Columns

    check(len(reco) == K * len(users), f"{len(reco)} rows after fit, expected {K * len(users)}")
    seen = set(zip(df[Columns.User].to_numpy().tolist(), df[Columns.Item].to_numpy().tolist()))
    check(not any(p in seen for p in zip(reco["user_id"].tolist(), reco["item_id"].tolist())), "a seen item came back")
    check(not bool(reco["item_id"].isin(["PAD", "MASK"]).any()), "an extra token (PAD or MASK) was recommended")
    scores = reco["score"].to_numpy().reshape(len(users), K)
    check(bool(np.isfinite(scores).all()) and bool((np.diff(scores, axis=1) <= 0).all()), "bad scores after fit")
    print(f"{tag}: the fitted model recommends {K} unseen items to each of {len(users)} users")

    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
    batch = tm._device_batch(pad_batch(next(iter(loader)), TRAIN_B))
    print(f"{tag}: profile of one train step")
    profile = profile_phase(torch, lambda: tm._train_step(batch))
    host_ops = {}
    if family in ("sasrec", "hstu"):  # one epoch of the train collate, host only, native and numpy
        host_ops = host_op_turns(
            np, lambda: list(model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))), tag,
            f"the train loader's {steps_per_epoch} batches")
    return {"launches": launches, "steps": steps, "train_loss": losses, "val_loss": val_losses,
            f"val_recall@{K}": recall, "fit_s": fit_s, "epoch2_s": epoch2_s, "train_examples_per_s": examples_per_s,
            "peak_device_mib": peak_mb, "host_ops": host_ops, "model": model,
            **{f"step_{k}": v for k, v in profile.items()}}


def agreement_phase(torch, np, dataset, dev, family: str = "sasrec", **training_module_kwargs) -> dict:
    """3 train steps with dropout on the card and on the CPU twins, on one
    batch of 64 sessions of the KION frame, full catalog, for a family's model
    with the given training-module options."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch

    tag = f"{FAMILY_TAGS[family]}agree" + (f" {training_module_kwargs}" if training_module_kwargs else "")
    models = {}
    for run, device in (("cpu", "cpu"), ("card", dev)):
        model = family_model(
            family, **{**TRAIN_CONFIG, "batch_size": AGREE_SESSIONS}, item_net_block_types=(IdEmbeddingsItemNet,),
            training_module_kwargs=training_module_kwargs, device=device,
        )
        model._build_model_from_dataset(dataset)
        models[run] = model
    check(models["card"].backbone.item_model.n_items == N_ITEM_IDS + EXTRA_TOKENS[family],
          "agreement model is not at full width")
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    batch = pad_batch(next(iter(models["cpu"].data_preparator.get_dataloader_train(np.random.default_rng(SEED)))),
                      AGREE_SESSIONS)
    losses, grads = {}, {}
    t0 = time.perf_counter()
    for run, model in models.items():
        tm = model.training_module
        tm.load_params(start)
        device_batch = tm._device_batch(batch)
        losses[run], grads[run] = [], []
        for _ in range(AGREE_STEPS):
            losses[run].append(tm._train_step(device_batch).item())
            grads[run].append({n: p.grad.detach().cpu().clone() for n, p in model.backbone.named_parameters()})
    loss_rel = max(abs(g - c) / abs(c) for g, c in zip(losses["card"], losses["cpu"]))
    # The attention key-projection biases have a zero gradient in exact
    # arithmetic (softmax ignores a shift shared by a query's scores), so Adam
    # moves them by the sign of rounding noise: their reading is printed, not
    # held to PARAM_ATOL. Every other parameter entry is. HSTU has no such
    # parameter (its attention has no softmax and its projection no bias):
    # nothing of it is exempted.
    cpu_params = dict(models["cpu"].backbone.named_parameters())
    param_err, key_bias_err, worst, worst_at = 0.0, 0.0, "", 0
    for name, param in models["card"].backbone.named_parameters():
        diff = (param.detach().cpu() - cpu_params[name].detach()).abs().reshape(-1)
        err = diff.max().item()
        if name.endswith("multi_head_attn.k_proj.bias"):
            key_bias_err = max(key_bias_err, err)
        elif err > param_err:
            param_err, worst, worst_at = err, name, int(diff.argmax())
    print(f"{tag}: {AGREE_STEPS} steps on {AGREE_SESSIONS} sessions in {time.perf_counter() - t0:.1f} s; "
          f"losses card {losses['card']} cpu {losses['cpu']}; max loss rel diff {loss_rel:.3g}, "
          f"max param abs diff {param_err:.3g} in {worst} (key-projection biases {key_bias_err:.3g})")
    # Why the parameters differ more than the losses: the gradients' own
    # agreement, each parameter's relative to its largest gradient entry, and
    # the gradients at the entry that differs most. Adam moves an entry by
    # lr * m / (sqrt(v) + 1e-8): where |gradient| is near 1e-8 or changes sign,
    # rounding noise of that size becomes a visible share of lr.
    grad_abs, grad_rel = 0.0, 0.0
    for on_card, on_cpu in zip(grads["card"], grads["cpu"]):
        for name, g in on_card.items():
            if not name.endswith("multi_head_attn.k_proj.bias"):
                err = (g - on_cpu[name]).abs().max().item()
                grad_abs, grad_rel = max(grad_abs, err), max(grad_rel, err / on_cpu[name].abs().max().item())
    at_worst = {run: [g[worst].reshape(-1)[worst_at].item() for g in grads[run]] for run in grads}
    largest = max(g[worst].abs().max().item() for g in grads["cpu"])
    print(f"{tag}: gradients over the {AGREE_STEPS} steps: max abs diff {grad_abs:.3g}, max diff relative to the "
          f"parameter's largest gradient entry {grad_rel:.3g}; at entry {worst_at} of {worst} the gradients were "
          f"card {at_worst['card']} cpu {at_worst['cpu']} (largest entry of that gradient {largest:.3g}, lr {LR})")
    check(loss_rel <= LOSS_RTOL, f"train losses differ from the CPU run by {loss_rel} relative")
    check(param_err <= PARAM_ATOL, f"parameters differ from the CPU run by {param_err}")
    return {"loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err, "key_bias_max_abs_diff": key_bias_err,
            "grad_max_abs_diff": grad_abs, "grad_max_rel_diff": grad_rel, "worst_param": worst,
            "worst_entry_grads": at_worst}

# ---------------------------------------------------------------- phases 11 and 12: checkpoints and evaluation


def serving_launches(port, family: str, n_batches: int) -> dict:
    """Every launch count of a recommend that encodes ``n_batches`` batches."""
    expected = {name: 0 for name in port.LAUNCHES}
    expected.update({key: n * n_batches for key, n in forward_launches(family).items()}, group_topm=n_batches)
    return expected


def _same_reco(got, ref) -> bool:
    """The same rows, items and scores, bit for bit."""
    return bool(got.reset_index(drop=True).equals(ref.reset_index(drop=True)))


def checkpoint_phase(torch, np, pd, port, dataset, dev, model, family: str = "sasrec") -> dict:
    """A model fitted by ``train_phase`` through its checkpoints:
    ``save_checkpoint`` -> ``load_from_checkpoint`` -> recommend for all users
    (bit-equal to the fitted model; its launches counted),
    ``load_weights_from_checkpoint`` into a second model fitted from another
    seed, ``load_model`` of ``model.save``, and a CPU copy through
    ``model_params_update={"device": "cpu"}`` against the card on 64 users."""
    import io

    from rectools_tpu_torch.models import load_model
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    tag = f"{FAMILY_TAGS[family]}checkpoint"
    extra = {"context": later_context(np, pd, dataset)} if family == "hstu" else {}
    users = dataset.user_id_map.external_ids
    # the fit's callbacks factory is a closure over this run's epoch clock, which no config can name
    model.get_callbacks_func = None
    ref = model.recommend(users, dataset, k=K, filter_viewed=True, **extra)

    buf = io.BytesIO()
    t0 = time.perf_counter()
    size = model.save_checkpoint(buf)
    save_s = time.perf_counter() - t0
    buf.seek(0)
    t0 = time.perf_counter()
    loaded = type(model).load_from_checkpoint(buf)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(next(loaded.backbone.parameters()).device.type == torch.device(dev).type, "the loaded model left the card")
    port.reset_launches()
    got = loaded.recommend(users, dataset, k=K, filter_viewed=True, **extra)
    launches = dict(port.LAUNCHES)
    n_batches = math.ceil(len(users) / loaded._effective_recommend_batch_size())
    expected = serving_launches(port, family, n_batches)
    check(launches == expected, f"launches of the loaded model's recommend {launches}, expected {expected}")
    check(_same_reco(got, ref), "the model loaded from its checkpoint recommends other items or scores")
    print(f"{tag}: checkpoint of {size / 2**20:.2f} MiB, save_checkpoint {save_s:.3f} s, load_from_checkpoint "
          f"{load_s:.3f} s; recommend for {len(users)} users bit-equal to the fitted model's; launches {launches}")

    second = family_model(
        family, **{**TRAIN_CONFIG, "seed": SEED + 7}, epochs=1, item_net_block_types=(IdEmbeddingsItemNet,),
        get_val_mask_func=hold_out_last, device=dev,
    ).fit(dataset)
    check(not _same_reco(second.recommend(users, dataset, k=K, filter_viewed=True, **extra), ref),
          "the second model already recommends as the first")
    buf.seek(0)
    t0 = time.perf_counter()
    second.load_weights_from_checkpoint(buf)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    check(_same_reco(second.recommend(users, dataset, k=K, filter_viewed=True, **extra), ref),
          "load_weights_from_checkpoint did not give the fitted model's recommendations")
    check(second.training_module.global_step == model.training_module.global_step, "the step count was not loaded")

    saved = io.BytesIO()
    model.save(saved)
    saved.seek(0)
    check(_same_reco(load_model(saved).recommend(users, dataset, k=K, filter_viewed=True, **extra), ref),
          "load_model of model.save does not recommend as the fitted model")
    print(f"{tag}: load_weights_from_checkpoint into a model fitted from seed {SEED + 7} in {weights_s:.3f} s, "
          f"and load_model of model.save: recommend bit-equal to the fitted model's")

    buf.seek(0)
    t0 = time.perf_counter()
    cpu = type(model).load_from_checkpoint(buf, model_params_update={"device": "cpu"})
    cpu_load_s = time.perf_counter() - t0
    check(next(cpu.backbone.parameters()).device.type == "cpu", "the CPU copy is not on the CPU")
    sample = users[:64]
    n_cmp = compare_reco(np, model.recommend(sample, dataset, k=K, filter_viewed=True, **extra),
                         cpu.recommend(sample, dataset, k=K + 1, filter_viewed=True, **extra), K)
    print(f"{tag}: the CPU copy (model_params_update device cpu, loaded in {cpu_load_s:.3f} s) agrees with the card "
          f"on {n_cmp} users (score rtol {SCORE_RTOL}, atol {SCORE_ATOL})")
    return {"launches": launches, "checkpoint_bytes": size, "save_s": save_s, "load_s": load_s,
            "load_weights_s": weights_s, "cpu_load_s": cpu_load_s, "cpu_users_compared": n_cmp}


EVAL_FOLDS = 2  # 1-day test windows at the end of the frame
EVAL_FEATURES = 4


def evaluation_metrics(np, pd, n_item_ids: int = N_ITEM_IDS) -> dict:
    """The quickstart's metrics at k = K; IntraListDiversity over a random
    (n_item_ids, EVAL_FEATURES) categorical feature table from the seed."""
    from rectools_tpu_torch import metrics as m

    features = pd.DataFrame(np.random.default_rng(SEED + 5).integers(0, 4, size=(n_item_ids, EVAL_FEATURES)),
                            index=np.arange(n_item_ids), columns=[f"feature_{i}" for i in range(EVAL_FEATURES)])
    return {
        f"precision@{K}": m.Precision(k=K), f"recall@{K}": m.Recall(k=K), f"ndcg@{K}": m.NDCG(k=K),
        f"map@{K}": m.MAP(k=K), f"mrr@{K}": m.MRR(k=K), f"serendipity@{K}": m.Serendipity(k=K),
        f"miuf@{K}": m.MeanInvUserFreq(k=K), f"arp@{K}": m.AvgRecPopularity(k=K),
        f"coverage@{K}": m.CatalogCoverage(k=K),
        f"ild@{K}": m.IntraListDiversity(k=K, distance_calculator=m.PairwiseHammingDistanceCalculator(features)),
        f"sufficient@{K}": m.SufficientReco(k=K),
    }


def evaluate_phase(torch, np, pd, port, dataset, dev) -> dict:
    """``cross_validate`` of SASRec at the training width (1 epoch a fold)
    over the last EVAL_FOLDS days of the frame, held against the same folds
    by hand: split -> fit -> recommend -> calc_metrics."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.metrics import calc_metrics
    from rectools_tpu_torch.model_selection import TimeRangeSplitter, cross_validate
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    metrics = evaluation_metrics(np, pd)
    config = {**TRAIN_CONFIG, "epochs": 1, "item_net_block_types": (IdEmbeddingsItemNet,), "device": dev}
    splitter = TimeRangeSplitter("1D", n_splits=EVAL_FOLDS)

    port.reset_launches()
    t0 = time.perf_counter()
    cv = cross_validate(dataset, splitter, metrics, {"sasrec": family_model("sasrec", **config)}, k=K,
                        filter_viewed=True)
    wall_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)

    expected = {name: 0 for name in port.LAUNCHES}
    by_hand, folds = [], []
    t0 = time.perf_counter()
    for train_rows, test_rows, info in splitter.split(dataset.interactions, collect_fold_stats=True):
        train = dataset.filter_interactions(train_rows, keep_external_ids=True)
        test = dataset.interactions.df.loc[test_rows].copy()
        test[Columns.User] = dataset.user_id_map.convert_to_external(test[Columns.User])
        test[Columns.Item] = dataset.item_id_map.convert_to_external(test[Columns.Item])
        history = train.get_raw_interactions()
        model = family_model("sasrec", **config)
        port.reset_launches()
        model.fit(train)
        fit_launches = dict(port.LAUNCHES)
        steps = model.training_module.global_step
        fit_expected = expected_fit_launches(port, "sasrec", steps, steps)
        check(fit_launches == fit_expected, f"evaluate: fold {info['i_split']} fit launches {fit_launches}, "
              f"expected {fit_expected}")
        users = test[Columns.User].unique()
        n_encoded = model.data_preparator.transform_dataset_u2i(train, users).user_id_map.size
        port.reset_launches()
        reco = model.recommend(users, train, k=K, filter_viewed=True)
        reco_launches = dict(port.LAUNCHES)
        reco_expected = serving_launches(port, "sasrec", math.ceil(n_encoded / model._effective_recommend_batch_size()))
        check(reco_launches == reco_expected, f"evaluate: fold {info['i_split']} recommend launches {reco_launches}, "
              f"expected {reco_expected}")
        for key in expected:
            expected[key] += fit_launches[key] + reco_launches[key]
        values = calc_metrics(metrics, reco, test, history, history[Columns.Item].unique())
        by_hand.append({"model": "sasrec", "i_split": info["i_split"], **values})
        folds.append({"i_split": info["i_split"], "start": str(info["start"]), "end": str(info["end"]),
                      "train_interactions": len(train_rows), "test_interactions": len(test_rows),
                      "target_users": len(users), "train_steps": steps})
    by_hand_s = time.perf_counter() - t0

    check(launches == expected, f"launches in cross_validate {launches}, expected {expected} (the loop by hand)")
    ran = ("layer_norm_fwd", "attention_fwd", "group_topm", "layer_norm_bwd", "attention_bwd", "lse_partials_fwd",
           "ce_grads_fused")
    check(all(launches[key] > 0 for key in ran), f"a kernel of 1-7 was not launched; launches {launches}")
    check(len(cv["metrics"]) == len(by_hand) == EVAL_FOLDS, f"{len(cv['metrics'])} folds scored")
    worst = 0.0
    for row, ref in zip(cv["metrics"], by_hand):
        check(row.keys() == ref.keys(), f"metrics {sorted(row)} vs {sorted(ref)}")
        worst = max([worst] + [abs(row[k] - ref[k]) for k in metrics])
        check(row == ref, f"fold {ref['i_split']}: cross_validate {row} differs from the loop by hand {ref}")
        check(all(math.isfinite(row[k]) for k in metrics), f"fold {ref['i_split']}: non-finite metric {row}")
        check(0 < row[f"recall@{K}"] <= 1 and row[f"sufficient@{K}"] > 0, f"fold {ref['i_split']}: {row}")
    for fold, row in zip(folds, cv["metrics"]):
        print(f"evaluate: fold {fold['i_split']} [{fold['start']}, {fold['end']}): {fold['train_interactions']} train "
              f"/ {fold['test_interactions']} test interactions, {fold['target_users']} users, "
              f"{fold['train_steps']} steps; " + ", ".join(f"{k} {row[k]:.6g}" for k in metrics))
    print(f"evaluate: cross_validate of SASRec over {EVAL_FOLDS} folds with {len(metrics)} metrics in {wall_s:.2f} s "
          f"(the loop by hand {by_hand_s:.2f} s); every metric equal to the loop by hand (max abs diff {worst:.3g}); "
          f"launches {launches}")
    return {"launches": launches, "wall_s": wall_s, "by_hand_s": by_hand_s, "folds": folds, "metrics": cv["metrics"]}


# ---------------------------------------------------------------- phase 13, the classic models


CLASSIC_CATEGORIES = 12  # PopularInCategory's item feature: item id mod 12
CLASSIC_NEIGHBOURS = 50  # ItemKNN's K
CLASSIC_FACTORS = 64  # PureSVD's factors
CLASSIC_I2I_ITEMS = 256
CLASSIC_WHITELIST = 4096  # items of the whitelisted recommend, drawn from the seed
CLASSIC_CPU_USERS = 64
CLASSIC_WARM_CALLS = 3
EASE_SOLVER_RTOL, EASE_SOLVER_ATOL = 1e-3, 1e-4  # auto against exact, tests/models/test_ease_svd.py:168
# models whose scores are sums of floats: against the CPU a user's items may swap inside TIE_GAP, counted
CLASSIC_FLOAT_SCORES = ("ease", "ease_exact", "pure_svd", "item_knn_bm25")


def classic_models(dev) -> dict:
    from rectools_tpu_torch.models import (
        EASEModel, ItemKNNModel, PopularInCategoryModel, PopularModel, PureSVDModel, RandomModel,
    )

    return {
        "popular": PopularModel(device=dev),
        "popular_in_category": PopularInCategoryModel(category_feature="category", n_categories=CLASSIC_CATEGORIES,
                                                      device=dev),
        "random": RandomModel(random_state=SEED, device=dev),
        "ease": EASEModel(device=dev),
        "ease_exact": EASEModel(solver="exact", device=dev),
        "pure_svd": PureSVDModel(factors=CLASSIC_FACTORS, device=dev),
        "item_knn_plain": ItemKNNModel(K=CLASSIC_NEIGHBOURS, variant="plain", device=dev),
        "item_knn_bm25": ItemKNNModel(K=CLASSIC_NEIGHBOURS, variant="bm25", device=dev),
    }


def category_dataset(np, pd, df):
    """The frame with one categorical item feature, item id mod CLASSIC_CATEGORIES."""
    from rectools_tpu_torch.dataset import Dataset

    items = np.unique(df["item_id"].to_numpy())
    features = pd.DataFrame({"id": items, "feature": "category", "value": items % CLASSIC_CATEGORIES})
    return Dataset.construct(df, item_features_df=features, cat_item_features=["category"])


def _count_group_topm(port, fn, totals: dict):
    """``fn()`` with kernel 3's launches counted from 0 into ``totals``."""
    port.reset_launches()
    out = fn()
    launches = dict(port.LAUNCHES)
    check(all(n == 0 for key, n in launches.items() if key not in ("group_topm", "group_topm_warp")),
          f"a kernel other than kernel 3 ran in a classic model: {launches}")
    for key in ("group_topm", "group_topm_warp"):
        totals[key] = totals.get(key, 0) + launches[key]
    return out, launches["group_topm"] + launches["group_topm_warp"]


def _check_u2i(np, reco, users, seen: set, k: int, what: str, whitelist=None) -> None:
    check(len(reco) == k * len(users), f"{what}: {len(reco)} rows, expected {k * len(users)}")
    check(bool((reco.groupby("user_id").size() == k).all()), f"{what}: some user did not get k items")
    check(not any(p in seen for p in zip(reco["user_id"].tolist(), reco["item_id"].tolist())),
          f"{what}: a seen item came back")
    check(not bool(reco.duplicated(["user_id", "item_id"]).any()), f"{what}: an item came back twice for a user")
    scores = reco["score"].to_numpy().reshape(len(users), k)
    check(bool(np.isfinite(scores).all()), f"{what}: non-finite scores")
    if whitelist is not None:
        check(bool(reco["item_id"].isin(whitelist).all()), f"{what}: an item outside the whitelist")


def _cpu_agreement(np, name: str, model, data, users, cpu=None, float_scores=None, phase: str = "classic") -> str:
    """The same fitted arrays in a CPU model (the plain twins; ``cpu``, else
    a copy through ``models/convert.py``): identical items and scores within
    SCORE_RTOL / SCORE_ATOL on ``users``. Where the scores are sums of floats
    (``float_scores``, by default the classic models of
    CLASSIC_FLOAT_SCORES), a user whose items differ is held to
    ``compare_reco`` alone (items may swap only inside TIE_GAP) and counted."""
    from rectools_tpu_torch.models import model_from_config
    from rectools_tpu_torch.models.convert import fitted_arrays, load_fitted_arrays

    if cpu is None:
        cpu = load_fitted_arrays(model_from_config({**model.get_config(), "device": "cpu"}), fitted_arrays(model))
    if float_scores is None:
        float_scores = name in CLASSIC_FLOAT_SCORES
    got = model.recommend(users, data, k=K, filter_viewed=True)
    ref = cpu.recommend(users, data, k=K + 1, filter_viewed=True)
    ref_k = ref.groupby("user_id", sort=False).head(K)
    check(np.array_equal(got["user_id"].to_numpy(), ref_k["user_id"].to_numpy()),
          f"{phase} {name}: users or their counts differ from the CPU copy")
    check(bool(np.allclose(got["score"], ref_k["score"], rtol=SCORE_RTOL, atol=SCORE_ATOL)),
          f"{phase} {name}: scores differ from the CPU copy")
    same_rows = got["item_id"].to_numpy() == ref_k["item_id"].to_numpy()
    differ = got.loc[~same_rows, "user_id"].unique()
    check(len(differ) == 0 or float_scores,
          f"{phase} {name}: items differ from the CPU copy for {len(differ)} users")
    for user in differ:
        compare_reco(np, got[got["user_id"] == user], ref[ref["user_id"] == user], K)
    return (f"{len(users) - len(differ)} of {len(users)} users identical to the CPU copy (scores within rtol "
            f"{SCORE_RTOL}, atol {SCORE_ATOL}); {len(differ)} differ only inside ties of TIE_GAP {TIE_GAP}")


def _random_properties(np, model, data, users, first) -> str:
    """RandomModel's agreement is about properties: scores n..1, the same
    output from a refit with the same random_state, other output next call."""
    from rectools_tpu_torch.models import RandomModel

    scores = first["score"].to_numpy().reshape(len(users), K)
    check(bool((scores == np.arange(K, 0, -1)).all()), "classic random: scores are not n..1")
    refit = RandomModel(random_state=SEED, device=model.device).fit(data)
    check(_same_reco(refit.recommend(users, data, k=K, filter_viewed=True), first),
          "classic random: a refit with the same random_state gave other items")
    again = refit.recommend(users, data, k=K, filter_viewed=True)
    changed = float((again["item_id"].to_numpy() != first["item_id"].to_numpy()).mean())
    check(changed > 0.5, f"classic random: the next call repeated the draws ({changed:.3f} of the rows changed)")
    return f"scores n..1; a refit from random_state={SEED} repeats the first call; the next call changes {changed:.4f}"


def truncation_kernel_check(torch, np, dataset, dev) -> dict:
    """Kernel 3 at ItemKNN's truncation shape: the plain co-counts of the
    frame (15,871 x 15,871, padded to 15,872 columns), K = 50 candidates a
    group (the sorting kernel, launch key group_topm_warp), in blocks of 4,096
    rows. No block sorted again; each block's group top-50 bit-equal to the
    twin's, and its group top-128 (the whole group in order); the truncated
    table bit-equal to the one from a full stable sort of each block. The
    kernel on one block is timed at m = 50 and 128 beside its twin, the
    group-wise ``torch.topk`` (the kernel's function up to tie order) and the
    row-wise ``torch.topk`` (the truncation's), and the whole truncation
    beside the same table by the stable sort (its plain version) and by
    torch.topk, against the bound of reading S and writing the table."""
    import torch.nn.functional as F

    from rectools_tpu_torch.models.item_knn import TRUNCATE_BLOCK_ROWS, _truncate_topk_rows, apply_weighting
    from rectools_tpu_torch.ops import _native, linalg, topk_select

    ui = dataset.get_user_item_matrix(include_weights=True)
    s = linalg.gram_matrix(apply_weighting(ui, "plain").astype(np.float32).tocsr(), device=dev)
    n = s.shape[0]
    k = min(CLASSIC_NEIGHBOURS, n)
    m = min(k, topk_select.GROUP_W)  # _truncate_topk_rows's candidates a group
    n_blocks = math.ceil(n / TRUNCATE_BLOCK_ROWS)
    before, fallbacks = _native.LAUNCHES["group_topm_warp"], topk_select.FALLBACKS["exact_top_k"]
    truncated = _truncate_topk_rows(s, k)
    check(_native.LAUNCHES["group_topm_warp"] - before == n_blocks,
          "truncation: not one group_topm_warp launch a block")
    fired = topk_select.FALLBACKS["exact_top_k"] - fallbacks
    check(fired == 0, f"truncation: {fired} blocks failed the certificate with {m} candidates a group")

    def by_blocks(select):
        out = torch.zeros_like(s)
        for start in range(0, n, TRUNCATE_BLOCK_ROWS):
            vals, idx = select(s[start : start + TRUNCATE_BLOCK_ROWS])
            out[start : start + TRUNCATE_BLOCK_ROWS].scatter_(1, idx, vals)
        return out

    def by_sort():
        return by_blocks(lambda block: topk_select.sorted_top_k(block, k))

    def by_library():  # torch.topk: no tie order on CUDA, timed only
        return by_blocks(lambda block: torch.topk(block, k, dim=1))

    check(bool(torch.equal(truncated, by_sort())), "truncation: the kernel's top-K differs from the stable sort's")
    del truncated
    whole = dict(
        max_abs_err=0.0,
        ms=time_ms(lambda: _truncate_topk_rows(s, k), iters=5, warmup=1),
        plain_ms=time_ms(by_sort, iters=5, warmup=1),
        library_ms=time_ms(by_library, iters=5, warmup=1),
        bound=bound_ms(2 * s.numel() * 4, s.numel()),
    )

    n_pad = -(-n // topk_select.GROUP_W) * topk_select.GROUP_W
    blocks = [F.pad(s[start : start + TRUNCATE_BLOCK_ROWS], (0, n_pad - n), value=float("-inf"))
              for start in range(0, n, TRUNCATE_BLOCK_ROWS)]
    for i, block in enumerate(blocks):
        for m_ in (m, topk_select.GROUP_W):
            vals, lanes = topk_select.group_topm(block, m_)
            ref_vals, ref_lanes = topk_select.group_topm_reference(block, m_)
            check(bool(torch.equal(vals, ref_vals) and torch.equal(lanes, ref_lanes)),
                  f"truncation: group_topm at m={m_} differs from its twin on block {i}")
        del vals, lanes, ref_vals, ref_lanes
    block = blocks[0]
    b, g = block.shape[0], n_pad // topk_select.GROUP_W
    zero_share = float((s == 0).float().mean())

    def timed(m_: int) -> dict:
        # library_ms: the group-wise torch.topk, the kernel's function up to tie order; rowwise_library_ms: the
        # row-wise top-K, the truncation's
        return dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: topk_select.group_topm(block, m_)),
            plain_ms=time_ms(lambda: topk_select.group_topm_reference(block, m_), iters=1, warmup=1),
            library_ms=time_ms(lambda: torch.topk(block.view(-1, topk_select.GROUP_W), m_, dim=1)),
            rowwise_library_ms=time_ms(lambda: torch.topk(block[:, :n], k, dim=1)),
            bound=bound_ms(block.numel() * 4 + b * g * m_ * 8, block.numel()), m=m_,
        )

    result = dict(**timed(m), blocks=n_blocks, fired=fired, zero_share=zero_share, whole=whole,
                  m_128=timed(topk_select.GROUP_W))
    print(f"classic truncation: S {n} x {n} plain co-counts ({zero_share:.4f} zeros), K={k}, {n_blocks} blocks of "
          f"{TRUNCATE_BLOCK_ROWS} rows, m={m}: kernel 3 bit-equal to its twin on every block at m={m} and "
          f"m={topk_select.GROUP_W}, the top-K table bit-equal to a stable sort's; certificate failed on {fired} of "
          f"{n_blocks} blocks")
    for r in (result, result["m_128"]):
        print(f"classic truncation: one block ({b} x {n_pad}), m={r['m']}: ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (torch.topk of each 128-column group, "
              f"k={r['m']}) rowwise_library_ms={r['rowwise_library_ms']:.4f} (torch.topk k={k} a row) "
              f"{bound_text(r)}")
    print(f"classic truncation: the whole table: _truncate_topk_rows ms={whole['ms']:.4f}, by the stable sort "
          f"(its plain version) plain_ms={whole['plain_ms']:.4f}, by torch.topk library_ms={whole['library_ms']:.4f}, "
          f"{bound_text(whole)}")
    del s, blocks
    torch.cuda.empty_cache()
    return result


def classic_cv(np, pd, port, dataset, dev, totals: dict) -> dict:
    """``cross_validate`` of Popular, EASE, PureSVD, ItemKNN and ALS over the
    evaluate phase's folds, each fold's metrics equal to the folds by hand.
    EASE takes the exact solver here: the auto solver's fit at this catalog
    took 65 s on an H100 80GB HBM3 at 700 W (the phase times it once beside
    the exact one)."""
    import warnings

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.metrics import calc_metrics
    from rectools_tpu_torch.model_selection import TimeRangeSplitter, cross_validate

    names = ("popular", "ease_exact", "pure_svd", "item_knn_plain", "als")

    def models() -> dict:
        return {**classic_models(dev), "als": als_model(dev)}

    metrics = evaluation_metrics(np, pd)
    splitter = TimeRangeSplitter("1D", n_splits=EVAL_FOLDS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # test users absent from a fold's train part are dropped, with a warning
        t0 = time.perf_counter()
        cv, _ = _count_group_topm(port, lambda: cross_validate(
            dataset, splitter, metrics, {name: models()[name] for name in names}, k=K,
            filter_viewed=True), totals)
        wall_s = time.perf_counter() - t0
        by_hand = []
        t0 = time.perf_counter()
        for train_rows, test_rows, info in splitter.split(dataset.interactions, collect_fold_stats=True):
            train = dataset.filter_interactions(train_rows, keep_external_ids=True)
            test = dataset.interactions.df.loc[test_rows].copy()
            test[Columns.User] = dataset.user_id_map.convert_to_external(test[Columns.User])
            test[Columns.Item] = dataset.item_id_map.convert_to_external(test[Columns.Item])
            history = train.get_raw_interactions()
            for name in names:
                model = models()[name]
                model.fit(train)
                reco = model.recommend(test[Columns.User].unique(), train, k=K, filter_viewed=True,
                                       on_unsupported_targets="warn")
                values = calc_metrics(metrics, reco, test, history, history[Columns.Item].unique())
                by_hand.append({"model": name, "i_split": info["i_split"], **values})
        by_hand_s = time.perf_counter() - t0
    check(len(cv["metrics"]) == len(by_hand) == EVAL_FOLDS * len(names), f"{len(cv['metrics'])} rows scored")
    for row, ref in zip(cv["metrics"], by_hand):
        check(row == ref, f"classic cross_validate {row} differs from the loop by hand {ref}")
        check(all(math.isfinite(row[key]) for key in metrics), f"classic cross_validate: non-finite metric {row}")
    for row in cv["metrics"]:
        print(f"classic evaluate: fold {row['i_split']} {row['model']}: "
              + ", ".join(f"{key} {row[key]:.6g}" for key in metrics))
    print(f"classic evaluate: cross_validate of {', '.join(names)} over {EVAL_FOLDS} folds with {len(metrics)} "
          f"metrics in {wall_s:.2f} s (the loop by hand {by_hand_s:.2f} s); every metric equal to the loop by hand")
    return {"wall_s": wall_s, "by_hand_s": by_hand_s, "metrics": cv["metrics"]}


def classic_phase(torch, np, pd, port, df, dataset, dev) -> dict:
    """The heuristic and linear-algebra models on the KION frame: fit,
    recommend all users (kernel 3 once a serving batch), i2i and a
    whitelist, a CPU copy of the fitted arrays, EASE's two solvers, kernel 3
    at ItemKNN's truncation shape, and cross_validate."""
    users = dataset.user_id_map.external_ids
    seen = set(zip(df["user_id"].to_numpy().tolist(), df["item_id"].to_numpy().tolist()))
    rng = np.random.default_rng(SEED + 16)
    items = dataset.item_id_map.external_ids
    whitelist = np.sort(rng.choice(items, CLASSIC_WHITELIST, replace=False))
    t0 = time.perf_counter()
    by_category = category_dataset(np, pd, df)
    print(f"classic: the frame with a {CLASSIC_CATEGORIES}-value item category built in "
          f"{time.perf_counter() - t0:.2f} s")

    from rectools_tpu_torch.ops.topk_select import FALLBACKS

    totals: dict = {}
    results = {}
    fitted = {}
    for name, model in classic_models(dev).items():
        data = by_category if name == "popular_in_category" else dataset
        rows_per_user = CLASSIC_CATEGORIES if name == "popular_in_category" else 1
        t0 = time.perf_counter()
        FALLBACKS.clear()
        _, fit_launches = _count_group_topm(port, lambda: model.fit(data), totals)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_fallbacks = sum(FALLBACKS.values())
        FALLBACKS.clear()
        t0 = time.perf_counter()
        reco, launches = _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True),
                                           totals)
        first_s = time.perf_counter() - t0
        fallbacks = sum(FALLBACKS.values())  # serving batches sorted again after a failed certificate
        expected = math.ceil(len(users) * rows_per_user / SERVING_B)
        check(launches == expected, f"classic {name}: {launches} group_topm launches in recommend, "
              f"expected {expected} (one a serving batch)")
        _check_u2i(np, reco, users, seen, K, f"classic {name}")
        times = []
        for _ in range(CLASSIC_WARM_CALLS):
            t0 = time.perf_counter()
            _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True), totals)
            times.append(time.perf_counter() - t0)
        warm_s = float(np.median(times))
        targets = items[:CLASSIC_I2I_ITEMS]
        i2i, i2i_launches = _count_group_topm(port, lambda: model.recommend_to_items(targets, data, k=K), totals)
        check(len(i2i) == K * len(targets) and not bool((i2i["target_item_id"] == i2i["item_id"]).any()),
              f"classic {name}: i2i returned {len(i2i)} rows")
        listed, _ = _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True,
                                                                    items_to_recommend=whitelist), totals)
        _check_u2i(np, listed, users, seen, K, f"classic {name} with a whitelist", whitelist)
        sample = users[:CLASSIC_CPU_USERS]
        if name == "random":
            agreement = _random_properties(np, model, data, users, reco)
        else:
            agreement = _cpu_agreement(np, name, model, data, sample)
        print(f"classic {name}: fit {fit_s:.3f} s (kernel 3 launches {fit_launches}, blocks sorted again "
              f"{fit_fallbacks}); recommend {len(users)} users in {expected} batches, launches {launches}, batches "
              f"sorted again {fallbacks}, first {first_s:.3f} s, warm median "
              f"{warm_s:.3f} s of {[round(t, 3) for t in times]}, {len(users) / warm_s:.0f} users/s; i2i "
              f"{len(targets)} items (launches {i2i_launches}); whitelist of {len(whitelist)} items; {agreement}")
        results[name] = {"fit_s": fit_s, "first_s": first_s, "warm_s": warm_s, "warm_samples_s": times,
                         "users_per_s": len(users) / warm_s, "fit_launches": fit_launches,
                         "fit_fallbacks": fit_fallbacks, "recommend_launches": launches,
                         "recommend_fallbacks": fallbacks}
        fitted[name] = model

    auto, exact = fitted["ease"].weight, fitted["ease_exact"].weight
    check(bool(np.allclose(auto, exact, rtol=EASE_SOLVER_RTOL, atol=EASE_SOLVER_ATOL)),
          f"classic ease: auto and exact weights differ by {float(np.abs(auto - exact).max()):.3g}")
    print(f"classic ease solvers: auto (Newton-Schulz above n = 1,024) {results['ease']['fit_s']:.3f} s, exact "
          f"(cuSOLVER Cholesky) {results['ease_exact']['fit_s']:.3f} s for n = {auto.shape[0]}; weights within "
          f"rtol {EASE_SOLVER_RTOL}, atol {EASE_SOLVER_ATOL} (max abs diff {float(np.abs(auto - exact).max()):.3g})")
    print("classic ease profile: one warm recommend of all users")
    profile = profile_phase(torch, lambda: fitted["ease"].recommend(users, dataset, k=K, filter_viewed=True))
    del fitted, auto, exact
    torch.cuda.empty_cache()

    truncation = truncation_kernel_check(torch, np, dataset, dev)
    evaluate = classic_cv(np, pd, port, dataset, dev, totals)
    print(f"classic: kernel 3 launches over the phase's fits, recommends and cross_validate {totals}")
    return {"launches": totals, "models": results, "ease_profile": profile, "truncation": truncation,
            "evaluate": evaluate}


# ---------------------------------------------------------------- phase 14, the factorization models and DSSM


FACTORIZATION_FACTORS = 64  # benchmarks/quality_gate.py:201-204, benchmarks/dssm_head_to_head.py:183
FACTORIZATION_WARM_USERS = 256  # users with features and no interactions: HybridMF and DSSM serve them
FACTORIZATION_COLD_USERS = 64  # ids in no table: HybridMF serves them its item-bias list
USER_FEATURES = (("age", 6), ("income", 6), ("sex", 2), ("kids_flg", 2))  # KION's users table, values a column
ITEM_GENRES = 12  # the item genre is id mod 12; content_type takes 2 values
REFIT_BITS = ("bpr", "hybrid_mf", "dssm")  # a second fit from the seed repeats every bit
FALLING_LOSS = ("hybrid_mf", "dssm")
EPOCHS_FIELD = {"hybrid_mf": "epochs", "dssm": "max_epochs"}


def factorization_dataset(np, pd, df):
    """The frame with seeded synthetic features in KION's shape (users: age,
    income, sex, kids_flg; items: genre = id mod 12, content_type), and
    FACTORIZATION_WARM_USERS users who have features and no interactions."""
    from rectools_tpu_torch.dataset import Dataset

    rng = np.random.default_rng(SEED + 17)
    users = np.arange(N_USERS + FACTORIZATION_WARM_USERS)
    items = np.unique(df["item_id"].to_numpy())
    user_features = pd.concat([pd.DataFrame({"id": users, "feature": name, "value": rng.integers(0, n, len(users))})
                               for name, n in USER_FEATURES])
    item_features = pd.concat([
        pd.DataFrame({"id": items, "feature": "genre", "value": items % ITEM_GENRES}),
        pd.DataFrame({"id": items, "feature": "content_type", "value": rng.integers(0, 2, len(items))}),
    ])
    return Dataset.construct(df, user_features_df=user_features, cat_user_features=[n for n, _ in USER_FEATURES],
                             item_features_df=item_features, cat_item_features=["genre", "content_type"])


def als_model(dev, **kwargs):
    from rectools_tpu_torch.models import ALSModel

    return ALSModel(factors=FACTORIZATION_FACTORS, regularization=0.05, iterations=15, random_state=SEED,
                    device=dev, **kwargs)


def factorization_models(dev) -> dict:
    """name: (model, whether it fits on the frame with features), at the
    quality gate's widths."""
    from rectools_tpu_torch.models import BPRModel, DSSMModel, HybridMFModel

    return {
        "als": (als_model(dev), False),
        "als_features": (als_model(dev, fit_features_together=True), True),
        "bpr": (BPRModel(factors=FACTORIZATION_FACTORS, iterations=60, random_state=SEED, device=dev), False),
        "hybrid_mf": (HybridMFModel(no_components=FACTORIZATION_FACTORS, loss="warp", epochs=20, random_state=SEED,
                                    device=dev), True),
        "dssm": (DSSMModel(n_factors=FACTORIZATION_FACTORS, batch_size=128, lr=0.01, max_epochs=5,
                           random_state=SEED, device=dev), True),
    }


def _fitted_bits(model) -> dict:
    """Every fitted array of ``model`` on the host (DSSM: its towers' weights)."""
    from rectools_tpu_torch.models import DSSMModel
    from rectools_tpu_torch.models.convert import fitted_arrays

    if isinstance(model, DSSMModel):
        return {k: v.cpu().numpy() for k, v in model.towers.state_dict().items()}
    out = {}
    for key, value in fitted_arrays(model).items():
        out.update({f"{key}.{k}": v for k, v in value.items()} if isinstance(value, dict) else {key: value})
    return out


def _cpu_copy(model):
    """The fitted model on the CPU, through models/convert.py."""
    from rectools_tpu_torch.models import DSSMModel, model_from_config
    from rectools_tpu_torch.models.convert import fitted_arrays, jax_dssm_params, load_fitted_arrays, load_jax_dssm_params

    cpu = model_from_config({**model.get_config(), "device": "cpu"})
    if isinstance(model, DSSMModel):
        return load_jax_dssm_params(cpu, jax_dssm_params(model))
    return load_fitted_arrays(cpu, fitted_arrays(model))


def _host_batch_seconds(torch, model, data) -> tuple:
    """(seconds in ``_host_batch``, the epoch's wall) of a one-epoch fit of a
    copy of HybridMF ``model`` under cProfile (which slows both)."""
    import cProfile
    import pstats

    from rectools_tpu_torch.models import model_from_config

    probe = model_from_config({**model.get_config(), "epochs": 1})
    profile = cProfile.Profile()
    t0 = time.perf_counter()
    profile.enable()
    probe.fit(data)
    torch.cuda.synchronize()
    profile.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(profile).stats  # (file, line, function) -> (calls, primitive, own s, cumulative s, callers)
    batch_s = sum(v[3] for k, v in stats.items() if k[2] == "_host_batch")
    return batch_s, wall


def factorization_phase(torch, np, pd, port, df, dataset, dev) -> dict:
    """ALS (plain and with features fitted together), BPR, HybridMF (WARP,
    user and item features) and DSSM on the KION frame at the quality gate's
    widths: fit seconds; recommend all 8,192 users (kernel 3 once a serving
    batch, no other kernel, in the fits neither); i2i and a whitelist; a CPU
    copy on 64 users; save / load_model bit-equal; a refit from the seed
    bit-equal (BPR, HybridMF, DSSM); a falling loss (HybridMF, DSSM); warm
    users (HybridMF, DSSM) and cold ones (HybridMF)."""
    import tempfile

    from rectools_tpu_torch.models import load_model, model_from_config

    t_phase = time.perf_counter()
    users = dataset.user_id_map.external_ids
    seen = set(zip(df["user_id"].to_numpy().tolist(), df["item_id"].to_numpy().tolist()))
    items = dataset.item_id_map.external_ids
    whitelist = np.sort(np.random.default_rng(SEED + 18).choice(items, CLASSIC_WHITELIST, replace=False))
    t0 = time.perf_counter()
    featured = factorization_dataset(np, pd, df)
    warm = featured.user_id_map.external_ids[featured.n_hot_users:]
    cold = np.arange(10**7, 10**7 + FACTORIZATION_COLD_USERS)
    check(len(warm) == FACTORIZATION_WARM_USERS, f"{len(warm)} warm users in the frame with features")
    print(f"factorization: the frame with {len(USER_FEATURES)} user and 2 item features and {len(warm)} warm users "
          f"built in {time.perf_counter() - t0:.2f} s")

    totals: dict = {}
    results = {}
    for name, (model, with_features) in factorization_models(dev).items():
        data = featured if with_features else dataset
        t0 = time.perf_counter()
        _, fit_launches = _count_group_topm(port, lambda: model.fit(data), totals)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        check(fit_launches == 0, f"factorization {name}: the fit launched kernel 3 {fit_launches} times")
        t0 = time.perf_counter()
        reco, launches = _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True),
                                           totals)
        first_s = time.perf_counter() - t0
        expected = math.ceil(len(users) / SERVING_B)
        check(launches == expected, f"factorization {name}: {launches} group_topm launches in recommend, "
              f"expected {expected} (one a serving batch)")
        _check_u2i(np, reco, users, seen, K, f"factorization {name}")
        times = []
        for _ in range(CLASSIC_WARM_CALLS):
            t0 = time.perf_counter()
            _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True), totals)
            times.append(time.perf_counter() - t0)
        warm_s = float(np.median(times))
        targets = items[:CLASSIC_I2I_ITEMS]
        i2i, i2i_launches = _count_group_topm(port, lambda: model.recommend_to_items(targets, data, k=K), totals)
        check(len(i2i) == K * len(targets) and not bool((i2i["target_item_id"] == i2i["item_id"]).any()),
              f"factorization {name}: i2i returned {len(i2i)} rows")
        listed, _ = _count_group_topm(port, lambda: model.recommend(users, data, k=K, filter_viewed=True,
                                                                    items_to_recommend=whitelist), totals)
        _check_u2i(np, listed, users, seen, K, f"factorization {name} with a whitelist", whitelist)
        agreement = _cpu_agreement(np, name, model, data, users[:CLASSIC_CPU_USERS], cpu=_cpu_copy(model),
                                   float_scores=True, phase="factorization")
        with tempfile.TemporaryDirectory(prefix="factorization_") as tmp:
            path = Path(tmp) / f"{name}.pkl"
            t0 = time.perf_counter()
            size = model.save(path)
            reloaded = load_model(path)
            reload_s = time.perf_counter() - t0
        again, _ = _count_group_topm(port, lambda: reloaded.recommend(users, data, k=K, filter_viewed=True), totals)
        check(_same_reco(again, reco), f"factorization {name}: the reloaded model recommends other bits")
        extra = {}
        if name in REFIT_BITS:
            refit = model_from_config(model.get_config())
            t0 = time.perf_counter()
            _count_group_topm(port, lambda: refit.fit(data), totals)
            torch.cuda.synchronize()
            extra["refit_s"] = time.perf_counter() - t0
            bits, ref_bits = _fitted_bits(refit), _fitted_bits(model)
            check(bits.keys() == ref_bits.keys() and all(np.array_equal(bits[k], ref_bits[k]) for k in bits),
                  f"factorization {name}: a second fit from random_state={SEED} gave other bits")
            del refit
        if name in FALLING_LOSS:
            history = model.train_loss_history
            check(all(math.isfinite(v) for v in history) and history[-1] < history[0],
                  f"factorization {name}: the loss did not fall: {history}")
            extra["loss_history"] = history
        targets_text = ""
        if model.recommends_for_warm:
            warm_reco, warm_launches = _count_group_topm(
                port, lambda: model.recommend(warm, data, k=K, filter_viewed=False), totals)
            check(len(warm_reco) == K * len(warm) and set(warm_reco["user_id"]) == set(warm.tolist()),
                  f"factorization {name}: warm users got {len(warm_reco)} rows")
            check(warm_launches == math.ceil(len(warm) / SERVING_B), f"factorization {name}: warm launches "
                  f"{warm_launches}")
            targets_text += f"; {len(warm)} warm users served (launches {warm_launches})"
        if model.recommends_for_cold:
            cold_reco, cold_launches = _count_group_topm(
                port, lambda: model.recommend(cold, data, k=K, filter_viewed=False), totals)
            check(len(cold_reco) == K * len(cold) and cold_launches == 0,
                  f"factorization {name}: cold users got {len(cold_reco)} rows, launches {cold_launches}")
            lists = cold_reco.groupby("user_id")["item_id"].apply(tuple)
            check(lists.nunique() == 1, f"factorization {name}: cold users got different lists")
            targets_text += f"; {len(cold)} cold users served one item-bias list (host, no launch)"
        if name in FALLING_LOSS:  # the SGD fits: where one epoch's time goes
            probe = model_from_config({**model.get_config(), EPOCHS_FIELD[name]: 1})
            print(f"factorization {name} profile: one epoch of the fit")
            extra["epoch_profile"] = profile_phase(torch, lambda: probe.fit(data))
            del probe
        if name == "hybrid_mf":
            batch_s, epoch_s = _host_batch_seconds(torch, model, data)
            extra.update(host_batch_s=batch_s, profiled_epoch_s=epoch_s)
            targets_text += (f"; one epoch under cProfile {epoch_s:.2f} s, of which the host batches "
                             f"{batch_s:.2f} s ({fit_s / model.epochs:.2f} s an epoch without it)")
        print(f"factorization {name}: fit {fit_s:.3f} s; recommend {len(users)} users in {expected} batches, "
              f"launches {launches}, first {first_s:.3f} s, warm median {warm_s:.3f} s of "
              f"{[round(t, 3) for t in times]}, {len(users) / warm_s:.0f} users/s; i2i {len(targets)} items "
              f"(launches {i2i_launches}); whitelist of {len(whitelist)} items; {agreement}; save + load_model "
              f"{size / 2**20:.2f} MiB in {reload_s:.3f} s, bit-equal"
              + (f"; a refit from the seed bit-equal ({extra['refit_s']:.3f} s)" if name in REFIT_BITS else "")
              + (f"; loss {extra['loss_history'][0]:.5f} -> {extra['loss_history'][-1]:.5f}"
                 if name in FALLING_LOSS else "") + targets_text)
        results[name] = {"fit_s": fit_s, "first_s": first_s, "warm_s": warm_s, "warm_samples_s": times,
                         "users_per_s": len(users) / warm_s, "recommend_launches": launches,
                         "save_mib": size / 2**20, "reload_s": reload_s, **extra}
        del model, reloaded
        torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t_phase
    print(f"factorization: kernel 3 launches over the phase {totals}; the phase's wall {wall_s:.1f} s")
    return {"launches": totals, "models": results, "wall_s": wall_s}


# ---------------------------------------------------------------- phase 15, two-stage ranking, ANN, compat, visuals


RANKING_CANDIDATES = 50  # each generator's candidates a user
RANKING_NEGATIVES = 3  # PerUserNegativeSampler's negatives a user
RANKING_STEPS = 300  # full-batch steps of the script's rerankers
RANKING_CPU_USERS = 64
RANKING_SCORE_TOL = 1e-5  # the CPU copy's generator scores: f32 products in another order
ANN_TOP_N, ANN_INDEX_TOP_K = 10, 50  # k = 60 > m = 12: a batch can fail the certificate
ANN_I2I_ITEMS = 4096
ANN_WHITELIST_USERS, ANN_WHITELIST_ITEMS = 256, 2000
ANN_CPU_ROWS = 64
ANN_WARM_CALLS = 3


def _frame_digest(np, X, y) -> str:
    """A hash of a reranker's fit frame: features and labels, in row order."""
    import hashlib

    return hashlib.sha1(X.to_numpy(np.float64).tobytes() + np.asarray(y, np.int64).tobytes()).hexdigest()


def _standardized(torch, x, stats=None):
    mean, std = stats if stats is not None else (x.mean(dim=0), x.std(dim=0).clamp_min(1e-6))
    return (x - mean) / std, (mean, std)


class TorchLogisticRegression:
    """The two-stage phase's reranker (``fit`` / ``predict_proba``, sklearn's
    protocol): logistic regression on standardized features, RANKING_STEPS
    full-batch gradient steps on the card. ``fit_digest`` is a hash of the
    frame it was fitted on, for the phase's check by hand."""

    def __init__(self, device: str = "cuda", steps: int = RANKING_STEPS, lr: float = 0.5) -> None:
        self.device, self.steps, self.lr = device, steps, lr

    def _features(self, x):
        import numpy as np
        import torch

        return torch.as_tensor(np.ascontiguousarray(x.to_numpy(np.float32)), device=self.device)

    def fit(self, X, y):
        import numpy as np
        import torch

        self.columns = list(X.columns)
        self.fit_digest = _frame_digest(np, X, y)
        z, self.stats = _standardized(torch, self._features(X))
        target = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        self.w = torch.zeros(z.shape[1], device=self.device)
        self.b = torch.zeros((), device=self.device)
        for _ in range(self.steps):
            residual = torch.sigmoid(z @ self.w + self.b) - target
            self.w -= self.lr * (z.T @ residual) / len(target)
            self.b -= self.lr * residual.mean()
        self.loss = float(torch.nn.functional.binary_cross_entropy_with_logits(z @ self.w + self.b, target))
        return self

    def predict_proba(self, X):
        import numpy as np
        import torch

        z, _ = _standardized(torch, self._features(X[self.columns]), self.stats)
        p = torch.sigmoid(z @ self.w + self.b).cpu().numpy().astype(np.float64)
        return np.stack([1.0 - p, p], axis=1)


class SmokePool:
    """The phase's stand-in for ``catboost.Pool`` (catboost is not on the
    card's machine): the frame, labels and group ids as given."""

    def __init__(self, data, label=None, group_id=None, **kwargs) -> None:
        self.data, self.label, self.group_id, self.extra = data, label, group_id, kwargs


class TorchListwiseRanker:
    """A CatBoostRanker-shaped trainer (``fit(X=pool)`` / ``predict``): a
    linear scorer trained on the card with a softmax over each group's rows
    (one group a user) against its positives, RANKING_STEPS Adam steps."""

    def __init__(self, device: str = "cuda", steps: int = RANKING_STEPS, lr: float = 0.05) -> None:
        self.device, self.steps, self.lr = device, steps, lr

    def fit(self, X):
        import numpy as np
        import torch

        group_id = np.asarray(X.group_id)
        check(len(group_id) == len(X.data) and bool((np.diff(group_id) >= 0).all()),
              "ranking: the ranker's pool is not sorted by user")
        self.columns = list(X.data.columns)
        groups = torch.as_tensor(np.unique(group_id, return_inverse=True)[1], device=self.device)
        self.n_groups = int(groups.max()) + 1
        z, self.stats = _standardized(torch, torch.as_tensor(X.data.to_numpy(np.float32), device=self.device))
        positive = torch.as_tensor(np.asarray(X.label) > 0, device=self.device)
        self.w = torch.zeros(z.shape[1], device=self.device, requires_grad=True)
        optimizer = torch.optim.Adam([self.w], lr=self.lr)
        for _ in range(self.steps):
            s = z @ self.w
            shift = s.max().detach()
            denom = torch.zeros(self.n_groups, device=self.device).index_add(0, groups, torch.exp(s - shift))
            loss = -(s - shift - torch.log(denom)[groups])[positive].mean()
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        self.w = self.w.detach()
        self.loss = float(loss.detach())
        return self

    def predict(self, X):
        import numpy as np
        import torch

        z, _ = _standardized(torch, torch.as_tensor(X[self.columns].to_numpy(np.float32), device=self.device),
                             self.stats)
        return (z @ self.w).cpu().numpy().astype(np.float64)


def ranking_generators(dev) -> list:
    """PopularModel and ALSModel at the quality gate's width, 50 candidates
    each, ranks and scores kept, with fill values."""
    from rectools_tpu_torch.models import PopularModel
    from rectools_tpu_torch.models.ranking import CandidateGenerator

    fill = dict(keep_ranks=True, keep_scores=True, scores_fillna_value=0.0,
                ranks_fillna_value=RANKING_CANDIDATES + 1)
    return [CandidateGenerator(PopularModel(device=dev), RANKING_CANDIDATES, **fill),
            CandidateGenerator(als_model(dev), RANKING_CANDIDATES, **fill)]


def ranking_model(dev, reranker):
    from rectools_tpu_torch.model_selection import TimeRangeSplitter
    from rectools_tpu_torch.models.ranking import CandidateRankingModel, PerUserNegativeSampler

    return CandidateRankingModel(ranking_generators(dev), splitter=TimeRangeSplitter("7D", n_splits=1),
                                 reranker=reranker,
                                 sampler=PerUserNegativeSampler(n_negatives=RANKING_NEGATIVES, random_state=SEED))


def _pool_by_hand(pd, model, users, data, filter_viewed: bool):
    """Each generator's recommend, renamed, outer-joined on (user, item) in
    generator order, the fill values applied: the pooled candidates by hand."""
    pooled, fill = None, {}
    for name, generator in model.cand_gen_dict.items():
        part = generator.model.recommend(users, data, k=RANKING_CANDIDATES, filter_viewed=filter_viewed)
        part = part.rename(columns={"rank": f"{name}_rank", "score": f"{name}_score"})
        fill.update({f"{name}_rank": generator.ranks_fillna_value, f"{name}_score": generator.scores_fillna_value})
        pooled = part if pooled is None else pooled.merge(part, how="outer", on=["user_id", "item_id"])
    return pooled.fillna(fill)


def _two_stage_by_hand(np, pd, model, train_users, history, targets) -> dict:
    """The pipeline's stages by hand on its fitted generators: before serving
    (generators in their train-stage fit) the pooled candidates, labels and
    sampled frame. Returns their sizes and the sampled frame."""
    pooled = _pool_by_hand(pd, model, train_users, history, filter_viewed=True)
    got = model._pool_first_stage_candidates(train_users, history, filter_viewed=True, for_train=True)
    check(got.reset_index(drop=True).equals(pooled.reset_index(drop=True)),
          "ranking: the pooled train candidates differ from the pool by hand")
    pairs = set(zip(targets["user_id"].tolist(), targets["item_id"].tolist()))
    labels = np.array([p in pairs for p in zip(pooled["user_id"].tolist(), pooled["item_id"].tolist())], np.int32)
    labeled = model._label_candidates(got, targets)
    check(np.array_equal(labeled["target"].to_numpy(), labels), "ranking: labels differ from membership by hand")
    negatives = labeled[labels == 0].sample(frac=1.0, random_state=SEED)
    kept = negatives.groupby("user_id", sort=False).head(RANKING_NEGATIVES)
    sampled = pd.concat([labeled[labels == 1], kept], ignore_index=True).sample(frac=1.0, random_state=SEED)
    check(model.sampler.sample_negatives(labeled).equals(sampled), "ranking: the sampled frame differs from by hand")
    per_user = sampled[sampled["target"] == 0].groupby("user_id").size()
    check(int(per_user.max()) <= RANKING_NEGATIVES, f"ranking: {int(per_user.max())} negatives for a user")
    return {"pooled": len(pooled), "positives": int(labels.sum()), "sampled": sampled}


def _serve_by_hand(np, pd, model, dataset, users, reco) -> None:
    """Serving by hand on the serving-stage generators: pool, score with the
    fitted reranker, sort each user's rows by score (stable), keep k; equal
    to ``reco`` bit for bit."""
    pooled = _pool_by_hand(pd, model, users, dataset, filter_viewed=True)
    scored = pooled[["user_id", "item_id"]].copy()
    scored["score"] = model.reranker.predict_scores(pooled)
    order = np.lexsort((-scored["score"].to_numpy(), scored["user_id"].to_numpy()))
    ranked = scored.iloc[order].reset_index(drop=True)
    ranked = ranked[ranked.groupby("user_id", sort=False).cumcount() < K].reset_index(drop=True)
    ranked["rank"] = ranked.groupby("user_id", sort=False).cumcount() + 1
    check(_same_reco(reco, ranked), "ranking: the recommendations differ from scoring and sorting by hand")


def _two_stage_cpu_copy(np, model, dataset, users) -> str:
    """The fitted generators copied to the CPU (models/convert.py): the same
    pooled users, items and ranks on ``users``, scores within
    RANKING_SCORE_TOL. Where ALS's CPU list differs it may differ only inside
    ties of TIE_GAP (``compare_reco`` on its lists), and the user is left out
    of the pooled comparison and counted."""
    import copy

    from rectools_tpu_torch.models.ranking import CandidateGenerator

    cpu = copy.copy(model)
    cpu.cand_gen_dict = {}
    for name, generator in model.cand_gen_dict.items():
        copy = CandidateGenerator(_cpu_copy(generator.model), generator.num_candidates, generator.keep_ranks,
                                  generator.keep_scores, generator.scores_fillna_value, generator.ranks_fillna_value)
        copy.is_fitted_for_recommend = True
        cpu.cand_gen_dict[name] = copy
    als_name = [name for name in model.cand_gen_dict if name.startswith("ALSModel")][0]
    got_als = model.cand_gen_dict[als_name].model.recommend(users, dataset, k=RANKING_CANDIDATES, filter_viewed=True)
    ref_als = cpu.cand_gen_dict[als_name].model.recommend(users, dataset, k=RANKING_CANDIDATES + 1,
                                                          filter_viewed=True)
    ref_k = ref_als.groupby("user_id", sort=False).head(RANKING_CANDIDATES)
    differ = got_als.loc[got_als["item_id"].to_numpy() != ref_k["item_id"].to_numpy(), "user_id"].unique()
    for user in differ:
        compare_reco(np, got_als[got_als["user_id"] == user], ref_als[ref_als["user_id"] == user],
                     RANKING_CANDIDATES)
    same = np.setdiff1d(users, differ)
    got = model._pool_first_stage_candidates(same, dataset, filter_viewed=True, for_train=False)
    ref = cpu._pool_first_stage_candidates(same, dataset, filter_viewed=True, for_train=False)
    check(list(got.columns) == list(ref.columns) and len(got) == len(ref), "ranking: the CPU copy pooled other rows")
    for col in got.columns:
        if col.endswith("_score"):
            check(bool(np.allclose(got[col], ref[col], rtol=RANKING_SCORE_TOL, atol=RANKING_SCORE_TOL)),
                  f"ranking: the CPU copy's {col} differs by {float(np.abs(got[col] - ref[col]).max()):.3g}")
        else:
            check(np.array_equal(got[col].to_numpy(), ref[col].to_numpy()), f"ranking: the CPU copy's {col} differs")
    return (f"{len(same)} of {len(users)} users pool the same items and ranks as the CPU copy (scores within "
            f"{RANKING_SCORE_TOL}); {len(differ)} differ in ALS's list only inside ties of TIE_GAP {TIE_GAP}")


def _fallbacks(since=None) -> dict:
    """``topk_select.FALLBACKS`` now, or what it gained since ``since``."""
    from rectools_tpu_torch.ops.topk_select import FALLBACKS

    return dict(FALLBACKS) if since is None else {k: v - since.get(k, 0) for k, v in FALLBACKS.items()
                                                  if v != since.get(k, 0)}


def two_stage_phase(torch, np, pd, port, df, dataset, dev, totals: dict) -> dict:
    """CandidateRankingModel over PopularModel and ALSModel (50 candidates
    each) with TimeRangeSplitter("7D", n_splits=1), 3 negatives a user and
    the script's logistic regression: fit (kernel 3 once a 4,096-user batch
    of each generator's train candidates), the stages by hand, recommend all
    users (the same for the serving candidates), serving by hand, a CPU copy
    on 64 users, save / load_model bit-equal; then CatBoostReranker over the
    script's pool and listwise ranker, fitted and served the same way."""
    import tempfile

    from rectools_tpu_torch.models import load_model
    from rectools_tpu_torch.models.ranking import CatBoostReranker, Reranker

    users = dataset.user_id_map.external_ids
    seen = set(zip(df["user_id"].to_numpy().tolist(), df["item_id"].to_numpy().tolist()))
    model = ranking_model(dev, Reranker(TorchLogisticRegression(device=dev)))
    history, targets, _ = model.split_to_history_dataset_and_train_targets(dataset, model.splitter)
    train_users = targets["user_id"].unique()
    n_gen = len(model.cand_gen_dict)
    fit_expected = n_gen * math.ceil(len(train_users) / SERVING_B)
    serve_expected = n_gen * math.ceil(len(users) / SERVING_B)
    fallbacks = _fallbacks()

    t0 = time.perf_counter()
    _, fit_launches = _count_group_topm(port, lambda: model.fit(dataset, refit_candidate_generators=False), totals)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(fit_launches == fit_expected, f"ranking: the fit launched kernel 3 {fit_launches} times, expected "
          f"{fit_expected} ({n_gen} generators, {len(train_users)} target users)")
    stages = _two_stage_by_hand(np, pd, model, train_users, history, targets)
    sampled = stages.pop("sampled")
    features = sampled.drop(columns=["user_id", "item_id", "target"])
    check(_frame_digest(np, features, sampled["target"]) == model.reranker.model.fit_digest,
          "ranking: the reranker was fitted on another frame than the sampled frame by hand")

    t0 = time.perf_counter()
    reco, serve_launches = _count_group_topm(
        port, lambda: model.recommend(users, dataset, k=K, filter_viewed=True), totals)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(serve_launches == serve_expected, f"ranking: recommend launched kernel 3 {serve_launches} times, "
          f"expected {serve_expected}")
    _check_u2i(np, reco, users, seen, K, "ranking two-stage")
    times = []
    for _ in range(CLASSIC_WARM_CALLS):
        t0 = time.perf_counter()
        again, _ = _count_group_topm(port, lambda: model.recommend(users, dataset, k=K, filter_viewed=True), totals)
        times.append(time.perf_counter() - t0)
        check(_same_reco(again, reco), "ranking: a second recommend gave other bits")
    warm_s = float(np.median(times))
    _serve_by_hand(np, pd, model, dataset, users, reco)
    agreement = _two_stage_cpu_copy(np, model, dataset, users[:RANKING_CPU_USERS])
    with tempfile.TemporaryDirectory(prefix="ranking_") as tmp:
        path = Path(tmp) / "two_stage.pkl"
        t0 = time.perf_counter()
        size = model.save(path)
        reloaded = load_model(path)
        reload_s = time.perf_counter() - t0
    again, _ = _count_group_topm(port, lambda: reloaded.recommend(users, dataset, k=K, filter_viewed=True), totals)
    check(_same_reco(again, reco), "ranking: the reloaded two-stage model recommends other bits")
    print(f"ranking two-stage: {len(train_users)} target users, {stages['pooled']} pooled train candidates "
          f"({stages['positives']} positive), {len(sampled)} sampled, reranker loss "
          f"{model.reranker.model.loss:.5f}; "
          f"fit {fit_s:.3f} s (kernel 3 launches {fit_launches}); recommend {len(users)} users, launches "
          f"{serve_launches}, first {first_s:.3f} s (generators refitted on the whole frame), warm median "
          f"{warm_s:.3f} s of {[round(t, 3) for t in times]}, {len(users) / warm_s:.0f} users/s; pooled "
          f"candidates, labels, sampled frame, fit frame and final top-k equal to the pipeline by hand; "
          f"{agreement}; save + load_model {size / 2**20:.2f} MiB in {reload_s:.3f} s, bit-equal")

    ranker_model = ranking_model(dev, CatBoostReranker(TorchListwiseRanker(device=dev), pool_factory=SmokePool))
    t0 = time.perf_counter()
    _, cb_fit_launches = _count_group_topm(port, lambda: ranker_model.fit(dataset), totals)
    torch.cuda.synchronize()
    cb_fit_s = time.perf_counter() - t0
    cb_reco, cb_launches = _count_group_topm(
        port, lambda: ranker_model.recommend(users, dataset, k=K, filter_viewed=True), totals)
    check(cb_fit_launches == fit_expected, f"ranking catboost: the fit launched kernel 3 {cb_fit_launches} times, "
          f"expected {fit_expected}")
    check(cb_launches == serve_expected, f"ranking catboost: recommend launched kernel 3 {cb_launches} times")
    _check_u2i(np, cb_reco, users, seen, K, "ranking catboost")
    ranker = ranker_model.reranker.model
    check(ranker.n_groups == sampled["user_id"].nunique(),
          f"ranking catboost: {ranker.n_groups} groups in the pool, "
          f"{sampled['user_id'].nunique()} users in the sampled frame")
    print(f"ranking catboost: CatBoostReranker over the script's pool and listwise ranker: fit {cb_fit_s:.3f} s "
          f"(kernel 3 launches {cb_fit_launches}, generators refitted for serving), {ranker.n_groups} user groups, "
          f"loss {ranker.loss:.5f}; recommend {len(users)} users, launches {cb_launches}")
    return {"model": model, "reco": reco, "fit_s": fit_s, "first_s": first_s, "warm_s": warm_s,
            "warm_samples_s": times,
            "users_per_s": len(users) / warm_s, "fit_launches": fit_launches, "recommend_launches": serve_launches,
            "fallbacks": _fallbacks(fallbacks), "train_users": len(train_users), **stages,
            "save_mib": size / 2**20, "reload_s": reload_s, "catboost_fit_s": cb_fit_s}


def _brute_force(torch, np, queries, objects, cosine: bool, k: int) -> tuple:
    """The CPU brute force: f32 scores by torch.matmul on the CPU against the
    objects (COSINE: L2-normalised, zero rows kept), a stable descending
    sort. Returns (the top k internal ids (B, k), the scores (B, N))."""
    q, o = torch.as_tensor(np.asarray(queries, np.float32)), torch.as_tensor(np.asarray(objects, np.float32))
    if cosine:
        norms = torch.linalg.vector_norm(o, dim=1, keepdim=True)
        o = o / torch.where(norms == 0, torch.ones_like(norms), norms)
    scores = q @ o.T
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k].numpy(), scores.numpy()


def _ann_agreement(np, got_lists, expected, scores, item_id_map, what: str) -> int:
    """The card's lists (external ids) against the brute force's (internal
    ids): equal, or, where they differ, the same length with brute-force
    scores equal position by position within TIE_GAP (items swapped inside
    a tie). Returns the lists that are identical."""
    identical = 0
    for row, (got, ref) in enumerate(zip(got_lists, expected)):
        got_internal = item_id_map.convert_to_internal(got)
        if np.array_equal(got_internal, ref):
            identical += 1
            continue
        check(len(got_internal) == len(ref) and bool(np.allclose(scores[row, got_internal], scores[row, ref], rtol=0,
                                                                 atol=TIE_GAP)),
              f"{what}: row {row} differs from the CPU brute force: {got_internal} vs {ref}")
    return identical


def _suspect_batches(engine, vectors, k: int) -> int:
    """The batches of a ``query_batch`` whose certificate fails, by hand:
    each batch's flag from its own dispatch."""
    return sum(int(bool(engine.query_batch_async(vectors[start : start + engine.batch_size], k)[3]))
               for start in range(0, len(vectors), engine.batch_size))


def _warm_median(np, fn) -> tuple:
    times = []
    for _ in range(ANN_WARM_CALLS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def ann_phase(torch, np, port, dataset, dev, als, totals: dict) -> dict:
    """The ANN recommenders over the two-stage phase's fitted ALS factors:
    UserToItemAnnRecommender under COSINE and DOT for all users (top 10,
    index_top_k 50) and for 256 users with whitelists, ItemToItemAnnRecommender
    for 4,096 items; kernel 3 once a 4,096-row batch a query, the certificate's
    fallbacks equal to the batches that fail it by hand; 64 rows against the
    CPU brute force; approximate=True equal to exact; a pickle round trip
    bit-equal; users/s and items/s, warm median of 3."""
    import pickle

    from rectools_tpu_torch.models import Distance
    from rectools_tpu_torch.models.convert import fitted_arrays
    from rectools_tpu_torch.tools import ItemToItemAnnRecommender, UserToItemAnnRecommender

    arrays = fitted_arrays(als)
    user_vectors, item_vectors = arrays["user_factors"], arrays["item_factors"]
    users, items = dataset.user_id_map.external_ids, dataset.item_id_map.external_ids
    k = ANN_TOP_N + ANN_INDEX_TOP_K
    rng = np.random.default_rng(SEED + 19)
    out: dict = {}
    for distance in (Distance.COSINE, Distance.DOT):
        name = distance.name.lower()
        kwargs = dict(index_top_k=ANN_INDEX_TOP_K, distance=distance, device=dev)
        rec = UserToItemAnnRecommender(user_vectors, item_vectors, dataset.user_id_map, dataset.item_id_map,
                                       **kwargs).fit()
        before = _fallbacks()
        lists, launches = _count_group_topm(port, lambda: rec.get_item_list_for_user_batch(users, ANN_TOP_N), totals)
        fell = _fallbacks(before).get("query_batch", 0)
        check(launches == math.ceil(len(users) / SERVING_B), f"ann u2i {name}: {launches} kernel 3 launches")
        check(all(len(lst) == ANN_TOP_N for lst in lists), f"ann u2i {name}: a user got fewer than {ANN_TOP_N}")
        internal = dataset.user_id_map.convert_to_internal(users)
        suspect = _suspect_batches(rec._engine, user_vectors[internal], k)
        check(fell == suspect, f"ann u2i {name}: {fell} batches counted as sorted again, {suspect} fail by hand")
        warm_s, times = _warm_median(np, lambda: rec.get_item_list_for_user_batch(users, ANN_TOP_N))

        rows = internal[:ANN_CPU_ROWS]
        top, scores = _brute_force(torch, np, user_vectors[rows], item_vectors, distance == Distance.COSINE, k)
        identical = _ann_agreement(np, lists[:ANN_CPU_ROWS], top[:, :ANN_TOP_N], scores, dataset.item_id_map,
                                   f"ann u2i {name}")

        listed_users = users[:ANN_WHITELIST_USERS]
        whitelists = [rng.choice(items, ANN_WHITELIST_ITEMS, replace=False) for _ in listed_users]
        listed, listed_launches = _count_group_topm(
            port, lambda: rec.get_item_list_for_user_batch(listed_users, ANN_TOP_N, item_ids=whitelists), totals)
        check(listed_launches == 1, f"ann u2i {name}: {listed_launches} launches for {len(listed_users)} users")
        check(all(set(lst) <= set(wl.tolist()) for lst, wl in zip(listed, whitelists)),
              f"ann u2i {name}: an item outside a user's whitelist")
        expected = []
        for row, wl in zip(top[:, :k], whitelists[:ANN_CPU_ROWS]):
            allowed = set(dataset.item_id_map.convert_to_internal(wl).tolist())
            expected.append(np.array([i for i in row if i in allowed][:ANN_TOP_N], dtype=np.int64))
        listed_identical = _ann_agreement(np, listed[:ANN_CPU_ROWS], expected, scores, dataset.item_id_map,
                                          f"ann u2i {name} with whitelists")

        approx = UserToItemAnnRecommender(user_vectors, item_vectors, dataset.user_id_map, dataset.item_id_map,
                                          approximate=True, recall_target=0.5, **kwargs).fit()
        approx_lists, _ = _count_group_topm(port, lambda: approx.get_item_list_for_user_batch(users, ANN_TOP_N),
                                            totals)
        check(all(np.array_equal(a, b) for a, b in zip(approx_lists, lists)),
              f"ann u2i {name}: approximate=True gave other lists than exact")
        restored = pickle.loads(pickle.dumps(rec))
        check(restored._engine is None, f"ann u2i {name}: the pickle carried the device table")
        again, _ = _count_group_topm(port, lambda: restored.get_item_list_for_user_batch(users, ANN_TOP_N), totals)
        check(all(np.array_equal(a, b) for a, b in zip(again, lists)),
              f"ann u2i {name}: the pickle gave other lists")
        print(f"ann u2i {name}: {len(users)} users, top {ANN_TOP_N}, index_top_k {ANN_INDEX_TOP_K} (k = {k}): "
              f"kernel 3 launches {launches}, batches sorted again {fell} (by hand {suspect}); warm median "
              f"{warm_s:.3f} s of {[round(t, 3) for t in times]}, {len(users) / warm_s:.0f} users/s; "
              f"{identical} of {len(rows)} lists identical to the CPU brute force, the rest inside ties of TIE_GAP; "
              f"{len(listed_users)} users with whitelists of {ANN_WHITELIST_ITEMS} items ({listed_identical} of "
              f"{len(rows)} identical to the brute force); approximate=True equal to exact; pickle round trip "
              f"bit-equal")
        out[f"u2i_{name}"] = {"launches": launches, "fallbacks": fell, "warm_s": warm_s, "warm_samples_s": times,
                              "users_per_s": len(users) / warm_s, "cpu_identical": identical,
                              "whitelist_cpu_identical": listed_identical}

    rec = ItemToItemAnnRecommender(item_vectors, dataset.item_id_map, index_top_k=ANN_INDEX_TOP_K, device=dev).fit()
    targets = items[:ANN_I2I_ITEMS]
    before = _fallbacks()
    i2i, launches = _count_group_topm(port, lambda: rec.get_item_list_for_item_batch(targets, ANN_TOP_N), totals)
    fell = _fallbacks(before).get("query_batch", 0)
    check(launches == math.ceil(len(targets) / SERVING_B), f"ann i2i: {launches} kernel 3 launches")
    check(all(len(lst) == ANN_TOP_N and target not in set(lst.tolist()) for target, lst in zip(targets, i2i)),
          f"ann i2i: a list is short or holds its own item")
    internal = dataset.item_id_map.convert_to_internal(targets)
    suspect = _suspect_batches(rec._engine, item_vectors[internal], k + 1)
    check(fell == suspect, f"ann i2i: {fell} batches counted as sorted again, {suspect} fail by hand")
    warm_s, times = _warm_median(np, lambda: rec.get_item_list_for_item_batch(targets, ANN_TOP_N))
    rows = internal[:ANN_CPU_ROWS]
    top, scores = _brute_force(torch, np, item_vectors[rows], item_vectors, True, k + 1)
    expected = [np.array([i for i in row if i != self_id][:ANN_TOP_N]) for row, self_id in zip(top, rows)]
    identical = _ann_agreement(np, i2i[:ANN_CPU_ROWS], expected, scores, dataset.item_id_map, "ann i2i")
    restored = pickle.loads(pickle.dumps(rec))
    again, _ = _count_group_topm(port, lambda: restored.get_item_list_for_item_batch(targets, ANN_TOP_N), totals)
    check(all(np.array_equal(a, b) for a, b in zip(again, i2i)), "ann i2i: the pickle gave other lists")
    print(f"ann i2i cosine: {len(targets)} items, self excluded: kernel 3 launches {launches}, batches sorted again "
          f"{fell} (by hand {suspect}); warm median {warm_s:.3f} s of {[round(t, 3) for t in times]}, "
          f"{len(targets) / warm_s:.0f} items/s; {identical} of {len(rows)} lists identical to the CPU brute force, "
          f"the rest inside ties of TIE_GAP; pickle round trip bit-equal")
    out["i2i_cosine"] = {"launches": launches, "fallbacks": fell, "warm_s": warm_s, "warm_samples_s": times,
                         "items_per_s": len(targets) / warm_s, "cpu_identical": identical}
    return {**out, "i2i_lists": i2i, "i2i_targets": targets}


def compat_phase(np, port, dataset, dev, totals: dict) -> dict:
    """``translate_reference_config`` of a reference ImplicitALSWrapperModel
    config (nested ``model`` dict with host knobs): the dropped keys warned
    about, the translated model fitted and recommending all users bit-equal
    to ALSModel built directly with the same fields, kernel 3 once a batch."""
    import warnings

    from rectools_tpu_torch.compat import translate_reference_config
    from rectools_tpu_torch.models import model_from_config

    users = dataset.user_id_map.external_ids
    reference = {"cls": "rectools.models.implicit_als.ImplicitALSWrapperModel",
                 "model": {"factors": FACTORIZATION_FACTORS, "regularization": 0.05, "iterations": 15,
                           "use_gpu": True, "num_threads": 8, "random_state": SEED}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        config = translate_reference_config(reference)
    messages = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    check(len(messages) == 1 and "['num_threads', 'use_gpu']" in messages[0] and "ALSModel" in messages[0],
          f"compat: the dropped keys were not warned about: {messages}")
    check(config == {"cls": "ALSModel", "factors": FACTORIZATION_FACTORS, "regularization": 0.05, "iterations": 15,
                     "random_state": SEED}, f"compat: translated to {config}")
    translated = model_from_config(config if dev == "cuda" else {**config, "device": dev})
    check(translated.device == dev, f"compat: the translated model is on {translated.device}")
    t0 = time.perf_counter()
    translated.fit(dataset)
    fit_s = time.perf_counter() - t0
    reco, launches = _count_group_topm(port, lambda: translated.recommend(users, dataset, k=K, filter_viewed=True),
                                       totals)
    check(launches == math.ceil(len(users) / SERVING_B), f"compat: {launches} kernel 3 launches")
    direct = als_model(dev).fit(dataset)
    ref, _ = _count_group_topm(port, lambda: direct.recommend(users, dataset, k=K, filter_viewed=True), totals)
    check(_same_reco(reco, ref), "compat: the translated ALS recommends other bits than ALSModel built directly")
    print(f"compat: warned \"{messages[0]}\"; translated to {config}; fit {fit_s:.3f} s; recommend "
          f"{len(users)} users "
          f"(kernel 3 launches {launches}) bit-equal to ALSModel built directly")
    return {"config": config, "warning": messages[0], "fit_s": fit_s, "launches": launches, "reco": reco}


def visuals_phase(np, pd, df, dataset, reco: dict, i2i_targets, i2i_lists, metrics_rows: list) -> dict:
    """The visual apps' data half (``display`` is not called: plotly and the
    widgets are not on the card's machine): VisualApp over the two-stage and
    ALS recommendations, ItemToItemVisualApp over the ANN's i2i lists,
    MetricsApp over the evaluate and classic phases' cross_validate rows,
    each with a CSV round trip in a temporary directory."""
    import tempfile

    from rectools_tpu_torch.visuals import ItemToItemVisualApp, MetricsApp, VisualApp

    t0 = time.perf_counter()
    items = dataset.item_id_map.external_ids
    item_data = pd.DataFrame({"item_id": items, "genre": items % ITEM_GENRES})
    heaviest = int(df["user_id"].value_counts().index[0])
    selected = {"first": int(dataset.user_id_map.external_ids[0]), "heaviest": heaviest}
    app = VisualApp.construct(reco, df, item_data, selected_users=selected, n_random_users=2, auto_display=False)
    storage = app.data_storage
    check(storage.request_names[:2] == ["first", "heaviest"] and len(storage.request_names) == 4,
          f"visuals: requests {storage.request_names}")
    for model_name, per_request in storage.grouped_reco.items():
        for request, frame in per_request.items():
            rows = reco[model_name][reco[model_name]["user_id"] == storage.selected_requests[request]]
            check(frame["item_id"].tolist() == rows["item_id"].tolist() and "genre" in frame.columns,
                  f"visuals: {model_name} / {request} shows other items")
    check(len(storage.grouped_interactions["heaviest"]) == int((df["user_id"] == heaviest).sum()),
          "visuals: the heaviest user's interactions are incomplete")
    i2i = pd.DataFrame({"target_item_id": np.repeat(i2i_targets, [len(x) for x in i2i_lists]),
                        "item_id": np.concatenate(i2i_lists), "model": "ann_cosine"})
    i2i_app = ItemToItemVisualApp.construct(i2i, item_data, selected_items={"first": int(i2i_targets[0])},
                                            n_random_items=2, auto_display=False)
    check(len(i2i_app.data_storage.request_names) == 3, "visuals: i2i requests")
    metrics = pd.DataFrame(metrics_rows)
    meta = pd.DataFrame({"model": metrics["model"].unique()})
    meta["family"] = np.where(meta["model"] == "sasrec", "transformer", "classic")
    metrics_app = MetricsApp.construct(metrics, models_metadata=meta, auto_display=False)
    chart = metrics_app.chart_data()
    check(len(chart) == metrics["model"].nunique() and metrics_app.fold_ids == sorted(metrics["i_split"].unique()),
          f"visuals: metrics chart of {len(chart)} rows")
    check(bool(np.allclose(chart.set_index("model")[f"recall@{K}"],
                           metrics.groupby("model")[f"recall@{K}"].mean())), "visuals: averaged recall differs")
    with tempfile.TemporaryDirectory(prefix="visuals_") as tmp:
        for what, viewer, cls in (("u2i", app, VisualApp), ("i2i", i2i_app, ItemToItemVisualApp)):
            viewer.save(f"{tmp}/{what}")
            loaded = cls.load(f"{tmp}/{what}", auto_display=False).data_storage
            saved = viewer.data_storage
            check(loaded.selected_requests == saved.selected_requests and loaded.id_col == saved.id_col,
                  f"visuals: {what} requests after the round trip")
            for model_name, per_request in saved.grouped_reco.items():
                for request, frame in per_request.items():
                    pd.testing.assert_frame_equal(frame, loaded.grouped_reco[model_name][request][frame.columns],
                                                  check_dtype=False)
            for request, frame in saved.grouped_interactions.items():
                check(frame["item_id"].tolist() == loaded.grouped_interactions[request]["item_id"].tolist(),
                      f"visuals: {what} interactions of {request} after the round trip")
        metrics.to_csv(f"{tmp}/metrics.csv", index=False)
        again = MetricsApp.construct(pd.read_csv(f"{tmp}/metrics.csv"), models_metadata=meta, auto_display=False)
        pd.testing.assert_frame_equal(again.chart_data(), chart)
    wall_s = time.perf_counter() - t0
    print(f"visuals: VisualApp over {sorted(reco)} ({len(storage.request_names)} users, 2 drawn), "
          f"ItemToItemVisualApp over the ANN's i2i lists, MetricsApp over {metrics['model'].nunique()} models x "
          f"{len(metrics_app.fold_ids)} folds, each through a CSV round trip, in {wall_s:.2f} s")
    return {"wall_s": wall_s, "requests": storage.request_names, "metrics_models": int(metrics["model"].nunique())}


def ranking_phase(torch, np, pd, port, df, dataset, dev, metrics_rows: list) -> dict:
    """Phase 15: the two-stage model, the ANN recommenders over its ALS
    factors, the reference-config migration and the visual apps, with kernel
    3's launches counted over the phase."""
    t_phase = time.perf_counter()
    totals: dict = {}
    fallbacks = _fallbacks()
    two_stage = two_stage_phase(torch, np, pd, port, df, dataset, dev, totals)
    model, reco = two_stage.pop("model"), two_stage.pop("reco")
    als = [g.model for name, g in model.cand_gen_dict.items() if name.startswith("ALSModel")][0]
    ann = ann_phase(torch, np, port, dataset, dev, als, totals)
    i2i_targets, i2i_lists = ann.pop("i2i_targets"), ann.pop("i2i_lists")
    compat = compat_phase(np, port, dataset, dev, totals)
    visuals = visuals_phase(np, pd, df, dataset, {"two_stage": reco, "als": compat.pop("reco")}, i2i_targets,
                            i2i_lists, metrics_rows)
    del model
    torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t_phase
    fell = _fallbacks(fallbacks)
    print(f"ranking: kernel 3 launches over the phase {totals}; batches sorted again {fell}; the phase's wall "
          f"{wall_s:.1f} s")
    return {"launches": totals, "fallbacks": fell, "two_stage": two_stage, "ann": ann, "compat": compat,
            "visuals": visuals, "wall_s": wall_s}


# ---------------------------------------------------------------- phase 9, the other doors of the streaming lse


def ops_phase(torch, dev, b: int = TRAIN_B) -> dict:
    """The public ops whose kernels no model path runs, as a user calls them at
    the training width (51,200 x 15,872 x 128): ``streaming_lse(...,
    bounded_shift=True)`` with its backward (kernel 16, then kernel 9) and
    ``softmax_grads_from_z`` (kernel 12, its partials within the budget), in
    f32 and on the same towers in bf16 (kernel 12's bf16 form)."""
    import rectools_tpu_torch.ops as port
    from rectools_tpu_torch.ops import softmax_lse

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    m, n, d = b * SESSION_MAX_LEN, N_ITEM_IDS + 1, N_FACTORS
    s = torch.randn((m, d), generator=gen, device=dev).requires_grad_()
    items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).requires_grad_()
    dlse = torch.rand((m,), generator=gen, device=dev) / m
    port.reset_launches()
    lse = softmax_lse.streaming_lse(s, items, bounded_shift=True)
    lse.backward(dlse)
    z = lse.detach() - torch.log(dlse)
    ds, di = softmax_lse.softmax_grads_from_z(s.detach(), items.detach(), z)
    s_bf, items_bf = s.detach().to(torch.bfloat16), items.detach().to(torch.bfloat16)
    ds_bf, di_bf = softmax_lse.softmax_grads_from_z(s_bf, items_bf, z)
    launches = dict(port.LAUNCHES)
    expected = {name: 0 for name in launches}
    expected.update(lse_shift_fwd=1, lse_bwd_fused=1, grads_z_fused=1, grads_z_fused_bf16=1)
    check(launches == expected, f"launches of the ops {launches}, expected {expected}")
    ref_bf = softmax_lse.softmax_grads_from_z_bf16_reference(s_bf, items_bf, z, partials=True)
    rel_bf = max(_max_rel(g, r) for g, r in zip((ds_bf, di_bf), ref_bf))
    check(rel_bf <= BF16_SPLIT_RTOL, f"softmax_grads_from_z on bf16 towers is {rel_bf} from its twin")
    print(f"ops: softmax_grads_from_z on the same towers in bf16 (kernel 12's bf16 form): {rel_bf:.3g} of the "
          f"largest entry from its twin (limit {BF16_SPLIT_RTOL:.3g})")
    # the same function twice: the gradients of lse · dlse, and P @ items, Pᵀ @ s from z = lse − log(dlse)
    rel = max(_max_rel(ds, s.grad), _max_rel(di, items.grad))
    check(rel <= CE_RTOL, f"softmax_grads_from_z and the bounded-shift lse's VJP differ by {rel} of the largest entry")
    exact = softmax_lse.streaming_lse(s.detach(), items.detach())
    rel_lse = ((lse.detach() - exact).abs() / exact.abs()).max().item()
    check(rel_lse <= LSE_RTOL, f"the bounded-shift lse differs from kernel 6's by {rel_lse} relative")
    print(f"ops: streaming_lse(bounded_shift=True) with its backward and softmax_grads_from_z at M={m}, N={n}: "
          f"launches {launches}; the two gradients agree to {rel:.3g} of the largest entry, the lse with kernel 6's "
          f"to {rel_lse:.3g}")
    del s, items, dlse, lse, z, ds, di, exact, s_bf, items_bf, ds_bf, di_bf, ref_bf
    torch.cuda.empty_cache()
    return {"launches": launches, "grads_max_rel_diff": rel, "lse_max_rel_diff": rel_lse,
            "bf16_grads_max_rel_err": rel_bf}


def large_fit_phase(torch, np, pd, port, dev, n_item_ids: int = LARGE_N_ITEM_IDS, f32: dict = None,
                    compute_dtype: str = "float32") -> dict:
    """``SASRecModel(...).fit`` at the training width on a catalog of
    ``n_item_ids`` + 1 rows, too large for kernel 7's one pass: at 131,072
    rows every step's CE gradients take the very-large-catalog route (kernels
    13 + 14 and the label term in torch), at 65,536 kernel 7's two launches
    (``ce_ds_f32``, ``ce_di_f32``); then one step's loss gradients on the card
    against the twins. With ``compute_dtype="bfloat16"`` the fit runs the bf16
    forms, by the route rule at bf16 (kernel 7's two launches at 65,536 rows,
    the large-catalog route at 196,608), its losses held within BF16_LOSS_RTOL
    of ``f32`` (the f32 fit on the same catalog) where given, a profiled step's
    device kernels checked; one step's loss gradients are held against the
    two launches' twin, or, through the large-catalog route, against kernel
    7's bf16 one pass on the card with the budget lifted (BF16_ROUTE_BAND)."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.models import SASRecModel
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers import losses
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse

    t0 = time.perf_counter()
    dataset = Dataset.construct(kion_frame(np, pd, Columns, n_item_ids))
    n_items, m = n_item_ids + 1, TRAIN_B * SESSION_MAX_LEN
    bf16 = compute_dtype == "bfloat16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    route = softmax_lse.ce_takes_split_route(m, n_items, N_FACTORS, dtype)
    tag = ("bf16 " if bf16 else "") + ("large fit" if route else "mid fit")
    # the loss gradients' launches each step: the large-catalog route, or kernel 7's two launches
    loss_keys = tuple(key + ("_bf16" if bf16 else "") for key in (
        ("grads_z_ds", "grads_z_di") if route else ("ce_grads_ds", "ce_grads_di")))
    print(f"{tag}: frame of {dataset.user_id_map.size} users over {n_item_ids} item ids built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(not softmax_lse._fused_on_the_card(m, n_items, N_FACTORS, softmax_lse._ds_itemsize(dtype)),
          f"the CE gradients at N={n_items} would take kernel 7's one pass")
    clock = epoch_clock(torch, dev)
    model = SASRecModel(
        **TRAIN_CONFIG, epochs=EPOCHS, item_net_block_types=(IdEmbeddingsItemNet,), get_val_mask_func=hold_out_last,
        get_callbacks_func=lambda: [clock], training_module_kwargs={"val_recall_k": K, "compute_dtype": compute_dtype},
        device=dev,
    )
    torch.cuda.reset_peak_memory_stats()
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tm = model.training_module
    check(model.backbone.item_model.n_items == n_items, f"item table is not {n_items} rows")
    steps = tm.global_step
    val_batches = len(model.data_preparator.get_dataloader_val())
    if bf16:
        check(tm.resolved_compute_dtype == "bfloat16", f"the {tag} resolved {tm.resolved_compute_dtype}")
        expected = _bf16_fit_launches(port, steps, EPOCHS * val_batches, with_loss=False)
        expected.update(lse_partials_fwd_bf16=steps, **{key: steps for key in loss_keys})
    else:
        forwards = steps + EPOCHS * val_batches
        expected = {name: 0 for name in port.LAUNCHES}
        expected.update(lse_partials_fwd=steps, **{key: steps for key in loss_keys},
                        layer_norm_fwd=(2 * N_BLOCKS + 1) * forwards, attention_fwd=N_BLOCKS * forwards,
                        layer_norm_bwd=(2 * N_BLOCKS + 1) * steps, attention_bwd=N_BLOCKS * steps)
    check(launches == expected, f"launches in the {tag} {launches}, expected {expected}")
    losses_, val_losses = tm.train_loss_history, tm.val_loss_history
    recall = tm.val_metric_history.get(f"val_recall@{K}", [])
    check(len(losses_) == EPOCHS and bool(np.isfinite(losses_).all()) and losses_[1] < losses_[0],
          f"train losses {losses_}")
    loss_rel = None
    if f32 is not None:
        loss_rel = max(abs(a / b - 1) for a, b in zip(losses_, f32["train_loss"]))
        check(loss_rel <= BF16_LOSS_RTOL, f"{tag}: train losses {losses_} against the f32 fit's {f32['train_loss']}: "
                                          f"{loss_rel} (limit {BF16_LOSS_RTOL})")
        print(f"{tag}: losses {losses_} against the f32 fit's {f32['train_loss']} on the same catalog: largest "
              f"relative gap {loss_rel:.3g} (limit {BF16_LOSS_RTOL})")
    check(len(val_losses) == EPOCHS and bool(np.isfinite(val_losses).all()), f"validation losses {val_losses}")
    check(len(recall) == EPOCHS and bool(np.isfinite(recall).all()), f"val_recall@{K} {recall}")
    epoch2_s = clock.times[2] - clock.times[1]
    examples_per_s = TRAIN_B * (steps // EPOCHS) / epoch2_s
    print(f"{tag}: {EPOCHS} epochs x {steps // EPOCHS} steps of {TRAIN_B} on {n_items} items in {fit_s:.2f} s; "
          f"launches {launches}")
    print(f"{tag}: losses {losses_}, val_loss {val_losses}, val_recall@{K} {recall}")
    print(f"{tag}: epoch 2 wall {epoch2_s:.3f} s (validation included), {examples_per_s:.0f} train examples/s, "
          f"peak device memory {peak_mb:.0f} MiB")

    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
    batch = tm._device_batch(pad_batch(next(iter(loader)), TRAIN_B))
    if bf16:  # a profiled step's device kernels: the bf16 forms of the route, no one pass, no f32 loss kernel
        names = list(device_kernels(torch, lambda: tm._train_step(batch), 1))
        # the route's kernels (13 + 14, or kernel 7's engine) and not the other's
        split, engine = ("split_ds_bf16_kernel", "split_di_bf16_kernel"), (CE_BF16_ENGINE_KERNEL,)
        wanted = (ATTN_BF16_FWD_KERNEL, "attn_bwd_bf16_kernel", "lse_partials_bf16_kernel",
                  *(split if route else engine))
        missing, banned = bf16_step_kernels(names, wanted, (*BF16_BANNED_KERNELS, "ce_fused_bf16_kernel",
                                                            *(engine if route else split)))
        check(not missing and not banned, f"a {tag} step's device kernels: missing {missing}, banned {banned}")
        print(f"{tag}: a profiled step ran {len(names)} device kernels, {'the bf16 split kernels (13 + 14)' if route else 'kernel 7 bf16 engine'} and "
              f"LayerNorm's bf16 forms among them, no one pass, no f32 loss, attention or LayerNorm kernel, no "
              f"library attention or cross-entropy")
    print(f"{tag}: profile of one train step")
    profile = profile_phase(torch, lambda: tm._train_step(batch))

    # one step's loss gradients of the trained towers: the route against the twins (kernel 7's for the gradients)
    backbone = model.backbone.eval()
    with torch.no_grad():
        item_embs = backbone.item_model.embed_catalog()
        s_t, i_t = backbone.similarity_module.catalog_loss_towers(backbone.encode_sessions(batch, item_embs), item_embs)
    s2 = (s_t.float() / tm.logits_t).reshape(m, N_FACTORS).contiguous()
    items, y, w = i_t.float().contiguous(), batch["y"].reshape(-1), batch["yw"].reshape(-1)
    if bf16:
        step = bf16_step_check(torch, port, losses, softmax_lse, tag, "large-catalog" if route else "two launches",
                               s2.to(dtype), items.to(dtype), y, w, loss_keys)
        return {"launches": launches, "steps": steps, "n_items": n_items,
                "route": "large-catalog" if route else "kernel 7's two launches", "train_loss": losses_,
                "val_loss": val_losses, f"val_recall@{K}": recall, "fit_s": fit_s, "epoch2_s": epoch2_s,
                "train_examples_per_s": examples_per_s, "peak_device_mib": peak_mb, "loss_rel_to_f32": loss_rel,
                **step, **{f"step_{k}": v for k, v in profile.items()}}
    sg, ig = s2.clone().requires_grad_(), items.clone().requires_grad_()
    port.reset_launches()
    loss = losses.fused_softmax_loss(sg[None], ig, y[None], w[None])
    ds, di = torch.autograd.grad(loss, (sg, ig))
    keys = ("lse_partials_fwd", "grads_z_ds", "grads_z_di", "ce_grads_ds", "ce_grads_di", "ce_grads_fused")
    step = {k: port.LAUNCHES[k] for k in keys}
    check(step == {k: int(k == "lse_partials_fwd" or k in loss_keys) for k in keys},
          f"launches of one loss gradient {step}")
    lse = softmax_lse.streaming_lse_partials_reference(s2, items)
    ref_loss, _, denom = losses._ce_pieces(s2, items, y, w, lse)
    c = w.float() * (y != 0).float() / denom
    ref_ds, ref_di = softmax_lse.softmax_ce_grads_from_z_reference(s2, items, lse - torch.log(c), y, c,
                                                                    partials=route)
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    grad_rel = max(_max_rel(ds, ref_ds), _max_rel(di, ref_di))
    check(loss_rel <= LOSS_RTOL and grad_rel <= CE_RTOL,
          f"one step's loss {loss_rel} / gradients {grad_rel} differ from the twins'")
    print(f"{tag}: one step's loss and gradients against the twins: loss {loss_rel:.3g} relative, gradients "
          f"{grad_rel:.3g} of the largest entry")
    return {"launches": launches, "steps": steps, "n_items": n_items, "route": "large-catalog" if route else
            "kernel 7's two launches", "train_loss": losses_, "val_loss": val_losses,
            f"val_recall@{K}": recall, "fit_s": fit_s, "epoch2_s": epoch2_s, "train_examples_per_s": examples_per_s,
            "peak_device_mib": peak_mb, "step_loss_rel_diff": loss_rel, "step_grad_rel_diff": grad_rel,
            **{f"step_{k}": v for k, v in profile.items()}}


def bf16_step_check(torch, port, losses, softmax_lse, tag: str, route: str, s2, items, y, w, loss_keys) -> dict:
    """One step's loss gradients of a bf16 fit's towers through the fused
    loss: the route's kernels once each; the leaves' bf16 gradients are the
    route's f32 gradients rounded once; kernel 7's one pass (``route`` "one
    pass") or its two launches ("two launches") held against their twin
    (BF16_SPLIT_RTOL), the large-catalog route ("large-catalog") against
    kernel 7's bf16 one pass on the same inputs with the budget lifted
    (BF16_ROUTE_BAND)."""
    m = s2.shape[0]
    sg, ig = s2.clone().requires_grad_(), items.clone().requires_grad_()
    port.reset_launches()
    loss = losses.fused_softmax_loss(sg[None], ig, y[None], w[None])
    ds, di = torch.autograd.grad(loss, (sg, ig))
    keys = ("lse_partials_fwd_bf16", "grads_z_ds_bf16", "grads_z_di_bf16", "ce_grads_ds_bf16", "ce_grads_di_bf16",
            "ce_grads_fused_bf16", "lse_partials_fwd", "ce_grads_fused", "ce_grads_ds", "grads_z_ds")
    launched = {k: port.LAUNCHES[k] for k in keys}
    check(launched == {k: int(k == "lse_partials_fwd_bf16" or k in loss_keys) for k in keys},
          f"{tag}: launches of one loss gradient {launched}")
    lse = softmax_lse.streaming_lse(s2, items)
    _, _, denom = losses._ce_pieces(s2, items, y, w, lse)
    c = w.float() * (y != 0).float() / denom
    z = (lse - torch.log(c)).contiguous()
    got = softmax_lse.softmax_ce_grads_from_z(s2, items, z, y, c)
    check(ds.dtype == di.dtype == torch.bfloat16 and bool(torch.equal(ds, got[0].to(torch.bfloat16)))
          and bool(torch.equal(di, got[1].to(torch.bfloat16))),
          f"{tag}: the towers' gradients are not the route's f32 gradients rounded once to bf16")
    if route == "large-catalog":
        budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62
        ref = softmax_lse.softmax_ce_grads_from_z(s2, items, z, y, c)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        limit, against = BF16_ROUTE_BAND, "kernel 7's bf16 one pass (the budget lifted)"
    else:
        one_pass = route == "one pass"
        ref = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s2, items, z, y, c, partials=one_pass)
        limit, against = BF16_SPLIT_RTOL, f"the {route}'s twin"
    errs = [_max_rel(g, r) for g, r in zip(got, ref)]
    check(max(errs) <= limit, f"{tag}: one step's gradients ds {errs[0]}, di {errs[1]} from {against} (limit {limit})")
    print(f"{tag}: one step's loss gradients through the {route} (M={m}, D={s2.shape[1]}): ds {errs[0]:.3g}, di "
          f"{errs[1]:.3g} of the largest entry from {against} (limit {limit:.3g}); the towers' bf16 gradients are the "
          f"route's f32 ones rounded once")
    return {"step_grad_ds_rel_diff": errs[0], "step_grad_di_rel_diff": errs[1]}


def classic_fwd_phase(torch, np, port, dataset, dev) -> dict:
    """Two KION train steps with ``USE_PARTIALS_FWD = False`` (kernel 15) beside
    the same two steps from the same start with the default (kernel 6)."""
    from rectools_tpu_torch.models import SASRecModel
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse

    models = {run: SASRecModel(**TRAIN_CONFIG, item_net_block_types=(IdEmbeddingsItemNet,), device=dev)
              for run in ("partials", "classic")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["partials"].training_module.init_params()
    start = {k: v.clone() for k, v in models["partials"].backbone.state_dict().items()}
    loader = iter(models["partials"].data_preparator.get_dataloader_train(np.random.default_rng(SEED)))
    batches = [pad_batch(next(loader), TRAIN_B) for _ in range(2)]
    losses, launches = {}, {}
    for run, model in models.items():
        tm = model.training_module
        tm.load_params(start)
        device_batches = [tm._device_batch(batch) for batch in batches]
        softmax_lse.USE_PARTIALS_FWD = run == "partials"
        port.reset_launches()
        losses[run] = [tm._train_step(batch).item() for batch in device_batches]
        launches[run] = dict(port.LAUNCHES)
    softmax_lse.USE_PARTIALS_FWD = True
    for run, (on, off) in {"partials": ("lse_partials_fwd", "lse_fwd"), "classic": ("lse_fwd", "lse_partials_fwd")}.items():
        check(launches[run][on] == 2 and launches[run][off] == 0, f"{run} steps: launches {launches[run]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["classic"], losses["partials"]))
    check(bool(np.isfinite(losses["classic"]).all()) and rel <= LOSS_RTOL,
          f"losses with kernel 15 {losses['classic']} against kernel 6 {losses['partials']}: {rel} relative")
    print(f"classic forward: two steps with USE_PARTIALS_FWD = False: launches {launches['classic']}; losses "
          f"{losses['classic']} beside the default's {losses['partials']}, {rel:.3g} relative")
    return {"launches": launches["classic"], "losses": losses["classic"], "default_losses": losses["partials"],
            "loss_max_rel_diff": rel}

# ---------------------------------------------------------------- phase 8, mesh training


def _mesh_model(dev, mesh_shape, epochs: int, callbacks=(), width: dict = None, **training_kwargs):
    from rectools_tpu_torch.models import SASRecModel
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    kwargs = {"val_recall_k": K, **training_kwargs}
    if mesh_shape is not None:
        kwargs["mesh_shape"] = mesh_shape
    return SASRecModel(
        **{**TRAIN_CONFIG, **(width or {})}, epochs=epochs, item_net_block_types=(IdEmbeddingsItemNet,), get_val_mask_func=hold_out_last,
        get_callbacks_func=lambda: list(callbacks), training_module_kwargs=kwargs, device=dev,
    )


def _mesh_fit_expected(port, model, epochs: int) -> dict:
    """Launches of a SASRec mesh fit on one rank: the encoder's kernels as in
    the plain fit, kernel 8 and kernel 9 once per step, none of kernels 6, 7,
    10 and 11."""
    steps = model.training_module.global_step
    forwards = steps + epochs * len(model.data_preparator.get_dataloader_val())
    expected = {name: 0 for name in port.LAUNCHES}
    expected.update(lse_bias_fwd=steps, lse_bwd_fused=steps,
                    layer_norm_fwd=(2 * N_BLOCKS + 1) * forwards, attention_fwd=N_BLOCKS * forwards,
                    layer_norm_bwd=(2 * N_BLOCKS + 1) * steps, attention_bwd=N_BLOCKS * steps)
    return expected


def _mesh_bf16_fit_expected(port, model, epochs: int) -> dict:
    """Launches of a SASRec bf16 mesh fit on one rank: the encoder's bf16
    forms (and the f32 forwards of the validation recall) as in the bf16 fit
    without a mesh, kernel 8's and kernel 9's bf16 forms once per step, none
    of kernels 6, 7, 10 and 11 in either dtype."""
    steps = model.training_module.global_step
    expected = _bf16_fit_launches(port, steps, epochs * len(model.data_preparator.get_dataloader_val()),
                                  with_loss=False)
    expected.update(lse_bias_fwd_bf16=steps, lse_bwd_fused_bf16=steps)
    return expected


def _losses_close(np, got: dict, ref: dict, what: str) -> float:
    worst = 0.0
    for key in ("train_loss", "val_loss"):
        check(len(got[key]) == len(ref[key]) and bool(np.isfinite(got[key]).all()), f"{what}: {key} {got[key]}")
        worst = max(worst, max(abs(g - r) / abs(r) for g, r in zip(got[key], ref[key])))
    check(worst <= LOSS_RTOL, f"{what}: losses {got} differ from {ref} by {worst} relative")
    return worst


def mesh_fit_phase(torch, np, port, dataset, dev, plain: dict, bf16_plain: dict) -> dict:
    """``mesh_shape=(1, 1)`` through a one-rank process group: the mesh route
    of the loss at the full width, against the fit without a mesh (``plain``,
    the training phase's losses); then the same with bf16 compute
    (:func:`bf16_mesh_fit`, against ``bf16_plain``, the bf16 phase's fit)."""
    import tempfile

    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse
    from rectools_tpu_torch.parallel import distributed as dist

    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        dist.initialize(init_method=f"file://{tmp}/store", num_processes=1, process_id=0,
                        timeout_s=MESH_RANK_TIMEOUT_S)
        try:
            check(dist.is_initialized() and dist.process_count() == 1, "the one-rank world did not start")
            backend = torch.distributed.get_backend()
            clock = epoch_clock(torch, dev)
            model = _mesh_model(dev, (1, 1), EPOCHS, [clock])
            port.reset_launches()
            t0 = time.perf_counter()
            model.fit(dataset)
            fit_s = time.perf_counter() - t0
            launches = dict(port.LAUNCHES)
            tm = model.training_module
            steps = tm.global_step
            epoch2_s = clock.times[2] - clock.times[1]
            examples_per_s = TRAIN_B * (steps // EPOCHS) / epoch2_s
            check(tm._use_fused_softmax and tm._get_mesh() is not None, "the fit did not take the mesh route")
            expected = _mesh_fit_expected(port, model, EPOCHS)
            check(launches == expected, f"launches in mesh fit {launches}, expected {expected}")
            got = {"train_loss": tm.train_loss_history, "val_loss": tm.val_loss_history}
            check(got["train_loss"][1] < got["train_loss"][0], f"mesh fit: train loss did not fall: {got}")
            rel = _losses_close(np, got, plain, "mesh fit against the fit without a mesh")
            print(f"mesh fit: mesh (1, 1) on a one-rank {backend} world, {steps} steps in {fit_s:.2f} s; "
                  f"launches {launches}")
            print(f"mesh fit: losses {got['train_loss']}, val_loss {got['val_loss']}; max relative difference from "
                  f"the fit without a mesh {rel:.3g} (limit {LOSS_RTOL})")
            print(f"mesh fit: epoch 2 wall {epoch2_s:.3f} s (validation included), {examples_per_s:.0f} train "
                  f"examples/s (the fit without a mesh: {plain['train_examples_per_s']:.0f})")
            # the split route of the backward: the partials budget forced to 0
            loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
            batch = tm._device_batch(tm._local_batch(pad_batch(next(iter(loader)), TRAIN_B)))
            profile = {}
            if str(dev) != "cpu":
                print("mesh fit: profile of one train step")
                profile = profile_phase(torch, lambda: tm._train_step(batch))
            budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
            port.reset_launches()
            split_losses = [tm._train_step(batch).item() for _ in range(2)]
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
            split = {k: port.LAUNCHES[k] for k in ("lse_bias_fwd", "lse_bwd_fused", "lse_bwd_ds", "lse_bwd_di")}
            check(split == {"lse_bias_fwd": 2, "lse_bwd_fused": 0, "lse_bwd_ds": 2, "lse_bwd_di": 2},
                  f"launches with the partials budget forced to 0: {split}")
            check(bool(np.isfinite(split_losses).all()) and split_losses[1] < split_losses[0],
                  f"losses of two steps on one batch through the split backward: {split_losses}")
            print(f"mesh fit: two steps with the partials budget forced to 0: launches {split}, "
                  f"losses {split_losses}")
            bf16 = bf16_mesh_fit(torch, np, port, dataset, dev, bf16_plain, backend)
            bf16["wide_steps"] = bf16_wide_mesh_steps(torch, np, port, dataset, dev)
        finally:
            dist.shutdown()
    return {"launches": launches, "launches_budget_forced": split, "steps": steps, "fit_s": fit_s,
            "train_loss": got["train_loss"], "val_loss": got["val_loss"], "loss_max_rel_diff_from_plain_fit": rel,
            "backend": backend, "epoch2_s": epoch2_s, "train_examples_per_s": examples_per_s,
            **{f"step_{k}": v for k, v in profile.items()}, "bf16": bf16}


def bf16_mesh_fit(torch, np, port, dataset, dev, bf16_plain: dict, backend: str) -> dict:
    """``bf16 mesh fit``: SASRec with compute_dtype "bfloat16" at
    ``mesh_shape=(1, 1)`` in the one-rank world, the training phase's width,
    depth and epochs: kernels 8 and 9's bf16 forms once a step and none of
    kernels 6 and 7 in either dtype, a profiled step's device kernels (the
    bf16 forms, no f32 attention or loss kernel), losses falling and within
    BF16_LOSS_RTOL of the bf16 fit without a mesh (``bf16_plain``); then two
    steps with the partials budget forced to 0 (kernels 10 + 11 in bf16)."""
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse

    clock = epoch_clock(torch, dev)
    model = _mesh_model(dev, (1, 1), EPOCHS, [clock], compute_dtype="bfloat16")
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    tm = model.training_module
    steps = tm.global_step
    check(tm._use_fused_softmax and tm._get_mesh() is not None and tm.resolved_compute_dtype == "bfloat16",
          "the bf16 mesh fit did not take the bf16 mesh route")
    expected = _mesh_bf16_fit_expected(port, model, EPOCHS)
    check(launches == expected, f"launches in the bf16 mesh fit {launches}, expected {expected}")
    losses, val = tm.train_loss_history, tm.val_loss_history
    check(len(losses) == EPOCHS and bool(np.isfinite(losses + val).all()) and losses[1] < losses[0],
          f"bf16 mesh fit: train losses {losses}, val_loss {val}")
    rel = max(abs(a / b - 1) for a, b in zip(losses, bf16_plain["train_loss"]))
    check(rel <= BF16_LOSS_RTOL, f"bf16 mesh fit: losses {losses} against the bf16 fit without a mesh "
                                 f"{bf16_plain['train_loss']}: {rel}")
    epoch2_s = clock.times[2] - clock.times[1]
    examples_per_s = TRAIN_B * (steps // EPOCHS) / epoch2_s
    print(f"bf16 mesh fit: mesh (1, 1) on a one-rank {backend} world with bf16 compute, {steps} steps in "
          f"{fit_s:.2f} s; launches { {k: v for k, v in launches.items() if v} }")
    print(f"bf16 mesh fit: losses {losses}, val_loss {val}; largest relative gap from the bf16 fit without a mesh "
          f"{rel:.3g} (limit {BF16_LOSS_RTOL}); epoch 2 wall {epoch2_s:.3f} s (validation included), "
          f"{examples_per_s:.0f} train examples/s")
    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
    batch = tm._device_batch(tm._local_batch(pad_batch(next(iter(loader)), TRAIN_B)))
    names = list(device_kernels(torch, lambda: tm._train_step(batch), 1))
    missing, banned = bf16_step_kernels(names, BF16_MESH_DEVICE_KERNELS, (*BF16_BANNED_KERNELS, CE_BF16_ENGINE_KERNEL))
    if dev != "cpu":
        check(not missing and not banned, f"a bf16 mesh step's device kernels: missing {missing}, f32 or library "
                                          f"{banned}")
        print(f"bf16 mesh fit: a profiled step ran {len(names)} device kernels, the bf16 forms among them, no f32 "
              f"attention, loss or LayerNorm kernel, no library attention or cross-entropy")
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
    port.reset_launches()
    split_losses = [tm._train_step(batch).item() for _ in range(2)]
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
    split = {k: port.LAUNCHES[k] for k in ("lse_bias_fwd_bf16", "lse_bwd_fused_bf16", "lse_bwd_ds_bf16",
                                           "lse_bwd_di_bf16", "lse_bias_fwd", "lse_bwd_ds", "lse_bwd_di")}
    check(split == {"lse_bias_fwd_bf16": 2, "lse_bwd_fused_bf16": 0, "lse_bwd_ds_bf16": 2, "lse_bwd_di_bf16": 2,
                    "lse_bias_fwd": 0, "lse_bwd_ds": 0, "lse_bwd_di": 0},
          f"bf16 launches with the partials budget forced to 0: {split}")
    check(bool(np.isfinite(split_losses).all()) and split_losses[1] < split_losses[0],
          f"bf16 losses of two steps on one batch through the split backward: {split_losses}")
    print(f"bf16 mesh fit: two steps with the partials budget forced to 0: launches {split}, losses {split_losses}")
    return {"launches": launches, "launches_budget_forced": split, "steps": steps, "fit_s": fit_s,
            "train_loss": losses, "val_loss": val, "loss_max_rel_diff_from_bf16_fit": rel, "epoch2_s": epoch2_s,
            "train_examples_per_s": examples_per_s}


def _state_digest(state: dict) -> str:
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(state):
        digest.update(name.encode())
        digest.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def mesh_rank_worker(rank: int, repo: str, dev: str) -> dict:
    """One rank of the four-rank mesh fit: its own frame from the seed (the
    odd catalog), ``fit`` at ``mesh_shape=MESH_4``, and what it reports."""
    sys.path.insert(0, repo)
    import numpy as np
    import pandas as pd
    import torch

    import rectools_tpu_torch.ops as port
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dataset = Dataset.construct(kion_frame(np, pd, Columns, RAGGED_N - 1))
    clock = epoch_clock(torch, dev)
    model = _mesh_model(dev, MESH_4, 1, [clock])
    port.reset_launches()
    model.fit(dataset)
    launches = dict(port.LAUNCHES)
    tm = model.training_module
    state = tm.get_state()["params"]  # whole tables: every rank gathers
    out = {
        "rank": rank, "coords": dict(tm._get_mesh().coords), "launches": launches,
        "expected_launches": _mesh_fit_expected(port, model, 1), "steps": tm.global_step,
        "epoch_s": clock.times[1] - clock.times[0],
        "train_loss": tm.train_loss_history, "val_loss": tm.val_loss_history,
        "recall": tm.val_metric_history.get(f"val_recall@{K}", []),
        "n_items": model.backbone.item_model.n_items, "backend": torch.distributed.get_backend(),
        "table_shape": tuple(model.backbone.item_model.item_net_blocks[0].ids_emb.weight.shape),
        "digest": _state_digest(state), "params": state if rank == 0 else None,
    }
    # then one epoch with bf16 compute from the seed (kernels 8 and 9's bf16 forms)
    clock = epoch_clock(torch, dev)
    model = _mesh_model(dev, MESH_4, 1, [clock], compute_dtype="bfloat16")
    port.reset_launches()
    model.fit(dataset)
    tm = model.training_module
    state = tm.get_state()["params"]
    out["bf16"] = {
        "launches": dict(port.LAUNCHES), "expected_launches": _mesh_bf16_fit_expected(port, model, 1),
        "steps": tm.global_step, "epoch_s": clock.times[1] - clock.times[0],
        "train_loss": tm.train_loss_history, "val_loss": tm.val_loss_history,
        "recall": tm.val_metric_history.get(f"val_recall@{K}", []),
        "digest": _state_digest(state), "params": state if rank == 0 else None,
    }
    return out


def mesh_fit_4_phase(torch, np, pd, dev, world: int = 4) -> dict:
    """Four ranks on the one card at mesh (2, 2), one epoch on the odd catalog,
    against each other (exactly) and against the single-process fit of the
    same global batches (LOSS_RTOL, PARAM_ATOL)."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.parallel.launch import run_ranks

    repo = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    # several ranks on one card: gloo, device tensors staged through host memory
    ranks = run_ranks(mesh_rank_worker, world, (repo, dev), timeout_s=MESH_RANK_TIMEOUT_S, backend="gloo", threads=2)
    spawn_s = time.perf_counter() - t0
    first = ranks[0]
    check(first["n_items"] == RAGGED_N, f"the ranks' catalog has {first['n_items']} rows, expected {RAGGED_N}")
    check(first["table_shape"] == (RAGGED_N, N_FACTORS // MESH_4[1]),
          f"ids_emb on a rank is {first['table_shape']}, not column-sharded over the model group")
    check({(r["coords"]["data"], r["coords"]["model"]) for r in ranks} == {(d, m) for d in range(MESH_4[0])
                                                                          for m in range(MESH_4[1])},
          f"mesh coordinates {[r['coords'] for r in ranks]}")
    for r in ranks:
        check(r["launches"] == r["expected_launches"],
              f"rank {r['rank']}: launches {r['launches']}, expected {r['expected_launches']}")
        for key in ("train_loss", "val_loss", "recall", "digest", "steps"):
            check(r[key] == first[key], f"rank {r['rank']}: {key} {r[key]} differs from rank 0's {first[key]}")
    check(bool(np.isfinite(first["train_loss"] + first["val_loss"] + first["recall"]).all()), f"rank losses {first}")

    single = _mesh_model(dev, None, 1)
    single.fit(Dataset.construct(kion_frame(np, pd, Columns, RAGGED_N - 1)))
    tm = single.training_module
    rel = _losses_close(np, first, {"train_loss": tm.train_loss_history, "val_loss": tm.val_loss_history},
                        "four-rank mesh fit against the single-process fit")
    param_err, key_bias_err, worst = 0.0, 0.0, ""
    for name, value in tm.get_state()["params"].items():
        err = (first["params"][name] - value).abs().max().item()
        if name.endswith("multi_head_attn.k_proj.bias"):  # zero gradient in exact arithmetic: see the agree phase
            key_bias_err = max(key_bias_err, err)
        elif err > param_err:
            param_err, worst = err, name
    check(param_err <= PARAM_ATOL, f"four-rank mesh fit: parameters differ from the single-process fit by "
                                   f"{param_err} in {worst}")
    bf16 = mesh_4_bf16_check(np, pd, dev, ranks)
    step_ms = [1e3 * r["epoch_s"] / r["steps"] for r in ranks]  # the epoch's wall, its validation batches included
    print(f"mesh fit 4: {world} ranks on one card ({first['backend']}, host staging), mesh {MESH_4}, "
          f"{first['steps']} steps on the {RAGGED_N}-row catalog, spawn to results {spawn_s:.1f} s; "
          f"per rank launches {first['launches']}")
    print(f"mesh fit 4: all ranks report the same losses {first['train_loss']}, val_loss {first['val_loss']}, "
          f"val_recall@{K} {first['recall']} and parameter digest {first['digest'][:16]}; each holds "
          f"ids_emb columns {first['table_shape']}")
    print(f"mesh fit 4: against the single-process fit: max loss rel diff {rel:.3g}, max param abs diff "
          f"{param_err:.3g} in {worst} (key-projection biases {key_bias_err:.3g}); epoch wall per step, "
          f"4 ranks on one card: {[round(t, 1) for t in step_ms]} ms")
    return {"launches": first["launches"], "launches_by_rank": [r["launches"] for r in ranks],
            "steps": first["steps"], "train_loss": first["train_loss"], "val_loss": first["val_loss"],
            "digest": first["digest"], "loss_max_rel_diff_from_single_process": rel,
            "param_max_abs_diff_from_single_process": param_err, "key_bias_max_abs_diff": key_bias_err,
            "four_ranks_on_one_card_step_ms": step_ms, "spawn_to_results_s": spawn_s, "bf16": bf16}


def mesh_4_bf16_check(np, pd, dev, ranks: list) -> dict:
    """The ranks' bf16 epoch at MESH_4 (after their f32 one): launches, all
    ranks equal, and the single-process bf16 fit of the same batches at
    ``mesh_shape=(1, 1)`` within MESH_4_BF16_LOSS_RTOL and the parameter rule
    of MESH_4_BF16_PARAM_MEAN_A_STEP."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    first = ranks[0]["bf16"]
    for r in ranks:
        got = r["bf16"]
        check(got["launches"] == got["expected_launches"],
              f"rank {r['rank']}: bf16 launches {got['launches']}, expected {got['expected_launches']}")
        for key in ("train_loss", "val_loss", "recall", "digest", "steps"):
            check(got[key] == first[key], f"rank {r['rank']}: bf16 {key} {got[key]} differs from rank 0's {first[key]}")
    check(bool(np.isfinite(first["train_loss"] + first["val_loss"] + first["recall"]).all()), f"bf16 ranks {first}")
    single = _mesh_model(dev, (1, 1), 1, compute_dtype="bfloat16")  # one process: no group to join
    single.fit(Dataset.construct(kion_frame(np, pd, Columns, RAGGED_N - 1)))
    tm = single.training_module
    losses = {"train_loss": tm.train_loss_history, "val_loss": tm.val_loss_history}
    rel = max(abs(g / r - 1) for key in losses for g, r in zip(first[key], losses[key]))
    check(len(first["train_loss"]) == len(losses["train_loss"]) and rel <= MESH_4_BF16_LOSS_RTOL,
          f"four-rank bf16 fit: losses {first['train_loss']}, {first['val_loss']} against the single-process (1, 1) "
          f"bf16 fit's {losses}: {rel}")
    steps = first["steps"]
    errs = {name: (first["params"][name] - value).abs() for name, value in tm.get_state()["params"].items()}
    mean = sum(e.sum().item() for e in errs.values()) / sum(e.numel() for e in errs.values())
    # the key-projection biases' gradient is 0 in exact arithmetic (see the agree phase): printed, not held
    key_bias = max(e.max().item() for name, e in errs.items() if name.endswith("multi_head_attn.k_proj.bias"))
    errs = {name: e for name, e in errs.items() if not name.endswith("multi_head_attn.k_proj.bias")}
    worst = max(errs, key=lambda name: errs[name].max().item())
    largest = errs[worst].max().item()
    check(largest <= 2 * steps * LR and mean <= steps * MESH_4_BF16_PARAM_MEAN_A_STEP,
          f"four-rank bf16 fit: parameters differ from the single-process bf16 fit by {largest} in {worst} (limit "
          f"{2 * steps * LR}), {mean} on average (limit {steps * MESH_4_BF16_PARAM_MEAN_A_STEP})")
    step_ms = [1e3 * r["bf16"]["epoch_s"] / r["bf16"]["steps"] for r in ranks]
    print(f"mesh fit 4: bf16 epoch, all ranks report the same losses {first['train_loss']}, val_loss "
          f"{first['val_loss']}, val_recall@{K} {first['recall']} and parameter digest {first['digest'][:16]}; per rank "
          f"launches { {k: v for k, v in first['launches'].items() if v} }")
    print(f"mesh fit 4: bf16 epoch against the single-process (1, 1) bf16 fit: max loss rel diff {rel:.3g} (limit "
          f"{MESH_4_BF16_LOSS_RTOL}), param abs diff largest {largest:.3g} in {worst} (limit {2 * steps * LR:.3g}; "
          f"key-projection biases {key_bias:.3g}), mean {mean:.3g} (limit "
          f"{steps * MESH_4_BF16_PARAM_MEAN_A_STEP:.3g}); epoch wall per step, 4 ranks on one card: "
          f"{[round(t, 1) for t in step_ms]} ms")
    return {"launches": first["launches"], "steps": steps, "train_loss": first["train_loss"],
            "val_loss": first["val_loss"], "digest": first["digest"], "loss_max_rel_diff_from_single_process": rel,
            "param_max_abs_diff_from_single_process": largest, "param_mean_abs_diff_from_single_process": mean,
            "key_bias_max_abs_diff": key_bias, "four_ranks_on_one_card_step_ms": step_ms}


# ---------------------------------------------------------------- phase 10, the other transformer families


# SASRec at B = 512 on an ML-20M-sized configuration (benchmarks/perf_suite.py `ml20m_large` at B = 512, the
# configuration the JAX package's remat exists for): L = 200, d = 256, 8 heads of 32, 2 blocks, a 20,480-row catalog
# (20,479 ids + PAD), full softmax, f32
REMAT_SHAPE = dict(l=200, d=256, heads=8, n_item_ids=20479)
BERT4REC_LABEL_SHARE = 0.15  # the share of BERT4Rec's positions that carry a label (mask_prob)
REMAT_RTOL, REMAT_ATOL = 1e-6, 1e-6  # remat against the plain fit: losses relative, parameters absolute


def ptxas_entries(report: str) -> dict:
    """{mangled entry function: {"registers", "stack", "spill_stores",
    "spill_loads"}} from ``ptxas -v`` output."""
    import re

    entries, current = {}, None
    for line in report.splitlines():
        match = re.search(r"Compiling entry function '([^']+)'", line)
        if match:
            current = entries.setdefault(match.group(1), {})
        elif current is not None and "bytes stack frame" in line:
            current.update(zip(("stack", "spill_stores", "spill_loads"),
                               (int(x) for x in re.findall(r"(\d+) bytes", line))))
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def _attention_case(torch, F, attention, gen, dev, b: int, l: int, h: int, dh: int, bias, tag: str) -> dict:
    """Kernels 2 (with dropout) and 5 at (b, h, l, dh) under ``bias`` against
    their twins (ATTN_TOL, the same bits on a rerun), timed beside the twins,
    SDPA and its autograd, and the bound of the pairs the bias lets through."""
    q, k, v, dout = (torch.randn((b, l, h, dh), generator=gen, device=dev).transpose(1, 2) for _ in range(4))
    scale, seed = 1.0 / math.sqrt(dh), 192837465
    out, lse = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    ref_out, ref_lse = attention.attention_reference(q, k, v, bias, scale, DROPOUT, seed)
    err_fwd = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    again = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    check(err_fwd <= ATTN_TOL and bool(torch.equal(again[0], out) and torch.equal(again[1], lse)),
          f"attention forward {tag}: max abs err {err_fwd} from the twin, or other bits on a rerun")
    delta = (dout * out).sum(-1).contiguous()
    got = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    ref = attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    err_bwd = max((a - r).abs().max().item() for a, r in zip(got, ref))
    again = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    check(err_bwd <= ATTN_TOL and all(bool(torch.equal(a, g)) for a, g in zip(again, got)),
          f"attention backward {tag}: max abs err {err_bwd} from the twin, or other bits on a rerun")
    live = int((bias > -1e8).sum().item()) * (b // bias.shape[0]) * h  # (query, key) pairs the bias lets through
    flops = live * dh
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias, scale=scale)
    results = {
        f"attention_fwd_{tag}": dict(
            max_abs_err=err_fwd,
            ms=time_ms(lambda: attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)),
            plain_ms=time_ms(lambda: attention.attention_reference(q, k, v, bias, scale, DROPOUT, seed), iters=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)),
            **tc_bounds(4 * q.numel() * 4 + lse.numel() * 4 + bias.numel() * 4, 4 * flops),
        ),
        f"attention_bwd_{tag}": dict(
            max_abs_err=err_bwd,
            ms=time_ms(lambda: attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)),
            plain_ms=time_ms(lambda: attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale,
                                                                       DROPOUT, seed), iters=3),
            library_ms=time_ms(lambda: torch.autograd.grad(out_lib, (qg, kg, vg), dout, retain_graph=True)),
            **tc_bounds(7 * q.numel() * 4 + 2 * lse.numel() * 4 + bias.numel() * 4, 10 * flops),
        ),
    }
    print(f"family kernels: attention {tag} at B={b}, H={h}, L={l}, dh={dh}, dropout {DROPOUT}: forward "
          f"{results[f'attention_fwd_{tag}']['ms']:.4f} ms, backward {results[f'attention_bwd_{tag}']['ms']:.4f} ms; "
          f"max abs err {err_fwd:.3g} / {err_bwd:.3g} (limit {ATTN_TOL}); {live / (b * h * l * l):.4f} of the "
          "(query, key) pairs live; bit-equal on a rerun")
    return results


def family_kernel_phase(torch, dev, reports: dict, b: int = TRAIN_B) -> dict:
    """The kernels at the shapes the BERT4Rec fit and the remat fit give them:
    kernels 2 and 5 under BERT4Rec's bidirectional key-padding bias ((B, 1, L,
    L), the diagonal kept, left-padded sessions, one of length 1) and, causal,
    at L = 200 with heads of 32; kernels 6 and 7 on BERT4Rec's 15,873-row
    catalog with 15% of the rows labelled; kernels 1 and 4 at width 256; and
    kernel 6 with kernels 13 + 14 (the route the CE gradients take there) at
    102,400 x 20,480 x 256 on the SIMT tile, whose build must show no stack."""
    import types

    import torch.nn.functional as F

    from rectools_tpu_torch.models.nn.transformers import TransformerBackbone
    from rectools_tpu_torch.ops import _native, attention, layer_norm, softmax_lse

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    results = {}

    # the remat shape's kernels as built: D = 256 loss kernels, width-256 LayerNorms, attention at heads of 32
    marks = {"softmax_lse": "ILi256E", "layer_norm": "ILi8E", "attention": "ILi32E"}
    for source, mark in marks.items():
        if source not in reports:
            print(f"build: {source} came from the build cache this run; its stack frames are not shown")
            continue
        frames = {name: e["stack"] for name, e in ptxas_entries(reports[source]).items() if mark in name}
        check(bool(frames) and not any(frames.values()),
              f"build: {source}: the remat shape's kernels want stack: {frames}")
        print(f"build: {source}: {len(frames)} entry functions at the remat shape ({mark}), 0 bytes of stack each")

    # kernels 2 and 5: BERT4Rec's bias, from the backbone's own rule, over sessions of the frame's lengths
    l, h, dh = SESSION_MAX_LEN, N_HEADS, N_FACTORS // N_HEADS
    lengths = torch.randint(1, 301, (b,), generator=gen, device=dev).clamp(max=l)
    lengths[0], lengths[1] = 1, l
    sessions = torch.where(torch.arange(l, device=dev)[None, :] >= l - lengths[:, None], 1, 0)
    rule = types.SimpleNamespace(use_causal_attn=False, use_key_padding_mask=True)
    bias = TransformerBackbone._build_attn_bias(rule, sessions)
    check(tuple(bias.shape) == (b, 1, l, l) and bias.is_contiguous(), f"BERT4Rec's bias is {tuple(bias.shape)}")
    results.update(_attention_case(torch, F, attention, gen, dev, b, l, h, dh, bias, "bidirectional"))
    del bias

    # kernels 2 and 5 at the remat shape: causal, L = 200, 8 heads of 32
    rl, rd, rh = REMAT_SHAPE["l"], REMAT_SHAPE["d"], REMAT_SHAPE["heads"]
    causal = torch.where(torch.ones((rl, rl), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    results.update(_attention_case(torch, F, attention, gen, dev, b, rl, rh, rd // rh, causal, "remat_shape"))
    torch.cuda.empty_cache()

    # kernels 1 and 4 at width 256
    m = b * rl
    x = torch.randn((m, rd), generator=gen, device=dev) * 2 + 0.5
    gamma, beta = torch.randn((rd,), generator=gen, device=dev), torch.randn((rd,), generator=gen, device=dev)
    dy = torch.randn((m, rd), generator=gen, device=dev)
    y = layer_norm.layer_norm(x, gamma, beta, 1e-6)
    err = (y - layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)).abs().max().item()
    got = layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6)
    ref = layer_norm.layer_norm_bwd_reference(x, gamma, dy, 1e-6)
    err_dx, err_sums = (got[0] - ref[0]).abs().max().item(), max(_max_rel(got[1], ref[1]), _max_rel(got[2], ref[2]))
    check(err <= LN_TOL and err_dx <= LN_BWD_TOL and err_sums <= LN_BWD_TOL,
          f"LayerNorm at width {rd}: forward {err}, dx {err_dx}, dgamma/dbeta relative {err_sums}")
    check(all(bool(torch.equal(a, g)) for a, g in zip(layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6), got)),
          f"layer_norm_bwd at width {rd}: other bits on a rerun")
    xg, gg, bg = (t.detach().clone().requires_grad_() for t in (x, gamma, beta))
    y_lib = F.layer_norm(xg, (rd,), gg, bg, 1e-6)
    results["layer_norm_fwd_remat_shape"] = dict(
        max_abs_err=err, ms=time_ms(lambda: layer_norm.layer_norm(x, gamma, beta, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)),
        library_ms=time_ms(lambda: F.layer_norm(x, (rd,), gamma, beta, 1e-6)),
        bound=bound_ms(2 * x.numel() * 4 + 2 * rd * 4, 8 * x.numel()),
    )
    results["layer_norm_bwd_remat_shape"] = dict(
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)),
        ms=time_ms(lambda: layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm.layer_norm_bwd_reference(x, gamma, dy, 1e-6)),
        library_ms=time_ms(lambda: torch.autograd.grad(y_lib, (xg, gg, bg), dy, retain_graph=True)),
        bound=bound_ms(3 * x.numel() * 4 + 3 * rd * 4, 12 * x.numel()),
    )
    print(f"family kernels: LayerNorm at {m} x {rd}: forward {results['layer_norm_fwd_remat_shape']['ms']:.4f} ms "
          f"(err {err:.3g}), backward {results['layer_norm_bwd_remat_shape']['ms']:.4f} ms (dx {err_dx:.3g}, "
          f"dgamma/dbeta {err_sums:.3g} relative); bit-equal on a rerun")
    del x, dy, y, got, ref, xg, y_lib
    torch.cuda.empty_cache()

    def loss_case(m_: int, n_: int, d_: int, label_share: float, first_item: int, tag: str) -> None:
        """Kernel 6 and the CE gradients' route at (m_, n_, d_) against the
        twins in the card's order: the tensor-core limits at d <= 128, the SIMT
        ones at 256; timed beside the twins and the library calls. The bound is
        the card's least time for these f32 products whatever tile runs them:
        3xTF32 on the tensor cores, with the FP32 bound beside it."""
        tensor_cores = d_ <= 128
        s = torch.randn((m_, d_), generator=gen, device=dev)
        items = (0.1 if tensor_cores else 0.05) * torch.randn((n_, d_), generator=gen, device=dev)
        lse = softmax_lse.streaming_lse(s, items)
        ref = softmax_lse.streaming_lse_partials_reference(s, items)
        rel = ((lse - ref).abs() / ref.abs()).max().item()
        lse_limit = LSE_TC_RTOL if tensor_cores else LSE_RTOL
        check(rel <= lse_limit and bool(torch.equal(softmax_lse.streaming_lse(s, items), lse)),
              f"lse_partials_fwd {tag}: {rel} relative per row from its twin (limit {lse_limit}), or other bits")
        products = 2 * m_ * n_ * d_
        chunks = -(-n_ // softmax_lse.LSE_CHUNK)
        results[f"lse_partials_fwd_{tag}"] = dict(
            max_abs_err=(lse - ref).abs().max().item(),
            ms=time_ms(lambda: softmax_lse.streaming_lse(s, items), iters=3),
            plain_ms=time_ms(lambda: softmax_lse.streaming_lse_partials_reference(s, items), iters=3),
            library_ms=time_ms(lambda: torch.logsumexp(s @ items.T, dim=1), iters=3),
            **tc_bounds((m_ * d_ + n_ * d_ + 2 * m_ * chunks) * 4, products),
        )
        labelled = torch.rand((m_,), generator=gen, device=dev) < label_share
        y = torch.where(labelled, torch.randint(first_item, n_, (m_,), generator=gen, device=dev), 0)
        coeff = labelled.float() / labelled.sum()
        z = lse - torch.log(coeff)  # +inf on the unlabelled rows
        split = softmax_lse.ce_takes_split_route(m_, n_, d_)
        keys = ("grads_z_ds", "grads_z_di") if split else ("ce_grads_fused",)
        before = {k: _native.LAUNCHES[k] for k in keys}
        got = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
        check(dev.type != "cuda" or all(_native.LAUNCHES[k] == before[k] + 1 for k in keys),
              f"the CE gradients {tag} did not launch {keys}")
        fused = softmax_lse._fused_on_the_card(m_, n_, d_)
        ref_g = softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=fused)
        rel_g = max(_max_rel(g, r) for g, r in zip(got, ref_g))
        limit = TC_RTOL if tensor_cores else CE_RTOL
        again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
        check(rel_g <= limit and all(bool(torch.equal(a, g)) for a, g in zip(again, got)),
              f"CE gradients {tag}: {rel_g} of the largest entry from their twin (limit {limit}), or other bits")
        check(not bool(got[0][~labelled].any()), f"CE gradients {tag}: an unlabelled row's ds is not 0")
        sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
        ce_lib = (F.cross_entropy(sg @ ig.T, y, reduction="none") * coeff).sum()
        name = "grads_z_pair" if split else "ce_grads"
        results[f"{name}_{tag}"] = dict(
            max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref_g)),
            ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3),
            plain_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff,
                                                                                  partials=fused), iters=1),
            library_ms=time_ms(lambda: torch.autograd.grad(ce_lib, (sg, ig), retain_graph=True), iters=3),
            **tc_bounds((2 * m_ * d_ + 2 * n_ * d_ + 3 * m_) * 4, 3 * products),
        )
        print(f"family kernels: {tag} loss at {m_} x {n_} x {d_} ({'3xTF32' if tensor_cores else 'SIMT'} tile, "
              f"{labelled.float().mean().item():.3f} of the rows labelled): lse "
              f"{results[f'lse_partials_fwd_{tag}']['ms']:.4f} ms, {rel:.3g} relative per row (limit {lse_limit}); CE "
              f"gradients through {keys} {results[f'{name}_{tag}']['ms']:.4f} ms, {rel_g:.3g} of the largest entry "
              f"(limit {limit}); bit-equal on a rerun")
        del s, items, lse, ref, z, got, ref_g, again, sg, ig, ce_lib
        torch.cuda.empty_cache()

    # BERT4Rec: labels on real items only (ids from 2: PAD and MASK never are targets)
    loss_case(b * SESSION_MAX_LEN, N_ITEM_IDS + 2, N_FACTORS, BERT4REC_LABEL_SHARE, 2, "bert4rec")
    loss_case(m, REMAT_SHAPE["n_item_ids"] + 1, rd, 0.8, 1, "remat_shape")
    return results


def step_turns(torch, np, runs: dict, turns: int = 5) -> dict:
    """Train steps of several fitted models in turns (``runs``: {name:
    (training module, device batch)}), after one warm-up step each: each
    step's wall (host clock, the device drained) and the peak of
    ``torch.cuda.max_memory_allocated`` over it (reset before it), absolute and
    above the memory allocated when it started."""
    stats = {name: {"ms": [], "peak": 0.0, "above": 0.0} for name in runs}
    for tm, batch in runs.values():
        tm._train_step(batch)
    for _ in range(turns):
        for name, (tm, batch) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tm._train_step(batch)
            torch.cuda.synchronize()
            stats[name]["ms"].append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            stats[name]["peak"] = max(stats[name]["peak"], peak / 2**20)
            stats[name]["above"] = max(stats[name]["above"], (peak - start) / 2**20)
    return {name: {"step_ms_median": float(np.median(r["ms"])), "step_ms": r["ms"], "step_peak_mib": r["peak"],
                   "step_peak_above_start_mib": r["above"]} for name, r in stats.items()}


def _params_apart(a, b) -> tuple:
    """(largest absolute difference, its parameter) between two backbones."""
    other = dict(b.named_parameters())
    return max(((p.detach() - other[n].detach()).abs().max().item(), n) for n, p in a.named_parameters())


ESASREC_FITS = {"positionwise": {}, "shared": {"negatives_sharing": "batch"},
                "shared_remat": {"negatives_sharing": "batch", "remat": True}}


def esasrec_phase(torch, np, port, dataset, dev) -> dict:
    """eSASRec at the KION width: three fits of EPOCHS epochs from the seed,
    with positionwise negatives, shared negatives, and shared negatives with
    remat. Launch counts (remat: the encoder's forward kernels once more a
    step), finite falling losses; the remat fit's losses and parameters equal
    the shared fit's (REMAT_RTOL, REMAT_ATOL); then one train step of the
    shared fits in turns, each step's wall and peak memory. The positionwise
    fit is returned under ``model`` for serving."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch

    results, models = {}, {}
    for name, kwargs in ESASREC_FITS.items():
        clock = epoch_clock(torch, dev)
        model = family_model(
            "esasrec", **TRAIN_CONFIG, epochs=EPOCHS, item_net_block_types=(IdEmbeddingsItemNet,),
            get_val_mask_func=hold_out_last, get_callbacks_func=lambda clock=clock: [clock],
            training_module_kwargs={"val_recall_k": K, **kwargs}, device=dev,
        )
        port.reset_launches()
        t0 = time.perf_counter()
        model.fit(dataset)
        fit_s = time.perf_counter() - t0
        launches = dict(port.LAUNCHES)
        tm = model.training_module
        check(not tm._use_fused_softmax and tm._shares_negatives == (name != "positionwise")
              and tm.remat == (name == "shared_remat"), f"esasrec {name}: the fit took another route")
        steps = tm.global_step
        forwards = steps + EPOCHS * len(model.data_preparator.get_dataloader_val())
        expected = expected_fit_launches(port, "esasrec", steps, forwards, loss_keys=(),
                                         recomputed=steps if tm.remat else 0)
        check(launches == expected, f"launches in esasrec {name} {launches}, expected {expected}")
        losses, val_losses = tm.train_loss_history, tm.val_loss_history
        recall = tm.val_metric_history.get(f"val_recall@{K}", [])
        check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()) and losses[1] < losses[0],
              f"esasrec {name}: train losses {losses}")
        check(len(val_losses) == EPOCHS and bool(np.isfinite(val_losses).all()) and len(recall) == EPOCHS,
              f"esasrec {name}: validation losses {val_losses}, val_recall@{K} {recall}")
        epoch2_s = clock.times[2] - clock.times[1]
        results[name] = {"launches": launches, "steps": steps, "train_loss": losses, "val_loss": val_losses,
                         f"val_recall@{K}": recall, "fit_s": fit_s, "epoch2_s": epoch2_s,
                         "train_examples_per_s": TRAIN_B * (steps // EPOCHS) / epoch2_s}
        models[name] = model
        print(f"esasrec train: {name}: {EPOCHS} epochs x {steps // EPOCHS} steps of {TRAIN_B} in {fit_s:.2f} s, "
              f"epoch 2 wall {epoch2_s:.3f} s, {results[name]['train_examples_per_s']:.0f} train examples/s; losses "
              f"{losses}, val_loss {val_losses}, val_recall@{K} {recall}; launches {launches}")
    shared, remat = results["shared"], results["shared_remat"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(remat["train_loss"] + remat["val_loss"],
                                                       shared["train_loss"] + shared["val_loss"]))
    param_err, worst = _params_apart(models["shared_remat"].backbone, models["shared"].backbone)
    print(f"esasrec remat: the remat fit against the shared fit: losses {loss_rel:.3g} relative, parameters "
          f"{param_err:.3g} ({worst})")
    check(loss_rel <= REMAT_RTOL and param_err <= REMAT_ATOL,
          f"esasrec remat: losses {loss_rel} relative / parameters {param_err} from the fit without remat")
    batch = pad_batch(next(iter(models["shared"].data_preparator.get_dataloader_train(np.random.default_rng(SEED)))),
                      TRAIN_B)
    turns = step_turns(torch, np, {name: (models[name].training_module,
                                          models[name].training_module._device_batch(batch))
                                   for name in ("shared", "shared_remat")})
    for name, stats in turns.items():
        results[name].update(stats)
        print(f"esasrec step: {name}: median {stats['step_ms_median']:.2f} ms of "
              f"{[round(t, 2) for t in stats['step_ms']]}, peak device memory over a step "
              f"{stats['step_peak_mib']:.0f} MiB "
              f"({stats['step_peak_above_start_mib']:.0f} MiB above its start)")
    fitted = {k: v.clone() for k, v in models["positionwise"].backbone.state_dict().items()}
    for name in ("positionwise", "shared"):
        tm = models[name].training_module
        device_batch = tm._device_batch(batch)
        print(f"esasrec step: {name}: profile of one train step")
        profile = profile_phase(torch, lambda: tm._train_step(device_batch))
        results[name].update({f"step_{k}": v for k, v in profile.items()})
    models["positionwise"].backbone.load_state_dict(fitted)  # served as fitted
    del models["shared"], models["shared_remat"]
    torch.cuda.empty_cache()
    return {"fits": results, "remat_loss_max_rel_diff": loss_rel, "remat_param_max_abs_diff": param_err,
            "model": models["positionwise"]}


def remat_fit_phase(torch, np, pd, port, dev) -> dict:
    """One epoch of SASRec at the remat shape (REMAT_SHAPE: B = 512, L = 200,
    d = 256, 8 heads, a 20,480-row catalog, full softmax) without and with
    ``remat=True``, from the seed's start: launch counts, the losses and
    parameters equal (REMAT_RTOL, REMAT_ATOL), each fit's peak memory and
    epoch wall, then one step of each in turns."""
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.models import SASRecModel
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch

    t0 = time.perf_counter()
    n_items = REMAT_SHAPE["n_item_ids"] + 1
    dataset = Dataset.construct(kion_frame(np, pd, Columns, REMAT_SHAPE["n_item_ids"]))
    print(f"remat fit: frame of {dataset.user_id_map.size} users over {REMAT_SHAPE['n_item_ids']} item ids built in "
          f"{time.perf_counter() - t0:.1f} s")
    d, l = REMAT_SHAPE["d"], REMAT_SHAPE["l"]
    # at 102,400 x 20,480 x 256 the CE gradients take the split route (kernels 13 and 14)
    loss_keys = ("lse_partials_fwd", "grads_z_ds", "grads_z_di")
    config = dict(n_blocks=N_BLOCKS, n_heads=REMAT_SHAPE["heads"], n_factors=d, session_max_len=l,
                  dropout_rate=DROPOUT, batch_size=TRAIN_B, lr=LR, loss="softmax", seed=SEED, epochs=1,
                  item_net_block_types=(IdEmbeddingsItemNet,))
    results, models = {}, {}
    for remat in (False, True):
        name = "remat" if remat else "plain"
        clock = epoch_clock(torch, dev)
        model = SASRecModel(**config, get_callbacks_func=lambda clock=clock: [clock],
                            training_module_kwargs={"remat": remat}, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        port.reset_launches()
        model.fit(dataset)
        launches = dict(port.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        tm = model.training_module
        check(model.backbone.item_model.n_items == n_items and tm._use_fused_softmax, f"remat fit {name}: route")
        steps = tm.global_step
        expected = expected_fit_launches(port, "sasrec", steps, steps, loss_keys=loss_keys,
                                         recomputed=steps if remat else 0)
        check(launches == expected, f"launches in the remat fit ({name}) {launches}, expected {expected}")
        losses = tm.train_loss_history
        check(len(losses) == 1 and bool(np.isfinite(losses).all()), f"remat fit {name}: losses {losses}")
        epoch_s = clock.times[1] - clock.times[0]
        results[name] = {"launches": launches, "steps": steps, "train_loss": losses, "epoch_s": epoch_s,
                         "train_examples_per_s": TRAIN_B * steps / epoch_s, "peak_device_mib": peak_mb}
        models[name] = model
        print(f"remat fit: {name}: 1 epoch x {steps} steps of {TRAIN_B} at L={l}, d={d}, {REMAT_SHAPE['heads']} heads, "
              f"{n_items} items in {epoch_s:.3f} s ({results[name]['train_examples_per_s']:.0f} train examples/s), "
              f"loss {losses}, peak device memory {peak_mb:.0f} MiB; launches {launches}")
    loss_rel = abs(results["remat"]["train_loss"][0] - results["plain"]["train_loss"][0]) / abs(
        results["plain"]["train_loss"][0])
    param_err, worst = _params_apart(models["remat"].backbone, models["plain"].backbone)
    print(f"remat fit: remat against plain: loss {loss_rel:.3g} relative, parameters {param_err:.3g} ({worst})")
    check(loss_rel <= REMAT_RTOL and param_err <= REMAT_ATOL,
          f"remat fit: loss {loss_rel} relative / parameters {param_err} from the fit without remat")
    batch = pad_batch(next(iter(models["plain"].data_preparator.get_dataloader_train(np.random.default_rng(SEED)))),
                      TRAIN_B)
    turns = step_turns(torch, np, {name: (model.training_module, model.training_module._device_batch(batch))
                                   for name, model in models.items()}, turns=3)
    for name, stats in turns.items():
        results[name].update(stats)
        print(f"remat step: {name}: median {stats['step_ms_median']:.2f} ms of "
              f"{[round(t, 2) for t in stats['step_ms']]}, peak device memory over a step "
              f"{stats['step_peak_mib']:.0f} MiB "
              f"({stats['step_peak_above_start_mib']:.0f} MiB above its start)")
    del models
    torch.cuda.empty_cache()
    return {**results, "loss_max_rel_diff": loss_rel, "param_max_abs_diff": param_err}


# ---------------------------------------------------------------- phase 16, bf16

PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores, data sheet
# H100 SXM: each multiprocessor's SFUs return 16 exps a clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), 132 multiprocessors at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# the bf16 forms against their twins on the card, which multiply the bf16 values in f32 (exact), so that only the
# order of the f32 sums differs and, where two f32 sums straddle a rounding boundary, a bf16 value lands one step
# (at most 2^-7 of itself) apart: kernel 6 relative per row; kernel 7 relative to the largest entry, ds 2^-6 (each
# of the 8 item chunks' bf16 partials may round a step apart, and the partials can exceed their sum: 2.6e-3 to
# 5.6e-3 on an H100 at these shapes) and di 2^-10 (f32 sums of probabilities that may round a step apart: up to 6.7e-5);
# kernels 2 and 5 relative to the largest entry of out, dq, dk and dv, one bf16 step (up to 1.8e-3 measured)
BF16_LSE_RTOL = 1e-6
BF16_DS_RTOL, BF16_DI_RTOL = 2 ** -6, 2 ** -10
BF16_ATTN_RTOL = 2 ** -7
BF16_LOSS_RTOL = 2e-2  # the bf16 fit's train losses against the f32 fit's, as the JAX package holds its bf16 loss
BF16_HIT_BAND = 0.03  # HitRate@10 on ~1,018 held-out last items: bf16 within 0.03 of f32 (two binomial sigmas)
BF16_KEYS = ("attention_fwd_bf16", "attention_bwd_bf16", "lse_partials_fwd_bf16", "ce_grads_fused_bf16")
# kernels 17-19 in bf16 against their twins, relative to the largest entry of out, dq, dk, dv, ds and its bucket
# sums: one bf16 step where a score's or da's f32 sum lands on the other side of a rounding boundary
BF16_STU_RTOL = 2 ** -7
STU_BF16_LAUNCH_KEYS = ("stu_fwd_bf16", "stu_bwd_bf16", "stu_bwd_dq_bf16", "stu_ds_bf16")
STU_F32_LAUNCH_KEYS = ("stu_fwd", "stu_fwd_simt", "stu_bwd", "stu_bwd_dq", "stu_ds")
# device kernels of a bf16 train step: each bf16 form, and nothing of the f32 attention or loss kernels or of a
# library attention or cross-entropy
CE_BF16_ENGINE_KERNEL = "ce_grads_bf16_kernel"  # kernel 7's and 12's bf16 forms (csrc/ce_grads_bf16.cu)
# softmax_lse_bf16.cu's kernels that ran kernel 7's bf16 forms before the engine (9, 10, 12-14 keep them)
CE_BF16_OLD_KERNELS = ("ce_fused_bf16_kernel", "split_ds_bf16_kernel", "split_di_bf16_kernel")
CE_BF16_LAUNCH_REGS = 168  # the engine's registers a thread at launch, which setmaxnreg redistributes
# kernel 7's bf16 forms on those kernels at 51,200 session rows, by (form, D, items): ms on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md section 6, the kernel table's bracketed times)
CE_BF16_OLD_MS = {("one_pass", 128, 15872): 6.3503, ("one_pass", 256, 15872): 16.3567, ("one_pass", 16, 15872): 2.2980,
                  ("two_launches", 128, 15872): 7.3662, ("two_launches", 128, 65536): 29.4117,
                  ("two_launches", 256, 15872): 13.1909, ("two_launches", 16, 15872): 2.5259}
# kernel 12's bf16 one pass on softmax_lse_bf16.cu's one-pass kernel (its kZ form) at 51,200 x 15,872, by D: ms on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6, the kernel table's bracketed times)
GRADS_Z_BF16_OLD_MS = {128: 6.1004, 256: 16.2336, 16: 2.1839}
# kernel 2's bf16 forward (csrc/attention_bf16.cu: every score formed once, in its rows or tiles mode), and the
# two-pass kernel it replaced, which no step may launch
ATTN_BF16_FWD_KERNEL, ATTN_BF16_OLD_FWD_KERNEL = "attn_fwd_onepass_bf16_kernel", "attn_fwd_bf16_kernel"
# that form's times before (CUDA events a call, dropout 0.2, B = 512, L = 100) by (head dim, bias) on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6, the kernel table's bracketed times); heads of 64 and 16 had none
ATTN_BF16_OLD_MS = {(32, "causal"): 0.2567, (32, "bidirectional"): 0.2959, (8, "causal"): 0.1629,
                    (8, "bidirectional"): 0.2207}
BF16_DEVICE_KERNELS = (ATTN_BF16_FWD_KERNEL, "attn_bwd_bf16_kernel", "lse_partials_bf16_kernel",
                       CE_BF16_ENGINE_KERNEL)
# a bf16 mesh step's: kernel 8 (kernel 6's kernel with the bias) and kernel 9 (the one pass of softmax_lse_bf16.cu
# in its kLse form) in place of kernels 6 and 7
BF16_MESH_DEVICE_KERNELS = (ATTN_BF16_FWD_KERNEL, "attn_bwd_bf16_kernel", "lse_partials_bf16_kernel",
                            "ce_fused_bf16_kernel")
BF16_BANNED_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel", "attn_fwd_tc", "attn_bwd_tc", "lse_partials_tc",
                       "lse_chunk", "lse_bwd_fused", "grad_ds", "grad_di", "fmha", "flash", "attention_kernel",
                       "cross_entropy", "nll_loss", "log_softmax", "softmax_warp", ATTN_BF16_OLD_FWD_KERNEL)
# the same for a bf16 HSTU step: the bf16 STU kernels (18's two launches) and loss forms, none of the f32 STU
# kernels (tensor-core or SIMT)
BF16_HSTU_DEVICE_KERNELS = ("stu_fwd_bf16_kernel", "stu_dkdv_bf16_kernel", "stu_dq_bf16_kernel", "stu_ds_bf16_kernel",
                            "lse_partials_bf16_kernel", CE_BF16_ENGINE_KERNEL)
BF16_HSTU_BANNED_KERNELS = ("stu_fwd_tc_kernel", "stu_fwd_kernel", "stu_dkdv_tc_kernel", "stu_dq_tc_kernel",
                            "stu_ds_tc_kernel", "stu_bwd_kernel", "stu_ds_kernel", *BF16_BANNED_KERNELS)


def bf16_step_kernels(names, wanted, banned_keys) -> tuple:
    """(missing, banned) of a bf16 step's device kernel ``names``: each of
    ``wanted`` and of LayerNorm's bf16 forms (``ln_fwd_kernel``,
    ``ln_bwd_kernel`` on ``__nv_bfloat16``) that no name holds, and each name
    that holds one of ``banned_keys`` or is an f32 LayerNorm kernel."""
    norms = [name for name in names if "ln_fwd_kernel" in name or "ln_bwd_kernel" in name]
    missing = [k for k in wanted if not any(k in name for name in names)]
    missing += [f"{k} (bf16)" for k in ("ln_fwd_kernel", "ln_bwd_kernel")
                if not any(k in name and "bfloat16" in name for name in norms)]
    banned = [name for name in names
              if any(k in name for k in banned_keys) or (name in norms and "bfloat16" not in name)]
    return missing, banned


# kernels 8-11 in bf16 (the mesh loss on bf16 towers) against their twins: the lse relative per row (BF16_LSE_RTOL);
# ds and di (f32, the autograd functions round them to bf16 after) relative to the twin's largest entry, where a pw,
# p or s * dlse one bf16 step apart (its f32 value straddling a rounding boundary) moves a sum: up to 1.2e-3 on an
# H100 at the training shape (rectools_tpu_torch/tools/mesh_bf16_check.py)
BF16_MESH_GRAD_RTOL = 2 ** -7
MESH_BF16_KEYS = ("lse_bias_fwd_bf16", "lse_bwd_fused_bf16", "lse_bwd_ds_bf16", "lse_bwd_di_bf16")
# the four-rank bf16 epoch against the single-process bf16 fit of the same batches through the same loss route
# (``mesh_shape=(1, 1)``): the bf16 roundings of the shards' ds and di sums differ (ds summed over the model group
# in bf16, the tower gradient over the data group in f32). Losses within a quarter of the bf16 band (BF16_LOSS_RTOL);
# every parameter entry within 2 x steps x lr (Adam moves an entry whose bf16 gradient is rounding noise by up to lr
# a step on each side) and their mean within 3e-5 a step (the rule of tests/test_torch_parallel.py); the
# key-projection biases, whose gradient is rounding noise in either dtype, are printed beside them
MESH_4_BF16_LOSS_RTOL, MESH_4_BF16_PARAM_MEAN_A_STEP = 5e-3, 3e-5


def bf16_bound(n_bytes: float, n_ops: float, n_exps: float = 0) -> tuple:
    """(ms, "bytes" or "operations"): the bytes over the memory rate, or the
    operations: the products over the bf16 tensor-core rate or the ``n_exps``
    exponentials over the SFUs' rate, whichever is longer (the exps rule at D =
    16, where a logit is one 16-deep product)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_ops / PEAK_BF16_FLOP_PER_S, n_exps / SFU_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_line(name: str, r: dict) -> None:
    print(f"bf16 kernels: {name}: max_rel_err={r['max_rel_err']:.3g} ms={r['ms']:.4f} f32_ms={r['f32_ms']:.4f} "
          f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (bf16) bound_ms={r['bound'][0]:.4f} "
          f"({r['bound'][1]}, 989 TFLOP/s bf16, 3.35 TB/s)")
    if "design_floor" in r:  # kernel 7's engine (kernels 7 and 12): its own floor and the form it replaced
        print(f"bf16 kernels: {name}: kernel 7's engine {r['ms']:.4f} ms beside its design's floor "
              f"{r['design_floor'][0]:.4f} ms (four products and two exps a logit, {r['design_floor'][1]}), the "
              f"function's bound {r['bound'][0]:.4f} ms (three products), the library call {r['library_ms']:.4f} ms "
              f"and the form before it {r['old_ms']} ms (PERF.md section 6)")


def ce_bf16_design_floor(n_bytes: float, products: float, exps: float) -> tuple:
    """Kernel 7's bf16 engine's floor: four products (the logits once in
    each role) and two exps a logit where the function needs three and one."""
    return bf16_bound(n_bytes, 4 * products, 2 * exps)


def _attention_bf16_case(torch, F, attention, gen, dev, b: int, l: int, h: int, dh: int, bias, tag: str) -> dict:
    """Kernels 2 (with dropout) and 5 in bf16 at (b, h, l, dh) under ``bias``
    against their twins (BF16_ATTN_RTOL, the same bits on a rerun), timed beside
    the f32 forms on the same values, bf16 SDPA and its autograd, and the bound
    of the pairs the bias lets through; kernel 2 also without dropout, on the
    device (torch.profiler: its one kernel, ATTN_BF16_FWD_KERNEL) beside SDPA's
    kernels, and beside the two-pass form's time (ATTN_BF16_OLD_MS)."""
    bf = torch.bfloat16
    q, k, v, dout = (torch.randn((b, l, h, dh), generator=gen, device=dev).to(bf).transpose(1, 2) for _ in range(4))
    scale, seed = 1.0 / math.sqrt(dh), 192837465
    out, lse = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    ref_out, ref_lse = attention.attention_bf16_reference(q, k, v, bias, scale, DROPOUT, seed)
    check(out.dtype == bf and lse.dtype == torch.float32, f"attention bf16 {tag}: out {out.dtype}, lse {lse.dtype}")
    # the lse of the rounded scores, per row relative to max(|lse|, 1): a score one step apart moves it by that step
    err_lse = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
    err_fwd = max(_max_rel(out.float(), ref_out.float()), err_lse)
    again = attention.attention_fwd(q, k, v, bias, scale, DROPOUT, seed)
    check(err_fwd <= BF16_ATTN_RTOL and bool(torch.equal(again[0], out) and torch.equal(again[1], lse)),
          f"attention forward bf16 {tag}: {err_fwd} from the twin (limit {BF16_ATTN_RTOL}), or other bits on a rerun")
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    got = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    ref = attention.attention_bwd_bf16_reference(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    err_bwd = max(_max_rel(a.float(), r.float()) for a, r in zip(got, ref))
    again = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)
    check(err_bwd <= BF16_ATTN_RTOL and all(bool(torch.equal(a, g)) for a, g in zip(again, got)),
          f"attention backward bf16 {tag}: {err_bwd} from the twin (limit {BF16_ATTN_RTOL}), or other bits on a "
          "rerun")
    live = int((bias > -1e8).sum().item()) * (b // bias.shape[0]) * h
    flops = live * dh
    q32, k32, v32, dout32 = (t.float() for t in (q, k, v, dout))
    out32, lse32 = attention.attention_fwd(q32, k32, v32, bias, scale, DROPOUT, seed)
    delta32 = (dout32 * out32).sum(-1).contiguous()
    mask = bias.to(bf)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
    fwd = {rate: (lambda r=rate: attention.attention_fwd(q, k, v, bias, scale, r, seed)) for rate in (DROPOUT, 0.0)}
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)  # noqa: E731
    # a call's device kernels: the one-pass forward once a call, and no other attention kernel
    # (a form of which no capture kept a record has no device time; one of the two must show the kernel: while
    # neither does, both are captured again over more calls, up to 20)
    for calls in (5, 10, 20):
        device = {rate: {n: c for n, c in device_kernels(torch, fn, calls).items() if "attn" in n or "attention" in n}
                  for rate, fn in fwd.items()}
        if any(device.values()):
            break
    for rate, kernels in device.items():
        check(not torch.cuda.is_available() or not kernels or (len(kernels) == 1 and all(
            ATTN_BF16_FWD_KERNEL in n and launches == 1 for n, (launches, _) in kernels.items())),
              f"attention forward bf16 {tag}, dropout {rate}: device kernels {kernels}")
    check(not torch.cuda.is_available() or any(device.values()),
          f"attention forward bf16 {tag}: the profiler kept no record of it at either dropout rate")
    # SDPA's device time, from a capture that holds each of its kernels a whole number of times a call, else none
    library = device_kernels(torch, sdpa, 5)
    whole = bool(library) and all(n >= 1 and float(n).is_integer() for n, _ in library.values())
    results = {
        f"attention_fwd_bf16_{tag}": dict(
            max_abs_err=(out.float() - ref_out.float()).abs().max().item(), max_rel_err=err_fwd,
            ms=time_ms(fwd[DROPOUT]), ms_dropout_0=time_ms(fwd[0.0]),
            device_ms=sum(n * ms for n, ms in device[DROPOUT].values()) if device[DROPOUT] else None,
            device_ms_dropout_0=sum(n * ms for n, ms in device[0.0].values()) if device[0.0] else None,
            f32_ms=time_ms(lambda: attention.attention_fwd(q32, k32, v32, bias, scale, DROPOUT, seed)),
            plain_ms=time_ms(lambda: attention.attention_bf16_reference(q, k, v, bias, scale, DROPOUT, seed),
                             iters=3),
            library_ms=time_ms(sdpa),
            library_device_ms=sum(n * ms for n, ms in library.values()) if whole else None,
            bound=bf16_bound(4 * q.numel() * 2 + lse.numel() * 4 + bias.numel() * 4, 4 * flops),
        ),
        f"attention_bwd_bf16_{tag}": dict(
            max_abs_err=max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref)),
            max_rel_err=err_bwd,
            ms=time_ms(lambda: attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, DROPOUT, seed)),
            f32_ms=time_ms(lambda: attention.attention_bwd(q32, k32, v32, bias, lse32, delta32, dout32, scale,
                                                           DROPOUT, seed)),
            plain_ms=time_ms(lambda: attention.attention_bwd_bf16_reference(q, k, v, bias, lse, delta, dout, scale,
                                                                            DROPOUT, seed), iters=3),
            library_ms=time_ms(lambda: torch.autograd.grad(out_lib, (qg, kg, vg), dout, retain_graph=True)),
            bound=bf16_bound(7 * q.numel() * 2 + 2 * lse.numel() * 4 + bias.numel() * 4, 10 * flops),
        ),
    }
    for name, r in results.items():
        _bf16_line(f"{name} (B={b}, H={h}, L={l}, dh={dh}, dropout {DROPOUT})", r)
    r = results[f"attention_fwd_bf16_{tag}"]
    old_ms = ATTN_BF16_OLD_MS.get((dh, "causal" if "causal" in tag else "bidirectional"))
    old_ms = "not measured" if old_ms is None else f"{old_ms} ms"
    lib_device, dev_ms, dev_ms_0 = ("not measured" if r[k] is None else f"{r[k]:.4f}"
                                    for k in ("library_device_ms", "device_ms", "device_ms_dropout_0"))
    print(f"bf16 kernels: attention_fwd_bf16_{tag}: {r['ms']:.4f} ms a call with dropout {DROPOUT} "
          f"({dev_ms} on the device), {r['ms_dropout_0']:.4f} without ({dev_ms_0}); "
          f"bf16 SDPA (no dropout) {r['library_ms']:.4f} a call ({lib_device} on the device); the two-pass form "
          f"before it {old_ms} (PERF.md section 6); bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return results


def bert4rec_bias(torch, gen, dev, b: int, l: int):
    """BERT4Rec's (B, 1, L, L) attention bias from the backbone's own rule (key
    padding, no causal mask, the diagonal kept) over left-padded sessions of
    drawn lengths (one of length 1, one full)."""
    import types

    from rectools_tpu_torch.models.nn.transformers import TransformerBackbone

    lengths = torch.randint(1, 301, (b,), generator=gen, device=dev).clamp(max=l)
    lengths[0], lengths[1] = 1, l
    sessions = torch.where(torch.arange(l, device=dev)[None, :] >= l - lengths[:, None], 1, 0)
    rule = types.SimpleNamespace(use_causal_attn=False, use_key_padding_mask=True)
    return TransformerBackbone._build_attn_bias(rule, sessions)


def bf16_kernel_phase(torch, dev, b: int = TRAIN_B, d: int = N_FACTORS) -> dict:
    """(a) of the ``bf16`` phase: the bf16 forms of kernels 6 and 7 at 51,200 x
    15,872 x 128 (x ``d``: then their result keys end in ``_d{d}`` and the
    attention cases are left out) and of kernels 2 and 5 at B = 512, H = 4, L =
    100, heads of 32, causal with dropout and under BERT4Rec's bias, each
    against its twin on the card, the same bits on a rerun, timed beside its
    f32 form, the library call in bf16 and its bound at the bf16 rate (kernel
    7 also beside its engine's floor and the form it replaced); kernels 6 and
    7 also at the odd catalog (checked)."""
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import attention, softmax_lse

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 16 + d)
    m, n = b * SESSION_MAX_LEN, N_ITEM_IDS + 1
    sfx = width_suffix(d)
    products, exps = 2 * m * n * d, m * n
    s = torch.randn((m, d), generator=gen, device=dev).to(bf)
    items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).to(bf)
    s32, items32 = s.float(), items.float()
    results = {}

    # kernel 6
    lse = softmax_lse.streaming_lse(s, items)
    ref = softmax_lse.streaming_lse_bf16_reference(s, items)
    err = _row_rel(lse, ref)
    check(err <= BF16_LSE_RTOL and bool(torch.equal(lse, softmax_lse.streaming_lse(s, items))),
          f"kernel 6 bf16 at D={d}: {err} per row from its twin (limit {BF16_LSE_RTOL}), or other bits on a rerun")
    n_chunks = -(-n // softmax_lse.LSE_CHUNK)
    results[f"lse_partials_fwd_bf16{sfx}"] = dict(
        max_abs_err=(lse - ref).abs().max().item(), max_rel_err=err,
        ms=time_ms(lambda: softmax_lse.streaming_lse(s, items)),
        f32_ms=time_ms(lambda: softmax_lse.streaming_lse(s32, items32)),
        plain_ms=time_ms(lambda: softmax_lse.streaming_lse_bf16_reference(s, items), iters=3),
        library_ms=time_ms(lambda: torch.logsumexp(s @ items.T, dim=1), iters=3),
        bound=bf16_bound((m + n) * d * 2 + 2 * n_chunks * m * 4, products, exps),
    )

    # kernel 7, from the lse: PAD rows (coeff 0) and labelled rows
    y = torch.randint(1, n, (m,), generator=gen, device=dev)
    y[torch.rand((m,), generator=gen, device=dev) < 0.1] = 0
    coeff = torch.where(y == 0, 0.0, 1.0 / float((y != 0).sum()))
    z = lse - torch.log(coeff)
    check(not softmax_lse.ce_takes_split_route(m, n, d, bf)
          and softmax_lse._fused_on_the_card(m, n, d, softmax_lse._ds_itemsize(bf), bf),
          f"bf16 CE gradients at the training shape, D={d}, leave kernel 7's one pass")
    got = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    ref = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff)
    rel_ds, rel_di = _max_rel(got[0], ref[0]), _max_rel(got[1], ref[1])
    rel = max(rel_ds, rel_di)
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    rerun = all(bool(torch.equal(a, g)) for a, g in zip(again, got))
    check(rel_ds <= BF16_DS_RTOL and rel_di <= BF16_DI_RTOL and rerun,
          f"kernel 7 bf16 at D={d}: ds {rel_ds}, di {rel_di} of the largest entry from its twin (limits "
          f"{BF16_DS_RTOL}, {BF16_DI_RTOL}), or other bits on a rerun")
    print(f"bf16 kernels: kernel 7 at D={d} ds {rel_ds:.3g}, di {rel_di:.3g} of the largest entry from the twin "
          f"(limits {BF16_DS_RTOL}, {BF16_DI_RTOL}); bit-equal on a rerun")
    sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
    ce_lib = (F.cross_entropy(sg @ ig.T, y, reduction="none").float() * coeff).sum()
    ce_bytes = (m + n) * d * 2 + m * 16 + (m + n) * d * 4
    results[f"ce_grads_fused_bf16{sfx}"] = dict(
        max_abs_err=max((a - r).abs().max().item() for a, r in zip(got, ref)), max_rel_err=rel,
        ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), iters=3),
        f32_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s32, items32, z, y, coeff), iters=3),
        plain_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff), iters=3),
        library_ms=time_ms(lambda: torch.autograd.grad(ce_lib, (sg, ig), retain_graph=True), iters=3),
        bound=bf16_bound(ce_bytes, 3 * products, exps), design_floor=ce_bf16_design_floor(ce_bytes, products, exps),
        old_ms=CE_BF16_OLD_MS.get(("one_pass", d, n)),
    )
    del sg, ig, ce_lib, again
    # both at the odd catalog, where every item tile leaves a tail (checked, not timed)
    rows, y_ragged = items[:RAGGED_N], torch.where(y < RAGGED_N, y, 0)
    lse_ragged = softmax_lse.streaming_lse(s, rows)
    err_ragged = _row_rel(lse_ragged, softmax_lse.streaming_lse_bf16_reference(s, rows))
    z_ragged = lse_ragged - torch.log(coeff)
    got_r = softmax_lse.softmax_ce_grads_from_z(s, rows, z_ragged, y_ragged, coeff)
    ref_r = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, rows, z_ragged, y_ragged, coeff)
    rel_r = [_max_rel(g, r) for g, r in zip(got_r, ref_r)]
    check(err_ragged <= BF16_LSE_RTOL and rel_r[0] <= BF16_DS_RTOL and rel_r[1] <= BF16_DI_RTOL,
          f"kernels 6 / 7 bf16 at N={RAGGED_N}, D={d}: {err_ragged} / {rel_r} from their twins")
    print(f"bf16 kernels: at N={RAGGED_N}, D={d}, kernel 6 {err_ragged:.3g} per row, kernel 7 ds {rel_r[0]:.3g}, di "
          f"{rel_r[1]:.3g} of the largest entry from their twins")
    for name in ("lse_partials_fwd_bf16", "ce_grads_fused_bf16"):
        _bf16_line(f"{name} (M={m}, N={n}, D={d})", results[name + sfx])
    del s, items, s32, items32, lse, ref, got, rows, y_ragged, lse_ragged, z_ragged, got_r, ref_r
    torch.cuda.empty_cache()
    if d != N_FACTORS:
        return results

    # kernels 2 and 5: causal with dropout, and BERT4Rec's bias from the backbone's own rule
    l, h, dh = SESSION_MAX_LEN, N_HEADS, N_FACTORS // N_HEADS
    causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    results.update(_attention_bf16_case(torch, F, attention, gen, dev, b, l, h, dh, causal, "causal"))
    bias = bert4rec_bias(torch, gen, dev, b, l)
    results.update(_attention_bf16_case(torch, F, attention, gen, dev, b, l, h, dh, bias, "bidirectional"))
    for name in ("attention_fwd_bf16", "attention_bwd_bf16"):
        results[name] = results[f"{name}_causal"]
    torch.cuda.empty_cache()
    return results


def _stu_bf16_case(torch, F, gen, dev, b: int, l: int, tag: str, d: int = N_FACTORS // N_HEADS) -> dict:
    """Kernels 17-19's bf16 launches at (b, H, l) with heads of ``d``, both biases,
    the causal mask and a timeline whose last row is padding, as the HSTU layer
    gives them: against their twins (BF16_STU_RTOL), one launch each and none
    of the f32 forms, the padded row zeros, the same bits on a rerun; timed
    beside the f32 forms on the same values, the twins, the library call in
    bf16 (einsum, SiLU, mask, einsum; its autograd; for 19 autograd to the
    bias, then ``index_add_``) and the bound at 989 TFLOP/s bf16."""
    from rectools_tpu_torch.ops import _native, stu_attention

    bf = torch.bfloat16
    h = N_HEADS
    q32, k32, v32, dout32, bias, allowed, timeline, buckets = _stu_case(torch, dev, gen, b, l, d=d)
    q, k, v, dout = (t.to(bf) for t in (q32, k32, v32, dout32))  # the layer's (B, L, H, d) memory, in bf16
    del q32, k32, v32, dout32
    args = (q, k, v, bias, allowed, timeline)
    args32 = (q.float(), k.float(), v.float(), bias, allowed, timeline)
    n_entries = NUM_BUCKETS + 1
    what = f"at B={b}, L={l}, ad=lh={d}"
    before = dict(_native.LAUNCHES)
    out = stu_attention.stu_fwd(*args)
    got = stu_attention.stu_bwd(*args, dout)
    ds = stu_attention.stu_ds(*args, dout, buckets, n_entries)
    launched = [_native.LAUNCHES[key] - before[key] for key in (*STU_BF16_LAUNCH_KEYS, *STU_F32_LAUNCH_KEYS)]
    check(launched == [1, 1, 1, 1, 0, 0, 0, 0, 0], f"stu bf16 {what}: launches {launched}")
    check(out.dtype == bf and all(g.dtype == bf for g in got) and ds[0].dtype == torch.float32,
          f"stu bf16 {what}: dtypes")
    errors, abs_errors = {}, {}
    for name, g, e in zip(("out", "dq", "dk", "dv", "ds", "bucket sums"), (out, *got, *ds),
                          (stu_attention.stu_bf16_reference(*args), *stu_attention.stu_bwd_bf16_reference(*args, dout),
                           *stu_attention.stu_ds_bf16_reference(*args, dout, buckets, n_entries))):
        check(bool(torch.isfinite(g.float()).all()), f"stu bf16 {name} {what}: not finite")
        errors[name], abs_errors[name] = _max_rel(g.float(), e.float()), (g.float() - e.float()).abs().max().item()
    check(max(errors.values()) <= BF16_STU_RTOL, f"stu bf16 {what}: {errors} of the largest entry from the twins "
          f"(limit {BF16_STU_RTOL})")
    check(not any(bool(g[-1].any()) for g in (out, *got, ds[0])), f"stu bf16 {what}: the padded row is not zeros")
    again = (stu_attention.stu_fwd(*args), *stu_attention.stu_bwd(*args, dout),
             *stu_attention.stu_ds(*args, dout, buckets, n_entries))
    check(all(bool(torch.equal(a, g)) for a, g in zip(again, (out, *got, *ds))),
          f"stu bf16 {what}: a second run gave other bits")
    print(f"stu bf16 kernels {what}: of the largest entry from the twins "
          f"{ {n: float(f'{e:.3g}') for n, e in errors.items()} } (limit {BF16_STU_RTOL}); launches {launched[:4]}, "
          "no f32 STU launch; the padded row zeros; bit-equal on a second run")
    del again, got, ds

    def library(q, k, v, bias):
        """The materialized form in bf16: one einsum, SiLU and mask over (B, H, L, L), one einsum."""
        mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None].to(bf)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
        return torch.einsum("bhqk,bhkd->bhqd", F.silu(s) / l * mask, v)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias.to(bf))]
    lib_out = library(*leaves)

    def library_ds() -> tuple:
        """Autograd to the bias, then ``index_add_`` by bucket (float atomics)."""
        (dbias,) = torch.autograd.grad(lib_out, leaves[3:], dout, retain_graph=True)
        sums = torch.zeros(n_entries, device=dev)
        return dbias, sums.index_add_(0, buckets.reshape(-1), dbias.reshape(-1).float())

    iters = 10 if b * l <= TRAIN_B * SESSION_MAX_LEN else 3
    n_pairs = h * (allowed * timeline[:, :, None] * timeline[:, None, :]).sum().item()
    qkv_bytes = 4 * 2 * b * h * l * d  # q, k, v and one of out / dout, bf16
    mask_bytes = (bias.numel() + allowed.numel() + timeline.numel()) * 4
    n_partials = b * math.ceil(l / stu_attention.BWD_TILE) ** 2
    dout32 = dout.float()
    results = {
        f"stu_fwd_bf16{tag}": dict(
            max_abs_err=abs_errors["out"], max_rel_err=errors["out"],
            ms=time_ms(lambda: stu_attention.stu_fwd(*args), iters=iters),
            f32_ms=time_ms(lambda: stu_attention.stu_fwd(*args32), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_bf16_reference(*args), iters=3),
            library_ms=time_ms(lambda: library(q, k, v, leaves[3].detach()), iters=iters),
            bound=bf16_bound(qkv_bytes + mask_bytes, 2 * n_pairs * 2 * d),
        ),
        f"stu_bwd_bf16{tag}": dict(  # both launches: dk and dv, then dq
            max_abs_err=max(abs_errors[n] for n in ("dq", "dk", "dv")),
            max_rel_err=max(errors[n] for n in ("dq", "dk", "dv")),
            ms=time_ms(lambda: stu_attention.stu_bwd(*args, dout), iters=iters),
            f32_ms=time_ms(lambda: stu_attention.stu_bwd(*args32, dout32), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_bwd_bf16_reference(*args, dout), iters=3),
            library_ms=time_ms(lambda: torch.autograd.grad(lib_out, leaves[:3], dout, retain_graph=True), iters=iters),
            bound=bf16_bound(qkv_bytes + 3 * 2 * b * h * l * d + mask_bytes, 2 * n_pairs * 5 * d),
        ),
        f"stu_ds_bf16{tag}": dict(
            max_abs_err=max(abs_errors["ds"], abs_errors["bucket sums"]),
            max_rel_err=max(errors["ds"], errors["bucket sums"]),
            ms=time_ms(lambda: stu_attention.stu_ds(*args, dout, buckets, n_entries), iters=iters),
            f32_ms=time_ms(lambda: stu_attention.stu_ds(*args32, dout32, buckets, n_entries), iters=iters),
            plain_ms=time_ms(lambda: stu_attention.stu_ds_bf16_reference(*args, dout, buckets, n_entries), iters=3),
            library_ms=time_ms(library_ds, iters=iters),
            # reads the buckets too; writes ds, the per-block partials and their sum
            bound=bf16_bound(qkv_bytes + mask_bytes + 2 * bias.numel() * 4 + (n_partials + 1) * n_entries * 4,
                             2 * n_pairs * 2 * d + bias.numel()),
        ),
    }
    for name, r in results.items():
        _bf16_line(f"{name} (B={b}, H={h}, L={l}, ad=lh={d}, time and position biases)", r)
    return results


def stu_bf16_kernel_phase(torch, dev, b: int = TRAIN_B) -> dict:
    """(a) of the ``bf16`` phase for HSTU: the bf16 forms of kernels 17-19 at
    the training shape (B = 512, H = 4, L = 100, heads of 32) and at B = 64, L =
    1,024 (``_long_ctx``)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    results = _stu_bf16_case(torch, F, gen, dev, b, SESSION_MAX_LEN, "")
    torch.cuda.empty_cache()
    results.update(_stu_bf16_case(torch, F, gen, dev, LONG_CTX["b"], LONG_CTX["l"], "_long_ctx"))
    torch.cuda.empty_cache()
    return results


def mesh_bf16_kernel_phase(torch, dev, b: int = TRAIN_B, d: int = N_FACTORS) -> dict:
    """(a) of the ``bf16`` phase for the mesh loss: the bf16 forms of kernels
    8-11 at the shapes ``mesh_kernel_phase`` gives their f32 forms (the (1, 1)
    mesh's 51,200 x 15,872; a (2, 2) shard 25,600 x 7,936; the last shard of
    the odd catalog cut four ways, one row of it biased -1e30; at another
    width ``d`` the first two, their result keys with ``_d{d}``), with a
    cotangent of mixed sign: each against its twin, the same bits on a rerun,
    kernel 8's bits against kernel 6's bf16 form at a zero bias, timed beside
    its f32 form on the same values, the library call (``torch.logsumexp`` of
    the bf16 product plus the bias, and its autograd) and its bound at the
    bf16 rate."""
    from rectools_tpu_torch.ops import _native, softmax_lse

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 22 + d)
    l, n = SESSION_MAX_LEN, N_ITEM_IDS + 1
    sfx = width_suffix(d)
    ragged_shard = -(-RAGGED_N // 4)
    shapes = {"": (b * l, n, 0), "_shard_2x2": (b * l // 2, n // 2, 0)}
    if d == N_FACTORS:
        shapes["_ragged_shard"] = (b * l // 2, ragged_shard, 4 * ragged_shard - RAGGED_N)
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    results = {}
    for tag, (m, rows, n_invalid) in shapes.items():
        s = torch.randn((m, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((rows, d), generator=gen, device=dev)).to(bf)
        bias = torch.zeros((rows,), device=dev)
        if n_invalid:
            items[rows - n_invalid:] = 0.0  # the zero rows a shard is padded with
            bias[rows - n_invalid:] = softmax_lse.NEG_BIG
        dlse = torch.randn((m,), generator=gen, device=dev) / m  # mixed sign
        s32, items32 = s.float(), items.float()
        what = f"at M={m}, N={rows}, D={d}" + (f" with {n_invalid} invalid row(s)" if n_invalid else "")

        # kernel 8
        lse = softmax_lse.streaming_lse_fwd(s, items, bias)
        ref = softmax_lse.streaming_lse_bias_bf16_reference(s, items, bias)
        err = _row_rel(lse, ref)
        check(bool(torch.isfinite(lse).all()) and err <= BF16_LSE_RTOL
              and bool(torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items, bias))),
              f"kernel 8 bf16 {what}: {err} per row from its twin (limit {BF16_LSE_RTOL}), or other bits on a rerun")
        if not n_invalid:  # kernel 8 is kernel 6 with a bias column
            check(bool(torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items))),
                  f"kernel 8 bf16 {what}: a zero bias changed the bits of kernel 6's bf16 form")
        lse32 = softmax_lse.streaming_lse_fwd(s32, items32, bias)
        products, exps = 2 * m * rows * d, m * rows
        vectors = (rows + 2 * m) * 4
        results[f"lse_bias_fwd_bf16{sfx}{tag}"] = dict(
            max_abs_err=(lse - ref).abs().max().item(), max_rel_err=err,
            ms=time_ms(lambda: softmax_lse.streaming_lse_fwd(s, items, bias)),
            f32_ms=time_ms(lambda: softmax_lse.streaming_lse_fwd(s32, items32, bias)),
            plain_ms=time_ms(lambda: softmax_lse.streaming_lse_bias_bf16_reference(s, items, bias), iters=3),
            library_ms=time_ms(lambda: torch.logsumexp(s @ items.T + bias, dim=1), iters=3),
            bound=bf16_bound((m + rows) * d * 2 + rows * 4 + m * 4, products, exps),
        )

        # kernels 9 and 10 + 11
        got, refs = {}, {}
        for route, forced in (("fused", 1 << 62), ("split", 0)):
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = forced
            got[route] = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
            again = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
            refs[route] = softmax_lse.streaming_lse_bwd_bf16_reference(s, items, bias, lse, dlse,
                                                                       partials=route == "fused")
            rel_ds, rel_di = (_max_rel(g, r) for g, r in zip(got[route], refs[route]))
            rerun = all(bool(torch.equal(a, g)) for a, g in zip(again, got[route]))
            check(all(bool(torch.isfinite(g).all()) for g in got[route]) and max(rel_ds, rel_di) <= BF16_MESH_GRAD_RTOL
                  and rerun, f"lse backward bf16 ({route}) {what}: ds {rel_ds}, di {rel_di} of the largest entry from "
                             f"its twin (limit {BF16_MESH_GRAD_RTOL}), or other bits on a rerun")
            if n_invalid:
                check(not bool(got[route][1][rows - n_invalid:].any()),
                      f"lse backward bf16 ({route}) {what}: an invalid row's gradient is not exactly 0")
            print(f"bf16 mesh kernels: lse backward ({route}) {what}: ds {rel_ds:.3g}, di {rel_di:.3g} of the largest "
                  f"entry from its twin (limit {BF16_MESH_GRAD_RTOL:.3g}), bit-equal on a rerun")
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62
        fused_ms = time_ms(lambda: softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse), iters=3)
        fused_f32_ms = time_ms(lambda: softmax_lse.streaming_lse_bwd(s32, items32, bias, lse32, dlse), iters=3)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        # each split kernel alone, bf16 and f32, through the library handles (ds with the sum of its chunk partials
        # over each dtype's plan)
        out_di = torch.empty((rows, d), device=dev)
        split_ms = {"ds": 0.0, "di": 0.0, "ds_f32": 0.0, "di_f32": 0.0}
        if dev.type == "cuda":
            stream = _native.current_stream_ptr(s.device)
            for suffix, lib, towers in (("", _native.load("softmax_lse_bf16", softmax_lse._SIGNATURES_BF16), (s, items)),
                                        ("_f32", _native.load("softmax_lse", softmax_lse._SIGNATURES),
                                         (s32, items32))):
                args = (towers[0].data_ptr(), towers[1].data_ptr(), bias.data_ptr(),
                        (lse if not suffix else lse32).data_ptr(), dlse.data_ptr())
                ds_fn = getattr(lib, "lse_bwd_ds_f32" if suffix else "lse_bwd_ds_bf16")
                di_fn = getattr(lib, "lse_bwd_di_f32" if suffix else "lse_bwd_di_bf16")
                n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, rows, d, n_sms,
                                                                  dtype=torch.float32 if suffix else bf)
                ds_part = torch.empty((n_chunks, m, d), device=dev)

                def ds_kernel(ds_fn=ds_fn, args=args, n_chunks=n_chunks, chunk_rows=chunk_rows, ds_part=ds_part):
                    ds_fn(*args, ds_part.data_ptr(), m, rows, d, chunk_rows, n_chunks, stream)
                    return ds_part.sum(dim=0)

                split_ms[f"ds{suffix}"] = time_ms(ds_kernel, iters=3)
                split_ms[f"di{suffix}"] = time_ms(lambda di_fn=di_fn, args=args: di_fn(
                    *args, out_di.data_ptr(), m, rows, d, stream), iters=3)
                if not suffix:
                    check(bool(torch.equal(ds_kernel(), got["split"][0])) and bool(torch.equal(out_di, got["split"][1])),
                          f"split lse backward bf16 {what}: the timed launches gave other bits than the wrapper's")
        plain_ms = {route: time_ms(lambda route=route: softmax_lse.streaming_lse_bwd_bf16_reference(
            s, items, bias, lse, dlse, partials=route == "fused"), iters=3) for route in ("fused", "split")}
        sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
        lib_out = torch.logsumexp(sg @ ig.T + bias, dim=1)

        def grad_ms(inputs) -> float:
            return time_ms(lambda: torch.autograd.grad(lib_out, inputs, dlse, retain_graph=True), iters=3)

        def max_abs(route: str, i: int) -> float:
            return (got[route][i] - refs[route][i]).abs().max().item()

        results[f"lse_bwd_fused_bf16{sfx}{tag}"] = dict(
            max_abs_err=max(max_abs("fused", 0), max_abs("fused", 1)),
            max_rel_err=max(_max_rel(g, r) for g, r in zip(got["fused"], refs["fused"])),
            ms=fused_ms, f32_ms=fused_f32_ms, plain_ms=plain_ms["fused"], library_ms=grad_ms((sg, ig)),
            bound=bf16_bound((m + rows) * d * (2 + 4) + vectors, 3 * products, exps),
        )
        # the split twin computes both gradients in one walk: its time stands beside each split kernel
        results[f"lse_bwd_ds_bf16{sfx}{tag}"] = dict(
            max_abs_err=max_abs("split", 0), max_rel_err=_max_rel(got["split"][0], refs["split"][0]),
            ms=split_ms["ds"], f32_ms=split_ms["ds_f32"], plain_ms=plain_ms["split"], library_ms=grad_ms((sg,)),
            bound=bf16_bound((m + rows) * d * 2 + m * d * 4 + vectors, 2 * products, exps),
        )
        results[f"lse_bwd_di_bf16{sfx}{tag}"] = dict(
            max_abs_err=max_abs("split", 1), max_rel_err=_max_rel(got["split"][1], refs["split"][1]),
            ms=split_ms["di"], f32_ms=split_ms["di_f32"], plain_ms=plain_ms["split"], library_ms=grad_ms((ig,)),
            bound=bf16_bound((m + rows) * d * 2 + rows * d * 4 + vectors, 2 * products, exps),
        )
        print(f"bf16 mesh kernels: kernel 8 {what}: {err:.3g} per row from its twin (limit {BF16_LSE_RTOL}), "
              f"bit-equal on a rerun{'' if n_invalid else ' and to kernel 6 bf16 at a zero bias'}")
        for name in MESH_BF16_KEYS:
            r = results[f"{name}{sfx}{tag}"]
            print(f"bf16 mesh kernels: {name} {what}: max_rel_err={r['max_rel_err']:.3g} ms={r['ms']:.4f} "
                  f"f32_ms={r['f32_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (bf16) "
                  f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}, 989 TFLOP/s bf16, 3.35 TB/s)")
        del s, items, bias, dlse, s32, items32, lse, lse32, ref, got, refs, again, out_di, sg, ig, lib_out
        torch.cuda.empty_cache()
    return results


# kernel 7's two launches and kernels 12-14 in bf16 against their twins, relative to the twin's largest entry: the
# twins round at the kernels' points (kernel 7's one pass's, for its two launches), so only the order of f32 sums
# differs and, where a sum straddles a rounding boundary, a bf16 value lands a step apart
BF16_SPLIT_RTOL = 2 ** -7
# the large-catalog CE route (kernels 13 + 14, the label term in f32) against kernel 7's bf16 one pass on the same
# inputs: the two round at other points (P - D rounded as one bf16 value and bf16 ds partials in the one pass; P
# rounded and an f32 label term in the route), as JAX's two routes do: 3.3e-3 (ds) and 1.3e-3 (di) of the largest
# entry on the CPU at 200 x 5,000 x 32 (ROADMAP §3)
BF16_ROUTE_BAND = 2 ** -6
CE_SPLIT_BF16_KEYS = ("ce_grads_pair_bf16", "grads_z_fused_bf16", "grads_z_ds_bf16", "grads_z_di_bf16")
XL_N_ITEM_IDS = 196_607  # + PAD = 196,608 rows: past the 163,840 items at which bf16 CE gradients leave kernel 7


def ce_split_bf16_kernel_phase(torch, dev, b: int = TRAIN_B, d: int = N_FACTORS, mid_n: int = MID_N_ITEM_IDS + 1,
                               large_n: int = XL_N_ITEM_IDS + 1) -> dict:
    """(a) of the ``bf16`` phase for large catalogs: kernel 12's bf16 form
    (within the budget), 13 + 14's and kernel 7's two launches (the budget
    forced below the plan's partials, and over the JAX rule's bytes for the two
    launches) at 51,200 x 15,872 x ``d`` (result keys with ``_d{d}`` at
    another width than 128); kernel 7's two launches unforced at ``mid_n``
    items; kernels 13 + 14 and the large-catalog CE route unforced at
    ``large_n`` items, the route held against kernel 7's bf16 one pass with the
    budget lifted (0 leaves a case out). Each against its twin
    (BF16_SPLIT_RTOL), the same bits on a rerun, timed beside its f32 form on
    the same values, the library call in bf16 and its bound at the bf16
    rate."""
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import _native, softmax_lse

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 23 + d)
    m, n = b * SESSION_MAX_LEN, N_ITEM_IDS + 1
    sfx = width_suffix(d)
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 132
    s = torch.randn((m, d), generator=gen, device=dev).to(bf)
    items_xl = (0.1 * torch.randn((max(n, mid_n or 0, large_n or 0), d), generator=gen, device=dev)).to(bf)
    s32 = s.float()
    pad = torch.rand((m,), generator=gen, device=dev) < 0.1
    coeff = torch.where(pad, 0.0, 1.0 / float((~pad).sum()))
    lib = _native.load("softmax_lse_bf16", softmax_lse._SIGNATURES_BF16) if dev.type == "cuda" else None
    lib32 = _native.load("softmax_lse", softmax_lse._SIGNATURES) if dev.type == "cuda" else None
    results = {}

    def materialized(s_, items_, z_, want_ds: bool = True, want_di: bool = True) -> tuple:
        """P = exp(s @ itemsᵀ − z) in device memory (bf16), then its products."""
        p = (s_ @ items_.T).sub_(z_[:, None]).exp_()
        return (p @ items_ if want_ds else None), (p.T @ s_ if want_di else None)

    def hold(what: str, got, ref, rtol: float = BF16_SPLIT_RTOL) -> tuple:
        errs = [_max_rel(g, r) for g, r in zip(got, ref)]
        check(all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= rtol,
              f"{what}: ds {errs[0]}, di {errs[1]} of the largest entry from its twin (limit {rtol})")
        return errs, [(g - r).abs().max().item() for g, r in zip(got, ref)]

    def rerun(what: str, fn, got) -> None:
        check(all(bool(torch.equal(a, g)) for a, g in zip(fn(), got)), f"{what}: a second run gave other bits")

    def launched(fn, keys: tuple) -> tuple:
        before = dict(_native.LAUNCHES)
        out = fn()
        counts = {k: _native.LAUNCHES[k] - before[k] for k in _native.LAUNCHES if _native.LAUNCHES[k] != before[k]}
        check(counts == {k: 1 for k in keys}, f"launches {counts}, expected one each of {keys}")
        return out

    def split_pair(rows, z_, tag: str, iters: int) -> None:
        """Kernels 13 + 14 through the wrapper (the budget as set) against their
        twin, each then timed alone through the library handle beside its f32
        form (ds with the sum of its chunk partials)."""
        n_rows = rows.shape[0]
        what = f"grads_z_ds_bf16 / _di_bf16 at N={n_rows}"
        fn = lambda: softmax_lse.softmax_grads_from_z(s, rows, z_)  # noqa: E731
        got = launched(fn, ("grads_z_ds_bf16", "grads_z_di_bf16"))
        ref = softmax_lse.softmax_grads_from_z_bf16_reference(s, rows, z_, partials=False)
        errs, abs_errs = hold(what, got, ref)
        rerun(what, fn, got)
        rows32 = rows.float()
        n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, n_rows, d, n_sms, dtype=bf)
        out_di = torch.empty((n_rows, d), device=dev)
        times = {"ds": 0.0, "di": 0.0, "ds_f32": 0.0, "di_f32": 0.0}
        if lib is not None:
            stream = _native.current_stream_ptr(s.device)
            for suffix, lib_, towers in (("", lib, (s, rows)), ("_f32", lib32, (s32, rows32))):
                args = (towers[0].data_ptr(), towers[1].data_ptr(), z_.data_ptr())
                ds_fn = lib_.grads_z_ds_f32 if suffix else lib_.grads_z_ds_bf16
                di_fn = lib_.grads_z_di_f32 if suffix else lib_.grads_z_di_bf16
                plan = softmax_lse.split_bwd_plan(m, n_rows, d, n_sms, dtype=torch.float32 if suffix else bf)
                ds_part = torch.empty((plan[0], m, d), device=dev)

                def ds_kernel(ds_fn=ds_fn, args=args, plan=plan, ds_part=ds_part):
                    ds_fn(*args, ds_part.data_ptr(), m, n_rows, d, plan[1], plan[0], stream)
                    return ds_part.sum(dim=0)

                times[f"ds{suffix}"] = time_ms(ds_kernel, iters=iters)
                times[f"di{suffix}"] = time_ms(lambda di_fn=di_fn, args=args: di_fn(
                    *args, out_di.data_ptr(), m, n_rows, d, stream), iters=iters)
                if not suffix:
                    check(bool(torch.equal(ds_kernel(), got[0])) and bool(torch.equal(out_di, got[1])),
                          f"{what}: the timed launches gave other bits than the wrapper's")
        plain = time_ms(lambda: softmax_lse.softmax_grads_from_z_bf16_reference(s, rows, z_, partials=False),
                        iters=1, warmup=1)
        products = 2 * m * n_rows * d
        vectors = m * 4
        for i, (kernel, outputs) in enumerate((("ds", m * d), ("di", n_rows * d))):
            results[f"grads_z_{kernel}_bf16{sfx}{tag}"] = dict(
                max_abs_err=abs_errs[i], max_rel_err=errs[i], ms=times[kernel], f32_ms=times[f"{kernel}_f32"],
                plain_ms=plain,
                library_ms=time_ms(lambda: materialized(s, rows, z_, i == 0, i == 1), iters=1, warmup=1),
                bound=bf16_bound((m + n_rows) * d * 2 + vectors + outputs * 4, 2 * products, m * n_rows))
        print(f"bf16 kernels: {what}, D={d}: ds {errs[0]:.3g}, di {errs[1]:.3g} of the largest entry from their twin "
              f"(limit {BF16_SPLIT_RTOL:.3g}), bit-equal on a rerun; ds in {n_chunks} item chunks of {chunk_rows} "
              "rows")

    def ce_pair(rows, z_, y_, tag: str, forced: bool) -> None:
        """Kernel 7's two launches (``forced``: the budget under the bf16 plan's
        partials) against their twin, timed beside the f32 form on the same
        values (its two launches too, the budget under the f32 plan)."""
        n_rows = rows.shape[0]
        what = f"ce_grads_ds_bf16 / _di_bf16 at N={n_rows}"
        plan = softmax_lse.fused_bwd_plan(m, n_rows, d, n_sms, softmax_lse._ds_itemsize(bf), bf)
        plan32 = softmax_lse.fused_bwd_plan(m, n_rows, d, n_sms)
        if forced:
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = plan[2] - 1
        check(plan[2] > softmax_lse.FUSED_BWD_PARTIALS_BUDGET and not softmax_lse.ce_takes_split_route(m, n_rows, d, bf),
              f"{what}: the CE gradients do not take kernel 7's two launches ({plan[2]} bytes of one-pass partials)")
        fn = lambda: softmax_lse.softmax_ce_grads_from_z(s, rows, z_, y_, coeff)  # noqa: E731
        got = launched(fn, ("ce_grads_ds_bf16", "ce_grads_di_bf16"))
        rerun(what, fn, got)
        ms = time_ms(fn, iters=3)
        rows32 = rows.float()
        f32_pair = plan32[2] > softmax_lse.FUSED_BWD_PARTIALS_BUDGET and not softmax_lse.ce_takes_split_route(
            m, n_rows, d)
        check(f32_pair, f"{what}: the f32 form on the same values would not take its two launches")
        f32_ms = time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s32, rows32, z_, y_, coeff), iters=3)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        ref = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, rows, z_, y_, coeff, partials=False)
        errs, abs_errs = hold(what, got, ref)
        # the one pass's twin on the same inputs: the same roundings, f32 sums in another order
        one_pass = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, rows, z_, y_, coeff, partials=True)
        order = max(_max_rel(a, b) for a, b in zip(ref, one_pass))
        check(order <= 1e-5, f"{what}: the two-launch twin is {order} from the one-pass twin")
        sg, ig = s.detach().clone().requires_grad_(), rows.detach().clone().requires_grad_()
        ce_lib = (F.cross_entropy(sg @ ig.T, y_, reduction="none").float() * coeff).sum()
        products = 2 * m * n_rows * d
        ce_bytes = (m + n_rows) * d * 2 + m * 16 + (m + n_rows) * d * 4
        results[f"ce_grads_pair_bf16{sfx}{tag}"] = dict(
            max_abs_err=max(abs_errs), max_rel_err=max(errs), ms=ms, f32_ms=f32_ms,
            plain_ms=time_ms(lambda: softmax_lse.softmax_ce_grads_from_z_bf16_reference(
                s, rows, z_, y_, coeff, partials=False), iters=1, warmup=1),
            library_ms=time_ms(lambda: torch.autograd.grad(ce_lib, (sg, ig), retain_graph=True), iters=1, warmup=1),
            bound=bf16_bound(ce_bytes, 3 * products, m * n_rows),
            design_floor=ce_bf16_design_floor(ce_bytes, products, m * n_rows),
            old_ms=CE_BF16_OLD_MS.get(("two_launches", d, n_rows)))
        split = softmax_lse.split_bwd_plan(m, n_rows, d, n_sms, softmax_lse.FUSED_BWD_CHUNK, bf)
        print(f"bf16 kernels: {what}, D={d}{' (budget forced)' if forced else ''}: ds {errs[0]:.3g}, di {errs[1]:.3g} of the "
              f"largest entry from their twin (limit {BF16_SPLIT_RTOL:.3g}), bit-equal on a rerun; one-pass partials "
              f"{plan[2] / 2**20:.0f} MiB; ds in {split[0]} item chunks of {split[1]} rows; the two-launch twin "
              f"{order:.3g} from the one-pass twin")

    # at the training width: kernel 12 within the budget
    items = items_xl[:n]
    y = torch.where(pad, 0, torch.randint(1, n, (m,), generator=gen, device=dev))
    z = softmax_lse.streaming_lse(s, items) - torch.log(coeff)
    check(softmax_lse._fused_on_the_card(m, n, d, softmax_lse._ds_itemsize(bf), bf),
          f"the bf16 softmax gradients from z at the training shape, D={d}, leave kernel 12")
    fn = lambda: softmax_lse.softmax_grads_from_z(s, items, z)  # noqa: E731
    got = launched(fn, ("grads_z_fused_bf16",))
    ref = softmax_lse.softmax_grads_from_z_bf16_reference(s, items, z, partials=True)
    errs, abs_errs = hold("grads_z_fused_bf16", got, ref)
    rerun("grads_z_fused_bf16", fn, got)
    # kernel 12 is kernel 7's engine without the label term: kernel 7's one pass with coeff = 0 gives its bits
    if dev.type == "cuda":
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62
        no_label = launched(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, torch.zeros_like(coeff)),
                            ("ce_grads_fused_bf16",))
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        check(all(bool(torch.equal(a, g)) for a, g in zip(no_label, got)),
              f"grads_z_fused_bf16 at D={d}: other bits than kernel 7's one pass with coeff = 0")
        del no_label
    items32 = items.float()
    products = 2 * m * n * d
    z_bytes = (m + n) * d * 2 + m * 4 + (m + n) * d * 4
    results[f"grads_z_fused_bf16{sfx}"] = dict(
        max_abs_err=max(abs_errs), max_rel_err=max(errs), ms=time_ms(fn, iters=3),
        f32_ms=time_ms(lambda: softmax_lse.softmax_grads_from_z(s32, items32, z), iters=3),
        plain_ms=time_ms(lambda: softmax_lse.softmax_grads_from_z_bf16_reference(s, items, z), iters=1, warmup=1),
        library_ms=time_ms(lambda: materialized(s, items, z), iters=3),
        bound=bf16_bound(z_bytes, 3 * products, m * n), design_floor=ce_bf16_design_floor(z_bytes, products, m * n),
        old_ms=GRADS_Z_BF16_OLD_MS.get(d))
    print(f"bf16 kernels: grads_z_fused_bf16 at N={n}, D={d}: ds {errs[0]:.3g}, di {errs[1]:.3g} of the largest entry "
          f"from its twin (limit {BF16_SPLIT_RTOL:.3g}), bit-equal on a rerun and to kernel 7's one pass with "
          "coeff = 0 (the engine's two forms)")
    # kernels 13 + 14 and kernel 7's two launches, the budget forced
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
    split_pair(items, z, "", iters=3)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
    ce_pair(items, z, y, "", forced=True)
    del items32
    names = ["grads_z_fused_bf16", "grads_z_ds_bf16", "grads_z_di_bf16", "ce_grads_pair_bf16"]
    if mid_n:  # kernel 7's two launches, unforced
        rows = items_xl[:mid_n]
        y_mid = torch.where(pad, 0, torch.randint(1, mid_n, (m,), generator=gen, device=dev))
        ce_pair(rows, softmax_lse.streaming_lse(s, rows) - torch.log(coeff), y_mid, "_mid_catalog", forced=False)
        names.append("ce_grads_pair_bf16_mid_catalog")
        torch.cuda.empty_cache()
    if not large_n:
        for name in names:
            _bf16_line(f"{name} at D={d}", results[name.replace("_bf16", "_bf16" + sfx)])
        del s, s32, items_xl, items, z
        torch.cuda.empty_cache()
        return results
    # kernels 13 + 14 and the large-catalog route, unforced
    n_xl = large_n
    items_xl = items_xl[:n_xl]
    y_xl = torch.where(pad, 0, torch.randint(1, n_xl, (m,), generator=gen, device=dev))
    y_xl[: m // 50] = n_xl - 1  # a label many rows share, on the catalog's last row
    z_xl = softmax_lse.streaming_lse(s, items_xl) - torch.log(coeff)
    check(softmax_lse.ce_takes_split_route(m, n_xl, d, bf),
          f"the bf16 CE gradients at N={n_xl}, D={d} stay on kernel 7")
    split_pair(items_xl, z_xl, "_large_catalog", iters=1)
    torch.cuda.empty_cache()
    fn = lambda: softmax_lse.softmax_ce_grads_from_z(s, items_xl, z_xl, y_xl, coeff)  # noqa: E731
    route = launched(fn, ("grads_z_ds_bf16", "grads_z_di_bf16"))
    rerun(f"the bf16 CE route at N={n_xl}", fn, route)
    route_ms = time_ms(fn, iters=1)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62  # kernel 7's bf16 one pass at any size
    large_plan = softmax_lse.fused_bwd_plan(m, n_xl, d, n_sms, softmax_lse._ds_itemsize(bf), bf)
    kernel_7 = softmax_lse.softmax_ce_grads_from_z(s, items_xl, z_xl, y_xl, coeff)
    kernel_7_ms = time_ms(lambda: softmax_lse.softmax_ce_grads_from_z(s, items_xl, z_xl, y_xl, coeff), iters=1)
    softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
    band = [_max_rel(a, k) for a, k in zip(route, kernel_7)]
    check(max(band) <= BF16_ROUTE_BAND,
          f"the bf16 CE route at N={n_xl} is ds {band[0]}, di {band[1]} from kernel 7's bf16 one pass")
    results[f"ce_grads_large_catalog_route_bf16{sfx}"] = {"route_ms": route_ms, "kernel_7_ms": kernel_7_ms,
                                                          "ds_rel_diff": band[0], "di_rel_diff": band[1]}
    print(f"bf16 kernels: at N={n_xl}, D={d}: the bf16 CE route (kernels 13 + 14, the label term in f32) {route_ms:.3f} ms "
          f"beside kernel 7's bf16 one pass {kernel_7_ms:.3f} ms (the budget lifted: {large_plan[2] / 2**30:.2f} GiB "
          f"of partials); ds {band[0]:.3g}, di {band[1]:.3g} of the largest entry apart (band {BF16_ROUTE_BAND:.3g}: "
          f"the routes round at other points); the route bit-equal on a rerun")
    del route, kernel_7
    for name in (*names, "grads_z_ds_bf16_large_catalog", "grads_z_di_bf16_large_catalog"):
        _bf16_line(f"{name} at D={d}", results[name.replace("_bf16", "_bf16" + sfx)])
    del s, s32, items_xl, z, z_xl
    torch.cuda.empty_cache()
    return results


def _bf16_fit_launches(port, steps: int, val_forwards: int, with_loss: bool = True, family: str = "sasrec") -> dict:
    """Every launch count of a bf16 fit: per step the bf16 attention forms (HSTU:
    the bf16 STU forms, 18 in two launches, and 19), LayerNorm's bf16 forms
    and, with the full-catalog loss, the bf16 loss forms; per validation batch
    one bf16 forward (the loss) and one f32 forward (the recall, LayerNorm's
    f32 kernel among it), as the JAX package reads its bf16 and f32 weights."""
    hstu = family == "hstu"
    norms = 2 * N_BLOCKS + (not hstu)
    fwd, fwd_f32 = ("stu_fwd_bf16", "stu_fwd") if hstu else ("attention_fwd_bf16", "attention_fwd")
    expected = {name: 0 for name in port.LAUNCHES}
    expected.update({fwd: N_BLOCKS * (steps + val_forwards), fwd_f32: N_BLOCKS * val_forwards,
                     "layer_norm_fwd_bf16": norms * (steps + val_forwards), "layer_norm_fwd": norms * val_forwards,
                     "layer_norm_bwd_bf16": norms * steps})
    if hstu:
        expected.update(stu_bwd_bf16=N_BLOCKS * steps, stu_bwd_dq_bf16=N_BLOCKS * steps, stu_ds_bf16=N_BLOCKS * steps)
    else:
        expected.update(attention_bwd_bf16=N_BLOCKS * steps)
    if with_loss:
        expected.update(lse_partials_fwd_bf16=steps, ce_grads_fused_bf16=steps)
    return expected


def bf16_fit_phase(torch, np, port, df, dataset, dev, f32: dict, family: str = "sasrec", width: dict = None) -> dict:
    """(b) of the ``bf16`` phase: SASRecModel(...).fit (``family="hstu"``:
    HSTUModel(...).fit) with compute_dtype "bfloat16" at phase 5's (7's) width,
    depth, batch and epochs on the same frame, beside that phase's f32 fit:
    launch counts, one profiled train step's device kernels, losses and
    HitRate@10 (val_recall@10 on the held-out last items) within their bands
    of the f32 fit's, train examples/s of both. ``width`` (``n_factors``,
    ``n_heads``) fits at another width beside ``f32``, the f32 fit at that
    width, and adds one step's loss gradients against kernel 7's twin."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
    from rectools_tpu_torch.models.nn.transformers import losses as loss_fns
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse

    hstu = family == "hstu"
    tag = f"bf16 {FAMILY_TAGS[family]}{'wide ' if width else ''}train"
    config = {**TRAIN_CONFIG, **(width or {})}
    clock = epoch_clock(torch, dev)
    model = family_model(
        family, **config, epochs=EPOCHS, item_net_block_types=(IdEmbeddingsItemNet,),
        get_val_mask_func=hold_out_last, get_callbacks_func=lambda: [clock],
        training_module_kwargs={"val_recall_k": K, "compute_dtype": "bfloat16"}, device=dev,
    )
    torch.cuda.reset_peak_memory_stats()
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tm = model.training_module
    check(tm.resolved_compute_dtype == "bfloat16" and tm._use_fused_softmax, "the bf16 fit left the fused loss")
    check(all(p.dtype == torch.float32 for p in tm.backbone.parameters()), "the bf16 fit's master weights left f32")
    steps = tm.global_step
    val_batches = len(model.data_preparator.get_dataloader_val())
    expected = _bf16_fit_launches(port, steps, EPOCHS * val_batches, family=family)
    check(launches == expected, f"launches in the {tag} fit {launches}, expected {expected}")
    losses, recall = tm.train_loss_history, tm.val_metric_history.get(f"val_recall@{K}", [])
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()) and losses[1] < losses[0],
          f"bf16 train losses {losses}")
    check(len(recall) == EPOCHS and bool(np.isfinite(recall).all()), f"bf16 val_recall@{K} {recall}")
    loss_rel = max(abs(a / b - 1) for a, b in zip(losses, f32["train_loss"]))
    hit_gap = abs(recall[-1] - f32[f"val_recall@{K}"][-1])
    check(loss_rel <= BF16_LOSS_RTOL, f"bf16 train losses {losses} against f32 {f32['train_loss']}: {loss_rel}")
    check(hit_gap <= BF16_HIT_BAND, f"bf16 HitRate@{K} {recall[-1]} against f32 {f32[f'val_recall@{K}'][-1]}")
    epoch2_s = clock.times[2] - clock.times[1]
    examples_per_s = TRAIN_B * (steps // EPOCHS) / epoch2_s
    print(f"{tag}: fit {EPOCHS} epochs x {steps // EPOCHS} steps of {TRAIN_B} in {fit_s:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if hstu:
        print(f"{tag}: per step {launches['stu_fwd_bf16'] // (steps + EPOCHS * val_batches)} stu_fwd_bf16 a forward, "
              f"{launches['stu_bwd_bf16'] // steps} stu_bwd_bf16, {launches['stu_bwd_dq_bf16'] // steps} "
              f"stu_bwd_dq_bf16, {launches['stu_ds_bf16'] // steps} stu_ds_bf16; f32 stu_fwd only in the validation "
              f"recall's f32 forwards ({launches['stu_fwd']}), no f32 stu_bwd, stu_bwd_dq or stu_ds")
    print(f"{tag}: losses {losses} (f32 {f32['train_loss']}, largest relative gap {loss_rel:.3g}, limit "
          f"{BF16_LOSS_RTOL}); HitRate@{K} on the held-out last items {recall} (f32 {f32[f'val_recall@{K}']}, gap "
          f"{hit_gap:.4f}, band {BF16_HIT_BAND})")
    f32_fit = f"the f32 fit at d = {config['n_factors']}" if width else f"phase {7 if hstu else 5}"
    print(f"{tag}: epoch 2 wall {epoch2_s:.3f} s (validation included), {examples_per_s:.0f} train examples/s "
          f"beside f32 {f32['train_examples_per_s']:.0f} ({f32_fit}), peak device memory {peak_mb:.0f} MiB")
    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
    batch = tm._device_batch(pad_batch(next(iter(loader)), TRAIN_B))
    names = list(device_kernels(torch, lambda: tm._train_step(batch), 1))
    wanted, banned_keys = ((BF16_HSTU_DEVICE_KERNELS, BF16_HSTU_BANNED_KERNELS) if hstu
                           else (BF16_DEVICE_KERNELS, BF16_BANNED_KERNELS))
    missing, banned = bf16_step_kernels(names, wanted, (*banned_keys, *CE_BF16_OLD_KERNELS))
    check(not missing and not banned,
          f"a {tag} step's device kernels: missing {missing}, f32 or library {banned}")
    print(f"{tag}: a profiled step ran {len(names)} device kernels, the {len(wanted)} bf16 forms and LayerNorm's "
          f"bf16 forms among them, no f32 {'STU' if hstu else 'attention'}, loss or LayerNorm kernel, no library "
          f"attention or cross-entropy, none of kernel 7's kernels before its engine")
    print(f"{tag}: profile of one train step")
    profile = profile_phase(torch, lambda: tm._train_step(batch), by_kernel=True)
    by_kernel = profile.pop("device_ms_by_kernel")
    kernel_7_ms = sum(ms for name, ms in by_kernel.items() if CE_BF16_ENGINE_KERNEL in name)
    profile["kernel_7_ms"], profile["kernel_7_share"] = kernel_7_ms, kernel_7_ms / profile["device_ms"]
    print(f"{tag}: kernel 7's engine took {kernel_7_ms:.3f} ms of the step's {profile['device_ms']:.3f} ms on the "
          f"device ({profile['kernel_7_share']:.3f}); the step at d = {config['n_factors']} on {gpu_name_and_power()}")
    print(f"{tag}: the profiled step ran {profile['copy_kernels']} copy kernels in {profile['copy_ms']:.3f} ms on the "
          f"device (a bf16 SASRec step at d = 128 with LayerNorm widened to its f32 kernels, counted by this "
          f"profile: 80 copy kernels, 0.77 ms; PERF.md §6)")
    step = {}
    if width:  # one step's loss gradients of the trained towers: kernel 7's one pass against its twin
        backbone, d = model.backbone.eval(), config["n_factors"]
        with torch.no_grad():
            item_embs = backbone.item_model.embed_catalog()
            s_t, i_t = backbone.similarity_module.catalog_loss_towers(backbone.encode_sessions(batch, item_embs),
                                                                      item_embs)
        bf = torch.bfloat16
        s2 = (s_t.float() / tm.logits_t).reshape(-1, d).contiguous().to(bf)
        step = bf16_step_check(torch, port, loss_fns, softmax_lse, tag, "one pass", s2, i_t.float().contiguous().to(bf),
                               batch["y"].reshape(-1), batch["yw"].reshape(-1), ("ce_grads_fused_bf16",))
    return {"launches": launches, "steps": steps, "train_loss": losses, f"val_recall@{K}": recall, "fit_s": fit_s,
            "epoch2_s": epoch2_s, "train_examples_per_s": examples_per_s,
            "f32_train_examples_per_s": f32["train_examples_per_s"], "loss_rel_to_f32": loss_rel,
            "hit_gap_to_f32": hit_gap, "peak_device_mib": peak_mb, **step,
            **{f"step_{k}": v for k, v in profile.items()}}


def bf16_family_phase(torch, np, port, dataset, dev) -> dict:
    """(c) of the ``bf16`` phase: one epoch through Model.fit with bf16 compute
    of BERT4Rec (full-catalog loss: kernels 6 and 7 in bf16) and of eSASRec with
    shared negatives (sampled softmax: the attention forms only): finite
    losses, the bf16 forms launched, no f32 attention."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    out = {}
    for family, extra in (("bert4rec", {}), ("esasrec", {"negatives_sharing": "batch"})):
        model = family_model(family, **TRAIN_CONFIG, epochs=1, item_net_block_types=(IdEmbeddingsItemNet,),
                             training_module_kwargs={"compute_dtype": "bfloat16", **extra}, device=dev)
        port.reset_launches()
        t0 = time.perf_counter()
        model.fit(dataset)
        fit_s = time.perf_counter() - t0
        launches = dict(port.LAUNCHES)
        tm = model.training_module
        losses = tm.train_loss_history
        check(len(losses) == 1 and bool(np.isfinite(losses).all()), f"bf16 {family} losses {losses}")
        steps = tm.global_step
        norms = 2 * N_BLOCKS  # Pre-LN and LiGR blocks: two LayerNorms each, no closing one
        expected = {name: 0 for name in port.LAUNCHES}
        expected.update(attention_fwd_bf16=N_BLOCKS * steps, attention_bwd_bf16=N_BLOCKS * steps,
                        layer_norm_fwd_bf16=norms * steps, layer_norm_bwd_bf16=norms * steps)
        if family == "bert4rec":
            expected.update(lse_partials_fwd_bf16=steps, ce_grads_fused_bf16=steps)
        check(launches == expected, f"launches in the bf16 {family} fit {launches}, expected {expected}")
        print(f"bf16 {family}: one epoch of {steps} steps of {TRAIN_B} in {fit_s:.2f} s, loss {losses}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        out[family] = {"launches": launches, "steps": steps, "train_loss": losses, "fit_s": fit_s}
    return out


# kernels 1 and 4 in bf16 against their twins, relative to the largest entry: one bf16 step where the card's f32
# row sums, in another order than the twin's, straddle a rounding boundary (against the f32 kernels on the widened
# operands they are bit-equal, and checked so)
BF16_LN_RTOL = 2 ** -8
LSE_LN_BF16_WIDTHS = (N_FACTORS, 16, 256)  # the training width first: its result keys carry no suffix
LSE_LN_BF16_ENTRIES = ("layer_norm_fwd_bf16", "layer_norm_bwd_bf16", "lse_fwd_bf16", "lse_shift_fwd_bf16")


def _lse_bf16_cases(torch, softmax_lse, s, items, sfx: str) -> dict:
    """Kernels 15 and 16's bf16 forms through the public streaming_lse on bf16
    towers: each against its twin per row (BF16_LSE_RTOL), the same bits on a
    rerun, timed beside its f32 form on the widened values, its twin on the
    card, torch.logsumexp of the bf16 product and its bound."""
    m, d = s.shape
    n = items.shape[0]
    s32, items32 = s.float(), items.float()
    products, exps = 2 * m * n * d, m * n
    n_chunks = -(-n // softmax_lse.LSE_CHUNK)
    out = {}

    def carried(a, b):
        softmax_lse.USE_PARTIALS_FWD = False
        try:
            return softmax_lse.streaming_lse(a, b)
        finally:
            softmax_lse.USE_PARTIALS_FWD = True

    def shifted(a, b):
        return softmax_lse.streaming_lse(a, b, bounded_shift=True)

    def shift_twin(a, b):
        return softmax_lse.select_shift_window(*softmax_lse.lse_shift_sums_bf16_reference(a, b))

    # kernel 15: one running (max, sum of exp) a row, lse (M,); kernel 16: the f32 shift (M,) in, two windows'
    # (n_chunks, M) sums out. One exp a logit for both: window 2's term is e^64 times window 1's (the kernel
    # takes two exps, but the function needs one)
    cases = (("lse_fwd_bf16", carried, softmax_lse.streaming_lse_carried_bf16_reference, (m + n) * d * 2 + m * 4),
             ("lse_shift_fwd_bf16", shifted, shift_twin, (m + n) * d * 2 + m * 4 + 2 * n_chunks * m * 4))
    for name, fn, twin, n_bytes in cases:
        lse = fn(s, items)
        ref = twin(s, items)
        err = _row_rel(lse, ref)
        rerun = bool(torch.equal(lse, fn(s, items)))
        check(bool(torch.isfinite(lse).all()) and err <= BF16_LSE_RTOL and rerun,
              f"{name} at {m} x {n} x {d}: {err} per row from its twin (limit {BF16_LSE_RTOL}), or other bits on a "
              f"rerun ({rerun})")
        out[name + sfx] = dict(
            max_abs_err=(lse - ref).abs().max().item(), max_rel_err=err,
            ms=time_ms(lambda: fn(s, items)), f32_ms=time_ms(lambda: fn(s32, items32), iters=5),
            plain_ms=time_ms(lambda: twin(s, items), iters=3),
            library_ms=time_ms(lambda: torch.logsumexp(s @ items.T, dim=1), iters=3),
            bound=bf16_bound(n_bytes, products, exps),
        )
        _bf16_line(f"{name} (M={m}, N={n}, D={d})", out[name + sfx])
    shift, l, _ = softmax_lse.lse_shift_sums_bf16_reference(s, items)
    window_2 = (l < softmax_lse.WINDOW1_FLOOR).float().mean().item()
    print(f"bf16 lse and layer norm: at D={d} kernels 15 and 16 bf16 within {BF16_LSE_RTOL} per row of their twins, "
          f"bit-equal on a rerun; kernel 16's rows in window 2: {window_2:.4f}")
    return out


def _layer_norm_bf16_cases(torch, F, layer_norm, gen, dev, rows: int, d: int, sfx: str) -> dict:
    """Kernels 1 and 4's bf16 forms on (rows, d) bf16 x and dy with bf16 γ, β:
    bit-equal to the f32 kernels on the widened operands (y and dx rounded to
    bf16, dγ and dβ to γ's dtype), within BF16_LN_RTOL of their twins, the same
    bits on a rerun, timed beside the f32 kernels on the widened values (CUDA
    events, and the device time by the profiler), their twins on the card, bf16
    F.layer_norm and its autograd, and their bounds (bytes)."""
    bf = torch.bfloat16
    x = (3 * torch.randn((rows, d), generator=gen, device=dev) + 1).to(bf)
    dy = torch.randn((rows, d), generator=gen, device=dev).to(bf)
    g = (1 + 0.3 * torch.randn((d,), generator=gen, device=dev)).to(bf)
    b = (0.3 * torch.randn((d,), generator=gen, device=dev)).to(bf)
    x32, dy32, g32, b32 = x.float(), dy.float(), g.float(), b.float()
    y = layer_norm.layer_norm_fwd(x, g, b, 1e-6)
    grads = layer_norm.layer_norm_bwd(x, g, dy, 1e-6)
    widened = (layer_norm.layer_norm_fwd(x32, g32, b32, 1e-6), *layer_norm.layer_norm_bwd(x32, g32, dy32, 1e-6))
    bits = all(bool(torch.equal(a, w.to(bf))) for a, w in zip((y, *grads), widened))
    rerun = bool(torch.equal(layer_norm.layer_norm_fwd(x, g, b, 1e-6), y)) and all(
        bool(torch.equal(a, c)) for a, c in zip(layer_norm.layer_norm_bwd(x, g, dy, 1e-6), grads))
    twin_y = layer_norm.layer_norm_bf16_reference(x, g, b, 1e-6)
    twin_g = layer_norm.layer_norm_bwd_bf16_reference(x, g, dy, 1e-6)
    rel_y = _max_rel(y.float(), twin_y.float())
    rel_g = max(_max_rel(a.float(), w.float()) for a, w in zip(grads, twin_g))
    check(bits and rerun and rel_y <= BF16_LN_RTOL and rel_g <= BF16_LN_RTOL,
          f"LayerNorm bf16 at {rows} x {d}: equal to the widened f32 route {bits}, on a rerun {rerun}; "
          f"{rel_y} / {rel_g} of the largest entry from the twins (limit {BF16_LN_RTOL})")
    xg, gg, bg = (t.detach().clone().requires_grad_() for t in (x, g, b))
    y_lib = F.layer_norm(xg, (d,), gg, bg, 1e-6)
    numel = rows * d

    def device_ms(fn, kernel: str):
        """The device ms a call of ``kernel`` by the profiler, or None where no
        capture of three holds its records (a capture of short kernels now
        and then comes back without them)."""
        for _ in range(3):
            found = [(k, ms) for name, (k, ms) in device_kernels(torch, fn, calls=20).items() if kernel in name]
            if found and all(k >= 1 for k, _ in found):
                return sum(k * ms for k, ms in found)
        return None

    out = {
        f"layer_norm_fwd_bf16{sfx}": dict(
            max_abs_err=(y.float() - twin_y.float()).abs().max().item(), max_rel_err=rel_y,
            ms=time_ms(lambda: layer_norm.layer_norm_fwd(x, g, b, 1e-6)),
            device_ms=device_ms(lambda: layer_norm.layer_norm_fwd(x, g, b, 1e-6), "ln_fwd_kernel"),
            f32_ms=time_ms(lambda: layer_norm.layer_norm_fwd(x32, g32, b32, 1e-6)),
            plain_ms=time_ms(lambda: layer_norm.layer_norm_bf16_reference(x, g, b, 1e-6)),
            library_ms=time_ms(lambda: F.layer_norm(x, (d,), g, b, 1e-6)),
            bound=bound_ms(2 * numel * 2 + 2 * d * 2, 8 * numel), bound_ops="FP32",
        ),
        f"layer_norm_bwd_bf16{sfx}": dict(
            max_abs_err=max((a.float() - w.float()).abs().max().item() for a, w in zip(grads, twin_g)),
            max_rel_err=rel_g,
            ms=time_ms(lambda: layer_norm.layer_norm_bwd(x, g, dy, 1e-6)),
            device_ms=device_ms(lambda: layer_norm.layer_norm_bwd(x, g, dy, 1e-6), "ln_bwd_kernel"),
            f32_ms=time_ms(lambda: layer_norm.layer_norm_bwd(x32, g32, dy32, 1e-6)),
            plain_ms=time_ms(lambda: layer_norm.layer_norm_bwd_bf16_reference(x, g, dy, 1e-6)),
            library_ms=time_ms(lambda: torch.autograd.grad(y_lib, (xg, gg, bg), dy, retain_graph=True)),
            bound=bound_ms(3 * numel * 2 + 3 * d * 2, 12 * numel), bound_ops="FP32",
        ),
    }
    for name, r in out.items():
        on_device = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
        print(f"bf16 lse and layer norm: {name} ({rows} x {d}): bit-equal to the f32 kernels on the widened "
              f"operands, max_rel_err={r['max_rel_err']:.3g} (twin) ms={r['ms']:.4f} device_ms={on_device} "
              f"f32_ms={r['f32_ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (bf16) "
              f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}, 3.35 TB/s)")
    return out


def bf16_lse_ln_phase(torch, dev, b: int = TRAIN_B) -> dict:
    """(d) of the ``bf16`` phase, ``bf16 lse and layer norm``: the bf16 forms of
    kernels 15 and 16 through the public streaming_lse at 51,200 x 15,872 and
    D = 128, 16 and 256 (``_lse_bf16_cases``), and of kernels 1 and 4 at
    51,200 rows of 128, 16 and 256 and at 51,199 rows of 128
    (``_layer_norm_bf16_cases``; result keys ``..._ragged``). Then, at each
    width, one public call of each lse form with the launch counts set to 0
    just before it (kernel 15, and kernel 16 with its backward through kernel
    9's bf16 form, or 10 + 11's where 9's partials pass the budget): the
    ``ops`` launches of the kernels line. Returns the numbers under
    ``kernels`` and those launches by width under ``ops``; prints the phase's
    wall."""
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import _native, layer_norm, softmax_lse

    t0 = time.perf_counter()
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    m, n = b * SESSION_MAX_LEN, N_ITEM_IDS + 1
    kernels, ops = {}, {}
    for d in LSE_LN_BF16_WIDTHS:
        sfx = width_suffix(d)
        s = torch.randn((m, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).to(bf)
        kernels.update(_lse_bf16_cases(torch, softmax_lse, s, items, sfx))
        # the public op once a form, counted from 0
        _native.reset_launches()
        softmax_lse.USE_PARTIALS_FWD = False
        try:
            softmax_lse.streaming_lse(s, items)
        finally:
            softmax_lse.USE_PARTIALS_FWD = True
        sg, ig = s.detach().clone().requires_grad_(), items.detach().clone().requires_grad_()
        softmax_lse.streaming_lse(sg, ig, bounded_shift=True).sum().backward()
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        fused = softmax_lse._fused_on_the_card(m, n, d, 4, bf)
        want = {key: 0 for key in launches}
        want.update(lse_fwd_bf16=1, lse_shift_fwd_bf16=1,
                    **({"lse_bwd_fused_bf16": 1} if fused else {"lse_bwd_ds_bf16": 1, "lse_bwd_di_bf16": 1}))
        check(launches == want and sg.grad.dtype == ig.grad.dtype == bf
              and bool(torch.isfinite(sg.grad.float()).all()) and bool(torch.isfinite(ig.grad.float()).all()),
              f"bf16 lse ops at D={d}: launches {launches}, expected {want}; gradients {sg.grad.dtype}")
        print(f"bf16 lse and layer norm: the public streaming_lse on bf16 towers at D={d}: launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        ops[d] = {"launches": launches}
        del s, items, sg, ig
        torch.cuda.empty_cache()
        kernels.update(_layer_norm_bf16_cases(torch, F, layer_norm, gen, dev, m, d, sfx))
    kernels.update(_layer_norm_bf16_cases(torch, F, layer_norm, gen, dev, m - 1, N_FACTORS, "_ragged"))
    torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t0
    print(f"bf16 lse and layer norm: wall {wall_s:.1f} s")
    return {"kernels": kernels, "ops": ops, "wall_s": wall_s}


# ---------------------------------------------------------------- phase 16 at the widths 256 and 16

WIDE_WIDTHS = (256, 16)  # the models' default width, and the narrow end of SUPPORTED_D
WIDE_FIT = dict(n_factors=256, n_heads=4)  # the package defaults (models/nn/transformers/base.py): heads of 64
NARROW_FIT = dict(n_factors=16, n_heads=1)  # one head of 16
WIDE_LARGE_N = 65_536  # D = 256: past the 40,960 items at which JAX's bf16 CE gradients leave kernel 7
WIDE_PAIR_N = 32_768  # D = 256: kernel 7's one pass over the partials budget, JAX's rule still on kernel 7
BF16_LOSS_KERNELS = ("lse_partials_bf16_kernel", "ce_fused_bf16_kernel", "split_ds_bf16_kernel",
                     "split_di_bf16_kernel", "lse_bwd_di_bf16_kernel")  # in the order of lse_bf16_smem_bytes
SMEM_LIMIT = 232_448  # bytes of shared memory a block may take on an H100
# the bf16 loss entries of the kernels line, whose forms at D = 256 and 16 it gives beside them
BF16_LOSS_ENTRIES = ("lse_partials_fwd_bf16", "ce_grads_fused_bf16", "lse_bias_fwd_bf16", "lse_bwd_fused_bf16",
                     "lse_bwd_ds_bf16", "lse_bwd_di_bf16", "ce_grads_pair_bf16", "grads_z_fused_bf16",
                     "grads_z_ds_bf16", "grads_z_di_bf16")


def width_suffix(d: int) -> str:
    """The end of a bf16 kernel result's key at width ``d``: none at the
    training width (128), ``_d{d}`` at another."""
    return "" if d == N_FACTORS else f"_d{d}"


def bf16_wide_build_check(torch, dev, reports: dict) -> dict:
    """Every bf16 loss kernel instantiated at D = 256 and 16: ``ptxas``'s
    registers, 0 bytes of stack and no spill for each of its forms, and the
    shared memory a block takes (``lse_bf16_smem_bytes``) within SMEM_LIMIT."""
    from rectools_tpu_torch.ops import _native, softmax_lse

    if dev.type != "cuda":
        return {}
    lib = _native.load("softmax_lse_bf16", softmax_lse._SIGNATURES_BF16)
    cached = "softmax_lse_bf16" not in reports
    if cached:
        print("bf16 wide build: softmax_lse_bf16 came from the build cache this run; its registers are not shown")
    entries = ptxas_entries(reports.get("softmax_lse_bf16", ""))
    out = {}
    for d in WIDE_WIDTHS:
        for i, kernel in enumerate(BF16_LOSS_KERNELS):
            forms = [e for name, e in entries.items() if f"{kernel}ILi{d}E" in name]
            smem = lib.lse_bf16_smem_bytes(i, d)
            check(cached or bool(forms), f"bf16 wide build: no ptxas report of {kernel} at D={d}")
            clean = all(e.get("stack") == 0 and e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                        for e in forms)
            check(clean and 0 < smem <= SMEM_LIMIT,
                  f"bf16 wide build: {kernel} at D={d}: {forms}, {smem} bytes of shared memory a block")
            registers = sorted(e["registers"] for e in forms)
            out[f"{kernel}_d{d}"] = {"registers": registers, "stack_bytes": 0, "smem_bytes": smem}
            print(f"bf16 wide build: {kernel} at D={d}: {len(forms)} forms, registers {registers}, 0 bytes of stack, "
                  f"no spill, {smem} bytes of shared memory a block (limit {SMEM_LIMIT})")
    return out


def ce_bf16_engine_build_check(torch, dev, reports: dict) -> dict:
    """Kernel 7's bf16 engine (``csrc/ce_grads_bf16.cu``) at every D of
    SUPPORTED_D in both its forms (with the label term, kernel 7, and
    without, kernel 12): ``ptxas``'s registers (the launch count setmaxnreg
    balances against, which the launches check too), 0 bytes of stack and no
    spill, and its shared memory a block (kernel 7's, the larger)
    within SMEM_LIMIT."""
    from rectools_tpu_torch.ops import _native, softmax_lse

    if dev.type != "cuda":
        return {}
    lib = _native.load("ce_grads_bf16", softmax_lse._SIGNATURES_CE_BF16)
    cached = "ce_grads_bf16" not in reports
    if cached:
        print("bf16 engine build: ce_grads_bf16 came from the build cache this run; its registers are not shown")
    entries = ptxas_entries(reports.get("ce_grads_bf16", ""))
    out = {}
    for d in softmax_lse.SUPPORTED_D:
        forms = [e for name, e in entries.items() if f"{CE_BF16_ENGINE_KERNEL}ILi{d}ELb" in name]
        smem = lib.ce_grads_bf16_smem_bytes(d)
        clean = all(e.get("stack") == 0 and e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                    and e.get("registers") == CE_BF16_LAUNCH_REGS for e in forms)
        check((cached or len(forms) == 2) and clean and 0 < smem <= SMEM_LIMIT,
              f"bf16 engine build: {CE_BF16_ENGINE_KERNEL} at D={d}: {forms}, {smem} bytes of shared memory a block")
        stack = [e.get("stack") for e in forms]
        spills = [e.get("spill_stores") for e in forms]
        out[f"{CE_BF16_ENGINE_KERNEL}_d{d}"] = {"registers": CE_BF16_LAUNCH_REGS, "stack_bytes": stack,
                                                "spill_store_bytes": spills, "smem_bytes": smem}
        print(f"bf16 engine build: {CE_BF16_ENGINE_KERNEL} at D={d}, kernels 7 and 12: {CE_BF16_LAUNCH_REGS} "
              f"registers a thread at launch (setmaxnreg: 24 the producer warpgroup, 240 the consumers), stack "
              f"{stack} bytes, spill stores {spills} bytes (limit 0 for both), {smem} bytes of shared memory a block "
              f"(limit {SMEM_LIMIT})")
    return out


# (heads, head dim) of the package defaults (d 256, 4 heads) and of the narrow fit (d 16, one head)
WIDE_HEADS = tuple((w["n_heads"], w["n_factors"] // w["n_heads"]) for w in (WIDE_FIT, NARROW_FIT))


def attention_bf16_build_check(torch, dev, reports: dict) -> dict:
    """Kernel 2's bf16 forward (ATTN_BF16_FWD_KERNEL) in each of its forms (4
    head dims, dropout on and off, rows and tiles modes): ``ptxas``'s
    registers, 0 bytes of stack and no spill."""
    from rectools_tpu_torch.ops import attention

    if dev.type != "cuda":
        return {}
    cached = "attention_bf16" not in reports
    if cached:
        print("bf16 attention build: attention_bf16 came from the build cache this run; its registers are not shown")
    entries = ptxas_entries(reports.get("attention_bf16", ""))
    out = {}
    for dh in attention.BF16_HEAD_DIMS:
        forms = {name: e for name, e in entries.items() if f"{ATTN_BF16_FWD_KERNEL}ILi{dh}E" in name}
        clean = all(e.get("stack") == 0 and e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                    for e in forms.values())
        check((cached or len(forms) == 4) and clean,
              f"bf16 attention build: {ATTN_BF16_FWD_KERNEL} at dh={dh}: {forms}")
        registers = sorted(e["registers"] for e in forms.values())
        out[f"{ATTN_BF16_FWD_KERNEL}_dh{dh}"] = {"registers": registers, "stack_bytes": 0, "spill_bytes": 0}
        print(f"bf16 attention build: {ATTN_BF16_FWD_KERNEL} at dh={dh}: {len(forms)} forms (rows and tiles mode, "
              f"dropout on and off), registers {registers}, 0 bytes of stack, no spill")
    return out


def bf16_wide_attention_cases(torch, dev, b: int = TRAIN_B) -> dict:
    """Kernels 2 and 5 in bf16 at B = 512, L = 100 with the package defaults'
    4 heads of 64 and the narrow fit's one head of 16, causal and under
    BERT4Rec's bias (``_attention_bf16_case``; result keys
    ``attention_{fwd,bwd}_bf16_dh{dh}_{causal,bidirectional}``, and
    ``_dh{dh}`` for the causal case)."""
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    l = SESSION_MAX_LEN
    causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    bias = bert4rec_bias(torch, gen, dev, b, l)
    results = {}
    for h, dh in WIDE_HEADS:
        results.update(_attention_bf16_case(torch, F, attention, gen, dev, b, l, h, dh, causal, f"dh{dh}_causal"))
        results.update(_attention_bf16_case(torch, F, attention, gen, dev, b, l, h, dh, bias, f"dh{dh}_bidirectional"))
        for name in ("attention_fwd_bf16", "attention_bwd_bf16"):
            results[f"{name}_dh{dh}"] = results[f"{name}_dh{dh}_causal"]
        torch.cuda.empty_cache()
    return results


def bf16_wide_kernel_phase(torch, dev, reports: dict) -> dict:
    """``bf16 wide kernels``: the bf16 loss forms at D = 256 and 16 (the
    build checks, kernel 7's engine at every D and kernel 2's bf16 forward at
    every head dim among them, then kernels 6 and 7, 8-11 at the (1, 1) mesh's
    shape and a (2, 2) shard, 12, 13 + 14 and kernel 7's two launches at 51,200
    x 15,872; at D = 256 also 13 + 14 and the CE route unforced at 65,536
    items), then kernels 2 and 5 at those widths' heads (64 and 16), each
    against its twin (BF16_SPLIT_RTOL; lse BF16_LSE_RTOL per row;
    BF16_ATTN_RTOL), its bits on a rerun, timed beside its f32 form, its bf16
    library call and its bound."""
    results = {"build": {**bf16_wide_build_check(torch, dev, reports),
                         **ce_bf16_engine_build_check(torch, dev, reports),
                         **attention_bf16_build_check(torch, dev, reports)}}
    for d in WIDE_WIDTHS:
        results.update(bf16_kernel_phase(torch, dev, d=d))
        results.update(mesh_bf16_kernel_phase(torch, dev, d=d))
        results.update(ce_split_bf16_kernel_phase(torch, dev, d=d, mid_n=0, large_n=WIDE_LARGE_N if d == 256 else 0))
    results.update(bf16_wide_attention_cases(torch, dev))
    return results


def _f32_fit(torch, np, port, dataset, dev, width: dict) -> dict:
    """SASRec's f32 fit at ``width``, the training phase's depth, batch and
    epochs: losses, HitRate@10 on the held-out last items, train examples/s."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    clock = epoch_clock(torch, dev)
    model = family_model("sasrec", **{**TRAIN_CONFIG, **width}, epochs=EPOCHS,
                         item_net_block_types=(IdEmbeddingsItemNet,), get_val_mask_func=hold_out_last,
                         get_callbacks_func=lambda: [clock], training_module_kwargs={"val_recall_k": K}, device=dev)
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    tm = model.training_module
    steps, losses = tm.global_step, tm.train_loss_history
    recall = tm.val_metric_history.get(f"val_recall@{K}", [])
    check(len(losses) == EPOCHS and bool(np.isfinite(losses).all()) and losses[1] < losses[0],
          f"f32 train losses at d = {width['n_factors']}: {losses}")
    epoch2_s = clock.times[2] - clock.times[1]
    examples_per_s = TRAIN_B * (steps // EPOCHS) / epoch2_s
    loss_launches = {k: v for k, v in port.LAUNCHES.items() if v and k.startswith(("lse", "ce_", "grads"))}
    print(f"f32 wide train: {EPOCHS} epochs x {steps // EPOCHS} steps of {TRAIN_B} at d = {width['n_factors']}, "
          f"{width['n_heads']} heads in {fit_s:.2f} s; losses {losses}, HitRate@{K} {recall}; epoch 2 wall "
          f"{epoch2_s:.3f} s, {examples_per_s:.0f} train examples/s; the loss's launches {loss_launches}")
    return {"train_loss": losses, f"val_recall@{K}": recall, "fit_s": fit_s, "epoch2_s": epoch2_s,
            "train_examples_per_s": examples_per_s, "loss_launches": loss_launches}


def _epoch(torch, np, port, dataset, dev, family: str, width: dict, tag: str, compute_dtype: str = "bfloat16",
           keep_model: bool = False) -> dict:
    """One epoch of ``family`` at ``width`` through Model.fit in
    ``compute_dtype``: a finite loss and, in bf16, every launch (the bf16
    forms, LayerNorm's f32 kernels; no validation), in f32 no bf16 form.
    ``keep_model`` returns the fitted model under ``"model"``."""
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    model = family_model(family, **{**TRAIN_CONFIG, **width}, epochs=1, item_net_block_types=(IdEmbeddingsItemNet,),
                         training_module_kwargs={"compute_dtype": compute_dtype}, device=dev)
    port.reset_launches()
    t0 = time.perf_counter()
    model.fit(dataset)
    fit_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    tm = model.training_module
    steps, losses = tm.global_step, tm.train_loss_history
    check(tm.resolved_compute_dtype == compute_dtype and len(losses) == 1 and bool(np.isfinite(losses).all()),
          f"{tag}: losses {losses}")
    if compute_dtype == "bfloat16":
        expected = _bf16_fit_launches(port, steps, 0, family=family)
        check(launches == expected, f"launches in the {tag} epoch {launches}, expected {expected}")
    else:
        check(not any(v for k, v in launches.items() if k.endswith("_bf16")), f"{tag}: a bf16 form in f32 {launches}")
    dtype = "bf16" if compute_dtype == "bfloat16" else "f32"
    print(f"{tag}: one {dtype} epoch of {steps} steps of {TRAIN_B} at d = {width['n_factors']}, {width['n_heads']} "
          f"heads in {fit_s:.2f} s, loss {losses}; launches { {k: v for k, v in launches.items() if v} }")
    out = {"launches": launches, "steps": steps, "train_loss": losses, "fit_s": fit_s}
    return {**out, "model": model} if keep_model else out


def bf16_wide_fit_phase(torch, np, port, df, dataset, dev) -> dict:
    """``bf16 wide fit``: SASRec at the package defaults (d 256, 4 heads, 2
    blocks, L 100), batch 512, 2 epochs in f32 and then in bf16 from the same
    seed (``bf16_fit_phase``: launches, a profiled step's device kernels with
    no f32 loss kernel, losses within BF16_LOSS_RTOL, HitRate@10 within
    BF16_HIT_BAND, train examples/s of both, one step's loss gradients against
    kernel 7's twin); then one bf16 epoch of HSTU at d 256 and one of SASRec
    at d 16."""
    f32 = _f32_fit(torch, np, port, dataset, dev, WIDE_FIT)
    fit = bf16_fit_phase(torch, np, port, df, dataset, dev, f32, width=WIDE_FIT)
    hstu = _epoch(torch, np, port, dataset, dev, "hstu", WIDE_FIT, "bf16 wide hstu")
    narrow = _epoch(torch, np, port, dataset, dev, "sasrec", NARROW_FIT, "bf16 narrow")
    return {"f32": f32, "fit": fit, "hstu": hstu, "narrow": narrow}


def bf16_wide_mesh_steps(torch, np, port, dataset, dev) -> dict:
    """``bf16 wide mesh``: SASRec at d 256 with bf16 compute at
    ``mesh_shape=(1, 1)`` in the one-rank world, two train steps on one batch
    by the route the card's plan gives (kernel 8, then 9, or 10 + 11 where
    kernel 9's f32 partials pass the budget: 679 MB at 51,200 x 15,872) and
    two by the other route (the budget lifted, or forced to 0): the bf16
    forms once a step each, no f32 loss kernel, losses finite and falling."""
    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import softmax_lse

    bf = torch.bfloat16
    model = _mesh_model(dev, (1, 1), 1, width=WIDE_FIT, compute_dtype="bfloat16")
    model._build_model_from_dataset(dataset)
    tm = model.training_module
    tm.init_params()
    loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
    batch = tm._device_batch(tm._local_batch(pad_batch(next(iter(loader)), TRAIN_B)))
    m, n, d = TRAIN_B * SESSION_MAX_LEN, model.backbone.item_model.n_items, WIDE_FIT["n_factors"]
    fused = softmax_lse._fused_on_the_card(m, n, d, 4, bf)
    keys = ("lse_bias_fwd_bf16", "lse_bwd_fused_bf16", "lse_bwd_ds_bf16", "lse_bwd_di_bf16", "lse_bias_fwd",
            "lse_bwd_fused", "lse_bwd_ds", "lse_bwd_di", "lse_partials_fwd_bf16", "ce_grads_fused_bf16")
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    out = {}
    for name, forced in (("plan", None), ("other_route", 0 if fused else 1 << 62)):
        takes_fused = fused if forced is None else not fused
        if forced is not None:
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = forced
        try:
            port.reset_launches()
            losses = [tm._train_step(batch).item() for _ in range(2)]
        finally:
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        launches = {k: port.LAUNCHES[k] for k in keys}
        want = {k: 0 for k in keys}
        want.update({"lse_bias_fwd_bf16": 2, **({"lse_bwd_fused_bf16": 2} if takes_fused else
                                                 {"lse_bwd_ds_bf16": 2, "lse_bwd_di_bf16": 2})})
        check(launches == want, f"bf16 wide mesh ({name}): launches {launches}, expected {want}")
        check(bool(np.isfinite(losses).all()) and losses[1] < losses[0], f"bf16 wide mesh ({name}): losses {losses}")
        route = "kernel 9" if takes_fused else "kernels 10 + 11"
        how = "the plan" if forced is None else ("the budget lifted" if forced else "the budget forced to 0")
        print(f"bf16 wide mesh: two steps at d = {d} on mesh (1, 1), {route} ({how}): launches "
              f"{ {k: v for k, v in launches.items() if v} }, losses {losses}")
        out[name] = {"launches": dict(port.LAUNCHES), "route": route, "train_loss": losses}
    return out


def bf16_wide_ops_phase(torch, dev) -> dict:
    """``bf16 wide ops``: the public loss ops on bf16 towers at 51,200 session
    rows whose forms at D = 256 and 16 no fit above runs. D = 256: the
    softmax gradients from z (kernel 12), the CE gradients at 32,768 items
    (kernel 7's two launches) and at 65,536 (the large-catalog route, 13 +
    14), all by the card's plan. D = 16, on the KION catalog: the biased lse's
    VJP (kernel 9) and kernel 12, and with the budget forced kernels 10 + 11
    and 13 + 14 (0) and kernel 7's two launches (under its one pass's
    partials). Finite results, the expected launches."""
    from rectools_tpu_torch.ops import _native, softmax_lse

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    m, n = TRAIN_B * SESSION_MAX_LEN, N_ITEM_IDS + 1
    budget = softmax_lse.FUSED_BWD_PARTIALS_BUDGET
    out = {}

    def run(fn, keys: tuple, forced: int = -1) -> None:
        if forced >= 0:
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = forced
        try:
            before = dict(_native.LAUNCHES)
            got = fn()
        finally:
            softmax_lse.FUSED_BWD_PARTIALS_BUDGET = budget
        counts = {k: v - before[k] for k, v in _native.LAUNCHES.items() if v != before[k]}
        check(counts == {k: 1 for k in keys} and all(bool(torch.isfinite(g).all()) for g in got),
              f"bf16 wide ops: launches {counts}, expected one each of {keys}, or a result not finite")

    for d in WIDE_WIDTHS:
        s = torch.randn((m, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((WIDE_LARGE_N if d == 256 else n, d), generator=gen, device=dev)).to(bf)
        pad = torch.rand((m,), generator=gen, device=dev) < 0.1
        coeff = torch.where(pad, 0.0, 1.0 / float((~pad).sum()))
        lse = softmax_lse.streaming_lse(s, items[:n])
        z = (lse - torch.log(coeff)).contiguous()
        _native.reset_launches()
        if d == 256:
            run(lambda: softmax_lse.softmax_grads_from_z(s, items[:n], z), ("grads_z_fused_bf16",))
            for rows, keys in ((WIDE_PAIR_N, ("ce_grads_ds_bf16", "ce_grads_di_bf16")),
                               (WIDE_LARGE_N, ("grads_z_ds_bf16", "grads_z_di_bf16"))):
                part = items[:rows]
                y = torch.where(pad, 0, torch.randint(1, rows, (m,), generator=gen, device=dev))
                z_rows = (softmax_lse.streaming_lse_fwd(s, part) - torch.log(coeff)).contiguous()
                run(lambda: softmax_lse.softmax_ce_grads_from_z(s, part, z_rows, y, coeff), keys)
        else:
            bias = torch.zeros((n,), device=dev)
            bias[n - 3:] = softmax_lse.NEG_BIG
            dlse = torch.randn((m,), generator=gen, device=dev) / m
            y = torch.where(pad, 0, torch.randint(1, n, (m,), generator=gen, device=dev))
            lse_b = softmax_lse.streaming_lse_fwd(s, items, bias)
            plan = softmax_lse.fused_bwd_plan(m, n, d, 132, softmax_lse._ds_itemsize(bf), bf)[2]
            run(lambda: softmax_lse.streaming_lse_bwd(s, items, bias, lse_b, dlse), ("lse_bwd_fused_bf16",))
            run(lambda: softmax_lse.softmax_grads_from_z(s, items, z), ("grads_z_fused_bf16",))
            run(lambda: softmax_lse.streaming_lse_bwd(s, items, bias, lse_b, dlse),
                ("lse_bwd_ds_bf16", "lse_bwd_di_bf16"), forced=0)
            run(lambda: softmax_lse.softmax_grads_from_z(s, items, z), ("grads_z_ds_bf16", "grads_z_di_bf16"), forced=0)
            run(lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff),
                ("ce_grads_ds_bf16", "ce_grads_di_bf16"), forced=plan - 1)
        out[f"d{d}"] = {"launches": dict(_native.LAUNCHES)}
        print(f"bf16 wide ops: D={d}: launches { {k: v for k, v in _native.LAUNCHES.items() if v} }")
        del s, items
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 16 at heads of 8

HEADS_OF_8_FIT = dict(n_factors=32, n_heads=4)  # the transformer config's default 4 heads at width 32: heads of 8
HEADS_OF_8 = HEADS_OF_8_FIT["n_factors"] // HEADS_OF_8_FIT["n_heads"]
# the bf16 attention and STU entries of the kernels line, whose forms at head dim 8 it gives beside them
HEADS_OF_8_ENTRIES = ("attention_fwd_bf16", "attention_bwd_bf16", "stu_fwd_bf16", "stu_bwd_bf16", "stu_ds_bf16")


def bf16_narrow_heads_phase(torch, np, port, dataset, dev, b: int = TRAIN_B) -> dict:
    """``bf16 narrow heads``: (a) the bf16 forms of kernels 2 and 5 at B = 512,
    H = 4, L = 100, heads of 8, causal with dropout and under BERT4Rec's bias,
    and of kernels 17-19 at the HSTU training shape with ad = lh = 8, each
    against its twin, the same bits on a rerun, timed beside its f32 form, its
    bf16 library call and its bound (result keys ending ``_dh8``); (b) one
    epoch each of SASRec and HSTU at n_factors 32 with 4 heads, in f32 and
    then in bf16 from the same seed: the bf16 loss within BF16_LOSS_RTOL of
    the f32 one, weights apart from the f32 fit's, the bf16 forms launched,
    and a profiled bf16 step that runs
    the bf16 device kernels and none of the f32 attention, STU or loss
    kernels."""
    import torch.nn.functional as F

    from rectools_tpu_torch.models.nn.transformers.training import pad_batch
    from rectools_tpu_torch.ops import attention

    t0 = time.perf_counter()
    dev_t = torch.device(dev)
    gen = torch.Generator(device=dev_t).manual_seed(SEED + 25)
    l, h, dh = SESSION_MAX_LEN, N_HEADS, HEADS_OF_8
    causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev_t).tril(), 0.0, -1e9)[None, None]
    kernels = _attention_bf16_case(torch, F, attention, gen, dev_t, b, l, h, dh, causal, "dh8_causal")
    bias = bert4rec_bias(torch, gen, dev_t, b, l)
    kernels.update(_attention_bf16_case(torch, F, attention, gen, dev_t, b, l, h, dh, bias, "dh8_bidirectional"))
    for name in ("attention_fwd_bf16", "attention_bwd_bf16"):
        kernels[f"{name}_dh8"] = kernels[f"{name}_dh8_causal"]
    kernels.update(_stu_bf16_case(torch, F, gen, dev_t, b, l, "_dh8", d=dh))
    torch.cuda.empty_cache()

    fits = {}
    for family, wanted, banned_keys in (("sasrec", BF16_DEVICE_KERNELS, BF16_BANNED_KERNELS),
                                        ("hstu", BF16_HSTU_DEVICE_KERNELS, BF16_HSTU_BANNED_KERNELS)):
        tag = f"bf16 narrow heads {FAMILY_TAGS[family]}".rstrip()
        f32 = _epoch(torch, np, port, dataset, dev, family, HEADS_OF_8_FIT, tag, "float32", keep_model=True)
        fit = _epoch(torch, np, port, dataset, dev, family, HEADS_OF_8_FIT, tag, keep_model=True)
        model, f32_model = fit.pop("model"), f32.pop("model")
        loss_rel = max(abs(a / c - 1) for a, c in zip(fit["train_loss"], f32["train_loss"]))
        check(loss_rel <= BF16_LOSS_RTOL,
              f"{tag}: bf16 loss {fit['train_loss']} against f32 {f32['train_loss']}: {loss_rel}")
        # the epoch's mean loss can agree to the last f32 bit (HSTU here); the f32 master weights show that the
        # bf16 fit computed other gradients
        f32_state = f32_model.backbone.state_dict()
        gaps = torch.cat([(v - f32_state[n]).abs().reshape(-1) for n, v in model.backbone.state_dict().items()])
        param_gap, param_mean_gap = gaps.max().item(), gaps.mean().item()
        check(param_gap > 0, f"{tag}: the bf16 fit's weights equal the f32 fit's")
        del f32_model, f32_state, gaps
        tm = model.training_module
        loader = model.data_preparator.get_dataloader_train(np.random.default_rng(SEED))
        batch = tm._device_batch(pad_batch(next(iter(loader)), TRAIN_B))
        names = list(device_kernels(torch, lambda: tm._train_step(batch), 1))
        missing, banned = bf16_step_kernels(names, wanted, banned_keys)
        check(not missing and not banned, f"{tag}: a step's device kernels: missing {missing}, f32 or library {banned}")
        print(f"{tag}: bf16 loss {fit['train_loss']} beside f32 {f32['train_loss']} (relative gap {loss_rel:.3g}, "
              f"limit {BF16_LOSS_RTOL}); weights {param_gap:.3g} apart at most, {param_mean_gap:.3g} on average; "
              f"a profiled bf16 step ran {len(names)} device kernels, the {len(wanted)} "
              "bf16 forms and LayerNorm's among them, no f32 attention, STU, loss or LayerNorm kernel, no library "
              "attention or cross-entropy")
        fits[family] = {**fit, "f32_train_loss": f32["train_loss"], "f32_fit_s": f32["fit_s"],
                        "loss_rel_to_f32": loss_rel, "param_max_abs_diff_to_f32": param_gap,
                        "param_mean_abs_diff_to_f32": param_mean_gap, "step_device_kernels": len(names)}
        del model, tm, batch
        torch.cuda.empty_cache()
    wall_s = time.perf_counter() - t0
    print(f"bf16 narrow heads: wall {wall_s:.1f} s")
    return {"kernels": kernels, "fits": fits, "wall_s": wall_s}


def bf16_phase(torch, np, pd, port, df, dataset, dev, f32: dict, hstu_f32: dict, reports: dict) -> dict:
    """The ``bf16`` phase: (a) the kernel forms (2, 5-14 with kernel 7's two
    launches, and 17-19), and the loss forms 6-14 at D = 256 and 16 (``bf16
    wide kernels``), (b) the SASRec fit beside phase 5's and the HSTU fit
    beside phase 7's, then the fits at the package defaults (``bf16 wide
    fit``) and the public ops at both widths (``bf16 wide ops``), then the
    forms of kernels 2, 5 and 17-19 and SASRec's and HSTU's epochs at heads of
    8 (``bf16 narrow heads``), (c) BERT4Rec and eSASRec, (d) the bf16 forms of
    kernels 15, 16, 1 and 4 (``bf16 lse and layer norm``);
    its wall. The bf16 fits on the 65,536- and
    196,608-row catalogs run after phase 9's f32 fits (``bf16 mid fit``,
    ``bf16 large fit``), the mesh steps at D = 256 in phase 8 (``bf16 wide
    mesh``)."""
    t0 = time.perf_counter()
    kernels = bf16_kernel_phase(torch, torch.device(dev))
    kernels.update(stu_bf16_kernel_phase(torch, torch.device(dev)))
    kernels.update(mesh_bf16_kernel_phase(torch, torch.device(dev)))
    kernels.update(ce_split_bf16_kernel_phase(torch, torch.device(dev)))
    wide_t0 = time.perf_counter()
    kernels.update(bf16_wide_kernel_phase(torch, torch.device(dev), reports))
    print(f"bf16 wide kernels: wall {time.perf_counter() - wide_t0:.1f} s")
    fit = bf16_fit_phase(torch, np, port, df, dataset, dev, f32)
    hstu_fit = bf16_fit_phase(torch, np, port, df, dataset, dev, hstu_f32, family="hstu")
    wide = bf16_wide_fit_phase(torch, np, port, df, dataset, dev)
    wide["ops"] = bf16_wide_ops_phase(torch, torch.device(dev))
    narrow_heads = bf16_narrow_heads_phase(torch, np, port, dataset, dev)
    kernels.update(narrow_heads.pop("kernels"))
    families = bf16_family_phase(torch, np, port, dataset, dev)
    lse_ln = bf16_lse_ln_phase(torch, torch.device(dev))
    kernels.update(lse_ln.pop("kernels"))
    wall_s = time.perf_counter() - t0
    print(f"bf16: phase wall {wall_s:.1f} s")
    return {"kernels": kernels, "fit": fit, "hstu_fit": hstu_fit, "wide": wide, "narrow_heads": narrow_heads,
            "families": families, "lse_ln": lse_ln, "wall_s": wall_s}


def main() -> int:
    import torch

    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "rectools_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no rectools_tpu_torch/ beside {Path(__file__).name}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np
    import pandas as pd

    import rectools_tpu_torch.ops as port

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 2: build (the CUDA kernels and the native host ops; the host ops' numpy fallback must not hide here)
    from rectools_tpu_torch import native

    t0 = time.perf_counter()
    host_lib = native.lib()
    check(host_lib is not None, f"the native host ops did not build or load ({native.so_path()})")
    print(f"build: native host ops {native.so_path().relative_to(repo)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (g++ {' '.join(native.GXX_FLAGS)})")
    t0 = time.perf_counter()
    reports = port.build()
    print(f"build: {len(reports)} sources compiled in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    # phase 3: kernels, at serving shapes and at the training width
    kernels = kernel_phase(torch, torch.device("cuda"))
    kernels.update(train_kernel_phase(torch, torch.device("cuda")))
    kernels.update(stu_kernel_phase(torch, torch.device("cuda")))
    kernels.update(mesh_kernel_phase(torch, torch.device("cuda")))

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    t0 = time.perf_counter()
    df = kion_frame(np, pd, Columns)
    dataset = Dataset.construct(df)
    print(f"main: frame {len(df)} interactions, {dataset.user_id_map.size} users, "
          f"built in {time.perf_counter() - t0:.1f} s")

    # phase 4: the serving path
    main_result = main_phase(torch, np, port, df, dataset, "cuda")
    # phase 5: the training path
    train_result = train_phase(torch, np, port, df, dataset, "cuda")
    sasrec_fitted = train_result.pop("model")
    # phase 6: card against CPU twins
    agree_result = agreement_phase(torch, np, dataset, "cuda")
    # phase 7: HSTU through the same entry points
    hstu_main_result = main_phase(torch, np, port, df, dataset, "cuda", family="hstu")
    hstu_train_result = train_phase(torch, np, port, df, dataset, "cuda", family="hstu")
    hstu_fitted = hstu_train_result.pop("model")
    hstu_agree_result = agreement_phase(torch, np, dataset, "cuda", family="hstu")
    # phase 11: checkpoints of the fitted SASRec and HSTU; phase 12: cross-validation with the metrics
    for tag in ("checkpoint", "hstu checkpoint", "evaluate"):  # the card beside these phases' numbers
        print(f"{tag}: on {card}")
    checkpoint_result = checkpoint_phase(torch, np, pd, port, dataset, "cuda", sasrec_fitted)
    hstu_checkpoint_result = checkpoint_phase(torch, np, pd, port, dataset, "cuda", hstu_fitted, family="hstu")
    del sasrec_fitted, hstu_fitted
    evaluate_result = evaluate_phase(torch, np, pd, port, dataset, "cuda")
    # phase 13: the heuristic and linear-algebra models on the same frame
    print(f"classic: on {card}")
    baselines_result = classic_phase(torch, np, pd, port, df, dataset, "cuda")
    kernels["group_topm_truncation"] = baselines_result["truncation"]
    # phase 14: ALS, BPR, HybridMF and DSSM on the same frame
    print(f"factorization: on {card}")
    factorization_result = factorization_phase(torch, np, pd, port, df, dataset, "cuda")
    # phase 15: two-stage ranking, the ANN recommenders, compat and the visual apps on the same frame
    print(f"ranking: on {card}")
    ranking_result = ranking_phase(torch, np, pd, port, df, dataset, "cuda",
                                   evaluate_result["metrics"] + baselines_result["evaluate"]["metrics"])
    # phase 16: mixed-precision training (compute_dtype="bfloat16") on the bf16 forms of kernels 2, 5-14, 17-19, the
    # loss forms also at the widths 256 (the models' default) and 16
    print(f"bf16: on {card}")
    bf16_result = bf16_phase(torch, np, pd, port, df, dataset, "cuda", train_result, hstu_train_result, reports)
    kernels.update(bf16_result["kernels"])
    # phase 10: BERT4Rec and eSASRec (shared negatives, remat) through the same entry points, remat at the
    # ML-20M-sized shape
    for tag in ("family kernels", "bert4rec", "esasrec", "remat fit"):  # the card beside these phases' numbers
        print(f"{tag}: on {card}")
    kernels.update(family_kernel_phase(torch, torch.device("cuda"), reports))
    bert4rec_train_result = train_phase(torch, np, port, df, dataset, "cuda", family="bert4rec")
    bert4rec_main_result = main_phase(torch, np, port, df, dataset, "cuda", family="bert4rec",
                                      model=bert4rec_train_result.pop("model"))
    bert4rec_agree_result = agreement_phase(torch, np, dataset, "cuda", family="bert4rec")
    esasrec_result = esasrec_phase(torch, np, port, dataset, "cuda")
    esasrec_main_result = main_phase(torch, np, port, df, dataset, "cuda", family="esasrec",
                                     model=esasrec_result.pop("model"))
    esasrec_agree_result = agreement_phase(torch, np, dataset, "cuda", family="esasrec")
    esasrec_shared_agree_result = agreement_phase(torch, np, dataset, "cuda", family="esasrec",
                                                  negatives_sharing="batch", remat=True)
    remat_result = remat_fit_phase(torch, np, pd, port, "cuda")
    # phase 8: mesh training, one rank and four ranks
    mesh_result = mesh_fit_phase(torch, np, port, dataset, "cuda", train_result, bf16_result["fit"])
    mesh_4_result = mesh_fit_4_phase(torch, np, pd, "cuda")
    # phase 9: the other doors of the streaming lse
    ops_result = ops_phase(torch, torch.device("cuda"))
    classic_result = classic_fwd_phase(torch, np, port, dataset, "cuda")
    mid_result = large_fit_phase(torch, np, pd, port, "cuda", MID_N_ITEM_IDS)
    large_result = large_fit_phase(torch, np, pd, port, "cuda")
    # phase 16's fits on large catalogs: bf16 on kernel 7's two launches (65,536 rows, beside the f32 mid fit) and
    # on the large-catalog route (196,608 rows)
    print(f"bf16 mid fit: on {card}")
    bf16_mid_result = large_fit_phase(torch, np, pd, port, "cuda", MID_N_ITEM_IDS, mid_result, "bfloat16")
    print(f"bf16 large fit: on {card}")
    bf16_large_result = large_fit_phase(torch, np, pd, port, "cuda", XL_N_ITEM_IDS, None, "bfloat16")

    # name: (source, replaced TPU kernel, launch-count keys, entry of `kernels` with its numbers), by kernel number
    table = {
        "layer_norm_fwd": ("layer_norm.cu", "layer_norm.py:27", ("layer_norm_fwd",), "layer_norm_fwd"),
        "attention_fwd": ("attention.cu", "attention.py:104", ("attention_fwd",), "attention_fwd"),
        "group_topm": ("topk_select.cu", "topk_select.py:49", ("group_topm", "group_topm_warp"), "group_topm"),
        "layer_norm_bwd": ("layer_norm.cu", "layer_norm.py:36", ("layer_norm_bwd",), "layer_norm_bwd"),
        "attention_bwd": ("attention.cu", "attention.py:256", ("attention_bwd",), "attention_bwd"),
        "lse_partials_fwd": ("softmax_lse.cu", "softmax_lse.py:169", ("lse_partials_fwd",), "lse_partials_fwd"),
        "ce_grads": ("softmax_lse.cu", "softmax_lse.py:643", ("ce_grads_fused", "ce_grads_ds", "ce_grads_di"),
                     "ce_grads"),
        "lse_bias_fwd": ("softmax_lse.cu", "softmax_lse.py:99", ("lse_bias_fwd",), "lse_bias_fwd"),
        "lse_bwd_fused": ("softmax_lse.cu", "softmax_lse.py:234", ("lse_bwd_fused",), "lse_bwd_fused"),
        "lse_bwd_ds": ("softmax_lse.cu", "softmax_lse.py:205", ("lse_bwd_ds",), "lse_bwd_ds"),
        "lse_bwd_di": ("softmax_lse.cu", "softmax_lse.py:266", ("lse_bwd_di",), "lse_bwd_di"),
        "grads_z_fused": ("softmax_lse.cu", "softmax_lse.py:591", ("grads_z_fused",), "grads_z_fused"),
        "grads_z_ds": ("softmax_lse.cu", "softmax_lse.py:757", ("grads_z_ds",), "grads_z_ds"),
        "grads_z_di": ("softmax_lse.cu", "softmax_lse.py:774", ("grads_z_di",), "grads_z_di"),
        "lse_fwd": ("softmax_lse.cu", "softmax_lse.py:127", ("lse_fwd",), "lse_fwd"),
        "lse_shift_fwd": ("softmax_lse.cu", "softmax_lse.py:50", ("lse_shift_fwd",), "lse_shift_fwd"),
        "stu_fwd": ("stu_attention.cu", "stu_attention.py:90", ("stu_fwd", "stu_fwd_simt"), "stu_fwd"),
        "stu_bwd": ("stu_attention.cu", "stu_attention.py:274", ("stu_bwd", "stu_bwd_dq"), "stu_bwd"),
        "stu_ds": ("stu_attention.cu", "stu_attention.py:316", ("stu_ds",), "stu_ds"),
        # the bf16 forms (phase 16)
        "attention_fwd_bf16": ("attention_bf16.cu", "attention.py:104", ("attention_fwd_bf16",),
                               "attention_fwd_bf16"),
        "attention_bwd_bf16": ("attention_bf16.cu", "attention.py:256", ("attention_bwd_bf16",),
                               "attention_bwd_bf16"),
        "lse_partials_fwd_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:169", ("lse_partials_fwd_bf16",),
                                  "lse_partials_fwd_bf16"),
        "ce_grads_fused_bf16": ("ce_grads_bf16.cu", "softmax_lse.py:643", ("ce_grads_fused_bf16",),
                                "ce_grads_fused_bf16"),
        "stu_fwd_bf16": ("stu_attention_bf16.cu", "stu_attention.py:90", ("stu_fwd_bf16",), "stu_fwd_bf16"),
        "stu_bwd_bf16": ("stu_attention_bf16.cu", "stu_attention.py:274", ("stu_bwd_bf16", "stu_bwd_dq_bf16"),
                         "stu_bwd_bf16"),
        "stu_ds_bf16": ("stu_attention_bf16.cu", "stu_attention.py:316", ("stu_ds_bf16",), "stu_ds_bf16"),
        "lse_bias_fwd_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:99", ("lse_bias_fwd_bf16",), "lse_bias_fwd_bf16"),
        "lse_bwd_fused_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:234", ("lse_bwd_fused_bf16",),
                               "lse_bwd_fused_bf16"),
        "lse_bwd_ds_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:205", ("lse_bwd_ds_bf16",), "lse_bwd_ds_bf16"),
        "lse_bwd_di_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:266", ("lse_bwd_di_bf16",), "lse_bwd_di_bf16"),
        "ce_grads_pair_bf16": ("ce_grads_bf16.cu", "softmax_lse.py:643", ("ce_grads_ds_bf16", "ce_grads_di_bf16"),
                               "ce_grads_pair_bf16"),
        "grads_z_fused_bf16": ("ce_grads_bf16.cu", "softmax_lse.py:591", ("grads_z_fused_bf16",),
                               "grads_z_fused_bf16"),
        "grads_z_ds_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:757", ("grads_z_ds_bf16",), "grads_z_ds_bf16"),
        "grads_z_di_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:774", ("grads_z_di_bf16",), "grads_z_di_bf16"),
        "layer_norm_fwd_bf16": ("layer_norm.cu", "layer_norm.py:27", ("layer_norm_fwd_bf16",), "layer_norm_fwd_bf16"),
        "layer_norm_bwd_bf16": ("layer_norm.cu", "layer_norm.py:36", ("layer_norm_bwd_bf16",), "layer_norm_bwd_bf16"),
        "lse_fwd_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:127", ("lse_fwd_bf16",), "lse_fwd_bf16"),
        "lse_shift_fwd_bf16": ("softmax_lse_bf16.cu", "softmax_lse.py:50", ("lse_shift_fwd_bf16",),
                               "lse_shift_fwd_bf16"),
    }
    # mesh_fit_4 counts one rank's launches (every rank's are equal); kernels 10
    # and 11 run where the partials budget is forced to 0; `ops` calls the public
    # ops whose kernels no model path runs (12, 16); the mid-catalog fit runs
    # kernel 7's two launches
    paths = {"recommend": main_result, "fit": train_result, "hstu_recommend": hstu_main_result,
             "hstu_fit": hstu_train_result, "mesh_fit": mesh_result, "mesh_fit_4": mesh_4_result,
             "mesh_fit_budget_forced": {"launches": mesh_result["launches_budget_forced"]},
             "ops": ops_result, "fit_classic_fwd": classic_result, "fit_mid_catalog": mid_result,
             "fit_large_catalog": large_result, "bert4rec_recommend": bert4rec_main_result,
             "bert4rec_fit": bert4rec_train_result,
             "esasrec_fit": {"launches": {key: sum(fit["launches"][key] for fit in esasrec_result["fits"].values())
                                          for key in port.LAUNCHES}},
             "esasrec_recommend": esasrec_main_result, "remat_fit": remat_result["remat"],
             "checkpoint_recommend": checkpoint_result, "hstu_checkpoint_recommend": hstu_checkpoint_result,
             "evaluate": evaluate_result, "classic": baselines_result, "factorization": factorization_result,
             "ranking": ranking_result, "bf16_fit": bf16_result["fit"], "bf16_hstu_fit": bf16_result["hstu_fit"],
             "bf16_bert4rec_fit": bf16_result["families"]["bert4rec"],
             "bf16_esasrec_fit": bf16_result["families"]["esasrec"], "bf16_mesh_fit": mesh_result["bf16"],
             "bf16_mesh_fit_budget_forced": {"launches": mesh_result["bf16"]["launches_budget_forced"]},
             "bf16_mesh_fit_4": mesh_4_result["bf16"], "bf16_fit_mid_catalog": bf16_mid_result,
             "bf16_fit_large_catalog": bf16_large_result,
             "bf16_lse_ops": bf16_result["lse_ln"]["ops"][N_FACTORS]}
    # the paths that run the bf16 loss forms at the widths 256 and 16, by width: the fits, the mesh steps and the
    # public ops of phase 16 (``bf16 wide ...``); they count in the entries' launches too
    wide = bf16_result["wide"]
    width_paths = {
        256: {"bf16_wide_fit": wide["fit"], "bf16_wide_hstu_fit": wide["hstu"],
              "bf16_wide_mesh_steps": mesh_result["bf16"]["wide_steps"]["plan"],
              "bf16_wide_mesh_steps_other_route": mesh_result["bf16"]["wide_steps"]["other_route"],
              "bf16_wide_ops": wide["ops"]["d256"]},
        16: {"bf16_narrow_fit": wide["narrow"], "bf16_narrow_ops": wide["ops"]["d16"]},
    }
    for by_width in width_paths.values():
        paths.update(by_width)
    # the paths that run the bf16 attention and STU forms at heads of 8: phase 16's epochs at n_factors 32, 4 heads
    narrow_fits = bf16_result["narrow_heads"]["fits"]
    dh8_paths = {"bf16_heads_of_8_fit": narrow_fits["sasrec"], "bf16_heads_of_8_hstu_fit": narrow_fits["hstu"]}
    paths.update(dh8_paths)

    def numbers(r: dict) -> dict:
        out = {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
               "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        if "bound_f32" in r:  # tensor-core kernels: bound_ms counts 3xTF32 products; the FP32 bound beside it
            out.update(bound_ops="3xTF32", bound_f32_ms=r["bound_f32"][0], bound_f32_by=r["bound_f32"][1])
        if "device_ms" in r:  # kernel 4: its device time by the profiler beside the event-timed call
            out["device_ms"] = r["device_ms"]
        if "f32_ms" in r:  # the bf16 forms: bound_ms at the bf16 rate, the f32 form's time on the same values
            out.update(bound_ops=r.get("bound_ops", "bf16"), f32_ms=r["f32_ms"], max_rel_err=r["max_rel_err"])
        if "ms_dropout_0" in r:  # kernel 2 bf16: without dropout, and on the device beside SDPA's kernels
            out.update({k: r[k] for k in ("ms_dropout_0", "device_ms", "device_ms_dropout_0", "library_device_ms")})
        return out

    entries = []
    for name, (source, replaces, keys, result_key) in table.items():
        by_path = {path: sum(result["launches"].get(key, 0) for key in keys) for path, result in paths.items()}
        entry = {"name": name, "route": "cuda", "source": f"rectools_tpu_torch/csrc/{source}",
                 "replaces": f"rectools_tpu/ops/{replaces}", "launches": sum(by_path.values()),
                 "launches_by_path": by_path, **numbers(kernels[result_key])}
        if name == "group_topm":  # at ItemKNN's truncation shape: plain co-counts, many ties
            truncation = kernels["group_topm_truncation"]
            entry["item_knn_truncation"] = {**numbers(truncation), "m": truncation["m"],
                                            "rowwise_library_ms": truncation["rowwise_library_ms"],
                                            "blocks": truncation["blocks"], "certificate_fired": truncation["fired"],
                                            "whole_table": numbers(truncation["whole"]),
                                            "m_128": {**numbers(truncation["m_128"]),
                                                      "rowwise_library_ms": truncation["m_128"]["rowwise_library_ms"]}}
        if name == "attention_fwd":  # the same kernel at the training width, with dropout
            entry["train_width_dropout"] = numbers(kernels["attention_fwd_train"])
        if name.startswith("attention_"):  # under BERT4Rec's key-padding bias, and at L = 200 with heads of 32
            entry["bidirectional"] = numbers(kernels[f"{name}_bidirectional"])
            if not name.endswith("_bf16"):
                entry["remat_shape"] = numbers(kernels[f"{name}_remat_shape"])
        if name in ("layer_norm_fwd", "layer_norm_bwd"):  # at width 256
            entry["remat_shape"] = numbers(kernels[f"{name}_remat_shape"])
        if name in ("lse_partials_fwd", "ce_grads"):  # on BERT4Rec's 15,873-row catalog
            entry["bert4rec"] = numbers(kernels[f"{name}_bert4rec"])
        if name == "lse_partials_fwd":  # at 102,400 x 20,480 x 256, the SIMT tile
            entry["remat_shape"] = numbers(kernels["lse_partials_fwd_remat_shape"])
        if name in ("grads_z_ds", "grads_z_di"):  # the CE route there: kernels 13 + 14 and the label term
            entry["remat_shape_route"] = numbers(kernels["grads_z_pair_remat_shape"])
        if name.startswith("stu_"):  # the same kernel at B = 64, L = 1,024
            entry["long_ctx"] = numbers(kernels[f"{name}_long_ctx"])
        if name == "stu_fwd":  # and at the recommend batch, B = 4,096, L = 100
            entry["serving"] = numbers(kernels["stu_fwd_serving"])
        if name.startswith("lse_b"):  # the same kernel on a (2, 2) mesh's shard and on a shard with an invalid row
            entry["shard_2x2"] = numbers(kernels[f"{name}_shard_2x2"])
            entry["ragged_shard"] = numbers(kernels[f"{name}_ragged_shard"])
        if name in ("grads_z_ds", "grads_z_di"):  # the same kernel at 51,200 x 131,072
            entry["large_catalog"] = numbers(kernels[f"{name}_large_catalog"])
        if name == "lse_partials_fwd":  # the same kernel at 65,536 and 131,072 items
            entry["mid_catalog"] = numbers(kernels["lse_partials_fwd_mid_catalog"])
            entry["large_catalog"] = numbers(kernels["lse_partials_fwd_large_catalog"])
        if name == "lse_shift_fwd":  # the same kernel with every row in window 2
            entry["window_2"] = numbers(kernels["lse_shift_fwd_window_2"])
        if name == "ce_grads_pair_bf16":  # unforced at 65,536 items
            entry["mid_catalog"] = numbers(kernels["ce_grads_pair_bf16_mid_catalog"])
        if name in ("grads_z_ds_bf16", "grads_z_di_bf16"):  # unforced at 196,608 items; there the CE route
            entry["large_catalog"] = numbers(kernels[f"{name}_large_catalog"])
            entry["large_catalog_route"] = kernels["ce_grads_large_catalog_route_bf16"]
        if name == "ce_grads":  # kernel 7's two launches; at 51,200 x 131,072 the split route beside its one pass
            entry["two_launch_pair"] = numbers(kernels["ce_grads_pair"])
            entry["large_catalog_route"] = kernels["ce_grads_large_catalog_route"]
        if name in BF16_LOSS_ENTRIES:  # the same kernel's forms at D = 256 and 16: numbers, launches on their paths
            for d, wpaths in width_paths.items():
                w_by_path = {path: sum(result["launches"].get(key, 0) for key in keys) for path, result in wpaths.items()}
                sub = {**numbers(kernels[f"{name}_d{d}"]), "launches": sum(w_by_path.values()),
                       "launches_by_path": w_by_path}
                for tag in ("_shard_2x2", "_large_catalog"):
                    if f"{name}_d{d}{tag}" in kernels:
                        sub[tag[1:]] = numbers(kernels[f"{name}_d{d}{tag}"])
                check(sub["launches"] > 0, f"{name} at D={d}: no path launched it")
                entry[f"d{d}"] = sub
        if name in LSE_LN_BF16_ENTRIES:  # at D = 256 and 16: LayerNorm on the fits of that width, the lse on its ops
            for d in (256, 16):
                wpaths = (width_paths[d] if name.startswith("layer_norm_")
                          else {f"bf16_lse_ops_d{d}": bf16_result["lse_ln"]["ops"][d]})
                w_by_path = {path: sum(result["launches"].get(key, 0) for key in keys) for path, result in wpaths.items()}
                sub = {**numbers(kernels[f"{name}_d{d}"]), "launches": sum(w_by_path.values()),
                       "launches_by_path": w_by_path}
                check(sub["launches"] > 0, f"{name} at D={d}: no path launched it")
                entry[f"d{d}"] = sub
            if name.startswith("layer_norm_"):  # 51,199 rows: the backward's last block one row short
                entry["ragged"] = numbers(kernels[f"{name}_ragged"])
        if name in HEADS_OF_8_ENTRIES:  # the same kernel's form at head dim 8: numbers, launches on the epochs there
            h_by_path = {path: sum(result["launches"].get(key, 0) for key in keys)
                         for path, result in dh8_paths.items()}
            sub = {**numbers(kernels[f"{name}_dh8"]), "launches": sum(h_by_path.values()),
                   "launches_by_path": h_by_path}
            if name.startswith("attention_"):
                sub["bidirectional"] = numbers(kernels[f"{name}_dh8_bidirectional"])
            check(sub["launches"] > 0, f"{name} at head dim 8: no path launched it")
            entry["dh8"] = sub
        if name == "attention_fwd_bf16":  # the one-pass kernel the entry launches
            entry["device_kernel"] = ATTN_BF16_FWD_KERNEL
        if name in ("attention_fwd_bf16", "attention_bwd_bf16"):  # at the heads of the widths 256 and 16 (64, 16)
            for (_, dh), d in zip(WIDE_HEADS, WIDE_WIDTHS):
                w_by_path = {path: sum(result["launches"].get(key, 0) for key in keys)
                             for path, result in width_paths[d].items()}
                sub = {**numbers(kernels[f"{name}_dh{dh}"]), "launches": sum(w_by_path.values()),
                       "launches_by_path": w_by_path, "bidirectional": numbers(kernels[f"{name}_dh{dh}_bidirectional"])}
                check(sub["launches"] > 0, f"{name} at head dim {dh}: no path launched it")
                entry[f"dh{dh}"] = sub
        check(entry["launches"] > 0, f"{name}: no path launched it")
        entries.append(entry)
    for key, before_ms in SIMT_TILE_MS.items():  # redesigned
        print(f"redesigned: {key} {kernels[key]['ms']:.4f} ms beside {before_ms} ms before its redesign (PERF.md §6)")
    line = {
        "kernels": entries,
        "recommend": {k: v for k, v in main_result.items() if k != "launches"},
        "train": {**{k: v for k, v in train_result.items() if k != "launches"}, "agreement": agree_result},
        "hstu_recommend": {k: v for k, v in hstu_main_result.items() if k != "launches"},
        "hstu_train": {**{k: v for k, v in hstu_train_result.items() if k != "launches"},
                       "agreement": hstu_agree_result},
        "mesh_fit": {**{k: v for k, v in mesh_result.items() if not k.startswith("launches") and k != "bf16"},
                     "bf16": {k: v for k, v in mesh_result["bf16"].items()
                              if not k.startswith("launches") and k != "wide_steps"}},
        "mesh_fit_4": {**{k: v for k, v in mesh_4_result.items() if k not in ("launches", "bf16")},
                       "bf16": {k: v for k, v in mesh_4_result["bf16"].items() if k != "launches"}},
        "ops": {k: v for k, v in ops_result.items() if k != "launches"},
        "fit_classic_fwd": {k: v for k, v in classic_result.items() if k != "launches"},
        "fit_mid_catalog": {k: v for k, v in mid_result.items() if k != "launches"},
        "fit_large_catalog": {k: v for k, v in large_result.items() if k != "launches"},
        "bf16_fit_mid_catalog": {k: v for k, v in bf16_mid_result.items() if k != "launches"},
        "bf16_fit_large_catalog": {k: v for k, v in bf16_large_result.items() if k != "launches"},
        "bert4rec_recommend": {k: v for k, v in bert4rec_main_result.items() if k != "launches"},
        "bert4rec_train": {**{k: v for k, v in bert4rec_train_result.items() if k != "launches"},
                           "agreement": bert4rec_agree_result},
        "esasrec_train": {"fits": {name: {k: v for k, v in fit.items() if k != "launches"}
                                   for name, fit in esasrec_result["fits"].items()},
                          **{k: v for k, v in esasrec_result.items() if k != "fits"},
                          "agreement": esasrec_agree_result, "agreement_shared_remat": esasrec_shared_agree_result},
        "esasrec_recommend": {k: v for k, v in esasrec_main_result.items() if k != "launches"},
        "remat_fit": {k: ({kk: vv for kk, vv in v.items() if kk != "launches"} if isinstance(v, dict) else v)
                      for k, v in remat_result.items()},
        "checkpoint": {k: v for k, v in checkpoint_result.items() if k != "launches"},
        "hstu_checkpoint": {k: v for k, v in hstu_checkpoint_result.items() if k != "launches"},
        "evaluate": {k: v for k, v in evaluate_result.items() if k != "launches"},
        "classic": {k: v for k, v in baselines_result.items() if k != "launches"},
        "factorization": {k: v for k, v in factorization_result.items() if k != "launches"},
        "ranking": {k: v for k, v in ranking_result.items() if k != "launches"},
        "bf16": {"fit": {k: v for k, v in bf16_result["fit"].items() if k != "launches"},
                 "hstu_fit": {k: v for k, v in bf16_result["hstu_fit"].items() if k != "launches"},
                 "families": {f: {k: v for k, v in r.items() if k != "launches"}
                              for f, r in bf16_result["families"].items()},
                 "lse_ln_wall_s": bf16_result["lse_ln"]["wall_s"], "wall_s": bf16_result["wall_s"],
                 "narrow_heads": {"fits": {f: {k: v for k, v in r.items() if k != "launches"}
                                           for f, r in narrow_fits.items()},
                                  "wall_s": bf16_result["narrow_heads"]["wall_s"]},
                 "wide": {"build": kernels["build"], "f32_fit": wide["f32"],
                          "fit": {k: v for k, v in wide["fit"].items() if k != "launches"},
                          "hstu": {k: v for k, v in wide["hstu"].items() if k != "launches"},
                          "narrow": {k: v for k, v in wide["narrow"].items() if k != "launches"},
                          "mesh_steps": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                         for k, v in mesh_result["bf16"]["wide_steps"].items()},
                          "large_catalog_route": kernels["ce_grads_large_catalog_route_bf16_d256"]}},
    }
    print(f"chip_smoke: wall {time.perf_counter() - script_t0:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
