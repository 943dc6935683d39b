#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the hand-written CUDA kernels
from ``src/repro_torch/kernels/csrc`` with nvcc, then:

1. prints the card (name and power limit);
2. holds each kernel (dense_tile_spmm, gather_spmm, gather_spmm_ksharded,
   dense_tile_sddmm, gather_sddmm) against its plain PyTorch version on
   the card, on the ogbn-arxiv and reddit stand-ins (N = D = 256), and
   the structured lane's nm_tile_spmm on the dlmc-nm-1-32 and dlmc-nm-2-32
   stand-ins and bitmap_tile_spmm on dlmc-unstr with the bitmap hint; then
   the paths of the redesigned kernels: dense_tile_spmm on 2.5 %-dense
   tiles with one window of 4,096 tiles (split into chunks and reduced)
   and on tiles alternating 2 % and 50 % density (zero-skipping walk and
   3xTF32 tensor-core product in one launch), nm_tile_spmm at 2:4 and 1:32
   and bitmap_tile_spmm on tiles alternating 2 % and 50 % (bit walk and
   decode + 3xTF32), with N = 2,048; then the non-finite phase: the same
   stand-ins of dense_tile_spmm, nm_tile_spmm (2:4 and 1:32) and
   bitmap_tile_spmm with +Inf, -Inf and NaN in B, each held against its
   plain (dense-tile) version with NaN and +-Inf in the same cells; then
   the gradient phase: on the cora stand-in, "cuda" ``spmm`` (also after
   ``with_values``) and ``bspmm`` with a grad-requiring B against
   ``torch.sparse.mm`` on the CSR of the same COO with autograd, and
   ``sddmm``'s gradients in X and Y against fp64 dense autograd;
3. drives four paths through the user entry points, each with the kernel
   launch counts set to 0 just before it and read just after it:
   ``from_coo`` + ``spmm`` (N = 256) + ``bspmm`` (batch 4, N = 64) on a
   Reddit-scale graph (232,965 nodes, average degree 492, power-law skew
   1.05, seed 10), which must launch dense_tile_spmm and gather_spmm; then
   ``from_coo`` + ``spmm`` on the ogbn-arxiv stand-in, whose default plan
   takes the k-sharded fringe tier and must launch gather_spmm_ksharded;
   then the graph-attention path: one forward of ``SparseGraphAttention``
   (one head of width 256) over the Reddit-scale plan of the first path,
   on seeded features of Reddit's width 602 (``sddmm`` -> edge softmax ->
   ``with_values`` -> ``spmm``), which must launch dense_tile_sddmm,
   gather_sddmm, dense_tile_spmm and gather_spmm and not
   gather_spmm_ksharded; then the GCN training path: 20 full-batch SGD
   steps of the reference example's two-layer GCN (``SparseGraphConv``
   twice, hidden 256) at ogbn-arxiv's size (169,343 nodes, 128 features,
   40 classes, 2.48 M nonzeros from the example's generator, symmetrised,
   row-normalised so that A is not its own transpose), whose forward must
   launch dense_tile_spmm and a fringe kernel on A and whose backward the
   same on the transpose plan; step 0's four SpMMs (two on A, two on the
   transpose plan, each at its N) are held against ``torch.sparse.mm`` on
   the CSR of A and of Aᵀ, its gradients of W1 and W2 against the same
   model on ``torch.sparse.mm`` with autograd (both within 1e-4 * max
   |ref|, no floor of 1), and its loss must fall; its step time (forward,
   backward, update by CUDA events) is printed beside the library's, the
   transpose plan's prepare seconds and where the backward's host time
   goes (cProfile).
   Two more paths, on the plans above: the Reddit-scale per-path phase
   runs ``execute_matrix_path`` and ``execute_vector_path`` (N = 256) on
   the first path's plan, which must launch dense_tile_spmm alone and
   gather_spmm alone, and whose sum must be ``spmm``'s result bit for bit,
   also with +Inf, -Inf and NaN in B; it times each path by CUDA events,
   as a synchronised wall time, and the two on two streams from one
   synchronised start, beside the fused ``spmm``, and prints the skew.
   The coordination path runs ``NeutronSpMM.run_epoch`` for 10 epochs on
   the GCN path's graph with a seeded B (N = 256), each epoch's result
   against ``torch.sparse.mm`` on its CSR, prints the epoch log, each
   prepare's seconds and the launches per epoch, then times the fused
   ``execute`` and its two paths at every alpha of the trajectory and at
   alpha = 1.0 (all fringe) and names the fastest beside the alpha the
   coordinator ended at.  Telemetry: the same graph's plan prepared with
   ``telemetry=True`` must give ``execute`` and the two paths bit for bit
   as with it off, with the same launches, and a roofline row per kind of
   dispatch; the matrix-path against fringe-path report of
   ``obs.snapshot()`` (H100 ceilings) is printed.
   ``spmm`` is checked against ``torch.sparse.mm``
   on the same COO, ``bspmm`` against four ``spmm`` calls, the attention
   forward against ``torch.sparse.sampled_addmm`` scores, the same edge
   softmax and ``torch.sparse.mm``, and ``sddmm`` against
   ``torch.sparse.sampled_addmm``;
4. times each kernel at its path's shapes with CUDA events, next to its
   plain version, one PyTorch library call computing the same function,
   and its bound on the card, and prints them as one JSON line.
   gather_spmm_ksharded is also held and timed on the Reddit-scale fringe,
   pushed onto the k-sharded tier (printed on its own line), and on both
   streams with an Inf in the first B row of a padded k-block, whose
   padding entries must give NaN in row 0 as the plain version does.
   dense_tile_sddmm and gather_sddmm run twice at reddit scale, bit-
   identical; the SDDMM fringe's row runs in input order and in the
   walk's order are printed before gather_sddmm is timed.
   dense_tile_spmm runs twice on the reddit-scale plan, and the two results
   must be bit-identical; then it and bitmap_tile_spmm are timed on one
   4,096-tile stream at each tile density of SWEEP_DENSITIES (one JSON
   line each).  gather_spmm runs twice on the reddit-scale fringe (bit-
   identical), the fringe's row lengths and column concentration are
   printed, and the gather-bandwidth probe gives the card's ceilings for
   its reads (1 KB rows at random from a 24 MB and from the 238 MB B).
   The cost of the non-finite check (one read of B, and the every-entry
   kernel's launch, which returns at once) is printed beside each path's
   ``spmm`` time;
5. the pruned-weight paths (the structured lane): the MLP up-projection
   weight of Llama-2-7B (11,008 x 4,096) pruned 2:4 (``structure_hint=
   ("nm", 2, 4)``), 1:32 (detected without a hint) and 50 % unstructured
   (``structure_hint="bitmap"``), each ``from_coo`` + ``spmm`` on one
   2,048-token chunk, which must launch nm_tile_spmm, nm_tile_spmm and
   bitmap_tile_spmm once each and no other matrix-path kernel, plus one
   ``bspmm`` of batch 2 on the 2:4 plan; each result is held against
   ``torch.sparse.mm`` on the CSR of the same COO, and the two kernels are
   timed there as in 4, beside dense_tile_spmm on the same plans' general
   tiles and a dense ``torch.matmul`` of the weight;
6. the two-hop path: ``P = A @ A`` through the facade (``spspmm``) on the
   directed ogbn-arxiv-size graph of the GCN path's generator and seed
   (169,343 nodes, 1,326,032 nonzeros, 10,451,327 terms, 8,613,042
   product nonzeros; not cut), whose pattern must equal scipy's
   ``A @ A``, whose values must lie within 1e-4 * max |ref| of scipy's
   float64 product and be bit-equal to the port's plain version on the
   CPU and across two card runs; the host symbolic phase, the numeric
   phase (CUDA events) and the product's ``from_coo`` are timed beside
   cuSPARSE's SpGEMM (``torch.sparse.mm`` of A's CSR by itself); then
   ``spmm`` on P (N = 256) against ``torch.sparse.mm`` on P's CSR, which
   must launch dense_tile_spmm and a fringe kernel;
7. health, faults and deadlines on the card, on that A's plan:
   ``executor_build`` armed once for "cuda" signatures makes a ``bspmm``
   (batch 5, used by no other path) raise ``KernelLoweringError``, the
   next dispatch (inside the backoff) raises with no kernel launch, the
   retry launches and is bit-equal to an unarmed call, and the signature
   is healthy again with one recovery; ``pallas_lowering`` armed for good
   (batch 6) raises until the signature is demoted, and once disarmed it
   still raises with no launch until ``HEALTH.reset()``; ``deadline=0.0``
   raises ``DeadlineExceeded`` on ``spmm``, ``sddmm`` and ``spspmm``, and
   ``deadline=120.0`` gives the bits of the call without one;
8. the dynamic path, on the GCN path's graph at ogbn-arxiv size (169,343
   nodes, 2,481,327 nonzeros; not cut): ``from_coo(..., dynamic=True)``
   and the reference example's mutation stream (``mutate(steps=5,
   insert_frac=0.01, delete_frac=0.01, update_frac=0.05, seed=1)``: about
   24.8 k inserts, 24.8 k deletes and 124 k re-weights a step), N = 256;
   each step prints ``update()``'s host seconds and routing stats,
   ``_materialize``'s host seconds, the sidecar's capacity and tier,
   ``spmm`` by CUDA events beside the base plan alone, and the launches,
   and holds the result against ``torch.sparse.mm`` on the CSR of
   ``to_coo()`` and the sidecar's contribution against its plain version.
   The whole stream on the default tier, whose sidecar must launch
   gather_spmm once a call; the first two steps again under a budget that
   puts the sidecar on the k-sharded tier, which must launch
   gather_spmm_ksharded; both kernels are timed on their last sidecar
   beside the plain version, cuSPARSE and the bound, and with an Inf in B
   row 0 their NaN cells must be the plain version's.  Then B's gradient
   against ``torch.sparse.mm`` with autograd; a registry round trip (no
   ``prepare``, ``spmm`` bit-equal); ``executor_build`` armed around a
   fresh ``fused+delta`` build (``KernelLoweringError``, no launch); one
   ``compact()``, whose leaves must equal a fresh ``from_coo`` of
   ``to_coo()`` and whose ``spmm`` must be bit-equal to that plan's; and
   bench_dynamic's three rows (a value update of 1 % of the nonzeros, one
   structural batch, a full re-prepare, each with one ``spmm``) with their
   ratios.  It prints its wall time (``bench_torch/dynamic_probe.py`` runs
   it alone); B2 and B3 walk the sidecar in row orders that keep only the
   padding entries that change their sums;
9. the serving path (``serving_path``; ``bench_torch/serving_probe.py``
   runs it alone), on the same graph: ``SpmmService`` with a registry,
   one request, then 23 in flushes of 8, 8, 4, 2 and 1 (N = 256, each
   against ``torch.sparse.mm``; one dense_tile_spmm and one gather_spmm
   launch per flush; CUDA-event time per flush, p50/p99 submit -> fetch,
   requests/s); two steps of the stream through ``update_matrix``, each
   served request against the library on ``to_coo()``, and B2 on the
   sidecar with the cut row order and over every padding entry (bit-
   equal, both timed); a service whose sidecar takes the k-sharded tier
   (B3 must launch; cut and full walks bit-equal); a fold forced through
   a tuned ``delta_max_fraction`` with requests served against the old
   plan meanwhile and folded leaves equal to a fresh ``from_coo``;
   ``fold_build`` armed until the matrix is quarantined (it keeps
   serving; ``close()`` is clean); a warm start from the registry (no
   ``prepare``, bit-equal); and an ``autotune=True`` service whose
   background tune is adopted and read back by a fresh tuner with no
   microbenchmark, the tuned plan held against the library;
10. the sharded path (``sharded_path``; ``bench_torch/sharded_probe.py``
   runs it alone): a 4-way mesh over the visible cards, ``cuda:0`` four
   times on one card (``distributed.make_spmm_mesh(devices=...)``).  The
   main path's Reddit-scale COO sharded by rows (the single-device plan
   freed first): ``prepare_sharded`` seconds, ``auto_shard_axis``, the
   imbalance, rows and nonzeros per shard, the tier and the peak device
   memory; ``spmm`` (N = 256) and a batch-2 ``bspmm``, each the median of
   7 CUDA-event times, launching dense_tile_spmm and the fringe kernel
   once per shard per call, held against ``torch.sparse.mm`` and
   bit-equal across two calls; the assemble gather alone.  Then on the
   GCN path's graph at ogbn-arxiv size: an rhs-sharded ``spmm``; the
   sharded SDDMM at D = 256 (gather_sddmm over the global COO, no
   dense_tile_sddmm) against ``torch.sparse.sampled_addmm``, then
   ``with_values`` of it and ``spmm``; a sharded ``DynamicPlan`` through
   two steps of the reference example's stream with the routed sidecar
   (per step the fringe kernel twice per shard); a registry save and a
   ``SpmmService.warm_start(mesh=)`` re-sharded, bit-equal; and
   ``register_sharded`` with flushes of 8, 4, 2 and 1 requests, each
   against the library.  The kernels line adds this path's launches;
11. LM serving (``lm_serving_path``; ``bench_torch/lm_serving_probe.py``
   runs it alone): the model zoo's inference path, no kernel of the
   port's own.  ``qwen1.5-4b`` and ``granite-moe-3b-a800m`` at full width
   and depth (the repo's configs; bf16 compute, fp32 params from a seeded
   generator on the card), one after the other, each served through
   ``ServeEngine.generate``: batch 8, 128-token prompts from
   ``data.pipeline.make_batch`` (seed 0), 32 tokens; then qwen once more
   with 2,048-token prompts and 8 tokens (the cached decode crosses
   ``kv_chunk`` 1,024).  Checks: bf16 ``prefill`` against ``forward``'s
   last position within 5e-2 * max(1, max |ref|), finite logits, tokens
   below ``vocab_size``; ``blockwise_attention`` at qwen's 2,048-token
   shapes against a plain fp32 softmax, also with ``kv_len`` short of
   the cache; each model at fp32 compute with 2 layers (granite's
   capacity factor 8, as the reference's decode test sets it): ``prefill``
   and every ``decode_step`` teacher-forced against ``forward``, and
   greedy ``generate`` equal to greedy over ``forward``; the smoke
   configs of qwen, granite-moe, gemma2, mamba2 and zamba2 at fp32 on the
   card against the CPU from one carried-over tree.  Prints parameters,
   GB, peak device memory, prefill ms (CUDA events), decode ms a token
   (median), tokens/s, one decode step's device time (profiler) against
   its wall time, and the phase's seconds;
12. LM training (``lm_training_path``; ``bench_torch/lm_training_probe.py``
   runs it alone): no kernel of the port's own.  ``qwen1.5-4b`` and
   ``granite-moe-3b-a800m`` at full width and depth (bf16 compute, fp32
   params, ``remat="full"``), one after the other, each 4 steps of
   ``make_train_step`` under ``TrainController`` (``launch/train.py``'s
   AdamW with fp32 moments, batch 8 x 128 from ``data.pipeline`` seed 0,
   2 microbatches, no checkpoint written); prints per step the wall and
   device ms (CUDA events), tokens/s, loss and grad norm, the peak device
   memory, and one more step's device time by kernel (profiler, top 8)
   against the steps' median wall (idle share).  Checks: every loss and
   grad norm finite; at full width with 4 layers, ``remat="full"`` and
   ``"none"`` give the same loss and gradients bit for bit (deterministic
   kernels); the smoke configs of qwen, granite-moe, mamba2, zamba2 and
   phi-3-vision at fp32: one loss and every gradient on the card within
   1e-4 * max(1, max |ref|) of the CPU's, and two ``apply_updates`` with
   the CPU's gradients within 1e-6 * max(1, max |ref|); the restart drill
   on qwen's smoke config (a checkpoint every 5 steps, a failure at step
   6, 10 steps) ends in the uninterrupted run's params, moments and step
   bit for bit (deterministic kernels); ``examples/lm_training.py`` at its
   defaults passes its own assertion on the card; granite-moe's smoke
   config with the ``shard_map`` MoE on a 2 x 2 mesh of ``cuda:0``: loss
   and gradients within 1e-4 * max(1, max |ref|) of a 2 x 2 CPU mesh's;
   ``launch.train --grad-compression`` on qwen's smoke config, two steps
   from params drawn on the CPU: both losses within the same of the
   CPU's;
13. the dry run against the card (``dryrun_path``;
   ``bench_torch/dryrun_probe.py`` runs it alone): no kernel of the
   port's own.  ``launch.dryrun.run_cell`` traces ``qwen1.5-4b``'s train
   cell on the ``meta`` device on a 1 x 1 mesh at phase 12's size (8 x
   128, 2 microbatches, remat full; the cell's bf16 moments), then one
   step of the same cell runs on the card under ``FlopCounterMode`` with
   the peak memory reset first, and one more under the profiler.
   Checks: the card's FLOP count equals the dry run's traced count
   exactly (the counter applies the same shape formulas on both devices,
   so this holds the op sequence, not the count);
   ``argument_bytes`` equals the summed ``nbytes`` of the params,
   optimizer state and batch on the card; ``argument_bytes +
   temp_bytes`` is within 5 % of the step's peak
   (``max_memory_allocated`` less the bytes earlier phases hold).  Prints
   the dry run's H100 roofline bound beside the step's device time.
   Then the partitioned program: the same cell on a 1 x 2 (data x model)
   mesh, traced as rank 0 of a DTensor program over a ``fake`` process
   group, and rank 0's step of it on the card under a ``fake`` group of
   2 ranks (the collectives do no work; their values are held on the
   CPU): its counted FLOPs and collectives equal the dry run's per-device
   ones, its state's local ``nbytes`` equal ``argument_bytes``, and its
   peak is within 5 % of ``argument_bytes + temp_bytes``.  The same
   checks for ``granite-moe-3b-a800m``'s train cell (the dense MoE, full
   width and depth, phase 12's size) on a 2 x 1 mesh, where the MoE's
   capacity slots, expert outputs and token rows are split along d over
   data.

Tolerance everywhere: max |x - ref| <= 1e-4 * max(1, max |ref|) (fp32 on
both sides, different summation orders; the kernels' tensor-core path is
3xTF32, about fp32 accuracy, and PyTorch's TF32 switches stay off); the
GCN path's step-0 SpMMs and gradients, whose entries lie far below 1, are
held within 1e-4 * max |ref|.  Any
failure raises and the script exits nonzero without its result line.  The
last line is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX
or of the JAX package, and needs no network.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = 1e-4
N = 256
# graph attention: Reddit's node-feature width (Hamilton et al. 2017) and
# one head of the per-head width GAT uses on PPI (Velickovic et al. 2018)
D_IN = 602
D_HEAD = 256
# Reddit (Hamilton et al. 2017, GraphSAGE; DGL RedditDataset): 232,965
# nodes, 114.6M edges; the generator's dedup leaves 70,525,725 nonzeros
REDDIT = dict(name="reddit-full", m=232965, k=232965, avg_degree=492.0,
              kind="power_law", skew=1.05, seed=10)
# the pruned-weight paths: the MLP up-projection of Llama-2-7B
# (meta-llama/Llama-2-7b-hf config: intermediate_size 11008, hidden_size
# 4096; Touvron et al. 2023) times one 2,048-token prefill chunk, pruned
# 2:4 (the pattern of the sparse tensor cores, as SparseGPT and Wanda
# prune), 1:32 (the density of the repo's dlmc-nm-1-32) and 50 %
# unstructured (Wanda's headline setting); weights from seeds
PRUNED_M, PRUNED_K, PRUNED_N = 11008, 4096, 2048
PRUNED_PATHS = (
    # (label, density, generator spec, config overrides, the kernel it must
    # launch)
    ("2:4", 0.5, dict(kind="nm_pruned", nm=(2, 4), seed=24),
     dict(structure_hint=("nm", 2, 4)), "nm_tile_spmm"),
    ("1:32", 1 / 32, dict(kind="nm_pruned", nm=(1, 32), seed=32),
     {}, "nm_tile_spmm"),
    ("50% unstructured", 0.5, dict(kind="unstructured_pruned", seed=50),
     dict(structure_hint="bitmap"), "bitmap_tile_spmm"),
)
MATRIX_KERNELS = ("dense_tile_spmm", "nm_tile_spmm", "bitmap_tile_spmm")
# the GCN training path: ogbn-arxiv's published size (OGB, Hu et al. 2020:
# 169,343 nodes, 1,166,243 edges, 128 features, 40 classes; symmetrised
# with self-loops, 2,501,829 nonzeros) from the port's make_graph, whose
# avg_deg 3.6 gives 2,481,327; hidden width 256 as OGB's GCN baseline; the
# reference example's learning rate
ARXIV_GCN = dict(n=169343, avg_deg=3.6, n_classes=40, n_features=128,
                 symmetric=True, seed=0)
GCN_HIDDEN, GCN_STEPS, GCN_LR = 256, 20, 2.0
FRINGE_KERNELS = ("gather_spmm", "gather_spmm_ksharded")
# the two-hop path: ogbn-arxiv's size from the GCN path's generator and
# seed, left directed as OGB ships its citation edges (1,156,689 edges
# against OGB's 1,166,243, plus the self-loops); A @ A is the precomputed
# two-hop operator of SGC (Wu et al. 2019) and SIGN (Frasca et al. 2020)
TWO_HOP = dict(n=169343, avg_deg=3.6, n_classes=40, n_features=128,
               symmetric=False, seed=0)
# what this generator and seed give: A's nonzeros, A @ A's terms and the
# product's nonzeros (scipy's A @ A on the same COO)
TWO_HOP_SIZES = (1326032, 10451327, 8613042)
# tile densities of B1's sweep in phase 4
SWEEP_DENSITIES = (0.01, 0.025, 0.05, 0.10, 0.25, 0.50)


def log(*args) -> None:
    print(*args, flush=True)


def require(cond, what) -> None:
    """Fail the run (a check that ``python -O`` does not strip)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def mma_min_density() -> float:
    """The tile core's density threshold, read from its source."""
    text = (SRC / "repro_torch" / "kernels" / "csrc" /
            "tile_core.cuh").read_text()
    return float(re.search(
        r"kMmaMinDensity\s*=\s*([0-9.]+)f", text).group(1))


def density_sweep(kernel, sparse_tiles, timed_ms, operand, log):
    """B1's time on one 4,096-tile stream (32 windows of 128 tiles, each
    window holding every k-block once, bm = 128, bk = 64, N = 256) at each
    tile density of SWEEP_DENSITIES, and B7's on the same tiles packed as
    bitmaps; prints one JSON line for each."""
    import torch

    from repro_torch.core.formats import pack_bitmap_tiles_torch
    from repro_torch.core.plan_ir import unsplittable_flag
    from repro_torch.kernels.dense_tile_spmm import (
        window_chunks, window_segments,
    )
    from repro_torch.kernels.structured_spmm import bitmap_tile_spmm

    dev = torch.device("cuda")
    nw, per, n = 32, 128, 256
    sw = torch.arange(nw, device=dev, dtype=torch.int32).repeat_interleave(
        per)
    sc = torch.arange(per, device=dev, dtype=torch.int32).repeat(nw)
    b = operand(per * 64, n)
    segments = window_segments(sw, nw)
    chunks = window_chunks(segments[1])
    threshold = mma_min_density()
    rows, rows_b7 = [], []
    for density in SWEEP_DENSITIES:
        fv = sparse_tiles(nw * per, (density,))
        flag = unsplittable_flag(fv)   # as a plan holds it
        ms = timed_ms(lambda: kernel(sw, sc, fv, b, num_windows=nw, bm=128,
                                     bk=64, segments=segments,
                                     chunks=chunks, a_flag=flag))
        path = "mma" if density >= threshold else "walk"
        rows.append({"density": density, "ms": ms, "path": path})
        words, values, cap = pack_bitmap_tiles_torch(fv)
        ms = timed_ms(lambda: bitmap_tile_spmm(
            sw, sc, words, values, b, num_windows=nw, bm=128, bk=64,
            row_cap=cap, segments=segments, a_flag=flag))
        rows_b7.append({"density": density, "ms": ms, "path": path,
                        "row_cap": cap})
        del fv, words, values
    log(json.dumps({"dense_tile_spmm_density_sweep": rows,
                    "threshold": threshold, "tiles": nw * per, "n": n}))
    log(json.dumps({"bitmap_tile_spmm_density_sweep": rows_b7,
                    "threshold": threshold, "tiles": nw * per, "n": n}))


def check_cost_ms(fn, reps=5):
    """Device ms per call that the non-finite check costs inside ``fn`` (a
    call through the matrix-path wrappers on finite B): the check of B
    (nonfinite_kernel) and the every-entry kernel's launch, which returns
    at once.  Read from torch.profiler's kernel records; None where it
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if "every_entry_kernel" in evt.key or "nonfinite_kernel" in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
    return total_us / 1e3 / reps if total_us > 0 else None


def device_breakdown(fn, reps=3, top=8):
    """Device ms per call of ``fn`` by kernel (torch.profiler's kernel
    records): ``(total, [(name, ms), ...] for the ``top`` largest)``;
    total None where it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        if us > 0:
            rows.append((evt.key[:90], us / 1e3 / reps))
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms in rows)
    return (total if total > 0 else None), rows[:top]


def check_cost_line(fn, spmm_ms):
    ms = check_cost_ms(fn)
    if ms is None:
        return "the non-finite check: not measured (no device time profiled)"
    return (f"the non-finite check (one read of B, idle every-entry launch) "
            f"{ms:.4f} ms = {100 * ms / spmm_ms:.2f} % of it")


# values the 3xTF32 split cannot carry: cvt.rna.tf32 rounds |x| from
# 3.401993e38 up to Inf
BIG = 3.402e38
# the non-finite phase's cases: (label, operand, values planted in it)
NONFINITE_CASES = (
    ("B with +Inf, -Inf and NaN", "b",
     (float("inf"),) * 3 + (-float("inf"),) * 3 + (float("nan"),) * 3),
    ("A with +Inf, -Inf, NaN and +-3.402e38", "a",
     (float("inf"), -float("inf"), float("nan"), BIG, -BIG)),
    ("B with +-3.402e38", "b", (BIG, -BIG, BIG, -BIG)),
)


def nonfinite_phase(ctx):
    """B1, B6 (2:4 and 1:32) and B7 on stand-ins with values the 3xTF32
    split cannot carry (NONFINITE_CASES: +Inf, -Inf and NaN in B; the same
    and +-3.402e38 in A's stored values; +-3.402e38 in B), each against its
    plain (dense-tile) version: NaN and +-Inf in the same cells, with the
    same signs, and the finite cells within the tolerance.  B1 and B7 take
    tiles alternating 2 % and 50 % (both of their paths in one launch).
    A's values reach the kernels' routing through the flag a plan keeps
    (the wrappers compute it from the tile values here)."""
    import numpy as np
    import torch

    from repro_torch.core.formats import pack_bitmap_tiles_torch, pack_nm_tiles
    from repro_torch.kernels import ref
    from repro_torch.kernels.dense_tile_spmm import dense_tile_spmm
    from repro_torch.kernels.structured_spmm import (
        bitmap_tile_spmm, nm_tile_spmm,
    )

    dev, n, nw, per = ctx.dev, 256, 8, 64
    sw = torch.arange(nw, device=dev, dtype=torch.int32).repeat_interleave(
        per)
    sc = torch.arange(nw * per, device=dev, dtype=torch.int32) % per
    fv0 = ctx.sparse_tiles(nw * per, (0.02, 0.5))
    b0 = ctx.operand(per * 64, n)
    rng = np.random.RandomState(15)
    nm_flat = {}
    for n_pat, m_pat in ((2, 4), (1, 32)):
        g = rng.randn(nw * per, 128, 64 // m_pat, m_pat).astype(np.float32)
        keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
        nm_flat[n_pat, m_pat] = np.where(keep, g, 0.0).reshape(nw * per, 128,
                                                               64)
    for case, operand, values in NONFINITE_CASES:
        b, fv = b0.clone(), fv0.clone()
        flats = {key: f.copy() for key, f in nm_flat.items()}
        if operand == "b":
            # distinct columns: no output cell sums two +-3.402e38 terms,
            # whose overflow would depend on the order of the sum
            cols = torch.randperm(n, generator=ctx.gen, device=dev)[
                :len(values)]
            rows = torch.randint(0, b.shape[0], (len(values),),
                                 generator=ctx.gen, device=dev)
            b[rows, cols] = torch.tensor(values, device=dev)
        else:
            # one value per row of tile 1 (50 % dense), on a stored cell
            for r, v in enumerate(values):
                fv[1, r, int(torch.nonzero(fv[1, r])[0])] = v
                for f in flats.values():
                    f[1, r, np.flatnonzero(f[1, r])[0]] = v
        words, vals_b, cap = pack_bitmap_tiles_torch(fv)
        runs = [
            ("dense_tile_spmm",
             lambda: dense_tile_spmm(sw, sc, fv, b, num_windows=nw, bm=128,
                                     bk=64),
             lambda: ref.ref_block_stream_spmm(sw, sc, fv, b, nw)),
            ("bitmap_tile_spmm",
             lambda: bitmap_tile_spmm(sw, sc, words, vals_b, b,
                                      num_windows=nw, bm=128, bk=64,
                                      row_cap=cap),
             lambda: ref.ref_bitmap_stream_spmm(sw, sc, words, vals_b, b, nw,
                                                64)),
        ]
        for (n_pat, m_pat), flat in flats.items():
            vals, codes = (torch.from_numpy(x).to(dev)
                           for x in pack_nm_tiles(flat, n_pat, m_pat))
            runs.append((
                f"nm_tile_spmm {n_pat}:{m_pat}",
                lambda v=vals, c=codes, np_=n_pat, mp=m_pat: nm_tile_spmm(
                    sw, sc, v, c, b, num_windows=nw, bm=128, bk=64,
                    n_pat=np_, m_pat=mp),
                lambda v=vals, c=codes, np_=n_pat, mp=m_pat:
                    ref.ref_nm_stream_spmm_dense(sw, sc, v, c, b, nw, np_,
                                                 mp, 64)))
        for label, kern, plain in runs:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            nan, inf = torch.isnan(want), torch.isinf(want)
            ctx.require(bool(nan.any()) or bool(inf.any()),
                        (label, case, "vacuous"))
            ctx.require(torch.equal(torch.isnan(got), nan),
                        (label, case, "NaN cells"))
            ctx.require(torch.equal(torch.isinf(got), inf)
                        and torch.equal(got[inf], want[inf]),
                        (label, case, "Inf cells"))
            fin = torch.isfinite(want)
            err = (got[fin] - want[fin]).abs().max().item()
            scale = max(1.0, want[fin].abs().max().item())
            ctx.require(err <= TOL * scale, (label, case, err, scale))
            ctx.log(f"  {label}, {case}: {int(nan.sum())} NaN and "
                    f"{int(inf.sum())} +-Inf cells as in the plain version; "
                    f"finite cells max |diff| {err:.3e}")
        del b, fv, words, vals_b, runs


def gradient_phase(ctx, a, rows, cols, vals):
    """A "cuda" spmm, bspmm and sddmm on plan ``a`` (COO ``rows``, ``cols``,
    ``vals``) with grad-requiring operands return gradients: spmm's (on
    ``a`` and after ``with_values``) and bspmm's held against
    ``torch.sparse.mm`` on the CSR of the same COO with autograd, sddmm's
    in X and Y against fp64 dense autograd.  Returns the largest error."""
    import numpy as np
    import torch

    m, k = a.shape
    rng = np.random.RandomState(17)
    idx = torch.from_numpy(np.stack([rows, cols])).to(ctx.dev)

    def csr(v):
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(v, dtype=torch.float32, device=ctx.dev),
            (m, k)).coalesce().to_sparse_csr()

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            ctx.dev)

    errs = {}
    new_vals = rng.randn(rows.size).astype(np.float32)
    for label, mat, v in (("spmm", a, vals),
                          ("spmm after with_values", a.with_values(new_vals),
                           new_vals)):
        b, g = randn(k, 16).requires_grad_(True), randn(m, 16)
        (ctx.sp.spmm(mat, b) * g).sum().backward()
        b_ref = b.detach().clone().requires_grad_(True)
        (torch.sparse.mm(csr(v), b_ref) * g).sum().backward()
        errs[label] = ctx.err_bound(b.grad, b_ref.grad)
    bb, gb = randn(3, k, 8).requires_grad_(True), randn(3, m, 8)
    (ctx.sp.bspmm(a, bb) * gb).sum().backward()
    bb_ref = bb.detach().clone().requires_grad_(True)
    lib = csr(vals)
    (torch.stack([torch.sparse.mm(lib, bb_ref[i]) for i in range(3)])
     * gb).sum().backward()
    errs["bspmm"] = ctx.err_bound(bb.grad, bb_ref.grad)
    x, y = randn(m, 8).requires_grad_(True), randn(8, k).requires_grad_(True)
    gs = randn(rows.size)
    (ctx.sp.sddmm(a, x, y) * gs).sum().backward()
    x64, y64 = (t.detach().double().requires_grad_(True) for t in (x, y))
    r, c = (torch.from_numpy(t).to(ctx.dev) for t in (rows, cols))
    ((x64 @ y64)[r, c] * gs.double()).sum().backward()
    errs["sddmm dX"] = ctx.err_bound(x.grad, x64.grad.float())
    errs["sddmm dY"] = ctx.err_bound(y.grad, y64.grad.float())
    ctx.log("  gradients on impl='cuda' (cora stand-in) against "
            "torch.sparse.mm with autograd (spmm, bspmm) and fp64 dense "
            "(sddmm): " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    return max(errs.values())


def host_profile(fn, top=6):
    """Host ms that a call of ``fn`` takes to return (no synchronisation
    after it, so a wait for the card inside it counts) and the ``top``
    functions by their own host time under cProfile: ``(ms, [(name, ms),
    ...])``."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    prof.disable()
    ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((f"{name} ({Path(file).name}:{line})", tt * 1e3)
                   for (file, line, name), (_, _, tt, _, _) in stats.items()),
                  key=lambda r: -r[1])
    return ms, rows[:top]


def arxiv_gcn_graph():
    """The GCN path's graph at ogbn-arxiv size (ARXIV_GCN), row-normalised:
    every row of A sums to 1, so A differs from Aᵀ and a backward on A's
    plan instead of the transpose plan would show.  Returns ``(rows, cols,
    vals, feats, labels, n_classes, seconds)``."""
    import numpy as np

    from repro_torch.examples.gcn_training import make_graph

    t0 = time.perf_counter()
    rows, cols, _, feats, labels, n_classes = make_graph(**ARXIV_GCN)
    n = feats.shape[0]
    vals = (1.0 / np.bincount(rows, minlength=n))[rows].astype(np.float32)
    return (rows, cols, vals, feats, labels, n_classes,
            time.perf_counter() - t0)


def gcn_training_path(ctx, graph):
    """The GCN training path: GCN_STEPS full-batch SGD steps of the
    reference example's two-layer GCN at ogbn-arxiv size on the card, on
    the row-normalised adjacency D^-1 (A + I), which is not its own
    transpose.  Step 0 reads the launch counts around its forward and
    around its backward (which runs on the transpose plan), holds each of
    its four SpMMs against ``torch.sparse.mm`` on the CSR of A or of Aᵀ
    (built from the COO, not from the plan), and its gradients of W1 and
    W2 against the same model on ``torch.sparse.mm`` (CSR) with autograd;
    steps 1 on are timed with CUDA events (forward, backward, update) with
    no host synchronisation between them, their counts read after the
    last.  The library's step is timed the same way.  Returns a dict of
    what it measured."""
    import numpy as np
    import torch

    from repro_torch.examples.gcn_training import GCN, loss_fn
    from repro_torch.exec import api

    dev = ctx.dev
    rows, cols, vals, feats, labels, n_classes, t_graph = graph
    n = feats.shape[0]
    t1 = time.perf_counter()
    a = ctx.sp.from_coo(rows, cols, vals, (n, n), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # prepared here, not lazily in the first backward, so that its host
    # seconds are read on their own and every step below is alike
    plan_t = api.transpose_structure(a.plan)
    torch.cuda.synchronize()
    t_plan_t = time.perf_counter() - t2
    ctx.log(f"GCN training path (ogbn-arxiv size): {n} nodes, {rows.size} "
            f"nonzeros, {feats.shape[1]} features, {n_classes} classes, "
            f"hidden {GCN_HIDDEN}, lr {GCN_LR}; graph {t_graph:.1f} s, "
            f"from_coo {t2 - t1:.1f} s, plan_t prepare {t_plan_t:.2f} s")
    for label, pl in (("A", a.plan), ("plan_t", plan_t)):
        sd = pl.stats_dict
        ctx.log(f"  {label}: core_nnz={sd['core_nnz']} fringe_nnz="
                f"{sd['fringe_nnz']} windows={pl.num_windows} tiles="
                f"{pl.step_window.shape[0]} tier={pl.fringe_tier}")
    x = torch.from_numpy(feats).to(dev)
    y = torch.from_numpy(labels).long().to(dev)
    model = GCN.init(a, feats.shape[1], GCN_HIDDEN, n_classes,
                     generator=torch.Generator(device=dev).manual_seed(0))
    params = list(model.parameters())
    w0 = [p.detach().clone() for p in params]
    # the library's model: the generator's COO is sorted and unique, so
    # its CSR keeps input order; Aᵀ's CSR by the library's own coalesce
    crow = np.zeros(n + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=n))
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev), torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), (n, n))
    csr_t = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([cols, rows])).to(dev),
        torch.from_numpy(vals).to(dev), (n, n)).coalesce().to_sparse_csr()

    def rel_err(got, want):
        """max |got - want| within ctx.tol * max |want| (no floor of 1);
        returns both."""
        torch.cuda.synchronize()
        ctx.require(got.shape == want.shape, (got.shape, want.shape))
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ctx.require(err <= ctx.tol * scale,
                    f"max |diff| {err} > {ctx.tol} * {scale}")
        return err, scale

    def library_loss(w1, w2):
        h = torch.relu(torch.sparse.mm(csr, x @ w1))
        return loss_fn(torch.sparse.mm(csr, h @ w2), y)

    def sgd_update(ws, grads):
        with torch.no_grad():
            for w, g in zip(ws, grads):
                w -= GCN_LR * g

    # step 0: counts around the forward and around the backward; each SpMM
    # the executor runs in it is recorded (plan, operand, output) and held
    # against the library after it
    spmms = []
    execute = api._execute

    def recorded(plan, b):
        out = execute(plan, b)
        spmms.append((plan, b, out))
        return out

    model.zero_grad(set_to_none=True)
    api._execute = recorded
    try:
        loss0, fwd0 = ctx.drive(lambda: loss_fn(model(x), y))
        _, bwd0 = ctx.drive(loss0.backward)
    finally:
        api._execute = execute
    ctx.require(len(spmms) == 4, ("step 0 ran", len(spmms), "SpMMs"))
    spmm_errs = []
    for i, (pl, b, out) in enumerate(spmms):
        forward = i < 2
        ctx.require((pl is a.plan) == forward,
                    f"SpMM {i} of step 0 ran on the wrong plan")
        err, scale = rel_err(out, torch.sparse.mm(csr if forward else csr_t,
                                                  b))
        spmm_errs.append({"on": "A" if forward else "plan_t",
                          "n": int(b.shape[1]), "max_abs_err": err,
                          "max_abs_ref": scale})
    del spmms
    w_lib = [w.clone().requires_grad_(True) for w in w0]
    loss_lib = library_loss(*w_lib)
    g_lib = torch.autograd.grad(loss_lib, w_lib)
    grad_errs = [rel_err(p.grad, g) for p, g in zip(params, g_lib)]
    err_grad = max(e for e, _ in grad_errs)
    loss0, loss_lib = loss0.detach(), loss_lib.detach()
    ctx.require(abs(float(loss0) - float(loss_lib))
                <= ctx.tol * max(1.0, abs(float(loss_lib))),
                ("step-0 loss", float(loss0), float(loss_lib)))
    sgd_update(params, [p.grad for p in params])
    losses = [loss0]
    # steps 1 on: events only, no synchronisation inside the loop
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(GCN_STEPS - 1)]

    def steps():
        for e in ev:
            model.zero_grad(set_to_none=True)
            e[0].record()
            loss = loss_fn(model(x), y)
            e[1].record()
            loss.backward()
            e[2].record()
            sgd_update(params, [p.grad for p in params])
            e[3].record()
            losses.append(loss.detach())

    _, rest = ctx.drive(steps)
    losses = [float(v) for v in losses]

    def mean_ms(k0, k1):
        return sum(e[k0].elapsed_time(e[k1]) for e in ev) / len(ev)

    fwd_ms, bwd_ms, upd_ms, step_ms = (mean_ms(0, 1), mean_ms(1, 2),
                                       mean_ms(2, 3), mean_ms(0, 3))
    # the library's step, timed the same way from the same weights
    w_lib = [w.clone().requires_grad_(True) for w in w0]
    lev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
           for _ in range(6)]
    for e in lev:
        e[0].record()
        loss = library_loss(*w_lib)
        e[1].record()
        grads = torch.autograd.grad(loss, w_lib)
        e[2].record()
        sgd_update(w_lib, grads)
        e[3].record()
    torch.cuda.synchronize()
    lev = lev[1:]  # the first is a warm-up
    lib_fwd, lib_bwd, lib_step = (
        sum(e[k0].elapsed_time(e[k1]) for e in lev) / len(lev)
        for k0, k1 in ((0, 1), (1, 2), (0, 3)))
    launches = {k: fwd0[k] + bwd0[k] + rest[k] for k in fwd0}

    def one_step():
        model.zero_grad(set_to_none=True)
        loss_fn(model(x), y).backward()
        sgd_update(params, [p.grad for p in params])

    busy_ms, by_kernel = device_breakdown(one_step)
    # where the backward's host time goes: one more step, its forward
    # finished on the card first
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model(x), y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss.backward()
    bwd_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model(x), y)
    torch.cuda.synchronize()
    bwd_prof_ms, bwd_top = host_profile(loss.backward)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.transpose_plan(a.plan)
    transpose_lookup_us = (time.perf_counter() - t0) * 1e6
    ctx.log(f"  step 0 launches: forward {fwd0}; backward (plan_t) {bwd0}")
    ctx.log(f"  launches over the {GCN_STEPS} steps: {launches}")
    ctx.log("  step-0 SpMMs against torch.sparse.mm on the CSR of A or of "
            "A^T: " + json.dumps(spmm_errs))
    ctx.log(f"  loss: step 0 {losses[0]:.6f} (library {float(loss_lib):.6f})"
            f", step {GCN_STEPS - 1} {losses[-1]:.6f}; step-0 gradients "
            f"against torch.sparse.mm with autograd: " + ", ".join(
                f"{w} max |diff| {e:.3e} (max |ref| {m:.3e})"
                for w, (e, m) in zip(("W1", "W2"), grad_errs)))
    ctx.log(f"  backward host time (to return, no sync after): "
            f"{bwd_host_ms:.3f} "
            f"ms; under cProfile {bwd_prof_ms:.3f} ms, by own time: "
            + "; ".join(f"{name} {ms:.3f}" for name, ms in bwd_top)
            + f"; transpose_plan lookup {transpose_lookup_us:.1f} us")
    ctx.log(f"  step (mean of steps 1-{GCN_STEPS - 1}, CUDA events): "
            f"{step_ms:.3f} ms = forward {fwd_ms:.3f} + backward "
            f"{bwd_ms:.3f} + update {upd_ms:.3f}; the same step on "
            f"torch.sparse.mm (CSR): {lib_step:.3f} ms (forward "
            f"{lib_fwd:.3f}, backward {lib_bwd:.3f})")
    if busy_ms is not None:
        ctx.log(f"  device time of one step (torch.profiler, kernels): "
                f"{busy_ms:.3f} ms of the {step_ms:.3f} ms step (idle share "
                f"{1 - busy_ms / step_ms:.2f}); largest: "
                + "; ".join(f"{name} {ms:.3f}" for name, ms in by_kernel))
    ctx.require(losses[-1] < losses[0], ("loss did not fall", losses))
    ctx.require(all(np.isfinite(losses)), losses)
    for label, counts in (("forward", fwd0), ("backward", bwd0)):
        ctx.require(counts["dense_tile_spmm"] > 0
                    and sum(counts[k] for k in FRINGE_KERNELS) > 0,
                    (label, counts))
    return {"launches": launches, "err": err_grad, "spmm_errs": spmm_errs,
            "grad_errs": grad_errs, "backward_host_ms": bwd_host_ms,
            "step_ms": step_ms,
            "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "library_step_ms": lib_step, "library_forward_ms": lib_fwd,
            "library_backward_ms": lib_bwd, "device_busy_ms": busy_ms,
            "plan_t_s": t_plan_t, "losses": (losses[0], losses[-1])}


def bitwise(got, want) -> bool:
    """Equal bit for bit, NaN cells in the same places (and +-Inf, which
    ``torch.equal`` compares as values)."""
    import torch

    nan = torch.isnan(want)
    return (got.shape == want.shape
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def wall_ms(fn, reps=7):
    """Median wall ms of ``fn`` as a synchronised call (synchronise, read
    the clock, call, synchronise, read the clock) after one warm-up."""
    import torch

    torch.cuda.synchronize()
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def reddit_per_path(ctx, a, b, c):
    """The Reddit-scale per-path phase, on the plan of the main path (not
    prepared again): ``execute_matrix_path`` must launch only
    dense_tile_spmm and ``execute_vector_path`` only gather_spmm, and
    their sum must be ``spmm``'s result ``c`` bit for bit, also with +Inf,
    -Inf and NaN in B.  Each path is timed by CUDA events, as a
    synchronised wall time, and the two on two streams from one
    synchronised start to a synchronised end.  Returns what it measured."""
    import torch

    from repro_torch.exec import api

    plan = a.plan
    paths = (("matrix", api.execute_matrix_path, "dense_tile_spmm"),
             ("vector", api.execute_vector_path, "gather_spmm"))
    outs, launches = {}, {}
    for label, path, kernel in paths:
        outs[label], launches[label] = ctx.drive(lambda: path(plan, b))
        ctx.require(launches[label][kernel] > 0 and all(
            n == 0 for k, n in launches[label].items() if k != kernel),
            (label, launches[label]))
    ctx.require(torch.equal(outs["matrix"] + outs["vector"], c),
                "matrix path + vector path != spmm bit for bit")
    del outs
    events = {label: ctx.timed_ms(lambda: path(plan, b))
              for label, path, _ in paths}
    events["spmm"] = ctx.timed_ms(lambda: ctx.sp.spmm(a, b))
    walls = {label: wall_ms(lambda: path(plan, b))
             for label, path, _ in paths}
    walls["spmm"] = wall_ms(lambda: ctx.sp.spmm(a, b))
    streams = (torch.cuda.Stream(), torch.cuda.Stream())

    def two_streams():
        outs = []
        for stream, (_, path, _) in zip(streams, paths):
            with torch.cuda.stream(stream):
                outs.append(path(plan, b))
        return outs

    walls["two streams"] = wall_ms(two_streams)
    two = two_streams()
    torch.cuda.synchronize()
    ctx.require(torch.equal(two[0] + two[1], c),
                "the two-stream paths' sum != spmm bit for bit")
    del two
    skew = max(walls["matrix"], walls["vector"]) / min(walls["matrix"],
                                                       walls["vector"])
    skew_events = max(events["matrix"], events["vector"]) / min(
        events["matrix"], events["vector"])
    # +Inf, -Inf and NaN in B rows the matrix path and the fringe read
    b_nf = b.clone()
    b_nf[0, 3] = float("inf")
    b_nf[b.shape[0] // 2, 7] = -float("inf")
    b_nf[b.shape[0] - 1, 11] = float("nan")
    fused = ctx.sp.spmm(a, b_nf)
    both = api.execute_matrix_path(plan, b_nf) + api.execute_vector_path(
        plan, b_nf)
    torch.cuda.synchronize()
    ctx.require(bitwise(both, fused),
                "with Inf/NaN in B: the paths' sum != spmm bit for bit")
    n_nan, n_inf = int(torch.isnan(fused).sum()), int(
        torch.isinf(fused).sum())
    ctx.require(n_nan > 0 and n_inf > 0, (n_nan, n_inf))
    del both, fused, b_nf
    ctx.log(f"reddit-scale per-path (N = {b.shape[1]}, the main path's "
            f"plan): launches matrix path {launches['matrix']}, vector path "
            f"{launches['vector']}; sum == spmm bit for bit (also with "
            f"+-Inf/NaN in B: {n_nan} NaN and {n_inf} Inf cells in the same "
            f"places)")
    ctx.log(f"  CUDA events: matrix {events['matrix']:.3f} ms, vector "
            f"{events['vector']:.3f} ms, spmm {events['spmm']:.3f} ms; "
            f"synchronised wall: matrix {walls['matrix']:.3f}, vector "
            f"{walls['vector']:.3f} (serial sum "
            f"{walls['matrix'] + walls['vector']:.3f}), two streams "
            f"{walls['two streams']:.3f}, fused spmm {walls['spmm']:.3f} "
            f"ms; skew {skew:.3f} (wall), {skew_events:.3f} (events)")
    return {"events_ms": events, "wall_ms": walls, "skew": skew,
            "skew_events": skew_events, "launches": launches}


COORD_EPOCHS = 10


def coordination_path(ctx, graph):
    """The coordination path at ogbn-arxiv size: ``NeutronSpMM.run_epoch``
    for COORD_EPOCHS epochs on the GCN path's row-normalised graph with a
    seeded B (N = 256), each epoch's result held against
    ``torch.sparse.mm`` on the CSR of the same COO; then the warm fused
    ``execute`` and its two paths (CUDA events) at each distinct alpha of
    the trajectory (on the plans the loop prepared, the default's first)
    and at alpha = 1.0 (all fringe).  The sweep prepares no plan below the
    default alpha: an all-core plan would put nearly every nonzero in its
    own 32 KB tile.  Returns ``(plans, b, summary)``: the plans by alpha,
    the operand and what it measured."""
    import numpy as np
    import torch

    from repro_torch.core.plan_ir import SpmmConfig
    from repro_torch.core.spmm import prepare
    from repro_torch.exec import api

    dev = ctx.dev
    rows, cols, vals, feats, *_ = graph
    n = feats.shape[0]
    b = torch.randn((n, N), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(256))
    crow = np.zeros(n + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=n))
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev), torch.from_numpy(cols).to(dev),
        torch.from_numpy(vals).to(dev), (n, n))
    ref = torch.sparse.mm(csr, b)
    config = SpmmConfig(impl=ctx.impl)
    op = api.NeutronSpMM(rows, cols, vals, (n, n), config, device=dev)
    default_alpha = op._alpha
    plans = {op._alpha: op.plan}
    errs, launches = [], []
    for _ in range(COORD_EPOCHS):
        out, counts = ctx.drive(lambda: op.run_epoch(b))
        errs.append(ctx.err_bound(out, ref))
        launches.append({k: v for k, v in counts.items() if v})
        plans.setdefault(op._alpha, op.plan)
    del out
    ctx.log(f"coordination path (ogbn-arxiv size, {n} nodes, {rows.size} "
            f"nonzeros, N = {N}): {COORD_EPOCHS} epochs of "
            f"NeutronSpMM.run_epoch, each against torch.sparse.mm (max "
            f"|diff| {max(errs):.3e})")
    for i, (e, cnt) in enumerate(zip(op.epoch_log, launches)):
        ctx.log(f"  epoch {i}: " + json.dumps(e) + f" launches {cnt}")
    ctx.log("  prepare seconds (initial, then each re-prepare): "
            + ", ".join(f"{s:.2f}" for s in op.prepare_seconds))
    sweep = []
    if 1.0 not in plans:
        plans[1.0] = prepare(rows, cols, vals, (n, n),
                             SpmmConfig(impl=ctx.impl, alpha=1.0),
                             device=dev)
    for alpha, plan in sorted(plans.items()):
        ctx.err_bound(api.execute(plan, b), ref)
        sd = plan.stats_dict
        sweep.append({
            "alpha": alpha, "core_nnz": sd["core_nnz"],
            "fringe_nnz": sd["fringe_nnz"], "tiles": (
                int(plan.step_window.shape[0]) if plan.has_core else 0),
            "tier": plan.fringe_tier,
            "spmm_ms": ctx.timed_ms(lambda: api.execute(plan, b)),
            "matrix_ms": ctx.timed_ms(
                lambda: api.execute_matrix_path(plan, b)),
            "vector_ms": ctx.timed_ms(
                lambda: api.execute_vector_path(plan, b)),
        })
    best = min(sweep, key=lambda r: r["spmm_ms"])
    for r in sweep:
        ctx.log("  sweep (CUDA events): " + json.dumps(r))
    ctx.log(f"  fastest fused spmm at alpha {best['alpha']} "
            f"({best['spmm_ms']:.3f} ms); the coordinator ended at alpha "
            f"{op._alpha} (default {default_alpha})")
    summary = {"default_alpha": default_alpha, "final_alpha": op._alpha,
               "best_alpha": best["alpha"], "sweep": sweep,
               "epoch_log": op.epoch_log, "launches": launches,
               "prepare_s": op.prepare_seconds, "max_abs_err": max(errs)}
    return plans, b, summary


def telemetry_path(ctx, graph, plan_off, b):
    """Telemetry on the card: the ogbn-arxiv-size plan prepared with
    ``telemetry=True`` against ``plan_off`` (the same COO and config with
    it off): ``execute`` and the two per-path calls bit for bit equal and
    with the same launches, one roofline row per kind of dispatch, and
    the matrix-path against fringe-path attribution of
    ``obs.snapshot()`` against the H100's ceilings; prints the report."""
    import dataclasses

    import torch

    import repro_torch.obs as obs
    from repro_torch.core.spmm import prepare
    from repro_torch.exec import api

    rows, cols, vals, feats, *_ = graph
    n = feats.shape[0]
    plan_on = prepare(rows, cols, vals, (n, n),
                      dataclasses.replace(plan_off.config, telemetry=True),
                      device=ctx.dev)
    ctx.require(plan_on.signature() == plan_off.signature(),
                "telemetry changed the signature")
    obs.PROFILER.reset()
    obs.TRACES.reset()
    calls = (("execute", api.execute),
             ("matrix path", api.execute_matrix_path),
             ("vector path", api.execute_vector_path))
    for label, fn in calls:
        for _ in range(3):
            off, l_off = ctx.drive(lambda: fn(plan_off, b))
            on, l_on = ctx.drive(lambda: fn(plan_on, b))
            ctx.require(torch.equal(on, off),
                        f"{label}: telemetry on != off bit for bit")
            ctx.require(l_on == l_off, (label, l_on, l_off))
    ctx.sp.spmm(ctx.sp.from_plan(plan_on), b)
    snap = obs.snapshot()
    attr = snap["roofline"]
    ops_seen = {r["op"] for r in attr["rows"]}
    ctx.require(ops_seen == {"spmm", "spmm:matrix_path",
                             "spmm:vector_path"}, ops_seen)
    ctx.require([t["name"] for t in snap["traces"]] == ["facade:spmm"],
                snap["traces"])
    json.dumps(snap)
    ctx.log("telemetry on the ogbn-arxiv-size plan (bit-identical on and "
            "off, same launches; peaks " + json.dumps(
                attr["rows"][0]["peaks"]) + "):")
    for line in obs.format_report(attr).splitlines():
        ctx.log("  " + line)
    return {p: attr[f"{p}_path"] for p in ("matrix", "fringe")}


def pruned_weight_paths(ctx, m=PRUNED_M, k=PRUNED_K, n=PRUNED_N):
    """Drive the three pruned-weight paths, check them and time their
    kernels.  Returns ``(launches, records)``: the launch counts of each
    structured kernel on the path that runs it, and the kernels-line
    fields of nm_tile_spmm (2:4) and bitmap_tile_spmm.

    ``ctx`` carries the script's helpers (``sp``, ``dev``, ``log``,
    ``require``, ``drive``, ``err_bound``, ``timed_ms``, ``measure``,
    ``operand``, ``csr_of``, ``standin_err``).
    """
    import torch

    from repro_torch.data.graphs import GraphSpec, generate
    from repro_torch.kernels import ref
    from repro_torch.kernels.dense_tile_spmm import (
        dense_tile_spmm, window_chunks, window_segments,
    )
    from repro_torch.kernels.structured_spmm import (
        bitmap_tile_spmm, nm_tile_spmm,
    )

    log, require, dev = ctx.log, ctx.require, ctx.dev
    log(f"pruned-weight paths: {m} x {k} weight, N = {n}; "
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    launches, measured, records = {}, {}, []
    for label, density, spec_kw, cfg, kname in PRUNED_PATHS:
        spec = GraphSpec(name=f"llama2-7b-mlp-up-{label}", m=m, k=k,
                         avg_degree=density * k, skew=1.0, **spec_kw)
        t0 = time.perf_counter()
        rows, cols, vals = generate(spec)
        t_gen = time.perf_counter() - t0
        b = ctx.operand(k, n)

        def path():
            t0 = time.perf_counter()
            a = ctx.sp.from_coo(rows, cols, vals, (m, k), device=dev, **cfg)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c = ctx.sp.spmm(a, b)
            torch.cuda.synchronize()
            return a, c, t1 - t0, time.perf_counter() - t1

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (a, c, t_prep, t_spmm), counts = ctx.drive(path)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        p = a.plan
        st = p.stats_dict
        log(f"{label}: nnz {rows.size} (generated in {t_gen:.1f} s); plan "
            f"{p.matrix_format} {p.format_params}, windows {p.num_windows},"
            f" tiles {p.step_window.shape[0]}, fringe_nnz "
            f"{st['fringe_nnz']}; prepare {t_prep:.1f} s; first spmm "
            f"{t_spmm * 1e3:.1f} ms; peak device "
            f"memory {peak_gb:.3f} GB above the {base / 1e9:.2f} GB held "
            f"before; launches {counts}")
        require(p.matrix_format == kname.split("_")[0], p.matrix_format)
        require(counts[kname] == 1 and all(
            counts[x] == 0 for x in MATRIX_KERNELS if x != kname),
            (label, counts))
        launches.setdefault(kname, counts[kname])
        csr = ctx.csr_of(rows, cols, vals, (m, k))
        e = ctx.err_bound(c, torch.sparse.mm(csr, b))
        log(f"  {label} spmm vs torch.sparse.mm: {e:.3e}")
        if label == "2:4":
            bb = ctx.operand(k, n, batch=2)
            cb, counts_b = ctx.drive(lambda: ctx.sp.bspmm(a, bb))
            require(counts_b[kname] == 1 and all(
                counts_b[x] == 0 for x in MATRIX_KERNELS if x != kname),
                counts_b)
            e_b = max(ctx.err_bound(cb[i], torch.sparse.mm(csr, bb[i]))
                      for i in range(2))
            log(f"  2:4 bspmm (batch 2) vs torch.sparse.mm: {e_b:.3e}; "
                f"launches {counts_b}")
            del cb, bb

        # the kernel at this path's shapes, as spmm calls it once warm
        cfgp = p.config
        nw, t_steps = p.num_windows, p.step_window.shape[0]
        segs = window_segments(p.step_window, nw)
        chunks = window_chunks(segs[1])
        io_bytes = t_steps * 8 + b.numel() * 4 + nw * cfgp.bm * n * 4
        if kname == "nm_tile_spmm":
            n_pat, m_pat = p.format_params

            def kern():
                return nm_tile_spmm(
                    p.step_window, p.step_col, p.nm_values, p.nm_codes, b,
                    num_windows=nw, bm=cfgp.bm, bk=cfgp.bk, n_pat=n_pat,
                    m_pat=m_pat, segments=segs, a_flag=p.a_unsplittable)

            def plain():
                return ref.ref_nm_stream_spmm(
                    p.step_window, p.step_col, p.nm_values, p.nm_codes, b,
                    nw, n_pat, m_pat, cfgp.bk, tile_chunk=32)

            payload = p.nm_values.numel() * 4 + p.nm_codes.numel() * 4
        else:
            def kern():
                return bitmap_tile_spmm(
                    p.step_window, p.step_col, p.bitmap_words,
                    p.bitmap_values, b, num_windows=nw, bm=cfgp.bm,
                    bk=cfgp.bk, row_cap=p.format_params[1], segments=segs,
                    a_flag=p.a_unsplittable)

            def plain():
                return ref.ref_bitmap_stream_spmm(
                    p.step_window, p.step_col, p.bitmap_words,
                    p.bitmap_values, b, nw, cfgp.bk, tile_chunk=2048)

            payload = (p.bitmap_words.numel() * 4
                       + p.bitmap_values.numel() * 4)
        measured[label] = ctx.measure(
            f"{kname} ({label})", kern, plain,
            lambda: torch.sparse.mm(csr, b),
            nbytes=payload + io_bytes, flops=2 * st["core_nnz"] * n)
        # what the packed lane buys: B1 on the same plan's general tiles,
        # and the dense product of the weight
        out = kern()
        e_b1 = ctx.err_bound(
            dense_tile_spmm(p.step_window, p.step_col, p.flat_values, b,
                            num_windows=nw, bm=cfgp.bm, bk=cfgp.bk,
                            segments=segs, chunks=chunks,
                            a_flag=p.a_unsplittable), out)
        b1_ms = ctx.timed_ms(lambda: dense_tile_spmm(
            p.step_window, p.step_col, p.flat_values, b, num_windows=nw,
            bm=cfgp.bm, bk=cfgp.bk, segments=segs, chunks=chunks,
            a_flag=p.a_unsplittable))
        w = torch.zeros((m, k), device=dev)
        w[torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev)] = (
            torch.from_numpy(vals).to(dev))
        mm_ms = ctx.timed_ms(lambda: w @ b)
        spmm_ms = ctx.timed_ms(lambda: ctx.sp.spmm(a, b))
        log(f"  {label} beside it: dense_tile_spmm on the plan's general "
            f"tiles {b1_ms:.3f} ms (max |diff| {e_b1:.3e}); dense "
            f"torch.matmul of the weight {mm_ms:.3f} ms; end-to-end spmm "
            f"{spmm_ms:.3f} ms (warm); "
            f"{check_cost_line(lambda: ctx.sp.spmm(a, b), spmm_ms)}")
        del a, c, p, csr, w, out, segs, chunks, b

    def record(name, label, source, replaces, other_errs):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                **measured[label],
                "max_abs_err": max(measured[label]["max_abs_err"],
                                   ctx.standin_err[name], *other_errs)}

    records.append(record(
        "nm_tile_spmm", "2:4", "structured_spmm.cu",
        "src/repro/kernels/structured_spmm.py:132",
        (measured["1:32"]["max_abs_err"],)))
    records.append(record(
        "bitmap_tile_spmm", "50% unstructured", "structured_spmm.cu",
        "src/repro/kernels/structured_spmm.py:180", ()))
    return launches, records



def bits_equal(got, want) -> bool:
    """The same fp32 bit patterns, on any devices (-0.0 and 0.0 differ)."""
    import torch

    got, want = got.cpu().contiguous(), want.cpu().contiguous()
    return got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


def two_hop_path(ctx):
    """The two-hop path: ``P = A @ A`` through the facade on the directed
    ogbn-arxiv-size graph, then ``sp.spmm(P, X)`` at N = 256.

    P's pattern must equal scipy's ``A @ A`` (A's values are positive, so
    no sum cancels), its values lie within 1e-4 * max |ref| of scipy's
    float64 product, and they are bit-equal to the port's plain version
    (the numeric phase on CPU tensors) and across two card runs.  The
    symbolic phase, the numeric dispatch and the product's ``from_coo``
    are timed inside the one facade call; the numeric phase alone by CUDA
    events beside cuSPARSE's SpGEMM (``torch.sparse.mm`` of A's CSR by
    itself).  ``spmm`` on P is held against ``torch.sparse.mm`` on P's CSR
    and must launch B1 and a fringe kernel; its device time is split by
    kernel.  Returns ``(A, P, X, the
    path's numbers)``."""
    import numpy as np
    import scipy.sparse
    import torch

    from repro_torch.examples.gcn_training import make_graph
    from repro_torch.exec import api
    from repro_torch.exec.pipeline import build_executor

    sp, dev, log, require = ctx.sp, ctx.dev, ctx.log, ctx.require
    t0 = time.perf_counter()
    rows, cols, vals, feats, _, _ = make_graph(**TWO_HOP)
    n = feats.shape[0]
    t_graph = time.perf_counter() - t0
    require(rows.size == TWO_HOP_SIZES[0], ("A's nonzeros", rows.size))
    require(bool((vals > 0).all()), "A's values are positive")
    t0 = time.perf_counter()
    A = sp.from_coo(rows, cols, vals, (n, n), device="cuda")
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0

    # one facade call, its three stages timed where the facade calls them
    seen = {}
    symbolic, execute_spspmm, from_coo = (
        api.spspmm_symbolic, api.execute_spspmm, sp.from_coo)

    def timed(name, fn, sync=False):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            seen[name] = (time.perf_counter() - t0, out)
            return out
        return run

    api.spspmm_symbolic = timed("symbolic", symbolic)
    api.execute_spspmm = timed("spspmm", execute_spspmm, sync=True)
    sp.from_coo = timed("from_coo", from_coo, sync=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P, launches_product = ctx.drive(lambda: A @ A)
        t_facade = time.perf_counter() - t0
    finally:
        api.spspmm_symbolic, api.execute_spspmm, sp.from_coo = (
            symbolic, execute_spspmm, from_coo)
    t_symbolic, (ae, be, lengths, c_keys) = seen["symbolic"]
    t_execute, (_, _, vals_card, _) = seen["spspmm"]
    t_product = seen["from_coo"][0]
    n_exp, nnz_c = int(ae.size), int(c_keys.size)
    require((n_exp, nnz_c) == TWO_HOP_SIZES[1:], ("terms, nonzeros",
                                                  n_exp, nnz_c))
    require(not any(launches_product.values()),
            ("the product launches no kernel of the port's",
             launches_product))
    log(f"two-hop path (directed ogbn-arxiv size, {n} nodes, A "
        f"{rows.size} nonzeros, generated in {t_graph:.1f} s, from_coo "
        f"{t_a:.1f} s): A @ A {n_exp} terms -> {nnz_c} nonzeros; facade "
        f"{t_facade:.2f} s = symbolic {t_symbolic:.3f} s (host) + upload "
        f"and numeric {t_execute - t_symbolic:.3f} s + product from_coo "
        f"{t_product:.2f} s")

    # the pattern and the values against scipy's float64 product
    a64 = scipy.sparse.csr_matrix((vals.astype(np.float64), (rows, cols)),
                                  shape=(n, n))
    a64.sort_indices()
    t0 = time.perf_counter()
    ref = (a64 @ a64).tocsr()
    t_scipy = time.perf_counter() - t0
    ref.sort_indices()
    ref_rows = np.repeat(np.arange(n), np.diff(ref.indptr))
    require(np.array_equal(P.row, ref_rows)
            and np.array_equal(P.col, ref.indices), "P's pattern is scipy's")
    err = float(np.abs(P.val.astype(np.float64) - ref.data).max())
    scale = float(np.abs(ref.data).max())
    require(err <= ctx.tol * scale, (err, scale))
    # bits: the plain version on CPU tensors, and a second card run
    sig = ("spspmm", n_exp, nnz_c)
    host = (torch.from_numpy(ae.astype(np.int32)),
            torch.from_numpy(be.astype(np.int32)), torch.from_numpy(lengths),
            torch.as_tensor(vals, dtype=torch.float32),
            torch.as_tensor(vals, dtype=torch.float32))
    card = tuple(t.to(dev) for t in host)
    numeric = build_executor(sig)
    t0 = time.perf_counter()
    plain = numeric(*host)
    t_plain = time.perf_counter() - t0
    again = numeric(*card)
    require(bits_equal(vals_card, plain), "card bits == CPU plain bits")
    require(bits_equal(vals_card, again), "two card runs bit-equal")
    require(bits_equal(torch.from_numpy(P.val), plain), "P holds them")
    numeric_ms = ctx.timed_ms(lambda: numeric(*card))
    a_csr = torch.sparse_csr_tensor(
        torch.from_numpy(a64.indptr).long().to(dev),
        torch.from_numpy(a64.indices).long().to(dev),
        torch.from_numpy(a64.data.astype(np.float32)).to(dev), (n, n))
    lib = torch.sparse.mm(a_csr, a_csr)
    torch.cuda.synchronize()
    library_ms = ctx.timed_ms(lambda: torch.sparse.mm(a_csr, a_csr))
    lib_nnz = int(lib._nnz())
    log(f"  pattern equals scipy's A @ A ({t_scipy:.2f} s on the host); "
        f"values max |diff| {err:.3e} against the float64 product (max "
        f"{scale:.3e}); bit-equal to the CPU plain version ({t_plain:.2f} "
        f"s) and across two card runs")
    log(f"  numeric phase {numeric_ms:.3f} ms (CUDA events); cuSPARSE "
        f"SpGEMM torch.sparse.mm(A_csr, A_csr) {library_ms:.3f} ms "
        f"({lib_nnz} nonzeros)")

    # spmm on the product: B1 and a fringe kernel on P's plan
    x = torch.randn((n, 256), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    c, launches_spmm = ctx.drive(lambda: sp.spmm(P, x))
    pp = P.plan
    p_csr = torch.sparse_csr_tensor(
        torch.from_numpy(np.searchsorted(P.row, np.arange(n + 1))).to(dev),
        torch.from_numpy(P.col).to(dev), torch.from_numpy(P.val).to(dev),
        (n, n))
    e_spmm = ctx.err_bound(c, torch.sparse.mm(p_csr, x))
    spmm_ms = ctx.timed_ms(lambda: sp.spmm(P, x))
    spmm_lib_ms = ctx.timed_ms(lambda: torch.sparse.mm(p_csr, x))
    busy_ms, by_kernel = device_breakdown(lambda: sp.spmm(P, x), top=6)
    st = pp.stats_dict
    log(f"  spmm on P (N = 256): {spmm_ms:.3f} ms against torch.sparse.mm "
        f"on P's CSR {spmm_lib_ms:.3f} ms, max |diff| {e_spmm:.3e}; P's "
        f"plan: windows {pp.num_windows}, tiles {pp.step_window.shape[0]}, "
        f"core {st['core_nnz']}, fringe {st['fringe_nnz']} "
        f"({pp.fringe_tier}); launches {launches_spmm}")
    log(f"  spmm on P by kernel (torch.profiler, ms per call, device "
        f"total {busy_ms}): {by_kernel}")
    require(launches_spmm["dense_tile_spmm"] > 0
            and launches_spmm["gather_spmm"]
            + launches_spmm["gather_spmm_ksharded"] > 0, launches_spmm)
    return A, P, x, {
        "nnz_a": int(rows.size), "terms": n_exp, "nnz_p": nnz_c,
        "a_from_coo_s": t_a, "facade_s": t_facade,
        "symbolic_s": t_symbolic, "upload_numeric_s": t_execute - t_symbolic,
        "product_from_coo_s": t_product, "numeric_ms": numeric_ms,
        "library_spgemm_ms": library_ms, "library_nnz": lib_nnz,
        "max_abs_err": err, "max_abs_ref": scale, "spmm_ms": spmm_ms,
        "spmm_library_ms": spmm_lib_ms, "spmm_err": e_spmm,
        "spmm_device_ms": busy_ms, "spmm_by_kernel": by_kernel,
        "launches_spmm": launches_spmm,
        "p_plan": {"windows": pp.num_windows,
                   "tiles": int(pp.step_window.shape[0]),
                   "core_nnz": int(st["core_nnz"]),
                   "fringe_nnz": int(st["fringe_nnz"]),
                   "fringe_tier": pp.fringe_tier},
    }


def health_phase(ctx, A, P):
    """Health, faults and deadlines on the card, on A's plan.

    Each fault case dispatches ``bspmm`` at a batch size no other path
    uses, so its (signature, batch) is built afresh and reaches the build
    seams.  ``executor_build`` armed once for "cuda" signatures: the first
    dispatch raises ``KernelLoweringError`` and the signature retries; the
    dispatch inside the backoff raises with no launch; the retry launches
    and its result is bit-equal to an unarmed call's; the signature is
    healthy again with one recovery.  ``pallas_lowering`` armed for good:
    dispatches raise until the signature is demoted; disarmed, it still
    raises with no launch; ``HEALTH.reset()`` heals it.  Deadlines:
    ``deadline=0.0`` raises ``DeadlineExceeded`` on ``spmm``, ``sddmm``
    and ``spspmm``, and ``deadline=120.0`` returns the bits of the call
    without one."""
    import torch

    from repro_torch.core.plan_ir import sig_impl
    from repro_torch.errors import DeadlineExceeded, KernelLoweringError
    from repro_torch.exec.health import HEALTH
    from repro_torch.kernels import ops
    from repro_torch.robust.faults import HARNESS, armed

    sp, dev, log, require = ctx.sp, ctx.dev, ctx.log, ctx.require
    sig = A.plan.signature()
    n = A.shape[1]
    HARNESS.reset()
    HEALTH.reset()

    def raises(exc, call, what):
        """``call()`` raises ``exc`` and launches no kernel."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        try:
            call()
        except exc as err:
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            require(not any(counts.values()), (what, "launched", counts))
            return err
        raise RuntimeError(f"check failed: {what} did not raise "
                           f"{exc.__name__}")

    gen = torch.Generator(device=dev).manual_seed(5)
    x5 = torch.randn((5, n, 32), device=dev, generator=gen)
    x6 = torch.randn((6, n, 32), device=dev, generator=gen)

    # case 1: one build failure, a refusal inside the backoff, a recovery
    with armed("executor_build", times=1,
               match=lambda s: sig_impl(s) == "cuda"):
        err = raises(KernelLoweringError, lambda: sp.bspmm(A, x5),
                     "the armed build")
        require(HEALTH.state(sig) == "retrying", HEALTH.state(sig))
        refused = raises(KernelLoweringError, lambda: sp.bspmm(A, x5),
                         "the dispatch inside the backoff")
        require("next attempt at dispatch 3" in str(refused), str(refused))
        retry, launches_retry = ctx.drive(lambda: sp.bspmm(A, x5))
    require(launches_retry["dense_tile_spmm"] > 0, launches_retry)
    unarmed = sp.bspmm(A, x5)
    require(bits_equal(retry, unarmed), "the retry is bit-equal to an "
            "unarmed call")
    snap = HEALTH.snapshot()
    require(HEALTH.state(sig) == "healthy" and snap["recoveries"] == 1
            and snap["failures"] == 1 and snap["fallbacks"] == 0, snap)
    log(f"health phase (two-hop A's plan): executor_build armed once -> "
        f"KernelLoweringError ({type(err.__cause__).__name__} chained), "
        f"state retrying, dispatch 2 refused with no launch, dispatch 3 "
        f"launched {launches_retry} and is bit-equal to an unarmed call; "
        f"healthy again: {snap}")

    # case 2: a lowering failure for good, demoted, sticky once disarmed
    HARNESS.reset()
    dispatches = 0
    with armed("pallas_lowering", times=None):
        while HEALTH.state(sig) != "demoted":
            raises(KernelLoweringError, lambda: sp.bspmm(A, x6),
                   "a dispatch under the armed lowering seam")
            dispatches += 1
            require(dispatches <= 40, "never demoted")
    demoted = raises(KernelLoweringError, lambda: sp.bspmm(A, x6),
                     "the demoted signature, disarmed")
    require("demoted" in str(demoted), str(demoted))
    snap = HEALTH.snapshot()
    HEALTH.reset()
    healed, launches_healed = ctx.drive(lambda: sp.bspmm(A, x6))
    require(launches_healed["dense_tile_spmm"] > 0, launches_healed)
    e_healed = max(ctx.err_bound(healed[i], sp.spmm(A, x6[i]))
                   for i in range(6))
    log(f"  pallas_lowering armed for good: demoted after {dispatches} "
        f"dispatches ({snap}); disarmed, still refused with no launch; "
        f"HEALTH.reset() heals it: bspmm launched {launches_healed}, "
        f"against 6 x spmm {e_healed:.3e}")

    # deadlines: post-hoc, after synchronising the result's device
    b = torch.randn((n, 64), device=dev, generator=gen)
    x = torch.randn((n, 16), device=dev, generator=gen)
    y = torch.randn((16, n), device=dev, generator=gen)
    # (call with a deadline, the bits of the call without one)
    calls = {
        "spmm": (lambda **kw: sp.spmm(A, b, **kw), lambda: sp.spmm(A, b)),
        "sddmm": (lambda **kw: sp.sddmm(A, x, y, **kw),
                  lambda: sp.sddmm(A, x, y)),
        "spspmm": (lambda **kw: torch.from_numpy(sp.spspmm(A, A, **kw).val),
                   lambda: torch.from_numpy(P.val)),
    }
    for name, (call, without) in calls.items():
        try:
            call(deadline=0.0)
        except DeadlineExceeded:
            pass
        else:
            raise RuntimeError(f"check failed: {name} with deadline=0.0 "
                               f"did not raise DeadlineExceeded")
        require(bits_equal(call(deadline=120.0), without()),
                (name, "deadline=120.0 changed the bits"))
    log("  deadline=0.0 raised DeadlineExceeded on spmm, sddmm and spspmm; "
        "deadline=120.0 gave the same bits as no deadline")
    return {"launches_retry": launches_retry,
            "launches_healed": launches_healed,
            "demoted_after": dispatches}


# the dynamic path: the reference example's mutation stream
# (examples/dynamic_serving.py) on the GCN path's graph
DYN_STREAM = dict(steps=5, insert_frac=0.01, delete_frac=0.01,
                  update_frac=0.05, seed=1)
# the k-sharded sidecar form runs the stream's first steps under a budget
# that makes a sidecar of up to 2 x this capacity take the k-sharded tier
DYN_KSHARDED_STEPS = 2
DYN_KSHARDED_CAP = 65536


def dynamic_path(ctx, graph):
    """The dynamic path on the card, at ogbn-arxiv size (the GCN path's
    graph): ``from_coo(..., dynamic=True)``, then ``mutate``'s stream
    (DYN_STREAM), each step ``update()`` (host seconds, routing stats),
    the sidecar's ``_materialize`` (host seconds, capacity, tier) and
    ``spmm`` (CUDA events, beside the base plan's call alone; launches,
    the sidecar's own being those of the dynamic ``spmm`` less those of
    the base plan alone), held
    against ``torch.sparse.mm`` on the CSR of ``to_coo()``; the sidecar's
    contribution (``execute_delta_contribution``) against its plain
    version.  Twice: on the default tier (B2's walk) for the whole stream,
    and under a budget that puts the sidecar on the k-sharded tier (B3's
    walk) for its first DYN_KSHARDED_STEPS steps.  Then, on the first
    form: B's gradient against ``torch.sparse.mm`` with autograd; B with
    an Inf in row 0 under the padded sidecar (NaN cells as the plain
    version's); a registry round trip (bit-equal, no ``prepare``); a fresh
    ``fused+delta`` build with ``executor_build`` armed (raises
    ``KernelLoweringError``, launches nothing); one ``compact()`` (forced
    unless the policy folded), whose leaves must equal a fresh
    ``from_coo`` of ``to_coo()`` and whose ``spmm`` must be bit-equal to
    that plan's; bench_dynamic's three rows (a value update of 1 % of the
    nonzeros, one structural batch, a full re-prepare, each with one
    ``spmm``).  B2 and B3 are timed on the last sidecar of each form."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import spmm as core_spmm
    from repro_torch.core.cost_model import fringe_resident_bytes
    from repro_torch.core.plan_ir import (
        LEAF_NAMES, gather_rows, permute_pad_b, sig_impl,
    )
    from repro_torch.data.graphs import mutate
    from repro_torch.dynamic import (
        DynamicPlan, GraphDelta, PlanRegistry, update_values,
    )
    from repro_torch.errors import KernelLoweringError
    from repro_torch.exec import api
    from repro_torch.exec.health import HEALTH
    from repro_torch.kernels import ops, ref
    from repro_torch.robust.faults import HARNESS, armed

    sp, dev, log, require, drive = (ctx.sp, ctx.dev, ctx.log, ctx.require,
                                    ctx.drive)
    t_path = time.perf_counter()
    rows, cols, vals = graph[:3]
    n = graph[3].shape[0]
    shape = (n, n)
    gen = torch.Generator(device=dev).manual_seed(20)
    b = torch.randn((n, N), device=dev, generator=gen)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    deltas = list(mutate(rows, cols, vals, shape, **DYN_STREAM))
    t_mutate = time.perf_counter() - t0
    log(f"dynamic path (ogbn-arxiv size, {rows.size} nonzeros, N = {N}): "
        f"mutate stream of {len(deltas)} steps generated in {t_mutate:.2f} "
        f"s; per step " + ", ".join(
            f"+{d.ins_rows.size} -{d.del_rows.size} ~{d.upd_rows.size}"
            for d in deltas))

    def plain_contrib(side, bmat):
        """The sidecar's contribution by its plain version: the reference
        gather on the padded stream (or its k-bucketed copy), then the
        sidecar's row gather."""
        d_rows, d_cols, d_vals, gsrc, kbc, kbr, kbcol, kbv = side.leaves
        if side.tier == "ksharded":
            packed = ref.ref_gather_spmm_kblocked(
                kbc, kbr, kbcol, kbv, bmat, side.capacity, side.bk,
                step=1 << 20)
        else:
            packed = ref.ref_gather_spmm(d_rows, d_cols, d_vals, bmat,
                                         side.capacity, chunk=1 << 20)
        return gather_rows(packed, gsrc)

    def library_ref(dp, bmat):
        r, c, v = dp.to_coo()
        return torch.sparse.mm(ctx.csr_of(r, c, v, shape), bmat)

    def run_form(label, a, steps, kernel):
        dp = a.plan
        log_rows = []
        for step, delta in enumerate(deltas[:steps]):
            stats, t_update = synced(lambda: dp.update(delta))
            if not dp.delta_nnz:   # the policy folded: no sidecar to run
                e_spmm = ctx.err_bound(sp.spmm(a, b), library_ref(dp, b))
                log_rows.append({"step": step, "update_s": t_update,
                                 **stats, "err_spmm": e_spmm})
                log(f"  {label} step {step}: update {t_update:.3f} s, "
                    f"folded by the policy ({dp.last_decision.reason}); "
                    f"vs torch.sparse.mm {e_spmm:.3e}")
                continue
            side, t_mat = synced(dp._materialize)
            _, base_counts = drive(lambda: api.execute(dp.plan, b))
            out, counts = drive(lambda: sp.spmm(a, b))
            side_launches = {k: counts[k] - base_counts[k] for k in counts}
            require(side_launches[kernel] == 1
                    and sum(side_launches.values()) == 1,
                    (label, step, "sidecar launches", side_launches))
            e_spmm = ctx.err_bound(out, library_ref(dp, b))
            contrib, c_counts = drive(lambda: api.execute_delta_contribution(
                shape, dp.config, side, b))
            require(c_counts[kernel] == 1 and sum(c_counts.values()) == 1,
                    (label, step, c_counts))
            e_side = ctx.err_bound(contrib, plain_contrib(side, b))
            spmm_ms = ctx.timed_ms(lambda: sp.spmm(a, b), budget_ms=100.0)
            base_ms = ctx.timed_ms(lambda: api.execute(dp.plan, b),
                                   budget_ms=100.0)
            row = {"step": step, "update_s": t_update, **stats,
                   "materialize_s": t_mat, "capacity": side.capacity,
                   "count": side.count, "tier": side.tier, "bk": side.bk,
                   "spmm_ms": spmm_ms, "base_ms": base_ms,
                   "launches": counts,
                   "sidecar_launches": side_launches,
                   "err_spmm": e_spmm, "err_sidecar": e_side}
            log_rows.append(row)
            log(f"  {label} step {step}: update {t_update:.3f} s "
                f"(fast_path {stats['fast_path']}, delta_nnz "
                f"{stats['delta_nnz']}, compacted {stats['compacted']}); "
                f"materialize {t_mat:.3f} s; sidecar capacity "
                f"{side.capacity} ({side.count} entries), tier {side.tier}"
                f"{f' bk={side.bk}' if side.bk else ''}; spmm "
                f"{spmm_ms:.3f} ms (the base plan alone {base_ms:.3f} ms); "
                f"launches {counts} (sidecar "
                f"{ {k: v for k, v in side_launches.items() if v} }); vs "
                f"torch.sparse.mm {e_spmm:.3e}; sidecar vs plain "
                f"{e_side:.3e}")
        return dp, log_rows

    def sidecar_kernel(label, dp):
        """B2 or B3 on the form's last sidecar, as the fused body calls
        it (its own derived cache, warm), against its plain version and
        cuSPARSE on the CSR of the padded stream."""
        side = dp._materialize()
        d_rows, d_cols, d_vals, _gsrc, kbc, kbr, kbcol, kbv = side.leaves
        bp = permute_pad_b(b, None, False, dp.config.bk)
        cap = side.capacity
        kname = ("gather_spmm_ksharded" if side.tier == "ksharded"
                 else "gather_spmm")

        def kern():
            return ops.delta_fringe_spmm(
                d_rows, d_cols, d_vals, bp, num_rows=cap, impl="cuda",
                tier=side.tier, bk=side.bk, kb_chunk=kbc, kb_rows=kbr,
                kb_cols=kbcol, kb_vals=kbv, derived=side.derived)

        # the walk takes the stream in its row order, which keeps only the
        # padding entries that change its sum (gather_spmm.drop_padding)
        kern()
        order = side.derived["kbucket_row_order" if side.tier == "ksharded"
                             else "stream_row_order"]
        entries = int(order.perm.numel())
        gcols = order.cols
        index_bytes = entries * 12
        if side.tier == "ksharded":
            def plain():
                return ref.ref_gather_spmm_kblocked(
                    kbc, kbr, kbcol, kbv, bp, cap, side.bk, step=1 << 20)
        else:
            def plain():
                return ref.ref_gather_spmm(d_rows, d_cols, d_vals, bp, cap,
                                           chunk=1 << 20)
        lib = torch.sparse_coo_tensor(
            torch.stack([d_rows.long(), d_cols.long()]), d_vals,
            (cap, bp.shape[0])).coalesce().to_sparse_csr()
        b_rows = int(torch.unique(gcols).numel())
        m = ctx.measure(
            f"{kname} on the {label} sidecar (capacity {cap}, "
            f"{side.count} entries, {entries} walked)",
            kern, plain, lambda: torch.sparse.mm(lib, bp),
            # each byte once: the walked stream (the padding it keeps
            # included), the B rows it addresses, the packed output; a
            # multiply-add per walked entry
            nbytes=index_bytes + b_rows * N * 4 + cap * N * 4,
            flops=2 * entries * N)
        return {"kernel": kname, "tier": side.tier,
                "capacity": cap, "count": side.count, "entries": entries,
                **m}

    def nonfinite(label, dp):
        """An Inf in B's row 0 under the padded sidecar: the card's NaN
        and Inf cells are the plain version's, finite cells within the
        tolerance."""
        side = dp._materialize()
        b_inf = b.clone()
        b_inf[0, 3] = float("inf")
        got = api.execute_delta_contribution(shape, dp.config, side, b_inf)
        want = plain_contrib(side, b_inf)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        row0 = int(torch.nonzero(side.leaves[3] == 0)[0])
        require(bool(nan[row0, 3]), (label, "padding gave no NaN"))
        require(torch.equal(torch.isnan(got), nan)
                and torch.equal(torch.isinf(got), torch.isinf(want)),
                (label, "NaN/Inf cells"))
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item()
        require(err <= TOL * max(1.0, want[fin].abs().max().item()),
                (label, err))
        log(f"  {label} sidecar with an Inf in B row 0: {int(nan.sum())} NaN "
            f"cells as in the plain version (packed row 0, original row "
            f"{row0}); finite cells max |diff| {err:.3e}")

    # --- the default tier (B2's walk), the whole stream --------------------
    a, t_prepare = synced(lambda: sp.from_coo(rows, cols, vals, shape,
                                              device=dev, dynamic=True))
    log(f"  from_coo(dynamic=True): {t_prepare:.2f} s; base fringe tier "
        f"{a.plan.plan.fringe_tier}")
    dp, steps_default = run_form("default", a, len(deltas), "gather_spmm")
    require(all(r.get("tier", "resident") == "resident"
                for r in steps_default), steps_default)
    if not dp.delta_nnz:   # folded at the last step: one more batch
        dp.update(GraphDelta.inserts(deltas[0].ins_rows, deltas[0].ins_cols,
                                     deltas[0].ins_vals))
    kern_default = sidecar_kernel("default-tier", dp)
    nonfinite("default-tier", dp)

    # B's gradient through the base plan (the transpose plan) and the
    # transposed sidecar, against the library's autograd on the CSR
    g = torch.randn((n, N), device=dev, generator=gen)
    bt = b.clone().requires_grad_(True)
    (_, t_grad) = synced(lambda: (sp.spmm(a, bt) * g).sum().backward())
    r, c, v = dp.to_coo()
    b_lib = b.clone().requires_grad_(True)
    (torch.sparse.mm(ctx.csr_of(r, c, v, shape), b_lib) * g).sum().backward()
    e_grad = ctx.err_bound(bt.grad, b_lib.grad)
    log(f"  B's gradient (first backward, plan_t prepared: {t_grad:.2f} s) "
        f"vs torch.sparse.mm with autograd: {e_grad:.3e}")

    # registry round trip of the plan with its pending deltas
    root = tempfile.mkdtemp(prefix="repro_torch_registry_")
    try:
        reg = PlanRegistry(root)
        _, t_save = synced(lambda: reg.save("arxiv", dp))
        prepares = core_spmm.prepare_call_count()
        loaded, t_load = synced(lambda: reg.load("arxiv"))
        require(core_spmm.prepare_call_count() == prepares,
                "the registry load ran prepare")
        require(loaded.delta_nnz == dp.delta_nnz, "overlay lost")
        same = bits_equal(loaded.execute(b), dp.execute(b))
        require(same, "the loaded plan's spmm is not bit-equal")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del loaded
    log(f"  registry: save {t_save:.2f} s, load {t_load:.2f} s (no "
        f"prepare), spmm bit-equal {same}")

    # a fresh fused+delta build under an armed executor_build: raises,
    # launches nothing (batch 3: a (signature, batch, sidecar) key no
    # other call built)
    HARNESS.reset()
    HEALTH.reset()
    b3 = torch.randn((3, n, 16), device=dev, generator=gen)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    raised = None
    with armed("executor_build", times=1,
               match=lambda s: sig_impl(s) == "cuda"):
        try:
            sp.bspmm(a, b3)
        except KernelLoweringError as err:
            raised = err
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(raised is not None, "the armed fused+delta build did not raise")
    require(not any(counts.values()), ("the armed build launched", counts))
    HARNESS.reset()
    HEALTH.reset()
    e_b3 = ctx.err_bound(sp.bspmm(a, b3)[2], sp.spmm(a, b3[2]))
    log(f"  executor_build armed around a fresh fused+delta build: "
        f"KernelLoweringError ({type(raised.__cause__).__name__} chained), "
        f"no launch; after HEALTH.reset() bspmm vs spmm {e_b3:.3e}")

    # the fold
    folded_by_policy = dp.compactions > 0
    if not folded_by_policy:
        _, t_fold = synced(dp.compact)
    else:
        t_fold = None
    fresh, t_fresh = synced(lambda: sp.from_coo(*dp.to_coo(), shape,
                                                device=dev))
    for name in LEAF_NAMES:
        require(torch.equal(getattr(dp.plan, name),
                            getattr(fresh.plan, name)),
                ("folded leaf differs from a fresh from_coo", name))
    require(bits_equal(sp.spmm(a, b), sp.spmm(fresh, b)),
            "the folded plan's spmm is not bit-equal to a fresh plan's")
    e_fold = ctx.err_bound(sp.spmm(a, b), library_ref(dp, b))
    log(f"  fold: {'by the policy' if folded_by_policy else 'forced'}, "
        f"compact() {t_fold if t_fold is None else round(t_fold, 2)} s; "
        f"leaves equal a fresh from_coo ({t_fresh:.2f} s), spmm bit-equal; "
        f"vs torch.sparse.mm {e_fold:.3e}; decision after the last step: "
        f"{dp.last_decision}")
    del fresh

    # bench_dynamic's three rows, each with one spmm (best of 2)
    rng = np.random.RandomState(0)
    base = dp.plan
    nnz = base.update_maps.nnz
    d = max(1, nnz // 100)

    def best_of(fn, reps=2):
        return min(synced(fn)[1] for _ in range(reps))

    state = {"plan": base}

    def value_cycle():
        idx = rng.choice(nnz, d, replace=False)
        state["plan"] = update_values(state["plan"], idx, rng.randn(d))
        api.execute(state["plan"], b)

    t_value = best_of(value_cycle)
    dp2 = DynamicPlan(base, auto_compact=False)
    taken = set((base.update_maps.rows * np.int64(n)
                 + base.update_maps.cols).tolist())

    def fresh_edges(count):
        out = []
        while len(out) < count:
            for key in (rng.randint(0, n, count).astype(np.int64) * n
                        + rng.randint(0, n, count)).tolist():
                if key not in taken and len(out) < count:
                    taken.add(key)
                    out.append(key)
        keys = np.asarray(out, np.int64)
        return keys // n, keys % n

    def struct_cycle():
        rr, cc = fresh_edges(d)
        dp2.update(GraphDelta.inserts(rr, cc, rng.randn(d)))
        dp2.execute(b)

    t_struct = best_of(struct_cycle)
    mv = base.update_maps

    def reprepare_cycle():
        v2 = mv.vals.copy()
        v2[rng.choice(nnz, d, replace=False)] = rng.randn(d)
        api.execute(core_spmm.prepare(mv.rows, mv.cols, v2, shape,
                                      base.config, device=dev), b)

    t_full = best_of(reprepare_cycle)
    bench = {"value_update_s": t_value, "struct_update_s": t_struct,
             "full_reprepare_s": t_full, "delta": d,
             "full_over_value": t_full / t_value,
             "full_over_struct": t_full / t_struct}
    log(f"  bench_dynamic rows ({d} nonzeros, 1 %; each with one spmm, best"
        f" of 2): value update {t_value:.3f} s, structural batch "
        f"{t_struct:.3f} s, full re-prepare {t_full:.3f} s; re-prepare / "
        f"value {t_full / t_value:.1f}x, re-prepare / structural "
        f"{t_full / t_struct:.1f}x")
    del state, dp2, a, dp, bt, b_lib, g

    # --- the k-sharded tier (B3's walk), the stream's first steps ----------
    k_pad = -(-n // 64) * 64
    budget = fringe_resident_bytes(k_pad, DYN_KSHARDED_CAP, 256) - 1
    a_ks, t_prepare_ks = synced(lambda: sp.from_coo(
        rows, cols, vals, shape, device=dev, dynamic=True,
        fringe_vmem_budget=budget))
    log(f"  k-sharded form: fringe_vmem_budget {budget}, from_coo "
        f"{t_prepare_ks:.2f} s; base fringe tier {a_ks.plan.plan.fringe_tier}")
    dp_ks, steps_ks = run_form("k-sharded", a_ks, DYN_KSHARDED_STEPS,
                               "gather_spmm_ksharded")
    require(all(r.get("tier", "ksharded") == "ksharded" for r in steps_ks)
            and any("tier" in r for r in steps_ks), steps_ks)
    kern_ks = sidecar_kernel("k-sharded", dp_ks)
    nonfinite("k-sharded", dp_ks)
    del a_ks, dp_ks
    torch.cuda.empty_cache()

    wall = time.perf_counter() - t_path
    log(f"  dynamic path wall time: {wall:.1f} s")
    return {"mutate_s": t_mutate, "prepare_s": t_prepare,
            "steps_default": steps_default, "steps_ksharded": steps_ks,
            "sidecar_kernels": [kern_default, kern_ks],
            "grad_err": e_grad, "registry": {"save_s": t_save,
                                             "load_s": t_load},
            "fold": {"by_policy": folded_by_policy, "compact_s": t_fold,
                     "fresh_from_coo_s": t_fresh},
            "bench": bench, "wall_s": wall}


# the serving path: SpmmService at ogbn-arxiv size (the GCN path's graph),
# request rounds that run every bucket of max_batch 8 once, unpadded
SERVE_MAX_BATCH = 8
SERVE_ROUNDS = (8, 8, 4, 2, 1)
SERVE_STEPS = 2   # steps of DYN_STREAM's mutation stream served through


def standalone_context():
    """The helpers every path takes: launch counts around a path, the
    tolerance check, CUDA-event times, a kernel's measurement beside its
    plain version, the library call and its bound on the card, and the CSR
    of a COO.  ``main`` uses them, and so does a probe that runs one path
    alone (``bench_torch/dynamic_probe.py``,
    ``bench_torch/serving_probe.py``)."""
    import torch

    import repro_torch.sparse as sp
    from repro_torch.core import cost_model
    from repro_torch.kernels import ops

    dev = torch.device("cuda")

    def drive(path):
        """Run one path with the launch counts set to 0 just before it;
        return its result and the counts read just after it."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = path()
        torch.cuda.synchronize()
        return out, ops.launch_counts()

    def err_bound(got, want):
        torch.cuda.synchronize()
        require(got.shape == want.shape, (got.shape, want.shape))
        require(bool(torch.isfinite(got).all()), "non-finite output")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(err <= TOL * scale, f"max |diff| {err} > {TOL} * {scale}")
        return err

    def timed_ms(fn, budget_ms=300.0, max_reps=200):
        """Mean ms per call over back-to-back calls after one warm-up,
        with enough calls to fill about ``budget_ms`` (at least 2)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        first = start.elapsed_time(end)
        reps = int(min(max_reps, max(2, budget_ms // max(first, 1e-3))))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound_ms(nbytes, flops):
        # the H100 SXM's HBM rate and fp32 rate outside the tensor cores
        t_bytes = nbytes / cost_model.H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / cost_model.H100_FP32_FLOPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def measure(label, kern, plain, library, nbytes, flops):
        """Hold ``kern`` against ``plain`` and time both, and ``library``."""
        err = err_bound(kern(), plain())
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain)
        lib_ms = timed_ms(library) if library is not None else None
        bms, by = bound_ms(nbytes, flops)
        log(f"  {label}: {ms:.3f} ms (plain {plain_ms:.3f} ms, library "
            f"{lib_ms if lib_ms is None else round(lib_ms, 3)} ms, bound "
            f"{bms:.3f} ms by {by}); max |kernel - plain| {err:.3e}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}

    def csr_of(r, c, v, shape):
        idx = torch.stack([torch.as_tensor(r), torch.as_tensor(c)]).to(dev)
        return torch.sparse_coo_tensor(
            idx, torch.as_tensor(v, dtype=torch.float32).to(dev), shape,
        ).coalesce().to_sparse_csr()

    return types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, measure=measure,
        csr_of=csr_of)


def serving_path(ctx, graph):
    """The serving path on the card: ``SpmmService`` over a dynamic plan of
    the GCN path's graph at ogbn-arxiv size, N = 256, ``max_batch`` 8.

    1. Registered with a ``PlanRegistry`` in a temporary directory; 23
       requests in rounds of SERVE_ROUNDS, one ``flush`` each, so that the
       buckets 8, 8, 4, 2 and 1 each run once; each result against
       ``torch.sparse.mm`` on the CSR; the launches of each flush (one
       B1 and one fringe kernel for any bucket), its CUDA-event time, the
       p50 and p99 of submit -> fetch and requests/s.
    2. SERVE_STEPS steps of the reference example's stream through
       ``update_matrix`` (host seconds), a request served after each
       against the library on ``to_coo()``; the sidecar's capacity, its
       padding and what the walk keeps of it; ``spmm`` (CUDA events)
       beside the base plan's; B2 on the sidecar with the cut row order
       and with every padding entry (the walk before the repair): bit-equal
       on a finite B, each timed.  Then a service whose budget puts the
       sidecar on the k-sharded tier (as the dynamic path's), one step,
       one request (B3 must launch), ``spmm`` timed, and B3 cut and full.
    3. A fold forced through the cost model: a tuned ``delta_max_fraction``
       in an injected record (the analytic rates, so the plan is the
       analytic one), then one update; requests are served against the
       old plan while the fold runs on the worker, and the folded leaves
       equal a fresh ``from_coo`` of ``to_coo()``.
    4. ``fold_build`` armed for ``quarantine_after`` folds: the matrix is
       ``quarantined``, keeps serving through its sidecar, and ``close()``
       is clean.
    5. A second service warm-started from the registry: no ``prepare``,
       its first result bit-equal to the first service's on that panel.
    6. A service with ``autotune=True``: the background tune (wall time,
       microbenchmarks, the adopted decisions and what each candidate
       measured), then a fresh tuner that reads the table back through
       ``RegistryTuningStore`` with 0 microbenchmarks; where the tuned tile
       shape or tier differs from the analytic one, the plan built with it
       against the library.

    Every phase drives the service through its entry points; launch
    counts are set to 0 just before each flush and read just after it.
    """
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import spmm as core_spmm
    from repro_torch.core import tuner
    from repro_torch.core.cost_model import (
        default_cost_model, fringe_resident_bytes,
    )
    from repro_torch.core.plan_ir import LEAF_NAMES, SpmmConfig, permute_pad_b
    from repro_torch.data.graphs import mutate
    from repro_torch.dynamic import GraphDelta, PlanRegistry
    from repro_torch.dynamic.tuning import RegistryTuningStore
    from repro_torch.errors import CompactionError
    from repro_torch.exec import api
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_spmm import (
        gather_spmm, gather_spmm_ksharded, kbucket_row_order,
        stream_row_order,
    )
    from repro_torch.robust.faults import HARNESS, armed
    from repro_torch.serve import SpmmService

    sp, dev, log, require, drive = (ctx.sp, ctx.dev, ctx.log, ctx.require,
                                    ctx.drive)
    t_path = time.perf_counter()
    rows, cols, vals = graph[:3]
    n = graph[3].shape[0]
    shape = (n, n)
    gen = torch.Generator(device=dev).manual_seed(30)
    csr = ctx.csr_of(rows, cols, vals, shape)
    root = tempfile.mkdtemp(prefix="repro_torch_serving_")
    out = {}

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def panel():
        return torch.randn((n, N), device=dev, generator=gen)

    def library_ref(dp, bmat):
        r, c, v = dp.to_coo()
        return torch.sparse.mm(ctx.csr_of(r, c, v, shape), bmat)

    def serve_one(svc, name, bmat):
        """One request through submit/flush/fetch; the result and the
        flush's launches."""
        t = svc.submit(name, bmat)
        _, counts = drive(lambda: svc.flush(name=name))
        return svc.fetch(t), counts

    def injected_record(key, decisions):
        am = default_cost_model()
        return {"table_format_version": tuner.TABLE_FORMAT_VERSION,
                "key": key, "p_matrix": am.p_matrix,
                "p_vector": am.p_vector, "r": am.r, "n_cols": am.n_cols,
                "decisions": dict(decisions)}

    try:
        # --- 1. registration and the request rounds ------------------------
        tuner.reset_for_tests()
        HARNESS.reset()
        reg = PlanRegistry(root)
        # "offline": the plans read the tuner's table, where phase 3
        # injects its record; until then the record below holds the
        # analytic rates and thresholds, so the plan is the analytic one
        cfg = SpmmConfig(autotune="offline")
        key = tuner.table_key("spmm", n, n, rows.size, cfg)
        tuner.get_tuner().adopt(key, injected_record(key, {}))
        svc = SpmmService(cfg, max_batch=SERVE_MAX_BATCH, registry=reg)
        _, t_register = synced(
            lambda: svc.register("arxiv", rows, cols, vals, shape))
        dp = svc.plan("arxiv")
        log(f"serving path (ogbn-arxiv size, {rows.size} nonzeros, N = {N},"
            f" max_batch {SERVE_MAX_BATCH}): register (prepare + registry "
            f"save) {t_register:.2f} s; fringe tier {dp.plan.fringe_tier}")
        # the first request builds the plan's derived index arrays (row
        # offsets, window segments, the chunk table): timed on its own
        cold = panel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = serve_one(svc, "arxiv", cold)
        first_ms = (time.perf_counter() - t0) * 1e3
        ctx.err_bound(res, torch.sparse.mm(csr, cold))
        del cold, res
        lat, flushes = [], []
        t_serve = 0.0   # first submit -> last result of each round, summed
        for size in SERVE_ROUNDS:
            panels = [panel() for _ in range(size)]
            torch.cuda.synchronize()
            t_sub, tickets = [], []
            for bmat in panels:
                t_sub.append(time.perf_counter())
                tickets.append(svc.submit("arxiv", bmat))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, counts = drive(lambda: svc.flush(name="arxiv"))
            end.record()
            results = [svc.fetch(t) for t in tickets]
            torch.cuda.synchronize()
            t_done = time.perf_counter()
            lat += [t_done - t for t in t_sub]
            t_serve += t_done - t_sub[0]
            require(counts["dense_tile_spmm"] == 1
                    and counts["gather_spmm"] + counts[
                        "gather_spmm_ksharded"] == 1
                    and sum(counts.values()) == 2, ("flush", size, counts))
            errs = [ctx.err_bound(r, torch.sparse.mm(csr, bmat))
                    for r, bmat in zip(results, panels)]
            flushes.append({"requests": size, "bucket": size,
                            "flush_ms": start.elapsed_time(end),
                            "launches": {k: v for k, v in counts.items()
                                         if v},
                            "max_err": max(errs)})
            del panels, results
        stats = svc.stats.as_dict()
        require(stats["requests"] == sum(SERVE_ROUNDS) + 1
                and stats["dispatches"] == len(SERVE_ROUNDS) + 1, stats)
        lat_ms = np.asarray(lat) * 1e3
        out["requests"] = {
            "count": int(sum(SERVE_ROUNDS)), "flushes": flushes,
            "padded_slots": stats["padded_slots"],
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "requests_per_s": sum(SERVE_ROUNDS) / t_serve,
            "wall_s": t_serve, "first_request_ms": first_ms}
        for f in flushes:
            log(f"  flush of {f['requests']} (bucket {f['bucket']}): "
                f"{f['flush_ms']:.3f} ms by CUDA events, "
                f"{f['flush_ms'] / f['requests']:.3f} ms a request; "
                f"launches {f['launches']}; vs torch.sparse.mm "
                f"{f['max_err']:.3e}")
        log(f"  the first request (builds the plan's index arrays): "
            f"{first_ms:.1f} ms submit -> fetch")
        log(f"  {sum(SERVE_ROUNDS)} requests in {len(SERVE_ROUNDS)} flushes"
            f": padded_slots {stats['padded_slots']}; submit -> fetch p50 "
            f"{out['requests']['p50_ms']:.2f} ms, p99 "
            f"{out['requests']['p99_ms']:.2f} ms; "
            f"{out['requests']['requests_per_s']:.1f} requests/s")

        # --- 2. the mutation stream through update_matrix ------------------
        t0 = time.perf_counter()
        deltas = list(mutate(rows, cols, vals, shape,
                             **dict(DYN_STREAM, steps=SERVE_STEPS)))
        log(f"  mutate stream of {len(deltas)} steps: "
            f"{time.perf_counter() - t0:.2f} s")
        b = panel()

        def sidecar_walks(label, dpl):
            """B2 (or B3) on the plan's sidecar with the cut row order and
            with every padding entry: bit-equal on this finite B; each
            timed by CUDA events."""
            side = dpl._materialize()
            d_rows, d_cols, d_vals, _gsrc, kbc, kbr, kbcol, kbv = \
                side.leaves
            bp = permute_pad_b(b, None, False, dpl.config.bk)
            cap = side.capacity

            def cut():
                return ops.delta_fringe_spmm(
                    d_rows, d_cols, d_vals, bp, num_rows=cap, impl="cuda",
                    tier=side.tier, bk=side.bk, kb_chunk=kbc, kb_rows=kbr,
                    kb_cols=kbcol, kb_vals=kbv, derived=side.derived)

            if side.tier == "ksharded":
                full_order = kbucket_row_order(kbc, kbr, kbcol, cap,
                                               side.bk)

                def full():
                    return gather_spmm_ksharded(
                        kbc, kbr, kbcol, kbv, bp, num_rows=cap, bk=side.bk,
                        row_order=full_order)
                n_pad = kbr.numel() - side.count
                key_order = "kbucket_row_order"
            else:
                full_order = stream_row_order(d_rows, d_cols, cap)

                def full():
                    return gather_spmm(d_rows, d_cols, d_vals, bp,
                                       num_rows=cap, row_order=full_order)
                n_pad = cap - side.count
                key_order = "stream_row_order"
            same = bits_equal(cut(), full())
            require(same, (label, "the cut row order changed the bits"))
            walked = int(side.derived[key_order].perm.numel())
            kept = walked - side.count
            row = {"tier": side.tier, "bk": side.bk, "capacity": cap,
                   "count": side.count, "padding": n_pad,
                   "padding_walked": kept,
                   "ms": ctx.timed_ms(cut), "full_walk_ms": ctx.timed_ms(
                       full), "bit_equal": same}
            log(f"  {label} sidecar: capacity {cap}, {side.count} entries, "
                f"{n_pad} padding of which the walk keeps {kept}; "
                f"{'B3' if side.tier == 'ksharded' else 'B2'} "
                f"{row['ms']:.3f} ms, over every padding entry "
                f"{row['full_walk_ms']:.3f} ms; bit-equal {same}")
            return row

        steps = []
        for step, delta in enumerate(deltas):
            stats_u, t_update = synced(
                lambda: svc.update_matrix("arxiv", delta))
            res, counts = serve_one(svc, "arxiv", b)
            e_serve = ctx.err_bound(res, library_ref(dp, b))
            require(counts["dense_tile_spmm"] == 1
                    and counts["gather_spmm"] + counts[
                        "gather_spmm_ksharded"] == 2, ("step", counts))
            walks = sidecar_walks(f"step {step}", dp)
            spmm_ms = ctx.timed_ms(lambda: dp.execute(b), budget_ms=100.0)
            base_ms = ctx.timed_ms(lambda: api.execute(dp.plan, b),
                                   budget_ms=100.0)
            steps.append({"step": step, "update_matrix_s": t_update,
                          **stats_u, "spmm_ms": spmm_ms, "base_ms": base_ms,
                          "launches": {k: v for k, v in counts.items() if v},
                          "err": e_serve, "sidecar": walks})
            log(f"  step {step}: update_matrix {t_update:.3f} s (fast_path "
                f"{stats_u['fast_path']}, delta_nnz {stats_u['delta_nnz']})"
                f"; served vs torch.sparse.mm on to_coo() {e_serve:.3e}, "
                f"launches {steps[-1]['launches']}; spmm {spmm_ms:.3f} ms "
                f"(the base plan alone {base_ms:.3f} ms)")
        out["steps"] = steps

        # the k-sharded sidecar (B3), as the dynamic path forces it
        k_pad = -(-n // 64) * 64
        budget = fringe_resident_bytes(k_pad, DYN_KSHARDED_CAP, 256) - 1
        svc_ks = SpmmService(SpmmConfig(fringe_vmem_budget=budget),
                             max_batch=SERVE_MAX_BATCH)
        _, t_reg_ks = synced(
            lambda: svc_ks.register("arxiv-ks", rows, cols, vals, shape))
        dp_ks = svc_ks.plan("arxiv-ks")
        _, t_update_ks = synced(
            lambda: svc_ks.update_matrix("arxiv-ks", deltas[0]))
        res, counts = serve_one(svc_ks, "arxiv-ks", b)
        e_ks = ctx.err_bound(res, library_ref(dp_ks, b))
        require(counts["gather_spmm_ksharded"] >= 1, ("k-sharded", counts))
        walks_ks = sidecar_walks("k-sharded", dp_ks)
        require(walks_ks["tier"] == "ksharded", walks_ks)
        spmm_ks = ctx.timed_ms(lambda: dp_ks.execute(b), budget_ms=100.0)
        base_ks = ctx.timed_ms(lambda: api.execute(dp_ks.plan, b),
                               budget_ms=100.0)
        out["ksharded"] = {"register_s": t_reg_ks,
                           "update_matrix_s": t_update_ks,
                           "spmm_ms": spmm_ks, "base_ms": base_ks,
                           "launches": {k: v for k, v in counts.items()
                                        if v},
                           "err": e_ks, "sidecar": walks_ks}
        log(f"  k-sharded service (budget {budget}): register "
            f"{t_reg_ks:.2f} s, update_matrix {t_update_ks:.3f} s; served "
            f"vs torch.sparse.mm {e_ks:.3e}, launches "
            f"{out['ksharded']['launches']}; spmm {spmm_ks:.3f} ms (the base "
            f"plan alone {base_ks:.3f} ms)")
        svc_ks.close()
        del svc_ks, dp_ks
        torch.cuda.empty_cache()

        # --- 3. a fold forced through the cost model -----------------------
        tuner.get_tuner().adopt(key, injected_record(
            key, {"delta_max_fraction": 1e-9}))
        require(dp.refresh_cost_model(), "the injected record was not read")
        zr = np.random.RandomState(31).randint(0, n, 64)
        zc = np.random.RandomState(32).randint(0, n, 64)
        taken = set((dp.maps.rows * np.int64(n) + dp.maps.cols).tolist())
        taken |= set(dp._overlay)
        keep = [i for i in range(64)
                if int(zr[i]) * n + int(zc[i]) not in taken]
        ins = GraphDelta.inserts(zr[keep[:8]], zc[keep[:8]],
                                 np.ones(len(keep[:8])))
        svc.update_matrix("arxiv", ins)
        require(svc.stats.compactions_scheduled == 1,
                svc.stats.as_dict())
        fut = svc._folds["arxiv"][1]
        served_during = 0
        while not fut.done() and served_during < 50:
            res, _ = serve_one(svc, "arxiv", b)
            ctx.err_bound(res, library_ref(dp, b))
            # a flush swaps the fold in only once it has finished
            require(dp.compactions == 0 or fut.done(), "swapped mid-fold")
            served_during += dp.compactions == 0
        require(served_during >= 1, "nothing served during the fold")
        _, t_drain = synced(lambda: svc.drain_compactions(timeout=300))
        require(dp.compactions == 1 and dp.delta_nnz == 0,
                (dp.compactions, dp.delta_nnz))
        fresh, t_fresh = synced(lambda: sp.from_coo(*dp.to_coo(), shape,
                                                    device=dev))
        for name in LEAF_NAMES:
            require(torch.equal(getattr(dp.plan, name),
                                getattr(fresh.plan, name)),
                    ("folded leaf differs from a fresh from_coo", name))
        res, _ = serve_one(svc, "arxiv", b)
        e_fold = ctx.err_bound(res, library_ref(dp, b))
        out["fold"] = {"served_during": served_during,
                       "drain_s": t_drain, "fresh_from_coo_s": t_fresh,
                       "err": e_fold}
        log(f"  fold through a tuned delta_max_fraction: {served_during} "
            f"requests served against the old plan while it ran; drained "
            f"{t_drain:.2f} s after; leaves equal a fresh from_coo "
            f"({t_fresh:.2f} s); vs torch.sparse.mm {e_fold:.3e}")
        del fresh

        # --- 4. quarantine ----------------------------------------------------
        errors = 0
        with armed("fold_build", times=None):
            for i in range(svc.quarantine_after):
                d = GraphDelta.inserts(zr[keep[8 + i:9 + i]],
                                       zc[keep[8 + i:9 + i]], [1.0])
                svc.update_matrix("arxiv", d)
                try:
                    svc.drain_compactions(timeout=300)
                except CompactionError:
                    errors += 1
        h = svc.health()["matrices"]["arxiv"]
        require(errors == svc.quarantine_after and h["state"] ==
                "quarantined", (errors, h))
        res, counts = serve_one(svc, "arxiv", b)
        e_quar = ctx.err_bound(res, library_ref(dp, b))
        require(dp.delta_nnz > 0 and counts["gather_spmm"]
                + counts["gather_spmm_ksharded"] == 2, (dp.delta_nnz,
                                                        counts))
        b_first = panel()
        first, _ = serve_one(svc, "arxiv", b_first)
        svc.close()
        out["quarantine"] = {"failed_folds": errors, "health": h,
                             "err": e_quar,
                             "stats": svc.stats.as_dict()}
        log(f"  fold_build armed: {errors} failed folds, state "
            f"{h['state']}; served through the sidecar ({dp.delta_nnz} "
            f"entries) vs torch.sparse.mm {e_quar:.3e}; close() clean")

        # --- 5. warm start -------------------------------------------------
        prepares = core_spmm.prepare_call_count()
        svc2 = SpmmService(cfg, max_batch=SERVE_MAX_BATCH, registry=reg)
        _, t_warm = synced(lambda: svc2.warm_start("arxiv"))
        again, _ = serve_one(svc2, "arxiv", b_first)
        n_prep = core_spmm.prepare_call_count() - prepares
        same = bits_equal(again, first)
        require(n_prep == 0 and same, (n_prep, same))
        svc2.close()
        out["warm_start"] = {"warm_start_s": t_warm, "prepares": n_prep,
                             "bit_equal": same}
        log(f"  warm start from the registry: {t_warm:.2f} s, {n_prep} "
            f"prepare calls; first result bit-equal to the first "
            f"service's: {same}")
        del svc, svc2, dp, first, again
        torch.cuda.empty_cache()

        # --- 6. the background tune ----------------------------------------
        tuner.reset_for_tests()
        root_tune = tempfile.mkdtemp(prefix="repro_torch_tune_", dir=root)
        reg3 = PlanRegistry(root_tune)
        calls0 = tuner.tune_call_count()
        svc3 = SpmmService(SpmmConfig(autotune=True),
                           max_batch=SERVE_MAX_BATCH, registry=reg3)
        svc3.register("arxiv", rows, cols, vals, shape)
        t0 = time.perf_counter()
        served_while = 0
        while svc3._tunes and served_while < 20:
            res, _ = serve_one(svc3, "arxiv", b)
            ctx.err_bound(res, torch.sparse.mm(csr, b))
            served_while += 1
        svc3.drain_tunings(timeout=600)
        t_tune = time.perf_counter() - t0
        n_bench = tuner.tune_call_count() - calls0
        report = svc3.tuning_report()
        (rec_key, rec), = report["records"].items()
        require(svc3.stats.tunings_applied == 1 and n_bench > 0,
                (svc3.stats.as_dict(), n_bench))
        require(not any(label.startswith("fringe:xla")
                        for label in rec["bench_us"]), rec["bench_us"])
        svc3.close()
        log(f"  autotune=True: background tune {t_tune:.2f} s (register -> "
            f"adopted, {served_while} requests served meanwhile), "
            f"{n_bench} microbenchmarks; record {rec_key}")
        log(f"    decisions {rec['decisions']}")
        log(f"    bench_us {json.dumps(rec['bench_us'])}")
        tuner.reset_for_tests(keep_store=True)
        off = SpmmConfig(autotune="offline")
        cm = tuner.resolve_cost_model("spmm", n, n, rows.size, off)
        require(isinstance(cm, tuner.TunedCostModel) and cm.source ==
                "table" and tuner.tune_call_count() == 0,
                (type(cm), tuner.tune_call_count()))
        require(isinstance(tuner.installed_store(), RegistryTuningStore),
                tuner.installed_store())
        tuned = {"tune_s": t_tune, "microbenchmarks": n_bench,
                 "decisions": rec["decisions"],
                 "bench_us": rec["bench_us"],
                 "refused": rec.get("refused", []),
                 "warm_microbenchmarks": tuner.tune_call_count()}
        if {"tile_shape", "fringe_tier"} & set(rec["decisions"]):
            a_tuned, t_tuned = synced(lambda: sp.from_coo(
                rows, cols, vals, shape, device=dev, autotune="offline"))
            plan = a_tuned.plan
            e_tuned = ctx.err_bound(sp.spmm(a_tuned, b),
                                    torch.sparse.mm(csr, b))
            tuned["tuned_plan"] = {"bm": plan.config.bm,
                                   "bk": plan.config.bk,
                                   "fringe_tier": plan.fringe_tier,
                                   "prepare_s": t_tuned, "err": e_tuned}
            log(f"    the tuned plan (bm {plan.config.bm}, bk "
                f"{plan.config.bk}, tier {plan.fringe_tier}) vs "
                f"torch.sparse.mm {e_tuned:.3e}")
            del a_tuned, plan
        out["autotune"] = tuned
        log(f"  a fresh tuner read the table back through "
            f"RegistryTuningStore: {tuned['warm_microbenchmarks']} "
            f"microbenchmarks, source {cm.source}")
    finally:
        HARNESS.reset()
        tuner.reset_for_tests()
        shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_path
    log(f"  serving path wall time: {out['wall_s']:.1f} s")
    return out


# the sharded path: a 4-way mesh over the visible cards, one card repeated
# where there are fewer (a machine with one H100 runs cuda:0 four times)
SHARDS = 4
# the single-device plan's warm spmm at Reddit scale, N = 256 (PERF.md
# section 5), beside which the rows-sharded plan on one card is printed
REDDIT_SINGLE_MS = 17.871
SHARDED_STEPS = 2     # steps of the reference example's stream
SERVE_FLUSHES = (8, 4, 2, 1)


def median_ms(fn, reps=7):
    """Median of ``reps`` CUDA-event times of one call each, after one
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def sharded_path(ctx, reddit, graph):
    """The sharded path on the card: plans sharded over a 4-way mesh of the
    visible cards (``cuda:0`` four times on one card), through the entry
    points a user calls.  Launch counts are set to 0 just before each
    call and read just after it.

    1. Reddit scale (``reddit``: the main path's COO and shape; its
       single-device plan is freed first), rows axis forced:
       ``from_coo(..., mesh=)`` (host seconds, ``auto_shard_axis``,
       imbalance, rows and nonzeros per shard, the fringe tier, peak
       device memory); ``spmm`` at N = 256 and ``bspmm`` at batch 2, each
       the median of 7 CUDA-event times, launching B1 and the fringe kernel
       once per shard; each held against ``torch.sparse.mm`` and bit-equal
       across two calls; the assemble gather timed alone.
    2. At ogbn-arxiv size (``graph``, the GCN path's): an rhs-sharded
       ``spmm`` (N = 256); the sharded SDDMM at D = 256 (B5 over the
       global COO) against ``torch.sparse.sampled_addmm``, then
       ``with_values`` of its output and ``spmm``; a sharded
       ``DynamicPlan`` through SHARDED_STEPS steps of the reference
       example's stream with the routed sidecar, each against the library
       on ``to_coo()``; a registry save and ``SpmmService.warm_start(mesh=)``
       re-sharding it bit-equal; ``register_sharded`` with flushes of
       SERVE_FLUSHES requests, each against the library.

    Returns the path's numbers and the launches of every kernel summed
    over its calls."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import spmm as core_spmm
    from repro_torch.core.arrays import sorted_unique
    from repro_torch.data.graphs import mutate
    from repro_torch.distributed import make_spmm_mesh
    from repro_torch.dynamic import DynamicPlan, PlanRegistry
    from repro_torch.serve import SpmmService

    sp, dev, log, require, drive = (ctx.sp, ctx.dev, ctx.log, ctx.require,
                                    ctx.drive)
    t_path = time.perf_counter()
    n_cards = torch.cuda.device_count()
    mesh = make_spmm_mesh(devices=[torch.device("cuda", i % n_cards)
                                   for i in range(SHARDS)])
    log(f"sharded path: {mesh}")
    gen = torch.Generator(device=dev).manual_seed(40)
    out = {"mesh": [str(d) for d in mesh.devices]}
    totals = {}

    def counted(fn):
        res, counts = drive(fn)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return res, counts

    def once_per_shard(counts, fringe):
        require(counts["dense_tile_spmm"] == SHARDS
                and counts[fringe] == SHARDS, counts)

    # --- 1. Reddit scale, rows axis ----------------------------------------
    rows, cols, vals, shape = reddit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    splan = core_spmm.prepare_sharded(
        rows, cols, vals, shape, mesh, core_spmm.SpmmConfig(impl="cuda"),
        shard_axis="rows")
    S = sp.from_plan(splan)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    st = splan.stats_dict
    fringe = ("gather_spmm_ksharded" if st["fringe_tier"] == "ksharded"
              else "gather_spmm")
    b = torch.randn((shape[1], N), device=dev, generator=gen)
    bb = torch.randn((2, shape[1], N), device=dev, generator=gen)
    c, counts = counted(lambda: sp.spmm(S, b))
    once_per_shard(counts, fringe)
    cb, counts_b = counted(lambda: sp.bspmm(S, bb))
    once_per_shard(counts_b, fringe)
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(torch.equal(c, sp.spmm(S, b)), "sharded spmm not bit-stable")
    csr = ctx.csr_of(rows, cols, vals, shape)
    e_spmm = ctx.err_bound(c, torch.sparse.mm(csr, b))
    e_bspmm = max(ctx.err_bound(cb[i], torch.sparse.mm(csr, bb[i]))
                  for i in range(2))
    del csr
    spmm_ms = median_ms(lambda: sp.spmm(S, b))
    bspmm_ms = median_ms(lambda: sp.bspmm(S, bb))
    m_loc = splan.rows_per_shard
    stacked_out = torch.empty((SHARDS * m_loc, N), device=dev)
    gather_ms = median_ms(lambda: torch.index_select(stacked_out, 0,
                                                     splan.assemble))
    # where the device time of one call goes, by kernel (torch.profiler)
    device_ms, by_kernel = device_breakdown(lambda: sp.spmm(S, b), top=10)
    out["reddit"] = {
        "prepare_s": t_prep, "auto_shard_axis": st["auto_shard_axis"],
        "rows_imbalance": st["rows_imbalance"],
        "rows_imbalance_est": st["rows_imbalance_est"],
        "shard_rows": list(st["shard_rows"]),
        "shard_nnz": list(st["shard_nnz"]),
        "rows_per_shard_padded": m_loc, "fringe_tier": st["fringe_tier"],
        "tiles_per_shard_padded": splan.sig[9],
        "fringe_per_shard_padded": splan.sig[10],
        "own_tiles": [sh.derived["stack_padding"]["steps"]
                      for sh in splan.shards],
        "own_fringe": [sh.derived["stack_padding"]["fringe"]
                       for sh in splan.shards],
        "peak_gb": peak, "spmm_ms": spmm_ms, "bspmm2_ms": bspmm_ms,
        "assemble_gather_ms": gather_ms, "single_device_ms": REDDIT_SINGLE_MS,
        "device_ms": device_ms, "kernels_ms": by_kernel,
        "launches_spmm": counts, "max_abs_err_spmm": e_spmm,
        "max_abs_err_bspmm": e_bspmm}
    log(f"  reddit-scale, rows axis: prepare_sharded {t_prep:.1f} s "
        f"(auto_shard_axis {st['auto_shard_axis']}, rows_imbalance "
        f"{st['rows_imbalance']:.4f}), shard_rows {st['shard_rows']}, "
        f"shard_nnz {st['shard_nnz']}, tier {st['fringe_tier']}, peak "
        f"device memory {peak:.2f} GB; spmm {spmm_ms:.3f} ms (median of 7; "
        f"single-device plan {REDDIT_SINGLE_MS} ms), bspmm batch 2 "
        f"{bspmm_ms:.3f} ms, assemble gather {gather_ms:.3f} ms; launches "
        f"{counts}; vs torch.sparse.mm {e_spmm:.3e} / {e_bspmm:.3e}")
    log(f"  sharded spmm's device time {device_ms} ms by kernel: "
        f"{by_kernel}")
    del S, splan, c, cb, b, bb, stacked_out
    torch.cuda.empty_cache()

    # --- 2. ogbn-arxiv size ------------------------------------------------
    rows, cols, vals = graph[:3]
    n = graph[3].shape[0]
    shape = (n, n)
    cfg = core_spmm.SpmmConfig(impl="cuda")
    csr = ctx.csr_of(rows, cols, vals, shape)
    b = torch.randn((n, N), device=dev, generator=gen)
    t0 = time.perf_counter()
    R = sp.from_plan(core_spmm.prepare_sharded(rows, cols, vals, shape, mesh,
                                               cfg, shard_axis="rhs"))
    t_rhs = time.perf_counter() - t0
    fringe_r = ("gather_spmm_ksharded" if R.plan.sig[14] == "ksharded"
                else "gather_spmm")
    c, counts = counted(lambda: sp.spmm(R, b))
    once_per_shard(counts, fringe_r)
    out["arxiv_rhs"] = {
        "prepare_s": t_rhs, "spmm_ms": median_ms(lambda: sp.spmm(R, b)),
        "library_ms": median_ms(lambda: torch.sparse.mm(csr, b)),
        "launches": counts,
        "max_abs_err": ctx.err_bound(c, torch.sparse.mm(csr, b))}
    del R
    log(f"  ogbn-arxiv size, rhs axis: {out['arxiv_rhs']}")

    # the sharded SDDMM (B5 over the global COO), then with_values + spmm
    t0 = time.perf_counter()
    S = sp.from_coo(rows, cols, vals, shape, mesh=mesh)
    t_rows = time.perf_counter() - t0
    require(S.is_sharded, "from_coo(mesh=) gave no sharded plan")
    key = rows.astype(np.int64) * n + cols
    order = torch.from_numpy(np.argsort(key, kind="stable")).to(dev)
    require(sorted_unique(key).size == key.size, "the GCN graph has duplicates")
    x = torch.randn((n, N), device=dev, generator=gen)
    yt = torch.randn((n, N), device=dev, generator=gen)
    y = yt.t()
    pattern = torch.sparse_csr_tensor(
        csr.crow_indices(), csr.col_indices(),
        torch.ones(rows.size, device=dev), shape)
    w, counts_sd = counted(lambda: sp.sddmm(S, x, y))
    require(counts_sd["gather_sddmm"] > 0
            and counts_sd["dense_tile_sddmm"] == 0, counts_sd)
    want_w = torch.sparse.sampled_addmm(pattern, x, yt.t().contiguous(),
                                        beta=0.0).values()
    e_sd = ctx.err_bound(w[order], want_w)
    fringe_s = ("gather_spmm_ksharded" if S.plan.sig[14] == "ksharded"
                else "gather_spmm")
    S2 = S.with_values(w)
    c2, counts_wv = counted(lambda: sp.spmm(S2, b))
    once_per_shard(counts_wv, fringe_s)
    wv_csr = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(),
                                     want_w, shape)
    e_wv = ctx.err_bound(c2, torch.sparse.mm(wv_csr, b))
    out["arxiv_sddmm"] = {
        "prepare_rows_s": t_rows,
        "shard_rows": list(S.plan.stats_dict["shard_rows"]),
        "sddmm_ms": median_ms(lambda: sp.sddmm(S, x, y)),
        "library_ms": median_ms(lambda: torch.sparse.sampled_addmm(
            pattern, x, yt.t().contiguous(), beta=0.0)),
        "launches": counts_sd, "max_abs_err": e_sd,
        "with_values_spmm_max_abs_err": e_wv}
    log(f"  ogbn-arxiv size, sharded sddmm at D = {N}: {out['arxiv_sddmm']}")
    del S2, w, c2, wv_csr, pattern, x, y, yt

    # a sharded DynamicPlan over the reference example's stream
    root = tempfile.mkdtemp(prefix="repro_torch_sharded_")
    try:
        t0 = time.perf_counter()
        D = sp.from_plan(DynamicPlan(core_spmm.prepare_sharded(
            rows, cols, vals, shape, mesh, cfg, shard_axis="rows")))
        t_dyn = time.perf_counter() - t0
        dp = D.plan
        steps = []
        deltas = list(mutate(rows, cols, vals, shape,
                             **dict(DYN_STREAM, steps=SHARDED_STEPS)))
        for i, d in enumerate(deltas):
            t0 = time.perf_counter()
            stats = dp.update(d)
            t_up = time.perf_counter() - t0
            t0 = time.perf_counter()
            side = dp._materialize()
            t_mat = time.perf_counter() - t0
            cd, counts_d = counted(lambda: sp.spmm(D, b))
            require(counts_d["dense_tile_spmm"] == SHARDS
                    and counts_d["gather_spmm"]
                    + counts_d["gather_spmm_ksharded"] == 2 * SHARDS,
                    counts_d)
            r, cc, v = dp.to_coo()
            e = ctx.err_bound(cd, torch.sparse.mm(
                ctx.csr_of(r, cc, v, shape), b))
            steps.append({
                "update_s": t_up, "materialize_s": t_mat,
                "routed": type(side).__name__, "capacity": side.capacity,
                "tier": side.tier, "stats": stats,
                "spmm_ms": median_ms(lambda: sp.spmm(D, b)),
                "launches": counts_d, "max_abs_err": e})
            log(f"  sharded dynamic step {i}: {steps[-1]}")
        require(steps and steps[0]["routed"] == "ShardedDeltaFringe", steps)
        out["arxiv_dynamic"] = {"prepare_s": t_dyn, "steps": steps}

        # registry save, then a warm start re-sharded onto the mesh
        reg = PlanRegistry(root)
        t0 = time.perf_counter()
        reg.save("arxiv", dp)
        t_save = time.perf_counter() - t0
        svc = SpmmService(cfg, registry=reg, max_batch=8)
        t0 = time.perf_counter()
        svc.warm_start("arxiv", mesh=mesh)
        t_warm = time.perf_counter() - t0
        warm = svc.plan("arxiv")
        require(warm.is_sharded and warm.delta_nnz == dp.delta_nnz,
                "warm start lost the sharded state")
        tk = svc.submit("arxiv", b)
        svc.flush()
        require(torch.equal(svc.fetch(tk), sp.spmm(D, b)),
                "warm start is not bit-equal")
        out["registry"] = {"save_s": t_save, "warm_start_s": t_warm}

        # register_sharded and flushes of 8, 4, 2, 1
        svc.register_sharded("g", S.plan)
        flushes = []
        for k in SERVE_FLUSHES:
            panels = [torch.randn((n, N), device=dev, generator=gen)
                      for _ in range(k)]
            tickets = [svc.submit("g", p) for p in panels]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def flush():
                start.record()
                svc.flush(name="g")
                end.record()

            _, counts_f = counted(flush)
            once_per_shard(counts_f, fringe_s)
            e = max(ctx.err_bound(svc.fetch(t), torch.sparse.mm(csr, p))
                    for t, p in zip(tickets, panels))
            flushes.append({"requests": k, "ms": start.elapsed_time(end),
                            "launches": counts_f, "max_abs_err": e})
        out["service"] = {"flushes": flushes,
                          "stats": svc.stats.as_dict()}
        log(f"  register_sharded flushes: {flushes}")
        svc.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = totals
    out["wall_s"] = time.perf_counter() - t_path
    log(f"  sharded path wall time: {out['wall_s']:.1f} s; launches "
        f"{totals}")
    return out


# LM serving: two published models at full width and depth, served
# through the port's ServeEngine (launch/serve.py's max_len rule)
LM_MODELS = ("qwen1.5-4b", "granite-moe-3b-a800m")
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 32
LM_LONG_PROMPT, LM_LONG_GEN = 2048, 8   # qwen only: crosses kv_chunk
LM_BF16_TOL = 5e-2
LM_SMOKE_FAMILIES = ("qwen1.5-4b", "granite-moe-3b-a800m", "gemma2-9b",
                     "mamba2-1.3b", "zamba2-1.2b")


def lm_serving_path(ctx):
    """LM serving on the card (phase 11): the model zoo's inference path
    through ``ServeEngine``.  Returns the phase's numbers; any failed check
    raises."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.models import layers, model
    from repro_torch.serve import ServeConfig, ServeEngine

    log, require, dev = ctx.log, ctx.require, ctx.dev
    t_path = time.perf_counter()
    out = {}

    def scaled_err(got, want, tol):
        """Max |got - want| within ``tol * max(1, max |want|)``.  Entries of
        magnitude 1e29 and more are the head's -1e30 masks of padded vocab
        columns: they must be equal, and they stay out of the scale."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float().to(got.device)
        require(got.shape == want.shape, (got.shape, want.shape))
        require(bool(torch.isfinite(got).all()), "non-finite logits")
        real = want.abs() < 1e29
        require(torch.equal(got[~real], want[~real]),
                "masked vocab columns differ")
        err = (got - want)[real].abs().max().item()
        scale = max(1.0, want[real].abs().max().item())
        require(err <= tol * scale, f"max |diff| {err} > {tol} * {scale}")
        return err

    def prompts_of(cfg, seq):
        return torch.from_numpy(pipeline.make_batch(pipeline.DataConfig(
            seed=0, global_batch=LM_BATCH, seq_len=seq,
            vocab_size=cfg.vocab_size), 0)["tokens"]).to(dev)

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def serve(eng, cfg, prompts, gen):
        """``eng.generate`` with CUDA events around each prefill/decode call
        (wrapping the engine's own functions) and a running finite check
        of their logits."""
        spans, finite = [], torch.ones((), dtype=torch.bool, device=dev)
        prefill_fn, decode_fn = eng.prefill_fn, eng.decode_fn

        def timed(fn):
            def run(*a, **k):
                nonlocal finite
                s, e = events()
                s.record()
                logits, cache = fn(*a, **k)
                e.record()
                spans.append((s, e))
                finite = finite & torch.isfinite(logits).all()
                return logits, cache
            return run

        eng.prefill_fn, eng.decode_fn = timed(prefill_fn), timed(decode_fn)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, meta = eng.generate(prompts, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            eng.prefill_fn, eng.decode_fn = prefill_fn, decode_fn
        ms = [s.elapsed_time(e) for s, e in spans]
        require(bool(finite), "non-finite logits while serving")
        require(tokens.shape == (LM_BATCH, gen), tokens.shape)
        require(int(tokens.min()) >= 0
                and int(tokens.max()) < cfg.vocab_size,
                "a generated token is a padded vocab column")
        dec = sorted(ms[1:])
        rec = {"prefill_ms": ms[0],
               "decode_ms_median": dec[len(dec) // 2] if dec else None,
               "generate_s": wall, "tokens_per_s": LM_BATCH * gen / wall}
        log(f"    prompt {prompts.shape[1]}, {gen} tokens: prefill "
            f"{ms[0]:.2f} ms, decode {rec['decode_ms_median']} ms a token "
            f"(median), generate {wall:.3f} s, {rec['tokens_per_s']:.1f} "
            f"tokens/s")
        return rec

    def decode_idle(eng, prompts):
        """One decode step's device time (profiler, summed kernel time)
        against its synchronised wall time (median of 5 without the
        profiler)."""
        with torch.inference_mode():
            cache = eng.fresh_cache()
            logits, cache = eng.prefill_fn(eng.params, {"tokens": prompts},
                                           cache=cache)
            tok = torch.argmax(logits, -1)[:, None]
            n = prompts.shape[1]
            walls = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.decode_fn(eng.params, tok, cache, n + i)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = sorted(walls[1:])[2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.decode_fn(eng.params, tok, cache, n + 6)
                torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if dev_ms <= 0:
            log("    decode step device time: not measured (the profiler "
                "saw no kernels)")
            return {"wall_ms": wall, "device_ms": None, "idle_share": None}
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        top = [{"kernel": e.key[:70], "calls": e.count,
                "ms": e.self_device_time_total / 1e3} for e in top]
        log(f"    decode step: device {dev_ms:.2f} ms (profiler, "
            f"{sum(e.count for e in kernels)} kernels) against wall "
            f"{wall:.2f} ms: idle share {1 - dev_ms / wall:.2f}; top "
            f"kernels {top}")
        return {"wall_ms": wall, "device_ms": dev_ms,
                "idle_share": 1 - dev_ms / wall, "top_kernels": top}

    # --- both models at full width and depth, one after the other -------
    for name in LM_MODELS:
        cfg = get_arch(name).full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _lm_leaves(params))
        gb = sum(t.numel() * t.element_size()
                 for t in _lm_leaves(params)) / 1e9
        rec = {"params_b": n_params / 1e9, "params_gb": gb,
               "init_s": time.perf_counter() - t0,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "padded_vocab": cfg.padded_vocab}
        log(f"  {name} (full, {cfg.num_layers} layers, d {cfg.d_model}): "
            f"{n_params / 1e9:.3f} B parameters, {gb:.2f} GB "
            f"({cfg.param_dtype}), init {rec['init_s']:.2f} s")

        prompts = prompts_of(cfg, LM_PROMPT)
        eng = ServeEngine(cfg, params, ServeConfig(
            batch_size=LM_BATCH, max_len=LM_PROMPT + LM_GEN + 8), device=dev)
        # check 1: bf16 prefill against forward's last position
        with torch.inference_mode():
            full_logits, _ = model.forward(params, {"tokens": prompts}, cfg)
            last = full_logits[:, -1].clone()
            del full_logits
            pre, _ = eng.prefill_fn(params, {"tokens": prompts},
                                    cache=eng.fresh_cache())
        rec["prefill_vs_forward_err"] = scaled_err(pre, last, LM_BF16_TOL)
        rec["forward_max_abs"] = last[:, :cfg.vocab_size].abs().max().item()
        require(int(torch.argmax(pre, -1).max()) < cfg.vocab_size,
                "argmax on a padded column")
        log(f"    bf16 prefill against forward: max |diff| "
            f"{rec['prefill_vs_forward_err']:.3e} (max |forward| "
            f"{rec['forward_max_abs']:.3f})")
        del pre, last
        rec["serve"] = serve(eng, cfg, prompts, LM_GEN)
        rec["decode_step"] = decode_idle(eng, prompts)
        if name == LM_MODELS[0]:
            long_prompts = prompts_of(cfg, LM_LONG_PROMPT)
            eng_long = ServeEngine(cfg, params, ServeConfig(
                batch_size=LM_BATCH,
                max_len=LM_LONG_PROMPT + LM_LONG_GEN + 8), device=dev)
            rec["serve_long"] = serve(eng_long, cfg, long_prompts,
                                      LM_LONG_GEN)
            rec["decode_step_long"] = decode_idle(eng_long, long_prompts)
            del eng_long, long_prompts
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"    peak device memory {rec['peak_gb']:.2f} GB")
        out[name] = rec
        del eng, params, prompts
        torch.cuda.empty_cache()

    # --- check 2: blockwise attention at qwen's 2,048-token shapes -------
    qcfg = get_arch(LM_MODELS[0]).full
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, h, hd = LM_BATCH, LM_LONG_PROMPT, qcfg.num_heads, \
        qcfg.resolved_head_dim
    s_cache = LM_LONG_PROMPT + LM_LONG_GEN + 8
    q = torch.randn((b, s, h, hd), generator=gen, device=dev)
    k = torch.randn((b, s_cache, qcfg.num_kv_heads, hd), generator=gen,
                    device=dev)
    v = torch.randn((b, s_cache, qcfg.num_kv_heads, hd), generator=gen,
                    device=dev)

    def plain(q, k, v, q_offset):
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        qp = q_offset + torch.arange(q.shape[1], device=dev)
        kp = torch.arange(k.shape[1], device=dev)
        logits = logits.masked_fill(kp[None, :] > qp[:, None], -float("inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)

    with torch.inference_mode():
        got = layers.blockwise_attention(
            q, k[:, :s], v[:, :s], causal=True, kv_chunk=qcfg.kv_chunk)
        attn_err = scaled_err(got, plain(q, k[:, :s], v[:, :s], 0), TOL)
        del got
        kv_len = LM_LONG_PROMPT + 3
        got = layers.blockwise_attention(
            q[:, -1:], k, v, causal=True, q_offset=kv_len - 1,
            kv_chunk=qcfg.kv_chunk, kv_len=kv_len)
        attn_dec_err = scaled_err(
            got, plain(q[:, -1:], k[:, :kv_len], v[:, :kv_len], kv_len - 1),
            TOL)
    out["attention_vs_plain"] = {"prefill_err": attn_err,
                                 "decode_err": attn_dec_err}
    log(f"  blockwise_attention (B {b}, {h} heads of {hd}, {s} tokens, "
        f"chunks of {qcfg.kv_chunk}) against plain fp32 softmax: "
        f"{attn_err:.3e}; one query at kv_len {kv_len} of {s_cache}: "
        f"{attn_dec_err:.3e}")
    del q, k, v
    torch.cuda.empty_cache()

    # --- check 3: decode against forward, teacher-forced, fp32 -----------
    forced = {}
    for name in LM_MODELS:
        cfg = dataclasses.replace(get_arch(name).full, num_layers=2,
                                  compute_dtype=torch.float32)
        if cfg.moe_num_experts:  # as the reference's decode test
            cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
        params = model.init_params(
            cfg, torch.Generator(device=dev).manual_seed(2), dev)
        n_pre, n_dec = 16, 6
        seq = torch.from_numpy(pipeline.make_batch(pipeline.DataConfig(
            seed=0, global_batch=2, seq_len=n_pre + n_dec,
            vocab_size=cfg.vocab_size), 0)["tokens"]).to(dev)
        with torch.inference_mode():
            ref, _ = model.forward(params, {"tokens": seq}, cfg)
            cache = model.init_cache(cfg, 2, n_pre + n_dec + 8, device=dev)
            lp, cache = model.prefill(params, {"tokens": seq[:, :n_pre]},
                                      cfg, cache)
            errs = [scaled_err(lp, ref[:, n_pre - 1], TOL)]
            for i in range(n_dec - 1):
                ld, cache = model.decode_step(
                    params, seq[:, n_pre + i:n_pre + i + 1], cache,
                    n_pre + i, cfg)
                errs.append(scaled_err(ld, ref[:, n_pre + i], TOL))
            eng = ServeEngine(cfg, params, ServeConfig(batch_size=2,
                                                       max_len=48),
                              device=dev)
            toks, _ = eng.generate(seq[:, :8], 6)
            cur = seq[:, :8]
            for i in range(6):
                logits, _ = model.forward(params, {"tokens": cur}, cfg)
                nxt = torch.argmax(logits[:, -1], -1)
                require(torch.equal(nxt.to(torch.int32), toks[:, i]),
                        f"{name}: greedy generate differs from greedy "
                        f"forward at token {i}")
                cur = torch.cat([cur, nxt[:, None]], dim=1)
        forced[name] = {"max_err": max(errs), "steps": len(errs)}
        log(f"  {name} (2 layers, full width, fp32): prefill and "
            f"{n_dec - 1} decode steps against forward, max |diff| "
            f"{max(errs):.3e}; greedy generate equals greedy forward")
        del params, ref, cache, eng
        torch.cuda.empty_cache()
    out["decode_vs_forward"] = forced

    # --- check 4: every family on the card against the CPU ---------------
    families = {}
    for name in LM_SMOKE_FAMILIES:
        cfg = dataclasses.replace(get_arch(name).smoke,
                                  compute_dtype=torch.float32)
        if cfg.moe_num_experts:
            cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
        tree = _lm_tree_numpy(model.init_params(
            cfg, torch.Generator().manual_seed(3), "cpu"))
        batch = {"tokens": pipeline.make_batch(pipeline.DataConfig(
            seed=0, global_batch=2, seq_len=24,
            vocab_size=cfg.vocab_size), 0)["tokens"]}
        res = {}
        for where in ("cpu", "cuda"):
            p = lm_params_from_arrays(tree, cfg, device=where)
            tb = {"tokens": torch.from_numpy(batch["tokens"]).to(where)}
            with torch.inference_mode():
                fl, _ = model.forward(p, tb, cfg)
                cache = model.init_cache(cfg, 2, 40, device=where)
                lp, cache = model.prefill(p, tb, cfg, cache)
                tok = torch.argmax(lp, -1)[:, None]
                steps = []
                for i in range(4):
                    ld, cache = model.decode_step(p, tok, cache, 24 + i, cfg)
                    steps.append(ld)
                    tok = torch.argmax(ld, -1)[:, None]
            res[where] = (fl, lp, steps)
        cpu, gpu = res["cpu"], res["cuda"]
        err = max([scaled_err(gpu[0], cpu[0], TOL),
                   scaled_err(gpu[1], cpu[1], TOL)]
                  + [scaled_err(g, c, TOL) for g, c in zip(gpu[2], cpu[2])])
        families[name] = {"family": cfg.family, "max_err": err}
        log(f"  {name} smoke ({cfg.family}, fp32): card against CPU, "
            f"forward, prefill and 4 decode steps, max |diff| {err:.3e}")
    out["card_vs_cpu"] = families
    out["wall_s"] = time.perf_counter() - t_path
    log(f"  LM serving path wall time: {out['wall_s']:.1f} s")
    return out


# LM training: the two served models at full width and depth, trained
# through the port's TrainController with launch/train.py's optimizer
LM_TRAIN_STEPS = 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 8, 128, 2
LM_TRAIN_FAMILIES = ("qwen1.5-4b", "granite-moe-3b-a800m", "mamba2-1.3b",
                     "zamba2-1.2b", "phi-3-vision-4.2b")
LM_REMAT_LAYERS = 4
LM_UPDATE_TOL = 1e-6


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic kernels inside the block (``warn_only``: cuBLAS needs
    an environment setting to promise it, and its GEMMs are deterministic
    on one stream anyway): the embedding's and the MoE gather's backward
    otherwise add with atomics, in an order that varies run to run."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def lm_training_path(ctx, split_compare=False):
    """LM training on the card (phase 12): the train step, the optimizer
    and the controller at full size, then the checks.  With
    ``split_compare`` (``bench_torch/lm_training_probe.py``), one forward
    and backward of qwen at full size with the stacked leaves split by
    ``torch.unbind`` and by indexing each group, under the profiler.
    Returns the phase's numbers; any failed check raises."""
    import dataclasses
    import gc
    import tempfile
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.examples import lm_training
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.models import model
    from repro_torch.train import controller, optimizer as opt_lib
    from repro_torch.train import train_loop

    log, require, dev = ctx.log, ctx.require, ctx.dev
    t_path = time.perf_counter()
    out = {}

    def scaled_err(got, want, tol):
        got, want = got.float(), want.float().to(got.device)
        require(got.shape == want.shape, (got.shape, want.shape))
        require(bool(torch.isfinite(got).all()), "non-finite values")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        scale = max(1.0, want.abs().max().item() if want.numel() else 0.0)
        require(err <= tol * scale, f"max |diff| {err} > {tol} * {scale}")
        return err

    def data_cfg(cfg, batch, seq):
        return pipeline.DataConfig(
            seed=0, global_batch=batch, seq_len=seq,
            vocab_size=cfg.vocab_size, frontend=cfg.frontend,
            frontend_dim=cfg.frontend_dim, num_patches=cfg.num_patches)

    def train_cfg(steps, micro):
        # launch/train.py's optimizer for --steps
        return train_loop.TrainConfig(
            optimizer=opt_lib.OptimizerConfig(
                lr=3e-4, warmup_steps=min(20, steps // 4),
                total_steps=steps),
            num_microbatches=micro)

    def step_profile(step_fn, wall_ms):
        """One step's device time by kernel (profiler, device activity
        only: a step's tens of thousands of host ops would take the
        profiler longer to sort than the step takes) against the
        controller's median step wall time."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if dev_ms <= 0:
            log("    step device time by kernel: not measured (the profiler "
                "saw no kernels)")
            return {"device_ms": None, "idle_share": None}
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        top = [{"kernel": e.key[:70], "calls": e.count,
                "ms": e.self_device_time_total / 1e3} for e in top]
        n = sum(e.count for e in kernels)
        log(f"    one step under the profiler: {dev_ms:.1f} ms of device "
            f"time in {n} kernels against the steps' median wall "
            f"{wall_ms:.1f} ms: idle share {1 - dev_ms / wall_ms:.3f}")
        for t in top:
            log(f"      {t['ms']:9.2f} ms {t['calls']:6d} x {t['kernel']}")
        return {"device_ms": dev_ms, "kernels": n,
                "idle_share": 1 - dev_ms / wall_ms, "top_kernels": top}

    # --- both models at full width and depth, one after the other -------
    for name in LM_MODELS:
        cfg = get_arch(name).full
        gc.collect()      # qwen's step peaks near 79 GB of the card's 85
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tcfg = train_cfg(LM_TRAIN_STEPS, LM_TRAIN_MICRO)
        t0 = time.perf_counter()
        params, opt = train_loop.init_train_state(
            cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        leaves = opt_lib.tree_leaves(params)
        n_params = sum(t.numel() for t in leaves)
        state_gb = 4 * n_params * 4 / 1e9   # params, grads, m, v in fp32
        rec = {"params_b": n_params / 1e9, "state_gb": state_gb,
               "init_s": time.perf_counter() - t0,
               "layers": cfg.num_layers, "d_model": cfg.d_model,
               "remat": cfg.remat}
        log(f"  {name} (full, {cfg.num_layers} layers, d {cfg.d_model}, "
            f"remat {cfg.remat}, {cfg.compute_dtype} compute): "
            f"{n_params / 1e9:.3f} B parameters; params, grads and fp32 "
            f"moments {state_gb:.1f} GB; init {rec['init_s']:.2f} s")
        step_fn = train_loop.make_train_step(cfg, tcfg)
        spans, metrics = [], []

        def timed_step(p, o, b):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            res = step_fn(p, o, b)
            e.record()
            spans.append((s, e))
            metrics.append(res[-1])
            return res

        dcfg = data_cfg(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
        with tempfile.TemporaryDirectory() as ckpt:
            ctl = controller.TrainController(
                timed_step, lambda s: pipeline.make_batch(dcfg, s),
                controller.ControllerConfig(
                    ckpt_dir=ckpt, save_every=LM_TRAIN_STEPS + 1))
            params, opt, steps = ctl.run(params, opt, LM_TRAIN_STEPS)
            require(not os.listdir(ckpt), "a checkpoint was written")
        torch.cuda.synchronize()
        dev_ms = [s.elapsed_time(e) for s, e in spans]
        wall_ms = [entry["dt"] * 1e3 for entry in steps]
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        # check 1: every loss and grad norm finite
        require(len(losses) == LM_TRAIN_STEPS
                and all(np.isfinite(losses + norms)), (losses, norms))
        warm = sorted(wall_ms[1:])[len(wall_ms[1:]) // 2]
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        rec.update({
            "step_wall_ms": wall_ms, "step_device_ms": dev_ms,
            "tokens_per_s": [tokens / (w / 1e3) for w in wall_ms],
            "loss": losses, "grad_norm": norms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        for i in range(LM_TRAIN_STEPS):
            log(f"    step {i}: wall {wall_ms[i]:.1f} ms, device "
                f"{dev_ms[i]:.1f} ms (events), {tokens / wall_ms[i] * 1e3:.0f}"
                f" tokens/s; loss {losses[i]:.4f}, grad_norm {norms[i]:.4f}")
        log(f"    peak device memory {rec['peak_gb']:.2f} GB")
        batch = pipeline.make_batch(dcfg, LM_TRAIN_STEPS)
        rec["profile"] = step_profile(lambda: step_fn(params, opt, batch),
                                      warm)
        out[name] = rec
        del params, opt, leaves, metrics, spans, ctl, step_fn
        torch.cuda.empty_cache()

    # --- the stacked leaves split by unbind against by indexing ---------
    if split_compare:
        out["split"] = split_comparison(ctx)

    # --- check 2: remat full and none give the same gradients -----------
    cfg = dataclasses.replace(get_arch(LM_MODELS[0]).full,
                              num_layers=LM_REMAT_LAYERS)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                               dev)
    leaves = opt_lib.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = pipeline.make_batch(data_cfg(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                0)
    grads = {}
    with deterministic_algorithms(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for remat in ("full", "none"):
            c = dataclasses.replace(cfg, remat=remat)
            torch.cuda.reset_peak_memory_stats()
            loss, _ = model.loss_fn(params, batch, c)
            grads[remat] = (loss.detach(),
                            torch.autograd.grad(loss, leaves))
            grads[remat + "_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del loss
    same = torch.equal(grads["full"][0], grads["none"][0]) and all(
        torch.equal(a, b) for a, b in zip(grads["full"][1], grads["none"][1]))
    require(same, "remat='full' and 'none' gradients differ")
    out["remat_check"] = {"layers": LM_REMAT_LAYERS, "bit_equal": same,
                          "peak_gb_full": grads["full_peak_gb"],
                          "peak_gb_none": grads["none_peak_gb"]}
    log(f"  {LM_MODELS[0]} at full width, {LM_REMAT_LAYERS} layers: "
        f"remat 'full' and 'none' give the same loss and {len(leaves)} "
        f"gradients bit for bit (deterministic kernels); peak "
        f"{grads['full_peak_gb']:.2f} GB against "
        f"{grads['none_peak_gb']:.2f} GB")
    del params, leaves, grads
    torch.cuda.empty_cache()

    # --- check 3: five families, one step on the card against the CPU --
    families = {}
    for name in LM_TRAIN_FAMILIES:
        cfg = dataclasses.replace(get_arch(name).smoke,
                                  compute_dtype=torch.float32)
        tree = _lm_tree_numpy(model.init_params(
            cfg, torch.Generator().manual_seed(3), "cpu"))
        batch = pipeline.make_batch(data_cfg(cfg, 2, 24), 0)
        res = {}
        for where in ("cpu", dev):
            p = lm_params_from_arrays(tree, cfg, device=where)
            leaves = opt_lib.tree_leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = model.loss_fn(p, batch, cfg)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            res["cpu" if where == "cpu" else "card"] = (loss.detach(), [
                x if x is not None else torch.zeros_like(t)
                for x, t in zip(g, leaves)], p)
        (lc, gc, pc), (lg, gg, pg) = res["cpu"], res["card"]
        err_loss = scaled_err(lg.reshape(1), lc.reshape(1), TOL)
        err_grad = max(scaled_err(a, b, TOL) for a, b in zip(gg, gc))
        # apply_updates on each device, given the CPU's gradients twice
        ocfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10)
        states = {}
        for where, p in (("cpu", pc), ("card", pg)):
            st = opt_lib.init_opt_state(p, ocfg)
            flat = {id(t): x.to(t.device) for t, x in
                    zip(opt_lib.tree_leaves(p), gc)}
            grads = opt_lib.tree_map(lambda t: flat[id(t)], p)
            for _ in range(2):
                p, st, _ = opt_lib.apply_updates(p, grads, st, ocfg)
            states[where] = opt_lib.tree_leaves((p, st.m, st.v))
        err_upd = max(scaled_err(a.detach(), b.detach(), LM_UPDATE_TOL)
                      for a, b in zip(states["card"], states["cpu"]))
        families[name] = {"family": cfg.family, "loss_err": err_loss,
                          "grad_err": err_grad, "update_err": err_upd}
        log(f"  {name} smoke ({cfg.family}, fp32): card against CPU, loss "
            f"{err_loss:.3e}, gradients {err_grad:.3e} (tolerance {TOL}); "
            f"two apply_updates {err_upd:.3e} (tolerance {LM_UPDATE_TOL})")
    out["card_vs_cpu"] = families

    # --- check 4: the restart drill on qwen's smoke config --------------
    cfg = dataclasses.replace(get_arch(LM_MODELS[0]).smoke,
                              compute_dtype=torch.float32)
    tcfg = train_cfg(10, 1)
    dcfg = data_cfg(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    finals = {}
    with deterministic_algorithms(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, fail in (("uninterrupted", None), ("restarted", 6)):
            params, opt = train_loop.init_train_state(
                cfg, tcfg, torch.Generator(device=dev).manual_seed(0), dev)
            with tempfile.TemporaryDirectory() as ckpt:
                ctl = controller.TrainController(
                    train_loop.make_train_step(cfg, tcfg),
                    lambda s: pipeline.make_batch(dcfg, s),
                    controller.ControllerConfig(ckpt_dir=ckpt, save_every=5))
                params, opt, steps = ctl.run(
                    params, opt, 10, failure_at=None if fail is None else
                    (lambda s, c=ctl: s == fail and not c.restart_events))
            finals[label] = (opt_lib.tree_leaves((params, opt)),
                             ctl.restart_events, len(steps))
    (a, ra, na), (b, rb, nb) = finals["uninterrupted"], finals["restarted"]
    require(ra == [] and rb == [6] and nb == na + 1, (ra, rb, na, nb))
    same = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    require(same, "the restarted run's state differs from the "
            "uninterrupted run's")
    out["restart_drill"] = {"restarts": rb, "steps_logged": nb,
                            "bit_equal": same}
    log(f"  restart drill ({LM_MODELS[0]} smoke, save every 5, failure at "
        f"step 6, 10 steps): restarted at {rb}, {nb} steps logged; params, "
        f"moments and step equal the uninterrupted run's bit for bit")
    del finals, a, b

    # --- check 5: the example at its defaults on the card ---------------
    t0 = time.perf_counter()
    example = lm_training.main(["--device", "cuda"])
    out["example"] = {"steps_logged": len(example),
                      "loss_first": example[0]["loss"],
                      "loss_last": example[-1]["loss"],
                      "wall_s": time.perf_counter() - t0}
    log(f"  examples/lm_training.py at its defaults: loss "
        f"{example[0]['loss']:.3f} -> {example[-1]['loss']:.3f} over "
        f"{len(example)} logged steps, {out['example']['wall_s']:.1f} s")
    # --- check 6: the shard_map MoE on a 2 x 2 mesh of the card ---------
    out["shard_map_moe"] = shard_map_moe_check(ctx, scaled_err, data_cfg)

    # --- check 7: launch.train with gradient compression ----------------
    out["compression"] = compression_check(ctx, scaled_err)
    out["wall_s"] = time.perf_counter() - t_path
    log(f"  LM training path wall time: {out['wall_s']:.1f} s")
    return out


# the shard_map MoE's mesh in phase 12 (data x model, every shard on the
# card) and its smoke batch
LM_MOE_MESH = (2, 2)
LM_MOE_BATCH, LM_MOE_SEQ = 4, 24


def shard_map_moe_check(ctx, scaled_err, data_cfg):
    """granite-moe's smoke config (fp32) with ``moe_impl="shard_map"``
    on a 2 x 2 mesh of ``cuda:0`` (the one-process loop over the shards,
    each weight gathered over FSDP), its loss and gradients against the
    same on a 2 x 2 mesh of the CPU, from the same params and batch,
    within ``TOL``.  Returns the errors; raises on a failure."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.mesh import make_mesh, use_mesh
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_lib

    log, dev = ctx.log, ctx.dev
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").smoke,
                              compute_dtype=torch.float32,
                              moe_impl="shard_map")
    tree = _lm_tree_numpy(model.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"))
    batch = pipeline.make_batch(data_cfg(cfg, LM_MOE_BATCH, LM_MOE_SEQ), 0)
    n = LM_MOE_MESH[0] * LM_MOE_MESH[1]
    res = {}
    for where in ("cpu", dev):
        p = lm_params_from_arrays(tree, cfg, device=where)
        leaves = opt_lib.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        mesh = make_mesh(LM_MOE_MESH, devices=[where] * n)
        with shd.use_rules(shd.AxisRules()), use_mesh(mesh):
            loss, _ = model.loss_fn(p, batch, cfg)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[where] = (loss.detach(), [x if x is not None else
                                      torch.zeros_like(t)
                                      for x, t in zip(g, leaves)])
    (lc, gc), (lg, gg) = res["cpu"], res[dev]
    err_loss = scaled_err(lg.reshape(1), lc.reshape(1), TOL)
    err_grad = max(scaled_err(a, b, TOL) for a, b in zip(gg, gc))
    log(f"  granite-moe-3b-a800m smoke (fp32) with the shard_map MoE on a "
        f"{LM_MOE_MESH[0]} x {LM_MOE_MESH[1]} mesh of {dev} against a CPU "
        f"mesh: loss {float(lg):.6f}, |diff| {err_loss:.3e}; {len(gg)} "
        f"gradients {err_grad:.3e} (tolerance {TOL})")
    return {"mesh": list(LM_MOE_MESH), "loss": float(lg),
            "loss_err": err_loss, "grad_err": err_grad}


LM_COMPRESSION_STEPS = 2


def compression_check(ctx, scaled_err):
    """``python -m repro_torch.launch.train --arch qwen1.5-4b --smoke
    --grad-compression`` for two steps on the card and on the CPU, the
    params drawn on the CPU for both (``--init-device cpu``): the second
    step's loss reads the first step's compressed update; both losses
    within ``TOL``.  Returns the numbers; raises on a failure."""
    import tempfile

    import torch

    from repro_torch.launch import train as launch_train

    log, dev = ctx.log, ctx.dev
    logs = {}
    for where in ("cpu", dev):
        with tempfile.TemporaryDirectory() as ckpt:
            logs[where] = launch_train.main([
                "--arch", LM_MODELS[0], "--smoke", "--steps",
                str(LM_COMPRESSION_STEPS), "--grad-compression",
                "--device", str(where), "--init-device", "cpu", "--ckpt-dir",
                ckpt, "--save-every", str(LM_COMPRESSION_STEPS + 1)])
    card = torch.tensor([e["loss"] for e in logs[dev]])
    cpu = torch.tensor([e["loss"] for e in logs["cpu"]])
    err = scaled_err(card, cpu, TOL)
    log(f"  launch.train --grad-compression ({LM_MODELS[0]} smoke, "
        f"{LM_COMPRESSION_STEPS} steps) on {dev}: losses "
        f"{[round(float(x), 6) for x in card]} against the CPU's "
        f"{[round(float(x), 6) for x in cpu]}: |diff| {err:.3e} "
        f"(tolerance {TOL})")
    return {"steps": LM_COMPRESSION_STEPS, "loss_card": card.tolist(),
            "loss_cpu": cpu.tolist(), "loss_err": err}


def split_comparison(ctx):
    """One forward and backward of qwen at full size (batch 8 x 128, remat
    full), the stacked leaves split per call by ``torch.unbind`` (the
    port's) and by indexing each leaf ``a[g]`` per group (before): device
    time by kernel (profiler), wall time and peak memory of each, and the
    gradients equal."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline
    from repro_torch.models import model, transformer
    from repro_torch.train import optimizer as opt_lib

    log, require, dev = ctx.log, ctx.require, ctx.dev
    cfg = get_arch(LM_MODELS[0]).full
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
    leaves = opt_lib.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = pipeline.make_batch(pipeline.DataConfig(
        seed=0, global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
        vocab_size=cfg.vocab_size), 0)
    unbind = transformer.split_groups

    def indexed(tree, n_groups):
        return [transformer.tree_map(lambda a: a[g], tree)
                for g in range(n_groups)]

    def fwd_bwd():
        loss, _ = model.loss_fn(params, batch, cfg)
        loss.backward()

    res = {}
    try:
        for label, split in (("unbind", unbind), ("index", indexed),
                             ("unbind_again", unbind)):
            transformer.split_groups = split
            for p in leaves:
                p.grad = None
            fwd_bwd()      # warm
            for p in leaves:
                p.grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fwd_bwd()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            grads = [p.grad.clone() for p in leaves[:4]]
            for p in leaves:
                p.grad = None
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fwd_bwd()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
            res[label] = {
                "wall_ms": wall, "device_ms": dev_ms, "peak_gb": peak,
                "top_kernels": [{"kernel": e.key[:70], "calls": e.count,
                                 "ms": e.self_device_time_total / 1e3}
                                for e in top]}
            res[label + "_grads"] = grads
            log(f"  split by {label}: forward + backward wall {wall:.1f} ms,"
                f" device {dev_ms:.1f} ms (profiler), peak {peak:.2f} GB; "
                f"top kernels {res[label]['top_kernels']}")
    finally:
        transformer.split_groups = unbind
    for a, b in zip(res.pop("unbind_grads"), res.pop("index_grads")):
        require(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)),
                "the gradients differ between the two splits")
    res.pop("unbind_again_grads")
    for p in leaves:
        p.grad = None
    del params, leaves
    torch.cuda.empty_cache()
    return res


# the dry run against the card: qwen1.5-4b's train cell on a 1 x 1 mesh at
# phase 12's size (8 x 128 tokens, 2 microbatches, remat full; the cell's
# bf16 moments), through launch.specs.build_cell's overrides
DRYRUN_ARCH = "qwen1.5-4b"
DRYRUN_OVERRIDES = {"global_batch": LM_TRAIN_BATCH, "seq_len": LM_TRAIN_SEQ,
                    "num_microbatches": LM_TRAIN_MICRO}
DRYRUN_PEAK_TOL = 0.05


def dryrun_path(ctx):
    """The dry run against the card (phase 13): ``launch.dryrun.run_cell``
    on the ``meta`` device for qwen1.5-4b's train cell on a 1 x 1 mesh,
    then one step of the same cell (its ``fn``) on the card, from random
    params, under ``FlopCounterMode`` with the peak memory reset first,
    and one more step under the profiler.  Checks: the card's FLOP count
    equals the dry run's traced count (``FlopCounterMode`` applies the
    same shape formulas to the same ops on ``meta`` and on the card, so
    this checks that both ran the same op sequence, not the count
    itself); ``argument_bytes`` equals the
    summed ``nbytes`` of the params, optimizer state and batch on the
    card; ``argument_bytes + temp_bytes`` is within 5 % of the step's
    peak (``max_memory_allocated`` less what earlier phases hold).
    Prints the dry run's roofline bound beside the step's device time.
    Returns the phase's numbers; any failed check raises."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh

    log, require = ctx.log, ctx.require
    t_path = time.perf_counter()
    overrides = dict(DRYRUN_OVERRIDES)
    mesh = make_debug_mesh(1, 1)

    # --- the dry run, on meta ---------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        rec = dryrun.run_cell(DRYRUN_ARCH, "train_4k", False, out_dir,
                              overrides=dict(overrides), mesh=mesh)
    dry_s = time.perf_counter() - t0
    require(rec["status"] == "ok", rec.get("traceback", rec))
    mem, rl, traced = rec["memory"], rec["roofline"], rec["traced"]
    log(f"  dry run of {DRYRUN_ARCH} train_4k on a 1 x 1 mesh "
        f"({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, {LM_TRAIN_MICRO} microbatches, "
        f"remat full, bf16 moments): {dry_s:.1f} s on the host (trace "
        f"{rec['t_trace_s']} s); traced {traced['flops']:.6e} FLOPs, "
        f"{traced['bytes']:.6e} bytes; argument {mem['argument_bytes']} B, "
        f"temp {mem['temp_bytes']} B; roofline compute {rl['compute_s']:.4f}"
        f" s, memory {rl['memory_s']:.4f} s, bound {rl['bound_s']:.4f} s "
        f"({rl['dominant']})")

    # --- the same cell on the card --------------------------------------
    cell = specs.build_cell(get_arch(DRYRUN_ARCH), "train_4k", mesh,
                            overrides=dict(overrides), analysis_mode=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    out = _dryrun_on_card(ctx, rec, cell, held, t_path, dry_s)
    out["partitioned"] = dryrun_partitioned_on_card(ctx)
    out["partitioned_moe"] = dryrun_partitioned_on_card(
        ctx, DRYRUN_MOE_ARCH, DRYRUN_MOE_MESH)
    out["wall_s"] = time.perf_counter() - t_path
    log(f"  dry-run path wall time: {out['wall_s']:.1f} s")
    return out


# the partitioned checks of phase 13: the same cell on a (data, model)
# mesh, rank 0 of it on the card under a fake process group; then
# granite-moe's (the dense MoE) on a 2 x 1 mesh, so that its dispatch is
# split along d over data
DRYRUN_PART_MESH = (1, 2)
DRYRUN_MOE_ARCH = "granite-moe-3b-a800m"
DRYRUN_MOE_MESH = (2, 1)


def _card_place(tree, shardings, dmesh, gen, dev, vocab):
    """``tree``'s ``meta`` tensors as DTensors over ``dmesh`` whose local
    blocks are on the card at their ``NamedSharding.shard_shape``:
    params random, moments and the step count 0, tokens random ids."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd

    def one(t, ns, role):
        shape = ns.shard_shape(tuple(t.shape))
        if role == "param":
            local = (torch.randn(shape, generator=gen, device=dev)
                     * 0.02).to(t.dtype)
        elif t.is_floating_point() or role == "step":
            local = torch.zeros(shape, dtype=t.dtype, device=dev)
        else:
            local = torch.randint(0, vocab, shape, generator=gen,
                                  dtype=t.dtype, device=dev)
        out = DTensor.from_local(local, dmesh,
                                 shd.placements(ns.spec, dmesh, t.ndim),
                                 run_check=False, shape=t.shape,
                                 stride=t.stride())
        return out.requires_grad_(True) if role == "param" else out

    def walk(t, ns, role):
        if isinstance(t, dict):
            return {k: walk(t[k], ns[k], role) for k in t}
        if isinstance(t, tuple) and hasattr(type(t), "_fields"):
            return type(t)(*[walk(getattr(t, f), getattr(ns, f),
                                  "step" if f == "step" else role)
                             for f in type(t)._fields])
        return one(t, ns, role)

    params, opt, batch = tree
    ps, os_, bs = shardings
    return (walk(params, ps, "param"), walk(opt, os_, "moment"),
            walk(batch, bs, "batch"))


def dryrun_partitioned_on_card(ctx, arch=DRYRUN_ARCH,
                                mesh_shape=DRYRUN_PART_MESH):
    """Rank 0 of ``arch``'s train cell at phase 12's size (full width and
    depth) on a ``mesh_shape`` (data x model) mesh: qwen1.5-4b's on 1 x 2,
    and granite-moe's on 2 x 1, where the dense MoE's capacity slots,
    expert outputs and token rows are split along d over data.  The dry
    run on ``meta`` (``run_cell``, a partitioned program over a ``fake``
    group), then one step of the same
    partitioned program on ``cuda:0`` under a ``fake`` process group of 2
    ranks, its local blocks random on the card, with the peak reset
    first.  The collectives do no work, so the values are not checked
    (``tests/test_torch_partitioned.py`` holds them on the CPU).  Checks:
    the card's FLOP count of the local ops equals the dry run's per-device
    count; the state's local ``nbytes`` equal ``argument_bytes``; the
    peak is within 5 % of ``argument_bytes + temp_bytes``."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, specs, step_analysis
    from repro_torch.launch.mesh import fake_dtensor_mesh, make_debug_mesh
    from repro_torch.train import optimizer as opt_lib

    log, require, dev = ctx.log, ctx.require, ctx.dev
    mesh = make_debug_mesh(*mesh_shape)
    overrides = dict(DRYRUN_OVERRIDES)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        rec = dryrun.run_cell(arch, "train_4k", False, out_dir,
                              overrides=dict(overrides), mesh=mesh)
    dry_s = time.perf_counter() - t0
    require(rec["status"] == "ok", rec.get("traceback", rec))
    require(rec["partitioned"] is True, rec)
    mem, traced = rec["memory"], rec["traced"]
    log(f"  dry run of {arch} train_4k ({overrides}) on a {mesh_shape[0]}"
        f" x {mesh_shape[1]} (data x model) mesh, partitioned: "
        f"{dry_s:.1f} s; per device {traced['flops']:.6e} FLOPs, argument "
        f"{mem['argument_bytes']} B, temp {mem['temp_bytes']} B; "
        f"collectives {rec['collective_schedule']}")

    cell = specs.build_cell(get_arch(arch), "train_4k", mesh,
                            overrides=dict(overrides), analysis_mode=False)
    dmesh = fake_dtensor_mesh(mesh, torch.device(dev).type)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    args = _card_place(cell.args, cell.in_shardings, dmesh, gen, dev,
                       cell.cfg.vocab_size)
    fn = specs._in_context(cell.fn.__wrapped__, cell.rules, cell.mesh,
                           dmesh)
    state_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in opt_lib.tree_leaves(args))
    require(state_bytes == mem["argument_bytes"],
            (state_bytes, mem["argument_bytes"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    count = step_analysis.count_step(fn, *args, memory=False)
    e.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    reckoned = mem["argument_bytes"] + mem["temp_bytes"]
    rel = abs(reckoned - peak) / peak
    log(f"  rank 0's step on the card under a fake group of "
        f"{mesh_shape[0] * mesh_shape[1]} (events "
        f"{s.elapsed_time(e):.1f} ms, counted): {count.flops:.6e} FLOPs "
        f"against the dry run's {traced['flops']:.6e} (probed "
        f"{rec['cost']['flops_per_device']:.6e}); state {state_bytes} B; "
        f"peak {peak} B ({held} B held before) against argument + temp "
        f"{reckoned} B: {100 * rel:.3f} % apart; collectives "
        f"{count.collectives}")
    require(count.flops == traced["flops"], (count.flops, traced["flops"]))
    require(count.collectives == traced["collectives"],
            (count.collectives, traced["collectives"]))
    require(rel <= DRYRUN_PEAK_TOL, (reckoned, peak, rel))
    out = {"arch": arch, "mesh": list(mesh_shape), "overrides": overrides,
           "dryrun_s": dry_s,
           "traced_flops": traced["flops"], "card_flops": count.flops,
           "argument_bytes": mem["argument_bytes"],
           "state_bytes": state_bytes, "temp_bytes": mem["temp_bytes"],
           "reckoned_peak_bytes": reckoned, "card_peak_bytes": peak,
           "held_bytes": held, "peak_rel_diff": rel,
           "step_event_ms": s.elapsed_time(e),
           "collectives": count.collectives}
    del args, fn, cell
    gc.collect()
    torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.destroy_process_group()
    return out


def _dryrun_on_card(ctx, rec, cell, held, t_path, dry_s):
    """Phase 13's card half: one step of ``cell`` from random params under
    ``FlopCounterMode``, one under the profiler, the checks and the
    phase's numbers."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_lib

    log, require, dev = ctx.log, ctx.require, ctx.dev
    cfg = cell.cfg
    mem, rl, traced = rec["memory"], rec["roofline"], rec["traced"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(cfg, gen, dev)
    for p in opt_lib.tree_leaves(params):
        p.requires_grad_(True)
    _, opt_struct, batch_struct = cell.args
    opt = opt_lib.OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=opt_lib.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                 device=dev), opt_struct.m),
        v=opt_lib.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                 device=dev), opt_struct.v))
    batch = {k: torch.randint(0, cfg.vocab_size, t.shape, dtype=t.dtype,
                              device=dev, generator=gen)
             for k, t in batch_struct.items()}
    state_bytes = sum(t.numel() * t.element_size() for t in
                      opt_lib.tree_leaves((params, opt, batch)))
    require(state_bytes == mem["argument_bytes"],
            (state_bytes, mem["argument_bytes"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        *_, metrics = cell.fn(params, opt, batch)
        e.record()
        torch.cuda.synchronize()
    card_flops = counter.get_total_flops()
    peak = torch.cuda.max_memory_allocated() - held
    step_ms = s.elapsed_time(e)
    require(bool(torch.isfinite(metrics["loss"])), metrics)
    reckoned = mem["argument_bytes"] + mem["temp_bytes"]
    rel = abs(reckoned - peak) / peak
    log(f"  one step on the card (events {step_ms:.1f} ms, under the FLOP "
        f"counter): {card_flops:.6e} FLOPs against the dry run's traced "
        f"{traced['flops']:.6e} and probed {rec['cost']['flops_per_device']:.6e};"
        f" peak {peak} B ({peak / 1e9:.3f} GB, {held} B held before) against"
        f" argument + temp {reckoned} B ({reckoned / 1e9:.3f} GB): "
        f"{100 * rel:.3f} % apart; loss {float(metrics['loss']):.4f}")
    require(card_flops == traced["flops"], (card_flops, traced["flops"]))
    require(rel <= DRYRUN_PEAK_TOL, (reckoned, peak, rel))

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cell.fn(params, opt, batch)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    share = rl["bound_s"] * 1e3 / dev_ms if dev_ms > 0 else None
    log(f"  the step's device time {dev_ms:.1f} ms (profiler, "
        f"{sum(ev.count for ev in kernels)} kernels) against the dry run's "
        f"H100 bound {rl['bound_s'] * 1e3:.1f} ms: the step runs at "
        f"{share if share is None else round(share, 4)} of its bound")
    out = {"arch": DRYRUN_ARCH, "dryrun_s": dry_s,
           "t_trace_s": rec["t_trace_s"], "traced_flops": traced["flops"],
           "probed_flops": rec["cost"]["flops_per_device"],
           "card_flops": card_flops, "traced_bytes": traced["bytes"],
           "argument_bytes": mem["argument_bytes"],
           "state_bytes": state_bytes, "temp_bytes": mem["temp_bytes"],
           "reckoned_peak_bytes": reckoned, "card_peak_bytes": peak,
           "held_bytes": held, "peak_rel_diff": rel,
           "step_event_ms": step_ms, "step_device_ms": dev_ms,
           "roofline": rl, "bound_share": share,
           "model_flops_total": rec["model_flops_total"]}
    del params, opt, batch, metrics, cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lm_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _lm_leaves(v)
    else:
        yield tree


def _lm_tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _lm_tree_numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    import repro_torch.sparse as sp
    from repro_torch.core import cost_model
    from repro_torch.core.formats import pack_bitmap_tiles_torch, pack_nm_tiles
    from repro_torch.core.plan_ir import (
        bucket_fringe_kblocks, build_sddmm_maps, gather_rows, permute_pad_b,
    )
    from repro_torch.data.graphs import PAPER_DATASETS, GraphSpec, generate
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.dense_tile_spmm import (
        dense_tile_spmm, window_chunks, window_segments,
    )
    from repro_torch.kernels.gather_spmm import (
        csr_indptr, fringe_profile, gather_spmm, gather_spmm_ksharded,
        kbucket_row_order,
    )
    from repro_torch.kernels.sddmm import (
        SLICE_COLS, dense_tile_sddmm, gather_sddmm, sampled_index,
    )
    from repro_torch.kernels.structured_spmm import (
        bitmap_tile_spmm, nm_tile_spmm,
    )
    from repro_torch.models import SparseGraphAttention

    from bench_torch.gather_sweep import gather_probe

    dev = torch.device("cuda")

    # --- phase 1: device ----------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}"
        f" numpy {np.__version__}")
    log(smi)

    phase_s, t_phase = {}, [time.perf_counter()]

    def phase_done(name):
        """Wall seconds since the previous phase ended, under ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    helpers = standalone_context()
    drive, err_bound, timed_ms = (helpers.drive, helpers.err_bound,
                                  helpers.timed_ms)
    measure, csr_of = helpers.measure, helpers.csr_of

    gen = torch.Generator(device=dev).manual_seed(0)

    def operand(k, n, batch=None):
        shape = (k, n) if batch is None else (batch, k, n)
        return torch.randn(shape, generator=gen, device=dev)

    def sparse_tiles(t, density, bm=128, bk=64):
        """(t, bm, bk) seeded fp32 tiles, tile i dense at
        density[i % len(density)]."""
        dens = torch.tensor(density, device=dev).repeat(
            -(-t // len(density)))[:t, None, None]
        vals = torch.randn((t, bm, bk), generator=gen, device=dev)
        keep = torch.rand((t, bm, bk), generator=gen, device=dev) < dens
        return torch.where(keep, vals, torch.zeros((), device=dev))

    def kernel_inputs(plan, b):
        """The tensors the fused body hands each kernel for operand b."""
        cfg = plan.config
        bp = permute_pad_b(b, plan.col_perm, cfg.reorder_cols, cfg.bk)
        return bp, plan.stats_dict

    def sddmm_inputs(plan, x, y):
        """The tensors the SDDMM body hands each kernel for x @ y: the
        window-gathered X panel, Y^T with its rows permuted and K-padded
        (both paths read it), and the extraction maps."""
        cfg = plan.config
        xp = gather_rows(x, plan.core_row_map).contiguous()
        ypt = permute_pad_b(y.t(), plan.col_perm, cfg.reorder_cols, cfg.bk)
        return xp, ypt, build_sddmm_maps(plan)

    def walked(walk, x, ypt, chunk=None):
        """gather_sddmm and its plain version on one row walk: the fringe
        dots written at their positions into fresh buffers of 0s (the core
        positions stay 0)."""
        n_out = int(walk.pos.max()) + 1 if walk.pos.numel() else 0
        rows_w = torch.repeat_interleave(
            torch.arange(x.shape[0], device=dev),
            (walk.indptr[1:] - walk.indptr[:-1]).long())
        buf = torch.zeros(n_out, device=dev)

        def kern():
            return gather_sddmm(*walk, x, ypt, buf)

        def plain():
            return ref.ref_gather_sddmm(rows_w, walk.cols, walk.pos, x, ypt,
                                        torch.zeros(n_out, device=dev),
                                        chunk=chunk)

        return kern, plain

    def sampled(plan, xp, ypt, smaps, index=None):
        """dense_tile_sddmm and its plain version on one plan: the values
        at the core slots, written into a fresh (nnz,) buffer of 0s."""
        cfg = plan.config

        buf = torch.zeros(smaps.nnz, device=dev)  # non-core entries stay 0

        def kern():
            return dense_tile_sddmm(
                plan.step_window, plan.step_col, smaps.core_lin, xp, ypt,
                buf, bm=cfg.bm, bk=cfg.bk, index=index)

        def plain():
            return ref.ref_tile_sddmm_at_slots(
                plan.step_window, plan.step_col, smaps.core_lin, xp, ypt,
                torch.zeros(smaps.nnz, device=dev), cfg.bm, cfg.bk,
                tile_chunk=2048)

        return kern, plain

    phase_done("1 device and kernel build")

    # --- phase 2: kernels against their plain versions on the stand-ins ----
    standin_err = {}
    for name in ("ogbn-arxiv", "reddit"):
        spec = PAPER_DATASETS[name]
        rows, cols, vals = generate(spec)
        a = sp.from_coo(rows, cols, vals, (spec.m, spec.k), device=dev)
        p = a.plan
        bp, st = kernel_inputs(p, operand(spec.k, N))
        log(f"{name}: tier={p.fringe_tier} bk={p.fringe_bk} "
            f"windows={p.num_windows} tiles={p.step_window.shape[0]} "
            f"fringe_nnz={st['fringe_nnz']}")
        pairs = [(
            "dense_tile_spmm",
            lambda: dense_tile_spmm(p.step_window, p.step_col, p.flat_values,
                                    bp, num_windows=p.num_windows,
                                    bm=p.config.bm, bk=p.config.bk),
            lambda: ref.ref_block_stream_spmm(p.step_window, p.step_col,
                                              p.flat_values, bp,
                                              p.num_windows),
        ), (
            "gather_spmm",
            lambda: gather_spmm(p.fringe_rows, p.fringe_cols, p.fringe_vals,
                                bp, num_rows=p.fringe_row_ids.shape[0]),
            lambda: ref.ref_gather_spmm(p.fringe_rows, p.fringe_cols,
                                        p.fringe_vals, bp,
                                        p.fringe_row_ids.shape[0]),
        )]
        if p.fringe_tier == "ksharded":
            pairs.append((
                "gather_spmm_ksharded",
                lambda: gather_spmm_ksharded(
                    p.fringe_kb_chunk, p.fringe_kb_rows, p.fringe_kb_cols,
                    p.fringe_kb_vals, bp,
                    num_rows=p.fringe_row_ids.shape[0], bk=p.fringe_bk),
                lambda: ref.ref_gather_spmm_kblocked(
                    p.fringe_kb_chunk, p.fringe_kb_rows, p.fringe_kb_cols,
                    p.fringe_kb_vals, bp, p.fringe_row_ids.shape[0],
                    p.fringe_bk),
            ))
        xs = operand(spec.m, N)
        xp, ypt, smaps = sddmm_inputs(p, xs, operand(N, spec.k))
        pairs += [
            ("dense_tile_sddmm", *sampled(p, xp, ypt, smaps)),
            ("gather_sddmm", *walked(smaps.walk, xs, ypt)),
        ]
        for kname, kern, plain in pairs:
            e = err_bound(kern(), plain())
            standin_err[kname] = max(standin_err.get(kname, 0.0), e)
            log(f"  {kname}: max |kernel - plain| = {e:.3e}")
        del a, p, bp, xp, ypt, smaps, xs
    # the structured lane's kernels on the DLMC stand-ins (4096 x 4096)
    for name, hint in (("dlmc-nm-1-32", None), ("dlmc-nm-2-32", None),
                       ("dlmc-unstr", "bitmap")):
        spec = PAPER_DATASETS[name]
        rows, cols, vals = generate(spec)
        p = sp.from_coo(rows, cols, vals, (spec.m, spec.k), device=dev,
                        structure_hint=hint).plan
        bp, _ = kernel_inputs(p, operand(spec.k, N))
        cfg = p.config
        log(f"{name}: format={p.matrix_format} {p.format_params} "
            f"windows={p.num_windows} tiles={p.step_window.shape[0]}")
        if p.matrix_format == "nm":
            kname = "nm_tile_spmm"
            n_pat, m_pat = p.format_params
            got = nm_tile_spmm(p.step_window, p.step_col, p.nm_values,
                               p.nm_codes, bp, num_windows=p.num_windows,
                               bm=cfg.bm, bk=cfg.bk, n_pat=n_pat,
                               m_pat=m_pat)
            want = ref.ref_nm_stream_spmm(p.step_window, p.step_col,
                                          p.nm_values, p.nm_codes, bp,
                                          p.num_windows, n_pat, m_pat,
                                          cfg.bk)
        else:
            require(p.matrix_format == "bitmap", p.matrix_format)
            kname = "bitmap_tile_spmm"
            got = bitmap_tile_spmm(p.step_window, p.step_col, p.bitmap_words,
                                   p.bitmap_values, bp,
                                   num_windows=p.num_windows, bm=cfg.bm,
                                   bk=cfg.bk, row_cap=p.format_params[1])
            want = ref.ref_bitmap_stream_spmm(p.step_window, p.step_col,
                                              p.bitmap_words,
                                              p.bitmap_values, bp,
                                              p.num_windows, cfg.bk)
        e = err_bound(got, want)
        standin_err[kname] = max(standin_err.get(kname, 0.0), e)
        log(f"  {kname}: max |kernel - plain| = {e:.3e}")
        del p, bp, got, want
    # the redesigned B1 and B6 on stand-ins that reach each of their paths:
    # B1 on 2.5 %-dense tiles with one window of 4,096 tiles (split into
    # chunks, reduced), and on tiles alternating 2 % and 50 % (walk and
    # tensor-core product in one launch); B6 at 2:4 (decode + 3xTF32) and
    # 1:32 (slot walk) at the pruned-weight paths' N = 2,048
    t0 = time.perf_counter()
    for label, sw_np, density in (
            ("one window of 4,096 tiles at 2.5 %",
             np.r_[np.zeros(4096), np.full(8, 2)], (0.025,)),
            ("2 % / 50 % alternating", np.repeat(np.arange(16), 128),
             (0.02, 0.5))):
        sw = torch.from_numpy(sw_np.astype(np.int32)).to(dev)
        nw = int(sw_np.max()) + 1
        sc = torch.arange(sw.numel(), device=dev, dtype=torch.int32) % 512
        fv = sparse_tiles(sw.numel(), density)
        bs = operand(512 * 64, N)
        got = dense_tile_spmm(sw, sc, fv, bs, num_windows=nw, bm=128, bk=64)
        e = err_bound(got, ref.ref_block_stream_spmm(sw, sc, fv, bs, nw,
                                                     tile_chunk=512))
        standin_err["dense_tile_spmm"] = max(standin_err["dense_tile_spmm"],
                                             e)
        log(f"  dense_tile_spmm, {label}: max |kernel - plain| = {e:.3e}")
        del sw, sc, fv, bs, got
    rng = np.random.RandomState(14)
    for n_pat, m_pat in ((2, 4), (1, 32)):
        t_nm, bm, bk = 512, 128, 64
        g = rng.randn(t_nm, bm, bk // m_pat, m_pat).astype(np.float32)
        keep = np.argsort(rng.rand(*g.shape), axis=-1) < n_pat
        vals, codes = pack_nm_tiles(
            np.where(keep, g, 0.0).reshape(t_nm, bm, bk), n_pat, m_pat)
        args = [torch.from_numpy(x).to(dev) for x in (
            np.repeat(np.arange(8), 64).astype(np.int32),
            (np.arange(t_nm) % 64).astype(np.int32), vals, codes)]
        bs = operand(64 * bk, PRUNED_N)
        got = nm_tile_spmm(*args, bs, num_windows=8, bm=bm, bk=bk,
                           n_pat=n_pat, m_pat=m_pat)
        e = err_bound(got, ref.ref_nm_stream_spmm(*args, bs, 8, n_pat, m_pat,
                                                  bk, tile_chunk=32))
        standin_err["nm_tile_spmm"] = max(standin_err["nm_tile_spmm"], e)
        log(f"  nm_tile_spmm, {n_pat}:{m_pat} at N = {PRUNED_N}: max "
            f"|kernel - plain| = {e:.3e}")
        del args, bs, got
    # B7 on tiles alternating 2 % and 50 % (bit walk and decode + 3xTF32)
    sw = torch.arange(8, device=dev, dtype=torch.int32).repeat_interleave(64)
    sc = torch.arange(512, device=dev, dtype=torch.int32) % 64
    words, values, cap = pack_bitmap_tiles_torch(sparse_tiles(512,
                                                              (0.02, 0.5)))
    bs = operand(64 * 64, PRUNED_N)
    got = bitmap_tile_spmm(sw, sc, words, values, bs, num_windows=8, bm=128,
                           bk=64, row_cap=cap)
    e = err_bound(got, ref.ref_bitmap_stream_spmm(sw, sc, words, values, bs,
                                                  8, 64, tile_chunk=64))
    standin_err["bitmap_tile_spmm"] = max(standin_err["bitmap_tile_spmm"], e)
    log(f"  bitmap_tile_spmm, 2 % / 50 % alternating at N = {PRUNED_N}: max "
        f"|kernel - plain| = {e:.3e}")
    del sw, sc, words, values, bs, got
    log(f"  (B1/B6/B7 path stand-ins: {time.perf_counter() - t0:.1f} s)")
    nonfinite_phase(types.SimpleNamespace(
        dev=dev, gen=gen, operand=operand, sparse_tiles=sparse_tiles,
        require=require, log=log))
    spec = PAPER_DATASETS["cora"]
    cora = generate(spec)
    gradient_phase(types.SimpleNamespace(dev=dev, sp=sp, log=log,
                                         err_bound=err_bound),
                   sp.from_coo(*cora, (spec.m, spec.k), device=dev), *cora)
    require(set(standin_err) == {"dense_tile_spmm", "gather_spmm",
                                 "gather_spmm_ksharded", "dense_tile_sddmm",
                                 "gather_sddmm", "nm_tile_spmm",
                                 "bitmap_tile_spmm"}, standin_err)

    phase_done("2 kernels on stand-ins")

    # --- phase 3: the main path through the entry points -------------------
    spec = GraphSpec(**REDDIT)
    t0 = time.perf_counter()
    rows, cols, vals = generate(spec)
    log(f"reddit-scale graph: {spec.m} x {spec.k}, nnz {rows.size} "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    arxiv = PAPER_DATASETS["ogbn-arxiv"]
    a_rows, a_cols, a_vals = generate(arxiv)
    b = operand(spec.k, N)
    bb = operand(spec.k, 64, batch=4)
    b_arxiv = operand(arxiv.k, N)

    def reddit_path():
        t0 = time.perf_counter()
        a = sp.from_coo(rows, cols, vals, (spec.m, spec.k), device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = sp.spmm(a, b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cb = sp.bspmm(a, bb)
        torch.cuda.synchronize()
        return a, c, cb, (t1 - t0, t2 - t1, time.perf_counter() - t2)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (A, c, cb, (t_prepare, t_spmm, t_bspmm)), launches_reddit = drive(
        reddit_path)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    p = A.plan
    st = p.stats_dict
    log(f"main path: prepare {t_prepare:.1f} s (partition "
        f"{st['t_partition_s']:.1f}, reorder {st['t_reorder_s']:.1f}, pack "
        f"{st['t_pack_s']:.1f}); first spmm {t_spmm * 1e3:.1f} ms; first "
        f"bspmm {t_bspmm * 1e3:.1f} ms; peak device memory {peak_gb:.2f} GB")
    log(f"  plan: windows={p.num_windows} tiles={p.step_window.shape[0]} "
        f"core_nnz={st['core_nnz']} fringe_nnz={st['fringe_nnz']} "
        f"fringe_rows={p.fringe_row_ids.shape[0]} tier={p.fringe_tier}")
    log(f"  launches on the reddit-scale path: {launches_reddit}")
    require(p.fringe_tier == "resident", p.fringe_tier)
    require(launches_reddit["dense_tile_spmm"] > 0
            and launches_reddit["gather_spmm"] > 0
            and launches_reddit["gather_spmm_ksharded"] == 0,
            launches_reddit)
    ctx3 = types.SimpleNamespace(
        dev=dev, sp=sp, log=log, require=require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, tol=TOL, impl="cuda")
    per_path = reddit_per_path(ctx3, A, b, c)
    log(f"  {json.dumps({'reddit_per_path': per_path})}")

    def arxiv_path():
        a = sp.from_coo(a_rows, a_cols, a_vals, (arxiv.m, arxiv.k),
                        device="cuda")
        return a, a @ b_arxiv

    (A_arxiv, c_arxiv), launches_arxiv = drive(arxiv_path)
    log(f"  launches on the ogbn-arxiv path: {launches_arxiv}")
    require(A_arxiv.plan.fringe_tier == "ksharded", A_arxiv.plan.fringe_tier)
    require(launches_arxiv["gather_spmm_ksharded"] > 0
            and launches_arxiv["gather_spmm"] == 0, launches_arxiv)
    # the graph-attention path: one forward of the layer over the plan the
    # reddit-scale path built (not prepared a second time)
    x_att = torch.randn((spec.m, D_IN), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(602))
    layer = SparseGraphAttention.init(
        A, D_IN, D_HEAD,
        generator=torch.Generator(device=dev).manual_seed(D_HEAD))
    with_values = sp.SparseMatrix.with_values
    t_with_values = []

    def timed_with_values(self, values):
        # host seconds of the with_values call inside the forward, taken
        # there so that the forward runs once
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = with_values(self, values)
        torch.cuda.synchronize()
        t_with_values.append(time.perf_counter() - t0)
        return out

    sp.SparseMatrix.with_values = timed_with_values
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        h, launches_att = drive(lambda: layer(x_att))
    finally:
        sp.SparseMatrix.with_values = with_values
    t_att = time.perf_counter() - t0
    peak_att_gb = torch.cuda.max_memory_allocated() / 1e9
    require(len(t_with_values) == 1, t_with_values)
    log(f"graph-attention path (D_in {D_IN}, one head of {D_HEAD}): forward "
        f"{t_att:.1f} s, of which with_values {t_with_values[0]:.1f} s on "
        f"the host; peak device memory {peak_att_gb:.2f} GB")
    log(f"  launches on the graph-attention path: {launches_att}")
    require(launches_att["dense_tile_sddmm"] > 0
            and launches_att["gather_sddmm"] > 0
            and launches_att["dense_tile_spmm"] > 0
            and launches_att["gather_spmm"] > 0
            and launches_att["gather_spmm_ksharded"] == 0, launches_att)

    # reference from other code: cuSPARSE's SDDMM on the CSR of the COO,
    # the same edge softmax, cuSPARSE's SpMM
    key = rows.astype(np.int64) * spec.k + cols
    require(bool(np.all(key[1:] > key[:-1])),
            "the generator's COO is sorted and unique, so CSR order is "
            "input order")

    def pattern_csr(r, cc, m, k):
        """CSR of row-sorted unique (r, cc) on the card, values 1."""
        crow = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(r.long(), minlength=m), 0)
        return torch.sparse_csr_tensor(
            crow, cc.long(), torch.ones(r.shape[0], device=dev), (m, k))

    q, k_att, v = (x_att @ w for w in (layer.wq, layer.wk, layer.wv))
    yk = k_att.t().contiguous()
    pattern = pattern_csr(torch.from_numpy(rows).to(dev),
                          torch.from_numpy(cols).to(dev), spec.m, spec.k)
    s_ref = torch.sparse.sampled_addmm(pattern, q, yk, beta=0.0).values()
    e_sddmm = err_bound(sp.sddmm(A, q, k_att.t()), s_ref)
    # device memory of the SDDMM step alone (warm: its index arrays are in
    # plan.derived), above what the path holds before it; the previous
    # dense_tile_sddmm allocated the whole (T, bm, bk) fp32 stream
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s_port = sp.sddmm(A, q, k_att.t())
    torch.cuda.synchronize()
    sddmm_peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    stream_gb = A.plan.flat_values.numel() * 4 / 1e9
    log(f"  sddmm step: peak device memory {sddmm_peak_gb:.3f} GB above the "
        f"{held / 1e9:.2f} GB held (the (T, bm, bk) stream the previous "
        f"kernel wrote would be {stream_gb:.3f} GB)")
    del s_port
    seg = torch.repeat_interleave(
        torch.arange(spec.m, device=dev), pattern.crow_indices().diff())
    e = s_ref / D_HEAD ** 0.5
    e_max = torch.full((spec.m,), -float("inf"), device=dev).scatter_reduce(
        0, seg, e, "amax")
    pe = torch.exp(e - e_max[seg])
    denom = torch.zeros(spec.m, device=dev).index_add_(0, seg, pe)
    att = torch.sparse_csr_tensor(
        pattern.crow_indices(), pattern.col_indices(),
        pe / denom[seg].clamp(min=1e-30), (spec.m, spec.k))
    require(h.shape == (spec.m, D_HEAD), h.shape)
    e_att = err_bound(h, torch.sparse.mm(att, v))
    log(f"  sddmm vs sampled_addmm: {e_sddmm:.3e}; attention forward vs "
        f"sampled_addmm + softmax + sparse.mm: {e_att:.3e}")
    del pattern, att, seg, e, e_max, pe, denom, s_ref, h, v

    # the GCN training path: forward SpMMs on A, backward SpMMs on plan_t
    arxiv_graph = arxiv_gcn_graph()
    gcn = gcn_training_path(ctx3, arxiv_graph)
    log(f"  {json.dumps({'gcn_training': gcn})}")
    # the coordination path and telemetry on the same graph
    t0 = time.perf_counter()
    coord_plans, b_coord, coord = coordination_path(ctx3, arxiv_graph)
    log(f"  {json.dumps({'coordination': coord})}")
    telemetry = telemetry_path(ctx3, arxiv_graph,
                               coord_plans[coord["default_alpha"]], b_coord)
    log(f"  {json.dumps({'telemetry_roofline': telemetry})}")
    log(f"  (coordination and telemetry paths: "
        f"{time.perf_counter() - t0:.1f} s)")
    del coord_plans, b_coord  # arxiv_graph stays for the dynamic path

    # each kernel's count from the path that runs it
    launches = {
        "dense_tile_spmm": launches_reddit["dense_tile_spmm"],
        "gather_spmm": launches_reddit["gather_spmm"],
        "gather_spmm_ksharded": launches_arxiv["gather_spmm_ksharded"],
        "dense_tile_sddmm": launches_att["dense_tile_sddmm"],
        "gather_sddmm": launches_att["gather_sddmm"],
    }

    require(c.shape == (spec.m, N) and cb.shape == (4, spec.m, 64),
            (c.shape, cb.shape))
    csr = csr_of(rows, cols, vals, (spec.m, spec.k))
    e_spmm = err_bound(c, torch.sparse.mm(csr, b))
    e_bspmm = max(err_bound(cb[i], sp.spmm(A, bb[i].contiguous()))
                  for i in range(4))
    e_arxiv = err_bound(c_arxiv, torch.sparse.mm(
        csr_of(a_rows, a_cols, a_vals, (arxiv.m, arxiv.k)), b_arxiv))
    del csr
    log(f"  spmm vs torch.sparse.mm: {e_spmm:.3e}; bspmm vs 4 x spmm: "
        f"{e_bspmm:.3e}; arxiv spmm vs torch.sparse.mm: {e_arxiv:.3e}")

    phase_done("3 main path")

    # --- phase 4: kernels at their paths' shapes ---------------------------
    report = []

    def padding_nan_check(label, kbc, kbr, kbcol, kbv, bmat, nr, bk, order):
        """B3 with an Inf in the first B row of a k-block whose bucket is
        padded: its padding entries (row 0, value 0) add 0 * Inf = NaN, as
        in the plain version and the TPU kernel; NaN and Inf cells equal,
        the rest within the tolerance."""
        chunk = kbr.numel() // kbc.numel()
        pad_kb = torch.repeat_interleave(kbc, chunk)[kbv == 0]
        require(pad_kb.numel() > 0, (label, "no padding entries"))
        b_inf = bmat.clone()
        b_inf[int(pad_kb[0]) * bk, 3] = float("inf")
        got = gather_spmm_ksharded(kbc, kbr, kbcol, kbv, b_inf, num_rows=nr,
                                   bk=bk, row_order=order)
        want = ref.ref_gather_spmm_kblocked(kbc, kbr, kbcol, kbv, b_inf, nr,
                                            bk, step=1 << 21)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        require(bool(nan[0, 3]), (label, "padding entries gave no NaN"))
        require(torch.equal(torch.isnan(got), nan)
                and torch.equal(torch.isinf(got), torch.isinf(want)),
                (label, "NaN/Inf cells"))
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item()
        require(err <= TOL * max(1.0, want[fin].abs().max().item()),
                (label, err))
        log(f"  gather_spmm_ksharded, {label}, an Inf in B row "
            f"{int(pad_kb[0]) * bk} (a padded k-block's first): "
            f"{int(nan.sum())} NaN cells as in the plain version, row 0's "
            f"included; finite cells max |diff| {err:.3e}")

    def record(name, src, replaces, *args, other_errs=(), **kwargs):
        m = measure(name, *args, **kwargs)
        report.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name], **m,
            "max_abs_err": max(m["max_abs_err"], standin_err[name],
                               *other_errs),
        })

    # the kernels are timed as the main path calls them once warm: with
    # the index arrays the wrappers derive from the leaves (window
    # segments, row offsets) computed once, as plan.derived holds them
    bp, _ = kernel_inputs(p, b)
    k_pad, n = bp.shape
    cfg = p.config
    t_steps = p.step_window.shape[0]
    nw = p.num_windows
    segments = window_segments(p.step_window, nw)
    chunks = window_chunks(segments[1])

    # the core tile stream as a BSR matrix with square (bk, bk) blocks (the
    # library's block-sparse product takes square blocks only)
    sub = cfg.bm // cfg.bk
    require(cfg.bm % cfg.bk == 0, (cfg.bm, cfg.bk))
    blk_row = (p.step_window.long()[:, None] * sub
               + torch.arange(sub, device=dev)[None, :]).reshape(-1)
    blk_col = p.step_col.long()[:, None].expand(t_steps, sub).reshape(-1)
    nkb = k_pad // cfg.bk
    order = torch.argsort(blk_row * nkb + blk_col)
    crow = torch.zeros(nw * sub + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(blk_row, minlength=nw * sub), 0)
    bsr = torch.sparse_bsr_tensor(
        crow, blk_col[order],
        p.flat_values.reshape(t_steps * sub, cfg.bk, cfg.bk)[order],
        (nw * cfg.bm, k_pad))
    per_tile = torch.count_nonzero(p.flat_values.reshape(t_steps, -1), dim=1)
    tile_nnz = int(per_tile.sum())
    tile_density = per_tile.float() / (cfg.bm * cfg.bk)
    qs = torch.quantile(tile_density[:1 << 24], torch.tensor(
        [0.5, 0.9, 0.99, 1.0], device=dev)).tolist()
    log(f"  reddit-scale tiles: density median {qs[0]:.4f}, p90 {qs[1]:.4f},"
        f" p99 {qs[2]:.4f}, max {qs[3]:.4f}; "
        f"{int((tile_density >= mma_min_density()).sum())} of {t_steps} at "
        f"or above the tensor-core threshold {mma_min_density()}")
    del tile_density, per_tile
    record(
        "dense_tile_spmm", "dense_tile_spmm.cu",
        "src/repro/kernels/dense_tile_spmm.py:65",
        lambda: dense_tile_spmm(p.step_window, p.step_col, p.flat_values, bp,
                                num_windows=nw, bm=cfg.bm, bk=cfg.bk,
                                segments=segments, chunks=chunks,
                                a_flag=p.a_unsplittable),
        lambda: ref.ref_block_stream_spmm(p.step_window, p.step_col,
                                          p.flat_values, bp, nw,
                                          tile_chunk=2048),
        lambda: torch.sparse.mm(bsr, bp),
        nbytes=(t_steps * 8 + p.flat_values.numel() * 4 + k_pad * n * 4
                + nw * cfg.bm * n * 4),
        flops=2 * tile_nnz * n,
    )

    # two calls on the reddit-scale plan (split windows, partials reduced
    # in chunk order, no atomics) must agree bit for bit
    c1, c2 = (dense_tile_spmm(p.step_window, p.step_col, p.flat_values, bp,
                              num_windows=nw, bm=cfg.bm, bk=cfg.bk,
                              segments=segments, chunks=chunks,
                              a_flag=p.a_unsplittable)
              for _ in range(2))
    torch.cuda.synchronize()
    same = bool(torch.equal(c1, c2))
    log(f"  dense_tile_spmm twice on the reddit-scale plan ({nw} windows, "
        f"{chunks.table.shape[0]} chunks, {chunks.n_slots} partial slots):"
        f" bit-identical {same}")
    require(same, "dense_tile_spmm differs between two calls")
    del c1, c2
    density_sweep(dense_tile_spmm, sparse_tiles, timed_ms, operand, log)

    # B4 and B5 at the graph-attention path's shapes: X = q, Y = k^T, D=256
    xp, ypt, smaps = sddmm_inputs(p, q, k_att.t())
    d = q.shape[1]
    # the library's SDDMM on the core tiles: the BSR above (square bk x bk
    # blocks) where the installed PyTorch takes a BSR input, else a CSR of
    # the core nonzeros in the original coordinates
    try:
        torch.sparse.sampled_addmm(bsr, xp, ypt.t(), beta=0.0)
        torch.cuda.synchronize()
        lib_b4_form = f"BSR {cfg.bk}x{cfg.bk} blocks of the tile stream"
        lib_b4 = lambda: torch.sparse.sampled_addmm(bsr, xp, ypt.t(), beta=0.0)  # noqa: E731
    except (RuntimeError, NotImplementedError, ValueError, TypeError) as err:
        core = smaps.core_lin >= 0
        core_csr = pattern_csr(torch.from_numpy(rows).to(dev)[core],
                               torch.from_numpy(cols).to(dev)[core],
                               spec.m, spec.k)
        lib_b4_form = (f"CSR of the core nonzeros (BSR refused: "
                       f"{type(err).__name__}: {str(err)[:120]})")
        lib_b4 = lambda: torch.sparse.sampled_addmm(core_csr, q, yk, beta=0.0)  # noqa: E731
    log(f"  library call for dense_tile_sddmm: torch.sparse.sampled_addmm on "
        f"{lib_b4_form}")
    # the sampled product as the attention path calls it once warm: the
    # index arrays plan.derived holds
    index_b4 = sampled_index(p.step_window, p.step_col, smaps.core_lin,
                             bm=cfg.bm, bk=cfg.bk)
    n_core = index_b4.pos.numel()
    kern_b4, plain_b4 = sampled(p, xp, ypt, smaps, index_b4)
    record(
        "dense_tile_sddmm", "sddmm.cu", "src/repro/kernels/sddmm.py:74",
        kern_b4, plain_b4, lib_b4,
        # each byte once: X's window panel, Y^T, three int32 per core
        # nonzero and the segment table, one fp32 output per core nonzero
        nbytes=(xp.numel() * 4 + ypt.numel() * 4 + n_core * 16
                + index_b4.seg_kb.numel() * 8),
        flops=2 * n_core * d,
    )
    first = kern_b4().clone()
    second = kern_b4()
    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    log(f"  dense_tile_sddmm twice at reddit scale ({n_core} core nonzeros, "
        f"{index_b4.seg_kb.numel()} segments): bit-identical {same}")
    require(same, "dense_tile_sddmm differs between two calls")
    del bsr, lib_b4, first, second, kern_b4, plain_b4, index_b4
    # B5: the fringe's rows in input order (runs of one row, which the
    # previous one-warp-per-nonzero kernel saw) and in the walk's order
    walk = smaps.walk
    um = p.update_maps
    f_sel = np.flatnonzero(um.core_lin < 0)
    f_rows_in, f_cols_in = (torch.from_numpy(t[f_sel]).to(dev)
                            for t in (um.rows, um.cols))
    del f_sel
    nnz_fs = int(walk.cols.numel())
    change = torch.ones(nnz_fs, dtype=torch.bool, device=dev)
    change[1:] = f_rows_in[1:] != f_rows_in[:-1]
    runs = torch.cat([torch.nonzero(change).squeeze(1),
                      torch.tensor([nnz_fs], device=dev)]).to(torch.int32)
    log(f"  reddit-scale SDDMM fringe, row runs in input order: "
        f"{json.dumps(fringe_profile(runs, f_cols_in, spec.k))}")
    log(f"  the same in the walk's row order: "
        f"{json.dumps(fringe_profile(walk.indptr, walk.cols, spec.k))}")
    f_pattern = pattern_csr(f_rows_in, f_cols_in, spec.m, spec.k)
    del change, runs, f_rows_in, f_cols_in
    kern_b5, plain_b5 = walked(walk, q, ypt, chunk=1 << 19)
    record(
        "gather_sddmm", "sddmm.cu", "src/repro/kernels/sddmm.py:150",
        kern_b5, plain_b5,
        lambda: torch.sparse.sampled_addmm(f_pattern, q, yk, beta=0.0),
        # each byte once: X, the padded Y^T panel, the row offsets, two
        # int32 in and one fp32 out per fringe nonzero
        nbytes=(nnz_fs * 12 + walk.indptr.numel() * 4 + q.numel() * 4
                + ypt.numel() * 4),
        flops=2 * nnz_fs * d,
    )
    first = kern_b5().clone()
    second = kern_b5()
    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    log(f"  gather_sddmm twice at reddit scale ({nnz_fs} fringe nonzeros, "
        f"{-(-d // SLICE_COLS)} passes of {SLICE_COLS} columns): "
        f"bit-identical {same}; "
        f"the one-warp-per-nonzero kernel it replaces took 10.818 ms here "
        f"(PERF.md)")
    require(same, "gather_sddmm differs between two calls")
    del xp, ypt, f_pattern, q, k_att, yk, first, second, kern_b5, plain_b5

    def fringe_csr(plan, k_cols):
        nr = plan.fringe_row_ids.shape[0]
        indptr = torch.zeros(nr + 1, dtype=torch.int64, device=dev)
        indptr[1:] = torch.cumsum(
            torch.bincount(plan.fringe_rows.long(), minlength=nr), 0)
        return torch.sparse_csr_tensor(
            indptr, plan.fringe_cols.long(), plan.fringe_vals, (nr, k_cols))

    nr = p.fringe_row_ids.shape[0]
    nnz_f = p.fringe_rows.shape[0]
    f_csr = fringe_csr(p, k_pad)
    indptr = csr_indptr(p.fringe_rows, nr)
    profile = fringe_profile(indptr, p.fringe_cols, k_pad)
    log(f"  reddit-scale fringe: {json.dumps(profile)}")
    record(
        "gather_spmm", "gather_spmm.cu",
        "src/repro/kernels/gather_spmm.py:141",
        lambda: gather_spmm(p.fringe_rows, p.fringe_cols, p.fringe_vals, bp,
                            num_rows=nr, indptr=indptr),
        lambda: ref.ref_gather_spmm(p.fringe_rows, p.fringe_cols,
                                    p.fringe_vals, bp, nr, chunk=1 << 21),
        lambda: torch.sparse.mm(f_csr, bp),
        nbytes=nnz_f * 12 + k_pad * n * 4 + nr * n * 4,
        flops=2 * nnz_f * n,
    )
    c1, c2 = (gather_spmm(p.fringe_rows, p.fringe_cols, p.fringe_vals, bp,
                          num_rows=nr, indptr=indptr) for _ in range(2))
    torch.cuda.synchronize()
    same = bool(torch.equal(c1, c2))
    log(f"  gather_spmm twice on the reddit-scale fringe: bit-identical "
        f"{same}")
    require(same, "gather_spmm differs between two calls")
    del c1, c2
    # the card's ceilings for B2's reads: as many 1 KB rows as the fringe
    # has nonzeros, at random from a set that fits in L2 and from all of B
    gathered_gb = nnz_f * n * 4 / 1e9
    for label, set_rows in (("24 MB", 24 * 10 ** 6 // (4 * n)),
                            ("238 MB", k_pad)):
        probe_ms = gather_probe(bp, set_rows, nnz_f, timed_ms)
        log(f"  gather probe, {nnz_f} rows of 1 KB at random from a "
            f"{label} set: {probe_ms:.3f} ms ({gathered_gb / probe_ms:.3f} "
            f"TB/s); gather_spmm moves the same {gathered_gb:.2f} GB in "
            f"{report[-1]['ms']:.3f} ms ({gathered_gb / report[-1]['ms']:.3f}"
            f" TB/s)")

    # B3 once more on the reddit-scale fringe, pushed onto the streaming
    # tier by a budget that holds a bk = 2048 slice stream but not the
    # resident B panel: the stream prepare builds from this packed fringe
    # under that budget.  The arxiv stand-in's stream (below) is too small
    # to time the kernel's throughput.
    budget = cost_model.fringe_ksharded_bytes(2048, nr, cfg.bn)
    tier_s, bk_s = cost_model.select_fringe_tier(
        k_pad, nr, cfg.bn, vmem_budget=budget, impl="cuda")
    require(tier_s == "ksharded" and bk_s == 2048, (tier_s, bk_s))
    t0 = time.perf_counter()
    kb = bucket_fringe_kblocks(
        *(x.cpu().numpy() for x in (p.fringe_rows, p.fringe_cols,
                                    p.fringe_vals)),
        k_pad, bk_s, ops.effective_chunk(cfg.fringe_chunk))
    kbc, kbr, kbcol, kbv = (torch.from_numpy(x).to(dev) for x in kb[:4])
    del kb
    order_s = kbucket_row_order(kbc, kbr, kbcol, nr, bk_s)
    log(f"reddit-scale fringe on the streaming tier: bk={bk_s}, "
        f"{kbc.numel()} chunks, {kbr.numel()} entries (bucketed in "
        f"{time.perf_counter() - t0:.1f} s)")
    b3_scale = measure(
        "gather_spmm_ksharded (reddit-scale fringe)",
        lambda: gather_spmm_ksharded(kbc, kbr, kbcol, kbv, bp, num_rows=nr,
                                     bk=bk_s, row_order=order_s),
        lambda: ref.ref_gather_spmm_kblocked(kbc, kbr, kbcol, kbv, bp, nr,
                                             bk_s, step=1 << 21),
        lambda: torch.sparse.mm(f_csr, bp),
        nbytes=kbc.numel() * 4 + kbr.numel() * 12 + k_pad * n * 4
        + nr * n * 4,
        flops=2 * nnz_f * n,
    )
    padding_nan_check("reddit-scale fringe", kbc, kbr, kbcol, kbv, bp, nr,
                      bk_s, order_s)
    del kbc, kbr, kbcol, kbv, order_s, f_csr

    q = A_arxiv.plan
    bq, st_q = kernel_inputs(q, b_arxiv)
    nr_q = q.fringe_row_ids.shape[0]
    q_csr = fringe_csr(q, bq.shape[0])
    row_order = kbucket_row_order(q.fringe_kb_chunk, q.fringe_kb_rows,
                                  q.fringe_kb_cols, nr_q, q.fringe_bk)
    padding_nan_check("ogbn-arxiv stand-in", q.fringe_kb_chunk,
                      q.fringe_kb_rows, q.fringe_kb_cols, q.fringe_kb_vals,
                      bq, nr_q, q.fringe_bk, row_order)
    record(
        "gather_spmm_ksharded", "gather_spmm.cu",
        "src/repro/kernels/gather_spmm.py:213",
        lambda: gather_spmm_ksharded(
            q.fringe_kb_chunk, q.fringe_kb_rows, q.fringe_kb_cols,
            q.fringe_kb_vals, bq, num_rows=nr_q, bk=q.fringe_bk,
            row_order=row_order),
        lambda: ref.ref_gather_spmm_kblocked(
            q.fringe_kb_chunk, q.fringe_kb_rows, q.fringe_kb_cols,
            q.fringe_kb_vals, bq, nr_q, q.fringe_bk),
        lambda: torch.sparse.mm(q_csr, bq),
        nbytes=(q.fringe_kb_chunk.numel() * 4 + q.fringe_kb_rows.numel() * 12
                + bq.numel() * 4 + nr_q * bq.shape[1] * 4),
        flops=2 * st_q["fringe_nnz"] * bq.shape[1],
        other_errs=(b3_scale["max_abs_err"],),
    )

    spmm_ms = timed_ms(lambda: sp.spmm(A, b))
    log(f"end-to-end spmm at N={N}: {spmm_ms:.3f} ms (warm); "
        f"{check_cost_line(lambda: sp.spmm(A, b), spmm_ms)}")

    phase_done("4 kernels at path shapes")

    # --- phase 5: the pruned-weight paths (the structured lane) ----------
    del A, p, c, cb, bp, b, bb, layer, x_att, A_arxiv, q, c_arxiv, segments
    del chunks
    torch.cuda.empty_cache()
    ctx = types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, measure=measure,
        operand=operand, csr_of=csr_of, standin_err=standin_err)
    launches_pruned, records = pruned_weight_paths(ctx)
    launches.update(launches_pruned)
    report.extend(records)
    torch.cuda.empty_cache()

    phase_done("5 pruned-weight paths")

    # --- phase 6: the two-hop path (spspmm) ---------------------------------
    ctx6 = types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, tol=TOL)
    A2, P2, _, two_hop = two_hop_path(ctx6)
    log(f"  {json.dumps({'two_hop': two_hop})}")

    phase_done("6 two-hop path")

    # --- phase 7: health, faults and deadlines --------------------------------
    health = health_phase(ctx6, A2, P2)
    log(f"  {json.dumps({'health': health})}")
    del A2, P2
    torch.cuda.empty_cache()

    phase_done("7 health")

    # --- phase 8: the dynamic path -------------------------------------------
    ctx8 = types.SimpleNamespace(
        sp=sp, dev=dev, log=log, require=require, drive=drive,
        err_bound=err_bound, timed_ms=timed_ms, measure=measure,
        csr_of=csr_of)
    dynamic = dynamic_path(ctx8, arxiv_graph)
    log(f"  {json.dumps({'dynamic': dynamic})}")

    phase_done("8 dynamic path")

    # --- phase 9: the serving path --------------------------------------------
    serving = serving_path(ctx8, arxiv_graph)
    log(f"  {json.dumps({'serving': serving})}")

    phase_done("9 serving path")

    # --- phase 10: the sharded path -------------------------------------------
    sharded = sharded_path(ctx8, (rows, cols, vals, (spec.m, spec.k)),
                           arxiv_graph)
    log(f"  {json.dumps({'sharded': sharded}, default=str)}")
    for r in report:
        r["launches"] += sharded["launches"].get(r["name"], 0)

    phase_done("10 sharded path")

    # --- phase 11: LM serving ---------------------------------------------
    torch.cuda.empty_cache()
    log(f"LM serving: {torch.cuda.memory_allocated() / 1e9:.2f} GB held by "
        f"earlier phases")
    lm = lm_serving_path(ctx8)
    log(f"  {json.dumps({'lm_serving': lm})}")

    phase_done("11 LM serving")

    # --- phase 12: LM training --------------------------------------------
    torch.cuda.empty_cache()
    log(f"LM training: {torch.cuda.memory_allocated() / 1e9:.2f} GB held by "
        f"earlier phases")
    lm_train = lm_training_path(ctx8)
    log(f"  {json.dumps({'lm_training': lm_train})}")

    phase_done("12 LM training")

    # --- phase 13: the dry run against the card ---------------------------
    torch.cuda.empty_cache()
    log(f"dry run: {torch.cuda.memory_allocated() / 1e9:.2f} GB held by "
        f"earlier phases")
    dry = dryrun_path(ctx8)
    log(f"  {json.dumps({'dryrun': dry})}")
    phase_done("13 dry run")
    log(json.dumps({"phase_s": phase_s}))
    require(len(report) == 7 and all(r["launches"] > 0 for r in report),
            [(r["name"], r["launches"]) for r in report])
    print(json.dumps({"kernels": report}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
