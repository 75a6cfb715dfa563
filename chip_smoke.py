#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # full size: 1M x 500 training rows
    python3 chip_smoke.py --rows N   # fewer training rows, same widths

Phases, each of which fails the run on error:
  1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source) and prints the build time and the
     ptxas resource report;
  2. drives the in-core path at the width of ``configs/xgb_paper.py`` (500
     features, max_bin 256, depth 8, lr 0.1, binary:logistic, no sampling):
     the host quantile sketch, binning on the card (`ArrayDMatrix`), a
     10-tree ``GradientBooster(device="cuda")`` fit with a 100k-row eval set,
     and ``predict_margin`` of the eval rows (binning included); every
     kernel's launch count is zeroed before and read after, and each must be
     > 0; then a second predict of the eval rows splits its milliseconds
     into the host-to-device copies, the binning kernel, the forest and the
     copy back, and a second pass of the binning splits its seconds into the
     host-to-device copies, the kernel and the copies back;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the paths give it (histogram: all training rows, 500 features,
     256 bins, 64 build nodes; partition: a trained tree over all training
     rows; forest: the trained forest over the eval rows, and a served
     forest of 256 random trees of depth 8 over all training rows; binning: one
     32 MiB page's rows in float32, and the eval rows in float64, also
     against the host `bin_batch`), and times kernel, plain version and,
     where one exists, one PyTorch library call computing the same function;
     the histogram also bit for bit against the fixed-point plain version,
     and timed at each level of the in-core booster's first tree (its real
     positions and build sets), beside the in-core seconds per tree; the
     partition with the next level's row counts folded in (positions and
     counts bit for bit), and at each level of that tree against the
     sequence it replaces (the kernel, then ``level_row_counts``); beside
     partition, forest and binning, what the memory system gives for their
     inputs (a gather of one bin a row; one read of the bins; one read and
     one copy of the raw rows);
  4. fits twice in core on a 200k-row subset and requires identical trees;
  5. requires ``predict_margin`` to equal the per-tree loop bit for bit;
  6. drives the out-of-core streaming path at the same width: the training
     rows, fed as batches to ``IterDMatrix`` (the phase-2 cuts, 32 MiB pages
     binned on the card and written to disk through `PageStore`), fit 4
     trees under ``ExecutionPolicy(mode="auto")`` with a memory budget
     between the byte model's streaming and in-core needs; requires the
     ``out_of_core`` decision, histogram and partition launches per page,
     eval AUC within 1e-3 of the in-core fit's after 4 trees, and a peak
     device memory below the in-core fit's; launch counts are zeroed and
     read as in phase 2. The fit's device-memory peak above its start is
     printed beside the byte model's streaming need, broken down by
     allocation site from the CUDA allocator's trace. Then one pass of the
     page stream holds the histogram and partition kernels against their
     plain versions on every staged page (the histogram also bit for bit
     against the fixed-point one; the partition's counts added over all
     pages into one buffer against the counts of the concatenated
     positions), the page-summed histogram against the
     plain histogram of the concatenated pages and bit for bit against the
     fixed-point pages summed with ``add_``;
  6b. drives the sampled path (Alg. 7) on phase 6's 15 pages, reopened with
     ``PagedDMatrix``: 4 trees under ``ExecutionPolicy(mode="auto")`` with
     phase 6's budget and ``SamplingConfig(method="mvs", f=0.1)`` (the
     paper config's ``sampling_f``); requires the ``sampled`` decision at
     f = 0.1, histogram and partition launched once a level of each tree
     (the compacted page is built in core), every tree's kept rows within
     the compacted page's capacity, the fit's peak above its start within
     the budget, and eval AUC within 0.01 of phase 6's streaming fit after
     4 trees. Prints seconds a tree split into the host compaction pass
     (sampling, the host gather, the stage), the tree build and the staged
     margin pass; host-to-device GB a tree beside streaming's; the peak
     beside the byte model's sampled need and the budget; kept rows a tree.
     Then, on the first tree's compacted page with its padding rows, at each
     level of that tree (its real positions and build sets), the histogram
     bit for bit against the fixed-point plain version and the partition
     with its counts against the plain version;
  7. fits twice more by streaming (3 trees, a 200k-row subset, the page
     cache reopened through ``PagedDMatrix``, staging depth 2) and requires
     identical trees; then twice by sampling (MVS, f = 0.1, the same pages)
     and twice in core with MVS on the same rows, and requires identical
     trees and margins. Before them, the MVS threshold μ, the suffix sums
     behind it and an MVS draw from one generator seed must give the same
     bits in 30 calls on 1M random values (a 1-D ``torch.cumsum``, whose
     float sums move from call to call on the card, is counted beside them
     for the record);
  8. drives the elastic multi-worker path at the same width:
     ``prepare_shards`` of 400k fresh rows into 2 shards of 3 x 32 MiB pages
     (binned on the card), then ``ElasticTrainer(device="cuda")`` with 2
     subprocess workers on the same card, 4 trees: run A uninterrupted (the
     level-window histogram kernel launched once per page and level in the
     workers, counted from their counters at shutdown; the node-set kernel
     never), run B with worker w1 killed at its third ``begin_tree`` (one
     recovery, shard reassignment, resume; every tree array equal to run
     A's), and eval AUC within 1e-3 of the single-process streaming fit on
     the same rows and cuts. Then, on one staged page at level 7, the
     level-window kernel against its plain version and bit for bit against
     the fixed-point plain version and the node-set kernel on the equivalent
     build nodes, and chunked split
     evaluation of a 128-node level against one chunk.

  9. (run right after 6b, on phase 6's 15 pages) drives the serving tier
     (`repro_torch.serve`) at the same width: (a) the in-core booster's
     ``predict_margin(PagedDMatrix(cache))``, one forest launch a page, bit
     for bit its ``predict_margin`` of the raw training rows and the plain
     version (`ref.predict_forest_bins`) page by page; (b) a served
     forest of 256 random trees of depth 8 (`serving_forest`, unscaled
     leaves, lr 0.1, the in-core cuts) over the same pages: resident (15
     launches, bit for bit the plain version page by page), paged in
     32-tree chunks without pins (8 x 15 launches, h2d
     8 row passes plus the chunks), with a byte budget that pins 4 of the 8
     chunks beside one row page (the plan: pages outer) and with every
     chunk pinned (chunks outer), each bit for bit the resident forest, its
     `ResidencyPlan` (recorded from the engine) equal to the arithmetic and
     its h2d bytes within the plan; then two requests through one
     `ForestServer` with that budget, the second staging no pinned chunk
     and moving fewer bytes; (c) 4,096 single raw eval rows through
     `BatchServer(max_batch=256, max_delay_ms=2)` over the resident and the
     32-tree-chunk forest, equal to a direct predict and to the plain
     versions (`ref.bin_values`, then `ref.predict_forest_bins`) on the
     same rows, with p50/p99,
     occupancy and rows/s; (d) kernel 3 at the chunk shape (32 trees over
     one 67,108-row page, a random ``margin_in``) against its plain
     version, timed beside its bound: the second ``predict_forest`` row of
     the kernels line, whose launches are the chunked launches of (b).

  10. best-first (lossguide) growth and the tiered histogram store, each
     fit with the launch counts zeroed before and read after: (a) in core
     on phase 2's matrix, depth 8, ``max_leaves=256``, ``pop_batch=1``, 4
     trees, bit for bit phase 2's first 4 depthwise trees; (b) 64 leaves at
     ``pop_batch`` 1 and 8, 4 trees each; (c) as (b) at ``pop_batch=1``
     under ``hist_budget_bytes`` of 16 node histograms, ``retained_levels``
     1 (bit for bit (b), with spills and a lower peak) and 2 (the
     structural bar); (d) depth 12, 256 leaves on the first 300,000 rows:
     ``mode="auto"`` at a budget of the byte model's fixed working set less
     one node refuses without a histogram budget (the error is printed)
     and decides ``in_core`` with 16 nodes of it; 2 trees stay within that
     budget; kernel 3 bit for bit its plain version on that forest (8,191
     nodes a tree) and on an 8-leaf one (255 nodes) over the eval rows;
     (e) (after phase 9, on phase 6's 15 pages) a streaming tree of 16
     leaves at ``pop_batch=4``, AUC within 1e-3 of an in-core fit at the
     same settings, then the same fit again with kernels 1 and 2 held
     against their plain versions on every page of their first four passes
     (the same tree); (f) MVS at f = 0.1 on those pages, 64 leaves, 2
     trees, AUC within 0.01 of the in-core fit at the same settings; then a
     sampled fit at a budget between the sampled byte model and its
     compacted page's capacity (ROADMAP queue 3; printed, not failed);
     (g) (after phase 8's run B, on its shards) one elastic tree of 16
     leaves, AUC within 1e-3 of a single-process streaming tree on phase
     8's single-process pages.

  11. compression (`repro_torch.compress`): (a) (after phase 10 (f), on
     phase 6's pages) the bitpack decode kernel bit for bit against its
     plain version, twice a case with one launch a call, at bits 1-8, with
     and without missing values, at row widths that do not fill a byte and
     with an all-missing row, at its tile edges (R - 1, R, R + 1 and 4R + 3
     rows at 500 and 13 symbols, R = ``kernels.bitpack.tile_rows``), from
     views 1, 3, 8 and 15 bytes into a buffer, and at 8 bits with a missing
     symbol of 254; then on phase 6's first page (67,108 x 500, 8 bits),
     timed beside its bound (the packed read plus the uint8 write), the
     plain version and one device copy of the decoded bytes (``copy_ms``):
     the ``bitpack_decode`` row of the kernels line; (b) (after phase 8)
     200,000 fresh rows x 500 with 5% missing at ``max_bin=32`` (6-bit
     symbols) in 32 MiB pages, written raw, ``bitpack`` and ``delta-rle``,
     the decode kernel timed as in (a) on the first page (67,108 x 500) and
     on the whole matrix (the in-core fit's one decode); 2 depth-8 trees
     out of core on each, trees and margins bit for bit the raw run's, the
     bitpack run's wire/logical bytes at most 0.76 and one decode launch a
     staged page; then in core on the same rows raw and with
     ``page_codec="bitpack"``, trees bit for bit, each peak printed beside
     the byte model's ``in_core_bytes``; (c) (after phase 10 (d), on phase
     2's matrix) phase 10 (c)'s lossguide fit (64 leaves, 16 node
     histograms of budget, 4 trees) with ``grad_transport`` raw, f16, bf16
     and int8: each spill a half, a half and a quarter of a raw spill's
     bytes, eval AUC within 0.02 of raw (the reference's bound), two int8
     fits identical; (d) (after phase 9) phase 9's 256-tree forest through
     ``ForestServer(trees_per_chunk=32, page_codec="bitpack")`` over the eval
     rows, bit for bit the raw server, each chunk's wire bytes 14/24 of raw
     (228,928 against 392,448 B), and a pinned server whose second request
     stages nothing.
  12. the sharded trainer (`repro_torch.distributed.gbdt_shard`, the
     paper's §2.2 histogram all-reduce): (a) (after phase 11 (c), on phase
     2's matrix) `fit_sharded` on a world of one, 4 trees, bit for bit phase
     2's first 4 trees; then (after phase 11 (a), on phase 6's pages) 4 rank
     processes share the card over gloo (NCCL refuses two ranks on one
     device), each this script run with ``--shard-rank``: (b) 4 trees
     data-parallel, 250,000 rows a rank, twice (the runs bit for bit
     equal, every rank's trees equal), eval AUC within 1e-4 of (a), the
     share of split nodes equal to (a)'s and the largest eval margin
     difference printed, a predict through kernel 3; (c) 2 x 2 data x
     feature, 2 trees, eval AUC within 1e-4 of (a)'s after 2; (d)
     `grow_tree_distributed_paged` over the 15 pages, one tree, each rank
     staging only its rows (a quarter of the single process's bytes, within
     0.2-0.3), eval AUC within 1e-3 of phase 6's first tree, the share of
     equal nodes printed; (e) lossguide at 64 leaves, one tree, again under
     a 16-node ``hist_budget_bytes`` (bit for bit the unbudgeted tree); (f)
     phase 11 (b)'s 200,000 rows at ``max_bin=32``, 2 trees: bitpack
     staging bit for bit raw, an f16 all-reduce within 0.02 AUC of raw.
     Each rank prints seconds a tree, the all-reduce's seconds, bytes and
     calls a tree, and its launches, which the kernels line adds as the
     sharded path (every kernel must be launched on it).
  13. LM serving (`repro_torch.models`, after phase 11 (b)): (a) all ten
     LM archs, llama3.2-1b (dense), olmoe-1b-7b (MoE, 64 experts top-8),
     mamba2-130m (SSM) and hymba-1.5b (hybrid) first, then smollm-135m,
     phi3-mini-3.8b, minicpm-2b, musicgen-large (4 codebooks, fed codes),
     moonshot-v1-16b-a3b (MoE, a dense first layer, 64 experts top-6) and
     llava-next-34b (60 layers, 56:8 GQA), each at its full CONFIG in bf16
     with random weights from a seeded generator on the card (drawn a layer
     at a time: one f32 block beside the weights), served through
     ``repro_torch.launch.serve.main`` (batch 4, prompt 32, 16 greedy
     tokens; dense and MoE also ``--paged``): every logit finite; prefill's
     and the first decode step's logits, contiguous and paged, against
     ``forward`` over the prompt plus that token (a vision model's text
     alone, as served), in bf16 and on the same weights widened to f32 (at
     full depth where the f32 copy fits beside the bf16 weights, else on
     the most leading layers that fit with the embeddings and head: llava,
     moonshot; relative to the largest logit; MoE at a
     capacity at which neither drops an assignment and with every token
     routed as the forward routes it, its gap as served printed): on the
     served weights where they are well conditioned (a 1e-7 nudge of the
     embeddings moves the f32 logits by at most 2e-3), and for every model
     with attention on the same weights with q and k scaled by 0.1; paged
     against contiguous as served; prefill s, decode tok/s, wall ms a step,
     the card's busy ms a step (`torch.profiler`), peak device memory and
     the step's bytes bound printed; each model freed before the next;
     llava-next-34b's vision input at its real size, one no-grad bf16
     ``forward`` and ``lm_loss`` over 576 seeded patch embeddings a
     sequence (finite; loss, seconds, peak printed); hymba-1.5b again from
     a 1,040-token prompt (batch 2) past its 1024-slot ring, prefill's and
     all 16 decode steps' logits against the forward in bf16 and f32. (b)
     every arch at REDUCED (f32) and the four serve cases of
     ``tests/test_models.py``: the same weights serve prefill and 4 greedy
     decode steps on the card and on the CPU, logits within 1e-4 and tokens
     equal. TF32 matmuls must be off (PyTorch's default; checked, not set).
     It launches none of the six kernels (counted from zero and printed).
  14. LM training (`repro_torch.train`, after phase 13): (a) through
     ``repro_torch.launch.train.main`` at full CONFIG in bf16 with random
     weights from a seeded generator: llama3.2-1b (batch 4, seq 512, 8
     steps, then 8 with ``--mvs-f 0.5``), mamba2-130m (3 steps into a
     checkpoint directory, the restored state bit for bit the saved one,
     then ``--resume`` for 2 more), hymba-1.5b, smollm-135m, minicpm-2b
     (its WSD schedule) and musicgen-large (3 steps each); olmoe-1b-7b at
     full width with its depth cut to what one card holds (printed), 3
     steps of `make_train_step`. Every loss and grad norm finite, MVS's kept
     fraction in [0, 1] each step and in (0, 1] over the run; wall ms a
     step (after a synchronise), tokens/s, peak device memory, the step's
     FLOP bound (8 x the parameters a token meets x tokens with remat, over
     the dense bf16 peak) and the card's busy share of a step from a
     `torch.profiler` trace of 2 steps. (b) 20 steps of
     `make_train_step` on one fixed batch of llama3.2-1b REDUCED lower the
     loss. (c) every REDUCED arch at f32: one `make_train_step` step and one
     `make_mvs_train_step` step (text models) from the same weights (query,
     key and SSM input projections scaled by 0.1, as the CPU tests do) and
     the same uniforms on the card and on the CPU: loss, grad norm and the
     updated parameters within the CPU tests' tolerances. (d)
     ``examples/torch_mvs_lm_training.py`` and ``examples/torch_quickstart.py``
     run on the card with their defaults in two subprocesses started
     together and exit 0. The
     phase launches none of the six kernels in this process (counted from
     zero and printed; the quickstart's subprocess is not counted).
  15. The dry run (`repro_torch.launch.dryrun`, after phase 14): (a) its
     ``main`` on the 16 x 16 production mesh of a fake 256-rank world, on
     the host, for llama3.2-1b x {train_4k, prefill_32k, decode_32k},
     olmoe-1b-7b x train_4k, llava-next-34b x decode_32k, mamba2-130m x
     long_500k and xgb-paper x boost_1m, one subprocess a cell, all started
     together: each cell must reach ``status: ok``, and a line a cell
     prints its dominant term, the compute / memory / collective seconds on
     H100 constants, the useful share, the per-device peak and the seconds
     it took. (b) On a world of one over a 1 x 1 mesh of the card, the dry
     run of llama3.2-1b train at batch 4 x 512 in bf16 (phase 14's shape),
     mamba2-130m train at the same shape and llama3.2-1b decode at batch 4
     against a 48-token paged cache (phase 13's shape), then the same steps
     run for real on the card from seeded generators: the FLOPs
     (`FlopCounterMode` around the card's step) must equal the dry run's,
     and the card's peak (``max_memory_allocated`` above the start, the
     step's inputs included) must lie within 25% of the dry run's peak
     estimate; the measured ms a step over the roofline's max(compute,
     memory) s is printed. It launches none of the six kernels.
  16. The sharded LM program (after phase 15), as a world of one over
     NCCL on a 1 x 1 mesh of the card (gloo ranks sharing a card die on
     DTensor's all-gather of CUDA tensors under torch 2.11): REDUCED
     llama3.2-1b, olmoe-1b-7b and hymba-1.5b in f32, prefill, 3 greedy
     decode steps and a train step on the mesh against no mesh (loss 1e-5,
     grad norm 1e-5, logits to the f32 floor, decode 1e-4 with equal
     tokens), each state after a step saved sharded (`train.checkpoint`),
     restored with its `sharding.state_shardings` and with none, both bit
     for bit, and the next step from it within 1e-5 of the uninterrupted
     one. The worlds of 2 and 4 ranks are the four-card runs of
     ``tests/test_torch_cuda.py`` (NCCL, one card a rank). It launches none
     of the six kernels.

The streaming and sampled fits' device-memory peaks above their starts must
stay within the budget their policy decided under (phases 6 and 6b). The card's compute mode must be
Default: the elastic phase runs three processes on it, the sharded phase
four. The widths come from ``src/repro_torch/configs/xgb_paper.py``.

It prints a JSON line of per-kernel numbers, the card's name and power limit
(nvidia-smi), and last ``{"ok": true, "device": {...}}``. It imports nothing
of JAX and exits non-zero without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
FP64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores
PAGE_BYTES = 32 * 1024 * 1024
AUC_TOLERANCE = 1e-3  # streaming vs in-core eval AUC after 4 trees
SAMPLED_AUC_TOLERANCE = 0.01  # sampled (f = 0.1) vs streaming eval AUC after 4 trees
SPIN_CYCLES = 40_000_000  # ~20 ms of the SM clock (up to 1.98 GHz)


def _time_ms(fn, iters: int, warmup: int = 1, queued: bool = False) -> float:
    """CUDA-event ms per call of ``fn`` called back to back: a call's wall
    time as a path pays it, the host's time per call (Python, the wrapper,
    the launch API) included where it exceeds the device's. With ``queued``
    the launches first queue behind a device spin of ~20 ms, so that the
    card runs them back to back and only its own time per call shows (the
    ``device_ms`` of the kernels line)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000, help="training rows")
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--stream-trees", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    # phase 12's rank processes: the script runs itself once per rank
    ap.add_argument("--shard-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shard-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.shard_rank is not None:
        return shard_rank_main(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    _load_paper_config()
    import numpy as np

    from repro_torch.core.booster import GradientBooster
    from repro_torch.core.ellpack import Binner
    from repro_torch.core.objectives import auc
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.quantile import QuantileSketch
    from repro_torch.data.dmatrix import ArrayDMatrix, IterDMatrix, PagedDMatrix
    from repro_torch.data.pages import _decode
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import _build
    from repro_torch.kernels import ellpack_bin as k_bin
    from repro_torch.kernels import launch_counts as read_counts
    from repro_torch.kernels import reset_launch_counts as zero_counts

    dev = torch.device("cuda", 0)
    # the kernels each path must launch
    node_path = ("build_histogram_nodes", "partition_rows", "predict_forest", "bin_values")
    elastic_path = ("build_histogram", "partition_rows", "predict_forest", "bin_values")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    if card.rsplit(",", 1)[-1].strip() != "Default":
        raise SystemExit(f"the card's compute mode is not Default ({card}): the elastic "
                         "phase runs a coordinator and two workers on it")

    # 1. build ---------------------------------------------------------------
    _build.build_all()
    print(f"build: {_build.build_seconds:.3f} s for {len(_build.SOURCES)} sources")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2. in-core path --------------------------------------------------------
    t0 = time.perf_counter()
    m = PAPER.num_features
    X, y = make_classification(args.rows, m, seed=args.seed)
    Xe, ye = make_classification(100_000, m, seed=args.seed, batch=1)
    print(f"data: {args.rows} x 500 train, 100000 x 500 eval, {time.perf_counter() - t0:.1f} s")
    params = dict(
        n_estimators=args.trees, max_depth=PAPER.max_depth, learning_rate=PAPER.learning_rate,
        max_bin=PAPER.max_bin, objective=PAPER.objective,
    )
    t0 = time.perf_counter()
    sketch = QuantileSketch(m, max_bin=PAPER.n_bins)
    sketch.update(X)
    cuts = sketch.finalize()
    sketch_s = time.perf_counter() - t0
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm = ArrayDMatrix(X, y, max_bin=PAPER.max_bin, cuts=cuts, device=dev)
    torch.cuda.synchronize()
    binning_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    in_core_base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    booster = GradientBooster(device="cuda", **params).fit(dm, eval_set=(Xe, ye))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    in_core_peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    margin = booster.predict_margin(Xe)
    predict_ms = (time.perf_counter() - t0) * 1e3
    in_core_launches = read_counts()
    eval_auc = auc(ye, margin)
    n_trees = len(booster.trees)
    # the boosting loop alone: eval_history's clock starts after the eval
    # set is binned
    loop_s = booster.eval_history[-1].elapsed_s
    print(
        f"in-core path: decision={booster.decision_.mode} trees={n_trees} "
        f"sketch={sketch_s:.3f} s (host) binning={binning_s:.3f} s (card, incl. copies) "
        f"fit={fit_s:.3f} s boosting_loop={loop_s:.3f} s per_tree={loop_s / n_trees:.4f} s "
        f"predict={predict_ms:.3f} ms (100000 rows, binning on the card included) "
        f"eval_auc={eval_auc:.6f} peak_device_bytes={in_core_peak} (at start {in_core_base})"
    )
    print(f"in-core path launches: {json.dumps(in_core_launches)}")
    predict_split(booster, Xe, margin, dev)
    binning_split(dm, X, dev)
    if booster.decision_.mode != "in_core":
        raise SystemExit("the in-core path did not train in core")
    if not all(in_core_launches[k] > 0 for k in node_path):
        raise SystemExit(f"a kernel of the in-core path was never launched: {in_core_launches}")
    if not (np.all(np.isfinite(margin)) and margin.shape == (100_000,) and eval_auc > 0.7):
        raise SystemExit(f"in-core path output wrong: shape {margin.shape}, auc {eval_auc}")

    # 3. kernels against their plain versions, at the paths' shapes ----------
    results = kernel_checks(args.seed, dev, dm, booster, X, Xe, loop_s / n_trees)

    # 10 (a)-(d). best-first growth and the budgeted store in core ----------
    lg_core_launches, lg_aucs = lossguide_in_core_phase(dev, dm, X, y, Xe, ye, booster, params)

    # 11 (c). the histogram spill's quantized transports on the same matrix
    grad_launches = compression_grad_phase(dev, dm, Xe, ye, params)

    # 12 (a). the sharded trainer on a world of one, on the same matrix
    shard_one = sharded_world_of_one(dev, dm, booster, Xe, ye, params)
    del dm

    # 4. determinism: two fits on a 200k-row subset grow identical trees ------
    sub = min(200_000, args.rows)
    fits = [
        GradientBooster(device="cuda", **params).fit(X[:sub], y[:sub], cuts=booster.cuts)
        for _ in range(2)
    ]
    for a, b in zip(fits[0].trees, fits[1].trees):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise SystemExit("two fits on the same data grew different trees")
    print(f"determinism: two in-core fits on {sub} rows grew {len(fits[0].trees)} identical trees")
    del fits

    # 5. fused predict equals the per-tree loop bit for bit -------------------
    forest = booster.packed_forest()
    eval_bins = Binner(booster.cuts, dev).to_device(Xe)
    fused = forest.predict_margin_bins(eval_bins)
    per_tree = forest.predict_margin_per_tree(eval_bins)
    if not (torch.equal(fused, per_tree) and np.array_equal(margin, fused.cpu().numpy())):
        raise SystemExit("fused forest predict differs from the per-tree loop")
    print("predict: fused forest == per-tree loop (bitwise)")
    del forest, eval_bins, fused, per_tree

    # 6. out-of-core streaming path ------------------------------------------
    batch_rows = 100_000
    batches = [(X[i : i + batch_rows], y[i : i + batch_rows]) for i in range(0, len(X), batch_rows)]
    n_stream = min(args.stream_trees, args.trees)
    stream_params = dict(params, n_estimators=n_stream)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pages_") as cache:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sdm = IterDMatrix(batches, max_bin=PAPER.max_bin, cuts=booster.cuts, cache_dir=cache,
                          page_bytes=PAGE_BYTES, device=dev)
        pages_s = time.perf_counter() - t0
        page_bin_launches = k_bin.launches
        model = ExecutionPolicy().memory_model(sdm, booster.params)
        need_stream, need_core = model.out_of_core_bytes(sdm.n_rows), model.in_core_bytes(sdm.n_rows)
        budget = (need_stream + need_core) // 2
        policy = ExecutionPolicy(mode="auto", memory_budget_bytes=budget)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        stream_base = torch.cuda.memory_allocated(dev)
        torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python")
        t0 = time.perf_counter()
        sb = GradientBooster(device="cuda", policy=policy, **stream_params)
        sb.fit(sdm, eval_set=(Xe, ye))
        torch.cuda.synchronize()
        stream_fit_s = time.perf_counter() - t0
        stream_peak = torch.cuda.max_memory_allocated(dev)
        trace = torch.cuda.memory._snapshot()["device_traces"][dev.index]
        torch.cuda.memory._record_memory_history(enabled=None)
        traced_peak, peak_sites = _peak_breakdown(trace)
        del trace
        stream_margin = sb.predict_margin(Xe)
        stream_launches = read_counts()
        st = sb.stats
        n_pages = sdm.n_pages
        stream_loop_s = sb.eval_history[-1].elapsed_s
        n_stream = len(sb.trees)
        stream_auc = sb.eval_history[n_stream - 1].value
        core_auc = booster.eval_history[n_stream - 1].value
        print(
            f"streaming path: decision={sb.decision_.mode} ({sb.decision_.reason}) "
            f"pages={n_pages} page_creation={pages_s:.3f} s trees={len(sb.trees)} "
            f"fit={stream_fit_s:.3f} s per_tree={stream_loop_s / len(sb.trees):.4f} s "
            f"h2d_GB={st.host_to_device_bytes / 1e9:.6f} disk_read_GB={st.disk_read_bytes / 1e9:.6f} "
            f"overlap_ratio={st.overlap_ratio:.6f} fetch_s={st.stream_fetch_seconds:.6f} "
            f"stage_s={st.stream_stage_seconds:.6f} compute_s={st.stream_compute_seconds:.6f} "
            f"wall_s={st.stream_wall_seconds:.6f} io_retries={st.io_retries}"
        )
        print(
            f"streaming memory: budget_bytes={budget} (byte model: streaming {need_stream}, "
            f"in-core {need_core}) peak_device_bytes={stream_peak} (at start {stream_base}) "
            f"in_core_peak_device_bytes={in_core_peak}"
        )
        print(
            f"streaming memory: peak above start {stream_peak - stream_base} B against the "
            f"byte model's streaming need {need_stream} B; the allocator trace's peak "
            f"{traced_peak} B holds:"
        )
        small = [r for r in peak_sites if r[1] < 1 << 20]
        for site, nbytes, blocks in peak_sites[: len(peak_sites) - len(small)]:
            print(f"  {nbytes} B in {blocks} block(s) from {site}")
        print(f"  {sum(r[1] for r in small)} B in {sum(r[2] for r in small)} block(s) "
              f"from {len(small)} sites of under 1 MiB each")
        # the histogram kernels' own buffers at the peak (the running page
        # sum, the workspace, the big slots' accumulator) stay below one
        # full-size (64, 500, 255, 2) int64 accumulator
        full_int64 = 64 * 500 * 255 * 2 * 8
        hist_bytes = sum(b for site, b, _ in peak_sites if site.startswith("kernels/histogram.py"))
        print(f"streaming memory: the histogram wrappers hold {hist_bytes} B at the peak, "
              f"against {full_int64} B for one full-size int64 accumulator")
        if hist_bytes >= full_int64:
            raise SystemExit("a full-size int64 histogram buffer is live at the streaming peak")
        print(
            f"streaming eval_auc after {n_stream} trees={stream_auc:.6f} in-core={core_auc:.6f} "
            f"|diff|={abs(stream_auc - core_auc):.6f}"
        )
        print(f"streaming path launches: {json.dumps(stream_launches)} "
              f"(bin_values {page_bin_launches} of them creating the pages)")
        if sb.decision_.mode != "out_of_core":
            raise SystemExit(f"the streaming path decided {sb.decision_.mode!r}")
        per_pass = n_pages * stream_params["max_depth"] * len(sb.trees)
        if not (stream_launches["build_histogram_nodes"] == per_pass
                == stream_launches["partition_rows"]):
            raise SystemExit(f"histogram/partition not launched once per page and level: "
                             f"{stream_launches}, expected {per_pass}")
        if not all(stream_launches[k] > 0 for k in node_path):
            raise SystemExit(f"a kernel of the streaming path was never launched: "
                             f"{stream_launches}")
        print(f"streaming memory: peak above start {stream_peak - stream_base} B within the "
              f"policy's budget {budget} B: {stream_peak - stream_base <= budget}")
        if stream_peak - stream_base > budget:
            raise SystemExit(f"the streaming fit peaked {stream_peak - stream_base} B above "
                             f"its start, over the {budget} B budget it decided under")
        if abs(stream_auc - core_auc) > AUC_TOLERANCE:
            raise SystemExit(f"streaming AUC {stream_auc} vs in-core {core_auc}")
        if not stream_peak < in_core_peak:
            raise SystemExit(f"streaming peak {stream_peak} not below in-core {in_core_peak}")
        if not (np.all(np.isfinite(stream_margin)) and stream_margin.shape == (100_000,)):
            raise SystemExit("streaming path output wrong")
        # what phase 12 (d) holds the sharded paged build against
        stream_tree0 = [a.cpu() for a in sb.trees[0]]
        stream_auc1 = sb.eval_history[0].value
        stream_h2d_tree = st.host_to_device_bytes / n_stream
        page_kernel_checks(args.seed, dev, sdm, sb.trees[0])
        del sb, sdm
        # where one page fetch goes (host clock, median of 5): the read, the
        # manifest's CRC32 check and the decode the prefetch thread does
        spans = []
        for _ in range(5):
            t0 = time.perf_counter()
            blob = (Path(cache) / "page_000000.bin").read_bytes()
            t1 = time.perf_counter()
            zlib.crc32(blob)
            t2 = time.perf_counter()
            _decode(blob)
            spans.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        read_s, crc_s, decode_s = np.median(np.asarray(spans), axis=0)
        print(f"page fetch (page 0, {len(blob)} bytes): read={read_s * 1e3:.3f} ms "
              f"crc32={crc_s * 1e3:.3f} ms decode={decode_s * 1e3:.3f} ms")

        # 6b. the sampled path (Alg. 7) on the same pages ----------------------
        sampled_launches = sampled_phase(
            dev, cache, dict(stream_params), budget, Xe, ye, stream_auc,
            st.host_to_device_bytes / n_stream, stream_loop_s / n_stream, node_path,
        )

        # 9. the serving tier on the same pages --------------------------------
        serving_launches, chunk_row, served = serving_phase(args.seed, dev, cache, booster, X, Xe)

        # 11 (d). the served forest's chunks through the forest transport
        serve_codec_launches = compression_serving_phase(dev, served, Xe)
        del served

        # 10 (e)-(f). best-first growth streaming and sampled on the same pages
        lg_paged_launches = lossguide_paged_phase(dev, cache, stream_params, Xe, ye, lg_aucs)
        sampled_budget_check(dev, cache, stream_params)

        # 11 (a). the bitpack decode kernel, and on phase 6's first page
        bitpack_row = bitpack_kernel_checks(args.seed, dev, cache)

        # 12 (b)-(f). the sharded trainer, 4 ranks on the card, on the same pages
        sharded_launches = sharded_phase(
            args.seed, dev, cache, stream_params, Xe, ye, shard_one, stream_tree0, stream_auc1,
            stream_h2d_tree,
        )
        _add_counts(sharded_launches, shard_one["counts"])
        if not all(sharded_launches.get(k, 0) > 0 for k in SHARD_PATH):
            raise SystemExit(f"a kernel of the sharded path was never launched: "
                             f"{sharded_launches}")

    # 7. determinism of the streaming path ------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pages_") as cache:
        sub_batches = [(X[i : i + batch_rows], y[i : i + batch_rows]) for i in range(0, sub, batch_rows)]
        IterDMatrix(sub_batches, max_bin=PAPER.max_bin, cuts=booster.cuts, cache_dir=cache,
                    page_bytes=PAGE_BYTES, device=dev)
        det_policy = ExecutionPolicy(mode="out_of_core", staging_depth=2)
        det = [
            GradientBooster(device="cuda", policy=det_policy, **dict(params, n_estimators=3))
            .fit(PagedDMatrix(cache))
            for _ in range(2)
        ]
        sampled_determinism(dev, cache, X[:sub], y[:sub], Xe, booster.cuts, params)
    for a, b in zip(det[0].trees, det[1].trees):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise SystemExit("two streaming fits on the same pages grew different trees")
    if not torch.equal(det[0].margins_, det[1].margins_):
        raise SystemExit("two streaming fits on the same pages gave different margins")
    print(f"determinism: two streaming fits on {sub} rows ({det[0].pages.n_pages} pages, "
          f"staging_depth=2) grew {len(det[0].trees)} identical trees")
    del det

    # 8. elastic multi-worker path -------------------------------------------
    elastic_launches, window_row, lg_elastic_launches = elastic_phase(
        args.seed, dev, params, elastic_path)
    results.insert(1, window_row)

    # 11 (b). page codecs on the streaming and in-core paths
    stream_codec_launches = compression_stream_phase(args.seed, dev, params)
    results.append(bitpack_row)

    # 13. LM serving on the card: every arch at full width, and every arch
    # held against the CPU
    lm_launches = lm_serving_phase(dev)

    # 14. LM training on the card: the archs one card holds at full width
    # through the entry point, and every arch held against the CPU
    train_launches = lm_training_phase(dev)

    # 15. the dry run: production cells on the host, and three steps whose
    # dry-run FLOPs and peak are held to the card's
    dryrun_launches = dryrun_phase(dev)

    # 16. the sharded LM program: what one card holds (a world of one over
    # NCCL, a sharded checkpoint restored with its layouts), and the
    # four-card runs where there are four cards
    lm_shard_launches = lm_sharded_phase(dev)

    # launches: the paths' runs (phase 10's lossguide fits among them), each
    # counted from zero (per path above);
    # the chunk-shape row of predict_forest counts its chunked launches alone
    for r in results:
        r["launches"] = sum(
            path[r["name"]]
            for path in (in_core_launches, stream_launches, sampled_launches, elastic_launches,
                         serving_launches, lg_core_launches, lg_paged_launches,
                         lg_elastic_launches, grad_launches, serve_codec_launches,
                         stream_codec_launches, sharded_launches, lm_launches,
                         train_launches, dryrun_launches, lm_shard_launches)
        )
    i = next(i for i, r in enumerate(results) if r["name"] == "predict_forest")
    results.insert(i + 1, chunk_row)
    print(json.dumps({"kernels": results}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


def sampled_phase(dev, cache: str, params: dict, budget: int, Xe, ye, stream_auc: float,
                  stream_h2d_per_tree: float, stream_per_tree_s: float, path_kernels) -> dict:
    """Phase 6b: the sampled path (see the module docstring). The booster
    runs as a user calls it; the script wraps, from outside, its sampler
    (kept rows), its tree builder (seconds; a host copy of the first tree's
    compacted page, gradients included) and its two per-tree steps (seconds)
    to split a tree's time. Returns the path's launch counts."""
    import numpy as np
    import torch

    import repro_torch.core.booster as booster_mod
    from repro_torch.core.booster import GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.sampling import SamplingConfig
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.kernels import launch_counts, reset_launch_counts

    cfg = SamplingConfig(method="mvs", f=PAPER.sampling_f)
    n_trees, depth = params["n_estimators"], params["max_depth"]
    sdm = PagedDMatrix(cache)
    sb = GradientBooster(device=dev, policy=ExecutionPolicy(mode="auto",
                         memory_budget_bytes=budget), **params, sampling=cfg)
    kept, spans, first = [], {"compact": [], "build": [], "margins": [], "copy": []}, {}
    sample, grow_tree = booster_mod.sample, booster_mod.grow_tree
    build_sampled, update_margins = sb._build_tree_sampled, sb._update_margins

    def timed(label, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spans[label].append(time.perf_counter() - t0)
            return out
        return call

    def counted_sample(*a):
        keep, w = sample(*a)
        kept.append(int(keep.sum()))
        return keep, w

    def grow_and_copy(bins, g, h, *a, **k):
        res = timed("build", grow_tree)(bins, g, h, *a, **k)
        t0 = time.perf_counter()
        if not first:  # host copies: the fit's device memory is not held longer
            first.update(bins=bins.cpu(), g=g.cpu(), h=h.cpu())
        spans["copy"].append(time.perf_counter() - t0)
        return res

    booster_mod.sample, booster_mod.grow_tree = counted_sample, grow_and_copy
    sb._build_tree_sampled = timed("compact", build_sampled)
    sb._update_margins = timed("margins", update_margins)
    try:
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        sb.fit(sdm, eval_set=(Xe, ye))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        margin = sb.predict_margin(Xe)
        launches = launch_counts()
    finally:
        booster_mod.sample, booster_mod.grow_tree = sample, grow_tree
        del sb._build_tree_sampled, sb._update_margins
    n = sdm.n_rows
    capacity = sb._sampled_capacity(n, cfg)
    model = sb.decision_.model
    # the compaction pass: the sampler, the host gather and the stage (the
    # wrapped build and the host copy of the first page taken out)
    compact = [c - b - k for c, b, k in zip(spans["compact"], spans["build"], spans["copy"])]
    loop_s = sb.eval_history[-1].elapsed_s
    st = sb.stats
    auc_s = sb.eval_history[n_trees - 1].value
    print(f"sampled path: decision={sb.decision_.mode} f={sb.decision_.sampling_f} "
          f"({sb.decision_.reason}) trees={len(sb.trees)} fit={fit_s:.3f} s "
          f"per_tree={loop_s / n_trees:.4f} s (streaming {stream_per_tree_s:.4f} s): "
          f"compaction pass {np.mean(compact):.4f} s, tree build {np.mean(spans['build']):.4f} s, "
          f"staged margin pass {np.mean(spans['margins']):.4f} s a tree (per tree: compaction "
          f"{[round(t, 4) for t in compact]}, build {[round(t, 4) for t in spans['build']]}, "
          f"margins {[round(t, 4) for t in spans['margins']]})")
    print(f"sampled path: h2d_GB a tree={st.host_to_device_bytes / n_trees / 1e9:.6f} "
          f"(streaming {stream_h2d_per_tree / 1e9:.6f}) "
          f"disk_read_GB={st.disk_read_bytes / 1e9:.6f} "
          f"fetch_s={st.stream_fetch_seconds:.6f} stage_s={st.stream_stage_seconds:.6f} "
          f"compute_s={st.stream_compute_seconds:.6f} wall_s={st.stream_wall_seconds:.6f}; "
          f"kept rows a tree {kept} (capacity {capacity}); compacted page "
          f"{capacity} x {sdm.num_features} uint8")
    print(f"sampled memory: peak above start {peak} B, byte model's sampled need "
          f"{model.sampled_bytes(n, PAPER.sampling_f)} B, budget {budget} B: within the budget "
          f"{peak <= budget}")
    print(f"sampled eval_auc after {n_trees} trees={auc_s:.6f} streaming={stream_auc:.6f} "
          f"|diff|={abs(auc_s - stream_auc):.6f}")
    print(f"sampled path launches: {json.dumps(launches)}")
    if not (sb.decision_.mode == "sampled" and sb.decision_.sampling_f == PAPER.sampling_f):
        raise SystemExit(f"the sampled path decided {sb.decision_}")
    if not launches["build_histogram_nodes"] == launches["partition_rows"] == n_trees * depth:
        raise SystemExit(f"histogram/partition not launched once a level of each tree: "
                         f"{launches}, expected {n_trees * depth}")
    if not all(launches[k] > 0 for k in path_kernels):
        raise SystemExit(f"a kernel of the sampled path was never launched: {launches}")
    if len(kept) != n_trees or max(kept) > capacity:
        raise SystemExit(f"kept rows {kept} past the compacted page's {capacity} rows")
    if peak > budget:
        raise SystemExit(f"the sampled fit peaked {peak} B above its start, over the "
                         f"{budget} B budget it decided under")
    if abs(auc_s - stream_auc) > SAMPLED_AUC_TOLERANCE:
        raise SystemExit(f"sampled AUC {auc_s} vs streaming {stream_auc}")
    if not (np.all(np.isfinite(margin)) and margin.shape == (len(Xe),)
            and bool(torch.isfinite(sb.margins_).all())):
        raise SystemExit("sampled path output wrong")
    compacted_page_checks(first, sb.trees[0], kept[0])
    return launches


def compacted_page_checks(first: dict, tree, n_kept: int) -> None:
    """Kernels 1 and 2 on the first tree's compacted page (its kept rows,
    then zero-gradient padding rows with bins 0), at each level of that
    tree: its real positions (the plain partition by the tree) and the build
    set the histogram store plans. The histogram must equal the fixed-point
    plain version bit for bit (its distance from the f32 plain version,
    which sums in another order, is printed), the partition with its counts
    the plain version. Restores the launch counts."""
    import torch

    from repro_torch.core.histcache import level_row_counts, plan_level
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import partition as k_part
    from repro_torch.kernels import ref

    dev = tree.feature.device
    bins, g, h = (first[k].to(dev) for k in ("bins", "g", "h"))
    n, m = bins.shape
    part_args = (tree.feature, tree.split_bin, tree.default_left, tree.is_leaf)
    saved = k_hist.launches, k_part.launches
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    err, rel, lines = 0.0, 0.0, []
    for depth in range(tree.max_depth):
        count = 1 << depth
        if depth == 0:
            nodes = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            _, build_left = plan_level(count, level_row_counts(pos, count - 1, count))
            nodes = (count - 1 + 2 * torch.arange(count // 2, dtype=torch.int32, device=dev)
                     + (~build_left).to(torch.int32))
        got = k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255)
        if not torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, 255)):
            raise SystemExit(f"histogram kernel differs from the fixed-point plain version on "
                             f"the compacted page at level {depth}")
        # the f32 plain version sums in another order: its distance, printed
        want = ref.build_histogram_nodes(bins, g, h, pos, nodes, 255)
        diff = (got - want).abs()
        err = max(err, diff.max().item())
        rel = max(rel, (diff / want.abs().clamp(min=1.0)).max().item())
        window = (2 * count - 1, 2 * count)
        got_c, want_c = (torch.zeros(2 * count, dtype=torch.int32, device=dev) for _ in range(2))
        moved = k_part.partition_rows(bins, pos, *part_args, window, got_c)
        new = ref.partition_rows(bins, pos, *part_args, window, want_c)
        if not (torch.equal(moved, new) and torch.equal(got_c, want_c)):
            raise SystemExit(f"partition kernel disagrees with its plain version on the "
                             f"compacted page at level {depth}")
        if depth == tree.max_depth - 1:
            def k1():
                return k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255)
            lines.append(f"level {depth} ({nodes.shape[0]} build nodes) kernel 1 "
                         f"ms={_time_ms(k1, 10):.4f} device_ms={_time_ms(k1, 10, queued=True):.4f}")
        del got, want
        pos = new
    k_hist.launches, k_part.launches = saved
    print(f"sampled kernels on the first tree's compacted page ({n} x {m} uint8, {n_kept} kept "
          f"rows, {n - n_kept} padding rows), each of {tree.max_depth} levels: histogram == the "
          f"fixed-point plain version (bitwise), vs the f32 plain version max_abs_err={err:.3g} "
          f"(relative to max(|plain|, 1): {rel:.3g}); partition positions and counts == the "
          f"plain version; "
          + "; ".join(lines))


def sampled_determinism(dev, cache: str, X, y, Xe, cuts, params: dict) -> None:
    """Phase 7's sampled half: two sampled fits (MVS, f = 0.1, 3 trees) on
    the subset's pages, and two in-core MVS fits on the same rows, must grow
    identical trees and margins."""
    import numpy as np
    import torch

    from repro_torch.core.booster import GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.sampling import SamplingConfig
    from repro_torch.data.dmatrix import PagedDMatrix

    threshold_repeatability(dev, 1_000_000)
    kw = dict(params, n_estimators=3, sampling=SamplingConfig(method="mvs", f=PAPER.sampling_f))
    paged = [GradientBooster(device=dev, policy=ExecutionPolicy(mode="out_of_core"), **kw)
             .fit(PagedDMatrix(cache)) for _ in range(2)]
    core = [GradientBooster(device=dev, **kw).fit(X, y, cuts=cuts) for _ in range(2)]
    for label, (a, b) in (("sampled", paged), ("in-core MVS", core)):
        if not (len(a.trees) == len(b.trees) == 3 and all(
            torch.equal(u, v) for ta, tb in zip(a.trees, b.trees) for u, v in zip(ta, tb)
        )):
            raise SystemExit(f"two {label} fits on the same rows grew different trees")
        if not np.array_equal(a.predict_margin(Xe), b.predict_margin(Xe)):
            raise SystemExit(f"two {label} fits on the same rows predict different margins")
    if paged[0].decision_.mode != "sampled" or core[0].decision_.mode != "in_core":
        raise SystemExit(f"determinism fits decided {paged[0].decision_.mode}, "
                         f"{core[0].decision_.mode}")
    if not torch.equal(paged[0].margins_, paged[1].margins_):
        raise SystemExit("two sampled fits on the same pages gave different training margins")
    print(f"determinism: two sampled fits (MVS, f={PAPER.sampling_f}) on {len(X)} rows "
          f"({paged[0].pages.n_pages} pages) grew 3 identical trees and equal margins; two "
          f"in-core MVS fits on the same rows grew 3 identical trees")


def threshold_repeatability(dev, n: int, calls: int = 30) -> None:
    """μ fixes every MVS weight of a round: its suffix sums (`prefix_sums`),
    μ itself and a whole MVS draw from one generator seed must give the same
    bits on every call. A 1-D ``torch.cumsum`` of the same values is counted
    beside them."""
    import torch

    from repro_torch.core.sampling import SamplingConfig, mvs_threshold, prefix_sums, sample

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    g_hat = torch.rand(n, generator=gen(n), device=dev).square()
    g, h = torch.randn(n, generator=gen(n + 1), device=dev), g_hat + 0.01
    cfg = SamplingConfig(method="mvs", f=PAPER.sampling_f)

    def distinct(fn) -> int:
        return len({fn().cpu().numpy().tobytes() for _ in range(calls)})

    n_scan = distinct(lambda: prefix_sums(g_hat))
    n_mu = distinct(lambda: mvs_threshold(g_hat, PAPER.sampling_f * n))
    n_draw = distinct(lambda: torch.cat([t.view(torch.uint8) for t in sample(gen(7), g, h, cfg)]))
    n_cumsum = distinct(lambda: torch.cumsum(g_hat, 0))
    print(f"MVS threshold on {n} values, {calls} calls: prefix_sums gave {n_scan} distinct "
          f"results, mvs_threshold {n_mu}, an MVS draw (keep, weight) {n_draw}; "
          f"a 1-D torch.cumsum gave {n_cumsum}")
    if n_scan != 1 or n_mu != 1 or n_draw != 1:
        raise SystemExit("the MVS threshold or draw differs from call to call")


def serving_phase(seed: int, dev, cache: str, booster, X, Xe) -> tuple[dict, dict, object]:
    """Phase 9: the serving tier on phase 6's pages (see the module
    docstring). Each mode runs with the launch counts zeroed just before it
    and read just after; the direct predicts it is compared with run
    outside those counts. Returns the path's launch counts, the
    chunk-shape row of the kernels line and the served forest (phase 11
    (d) serves it again)."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.serve.engine as engine
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.data.pages import TransferStats
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.serve import BatchServer, ForestServer, PackedForest, ServeStats

    t_phase = time.perf_counter()
    totals: dict[str, int] = {}
    chunked = {"predict_forest": 0}

    def counted(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        return out, counts, seconds

    # (a) the booster's DMatrix front door
    pdm = PagedDMatrix(cache)
    n_pages, m = pdm.n_pages, pdm.num_features
    extents = pdm.page_set().page_extents
    worst = max(nr for _, nr in extents)
    direct = booster.predict_margin(X)
    front, counts, secs = counted(lambda: booster.predict_margin(pdm))
    print(f"serving (a): booster.predict_margin(PagedDMatrix) over {n_pages} pages of "
          f"{pdm.n_rows} x {m}: {secs:.3f} s, predict_forest launches "
          f"{counts['predict_forest']}, == predict_margin(X) (bitwise) "
          f"{np.array_equal(front, direct)}")
    if not np.array_equal(front, direct):
        raise SystemExit("predict_margin of the paged matrix differs from the raw rows'")
    if counts["predict_forest"] != n_pages:
        raise SystemExit(f"the DMatrix front door launched predict_forest "
                         f"{counts['predict_forest']} times over {n_pages} pages")
    del direct

    # (b) a served forest of 256 trees of depth 8 over the same pages
    depth, n_trees, tpc = 8, 256, 32
    feature, split_bin, default_left, is_leaf, leaf = serving_forest(
        seed, dev, n_trees, depth, m, scaled=False)
    forest = PackedForest(
        feature=feature, split_bin=split_bin,
        split_value=torch.zeros(feature.shape, dtype=torch.float32, device=dev),
        default_left=default_left, is_leaf=is_leaf, leaf_value=leaf, max_depth=depth,
        learning_rate=0.1, base_margin=float(booster.base_margin_),
        objective="binary:logistic", cuts=booster.cuts,
    )
    n_chunks = n_trees // tpc
    chunk_bytes = engine.chunk_bytes(forest, tpc)

    # the plain versions on the same pages: what (a) and every mode of (b) equal
    plain_a, plain_b = np.empty(pdm.n_rows, np.float32), np.empty(pdm.n_rows, np.float32)
    store, fitted = pdm.page_set().store, booster.packed_forest()
    t0 = time.perf_counter()
    for i, (ro, nr) in enumerate(extents):
        bins = torch.from_numpy(store.read_page(i)["bins"]).to(dev)
        plain_a[ro : ro + nr] = _plain_margins(fitted, bins).cpu().numpy()
        plain_b[ro : ro + nr] = _plain_margins(forest, bins).cpu().numpy()
    del bins
    print(f"serving (a): == the plain versions page by page (bitwise) "
          f"{np.array_equal(front, plain_a)} ({time.perf_counter() - t0:.3f} s for both "
          f"forests' plain margins)")
    if not np.array_equal(front, plain_a):
        raise SystemExit("predict_margin of the paged matrix differs from the plain versions")
    del front, plain_a
    data_bytes = pdm.n_rows * m
    # pins 4 of the 8 chunks beside one row page, plus less than one chunk
    budget = worst * m + 4 * chunk_bytes[0] + chunk_bytes[0] // 2
    plans = []
    plan_residency = engine.plan_residency

    def recorded(*a, **k):
        plans.append(plan_residency(*a, **k))
        return plans[-1]

    engine.plan_residency = recorded
    try:
        stats = TransferStats()
        resident, counts, secs = counted(
            lambda: engine.predict_margin_dmatrix(forest, pdm, stats=stats))
        print(f"serving (b) resident forest ({n_trees} trees, {forest.nbytes} B): {secs:.3f} s, "
              f"h2d {stats.host_to_device_bytes} B, predict_forest launches "
              f"{counts['predict_forest']}, == the plain versions page by page (bitwise) "
              f"{np.array_equal(resident, plain_b)}")
        if not np.array_equal(resident, plain_b):
            raise SystemExit("the resident served forest differs from the plain versions")
        if counts["predict_forest"] != n_pages or stats.host_to_device_bytes != data_bytes:
            raise SystemExit(f"resident serving: {counts}, h2d {stats.host_to_device_bytes}")
        modes = (
            ("unpinned", dict(pin_chunks=False),
             plan_residency(chunk_bytes, data_bytes, n_pages, None, pin=False)),
            ("budget", dict(serve_budget_bytes=budget),
             plan_residency(chunk_bytes, data_bytes, n_pages, budget, reserve_bytes=worst * m)),
            ("pin all", dict(pin_chunks=True),
             plan_residency(chunk_bytes, data_bytes, n_pages, None)),
        )
        for label, kw, want in modes:
            stats, sstats = TransferStats(), ServeStats()
            plans.clear()
            out, counts, secs = counted(lambda: engine.predict_margin_dmatrix(
                forest, pdm, trees_per_chunk=tpc, stats=stats, serve_stats=sstats, **kw))
            chunked["predict_forest"] += counts["predict_forest"]
            h2d = stats.host_to_device_bytes
            plan = plans[0] if plans else want
            # unpinned, the engine plans nothing: chunks outer, every chunk
            # pass re-streams the rows (the baseline bill)
            modeled = (plan.baseline_bytes if label == "unpinned"
                       else plan.bytes_chunks_outer if plan.order == "chunks_outer"
                       else plan.bytes_pages_outer)
            print(f"serving (b) {label}: {secs:.3f} s, "
                  f"{'no plan' if label == 'unpinned' else f'plan {plan}'}, h2d {h2d} B "
                  f"(modeled {modeled}, baseline {plan.baseline_bytes}), chunk hits "
                  f"{sstats.chunk_hits} misses {sstats.chunk_misses}, predict_forest "
                  f"launches {counts['predict_forest']}, == resident (bitwise) "
                  f"{np.array_equal(out, resident)}")
            if not np.array_equal(out, resident):
                raise SystemExit(f"serving mode {label!r} differs from the resident forest")
            if counts["predict_forest"] != n_chunks * n_pages:
                raise SystemExit(f"serving mode {label!r} launched predict_forest "
                                 f"{counts['predict_forest']} times, not chunks x pages")
            if label == "unpinned":  # the legacy bill: 8 row passes plus the chunks
                if plans or h2d != plan.baseline_bytes:
                    raise SystemExit(f"unpinned serving moved {h2d} B, not the chunks x "
                                     f"pages bill {plan.baseline_bytes}")
                continue
            if plan != want:
                raise SystemExit(f"serving mode {label!r} planned {plan}, expected {want}")
            if not h2d <= modeled < plan.baseline_bytes:
                raise SystemExit(f"serving mode {label!r} moved {h2d} B against the modeled "
                                 f"{modeled} and the baseline {plan.baseline_bytes}")
    finally:
        engine.plan_residency = plan_residency
    budget_plan, all_plan = modes[1][2], modes[2][2]
    # at full size: 8 chunks of 392,448 B, 15 pages of at most 67,108 rows
    if pdm.n_rows == 1_000_000 and not (
            budget_plan.n_pinned == 4 and budget_plan.order == "pages_outer"
            and budget_plan.bytes_pages_outer == 525_116_672
            and budget_plan.bytes_chunks_outer == 2_003_139_584
            and all_plan.n_pinned == 8 and all_plan.order == "chunks_outer"):
        raise SystemExit(f"the plans {budget_plan}, {all_plan} are not the stated arithmetic")

    # two requests through one server with the budget: pins persist
    sstats = ServeStats()
    server = ForestServer(forest, trees_per_chunk=tpc, serve_budget_bytes=budget,
                          serve_stats=sstats)
    per_request = []
    for i in range(2):
        before = dataclasses.replace(sstats, latencies_s=[])
        out, counts, secs = counted(lambda: server.predict_margin(pdm))
        chunked["predict_forest"] += counts["predict_forest"]
        per_request.append((sstats.chunk_hits - before.chunk_hits,
                            sstats.chunk_misses - before.chunk_misses,
                            sstats.h2d_bytes - before.h2d_bytes))
        print(f"serving (b) server request {i + 1}: {secs:.3f} s, chunk hits "
              f"{per_request[-1][0]} misses {per_request[-1][1]} h2d {per_request[-1][2]} B, "
              f"== resident (bitwise) {np.array_equal(out, resident)}")
        if not np.array_equal(out, resident):
            raise SystemExit(f"server request {i + 1} differs from the resident forest")
    print(f"serving (b) server residency: {json.dumps(server.residency())}")
    (hits_1, misses_1, h2d_1), (hits_2, misses_2, h2d_2) = per_request
    n_pin = server.cache.pinned_pages
    # the second request's pin prologue hits where the first one staged; what
    # misses is the unpinned remainder, at most once a chunk and page
    if not (n_pin == budget_plan.n_pinned and hits_2 >= hits_1 + n_pin
            and misses_2 <= misses_1 - n_pin
            and misses_2 <= (n_chunks - n_pin) * n_pages and h2d_2 < h2d_1):
        raise SystemExit(f"the second request staged pinned chunks or cost as much: "
                         f"{per_request}, {n_pin} pinned")

    # (c) single raw rows through the micro-batcher
    rows = np.ascontiguousarray(Xe[:4096])
    want = forest.predict_margin(rows)
    # the plain versions at the batch's shapes: binning, then the forest
    cuts = forest.cuts
    dtype = np.float32 if np.result_type(rows.dtype, np.float32) == np.float32 else np.float64
    plain_bins = ref.bin_values(
        torch.from_numpy(rows.astype(dtype)).to(dev),
        torch.from_numpy(cuts.padded_edges(max(cuts.max_n_bins, 1))).to(dev),
        torch.from_numpy(cuts.n_bins_per_feature.astype(np.int32)).to(dev))
    want_plain = _plain_margins(forest, plain_bins).cpu().numpy()
    print(f"serving (c): direct predict of {len(rows)} rows == the plain versions (bitwise) "
          f"{np.array_equal(want, want_plain)}")
    if not np.array_equal(want, want_plain):
        raise SystemExit("direct predict of the batch rows differs from the plain versions")
    for label, kw in (("resident", {}), ("32-tree chunks", dict(trees_per_chunk=tpc))):
        bstats = ServeStats()
        srv_forest = ForestServer(forest, **kw)

        def serve():
            with BatchServer(srv_forest.predict_margin, max_batch=256, max_delay_ms=2.0,
                             stats=bstats) as bs:
                futures = [bs.submit(r) for r in rows]
                return np.asarray([f.result(timeout=120.0) for f in futures], np.float32)

        got, counts, secs = counted(serve)
        print(f"serving (c) BatchServer, {label}: {bstats.requests} requests in "
              f"{bstats.batches} batches, {secs:.3f} s, p50 {bstats.p50_ms:.4f} ms p99 "
              f"{bstats.p99_ms:.4f} ms occupancy {bstats.occupancy:.4f} rows/s "
              f"{bstats.rows_per_s:.1f}, launches bin_values {counts['bin_values']} "
              f"predict_forest {counts['predict_forest']}, == direct predict and the plain "
              f"versions (bitwise) {np.array_equal(got, want) and np.array_equal(got, want_plain)}")
        if not (np.array_equal(got, want) and np.array_equal(got, want_plain)):
            raise SystemExit(f"BatchServer ({label}) differs from direct predict or the plain "
                             f"versions")
        if min(counts["bin_values"], counts["predict_forest"]) < bstats.batches:
            raise SystemExit(f"BatchServer ({label}) launched a kernel less than once a "
                             f"batch: {counts}, {bstats.batches} batches")
    print(f"serving path launches: {json.dumps(totals)} (predict_forest at the chunk "
          f"shape {chunked['predict_forest']})")
    if not all(totals[k] > 0 for k in ("predict_forest", "bin_values")):
        raise SystemExit(f"a kernel of the serving path was never launched: {totals}")

    # (d) kernel 3 at the chunk shape
    page = torch.from_numpy(pdm.page_set().store.read_page(0)["bins"]).to(dev)
    row = chunk_kernel_check(seed, dev, page, forest.chunk(0, tpc))
    row["launches"] = chunked["predict_forest"]
    print(f"serving phase: {time.perf_counter() - t_phase:.3f} s in all")
    return totals, row, forest


def _plain_margins(forest, bins):
    """``forest``'s margins over device ``bins`` through the plain version
    (`ref.predict_forest_bins`), after the eager leaf pre-scale and base
    margin that `PackedForest.predict_margin_bins` gives the kernel."""
    import torch

    from repro_torch.kernels import ref

    dev = bins.device
    lr = torch.tensor(forest.learning_rate, dtype=torch.float32, device=dev)
    base = torch.full((bins.shape[0],), forest.base_margin, dtype=torch.float32, device=dev)
    return ref.predict_forest_bins(
        bins, forest.feature, forest.split_bin, forest.default_left, forest.is_leaf,
        lr * forest.leaf_value.to(torch.float32), forest.max_depth, base)


def chunk_kernel_check(seed: int, dev, bins, chunk) -> dict:
    """Kernel 3 at the paged forest's chunk shape: ``chunk``'s trees (their
    leaves scaled as `ops.predict_forest` scales them) over one staged page
    with a random ``margin_in``, bit for bit against its plain version and
    itself, timed beside its bound as `forest_checks` times it. Returns its
    row of the kernels line; restores the launch count."""
    import torch

    from repro_torch.kernels import forest as k_forest
    from repro_torch.kernels import ref

    depth = chunk.max_depth
    lr = torch.tensor(chunk.learning_rate, dtype=torch.float32, device=dev)
    planes = (chunk.feature.contiguous(), chunk.split_bin.contiguous(),
              chunk.default_left.contiguous(), chunk.is_leaf.contiguous(),
              lr * chunk.leaf_value)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    m_in = torch.randn(bins.shape[0], generator=gen, device=dev)
    n, m = bins.shape
    n_trees, n_total = planes[0].shape
    saved = k_forest.launches

    def kern():
        return k_forest.predict_forest(bins, *planes, depth, m_in)

    def plain():
        return ref.predict_forest_bins(bins, *planes, depth, m_in)

    got, want = kern(), plain()
    if not (torch.equal(got, want) and torch.equal(got, kern())):
        err = (got - want).abs().max().item()
        raise SystemExit(f"forest kernel disagrees with its plain version at the chunk "
                         f"shape: max err {err}")
    visits, distinct = _forest_reads(bins, *planes[:4], depth)
    bound, by = _bound(distinct + n * 8 + n_trees * n_total * 14, n * n_trees)
    t = dict(ms=_time_ms(kern, 50), device_ms=_time_ms(kern, 50, queued=True),
             plain_ms=_time_ms(plain, 3))
    k_forest.launches = saved
    print(f"kernel predict_forest, chunk shape ({n} x {m} uint8, {n_trees} trees of depth "
          f"{depth}, a random margin_in, {visits} internal visits, {distinct} distinct bins "
          f"read): == the plain version and itself (bitwise); ms={t['ms']:.4f} "
          f"device_ms={t['device_ms']:.4f} plain_ms={t['plain_ms']:.4f} bound_ms={bound:.4f} "
          f"({by})")
    return dict(name="predict_forest", shape=f"chunk: {n_trees} trees x {n} rows",
                route="cuda", source="src/repro_torch/kernels/csrc/forest.cu",
                replaces="src/repro/kernels/forest.py:129", launches=0, max_abs_err=0.0,
                ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                bound_ms=bound, bound_by=by, library_ms=None)


def elastic_phase(seed: int, dev, params: dict, path_kernels) -> tuple[dict, dict, dict]:
    """Phase 8: the elastic multi-worker path (see the module docstring),
    with phase 10 (g) after run B. Returns the path's launch counts
    (coordinator plus run A's workers), the level-window kernel's row of the
    kernels line and phase 10 (g)'s launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.ellpack import rows_per_page
    from repro_torch.core.objectives import auc
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.dmatrix import IterDMatrix, PagedDMatrix
    from repro_torch.data.synthetic import make_classification
    from repro_torch.distributed import ElasticConfig, ElasticTrainer, prepare_shards
    from repro_torch.fault import FaultPlan, FaultSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts

    n_rows, n_trees, depth = 400_000, 4, params["max_depth"]
    t0 = time.perf_counter()
    X, y = make_classification(n_rows, PAPER.num_features, seed=seed)
    Xe, ye = make_classification(50_000, PAPER.num_features, seed=seed, batch=2)
    print(f"elastic data: {n_rows} x 500 train, 50000 x 500 eval, "
          f"{time.perf_counter() - t0:.1f} s")
    eparams = BoosterParams(**dict(params, n_estimators=n_trees))
    cfg = ElasticConfig(n_workers=2)
    kill = FaultPlan.of(FaultSpec(site="elastic.worker.iteration", at=3, action="kill",
                                  match={"worker": "w1"}))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as root:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dirs = prepare_shards(X, y, 2, f"{root}/shards", max_bin=PAPER.max_bin, page_bytes=PAGE_BYTES,
                              device=dev)
        prep_s = time.perf_counter() - t0
        shard_rows = [[nr for _, nr in PagedDMatrix(d).page_set().page_extents] for d in dirs]
        print(f"elastic shards: prepare_shards={prep_s:.3f} s (host sketch of all rows, "
              f"binning on the card, pages to disk); page rows per shard {shard_rows}")
        half, rpp = n_rows // 2, rows_per_page(500, PAGE_BYTES)
        if shard_rows != [[min(rpp, half - lo) for lo in range(0, half, rpp)]] * 2:
            raise SystemExit(f"unexpected shard pages {shard_rows}")

        runs = {}
        for label, plan in (("A", None), ("B", kill)):
            t0 = time.perf_counter()
            tr = ElasticTrainer(dirs, eparams, checkpoint_dir=f"{root}/ckpt_{label}",
                                config=cfg, fault_plan=plan, device=dev)
            booster = tr.fit()
            torch.cuda.synchronize()
            runs[label] = (tr, booster, time.perf_counter() - t0)
            if label == "A":
                margin = booster.predict_margin(Xe)  # the forest kernel, coordinator side
                path = launch_counts()
                for counts in tr.worker_launches.values():
                    for k, v in counts.items():
                        path[k] += v
        (tr_a, a, a_s), (tr_b, b, b_s) = runs["A"], runs["B"]
        per_worker = n_trees * depth * len(shard_rows[0])  # one shard per worker
        print(f"elastic run A: fit={a_s:.3f} s (2 worker starts included) per_tree_s="
              f"{[round(t, 4) for t in tr_a.tree_seconds]}")
        print(f"elastic run B (w1 killed at its 3rd begin_tree): fit={b_s:.3f} s "
              f"recoveries={tr_b.recoveries} recovery_s="
              f"{[round(t, 4) for t in tr_b.recovery_seconds]} per_tree_s="
              f"{[round(t, 4) for t in tr_b.tree_seconds]} (after the recovery w0 serves "
              f"both shards)")
        rpc = tr_a.rpc
        print(f"elastic pipes (run A): histogram bytes per level, both shards, per tree "
              f"{ {d: v // n_trees for d, v in sorted(rpc.hist_bytes_by_depth.items())} }; "
              f"hist rpc {rpc.calls['hist']} calls wall={rpc.wall_s['hist']:.3f} s "
              f"in workers={rpc.worker_s['hist']:.3f} s (pipe, pickle and waiting "
              f"{rpc.wall_s['hist'] - rpc.worker_s['hist']:.3f} s, "
              f"{rpc.reply_bytes['hist']} reply bytes); partition wall="
              f"{rpc.wall_s['partition']:.3f} s in workers={rpc.worker_s['partition']:.3f} s")
        print(f"elastic launches (run A, workers at shutdown): {json.dumps(tr_a.worker_launches)}; "
              f"path total {json.dumps(path)}")
        print("elastic events (run B): " + "; ".join(tr_b.events))
        if sorted(tr_a.worker_launches) != ["w0", "w1"] or not all(
            c["build_histogram"] == per_worker == c["partition_rows"]
            and c["build_histogram_nodes"] == 0
            for c in tr_a.worker_launches.values()
        ):
            raise SystemExit(f"the workers did not launch the level-window histogram and "
                             f"partition once per page and level ({per_worker}) and the "
                             f"node-set histogram never: {tr_a.worker_launches}")
        if not all(path[k] > 0 for k in path_kernels):
            raise SystemExit(f"a kernel of the elastic path was never launched: {path}")
        if not (tr_a.recoveries == 0 and tr_b.recoveries == 1
                and any("re-assigning shard 1 -> w0" in e for e in tr_b.events)
                and any("resumed 2 trees" in e for e in tr_b.events)):
            raise SystemExit(f"run B did not recover once by reassignment and resume: "
                             f"{tr_b.events}")
        if not (len(a.trees) == len(b.trees) == n_trees and all(
            torch.equal(u, v) for ta, tb in zip(a.trees, b.trees) for u, v in zip(ta, tb)
        )):
            raise SystemExit("the recovered forest differs from the uninterrupted one")
        print("elastic chaos: run B's forest == run A's (every TreeArrays field, bitwise)")

        single = GradientBooster(eparams, device=dev, policy=ExecutionPolicy(mode="out_of_core"))
        batches = [(X[i : i + 100_000], y[i : i + 100_000]) for i in range(0, n_rows, 100_000)]
        t0 = time.perf_counter()
        single.fit(IterDMatrix(batches, max_bin=PAPER.max_bin, cuts=a.cuts, cache_dir=f"{root}/single",
                               page_bytes=PAGE_BYTES, device=dev))
        single_s = time.perf_counter() - t0
        elastic_auc, single_auc = auc(ye, margin), auc(ye, single.predict_margin(Xe))
        print(f"elastic eval_auc after {n_trees} trees={elastic_auc:.6f} single-process "
              f"streaming={single_auc:.6f} (fit {single_s:.3f} s, {single.pages.n_pages} pages) "
              f"|diff|={abs(elastic_auc - single_auc):.6f}")
        if not (np.all(np.isfinite(margin)) and margin.shape == (50_000,)):
            raise SystemExit("elastic forest's margins are not finite")
        if abs(elastic_auc - single_auc) > AUC_TOLERANCE:
            raise SystemExit(f"elastic AUC {elastic_auc} vs single-process {single_auc}")
        lg_path = elastic_lossguide(dev, dirs, root, params, cfg, Xe, ye, a.cuts)

        elastic_transport_probe(dev, dirs[0], rpc.worker_s["hist"] / rpc.calls["hist"])
        host_pages = PagedDMatrix(dirs[0]).page_set().iter_pages()
        page = torch.from_numpy(next(host_pages)[1].bins).to(dev)
        for _ in host_pages:  # the prefetch thread's reads end before anything is timed
            pass
        row = window_kernel_check(seed, dev, page)
        split_chunk_check(seed, dev, page, a.cuts)
    return path, row, lg_path


def elastic_transport_probe(dev, shard_dir: str, worker_pass_s: float) -> None:
    """Where a worker's time goes: one shard's histogram pass (3 pages, the
    root level) run in this process, against the workers' mean hist-op
    seconds; and one 64-slot level histogram (65 MB) framed through a pipe
    between two threads of this process."""
    import os
    import threading

    import numpy as np
    import torch

    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.distributed.elastic import recv_msg_deadline, send_msg
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import ops

    dm = PagedDMatrix(shard_dir)
    ps = dm.page_set()
    g = torch.ones(dm.n_rows, device=dev)
    positions = {i: torch.zeros(nr, dtype=torch.int32, device=dev)
                 for i, (_, nr) in enumerate(ps.page_extents)}
    saved = k_hist.launches_window
    spans = []
    for _ in range(3):
        t0 = time.perf_counter()
        ops.build_histogram_paged(ps.stream(device=dev), g, g, positions, 0, 1, dm.n_bins)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
    k_hist.launches_window = saved
    hist = np.zeros((64, 500, 255, 2), np.float32)
    r, w = os.pipe()
    try:
        t0 = time.perf_counter()
        writer = threading.Thread(target=send_msg, args=(w, {"hist": hist}))
        writer.start()
        _, nbytes = recv_msg_deadline(r, time.monotonic() + 120)
        writer.join()
        pipe_s = time.perf_counter() - t0
    finally:
        os.close(r)
        os.close(w)
    print(f"elastic transport: one shard's histogram pass ({ps.n_pages} pages) in this "
          f"process {[round(t, 4) for t in spans]} s against {worker_pass_s:.4f} s per hist "
          f"op in the workers; a {nbytes}-byte histogram frame through a pipe (two threads) "
          f"{pipe_s:.4f} s = {nbytes / pipe_s / 1e9:.3f} GB/s")


def window_kernel_check(seed: int, dev, page) -> dict:
    """The level-window kernel on one staged page at level 7 of a depth-8
    tree (128 level nodes, 64 build slots and 64 derived, 10% of rows
    inactive, 5% past the window): against its plain version, bit for bit
    against the node-set kernel on the equivalent build nodes, and timed
    beside its bound and one library call. Restores the launch counts."""
    import torch

    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import ref

    n, m = page.shape
    n_bins = 255
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    pos = torch.randint(0, 128, (n,), generator=gen, device=dev, dtype=torch.int32)
    pos[torch.rand(n, generator=gen, device=dev) < 0.05] += 128
    pos[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    left = torch.randint(0, 2, (64,), generator=gen, device=dev).bool()
    slots = torch.arange(64, device=dev, dtype=torch.int32)
    minus = torch.full_like(slots, -1)
    node_map = torch.stack([torch.where(left, slots, minus), torch.where(left, minus, slots)],
                           dim=1).reshape(128)
    build_nodes = 127 + 2 * slots + (~left).to(torch.int32)
    glob = torch.where(pos >= 0, pos + 127, -1)

    def k4():
        return k_hist.build_histogram(page, g, h, pos, 64, n_bins, node_map)

    def plain():
        return ref.build_histogram(page, g, h, pos, 64, n_bins, node_map)

    saved = k_hist.launches, k_hist.launches_window
    got, want = k4(), plain()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"level-window kernel disagrees with its plain version: max err {err}")
    if not torch.equal(got, ref.build_histogram_fixed(page, g, h, pos, 64, n_bins, node_map)):
        raise SystemExit("level-window kernel differs from the fixed-point plain version")
    if not torch.equal(got, k_hist.build_histogram_nodes(page, g, h, glob, build_nodes, n_bins)):
        raise SystemExit("level-window kernel differs from the node-set kernel on the "
                         "equivalent build nodes")
    if not torch.equal(got, k4()):
        raise SystemExit("level-window kernel is not deterministic run to run")
    wb, wb_by, lib_ms, n_matched = _hist_yardsticks(
        page, g, h, ref.apply_node_map(pos, node_map).long(), 64, 128
    )
    row = dict(
        name="build_histogram", route="cuda",
        source="src/repro_torch/kernels/csrc/hist_window.cu",
        replaces="src/repro/kernels/histogram.py:158",
        max_abs_err=err, ms=_time_ms(k4, 10), device_ms=_time_ms(k4, 10, queued=True),
        plain_ms=_time_ms(plain, 2), bound_ms=wb, bound_by=wb_by, library_ms=lib_ms,
    )
    k_hist.launches, k_hist.launches_window = saved
    print(f"kernel build_histogram on a staged page ({n} x {m} uint8, level 7, 64 of 128 "
          f"nodes built, {n_matched} rows matched): max_abs_err={err:.3g} (rtol=atol=1e-5), "
          f"== the fixed-point plain version and build_histogram_nodes on the equivalent "
          f"build nodes (bitwise); "
          f"ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} bound_ms={wb:.4f} ({wb_by}) "
          f"plain_ms={row['plain_ms']:.4f} library_ms={lib_ms:.4f} (index_put_ accumulate)")
    return row


def split_chunk_check(seed: int, dev, page, cuts) -> None:
    """Split evaluation of a full 128-node level (128 x 500 x 255, built by
    the level-window kernel on one page) in node chunks against one chunk:
    every field equal; prints both times and their temporaries' peaks."""
    import torch

    from repro_torch.core import split as split_mod
    from repro_torch.core.booster import bin_valid_from_cuts
    from repro_torch.kernels import histogram as k_hist

    n = page.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    pos = torch.randint(0, 128, (n,), generator=gen, device=dev, dtype=torch.int32)
    pos[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    saved = k_hist.launches_window
    hist = k_hist.build_histogram(page, g, h, pos, 128, 255)
    k_hist.launches_window = saved
    live = pos >= 0
    node_g = torch.zeros(128, device=dev).index_add_(0, pos[live].long(), g[live])
    node_h = torch.zeros(128, device=dev).index_add_(0, pos[live].long(), h[live])
    args = (hist, node_g, node_h, bin_valid_from_cuts(cuts, 255, dev), split_mod.SplitParams())
    chunk_bytes = split_mod.CHUNK_BYTES
    out, ms, peak = {}, {}, {}
    try:
        for label, cb in (("chunked", chunk_bytes), ("one_chunk", 1 << 62)):
            split_mod.CHUNK_BYTES = cb
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out[label] = split_mod.evaluate_splits(*args)
            torch.cuda.synchronize()
            peak[label] = torch.cuda.max_memory_allocated(dev) - base
            ms[label] = _time_ms(lambda: split_mod.evaluate_splits(*args), 3)
    finally:
        split_mod.CHUNK_BYTES = chunk_bytes
    fields = out["chunked"].__dataclass_fields__
    if not all(torch.equal(getattr(out["chunked"], f), getattr(out["one_chunk"], f))
               for f in fields):
        raise SystemExit("chunked split evaluation differs from one chunk")
    nodes = max(1, chunk_bytes // (500 * 255 * 4))
    print(f"split evaluation at 128 x 500 x 255: chunks of {nodes} nodes == one chunk "
          f"(every field, bitwise); chunked {ms['chunked']:.3f} ms, peak "
          f"{peak['chunked']} B above its input; one chunk {ms['one_chunk']:.3f} ms, peak "
          f"{peak['one_chunk']} B")


def _peak_breakdown(trace: list[dict]) -> tuple[int, list[tuple[str, int, int]]]:
    """Replays a CUDA allocator trace (``torch.cuda.memory._snapshot()``):
    the most bytes its own allocations held at once, and what was live at
    that moment as (allocation site, bytes, blocks), largest first. A site
    is the innermost frame in ``repro_torch``."""
    live: dict[int, tuple[int, str]] = {}
    total = peak = 0
    at_peak: dict[int, tuple[int, str]] = {}
    for ev in trace:
        if ev["action"] == "alloc":
            site = next(
                (f"{f['filename'].split('repro_torch/')[-1]}:{f['line']} {f['name']}"
                 for f in ev.get("frames", ()) if "repro_torch" in f["filename"]),
                "outside repro_torch",
            )
            live[ev["addr"]] = (ev["size"], site)
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free_completed") and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    sites: dict[str, tuple[int, int]] = {}
    for size, site in at_peak.values():
        nbytes, blocks = sites.get(site, (0, 0))
        sites[site] = (nbytes + size, blocks + 1)
    return peak, sorted(((s, b, c) for s, (b, c) in sites.items()), key=lambda r: -r[1])


def page_kernel_checks(seed: int, dev, sdm, tree) -> None:
    """Phase 6: the histogram and partition kernels at the streaming path's
    shape, on pages as the pinned ring and the side stream stage them,
    against their plain versions; then the page-summed histogram of one
    whole pass against the plain histogram of the concatenated pages.
    Restores the launch counts."""
    import torch

    from repro_torch.core.histcache import level_row_counts
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import partition as k_part

    n = sdm.n_rows
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    pick = torch.randint(0, 2, (64,), generator=gen, device=dev, dtype=torch.int32)
    nodes = 127 + 2 * torch.arange(64, device=dev, dtype=torch.int32) + pick
    positions = {}  # level 7 of a depth-8 tree, 10% inactive, as in phase 3
    for i, (_, nr) in enumerate(sdm.page_set().page_extents):
        pos = torch.randint(127, 255, (nr,), generator=gen, device=dev, dtype=torch.int32)
        pos[torch.rand(nr, generator=gen, device=dev) < 0.1] = -1
        positions[i] = pos
    part_args = (tree.feature, tree.split_bin, tree.default_left, tree.is_leaf)
    saved = k_hist.launches, k_part.launches
    hist_err, pages, fixed_sum = 0.0, {}, None
    window = (127, 128)  # level 7's nodes: the counts after level 6's partition
    counts = torch.zeros(128, dtype=torch.int32, device=dev)
    moved = {}  # per page, the plain version's new positions
    for sp in sdm.page_set().stream(device=dev, staging_depth=2):
        ro, nr = sp.host.row_offset, sp.host.n_rows
        args = (sp.device, g[ro : ro + nr], h[ro : ro + nr], positions[sp.index], nodes, 255)
        got, want = k_hist.build_histogram_nodes(*args), ref.build_histogram_nodes(*args)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"histogram kernel disagrees with its plain version on "
                             f"streamed page {sp.index}: max err {err}")
        fixed = ref.build_histogram_nodes_fixed(*args)
        if not torch.equal(got, fixed):
            raise SystemExit(f"histogram kernel differs from the fixed-point plain version on "
                             f"streamed page {sp.index}")
        fixed_sum = fixed if fixed_sum is None else fixed_sum.add_(fixed)
        hist_err = max(hist_err, err)
        del got, want, fixed
        level_pos = torch.zeros(nr, dtype=torch.int32, device=dev)
        for _ in range(6):  # rows at level 6 of the first tree
            level_pos = ref.partition_rows(sp.device, level_pos, *part_args)
        level_pos[torch.rand(nr, generator=gen, device=dev) < 0.05] = -1
        moved[sp.index] = ref.partition_rows(sp.device, level_pos, *part_args)
        # one counts buffer for every page, as the streaming path passes it
        if not torch.equal(k_part.partition_rows(sp.device, level_pos, *part_args, window,
                                                 counts), moved[sp.index]):
            raise SystemExit(f"partition kernel disagrees with its plain version on "
                             f"streamed page {sp.index}")
        if sp.index == 0:  # timed while the prefetch thread reads the next pages
            first = args
            hist_k = functools.partial(k_hist.build_histogram_nodes, *args)
            scratch = torch.zeros_like(counts)

            def part_k(pos=level_pos, page=sp.device):
                return k_part.partition_rows(page, pos, *part_args, window, scratch)

            def part_seq(pos=level_pos, page=sp.device):  # what a page cost before
                new = k_part.partition_rows(page, pos, *part_args)
                return scratch + level_row_counts(new, *window)

            t = dict(hist=_time_ms(hist_k, 10), hist_dev=_time_ms(hist_k, 10, queued=True),
                     part=_time_ms(part_k, 20), part_dev=_time_ms(part_k, 20, queued=True),
                     seq=_time_ms(part_seq, 20), seq_dev=_time_ms(part_seq, 20, queued=True))
        pages[sp.index] = sp.device
    t["bound"], t["by"], t["lib"], _ = _hist_yardsticks(
        *first[:3], ref.row_slots(first[3], nodes).long(), 64, 64
    )
    t["table"], t["search"] = _slot_lookup_ms(*first[:4], nodes)
    order = sorted(pages)
    if not torch.equal(counts, ref.level_row_counts(torch.cat([moved[i] for i in order]),
                                                    *window)):
        raise SystemExit("partition counts summed over the pages differ from the counts of "
                         "the concatenated positions")
    paged = ops.build_histogram_paged(
        sdm.page_set().stream(device=dev, staging_depth=2), g, h, positions, 0, 64, 255,
        build_nodes=nodes,
    )
    whole = ref.build_histogram_nodes(
        torch.cat([pages[i] for i in order]), g, h, torch.cat([positions[i] for i in order]),
        nodes, 255,
    )
    sum_err = (paged - whole).abs().max().item()
    if not torch.allclose(paged, whole, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"page-summed histogram disagrees with the plain histogram of "
                         f"the concatenated pages: max err {sum_err}")
    if not torch.equal(paged, fixed_sum):
        raise SystemExit("page-summed histogram (added into by the kernel) differs from the "
                         "fixed-point plain pages summed with add_")
    k_hist.launches, k_part.launches = saved
    print(
        f"streaming kernels on {len(order)} staged pages ({pages[0].shape[0]} x "
        f"{pages[0].shape[1]} uint8 each): histogram max_abs_err={hist_err:.3g} "
        f"(rtol=atol=1e-5) and == the fixed-point plain version on every page (bitwise), "
        f"partition equal; page-summed histogram == the fixed-point pages summed with add_ "
        f"(bitwise), vs plain over the concatenated pages max_abs_err={sum_err:.3g}; "
        f"partition with level 7's counts added over all pages into one buffer == "
        f"level_row_counts of the concatenated positions; at page "
        f"0 histogram ms={t['hist']:.4f} device_ms={t['hist_dev']:.4f} bound_ms={t['bound']:.4f} "
        f"({t['by']}) library_ms={t['lib']:.4f} (index_put_ accumulate), partition with counts "
        f"ms={t['part']:.4f} device_ms={t['part_dev']:.4f} against the kernel, "
        f"level_row_counts and the add ms={t['seq']:.4f} device_ms={t['seq_dev']:.4f}; "
        f"histogram slot lookup by id table "
        f"device_ms={t['table']:.4f}, by search (one far empty node added, same bits) "
        f"device_ms={t['search']:.4f}"
    )


def _hist_yardsticks(bins, g, h, slot, n_slots: int, table_len: int, n_bins: int = 255):
    """(bound ms, bound_by, index_put_ ms, matched rows) of a histogram over
    the rows whose slot (int64) is >= 0: the bound counts the bin row and g,
    h of each matched row, every position, the node table or map, and the
    output; the library call scatters the same cells with index_put_."""
    import torch

    n, m = bins.shape
    valid = (bins != 255) & (slot[:, None] >= 0)
    cell = (slot[:, None] * (m * n_bins) + torch.arange(m, device=bins.device) * n_bins
            + bins)[valid]
    rows = torch.nonzero(valid)[:, 0]
    gh = torch.stack([g[rows], h[rows]], dim=1)
    del valid, rows
    lib_out = torch.zeros(n_slots * m * n_bins, 2, device=bins.device)
    lib_ms = _time_ms(lambda: lib_out.index_put_((cell,), gh, accumulate=True), 3)
    del cell, gh, lib_out
    n_matched = int((slot >= 0).sum())
    bound, by = _bound(
        n_matched * (m * bins.element_size() + 8) + 4 * n + 4 * table_len
        + n_slots * m * n_bins * 8,
        2.0 * n_matched * m,
    )
    return bound, by, lib_ms, n_matched


def _slot_lookup_ms(bins, g, h, pos, nodes, n_bins: int = 255) -> tuple[float, float]:
    """Kernel 1's device ms with its slot lookup by id table (the build
    nodes span fewer than 4,096 ids) and by search of the build-node list,
    forced by one more build node far from the rest that no row matches:
    the search's first slots must give the table's bits, its last none."""
    import torch

    from repro_torch.kernels import histogram as k_hist

    far = torch.cat([nodes, nodes.new_tensor([1 << 30])])
    table = functools.partial(k_hist.build_histogram_nodes, bins, g, h, pos, nodes, n_bins)
    search = functools.partial(k_hist.build_histogram_nodes, bins, g, h, pos, far, n_bins)
    got, wide = table(), search()
    if not torch.equal(wide[:-1], got) or wide[-1].any():
        raise SystemExit("kernel 1's search of the build nodes differs from its id table")
    return _time_ms(table, 10, queued=True), _time_ms(search, 10, queued=True)


def level_times(bins, g, h, tree, per_tree_s: float) -> None:
    """Kernel 1 at each level of the in-core booster's first tree, on all
    training rows: the rows' positions from repeated partitions by the
    tree, and the build set the histogram store plans (the smaller child of
    each split pair, the root at level 0). Prints S, matched rows, ms and
    the bound per level, and their sum beside the in-core seconds per tree."""
    import torch

    from repro_torch.core.histcache import level_row_counts, plan_level
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import ref

    n, m = bins.shape
    dev = bins.device
    part_args = (tree.feature, tree.split_bin, tree.default_left, tree.is_leaf)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    total_ms = total_dev = total_bound = 0.0
    for depth in range(tree.max_depth):
        count = 1 << depth
        if depth == 0:
            nodes = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            _, build_left = plan_level(count, level_row_counts(pos, count - 1, count))
            nodes = (count - 1 + 2 * torch.arange(count // 2, dtype=torch.int32, device=dev)
                     + (~build_left).to(torch.int32))
        matched = int(torch.isin(pos, nodes).sum())
        def k1():
            return k_hist.build_histogram_nodes(bins, g, h, pos, nodes, 255)

        ms, dev_ms = _time_ms(k1, 5), _time_ms(k1, 5, queued=True)
        s = nodes.shape[0]
        bound, by = _bound(matched * (m + 8) + 4 * n + 4 * s + s * m * 255 * 8, 2.0 * matched * m)
        total_ms += ms
        total_dev += dev_ms
        total_bound += bound
        print(f"  kernel build_histogram_nodes, tree 0 level {depth}: S={s} matched_rows={matched} "
              f"ms={ms:.4f} device_ms={dev_ms:.4f} bound_ms={bound:.4f} ({by})")
        pos = ref.partition_rows(bins, pos, *part_args)
    print(f"  kernel build_histogram_nodes, tree 0, all levels: ms={total_ms:.4f} "
          f"device_ms={total_dev:.4f} bound_ms={total_bound:.4f} against the in-core "
          f"per_tree={per_tree_s * 1e3:.4f} ms")


def partition_level_times(bins, tree) -> None:
    """The partition kernel with the next level's counts folded in, against
    the sequence it replaces (the kernel without counts, then
    `level_row_counts` of its positions), at every level of the in-core
    booster's first tree that counts a next level: the rows' real positions,
    all training rows. Each side as a level of the path pays it, a fresh
    zeroed counts buffer included; both give the same positions and counts."""
    import torch

    from repro_torch.core.histcache import level_row_counts
    from repro_torch.kernels import partition as k_part
    from repro_torch.kernels import ref

    dev = bins.device
    part_args = (tree.feature, tree.split_bin, tree.default_left, tree.is_leaf)
    pos = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
    totals = [0.0] * 5
    for depth in range(tree.max_depth - 1):
        window = (2 ** (depth + 1) - 1, 2 ** (depth + 1))

        def fused(pos=pos, window=window):
            counts = torch.zeros(window[1], dtype=torch.int32, device=dev)
            return k_part.partition_rows(bins, pos, *part_args, window, counts), counts

        def sequence(pos=pos, window=window):
            new = k_part.partition_rows(bins, pos, *part_args)
            return new, level_row_counts(new, *window)

        def alone(pos=pos):
            return k_part.partition_rows(bins, pos, *part_args)

        (fp, fc), (qp, qc) = fused(), sequence()
        if not (torch.equal(fp, qp) and torch.equal(fc, qc)):
            raise SystemExit(f"fused partition + counts differs from the sequence at level "
                             f"{depth}")
        t = (_time_ms(fused, 20), _time_ms(fused, 20, queued=True),
             _time_ms(sequence, 20), _time_ms(sequence, 20, queued=True),
             _time_ms(alone, 20, queued=True))
        totals = [a + b for a, b in zip(totals, t)]
        print(f"  partition + counts, tree 0 level {depth} (window {window}, "
              f"{int(fc.sum())} rows counted): fused ms={t[0]:.4f} device_ms={t[1]:.4f}; "
              f"sequence ms={t[2]:.4f} device_ms={t[3]:.4f}; fused faster: "
              f"{t[0] < t[2] and t[1] < t[3]}; the kernel without counts device_ms={t[4]:.4f}")
        pos = ref.partition_rows(bins, pos, *part_args)
    print(f"  partition + counts, tree 0, levels 0-{tree.max_depth - 2}: fused "
          f"ms={totals[0]:.4f} device_ms={totals[1]:.4f}; sequence ms={totals[2]:.4f} "
          f"device_ms={totals[3]:.4f}; the kernel without counts device_ms={totals[4]:.4f}")


def predict_split(booster, Xe, margin, dev) -> None:
    """Where the in-core ``predict=`` milliseconds go: a second predict of
    the eval rows, step by step as ``predict_margin`` takes them (the binner
    built from the cuts; per chunk of one page's rows, the pageable
    host-to-device copy of the raw rows, host clock, synchronised; the
    binning kernel and the placement of its bins, CUDA events; then the
    forest, CUDA events: the eager leaf pre-scale, the packing and the walk;
    and the copy of the margins back, host clock). The margins must equal the
    first predict's. Restores the binning and forest launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.ellpack import Binner
    from repro_torch.kernels import ellpack_bin as k_bin
    from repro_torch.kernels import forest as k_forest

    forest = booster.packed_forest()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    saved = k_bin.launches, k_forest.launches
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    binner = Binner(booster.cuts, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_all
    dtype = np.float32 if np.result_type(Xe.dtype, np.float32) == np.float32 else np.float64
    bins = torch.empty((len(Xe), binner.num_features), dtype=torch.uint8, device=dev)
    h2d_s = bin_s = 0.0
    for lo in range(0, len(Xe), binner.chunk_rows):
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(Xe[lo : lo + binner.chunk_rows], dtype)).to(dev)
        torch.cuda.synchronize()
        h2d_s += time.perf_counter() - t0
        start.record()
        bins[lo : lo + x.shape[0]] = k_bin.bin_values(x, binner.edges, binner.n_bins)
        end.record()
        end.synchronize()
        bin_s += start.elapsed_time(end) / 1e3
    start.record()
    out = forest.predict_margin_bins(bins)
    end.record()
    end.synchronize()
    forest_s = start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    host = out.cpu().numpy()
    d2h_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_all
    n_chunks = k_bin.launches - saved[0]
    k_bin.launches, k_forest.launches = saved
    if not np.array_equal(host, margin):
        raise SystemExit("the predict split's margins differ from the in-core predict")
    print(f"predict split (a second predict of the {len(Xe)} eval rows, {n_chunks} chunks of "
          f"{binner.chunk_rows} rows, {np.dtype(dtype).name}): binner set-up "
          f"{setup_s * 1e3:.3f} ms, host-to-device copy {h2d_s * 1e3:.3f} ms, binning kernel "
          f"and placement {bin_s * 1e3:.4f} ms (CUDA events), forest (leaf pre-scale, packing "
          f"and walk) {forest_s * 1e3:.4f} ms (CUDA events), copy back {d2h_s * 1e3:.3f} ms, "
          f"total {total_s * 1e3:.3f} ms")


def binning_split(dm, X, dev) -> None:
    """Where the in-core binning's seconds (`binning=`) go: a second pass over
    the chunks `Binner.to_host` bins (one page of rows each), timing the
    pageable host-to-device copy of the raw rows (host clock, synchronised),
    the kernel (CUDA events) and the copy back into the host matrix (host
    clock). The bins must equal the in-core matrix's. Restores the binning
    kernel's launch count."""
    import numpy as np
    import torch

    from repro_torch.core.ellpack import Binner
    from repro_torch.kernels import ellpack_bin as k_bin

    binner = Binner(dm.cuts, dev)
    dtype = np.float32 if np.result_type(X.dtype, np.float32) == np.float32 else np.float64
    out = np.empty((len(X), binner.num_features), np.uint8)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    saved = k_bin.launches
    h2d_s = kernel_s = d2h_s = 0.0
    t_all = time.perf_counter()
    for lo in range(0, len(X), binner.chunk_rows):
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(X[lo : lo + binner.chunk_rows], dtype)).to(dev)
        torch.cuda.synchronize()
        h2d_s += time.perf_counter() - t0
        start.record()
        bins = k_bin.bin_values(x, binner.edges, binner.n_bins)
        end.record()
        end.synchronize()
        kernel_s += start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        out[lo : lo + bins.shape[0]] = bins.cpu().numpy()
        d2h_s += time.perf_counter() - t0
    total_s = time.perf_counter() - t_all
    n_chunks, k_bin.launches = k_bin.launches - saved, saved
    if not np.array_equal(out, dm.single_page_bins()):
        raise SystemExit("the binning split's bins differ from the in-core matrix")
    print(f"binning split (a second pass, {n_chunks} chunks of {binner.chunk_rows} rows, "
          f"{np.dtype(dtype).name}): host-to-device copy {h2d_s:.3f} s, kernel {kernel_s:.4f} s "
          f"(CUDA events), copy back and placement {d2h_s:.3f} s, total {total_s:.3f} s")


def serving_forest(seed: int, dev, n_trees: int, depth: int, m: int, scaled: bool = True):
    """A served forest's planes, made on the card from ``seed``: complete
    layout, the last level all leaves and about 10% early leaves above it,
    features in [0, m), split bins in [0, 254], random default_left, and
    normal leaf values pre-scaled by the paper config's lr 0.1 (one eager
    multiply), or left unscaled with ``scaled=False`` (for a `PackedForest`,
    whose launches scale them)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    shape = (n_trees, 2 ** (depth + 1) - 1)
    feature = torch.randint(0, m, shape, generator=gen, device=dev, dtype=torch.int32)
    split_bin = torch.randint(0, 255, shape, generator=gen, device=dev, dtype=torch.int32)
    default_left = torch.rand(shape, generator=gen, device=dev) < 0.5
    is_leaf = torch.rand(shape, generator=gen, device=dev) < 0.1
    is_leaf[:, 2**depth - 1:] = True
    leaf = torch.randn(shape, generator=gen, device=dev)
    if scaled:
        leaf = torch.tensor(0.1, dtype=torch.float32, device=dev) * leaf
    return feature, split_bin, default_left, is_leaf, leaf


def _forest_reads(bins, feature, split_bin, default_left, is_leaf, max_depth: int):
    """(internal nodes the rows visit, distinct (row, feature) bins those
    visits read): what this run's data needs of the bins."""
    import torch

    n, m = bins.shape
    dev = bins.device
    flat_rows = torch.arange(n, device=dev, dtype=torch.int64) * m
    touched = torch.zeros(n * m + 1, dtype=torch.bool, device=dev)  # last: no bin
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(feature.shape[0]):
        p = torch.zeros(n, dtype=torch.int64, device=dev)
        for _ in range(max_depth):
            inner = ~is_leaf[t][p]
            visits += inner.sum()
            f_idx = feature[t][p].long().clamp_(0, m - 1)
            touched[torch.where(inner, flat_rows + f_idx, n * m)] = True
            b = bins.gather(1, f_idx[:, None])[:, 0].int()
            left = torch.where(b == 255, default_left[t][p], b <= split_bin[t][p])
            p = torch.where(inner, 2 * p + 1 + (~left).long(), p)
    return int(visits), int(touched[:-1].sum())


def forest_checks(seed: int, dev, booster, eval_bins, train_bins) -> dict:
    """Kernel 3 at two shapes: the fitted shape (the in-core booster's forest
    over the 100k eval rows) and a serving shape (`serving_forest`: 256 trees
    of depth 8 over the 1M training rows). At each, bit for bit against the
    plain version and itself, timed beside its bound, the plain version and
    one read of the same bins (their bytes summed as float32 words). The
    bound counts the distinct bins the walks read, each once, plus margins
    in and out and the five planes; the per-visit count of earlier runs
    (one bin byte each internal node visited) is printed beside it. Returns
    the fitted shape's row of the kernels line; restores the launch count."""
    import torch

    from repro_torch.kernels import forest as k_forest
    from repro_torch.kernels import ref

    forest = booster.packed_forest()
    depth, m = forest.max_depth, eval_bins.shape[1]
    lr = torch.tensor(forest.learning_rate, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    shapes = (
        ("fitted", eval_bins, (forest.feature, forest.split_bin, forest.default_left,
                               forest.is_leaf, lr * forest.leaf_value),
         torch.full((eval_bins.shape[0],), forest.base_margin, device=dev), 20, 3),
        ("serving", train_bins, serving_forest(seed, dev, 256, depth, m),
         torch.randn(train_bins.shape[0], generator=gen, device=dev), 10, 1),
    )
    saved = k_forest.launches
    row = None
    for label, bins, planes, m_in, iters, plain_iters in shapes:
        n, n_trees, n_total = bins.shape[0], *planes[0].shape

        def kern():
            return k_forest.predict_forest(bins, *planes, depth, m_in)

        def plain():
            return ref.predict_forest_bins(bins, *planes, depth, m_in)

        got = kern()
        if not torch.equal(got, plain()):
            err = (got - plain()).abs().max().item()
            raise SystemExit(f"forest kernel disagrees with its plain version at the {label} "
                             f"shape: max err {err}")
        if not torch.equal(got, kern()):
            raise SystemExit(f"forest kernel is not deterministic at the {label} shape")
        del got
        visits, distinct = _forest_reads(bins, *planes[:4], depth)
        rest = n * 8 + n_trees * n_total * 14  # margins in and out, the planes
        bound, by = _bound(distinct + rest, n * n_trees)
        per_visit, _ = _bound(visits + rest, n * n_trees)
        # one read of the same bytes: torch sums uint8 through int64 at a
        # fraction of the memory's rate, float32 words at nearly all of it
        words = bins.view(-1)[: bins.numel() // 4 * 4].view(torch.float32)
        t = dict(ms=_time_ms(kern, iters), device_ms=_time_ms(kern, iters, queued=True),
                 plain_ms=_time_ms(plain, plain_iters),
                 read_ms=_time_ms(lambda: words.sum(), iters, queued=True))
        print(f"kernel predict_forest, {label} shape ({n} x {m} uint8, {n_trees} trees of "
              f"depth {depth}, {visits} internal visits, {distinct} distinct bins read): "
              f"== the plain version and itself (bitwise); ms={t['ms']:.4f} "
              f"device_ms={t['device_ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"bound_ms={bound:.4f} ({by}; a bin byte each internal visit instead: "
              f"{per_visit:.4f}) reading the bins once (a sum of their bytes as float32 "
              f"words) device_ms={t['read_ms']:.4f}")
        if row is None:
            row = dict(name="predict_forest", route="cuda",
                       source="src/repro_torch/kernels/csrc/forest.cu",
                       replaces="src/repro/kernels/forest.py:129", max_abs_err=0.0,
                       ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                       bound_ms=bound, bound_by=by, library_ms=None)
        del planes, m_in
    k_forest.launches = saved
    return row


def kernel_checks(seed: int, dev, dm, booster, X, Xe, per_tree_s: float) -> list[dict]:
    """Phase 3: each kernel against its plain version at the paths' shapes,
    timed beside its bound and a library call; restores the launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.ellpack import Binner, bin_batch, rows_per_page
    from repro_torch.kernels import ellpack_bin as k_bin
    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import partition as k_part
    from repro_torch.kernels import ref

    bins = torch.from_numpy(dm.single_page_bins()).to(dev)
    eval_bins = Binner(booster.cuts, dev).to_device(Xe)
    n, m = bins.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev)
    # deepest built level of a depth-8 tree: rows spread over level 7's 128
    # nodes (ids 127..254), 10% inactive; the smaller child of each pair built
    pos = torch.randint(127, 255, (n,), generator=gen, device=dev, dtype=torch.int32)
    pos[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    pick = torch.randint(0, 2, (64,), generator=gen, device=dev, dtype=torch.int32)
    nodes = 127 + 2 * torch.arange(64, device=dev, dtype=torch.int32) + pick
    n_bins = 255
    results = []

    def hist_k():
        return k_hist.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)

    def hist_p():
        return ref.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)

    saved = k_hist.launches
    got, want = hist_k(), hist_p()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"histogram kernel disagrees with its plain version: max err {err}")
    if not torch.equal(got, ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, n_bins)):
        raise SystemExit("histogram kernel differs from the fixed-point plain version")
    if not torch.equal(got, hist_k()):
        raise SystemExit("histogram kernel is not deterministic run to run")
    del got, want
    hb, hb_by, lib_ms, n_matched = _hist_yardsticks(
        bins, g, h, ref.row_slots(pos, nodes).long(), 64, 64
    )
    results.append(dict(
        name="build_histogram_nodes", route="cuda",
        source="src/repro_torch/kernels/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram.py:214",
        max_abs_err=err, ms=_time_ms(hist_k, 5), device_ms=_time_ms(hist_k, 5, queued=True),
        plain_ms=_time_ms(hist_p, 2), bound_ms=hb, bound_by=hb_by, library_ms=lib_ms,
    ))
    print(f"kernel build_histogram_nodes ({n} x {m} uint8, {n_bins} bins, 64 of 128 nodes "
          f"built, {n_matched} rows matched): == the fixed-point plain version (bitwise); "
          f"ms={results[-1]['ms']:.4f} device_ms={results[-1]['device_ms']:.4f} "
          f"bound_ms={hb:.4f} ({hb_by}) library_ms={lib_ms:.4f} (index_put_ accumulate)")
    lookup = _slot_lookup_ms(bins, g, h, pos, nodes)
    print(f"  slot lookup at this shape: id table device_ms={lookup[0]:.4f}, search of the "
          f"build nodes (one far empty node added, same bits) device_ms={lookup[1]:.4f}")
    t0_tree = booster.trees[0]
    level_times(bins, g, h, t0_tree, per_tree_s)
    k_hist.launches = saved

    level_pos = torch.zeros(n, dtype=torch.int32, device=dev)
    part_args = (t0_tree.feature, t0_tree.split_bin, t0_tree.default_left, t0_tree.is_leaf)
    for _ in range(6):  # rows at level 6 of the first tree: the 7th partition's input
        level_pos = ref.partition_rows(bins, level_pos, *part_args)
    level_pos[torch.rand(n, generator=gen, device=dev) < 0.05] = -1
    saved = k_part.launches
    window = (127, 128)  # level 7's nodes, the counts the histogram store plans by
    got_c, want_c = (torch.zeros(128, dtype=torch.int32, device=dev) for _ in range(2))
    got = k_part.partition_rows(bins, level_pos, *part_args, window, got_c)
    want = ref.partition_rows(bins, level_pos, *part_args, window, want_c)
    if not (torch.equal(got, want) and torch.equal(got_c, want_c)):
        raise SystemExit("partition kernel (positions and counts) disagrees with its plain "
                         "version")
    moved = int(((level_pos >= 0) & ~t0_tree.is_leaf[level_pos.clamp(min=0).long()]).sum())
    pb, pb_by = _bound(n * 8 + moved + t0_tree.n_total * 10 + 128 * 4, n)

    def part_k():
        return k_part.partition_rows(bins, level_pos, *part_args, window, got_c)

    def part_p():
        return ref.partition_rows(bins, level_pos, *part_args, window, want_c)

    results.append(dict(
        name="partition_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/partition.cu",
        replaces="src/repro/kernels/partition.py:82",
        max_abs_err=0.0, ms=_time_ms(part_k, 20), device_ms=_time_ms(part_k, 20, queued=True),
        plain_ms=_time_ms(part_p, 5), bound_ms=pb, bound_by=pb_by, library_ms=None,
    ))
    # the floor of reading one byte a row at the node's feature: the same
    # bins gathered by one PyTorch call, the feature index precomputed
    f_idx = t0_tree.feature[level_pos.clamp(min=0).long()].long().clamp_(0, m - 1)[:, None]
    gather_ms = _time_ms(lambda: torch.gather(bins, 1, f_idx), 20, queued=True)
    del f_idx
    print(f"kernel partition_rows ({n} x {m} uint8, level 6 of tree 0, 5% inactive, "
          f"{moved} rows moving, level 7's counts folded in): positions and counts == the "
          f"plain version (bitwise); ms={results[-1]['ms']:.4f} "
          f"device_ms={results[-1]['device_ms']:.4f} bound_ms={pb:.4f} ({pb_by}); "
          f"torch.gather of one bin a row device_ms={gather_ms:.4f}")
    partition_level_times(bins, t0_tree)
    k_part.launches = saved
    del g, h, pos, level_pos

    results.append(forest_checks(seed, dev, booster, eval_bins, bins))
    del bins, eval_bins

    # binning: one 32 MiB page's rows in f32 (the page-creation shape of the
    # streaming path), and the eval rows in f64; each against its plain
    # version and the host numpy binning, bit for bit
    binner = Binner(booster.cuts, dev)
    edges, nbf = binner.edges, binner.n_bins
    width = edges.shape[1]
    saved = k_bin.launches
    bin_rows = {}
    page_rows = min(rows_per_page(m), len(X))
    for dtype, raw in ((np.float32, X[:page_rows]), (np.float64, Xe)):
        raw = np.ascontiguousarray(raw, dtype=dtype)
        rows = raw.shape[0]
        x = torch.from_numpy(raw).to(dev)
        got = k_bin.bin_values(x, edges, nbf)
        want = ref.bin_values(x, edges, nbf)
        t0 = time.perf_counter()
        host = bin_batch(raw, booster.cuts)
        host_s = time.perf_counter() - t0
        if not (torch.equal(got, want) and np.array_equal(got.cpu().numpy(), host)):
            raise SystemExit(f"binning kernel disagrees ({dtype.__name__}): plain "
                             f"{torch.equal(got, want)}, host {np.array_equal(got.cpu().numpy(), host)}")
        lib_edges = edges if dtype is np.float32 else edges.double()
        xt = x.t().contiguous()
        itemsize = raw.itemsize
        bb, bb_by = _bound(
            rows * m * (itemsize + 1) + edges.numel() * 4 + m * 4,
            rows * m * max(1, int(np.ceil(np.log2(width)))),
            FP32_OPS_PER_S if dtype is np.float32 else FP64_OPS_PER_S,
        )
        bin_rows[dtype.__name__] = dict(
            rows=rows, ms=_time_ms(lambda: k_bin.bin_values(x, edges, nbf), 20),
            device_ms=_time_ms(lambda: k_bin.bin_values(x, edges, nbf), 20, queued=True),
            plain_ms=_time_ms(lambda: ref.bin_values(x, edges, nbf), 2),
            library_ms=_time_ms(lambda: torch.searchsorted(lib_edges, xt, side="left"), 5),
            bound_ms=bb, bound_by=bb_by, host_numpy_s=host_s,
            # what the memory system gives for this input: one read of it
            # (torch.sum), one read and one write (clone)
            read_ms=_time_ms(lambda: x.sum(), 20, queued=True),
            copy_ms=_time_ms(lambda: x.clone(), 20, queued=True),
        )
        del x, xt, got, want
    k_bin.launches = saved
    f32, f64 = bin_rows["float32"], bin_rows["float64"]
    print(f"kernel bin_values float64 ({f64['rows']} x {m}): ms={f64['ms']:.4f} "
          f"device_ms={f64['device_ms']:.4f} "
          f"plain_ms={f64['plain_ms']:.4f} library_ms={f64['library_ms']:.4f} "
          f"bound_ms={f64['bound_ms']:.4f} ({f64['bound_by']}) host numpy "
          f"{f64['host_numpy_s']:.3f} s; float32 host numpy {f32['host_numpy_s']:.3f} s")
    for name, r in bin_rows.items():
        print(f"  bin_values {name} ({r['rows']} x {m}) yardsticks: device_ms={r['device_ms']:.4f}; "
              f"reading the input once (torch.sum) device_ms={r['read_ms']:.4f}, reading and "
              f"writing it (clone) device_ms={r['copy_ms']:.4f}")
    results.append(dict(
        name="bin_values", route="cuda",
        source="src/repro_torch/kernels/csrc/ellpack_bin.cu",
        replaces="src/repro/kernels/ellpack_bin.py:60",
        max_abs_err=0.0, ms=f32["ms"], device_ms=f32["device_ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["library_ms"],
    ))
    for r in results:
        print(
            f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}"
        )
    return results


# ------------------------------------------------------- phase 10: lossguide
def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _same_trees(a, b) -> bool:
    """Two forests equal in every `TreeArrays` field, bit for bit."""
    import torch

    return len(a) == len(b) and all(
        torch.equal(u, v) for ta, tb in zip(a, b) for u, v in zip(ta, tb)
    )


def _structurally_equal(a, b) -> bool:
    """The structural bar of the reference's tests for chain-derived
    histograms (f32 sums re-associated): the same leaves, at least 95% of the
    splits, leaf values within rtol 1e-4 / atol 1e-5."""
    import torch

    for ta, tb in zip(a, b, strict=True):
        if not torch.equal(ta.is_leaf, tb.is_leaf):
            return False
        same = (ta.feature == tb.feature) & (ta.split_bin == tb.split_bin)
        if same.float().mean().item() < 0.95:
            return False
        if not torch.allclose(ta.leaf_value, tb.leaf_value, rtol=1e-4, atol=1e-5):
            return False
    return True


def lossguide_in_core_phase(dev, dm, X, y, Xe, ye, booster, params: dict) -> tuple[dict, dict]:
    """Phase 10 (a)-(d): best-first growth in core on phase 2's matrix (see
    the module docstring). Returns the launch counts of its fits and the
    eval AUCs of the in-core fits that (e) and (f) are held against."""
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.ellpack import Binner
    from repro_torch.core.objectives import auc
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.dmatrix import ArrayDMatrix
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    total: dict = {}

    def fit(label: str, n_trees: int, data=None, policy=None, eval_set=(Xe, ye), **kw):
        """One lossguide fit with its launch counts zeroed before and read
        after, its seconds a tree and its device-memory peak above start."""
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        b = GradientBooster(device=dev, policy=policy, **dict(
            params, n_estimators=n_trees, grow_policy="lossguide", **kw))
        # the boosting loop's own peak: from after the eval rows are binned
        # (a transient of the raw rows that hides the histogram store)
        eval_state, loop = b._eval_state, {}

        def eval_then_mark(*a):
            out = eval_state(*a)
            torch.cuda.synchronize()
            loop["peak_before"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            loop["base"] = torch.cuda.memory_allocated(dev)
            return out

        b._eval_state = eval_then_mark
        b.fit(dm if data is None else data, eval_set=eval_set)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        loop_peak = torch.cuda.max_memory_allocated(dev)
        peak = max(loop["peak_before"], loop_peak) - base
        loop_peak -= loop["base"]
        counts = launch_counts()
        _add_counts(total, counts)
        loop_s = b.eval_history[-1].elapsed_s if b.eval_history else fit_s
        info = dict(per_tree=loop_s / len(b.trees), peak=peak, loop_peak=loop_peak, counts=counts,
                    pops=[int((~t.is_leaf).sum()) for t in b.trees],
                    auc=b.eval_history[-1].value if b.eval_history else None)
        print(f"lossguide {label}: decision={b.decision_.mode} trees={len(b.trees)} "
              f"n_total={b.trees[0].n_total} fit={fit_s:.3f} s per_tree={info['per_tree']:.4f} s "
              f"pops a tree {info['pops']} kernel 1 launches="
              f"{counts['build_histogram_nodes']} kernel 2 launches={counts['partition_rows']} "
              f"eval_auc={info['auc']} peak above start={peak} B (boosting loop: "
              f"{loop_peak} B above its start)")
        return b, info

    # (a) the full leaf budget of depth 8 equals the depthwise trees of phase 2
    a, _ = fit("(a) max_leaves=256 pop_batch=1", 4, max_leaves=256, pop_batch=1)
    if not _same_trees(a.trees, booster.trees[:4]):
        raise SystemExit("lossguide at the full leaf budget differs from phase 2's depthwise "
                         "trees")
    print("lossguide (a): 4 trees == phase 2's first 4 depthwise trees (every field, bitwise)")

    # (b) 64 leaves, one and eight pops a pass
    b1, i1 = fit("(b) max_leaves=64 pop_batch=1", 4, max_leaves=64, pop_batch=1)
    b8, i8 = fit("(b) max_leaves=64 pop_batch=8", 4, max_leaves=64, pop_batch=8)

    # (c) the same under a budget of 16 node histograms, K = 1 and 2
    node_bytes = ExecutionPolicy().memory_model(dm, b1.params).hist_node_bytes
    hist_budget = 16 * node_bytes
    for k in (1, 2):
        pol = ExecutionPolicy(hist_budget_bytes=hist_budget, hist_retained_levels=k)
        bc, ic = fit(f"(c) max_leaves=64 hist_budget_bytes={hist_budget} retained_levels={k}",
                     4, policy=pol, max_leaves=64, pop_batch=1)
        st, hs = bc.stats, bc.hist_cache.stats
        print(f"lossguide (c) K={k}: hist_spills={st.hist_spills} hist_fetches={st.hist_fetches} "
              f"hist_spill_bytes={st.hist_spill_bytes} hist_fetch_bytes={st.hist_fetch_bytes} "
              f"chain_derived_nodes={hs.chain_derived_nodes} rebuilt_nodes={hs.rebuilt_nodes}; "
              f"boosting-loop peak above its start {ic['loop_peak']} B against "
              f"{i1['loop_peak']} B unbudgeted (one node {node_bytes} B; whole fits "
              f"{ic['peak']} and {i1['peak']} B); per_tree {ic['per_tree']:.4f} s against "
              f"{i1['per_tree']:.4f} s")
        if k == 1:
            if not _same_trees(bc.trees, b1.trees):
                raise SystemExit("the budgeted store (K=1) grew other trees than the "
                                 "unbudgeted one")
            if not (st.hist_spills > 0 and ic["loop_peak"] < i1["loop_peak"]):
                raise SystemExit(f"the budget did not spill or did not lower the boosting "
                                 f"loop's peak: {st.hist_spills} spills, {ic['loop_peak']} "
                                 f"vs {i1['loop_peak']} B")
        elif not _structurally_equal(bc.trees, b1.trees):
            raise SystemExit("the budgeted store (K=2) grew trees structurally unlike the "
                             "unbudgeted one")
    print("lossguide (c): K=1 trees == unbudgeted (bitwise); K=2 structurally equal")

    # (d) depth 12, 256 leaves: refused without a histogram budget, in core with one
    n_d = min(300_000, len(X))
    dm_d = ArrayDMatrix(X[:n_d], y[:n_d], max_bin=256, cuts=booster.cuts, device=dev)
    deep = dict(max_depth=12, max_leaves=256, pop_batch=1)
    bp = BoosterParams(**dict(params, n_estimators=2, grow_policy="lossguide", **deep))
    model = ExecutionPolicy(mode="auto").memory_model(dm_d, bp)
    budget = model.fixed_bytes - model.hist_node_bytes
    try:
        ExecutionPolicy(mode="auto", memory_budget_bytes=budget).decide(dm_d, bp)
    except ValueError as err:
        print(f"lossguide (d): {n_d} rows, memory_budget_bytes={budget} without "
              f"hist_budget_bytes: ValueError: {err}")
    else:
        raise SystemExit("the policy did not refuse depth 12 without a histogram budget")
    pol = ExecutionPolicy(mode="auto", memory_budget_bytes=budget, hist_budget_bytes=hist_budget)
    decision = pol.decide(dm_d, bp)
    print(f"lossguide (d): with hist_budget_bytes={hist_budget}: {decision.mode} "
          f"({decision.reason})")
    if decision.mode != "in_core":
        raise SystemExit(f"depth 12 with a histogram budget decided {decision.mode!r}")
    bd, idd = fit("(d) depth 12 max_leaves=256", 2, data=dm_d, policy=pol, eval_set=None, **deep)
    print(f"lossguide (d): hist_spills={bd.stats.hist_spills} "
          f"hist_fetches={bd.stats.hist_fetches}; peak above start {idd['peak']} B within the "
          f"budget {budget} B: {idd['peak'] <= budget}")
    if bd.decision_.mode != "in_core" or idd["peak"] > budget:
        raise SystemExit(f"depth 12 fit decided {bd.decision_.mode!r} or peaked {idd['peak']} "
                         f"B over its {budget} B budget")
    b8l, _ = fit("(d) depth 12 max_leaves=8", 2, data=dm_d, eval_set=None, max_depth=12,
                 max_leaves=8)
    eval_bins = Binner(booster.cuts, dev).to_device(Xe)
    for label, b in (("256 leaves", bd), ("8 leaves", b8l)):
        forest = b.packed_forest()
        got = forest.predict_margin_bins(eval_bins)
        if not torch.equal(got, _plain_margins(forest, eval_bins)):
            raise SystemExit(f"kernel 3 differs from its plain version on the {label} "
                             f"lossguide forest")
        print(f"lossguide (d): kernel 3 == ref.predict_forest_bins on the {label} forest "
              f"({forest.n_trees} trees x {forest.n_total} nodes, max_depth "
              f"{forest.max_depth}, {eval_bins.shape[0]} eval rows; bitwise); eval_auc={auc(ye, got.cpu().numpy()):.6f}")
    del dm_d, eval_bins

    # the in-core fits that the paged legs (e) and (f) are held against
    _, ie = fit("(e) reference: in core, max_leaves=16 pop_batch=4", 1, max_leaves=16, pop_batch=4)
    _, if_ = fit("(f) reference: in core, max_leaves=64", 2, max_leaves=64)
    print(f"lossguide phase (a)-(d): {time.perf_counter() - t_phase:.3f} s in all")
    return total, dict(e=ie["auc"], f=if_["auc"])


def _kernel_probes(max_pages: int):
    """Wrap kernels 1 and 2 so that each of their first ``max_pages``
    launches (pages of the first passes) is held against its plain version:
    kernel 1 bit for bit against the fixed-point one, added into the running
    page sum as the kernel adds; kernel 2 positions and counts bit for bit.
    The wrappers launch each kernel once, as the fit would, and compare with
    plain versions only. Returns (install, uninstall, tally)."""
    import torch

    from repro_torch.kernels import histogram as k_hist
    from repro_torch.kernels import partition as k_part
    from repro_torch.kernels import ref

    orig_h, orig_p = k_hist.build_histogram_nodes, k_part.partition_rows
    tally = dict(hist_pages=0, part_pages=0, err=0.0, node_lists=0, widest=0, max_build=0)

    def hist_probe(bins, g, h, pos, nodes, n_bins, add_into=None):
        if tally["hist_pages"] >= max_pages:
            return orig_h(bins, g, h, pos, nodes, n_bins, add_into=add_into)
        before = None if add_into is None else add_into.clone()
        out = orig_h(bins, g, h, pos, nodes, n_bins, add_into=add_into)
        fixed = ref.build_histogram_nodes_fixed(bins, g, h, pos, nodes, n_bins)
        plain = ref.build_histogram_nodes(bins, g, h, pos, nodes, n_bins)
        # f32 sums in row order stray from the fixed-point ones by rounding
        # that grows with the magnitudes summed: held within 1e-5 of them
        mag = ref.build_histogram_nodes(bins, g.abs(), h.abs(), pos, nodes, n_bins)
        err = (fixed - plain).abs()
        if not bool((err <= 1e-5 * (1.0 + mag)).all()):
            raise SystemExit(f"kernel 1's fixed-point plain version strays from the f32 one "
                             f"beyond 1e-5 of the magnitudes summed (max err "
                             f"{err.max().item():.3g})")
        tally["err"] = max(tally["err"], err.max().item())
        if not torch.equal(out, fixed if before is None else before.add_(fixed)):
            raise SystemExit(f"kernel 1 differs from its fixed-point plain version on a page "
                             f"of a lossguide pass ({nodes.shape[0]} build nodes)")
        tally["hist_pages"] += 1
        tally["max_build"] = max(tally["max_build"], nodes.shape[0])
        return out

    def part_probe(bins, pos, feature, split_bin, default_left, is_leaf, count_level=None,
                   counts=None):
        if tally["part_pages"] >= max_pages:
            return orig_p(bins, pos, feature, split_bin, default_left, is_leaf, count_level,
                          counts)
        before = None if counts is None else counts.clone()
        out = orig_p(bins, pos, feature, split_bin, default_left, is_leaf, count_level, counts)
        want = ref.partition_rows(bins, pos, feature, split_bin, default_left, is_leaf,
                                  count_level, before)
        if not (torch.equal(out, want) and (counts is None or torch.equal(counts, before))):
            raise SystemExit(f"kernel 2 differs from its plain version on a page of a "
                             f"lossguide pass (count window {count_level})")
        if count_level is not None and count_level[1] > 2:  # the span of a node list
            tally["node_lists"] += 1
            tally["widest"] = max(tally["widest"], count_level[1])
        tally["part_pages"] += 1
        return out

    def install():
        k_hist.build_histogram_nodes, k_part.partition_rows = hist_probe, part_probe

    def uninstall():
        k_hist.build_histogram_nodes, k_part.partition_rows = orig_h, orig_p

    return install, uninstall, tally


def lossguide_paged_phase(dev, cache: str, params: dict, Xe, ye, core_auc: dict) -> dict:
    """Phase 10 (e)-(f): best-first growth streaming and sampled on phase
    6's pages (see the module docstring). Returns the launch counts of the
    timed fits."""
    import torch

    from repro_torch.core.booster import GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.sampling import SamplingConfig
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    total: dict = {}
    sdm = PagedDMatrix(cache)
    n_pages = sdm.n_pages
    kw = dict(params, n_estimators=1, grow_policy="lossguide", max_leaves=16, pop_batch=4)
    forced = ExecutionPolicy(mode="out_of_core")

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eb = GradientBooster(device=dev, policy=forced, **kw).fit(sdm, eval_set=(Xe, ye))
    torch.cuda.synchronize()
    e_s = time.perf_counter() - t0
    counts = launch_counts()
    _add_counts(total, counts)
    st = eb.stats
    e_auc = eb.eval_history[-1].value
    print(f"lossguide (e) streaming: decision={eb.decision_.mode} pages={n_pages} "
          f"max_leaves=16 pop_batch=4 fit={e_s:.3f} s per_tree={eb.eval_history[-1].elapsed_s:.4f} s "
          f"pops={int((~eb.trees[0].is_leaf).sum())} pages_skipped={st.pages_skipped} "
          f"h2d_GB={st.host_to_device_bytes / 1e9:.6f} fetch_s={st.stream_fetch_seconds:.6f} "
          f"wall_s={st.stream_wall_seconds:.6f} launches {json.dumps(counts)}; eval_auc={e_auc:.6f} "
          f"in-core at the same settings {core_auc['e']:.6f} "
          f"|diff|={abs(e_auc - core_auc['e']):.6f}")
    if eb.decision_.mode != "out_of_core":
        raise SystemExit(f"the streaming lossguide fit decided {eb.decision_.mode!r}")
    if abs(e_auc - core_auc["e"]) > AUC_TOLERANCE:
        raise SystemExit(f"streaming lossguide AUC {e_auc} vs in-core {core_auc['e']}")

    # the same fit again, kernels 1 and 2 held against their plain versions
    # on every page of the first four passes of each
    install, uninstall, tally = _kernel_probes(4 * n_pages)
    install()
    try:
        again = GradientBooster(device=dev, policy=forced, **kw).fit(sdm)
    finally:
        uninstall()
    if not _same_trees(again.trees, eb.trees):
        raise SystemExit("two streaming lossguide fits on the same pages grew other trees")
    print(f"lossguide (e) kernels: {tally['hist_pages']} kernel 1 launches (up to "
          f"{tally['max_build']} build nodes) == the fixed-point plain version added page by "
          f"page (bitwise; the f32 plain version within 1e-5 of the magnitudes summed, "
          f"max_abs_err={tally['err']:.3g}), "
          f"{tally['part_pages']} kernel 2 launches == the plain version, positions and "
          f"counts ({tally['node_lists']} with a node list's span, widest "
          f"{tally['widest']} slots); a second fit grew the same tree")

    # (f) sampled: MVS at the paper's f on the same pages
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb = GradientBooster(device=dev, policy=forced, sampling=SamplingConfig(
        method="mvs", f=PAPER.sampling_f), **dict(params, n_estimators=2, grow_policy="lossguide",
                                             max_leaves=64)).fit(sdm, eval_set=(Xe, ye))
    torch.cuda.synchronize()
    f_s = time.perf_counter() - t0
    counts = launch_counts()
    _add_counts(total, counts)
    f_auc = fb.eval_history[-1].value
    print(f"lossguide (f) sampled: decision={fb.decision_.mode} f={fb.decision_.sampling_f} "
          f"max_leaves=64 2 trees fit={f_s:.3f} s per_tree="
          f"{fb.eval_history[-1].elapsed_s / len(fb.trees):.4f} s h2d_GB a tree="
          f"{fb.stats.host_to_device_bytes / len(fb.trees) / 1e9:.6f} launches "
          f"{json.dumps(counts)}; eval_auc={f_auc:.6f}, in core at the same settings "
          f"{core_auc['f']:.6f} |diff|={abs(f_auc - core_auc['f']):.6f}; (e) {e_auc:.6f}")
    if fb.decision_.mode != "sampled":
        raise SystemExit(f"the sampled lossguide fit decided {fb.decision_.mode!r}")
    if abs(f_auc - core_auc["f"]) > SAMPLED_AUC_TOLERANCE:
        raise SystemExit(f"sampled lossguide AUC {f_auc} vs in-core {core_auc['f']}")
    print(f"lossguide phase (e)-(f): {time.perf_counter() - t_phase:.3f} s in all")
    return total


def elastic_lossguide(dev, dirs, root: str, params: dict, cfg, Xe, ye, cuts) -> dict:
    """Phase 10 (g): one elastic lossguide tree on phase 8's shards against
    a single-process streaming lossguide tree on the same rows and cuts
    (phase 8's single-process page cache). Returns the path's launch counts
    (coordinator and workers)."""
    import numpy as np
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.objectives import auc
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.distributed import ElasticTrainer
    from repro_torch.kernels import launch_counts, reset_launch_counts

    kw = dict(params, n_estimators=1, grow_policy="lossguide", max_leaves=16, pop_batch=1)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = ElasticTrainer(dirs, BoosterParams(**kw), checkpoint_dir=f"{root}/ckpt_lg",
                        config=cfg, device=dev)
    booster = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    margin = booster.predict_margin(Xe)
    path = launch_counts()
    for counts in tr.worker_launches.values():
        _add_counts(path, counts)
    single = GradientBooster(device=dev, policy=ExecutionPolicy(mode="out_of_core"), **kw)
    single.fit(PagedDMatrix(f"{root}/single"))
    if not np.array_equal(single.cuts.values, cuts.values):
        raise SystemExit("phase 8's single-process pages carry other cuts")
    e_auc, s_auc = auc(ye, margin), auc(ye, single.predict_margin(Xe))
    pops = int((~booster.trees[0].is_leaf).sum())
    print(f"lossguide (g) elastic: max_leaves=16 pop_batch=1, 1 tree, fit={fit_s:.3f} s "
          f"(2 worker starts included) per_tree_s={[round(t, 4) for t in tr.tree_seconds]} "
          f"pops={pops} hist rpc {tr.rpc.calls['hist']} calls wall={tr.rpc.wall_s['hist']:.3f} s; "
          f"workers {json.dumps(tr.worker_launches)}; eval_auc={e_auc:.6f} single-process "
          f"streaming={s_auc:.6f} |diff|={abs(e_auc - s_auc):.6f}")
    if not all(c["build_histogram"] > 0 and c["build_histogram_nodes"] == 0
               for c in tr.worker_launches.values()):
        raise SystemExit(f"the elastic lossguide workers did not build their windows with "
                         f"kernel 4: {tr.worker_launches}")
    if abs(e_auc - s_auc) > AUC_TOLERANCE:
        raise SystemExit(f"elastic lossguide AUC {e_auc} vs single-process {s_auc}")
    return path


def sampled_budget_check(dev, cache: str, params: dict) -> None:
    """The sampled byte model against the sampled fit's peak (ROADMAP queue
    3): a budget midway between `sampled_bytes` (which counts int(n f) kept
    rows) and the same plus the compacted page's capacity rows, with MVS
    at the paper's f configured. Prints the decision and the peak above
    start against the budget; the byte model is the reference's, unchanged,
    so an overshoot is printed, not failed."""
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.core.sampling import SamplingConfig
    from repro_torch.data.dmatrix import PagedDMatrix

    sdm = PagedDMatrix(cache)
    cfg = SamplingConfig(method="mvs", f=PAPER.sampling_f)
    bp = BoosterParams(**dict(params, n_estimators=2), sampling=cfg)
    model = ExecutionPolicy().memory_model(sdm, bp)
    modeled = model.sampled_bytes(sdm.n_rows, PAPER.sampling_f)
    kept = int(sdm.n_rows * PAPER.sampling_f)
    capacity = GradientBooster(bp, device=dev)._sampled_capacity(sdm.n_rows, cfg)
    extra = (capacity - kept) * (sdm.num_features + model.row_state_bytes)
    budget = modeled + extra // 2
    pol = ExecutionPolicy(mode="auto", memory_budget_bytes=budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    b = GradientBooster(bp, device=dev, policy=pol).fit(sdm)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    print(f"sampled budget check: sampled_bytes={modeled} B ({kept} kept rows), compacted "
          f"page {capacity} rows (+{extra} B), budget {budget} B -> decision "
          f"{b.decision_.mode} f={b.decision_.sampling_f}; peak above start {peak} B, "
          f"within the budget: {peak <= budget} (over by {max(0, peak - budget)} B)")


# ------------------------------------------------------ phase 11: compression
CODEC_WIRE_RATIO = 0.76  # bitpack wire / logical bytes at 6-bit symbols (0.75 a page)
GRAD_AUC_TOLERANCE = 0.02  # the reference's bound for a lossy spill transport


def _packed_grid_page(rng, rows: int, cols: int, bits: int, missing: bool):
    """A uint8 page whose bitpack width is exactly ``bits``, with ~10%
    missing values and one all-missing row when ``missing``."""
    import numpy as np

    top = (1 << bits) - 2 if missing else min((1 << bits) - 1, 254)
    page = rng.integers(0, top + 1, size=(rows, cols)).astype(np.uint8)
    if missing:
        page[rng.random(page.shape) < 0.1] = 255
        page[min(3, rows - 1)] = 255
    page[0, 0] = top
    return page


def _bitpack_check(dev, page, payload, meta, what: str, view_at: int = 0):
    """Decode ``payload`` twice with the kernel (``view_at`` > 0: from a view
    that many bytes into a larger buffer, so not 16-byte aligned) and hold
    both against the plain version and the page, bit for bit, with one
    launch a call."""
    import numpy as np
    import torch

    from repro_torch.kernels import bitpack as k_bitpack
    from repro_torch.kernels import ref

    rows, cols = page.shape
    bits, miss = meta["bits"], meta["missing"]
    p = torch.from_numpy(payload).to(dev)
    if view_at:
        buf = torch.zeros(payload.size + view_at + 16, dtype=torch.uint8, device=dev)
        p = buf[view_at : view_at + payload.size].view(payload.shape).copy_(p)
    before = k_bitpack.launches
    got = k_bitpack.bitpack_decode(p, cols, bits, miss)
    again = k_bitpack.bitpack_decode(p, cols, bits, miss)
    want = ref.bitpack_decode(p, cols, bits, miss)
    torch.cuda.synchronize()
    if k_bitpack.launches != before + 2:
        raise SystemExit(f"bitpack decode: {k_bitpack.launches - before} launches for 2 calls "
                         f"({what})")
    if not (torch.equal(got, want) and torch.equal(got, again)
            and np.array_equal(got.cpu().numpy(), page)):
        raise SystemExit(f"bitpack decode kernel disagrees ({what}, bits={bits}, missing "
                         f"symbol {miss}, shape=({rows}, {cols}))")


def bitpack_kernel_checks(seed: int, dev, cache: str) -> dict:
    """Phase 11 (a): the bitpack decode kernel against its plain version,
    bit for bit, on a grid of widths, at its tile edges, from views that are
    not 16-byte aligned, and on phase 6's first page, which it times.
    Returns the kernels line's row (launches filled in by main); restores
    the kernel's launch count."""
    import numpy as np

    from repro_torch.compress import BitpackCodec
    from repro_torch.data.pages import PageStore
    from repro_torch.kernels import bitpack as k_bitpack

    saved = k_bitpack.launches
    codec = BitpackCodec()
    rng = np.random.default_rng(seed + 111)
    n_cases = 0
    edges = {cols: k_bitpack.tile_rows(cols) for cols in (500, 13)}
    shapes = [(4096, 500), (1000, 13), (7, 1), (1, 4099)] + [
        (rows, cols) for cols, r in edges.items() for rows in (r - 1, r, r + 1, 4 * r + 3)
    ]
    for bits in range(1, 9):
        for missing in (False, True):
            for rows, cols in shapes:
                page = _packed_grid_page(rng, rows, cols, bits, missing)
                payload, meta = codec.encode(page)
                if meta["bits"] != bits:
                    raise SystemExit(f"grid page packs at {meta['bits']} bits, not {bits}")
                _bitpack_check(dev, page, payload, meta, "grid")
                n_cases += 1
    for view_at in (1, 3, 8, 15):
        for bits, rows, cols in ((6, 4 * edges[500] + 3, 500), (3, edges[13] + 1, 13)):
            page = _packed_grid_page(rng, rows, cols, bits, True)
            payload, meta = codec.encode(page)
            _bitpack_check(dev, page, payload, meta, f"a view at byte {view_at}", view_at)
            n_cases += 1
    # 8 bits whose missing symbol is not 255: the copy path still remaps
    page = _packed_grid_page(rng, 4 * edges[500] + 3, 500, 8, True)
    page[page == 254] = 253
    payload, meta = codec.encode(page)
    if (meta["bits"], meta["missing"]) != (8, 254):
        raise SystemExit(f"the remap page packs as {meta}")
    _bitpack_check(dev, page, payload, meta, "8 bits, missing symbol 254")
    n_cases += 1
    print(f"bitpack (a): decode kernel == plain version == the page (bitwise), twice, one "
          f"launch a call, in {n_cases} cases: bits 1-8, with and without missing values (an "
          f"all-missing row), (rows, symbols) in {shapes} (tile rows {edges}), views at bytes "
          f"1, 3, 8 and 15 of a buffer, 8 bits with missing symbol 254")

    k_bitpack.launches = saved
    return _bitpack_timed_row(dev, PageStore(cache).read_page(0)["bins"], "phase 6's page 0")


def _bitpack_timed_row(dev, bins, what: str) -> dict:
    """Encode ``bins`` with the bitpack codec, hold the kernel's decode
    against the plain version and ``bins`` bit for bit, and time it beside
    its bound, the plain version and one device-to-device copy of the
    decoded bytes (``copy_ms``, the floor of a pass that reads and writes a
    page). Returns the kernels line's row (launches not filled in); leaves
    the kernel's launch count as it found it."""
    import numpy as np
    import torch

    from repro_torch.compress import BitpackCodec
    from repro_torch.kernels import bitpack as k_bitpack
    from repro_torch.kernels import ref

    saved = k_bitpack.launches
    payload, meta = BitpackCodec().encode(bins)
    rows, cols = bins.shape
    bits, miss = meta["bits"], meta["missing"]
    p = torch.from_numpy(payload).to(dev)
    got = k_bitpack.bitpack_decode(p, cols, bits, miss)
    want = ref.bitpack_decode(p, cols, bits, miss)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and np.array_equal(got.cpu().numpy(), bins)):
        raise SystemExit(f"bitpack decode kernel disagrees on {what}")
    dst = torch.empty_like(got)
    n_bytes = payload.nbytes + bins.nbytes  # packed read once, uint8 written once
    bound_ms, bound_by = _bound(n_bytes, 4 * bins.size)  # shift, or, shift, mask a symbol
    row = dict(
        name="bitpack_decode", route="cuda", source="src/repro_torch/kernels/csrc/bitpack.cu",
        replaces="src/repro/compress/codecs.py:148 (BitpackCodec.device_decode, jnp; no "
                 "Pallas counterpart)",
        shape=f"{rows} x {cols}, {bits} bits", max_abs_err=0.0,
        ms=_time_ms(lambda: k_bitpack.bitpack_decode(p, cols, bits, miss), 20),
        device_ms=_time_ms(lambda: k_bitpack.bitpack_decode(p, cols, bits, miss), 20,
                           queued=True),
        plain_ms=_time_ms(lambda: ref.bitpack_decode(p, cols, bits, miss), 3),
        bound_ms=bound_ms, bound_by=bound_by,
        # no one PyTorch call unpacks bit fields narrower than a byte
        library_ms=None,
        copy_ms=_time_ms(lambda: dst.copy_(got), 20, queued=True),
    )
    print(f"kernel bitpack_decode ({what}: {rows} x {cols} at {bits} bits, missing symbol "
          f"{miss}): == plain version == the page (bitwise) True ms={row['ms']:.4f} "
          f"device_ms={row['device_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}: {payload.nbytes} B packed read + "
          f"{bins.nbytes} B uint8 write = {n_bytes} B at {HBM_BYTES_PER_S / 1e12} TB/s) "
          f"copy_ms={row['copy_ms']:.4f} (one device copy of the {bins.nbytes} decoded B) "
          f"share of the bound {bound_ms / row['device_ms']:.2f} library_ms=None (no one "
          f"PyTorch call unpacks sub-byte fields)")
    k_bitpack.launches = saved
    return row


def compression_grad_phase(dev, dm, Xe, ye, params: dict) -> dict:
    """Phase 11 (c): phase 10 (c)'s budgeted lossguide fit with each spill
    transport. Returns the launch counts of its fits."""
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    total: dict = {}
    lg = dict(params, n_estimators=4, grow_policy="lossguide", max_leaves=64, pop_batch=1)
    node_bytes = ExecutionPolicy().memory_model(dm, BoosterParams(**lg)).hist_node_bytes
    fits = {}
    for mode in ("raw", "f16", "bf16", "int8", "int8"):
        policy = ExecutionPolicy(hist_budget_bytes=16 * node_bytes, grad_transport=mode)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = GradientBooster(device=dev, policy=policy, **lg).fit(dm, eval_set=(Xe, ye))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _add_counts(total, launch_counts())
        st = b.stats
        print(f"grad transport (c) {mode}: fit={secs:.3f} s per_tree="
              f"{b.eval_history[-1].elapsed_s / len(b.trees):.4f} s hist_spills={st.hist_spills} "
              f"hist_spill_bytes={st.hist_spill_bytes} hist_fetches={st.hist_fetches} "
              f"hist_fetch_bytes={st.hist_fetch_bytes} bytes a spill "
              f"{st.hist_spill_bytes / max(st.hist_spills, 1):.1f} eval_auc="
              f"{b.eval_history[-1].value:.6f}")
        if mode in fits:
            if not _same_trees(b.trees, fits[mode].trees):
                raise SystemExit(f"two {mode} spill-transport fits grew different trees")
            print(f"grad transport (c): two {mode} fits grew identical trees (every field)")
        else:
            fits[mode] = b
    raw = fits["raw"]
    raw_auc = raw.eval_history[-1].value
    raw_spills = raw.stats.hist_spills
    if not raw_spills or raw.stats.hist_spill_bytes != raw_spills * node_bytes:
        raise SystemExit(f"raw spills are not whole f32 node histograms: {raw.stats}")
    for mode, divisor in (("f16", 2), ("bf16", 2), ("int8", 4)):
        st = fits[mode].stats
        auc_gap = fits[mode].eval_history[-1].value - raw_auc
        per_spill = st.hist_spill_bytes // max(st.hist_spills, 1)
        print(f"grad transport (c) {mode}: a spill moves {per_spill} B against {node_bytes} B "
              f"raw (1/{divisor}: "
              f"{st.hist_spill_bytes * divisor == st.hist_spills * node_bytes}); spill bytes "
              f"{st.hist_spill_bytes} against {raw.stats.hist_spill_bytes} raw ({st.hist_spills} "
              f"against {raw.stats.hist_spills} spills); eval AUC - raw {auc_gap:+.6f}")
        if not st.hist_spills or st.hist_spill_bytes * divisor != st.hist_spills * node_bytes:
            raise SystemExit(f"{mode} spills are not 1/{divisor} of a raw spill's bytes")
        if st.hist_fetch_bytes * divisor != st.hist_fetches * node_bytes:
            raise SystemExit(f"{mode} fetches are not 1/{divisor} of a raw fetch's bytes")
        if abs(auc_gap) > GRAD_AUC_TOLERANCE:
            raise SystemExit(f"{mode} spill transport moved eval AUC by {auc_gap}")
    print(f"grad transport (c): {time.perf_counter() - t_phase:.3f} s in all")
    return total


def compression_serving_phase(dev, forest, Xe) -> dict:
    """Phase 11 (d): the served 256-tree forest in 32-tree chunks through
    the forest transport, against the raw server. Returns launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ForestServer

    tpc, total = 32, {}
    rows = np.ascontiguousarray(Xe)
    n_chunks = -(-forest.n_trees // tpc)
    chunk_nodes = tpc * forest.n_total
    out = {}
    for label, kw in (("raw", {}), ("bitpack", dict(page_codec="bitpack"))):
        server = ForestServer(forest, trees_per_chunk=tpc, **kw)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[label] = server.predict_margin(rows)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _add_counts(total, launch_counts())
        st = server.stats
        print(f"forest transport (d) {label}: {forest.n_trees} trees in {n_chunks} chunks of "
              f"{tpc} over {len(rows)} rows: {secs:.3f} s, wire {st.wire_bytes} B logical "
              f"{st.logical_bytes} B ({st.wire_bytes // n_chunks} B a chunk)")
        want_wire = n_chunks * chunk_nodes * (14 if label == "bitpack" else 24)
        if st.wire_bytes != want_wire or st.logical_bytes != n_chunks * chunk_nodes * 24:
            raise SystemExit(f"forest chunks ({label}) moved {st.wire_bytes} B, not {want_wire}")
    if not np.array_equal(out["bitpack"], out["raw"]):
        raise SystemExit("the forest transport changed the served margins")
    pinned = ForestServer(forest, trees_per_chunk=tpc, page_codec="bitpack", pin_chunks=True)
    h2d = []
    for _ in range(2):
        before = pinned.stats.host_to_device_bytes
        reset_launch_counts()
        got = pinned.predict_margin(rows)
        _add_counts(total, launch_counts())
        h2d.append(pinned.stats.host_to_device_bytes - before)
        if not np.array_equal(got, out["raw"]):
            raise SystemExit("the pinned forest-transport server changed the margins")
    print(f"forest transport (d): bitpack == raw server (bitwise) True; a chunk {chunk_nodes * 14} "
          f"B on the wire against {chunk_nodes * 24} B; pinned server h2d per request {h2d} B")
    if h2d != [n_chunks * chunk_nodes * 14, 0]:
        raise SystemExit(f"the pinned server staged {h2d} B over two requests")
    return total


def compression_stream_phase(seed: int, dev, params: dict, n_rows: int = 200_000) -> dict:
    """Phase 11 (b): page codecs on the streaming and in-core paths (see the
    module docstring), on ``n_rows`` fresh rows. Returns the launch counts
    of its fits."""
    import numpy as np
    import torch

    from repro_torch.core.booster import BoosterParams, GradientBooster
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.data.dmatrix import IterDMatrix, PagedDMatrix
    from repro_torch.data.pages import PageStore, _zstd
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    total: dict = {}
    m = 500
    X, y = make_classification(n_rows, m, missing_rate=0.05, seed=seed + 11)
    Xe, ye = make_classification(20_000, m, missing_rate=0.05, seed=seed + 11, batch=1)
    step = max(1, n_rows // 4)
    batches = [(X[i : i + step], y[i : i + step]) for i in range(0, n_rows, step)]
    p = dict(params, n_estimators=2, max_bin=32)
    print(f"codecs (b): zstandard {'installed' if _zstd is not None else 'not installed'} "
          f"on this machine; {n_rows} x {m} rows, 5% missing, max_bin=32")
    fits = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as root:
        cuts = None
        for codec in ("raw", "bitpack", "delta-rle"):
            t0 = time.perf_counter()
            dm = IterDMatrix(batches, max_bin=32, cuts=cuts, cache_dir=f"{root}/{codec}",
                             page_bytes=PAGE_BYTES, page_codec=codec, device=dev)
            cuts = dm.cuts
            print(f"codecs (b) {codec} store: {dm.n_pages} pages, "
                  f"{dm.stats.disk_write_bytes} B on disk, written in "
                  f"{time.perf_counter() - t0:.3f} s")
        # the decode kernel timed at the shapes this phase decodes: a staged
        # page, and the whole matrix as the in-core fit stages it
        store = PageStore(f"{root}/raw")
        pages = [store.read_page(i)["bins"] for i in range(store.n_pages)]
        _bitpack_timed_row(dev, pages[0], "a staged page of (b)")
        _bitpack_timed_row(dev, np.concatenate(pages), "(b)'s in-core matrix")
        del pages
        for codec in ("raw", "bitpack", "delta-rle"):
            pdm = PagedDMatrix(f"{root}/{codec}")
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = GradientBooster(device=dev, policy=ExecutionPolicy(mode="out_of_core",
                                page_codec=codec), **p).fit(pdm, eval_set=(Xe, ye))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
            _add_counts(total, counts)
            st = b.stats
            passes = st.logical_bytes // (n_rows * m)
            print(f"codecs (b) streaming {codec}: decision={b.decision_.mode} fit={secs:.3f} s "
                  f"per_tree={b.eval_history[-1].elapsed_s / len(b.trees):.4f} s "
                  f"h2d={st.host_to_device_bytes} B wire/logical={st.wire_ratio:.6f} "
                  f"({passes} passes of {pdm.n_pages} pages) disk_read={st.disk_read_bytes} B "
                  f"fetch_s={st.stream_fetch_seconds:.3f} bitpack_decode launches="
                  f"{counts['bitpack_decode']} eval_auc={b.eval_history[-1].value:.6f}")
            if b.decision_.mode != "out_of_core":
                raise SystemExit(f"the {codec} streaming fit decided {b.decision_.mode!r}")
            want_decodes = passes * pdm.n_pages if codec == "bitpack" else 0
            if counts["bitpack_decode"] != want_decodes:
                raise SystemExit(f"{codec}: {counts['bitpack_decode']} decode launches, not "
                                 f"one a staged page ({want_decodes})")
            fits[codec] = b
        raw = fits["raw"]
        for codec in ("bitpack", "delta-rle"):
            b = fits[codec]
            if not (_same_trees(b.trees, raw.trees) and torch.equal(b.margins_, raw.margins_)):
                raise SystemExit(f"the {codec} streaming fit differs from the raw one")
        bp = fits["bitpack"].stats
        if not bp.wire_ratio <= CODEC_WIRE_RATIO:
            raise SystemExit(f"bitpack wire/logical {bp.wire_ratio} > {CODEC_WIRE_RATIO}")
        if fits["delta-rle"].stats.wire_bytes != fits["delta-rle"].stats.logical_bytes:
            raise SystemExit("delta-rle changed the staged bytes")
        print("codecs (b): bitpack and delta-rle streaming trees and margins == raw (bitwise)")

        # in core on the same rows: the matrix staged raw and packed
        pdm = PagedDMatrix(f"{root}/raw")
        core = {}
        for codec in ("raw", "bitpack"):
            policy = ExecutionPolicy(mode="in_core", page_codec=codec)
            model = policy.memory_model(pdm, BoosterParams(**p))
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            b = GradientBooster(device=dev, policy=policy, **p).fit(pdm)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            counts = launch_counts()
            _add_counts(total, counts)
            need = model.in_core_bytes(pdm.n_rows)
            print(f"codecs (b) in core {codec}: peak above start {peak} B against the byte "
                  f"model's in_core_bytes {need} B ({peak - need:+d} B; page_codec_bits "
                  f"{model.page_codec_bits}) h2d={b.stats.host_to_device_bytes} B "
                  f"bitpack_decode launches={counts['bitpack_decode']}")
            if counts["bitpack_decode"] != (1 if codec == "bitpack" else 0):
                raise SystemExit(f"in core {codec}: {counts['bitpack_decode']} decode launches")
            core[codec] = b
        if not _same_trees(core["bitpack"].trees, core["raw"].trees):
            raise SystemExit("the bitpack in-core fit differs from the raw one")
        print("codecs (b): bitpack in-core trees == raw (bitwise)")
    print(f"codecs (b): {time.perf_counter() - t_phase:.3f} s in all")
    return total


# --------------------------------------------------------- phase 12: sharded
SHARD_WORLD = 4  # ranks sharing the card in (b)-(f)
SHARD_TIMEOUT_S = 60  # every collective of a rank ends within this, or raises
SHARD_DEADLINE_S = 300  # the ranks of (b)-(f), together
SHARD_AUC_TOLERANCE = 1e-4  # 4 ranks (and 2 x 2) vs the world of one, eval AUC
SHARD_PATH = ("build_histogram_nodes", "build_histogram", "partition_rows", "predict_forest",
              "bin_values", "bitpack_decode")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tree_digest(trees) -> int:
    """CRC32 of a forest's bytes, every field: equal digests, equal trees."""
    crc = 0
    for t in trees:
        for a in t:
            crc = zlib.crc32(a.cpu().numpy().tobytes(), crc)
    return crc


def _split_share(a, b) -> float:
    """The share of nodes whose (is_leaf, feature, split_bin) agree, over
    forests of `TreeArrays` or of their six fields in that order."""
    same = [
        ((ta[4] == tb[4]) & (ta[0] == tb[0]) & (ta[1] == tb[1])).float().mean().item()
        for ta, tb in zip(a, b, strict=True)
    ]
    return float(sum(same) / len(same))


def sharded_world_of_one(dev, dm, booster, Xe, ye, params: dict) -> dict:
    """Phase 12 (a): `fit_sharded` on a world of one (no process group) over
    phase 2's matrix, 4 trees, bit for bit phase 2's first 4 trees (kernel 4
    and kernel 1 give the same fixed-point sums). Returns what (b)-(f) are
    held against, and its launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.booster import BoosterParams
    from repro_torch.core.objectives import auc
    from repro_torch.distributed import fit_sharded, make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts

    mesh = make_mesh((1,), ("data",), device=dev)
    p = BoosterParams(**dict(params, n_estimators=4))
    reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    b = fit_sharded(mesh, dm, params=p, eval_set=(Xe, ye))
    _sync(dev)
    secs = time.perf_counter() - t0
    margin = b.predict_margin(Xe)
    counts = launch_counts()
    loop = b.eval_history[-1].elapsed_s
    print(f"sharded (a) world of one: fit={secs:.3f} s per_tree={loop / 4:.4f} s "
          f"eval_auc={b.eval_history[-1].value:.6f} h2d={b.stats.host_to_device_bytes} B "
          f"launches {json.dumps(counts)}")
    if not _same_trees(b.trees, booster.trees[:4]):
        raise SystemExit("sharded (a): a world of one grew other trees than phase 2's first 4")
    print("sharded (a): 4 trees == phase 2's first 4 trees (every field, bitwise)")
    if not (np.all(np.isfinite(margin)) and abs(auc(ye, margin) - b.eval_history[-1].value) < 1e-6):
        raise SystemExit("sharded (a): predict_margin disagrees with the fit's eval margins")
    return dict(trees=[[a.cpu() for a in t] for t in b.trees], margin=margin,
                aucs=[r.value for r in b.eval_history], counts=counts)


def sharded_phase(seed: int, dev, cache: str, params: dict, Xe, ye, one: dict,
                  stream_tree, stream_auc1: float, stream_h2d_tree: float,
                  f_rows: int = 200_000) -> dict:
    """Phase 12 (b)-(f): ``SHARD_WORLD`` rank processes on the card, gloo
    (see the module docstring); the ranks run `shard_rank_main`. Returns the
    launch counts of every rank, summed."""
    import numpy as np
    import torch

    from repro_torch.data.dmatrix import IterDMatrix
    from repro_torch.data.synthetic import make_classification

    t_phase = time.perf_counter()
    total: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as root:
        d = Path(root)
        np.save(d / "Xe.npy", Xe)
        np.save(d / "ye.npy", ye)
        # (f): phase 11 (b)'s rows at max_bin=32, written once as a raw store
        Xf, yf = make_classification(f_rows, PAPER.num_features, missing_rate=0.05,
                                     seed=seed + 11)
        Xef, yef = make_classification(f_rows // 10, PAPER.num_features, missing_rate=0.05,
                                       seed=seed + 11, batch=1)
        step = f_rows // 4
        IterDMatrix([(Xf[i : i + step], yf[i : i + step]) for i in range(0, len(Xf), step)],
                    max_bin=32, cache_dir=str(d / "f"), page_bytes=PAGE_BYTES, device=dev)
        np.save(d / "Xef.npy", Xef)
        np.save(d / "yef.npy", yef)
        del Xf, yf
        (d / "meta.json").write_text(json.dumps({
            "cache": cache, "cache_f": str(d / "f"), "params": params,
            "device": str(dev), "seed": seed,
        }))
        print(f"sharded: {SHARD_WORLD} ranks on one card over gloo (NCCL refuses two ranks "
              f"on one device); set-up {time.perf_counter() - t_phase:.1f} s")
        t0 = time.perf_counter()
        logs = [open(d / f"rank{r}.log", "w") for r in range(SHARD_WORLD)]
        procs = [
            subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank", str(r),
                 "--shard-dir", root],
                stdout=logs[r], stderr=subprocess.STDOUT,
            )
            for r in range(SHARD_WORLD)
        ]
        deadline = time.monotonic() + SHARD_DEADLINE_S
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for log in logs:
                log.close()
        ranks_s = time.perf_counter() - t0
        for r in range(SHARD_WORLD):
            for line in (d / f"rank{r}.log").read_text().splitlines()[-40:]:
                print(f"  [rank {r}] {line}")
        codes = [proc.returncode for proc in procs]
        if any(codes):
            raise SystemExit(f"sharded: rank exit codes {codes} after {ranks_s:.1f} s")
        reports = [json.loads((d / f"rank{r}.json").read_text()) for r in range(SHARD_WORLD)]
        res = np.load(d / "rank0.npz")
        for rep in reports:
            _add_counts(total, rep["launches"])

    def forest(prefix: str) -> list:
        n = int(res[f"{prefix}_n"])
        return [[torch.from_numpy(res[f"{prefix}_{i}_{k}"]) for k in range(6)] for i in range(n)]

    for key in reports[0]["digests"]:
        if len({rep["digests"][key] for rep in reports}) != 1:
            raise SystemExit(f"sharded: the ranks returned different trees in {key}")
    print("sharded: every rank returned the same trees in every run")
    # (b) four ranks, data-parallel: repeatable bit for bit, AUC beside (a)
    rep = reports[0]
    if rep["digests"]["b1"] != rep["digests"]["b2"]:
        raise SystemExit("sharded (b): two runs of 4 ranks grew different trees")
    b_auc = rep["aucs"]["b1"]
    a_trees = [[torch.as_tensor(a) for a in t] for t in one["trees"]]
    share = _split_share(forest("b1"), a_trees)
    margin_diff = float(np.abs(res["b1_margin"] - one["margin"]).max())
    print(f"sharded (b) 4 ranks: two runs bitwise equal; eval_auc={b_auc[-1]:.6f} against "
          f"(a) {one['aucs'][-1]:.6f} (|diff| {abs(b_auc[-1] - one['aucs'][-1]):.2e}); "
          f"split nodes equal to (a)'s: {share:.4f}; largest eval margin difference "
          f"{margin_diff:.3e}")
    if abs(b_auc[-1] - one["aucs"][-1]) > SHARD_AUC_TOLERANCE:
        raise SystemExit(f"sharded (b): eval AUC {b_auc[-1]} vs (a) {one['aucs'][-1]}")
    # (c) 2 x 2 data x feature
    c_auc = rep["aucs"]["c"][-1]
    print(f"sharded (c) 2 x 2: eval_auc={c_auc:.6f} against (a) after 2 trees "
          f"{one['aucs'][1]:.6f}; split nodes equal to (a)'s: "
          f"{_split_share(forest('c'), a_trees[:2]):.4f}")
    if abs(c_auc - one["aucs"][1]) > SHARD_AUC_TOLERANCE:
        raise SystemExit(f"sharded (c): eval AUC {c_auc} vs (a) {one['aucs'][1]}")
    # (d) the paged build against phase 6's streaming tree
    d_auc = rep["aucs"]["d"][-1]
    d_share = _split_share(forest("d"), [[a.cpu() for a in stream_tree]])
    h2d = [r["h2d"]["d"] for r in reports]
    ratio = max(h2d) / stream_h2d_tree
    print(f"sharded (d) paged, 4 ranks: eval_auc after 1 tree={d_auc:.6f} against phase 6's "
          f"{stream_auc1:.6f}; split nodes equal to phase 6's tree 0: {d_share:.4f}; h2d a "
          f"tree per rank {h2d} B against {stream_h2d_tree:.0f} B single-process "
          f"({ratio:.4f} of it)")
    if abs(d_auc - stream_auc1) > AUC_TOLERANCE:
        raise SystemExit(f"sharded (d): eval AUC {d_auc} vs phase 6's first tree {stream_auc1}")
    if not 0.2 <= ratio <= 0.3:
        raise SystemExit(f"sharded (d): a rank staged {ratio:.4f} of the single process's bytes")
    # (e) lossguide, unbudgeted and under 16 node histograms
    if rep["digests"]["e"] != rep["digests"]["e_budget"]:
        raise SystemExit("sharded (e): the budgeted lossguide tree differs from the unbudgeted")
    print(f"sharded (e) lossguide 64 leaves: budgeted tree == unbudgeted (bitwise); spills "
          f"{rep['spills']['e_budget']}, fetches {rep['fetches']['e_budget']}; eval_auc="
          f"{rep['aucs']['e'][-1]:.6f}")
    # (f) compression
    if rep["digests"]["f_raw"] != rep["digests"]["f_bitpack"]:
        raise SystemExit("sharded (f): bitpack trees differ from raw")
    f16 = rep["aucs"]["f_f16"][-1] - rep["aucs"]["f_raw"][-1]
    print(f"sharded (f): bitpack trees == raw (bitwise), wire/logical "
          f"{rep['wire_ratio']['f_bitpack']:.6f}; f16 eval_auc - raw {f16:+.6f}")
    if abs(f16) > GRAD_AUC_TOLERANCE:
        raise SystemExit(f"sharded (f): f16 eval AUC off raw by {f16}")
    print(f"sharded path launches (ranks summed): {json.dumps(total)}")
    print(f"sharded (b)-(f): {time.perf_counter() - t_phase:.3f} s in all (ranks {ranks_s:.1f} s)")
    return total


def shard_rank_main(args) -> int:
    """One rank of phase 12 (b)-(f): joins the gloo group through a file
    store in ``--shard-dir``, runs every case on the same inputs as the
    others, and writes ``rank<r>.json`` (and, rank 0, ``rank0.npz``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    _load_paper_config()
    from repro_torch.core.booster import BoosterParams, bin_valid_from_cuts
    from repro_torch.core.ellpack import Binner, EllpackPage
    from repro_torch.core.objectives import auc, get_objective
    from repro_torch.core.tree import predict_tree_bins
    from repro_torch.data.dmatrix import PagedDMatrix
    from repro_torch.data.pages import TransferStats
    from repro_torch.distributed import (
        DistConfig,
        fit_sharded,
        grow_tree_distributed_paged,
        make_mesh,
        sharded_page_put,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.pipeline import PageStream

    d = Path(args.shard_dir)
    rank = args.shard_rank
    meta = json.loads((d / "meta.json").read_text())
    dist.init_process_group(
        "gloo", init_method=f"file://{d}/store", rank=rank, world_size=SHARD_WORLD,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S),
    )
    dev = torch.device(meta["device"])
    mesh = make_mesh((SHARD_WORLD,), ("data",), device=dev)
    mesh2 = make_mesh((2, SHARD_WORLD // 2), ("data", "model"), device=dev)
    Xe, ye = np.load(d / "Xe.npy"), np.load(d / "ye.npy")
    params = meta["params"]
    rep: dict = {"rank": rank, "launches": {}, "digests": {}, "aucs": {}, "h2d": {},
                 "spills": {}, "fetches": {}, "wire_ratio": {}}
    arrays: dict = {}

    def keep(name: str, trees) -> None:
        rep["digests"][name] = _tree_digest(trees)
        arrays[f"{name}_n"] = len(trees)
        for i, t in enumerate(trees):
            for k, a in enumerate(t):
                arrays[f"{name}_{i}_{k}"] = a.cpu().numpy()

    def timed(name: str, n_trees: int, fn):
        for m in (mesh, mesh2):
            m.stats.reset()
        reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        _add_counts(rep["launches"], counts)
        ar_s = mesh.stats.all_reduce_seconds + mesh2.stats.all_reduce_seconds
        ar_b = mesh.stats.all_reduce_bytes + mesh2.stats.all_reduce_bytes
        ag_s = mesh.stats.all_gather_seconds + mesh2.stats.all_gather_seconds
        loop = getattr(out, "eval_history", None)
        per_tree = loop[-1].elapsed_s / n_trees if loop else secs / n_trees
        calls = mesh.stats.all_reduce_calls + mesh2.stats.all_reduce_calls
        print(f"{name}: {secs:.3f} s, {per_tree:.4f} s a tree; all-reduce {ar_s / n_trees:.4f} s, "
              f"{ar_b // n_trees} B, {calls // n_trees} calls a tree; all-gather "
              f"{ag_s / n_trees:.4f} s a tree", flush=True)
        return out

    pdm = PagedDMatrix(meta["cache"])
    p4 = BoosterParams(**dict(params, n_estimators=4))
    # (b) data-parallel, twice; a predict through kernel 3
    b1 = timed("b1", 4, lambda: fit_sharded(mesh, pdm, params=p4, eval_set=(Xe, ye)))
    margin = timed("b_predict", 1, lambda: b1.predict_margin(Xe))
    b2 = timed("b2", 4, lambda: fit_sharded(mesh, pdm, params=p4, eval_set=(Xe, ye)))
    keep("b1", b1.trees)
    keep("b2", b2.trees)
    arrays["b1_margin"] = margin
    rep["aucs"]["b1"] = [r.value for r in b1.eval_history]
    del b1, b2
    # (c) 2 x 2 data x feature, 2 trees
    c = timed("c", 2, lambda: fit_sharded(mesh2, pdm, params=BoosterParams(**dict(
        params, n_estimators=2)), cfg=DistConfig(feature_axis="model"), eval_set=(Xe, ye)))
    keep("c", c.trees)
    rep["aucs"]["c"] = [r.value for r in c.eval_history]
    del c
    # (d) the paged build over phase 6's pages, one tree, each rank its rows
    tp = p4.tree_params()
    labels = pdm.require_labels()
    obj = get_objective(params["objective"])
    base = obj.base_margin(labels)
    labels_t = torch.from_numpy(labels).to(dev)
    g, h = obj.grad_hess(torch.full_like(labels_t, base), labels_t)
    ps = pdm.page_set()
    put = sharded_page_put(mesh, DistConfig())
    stats = TransferStats()

    def make_stream(indices=None):
        return PageStream.from_store(
            ps.store, lambda i, a: EllpackPage(bins=a["bins"], row_offset=ps.row_offsets[i]),
            indices=indices, to_array=put, device=dev, stats=stats,
        )

    bv = bin_valid_from_cuts(pdm.cuts, pdm.n_bins, dev)
    tree, _ = timed("d", 1, lambda: grow_tree_distributed_paged(
        mesh, make_stream, ps.page_extents, g, h, pdm.n_bins, bv, tp, DistConfig(),
        pdm.cuts.values, pdm.cuts.ptrs))
    keep("d", [tree])
    rep["h2d"]["d"] = stats.host_to_device_bytes
    eval_bins = Binner(pdm.cuts, dev).to_device(Xe)
    em = base + params["learning_rate"] * predict_tree_bins(tree, eval_bins, tp.max_depth)
    rep["aucs"]["d"] = [auc(ye, em.cpu().numpy())]
    del g, h, eval_bins
    # (e) lossguide, 64 leaves, unbudgeted and under 16 node histograms
    p1 = BoosterParams(**dict(params, n_estimators=1))
    node_bytes = pdm.num_features * pdm.n_bins * 2 * 4
    for name, cfg in (("e", DistConfig(grow_policy="lossguide", max_leaves=64)),
                      ("e_budget", DistConfig(grow_policy="lossguide", max_leaves=64,
                                              hist_budget_bytes=16 * node_bytes))):
        e = timed(name, 1, lambda cfg=cfg: fit_sharded(mesh, pdm, params=p1, cfg=cfg,
                                                       eval_set=(Xe, ye)))
        keep(name, e.trees)
        rep["aucs"][name] = [r.value for r in e.eval_history]
        rep["spills"][name], rep["fetches"][name] = e.stats.hist_spills, e.stats.hist_fetches
    del pdm
    # (f) compression on phase 11 (b)'s rows at max_bin=32
    pdf = PagedDMatrix(meta["cache_f"])
    Xef, yef = np.load(d / "Xef.npy"), np.load(d / "yef.npy")
    p2 = BoosterParams(**dict(params, n_estimators=2, max_bin=32))
    for name, cfg in (("f_raw", DistConfig()), ("f_bitpack", DistConfig(page_codec="bitpack")),
                      ("f_f16", DistConfig(grad_transport="f16"))):
        f = timed(name, 2, lambda cfg=cfg: fit_sharded(mesh, pdf, params=p2, cfg=cfg,
                                                       eval_set=(Xef, yef)))
        keep(name, f.trees)
        rep["aucs"][name] = [r.value for r in f.eval_history]
        rep["wire_ratio"][name] = f.stats.wire_ratio
    print(f"launches: {json.dumps(rep['launches'])}")
    (d / f"rank{rank}.json").write_text(json.dumps(rep))
    if rank == 0:
        np.savez(d / "rank0.npz", **arrays)
    dist.destroy_process_group()
    return 0


# ----------------------------------------------------- phase 13: LM serving
# (a): every arch at its full CONFIG, in bf16, through the serving entry
# point; the attention families also paged. One arch of each family first,
# then the other six smallest first, so that a failure in a large one
# leaves the small ones' lines
LM_FULL = (("llama3.2-1b", True), ("olmoe-1b-7b", True), ("mamba2-130m", False),
           ("hymba-1.5b", False), ("smollm-135m", True), ("phi3-mini-3.8b", True),
           ("minicpm-2b", True), ("musicgen-large", True), ("moonshot-v1-16b-a3b", True),
           ("llava-next-34b", True))
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 32, 16
# (a)'s hymba-1.5b past its 1024-slot ring: a longer prompt, fewer sequences
LM_RING_BATCH, LM_RING_PROMPT = 2, 1040
# room left beside an f32 hold's weights (its activations and logits), and
# beside a tempered copy of q and k
LM_HOLD_HEADROOM = 2 * 2**30
LM_DEVICE_STEPS = 4  # decode steps traced for the card's busy time
# (a)'s checks, |a - b| / max |b| over a step's logits. bf16 serving (prefill
# into caches, decode attention over them) against the bf16 forward over the
# same tokens, and paged against contiguous, round the same values to bf16
# along different paths (matmul shapes, softmax lengths); at the reference's
# init the attention scores are large (its dense_init scales stacked weights
# by 1/sqrt(n_layers)), so a rounding can move a near-one-hot softmax, and
# the gap grows with depth: on the H100 it was 4.3% (llama3.2-1b), 4.7%
# (mamba2-130m) and 8.7% (hymba-1.5b) of the largest logit, where a wrong
# decode position moves the logits by O(1). The same weights widened to f32
# are the sharp hold: 1.1e-4, 3.4e-4 and 1.7e-4 there.
LM_BF16_REL_TOL = 0.2
LM_F32_REL_TOL = 5e-3
# ... but at that init a deep network whose residual stream attention
# dominates is chaotic: on the H100 a 1e-7 relative nudge of olmoe-1b-7b's
# embeddings moves its f32 forward's own logits by 48% (llama3.2-1b 3.8e-5,
# mamba2-130m 4.7e-4, hymba-1.5b 7.4e-5), so no tolerance tells a bug from
# rounding there. The served weights are held where that nudge moves the
# logits by at most LM_CONDITIONED; every model with attention is also held
# on the same weights with the query and key projections scaled by
# LM_TEMPER, which keeps the attention scores O(1) (olmoe's f32 gap then
# 2.4e-6, its bf16 gap 0.8%).
LM_NUDGE = 1e-7
LM_CONDITIONED = 2e-3
LM_TEMPER = 0.1
LM_CACHES = {"dense": "contiguous cache", "moe": "contiguous cache", "ssm": "SSM state",
             "hybrid": "ring and full caches + SSM state"}
# (b): the card against the CPU at f32, the CPU tests' tolerance
LM_F32_RTOL = LM_F32_ATOL = 1e-4
LM_CPU_STEPS = 4
# (b)'s extra configs: the serve cases of tests/test_models.py
LM_CASES = {
    "dense": dict(family="dense", n_layers=3, d_model=64, vocab_size=128, n_heads=4,
                  n_kv_heads=2, d_ff=128, dtype="float32"),
    "moe": dict(family="moe", n_layers=3, d_model=64, vocab_size=128, n_heads=4, n_kv_heads=4,
                d_ff=64, n_experts=4, top_k=2, first_k_dense=1, capacity_factor=8.0,
                dtype="float32"),
    "ssm": dict(family="ssm", n_layers=3, d_model=64, vocab_size=128, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, dtype="float32"),
    "hyb": dict(family="hybrid", n_layers=4, d_model=64, vocab_size=128, n_heads=4,
                n_kv_heads=2, d_ff=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                swa_window=8, n_global_layers=2, dtype="float32"),
}


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def _lm_step_bytes(cfg, params, batch: int, ctx: int) -> tuple[int, int, int]:
    """Bytes a decode step must read at context ``ctx`` (the new token
    included): (parameters as the port reads them, the same with only the
    routed experts' weights a token, caches and recurrent state). An
    untied embedding table gives only the batch's rows; a tied one is also
    the output head, read whole. A codebook model's tables give the batch's
    rows of each, its heads are read whole. The port's MoE reads every
    expert's weights (C = 8 slots each at one token a group)."""
    from repro_torch.models.transformer import param_bytes

    esize = params["final_norm"].element_size()
    read = param_bytes(params)
    if "embed" in params and not cfg.tie_embeddings:
        read -= params["embed"].numel() * esize - batch * cfg.d_model * esize
    if "codebook_embed" in params:
        read -= (params["codebook_embed"].numel() * esize
                 - cfg.n_codebooks * batch * cfg.d_model * esize)
    active = read
    if cfg.family == "moe":
        moe_layers = cfg.n_layers - cfg.first_k_dense
        active -= moe_layers * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_ff * esize
    state = 0
    if cfg.family in ("dense", "moe", "hybrid"):
        for i in range(cfg.n_layers):
            w = cfg.attn_window(i)
            tokens = min(w, ctx) if w > 0 else ctx
            state += 2 * batch * tokens * cfg.n_kv_heads * cfg.head_dim * esize
    if cfg.family in ("ssm", "hybrid"):  # conv window and SSD state, read and written
        conv = (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * esize
        ssd = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        state += 2 * cfg.n_layers * batch * (conv + ssd)
    return read, active, state


class _RouteTape:
    """Stands in for `repro_torch.models.moe.route` during a consistency
    check: records the experts each MoE layer routes every token to in the
    forward pass, then hands the same experts to prefill (the prompt's
    tokens) and to the decode step (the new token), with the router weights
    of those experts' logits. Routing is a discontinuous function of the
    logits, so without it two paths whose roundings differ (matmul shapes)
    route a near-tied token apart and their logits part by O(1)."""

    def __init__(self, route):
        self.route, self.ids, self.replay, self.calls, self.offset = route, [], False, 0, 0

    def __call__(self, logits, top_k):
        import torch

        if not self.replay:
            ids, weights = self.route(logits, top_k)
            self.ids.append(ids)
            return ids, weights
        ids = self.ids[self.calls][:, self.offset : self.offset + logits.shape[1]]
        self.calls += 1
        return ids, torch.softmax(torch.gather(logits, -1, ids).float(), dim=-1)

    def play_from(self, offset: int) -> None:
        self.replay, self.calls, self.offset = True, 0, offset


def _cat_tok(prompts, tok):
    import torch

    return torch.cat([prompts, tok[:, None]], dim=1)


def _tempered(params: dict) -> dict:
    """``params`` with every attention stack's query and key projections
    scaled by LM_TEMPER (new tensors; the rest shared)."""
    out = dict(params)
    for key in ("blocks", "dense_blocks"):
        if "wq" in params.get(key, {}):
            out[key] = dict(params[key], wq=params[key]["wq"] * LM_TEMPER,
                            wk=params[key]["wk"] * LM_TEMPER)
    return out


def _lm_batch(cfg, tokens) -> dict:
    """`forward`'s batch over served ``tokens``: a codebook model's codes
    (B, S, K); a vision model's text alone, as it is served (no patch
    embeddings, the forward then computes what prefill does)."""
    if cfg.n_codebooks:
        return {"codes": tokens}
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = tokens.new_zeros((tokens.shape[0], 0, cfg.d_model))
    return batch


def _embed_key(cfg) -> str:
    return "codebook_embed" if cfg.n_codebooks else "embed"


def _lm_nudge(params, cfg, tokens) -> float:
    """How far the forward's last logits move when the embeddings are
    scaled by 1 + LM_NUDGE (relative to the largest logit): the
    conditioning of the logits the consistency check compares."""
    import torch

    from repro_torch.models.transformer import forward

    key = _embed_key(cfg)
    with torch.inference_mode():
        full, _ = forward(params, cfg, _lm_batch(cfg, tokens))
        nudged = dict(params, **{key: params[key] * (1 + LM_NUDGE)})
        moved, _ = forward(nudged, cfg, _lm_batch(cfg, tokens))
    return _rel_err(moved[:, -1], full[:, -1])


def _stacks(cfg) -> tuple:
    """(key, layers) of each layer-stacked dict, in the forward's order."""
    if cfg.family == "moe" and cfg.first_k_dense:
        return ("dense_blocks", cfg.first_k_dense), ("blocks", cfg.n_layers - cfg.first_k_dense)
    return (("blocks", cfg.n_layers),)


def _depth_cut(params: dict, cfg, k: int):
    """The first ``k`` layers of ``params`` (views) with the embeddings,
    the final norm and the head, and ``cfg`` at ``k`` layers."""
    import dataclasses

    if k == cfg.n_layers:
        return params, cfg
    out, left = dict(params), k
    for key, n in _stacks(cfg):
        if left < n:
            out[key] = {name: w[:left] for name, w in params[key].items()}
        left -= min(left, n)
    return out, dataclasses.replace(cfg, n_layers=k)


def _free_bytes(dev) -> int:
    import torch

    torch.cuda.empty_cache()  # the allocator's cached blocks count as used
    return torch.cuda.mem_get_info(dev)[0]


def _hold_depth(params: dict, cfg, dev) -> int:
    """The most layers whose f32 copy fits the card beside what it holds
    now: the copy's embeddings, norm and head, its first layers, and a
    second f32 embedding table (the nudge's), with LM_HOLD_HEADROOM left.
    Every layer where the whole model's copy fits."""
    from repro_torch.models.transformer import _leaves

    room = _free_bytes(dev) - LM_HOLD_HEADROOM
    need = 4 * (params[_embed_key(cfg)].numel() + sum(
        w.numel() for key, w in _leaves(params) if key.split("/")[0] not in
        ("blocks", "dense_blocks")))
    k = 0
    for key, n in _stacks(cfg):
        layer = 4 * sum(w.numel() for w in params[key].values()) // n
        fit = min(n, max(0, (room - need) // layer))
        need, k = need + fit * layer, k + fit
        if fit < n:
            break
    if k < min(cfg.n_layers, 1 + (cfg.first_k_dense if cfg.family == "moe" else 0)):
        raise SystemExit(f"{cfg.name}: no f32 hold fits beside the bf16 weights ({room} B free "
                         f"past the headroom, {need} B needed)")
    return k


def _device_busy(step, n: int) -> tuple[float | None, float]:
    """The card's busy ms a call of ``step`` and the device activities
    (kernels, copies, fills) a call runs, from a `torch.profiler` trace of
    ``n`` calls (CUPTI, device activities only): the activities of one
    stream do not overlap, so their durations add up to the time the card
    works. The trace's raw events are summed: parsing them into the
    profiler's event tree, with host activities recorded too, takes seconds
    a trace. None where the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # (a host without CUDA records host activities only: no device time)
    activity = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    results = prof.profiler.kineto_results
    device = [e for e in (results.events() if results else [])
              if e.device_type() == DeviceType.CUDA]
    busy_ms = sum(e.duration_ns() for e in device) / 1e6 / n
    return (busy_ms if device else None), len(device) / n


def _lm_device_step(params, cfg, prompts, tok0) -> tuple[float | None, float]:
    """The card's busy ms a decode step and the device activities it runs
    (`_device_busy` over LM_DEVICE_STEPS steps)."""
    import torch

    from repro_torch.models import serve as lm_serve

    n, S = LM_DEVICE_STEPS, prompts.shape[1]
    with torch.inference_mode():
        _, cache = lm_serve.prefill(params, cfg, prompts, max_len=S + n + 1)
        box = [lm_serve.decode_step(params, cfg, tok0, cache)[1]]  # warm

        def step():
            box[0] = lm_serve.decode_step(params, cfg, tok0, box[0])[1]

        return _device_busy(step, n)


def _lm_consistency(params, cfg, prompts, tok0, logits=None,
                    pages: tuple = (False,)) -> list[tuple[float, float]]:
    """Serving into each cache of ``pages`` (a paged KV cache where True)
    against the forward pass over the prompt plus ``tok0``, computed once:
    the relative errors of prefill's logits and of the first decode step's,
    a pair a cache. ``logits`` are a contiguous cache's prefill and step
    logits where a run already made them. For a MoE config serving routes
    every token as the forward did (`_RouteTape`)."""
    import torch

    from repro_torch.models import moe as moe_lib
    from repro_torch.models import serve as lm_serve
    from repro_torch.models.transformer import forward

    S = prompts.shape[1]
    serves = logits is None or any(pages)
    tape = _RouteTape(moe_lib.route) if cfg.family == "moe" and serves else None
    errs = []
    try:
        if tape is not None:
            moe_lib.route = tape
        with torch.inference_mode():
            full, _ = forward(params, cfg, _lm_batch(cfg, _cat_tok(prompts, tok0)))
            for paged in pages:
                if logits is None or paged:
                    if tape is not None:
                        tape.play_from(0)
                    pre, cache = lm_serve.prefill(params, cfg, prompts, max_len=S + 1,
                                                  paged=paged)
                    if tape is not None:
                        tape.play_from(S)
                    step, _ = lm_serve.decode_step(params, cfg, tok0, cache)
                    if tape is not None and tape.calls != len(tape.ids):
                        raise SystemExit(f"{cfg.name}: the decode step replayed {tape.calls} "
                                         f"of {len(tape.ids)} MoE layers' routing")
                else:
                    pre, step = logits
                errs.append((_rel_err(pre, full[:, S - 1]), _rel_err(step, full[:, S])))
    finally:
        if tape is not None:
            moe_lib.route = tape.route
    return errs


def lm_full_width(dev, arch: str, paged: bool) -> None:
    """13 (a) for one arch: served through the entry point (bf16, full
    CONFIG), checked against the forward pass in bf16 and, on the same
    weights widened to f32, in f32; paged against contiguous; timed and
    bounded."""
    import dataclasses

    import torch

    from repro_torch.launch import serve as serve_cmd
    from repro_torch.models.transformer import param_count

    argv = ["--arch", arch, "--full", "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
            "--tokens", str(LM_TOKENS), "--device", str(dev)]
    B = LM_BATCH
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    run = serve_cmd.main(argv)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, tok0 = run.cfg, run.params, run.tokens[0]
    if cfg.dtype != "bfloat16" or not all(bool(torch.isfinite(lg).all()) for lg in run.logits):
        raise SystemExit(f"{arch}: logits not all finite, or not bf16 ({cfg.dtype})")

    # check 1: serving against the forward pass over the prompt plus tok0
    check_cfg, logits = cfg, run.logits[:2]
    if cfg.family == "moe":
        # forward over S + 1 tokens a group drops assignments at capacity
        # that decode (one token a group, 8 slots an expert) never drops, and
        # the two paths route near-tied tokens apart: print that gap, then
        # hold serving to the forward at a capacity at which neither drops
        # (C >= the group's tokens), each token routed as in the forward
        gap = _lm_consistency(params, cfg, run.prompts, tok0, logits)[0]
        print(f"  {arch} as served (capacity_factor {cfg.capacity_factor:g}, own routing): "
              f"prefill vs forward rel err {gap[0]:.6f}, decode step 1 vs forward {gap[1]:.6f} "
              f"(printed, not checked)")
        check_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        logits = None
    # the f32 hold: the same weights widened, at full depth where their f32
    # copy fits the card beside the bf16 ones, else on the first k layers
    # (the embeddings, norm and head kept) at the full widths
    k = _hold_depth(params, check_cfg, dev)
    cut, cut_cfg = _depth_cut(params, check_cfg, k)
    f32_cfg = dataclasses.replace(cut_cfg, dtype="float32")
    hold = "" if k == cfg.n_layers else f" on the first {k} of {cfg.n_layers} layers"
    wide = _tree_to(cut, None)
    nudge = _lm_nudge(wide, f32_cfg, _cat_tok(run.prompts, tok0))
    conditioned = nudge <= LM_CONDITIONED
    print(f"  {arch}: a {LM_NUDGE:g} nudge of the embeddings moves the f32 forward's last "
          f"logits{hold} by {nudge:.3e} of the largest: the served weights are "
          f"{'' if conditioned else 'not '}held (bound {LM_CONDITIONED:g})"
          + (f"; the f32 hold runs{hold} with the embeddings, final norm and head, the most "
             f"layers whose f32 copy fits beside the bf16 weights, and the conditioning was "
             f"read on that cut, not at the full depth the bf16 checks run at" if hold else ""))
    passes = [("served weights", False)]
    if cfg.family != "ssm":  # attention to temper
        passes.append((f"q, k x {LM_TEMPER:g}", True))
    pages = (False, True)[: 1 + paged]
    for label, temper in passes:
        weights = params
        if temper:
            copy = sum(params[key][w].numel() * params[key][w].element_size()
                       for key, _ in _stacks(cfg) for w in ("wq", "wk"))
            free = _free_bytes(dev)
            if copy + LM_HOLD_HEADROOM > free:
                raise SystemExit(f"{arch}: a tempered copy of q and k ({copy} B) does not fit "
                                 f"the card's {free} B free")
            weights = _tempered(params)
        e16 = _lm_consistency(weights, check_cfg, run.prompts, tok0,
                              None if temper else logits, pages)
        del weights
        if temper:
            wide = _tree_to(_tempered(cut), None)
        e32 = _lm_consistency(wide, f32_cfg, run.prompts, tok0, pages=pages)
        del wide
        checked = temper or conditioned
        for pg, a, b in zip(pages, e16, e32):
            cache = "paged cache" if pg else LM_CACHES[cfg.family]
            print(f"  {arch} consistency, {label}, {cache}"
                  f"{', routed as the forward' if cfg.family == 'moe' else ''}: bf16 prefill vs "
                  f"forward rel err {a[0]:.6f}, decode step 1 {a[1]:.6f} (bound "
                  f"{LM_BF16_REL_TOL}); in f32{hold} {b[0]:.3e}, {b[1]:.3e} (bound "
                  f"{LM_F32_REL_TOL}){'' if checked else '; printed, not checked'}")
            if checked and (max(a) > LM_BF16_REL_TOL or max(b) > LM_F32_REL_TOL):
                raise SystemExit(f"{arch}: {cache} serving disagrees with the forward pass "
                                 f"({label})")
    del cut

    step_ms = (run.decode_s - run.first_step_s) / (LM_TOKENS - 1) * 1e3
    device_ms, activities = _lm_device_step(params, cfg, run.prompts, tok0)
    read, active, state = _lm_step_bytes(cfg, params, B, LM_PROMPT + LM_TOKENS)
    bound_ms = (read + state) / HBM_BYTES_PER_S * 1e3
    note = ""
    if cfg.family == "moe":
        note = (f"; reads all {cfg.n_experts} experts a step (8 slots each at one token a "
                f"group): with only the {cfg.top_k} routed a token it would be {active} B, "
                f"{(active + state) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    print(f"lm serve {arch}: params={param_count(params)} "
          f"prefill_s={run.prefill_s:.4f} decode_s={run.decode_s:.4f} "
          f"tok_per_s={LM_TOKENS * B / run.decode_s:.1f} first_step_ms={run.first_step_s * 1e3:.3f} "
          f"step_ms={step_ms:.3f} (steps 2-{LM_TOKENS}) steady_tok_per_s={B / step_ms * 1e3:.1f} "
          f"peak_device_bytes={peak} (at start {base}; the card holds "
          f"{torch.cuda.get_device_properties(dev).total_memory}) bound_ms={bound_ms:.4f} "
          f"(bytes: {read} B of parameters + {state} B of caches and state a step at the last "
          f"step's context, over {HBM_BYTES_PER_S / 1e12:.2f} TB/s){note} "
          f"step/bound={step_ms / bound_ms:.2f} device_busy_ms="
          + (f"{device_ms:.3f} a step (profiler, {LM_DEVICE_STEPS} steps, "
             f"{activities:.0f} device activities a step) device_busy_share="
             f"{device_ms / step_ms:.3f}" if device_ms is not None
             else "not measured (no device activity in the profiler's trace)"))
    if cfg.frontend == "vision":
        _lm_vision_pass(params, cfg, dev)
    contiguous = [lg.clone() for lg in run.logits[:2]]
    del run, params
    torch.cuda.empty_cache()
    if not paged:
        return

    # check 2: paged against contiguous, the same weights (the same seed)
    torch.cuda.reset_peak_memory_stats(dev)
    paged_run = serve_cmd.main(argv + ["--paged"])
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(bool(torch.isfinite(lg).all()) for lg in paged_run.logits):
        raise SystemExit(f"{arch} paged: logits not all finite")
    e_pre = _rel_err(paged_run.logits[0], contiguous[0])
    e_step = _rel_err(paged_run.logits[1], contiguous[1])
    step_ms = (paged_run.decode_s - paged_run.first_step_s) / (LM_TOKENS - 1) * 1e3
    print(f"  {arch} paged vs contiguous, as served: prefill rel err {e_pre:.6f}, decode "
          f"step 1 {e_step:.6f} (bound {LM_BF16_REL_TOL})"
          f"{'' if conditioned else '; printed, not checked (the nudge above)'}")
    print(f"lm serve {arch} paged: prefill_s={paged_run.prefill_s:.4f} "
          f"decode_s={paged_run.decode_s:.4f} tok_per_s={LM_TOKENS * B / paged_run.decode_s:.1f} "
          f"step_ms={step_ms:.3f} peak_device_bytes={peak}")
    if conditioned and max(e_pre, e_step) > LM_BF16_REL_TOL:
        raise SystemExit(f"{arch}: paged serving disagrees with contiguous")
    del paged_run
    torch.cuda.empty_cache()


def _lm_vision_pass(params, cfg, dev) -> None:
    """A vision model's patch input at its real size, which serving (text
    only, as the reference's) never takes: one no-grad bf16 `forward` and
    `lm_loss` over LM_BATCH sequences of ``n_patches`` seeded patch
    embeddings (made as `launch.train.synth_batch` makes them) and
    LM_PROMPT tokens; logits and loss finite, loss, seconds and peak
    printed."""
    import numpy as np
    import torch

    from repro_torch.launch.train import synth_batch
    from repro_torch.models.transformer import forward, lm_loss

    batch = synth_batch(cfg, np.random.default_rng(0), LM_BATCH, LM_PROMPT, dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = forward(params, cfg, batch)
        finite = bool(torch.isfinite(logits).all())
        t1 = time.perf_counter()
        loss, _ = lm_loss(params, cfg, batch, remat=False)
        loss = float(loss)
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    S = cfg.n_patches + LM_PROMPT
    shape = tuple(logits.shape)
    if shape != (LM_BATCH, S, cfg.vocab_size) or not finite or not math.isfinite(loss):
        raise SystemExit(f"{cfg.name}: the vision forward gave {shape} logits "
                         f"(finite: {finite}) and loss {loss}")
    print(f"lm vision {cfg.name}: batch {LM_BATCH} x ({cfg.n_patches} patch embeddings + "
          f"{LM_PROMPT} tokens) at d_model {cfg.d_model}, bf16, no grad: forward_s={t1 - t0:.4f} "
          f"(logits {shape} finite) lm_loss={loss:.4f} (ln V = "
          f"{math.log(cfg.vocab_size):.4f}) lm_loss_s={t2 - t1:.4f} peak_device_bytes={peak} "
          f"(at start {base})")
    del logits, batch


def _teacher_forced(params, cfg, prompts, toks) -> list:
    """Prefill over ``prompts``, then a decode step on each of ``toks``
    (the served tokens, in order): every step's logits, prefill's first."""
    import torch

    from repro_torch.models import serve as lm_serve

    with torch.inference_mode():
        lg, cache = lm_serve.prefill(params, cfg, prompts, max_len=prompts.shape[1] + len(toks))
        out = [lg]
        for tok in toks:
            lg, cache = lm_serve.decode_step(params, cfg, tok, cache)
            out.append(lg)
    return out


def _ring_gap(params, cfg, prompts, toks, served=None) -> float:
    """The largest relative error of serving's logits (``served``, else
    served here teacher-forced on ``toks``) against the forward over the
    prompt and ``toks``."""
    import torch

    from repro_torch.models.transformer import forward

    S = prompts.shape[1]
    served = served or _teacher_forced(params, cfg, prompts, toks)
    with torch.inference_mode():
        full, _ = forward(params, cfg, _lm_batch(cfg, torch.cat([prompts] + [
            t[:, None] for t in toks], dim=1)))
    return max(_rel_err(lg, full[:, S - 1 + i]) for i, lg in enumerate(served))


def lm_ring_wrap(dev) -> None:
    """13 (a) for hymba-1.5b past its ring: served through the entry point
    (bf16, full CONFIG) from a prompt longer than its sliding window, so
    that prefill wraps every window layer's ring and each decode step writes
    over its oldest slot; prefill's and every decode step's logits against
    the forward over the same tokens, in bf16 and on the weights widened to
    f32 (served weights where the nudge allows, and q, k tempered)."""
    import dataclasses

    import torch

    from repro_torch.launch import serve as serve_cmd

    arch = "hymba-1.5b"
    argv = ["--arch", arch, "--full", "--batch", str(LM_RING_BATCH), "--prompt-len",
            str(LM_RING_PROMPT), "--tokens", str(LM_TOKENS), "--device", str(dev)]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run = serve_cmd.main(argv)
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, params, prompts = run.cfg, run.params, run.prompts
    window = max(cfg.attn_window(i) for i in range(cfg.n_layers))
    if not 0 < window < LM_RING_PROMPT:
        raise SystemExit(f"{arch}: a {LM_RING_PROMPT}-token prompt does not wrap a "
                         f"{window}-slot ring")
    if not all(bool(torch.isfinite(lg).all()) for lg in run.logits):
        raise SystemExit(f"{arch} ring: logits not all finite")
    toks = run.tokens[:LM_TOKENS]  # the tokens the decode steps took
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    wide = _tree_to(params, None)
    nudge = _lm_nudge(wide, f32_cfg, torch.cat([prompts] + [t[:, None] for t in toks], dim=1))
    conditioned = nudge <= LM_CONDITIONED
    step_ms = (run.decode_s - run.first_step_s) / (LM_TOKENS - 1) * 1e3
    print(f"lm serve {arch} ring: batch {LM_RING_BATCH}, prompt {LM_RING_PROMPT} past the "
          f"{window}-slot ring of {sum(cfg.attn_window(i) > 0 for i in range(cfg.n_layers))} "
          f"of {cfg.n_layers} layers, {LM_TOKENS} decode steps to position "
          f"{LM_RING_PROMPT + LM_TOKENS - 1}: prefill_s={run.prefill_s:.4f} "
          f"step_ms={step_ms:.3f} (steps 2-{LM_TOKENS}) peak_device_bytes={peak}; a "
          f"{LM_NUDGE:g} nudge moves the f32 logits by {nudge:.3e}: the served weights are "
          f"{'' if conditioned else 'not '}held (bound {LM_CONDITIONED:g})")
    for label, temper in (("served weights", False), (f"q, k x {LM_TEMPER:g}", True)):
        if temper:
            del wide
            weights = _tempered(params)
            e16 = _ring_gap(weights, cfg, prompts, toks)
            wide = _tree_to(weights, None)
            del weights
        else:
            e16 = _ring_gap(params, cfg, prompts, toks, served=run.logits)
        e32 = _ring_gap(wide, f32_cfg, prompts, toks)
        checked = temper or conditioned
        print(f"  {arch} ring consistency, {label}: prefill and {LM_TOKENS} decode steps vs "
              f"forward, largest rel err bf16 {e16:.6f} (bound {LM_BF16_REL_TOL}), f32 "
              f"{e32:.3e} (bound {LM_F32_REL_TOL}){'' if checked else '; printed, not checked'}")
        if checked and (e16 > LM_BF16_REL_TOL or e32 > LM_F32_REL_TOL):
            raise SystemExit(f"{arch}: serving past the ring disagrees with the forward pass "
                             f"({label})")
    del run, params, wide
    torch.cuda.empty_cache()


def _tree_to(tree: dict, dev) -> dict:
    """A parameter tree moved to ``dev``, or widened to f32 where ``dev`` is None."""
    return {k: _tree_to(v, dev) if isinstance(v, dict) else (v.float() if dev is None else
                                                               v.to(dev))
            for k, v in tree.items()}


def lm_card_vs_cpu(dev) -> None:
    """13 (b): every arch at REDUCED (f32) and the four serve cases: the same
    weights serve prefill and LM_CPU_STEPS greedy decode steps on the card and
    on the host, through the same functions."""
    import torch

    from repro_torch.configs.registry import LM_ARCHS, get_config
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.serve import decode_step, prefill
    from repro_torch.models.transformer import init_params

    B, S = 2, 24
    cpu = torch.device("cpu")
    cfgs = [get_config(a, reduced=True) for a in LM_ARCHS]
    cfgs += [ModelConfig(name=f"case-{k}", **kw) for k, kw in LM_CASES.items()]
    worst, runs = 0.0, 0
    for cfg in cfgs:
        params = init_params(cfg, torch.Generator().manual_seed(0), cpu)
        on_card = _tree_to(params, dev)
        rng = torch.Generator().manual_seed(1)
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        prompts = torch.randint(0, cfg.vocab_size, shape, generator=rng)
        for paged in ((False, True) if cfg.family in ("dense", "moe") else (False,)):
            got = []
            with torch.inference_mode():
                for p, d in ((params, cpu), (on_card, dev)):
                    lg, cache = prefill(p, cfg, prompts.to(d), max_len=S + LM_CPU_STEPS,
                                        paged=paged)
                    steps = [lg.cpu()]
                    for _ in range(LM_CPU_STEPS):
                        lg, cache = decode_step(p, cfg, torch.argmax(lg, -1), cache)
                        steps.append(lg.cpu())
                    got.append(steps)
            for i, (a, b) in enumerate(zip(got[1], got[0])):
                if not torch.allclose(a, b, rtol=LM_F32_RTOL, atol=LM_F32_ATOL):
                    raise SystemExit(f"{cfg.name}{' paged' if paged else ''}: card and CPU "
                                     f"logits differ at step {i}: max "
                                     f"{float((a - b).abs().max()):.3e}")
                if not torch.equal(a.argmax(-1), b.argmax(-1)):
                    raise SystemExit(f"{cfg.name}: card and CPU greedy tokens differ at step {i}")
                worst = max(worst, float((a - b).abs().max()))
            runs += 1
    print(f"lm card vs cpu: {len(cfgs)} configs ({len(LM_ARCHS)} archs at REDUCED + "
          f"{len(LM_CASES)} serve cases), {runs} runs of prefill + {LM_CPU_STEPS} decode steps at "
          f"f32: logits within rtol=atol={LM_F32_RTOL} (max |diff| {worst:.3e}), greedy tokens "
          f"equal")


def lm_serving_phase(dev) -> dict:
    """Phase 13: LM serving on the card. Returns its launch counts of the
    port's kernels (it launches none of them: the models' products are
    torch matmuls, as the reference's are jnp)."""
    import torch

    from repro_torch.kernels import launch_counts as read_counts
    from repro_torch.kernels import reset_launch_counts as zero_counts

    # the f32 hold against the CPU needs full-precision f32 matmuls:
    # PyTorch's default, which this phase checks and does not set
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("TF32 matmuls are enabled; the f32 card-vs-CPU hold needs them off")
    t0 = time.perf_counter()
    zero_counts()
    for arch, paged in LM_FULL:
        t = time.perf_counter()
        lm_full_width(dev, arch, paged)
        print(f"  {arch}: 13 (a) took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    lm_ring_wrap(dev)
    print(f"  hymba-1.5b past its ring: took {time.perf_counter() - t:.1f} s")
    lm_card_vs_cpu(dev)
    counts = read_counts()
    print(f"lm serving path launches: {json.dumps(counts)} ({time.perf_counter() - t0:.1f} s)")
    return counts


# ----------------------------------------------------- phase 14: LM training
# (a): through the training entry point at full CONFIG in bf16; olmoe-1b-7b
# (6.9 B parameters, ~12 bytes each with its AdamW state) at full width
# with fewer layers, through the step functions
TRAIN_BATCH, TRAIN_SEQ = 4, 512
# the archs whose step one card holds, by `train_peak_reckoned`: musicgen-large
# reckons 72,782,962,732 B; phi3-mini-3.8b, at 85,405,935,660 B, is past one card
TRAIN_FULL = (("llama3.2-1b", 8), ("mamba2-130m", 3), ("hymba-1.5b", 3), ("smollm-135m", 3),
              ("minicpm-2b", 3), ("musicgen-large", 3))
TRAIN_RESUME_STEPS = 2  # mamba2-130m's steps after --resume
TRAIN_PROFILED_STEPS = 2  # steps traced for the card's busy time
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
# a step's peak over its parameters: bf16 weights and gradients, f32 AdamW
# moments (12 B a parameter), and the update's new weights and moments (10 B)
TRAIN_BYTES_PER_PARAM = 22
TRAIN_HEADROOM = 12 * 2**30  # activations, logits, the update's f32 chunks
# (c): the CPU tests' holds (tests/test_torch_train.py)
TRAIN_OC = dict(peak_lr=1e-2, warmup_steps=2, total_steps=40, schedule="wsd")
TRAIN_TEMPER = 0.1
TRAIN_PARAM_ATOL = 1e-3 * TRAIN_OC["peak_lr"]
TRAIN_SMALL_GRAD = 1e-3
TRAIN_MAX_PAST = 1e-3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4


def _finite(run, arch: str) -> None:
    bad = [m for m in run.metrics if not all(math.isfinite(v) for v in m.values())]
    if bad or not run.metrics:
        raise SystemExit(f"{arch}: a training step gave a non-finite metric: {bad[:1]}")


def _train_busy_ms(state, batch: dict, step_fn, uniforms=None) -> float | None:
    """The card's busy ms a step (`_device_busy` over TRAIN_PROFILED_STEPS
    steps from ``state``), None where the trace holds no device activity.
    The steps make new states: the caller hands over its only reference to
    ``state``, so that two states at most are alive at once."""
    box = [state]
    del state

    def step():
        args = (box[0], batch) if uniforms is None else (box[0], batch, uniforms)
        box[0], metrics = step_fn(*args)
        float(metrics["loss"])

    return _device_busy(step, TRAIN_PROFILED_STEPS)[0]


def _train_report(label: str, cfg, n: int, step_s: list, peak: int, busy_ms) -> None:
    """The printed line of a (a) run: ``n`` parameters, each step's host
    seconds, the peak device bytes and the card's busy ms a step. The FLOP
    bound counts the parameters a token meets (a MoE token its top-k
    experts): forward, the remat recompute and a backward of twice the
    forward are 8 FLOPs a parameter a token."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = step_s[1:] or step_s
    step_ms = sorted(steady)[len(steady) // 2] * 1e3
    active = cfg.active_param_count()
    bound_ms = 8 * active * tokens / BF16_FLOPS_PER_S * 1e3
    busy = (f"device_busy_ms={busy_ms:.3f} a step (profiler, {TRAIN_PROFILED_STEPS} steps) "
            f"device_busy_share={busy_ms / step_ms:.3f}" if busy_ms is not None
            else "device_busy_ms=not measured (no device activity in the profiler's trace)")
    print(f"lm train {label}: params={n} batch={TRAIN_BATCH} seq={TRAIN_SEQ} "
          f"first_step_ms={step_s[0] * 1e3:.1f} step_ms={step_ms:.1f} (median of steps "
          f"2-{len(step_s)}) tok_per_s={tokens / step_ms * 1e3:.0f} peak_device_bytes={peak} "
          f"flop_bound_ms={bound_ms:.3f} (8 x {active} active params x {tokens} tokens over "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16) step/bound={step_ms / bound_ms:.1f} "
          + busy)


def _synth(cfg, dev, seed: int = 1) -> dict:
    import numpy as np

    from repro_torch.launch.train import synth_batch

    return synth_batch(cfg, np.random.default_rng(seed), TRAIN_BATCH, TRAIN_SEQ, dev)


def lm_train_full(dev, arch: str, steps: int, ckpt_root: str) -> None:
    """14 (a) for one arch, through the entry point (full CONFIG, bf16)."""
    import torch

    from repro_torch.configs.registry import get_module
    from repro_torch.launch import train as train_cmd
    from repro_torch.models.transformer import param_count
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.train_step import TrainConfig, make_mvs_train_step, make_train_step

    base = ["--arch", arch, "--full", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--device", str(dev)]
    ckpt = os.path.join(ckpt_root, arch) if arch == "mamba2-130m" else None
    runs = [("", [])]
    if arch == "llama3.2-1b":
        runs.append((" mvs f=0.5", ["--mvs-f", "0.5"]))
    for label, extra in runs:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        argv = base + ["--steps", str(steps)] + extra + (["--ckpt-dir", ckpt] if ckpt else [])
        run = train_cmd.main(argv)
        peak = torch.cuda.max_memory_allocated(dev)
        _finite(run, arch)
        if run.cfg.dtype != "bfloat16":
            raise SystemExit(f"{arch}: trained in {run.cfg.dtype}, not bf16")
        losses = [round(m["loss"], 4) for m in run.metrics]
        line = f"  {arch}{label}: losses {losses}, grad norms " + str(
            [round(m["grad_norm"], 3) for m in run.metrics])
        schedule = getattr(get_module(arch), "PREFERRED_SCHEDULE", "cosine")
        line += f", {schedule} lr " + str([float(f"{m['lr']:.3g}") for m in run.metrics])
        uniforms = None
        if extra:
            # Poisson sampling may keep no sequence of a batch in a step (its
            # loss is then 0): each step's fraction lies in [0, 1], the run's in (0, 1]
            kept = [m["kept"] for m in run.metrics]
            if not (all(0.0 <= k <= 1.0 for k in kept) and 0.0 < sum(kept) / len(kept) <= 1.0):
                raise SystemExit(f"{arch}: MVS kept fractions {kept} outside [0, 1], or "
                                 f"their mean outside (0, 1]")
            line += f", kept {kept} (mean {sum(kept) / len(kept):.3f})"
        print(line)
        oc = OptConfig(peak_lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps,
                       schedule=schedule)
        batch = _synth(run.cfg, dev)
        if extra:
            step_fn = make_mvs_train_step(run.cfg, oc, TrainConfig(mvs_f=0.5))
            uniforms = torch.rand(TRAIN_BATCH, generator=torch.Generator(device=dev)
                                  .manual_seed(5), device=dev)
        else:
            step_fn = make_train_step(run.cfg, oc)
        n = param_count(run.state.params)
        if ckpt:
            # the checkpoint restores the state the run ended with, bit for bit
            restored, at = restore_checkpoint(ckpt, run.state)
            same = at == steps and all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(tree_leaves(tuple(run.state)), tree_leaves(tuple(restored))))
            nbytes = os.path.getsize(os.path.join(ckpt, "ckpt.npz"))
            if not same:
                raise SystemExit(f"{arch}: the restored state differs from the saved one")
            del restored
            later = train_cmd.main(base + ["--steps", str(steps + TRAIN_RESUME_STEPS),
                                           "--ckpt-dir", ckpt, "--resume"])
            _finite(later, arch)
            if later.start != steps or len(later.metrics) != TRAIN_RESUME_STEPS:
                raise SystemExit(f"{arch}: resume started at {later.start} and ran "
                                 f"{len(later.metrics)} steps")
            print(f"  {arch}: checkpoint of {nbytes} B at step {steps} restored bit for bit; "
                  f"--resume ran steps {steps}-{steps + TRAIN_RESUME_STEPS - 1}, losses "
                  f"{[round(m['loss'], 4) for m in later.metrics]}")
            del later
        # the trace's steps make new states: hand it the only reference to
        # the run's, so that two states at most are alive at once
        held, run.state = [run.state], None
        busy = _train_busy_ms(held.pop(), batch, step_fn, uniforms)
        _train_report(f"{arch}{label}", run.cfg, n, run.step_s, peak, busy)
        del run, step_fn, batch
        torch.cuda.empty_cache()


def lm_train_olmoe(dev, steps: int = 3) -> None:
    """14 (a) for olmoe-1b-7b: its full width, its depth cut to fit the card."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.transformer import param_count
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_state, make_train_step

    full = get_config("olmoe-1b-7b")
    per_layer = (dataclasses.replace(full, n_layers=2).param_count()
                 - dataclasses.replace(full, n_layers=1).param_count())
    outside = dataclasses.replace(full, n_layers=1).param_count() - per_layer
    torch.cuda.empty_cache()  # the earlier phases' cached blocks count as used
    free, total = torch.cuda.mem_get_info(dev)
    room = min(free, total) - TRAIN_HEADROOM
    depth = max(1, min(full.n_layers, (room // TRAIN_BYTES_PER_PARAM - outside) // per_layer))
    cfg = dataclasses.replace(full, n_layers=int(depth))
    print(f"  olmoe-1b-7b: full width (d_model {cfg.d_model}, {cfg.n_experts} experts, "
          f"top-{cfg.top_k}) at {depth} of {full.n_layers} layers ({cfg.param_count()} of "
          f"{full.param_count()} parameters; {TRAIN_BYTES_PER_PARAM} B a parameter at the "
          f"update's peak, {free} B free of {total})")
    oc = OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_state(cfg, oc, torch.Generator(device=dev).manual_seed(0), dev)
    step = make_train_step(cfg, oc)
    rng = np.random.default_rng(0)
    metrics, step_s = [], []
    for _ in range(steps):
        batch = synth_batch(cfg, rng, TRAIN_BATCH, TRAIN_SEQ, dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise SystemExit(f"olmoe-1b-7b: a non-finite metric: {metrics}")
    print(f"  olmoe-1b-7b x{depth}: losses {[round(m['loss'], 4) for m in metrics]}, "
          f"moe_aux {[round(m['moe_aux'], 4) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in metrics]}")
    n = param_count(state.params)
    # the trace's steps make new states: hand it the only reference to this
    # one, so that two states at most are alive at once (the byte budget above)
    held = [state]
    del state
    busy = _train_busy_ms(held.pop(), _synth(cfg, dev), step)
    _train_report(f"olmoe-1b-7b x{depth} layers", cfg, n, step_s, peak, busy)
    del step
    torch.cuda.empty_cache()


def lm_memorise(dev, steps: int = 20) -> None:
    """14 (b): one fixed batch, llama3.2-1b REDUCED: the loss must fall."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = get_config("llama3.2-1b", reduced=True)
    oc = OptConfig(**TRAIN_OC)
    state = init_state(cfg, oc, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 32))).to(dev)}
    step = make_train_step(cfg, oc)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"memorisation: the loss did not fall: {losses}")
    print(f"lm train memorisation (llama3.2-1b REDUCED, one batch of 8 x 32, {steps} steps): "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


def _tempered_leaves(params: dict) -> dict:
    for stack in ("blocks", "dense_blocks"):
        for w in ("wq", "wk", "in_proj"):
            if w in params.get(stack, {}):
                params[stack][w] = params[stack][w] * TRAIN_TEMPER
    return params


def lm_train_card_vs_cpu(dev) -> None:
    """14 (c): one train step and one MVS step of every REDUCED arch (f32) on
    the card and on the CPU from the same weights and uniforms."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import LM_ARCHS, get_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models.transformer import _leaves, init_params
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import (
        TrainConfig,
        TrainState,
        make_mvs_train_step,
        make_train_step,
    )

    cpu = torch.device("cpu")
    oc = OptConfig(**TRAIN_OC)
    worst = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0}
    n_past = n_all = runs = 0
    for arch in LM_ARCHS:
        cfg = get_config(arch, reduced=True)
        params = _tempered_leaves(init_params(cfg, torch.Generator().manual_seed(0), cpu))
        host = synth_batch(cfg, np.random.default_rng(2), 4, 24, cpu)
        kinds = [("step", make_train_step(cfg, oc), None)]
        if not cfg.n_codebooks and cfg.frontend != "vision":
            u = torch.rand(4, generator=torch.Generator().manual_seed(3))
            kinds.append(("mvs", make_mvs_train_step(cfg, oc, TrainConfig(mvs_f=0.5)), u))
        for kind, step, u in kinds:
            out = []
            for d in (cpu, dev):
                p = _tree_to(params, d)
                state = TrainState(p, adamw_init(p, oc))
                batch = {k: v.to(d) for k, v in host.items()}
                new, m = step(state, batch) if u is None else step(state, batch, u.to(d))
                out.append((new, {k: float(v) for k, v in m.items()}))
            (want, wm), (got, gm) = out
            for key, rtol in (("loss", TRAIN_LOSS_RTOL), ("grad_norm", TRAIN_GNORM_RTOL)):
                err = abs(gm[key] - wm[key]) / abs(wm[key])
                worst[key] = max(worst[key], err)
                if err > rtol:
                    raise SystemExit(f"{arch} {kind}: card {key} {gm[key]} vs CPU {wm[key]}")
            if gm.get("kept") != wm.get("kept"):
                raise SystemExit(f"{arch} mvs: kept {gm.get('kept')} vs CPU {wm.get('kept')}")
            m_want = dict(_leaves(want.opt.m))
            for key, p_want in _leaves(want.params):
                g = (m_want[key].double() / (1 - oc.b1)).abs()  # step 1: m = (1 - b1) g
                small = g < TRAIN_SMALL_GRAD * g.max()
                diff = (dict(_leaves(got.params))[key].cpu().double() - p_want.double()).abs()
                past = diff > TRAIN_PARAM_ATOL
                worst["param"] = max(worst["param"], float(diff[~small].max()) if
                                     bool((~small).any()) else 0.0)
                if bool((past & ~small).any()) or float(diff.max()) > 2 * wm["lr"]:
                    raise SystemExit(f"{arch} {kind}: {key} on the card differs from the CPU "
                                     f"by {float(diff.max()):.3e}")
                n_past += int(past.sum())
                n_all += diff.numel()
            runs += 1
            del out, want, got
    if n_past > TRAIN_MAX_PAST * n_all:
        raise SystemExit(f"lm train card vs cpu: {n_past} of {n_all} parameters past "
                         f"{TRAIN_PARAM_ATOL}")
    print(f"lm train card vs cpu: {len(LM_ARCHS)} REDUCED archs at f32, {runs} steps (train and "
          f"MVS): loss within rtol {TRAIN_LOSS_RTOL} (max {worst['loss']:.3e}), grad norm "
          f"within {TRAIN_GNORM_RTOL} (max {worst['grad_norm']:.3e}), updated parameters with "
          f"sizeable gradients within {TRAIN_PARAM_ATOL:g} (max {worst['param']:.3e}); "
          f"{n_past} of {n_all} small-gradient elements past it")


def lm_train_examples() -> None:
    """14 (d): the LM and GBDT quickstart examples on the card, defaults,
    in two subprocesses started together (most of each is its start)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [(script, subprocess.Popen([sys.executable, str(ROOT / script)], env=env, cwd=ROOT,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True))
             for script in ("examples/torch_mvs_lm_training.py", "examples/torch_quickstart.py")]
    try:
        for script, proc in procs:
            out, err = proc.communicate(timeout=max(1.0, t0 + 300 - time.perf_counter()))
            if proc.returncode != 0:
                raise SystemExit(f"{script} exited {proc.returncode}: {err[-2000:]}")
            tail = " | ".join(out.strip().splitlines()[-2:])
            print(f"example {script}: exit 0 in {time.perf_counter() - t0:.1f} s: {tail}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def train_peak_reckoned(arch: str, mesh: tuple[int, int] = (1, 1),
                        layers: int | None = None) -> None:
    """Prints the dry run of one training step of ``arch`` at TRAIN_BATCH x
    TRAIN_SEQ in bf16 on a ``(data, model)`` mesh (a fake world of its size,
    meta tensors, on the host) as one JSON line: the per-device peak
    estimate, FLOPs and collective bytes. A vision model's batch holds its
    ``n_patches`` patch positions beside the TRAIN_SEQ tokens. ``layers``
    cuts the depth (full width). The one-time reckoning behind TRAIN_FULL
    (1 x 1), run by hand with no card, e.g. ``PYTHONPATH=src python3 -c
    "import chip_smoke; chip_smoke.train_peak_reckoned('phi3-mini-3.8b')"``,
    and the plan of the four-card runs (`tests/test_torch_cuda.py`)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    seq = TRAIN_SEQ + (cfg.n_patches if cfg.frontend == "vision" else 0)
    shape = ShapeSpec(f"train_{TRAIN_BATCH}x{seq}", "train", seq, TRAIN_BATCH)
    with dryrun.fake_world(mesh[0] * mesh[1]):
        m = make_host_mesh(*mesh, device_type="cpu")
        cost = dryrun.trace_lm(cfg, shape, m, mesh_axes(False))
    print(json.dumps({"arch": arch, "mesh": list(mesh), "layers": cfg.n_layers,
                      "peak": cost.peak, "flops": cost.flops,
                      "collectives": cost.collectives}))


def lm_training_phase(dev) -> dict:
    """Phase 14: LM training on the card. Returns its launch counts of the
    port's kernels (none: the products, the loss and AdamW are torch ops,
    as the reference's are jnp)."""
    import torch

    from repro_torch.kernels import launch_counts as read_counts
    from repro_torch.kernels import reset_launch_counts as zero_counts

    # (c) holds f32 steps against the CPU: full-precision f32 matmuls, which
    # are PyTorch's default; checked, not set
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("TF32 matmuls are enabled; the f32 card-vs-CPU hold needs them off")
    t0 = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_root:
        for arch, steps in TRAIN_FULL:
            t = time.perf_counter()
            lm_train_full(dev, arch, steps, ckpt_root)
            print(f"  {arch}: 14 (a) took {time.perf_counter() - t:.1f} s")
    lm_train_olmoe(dev)
    lm_memorise(dev)
    lm_train_card_vs_cpu(dev)
    counts = read_counts()
    lm_train_examples()
    print(f"lm training path launches: {json.dumps(counts)} ({time.perf_counter() - t0:.1f} s)")
    return counts


# ------------------------------------------------------- phase 15: dry run
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"),
                ("llama3.2-1b", "decode_32k"), ("olmoe-1b-7b", "train_4k"),
                ("llava-next-34b", "decode_32k"), ("mamba2-130m", "long_500k"),
                ("xgb-paper", "boost_1m"))
DRYRUN_CELL_TIMEOUT_S = 600
DRYRUN_PEAK_RTOL = 0.25  # the dry run's peak estimate against the card's
DRYRUN_TIMED_STEPS = 3
# (arch, kind, seq, batch): phase 14's train shape, phase 13's decode shape
DRYRUN_CASES = (("llama3.2-1b", "train", TRAIN_SEQ, TRAIN_BATCH),
                ("mamba2-130m", "train", TRAIN_SEQ, TRAIN_BATCH),
                ("llama3.2-1b", "decode", 48, 4))


def _dryrun_cells_start(out: str) -> list:
    """15 (a): one `launch.dryrun` process a cell, all started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--single-pod", "--out", out]
        procs.append((arch, shape, subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def _dryrun_cells_finish(procs: list, out: str, t0: float) -> None:
    try:
        for arch, shape, proc in procs:
            log, _ = proc.communicate(
                timeout=max(1.0, t0 + DRYRUN_CELL_TIMEOUT_S - time.perf_counter()))
            path = Path(out) / "16x16" / f"{arch}__{shape}.json"
            if proc.returncode != 0 or not path.exists():
                raise SystemExit(f"dry run {arch} x {shape} exited {proc.returncode}: "
                                 f"{log[-2000:]}")
            r = json.loads(path.read_text())
            if r["status"] != "ok":
                raise SystemExit(f"dry run {arch} x {shape}: {r['error']}\n"
                                 f"{r.get('traceback', '')}")
            useful = "null" if r["useful_ratio"] is None else f"{r['useful_ratio']:.4f}"
            print(f"dryrun 16x16 {arch} x {shape}: ok dominant={r['dominant']} "
                  f"compute_s={r['compute_s']:.6f} memory_s={r['memory_s']:.6f} "
                  f"collective_s={r['collective_s']:.6f} useful={useful} "
                  f"peak_GiB={r['memory_stats']['peak_estimate_bytes'] / 2**30:.3f} "
                  f"fits_one_card={r['fits_one_card']} compile_s={r['compile_seconds']} "
                  f"(H100 SXM constants, modelled)")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _dryrun_real_step(dev, cfg, kind: str, seq: int, batch: int):
    """The step the dry run traced, from seeded generators on the card:
    returns ``step()`` (its inputs made, nothing run)."""
    import torch

    from repro_torch.models.serve import decode_step, init_cache
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, TrainState, make_train_step

    gen = torch.Generator(device=dev).manual_seed(15)
    params = init_params(cfg, gen, dev)
    if kind == "train":
        oc = OptConfig(schedule="wsd" if cfg.name == "minicpm-2b" else "cosine")
        box = [TrainState(params, adamw_init(params, oc))]
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev,
                               dtype=torch.int32)
        step_fn = make_train_step(cfg, oc, TrainConfig(remat=True))

        def step():
            box[0], metrics = step_fn(box[0], {"tokens": tokens})
            return metrics["loss"]
        return step
    cache = init_cache(cfg, batch, seq, paged=cfg.family in ("dense", "moe"), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch,), generator=gen, device=dev,
                           dtype=torch.int32)
    box = [cache]

    def step():
        with torch.no_grad():
            logits, box[0] = decode_step(params, cfg, tokens, box[0])
        return logits
    return step


def dryrun_card_case(dev, arch: str, kind: str, seq: int, batch: int) -> None:
    """15 (b) for one case: the dry run on a 1 x 1 mesh of the card, then
    the same step on the card."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    from repro_torch.roofline import analyze_traced

    cfg = get_config(arch)
    shape = ShapeSpec(f"{kind}_{batch}x{seq}", kind, seq, batch)
    with dryrun.fake_world(1):
        mesh = make_host_mesh(1, 1, device_type="cuda")
        cost = dryrun.trace_lm(cfg, shape, mesh, mesh_axes(False))
    tokens = batch * seq if kind == "train" else batch
    rep = analyze_traced(cost, arch=arch, shape=shape.name, mesh_name="1x1", chips=1,
                         n_active_params=cfg.active_param_count(), tokens=tokens,
                         kind="train" if kind == "train" else "serve")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    step = _dryrun_real_step(dev, cfg, kind, seq, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    with counter:
        out = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if not bool(torch.isfinite(out.float()).all()):
        raise SystemExit(f"dry-run case {arch} {kind}: the card's step is not finite")
    flops = counter.get_total_flops()
    ms = _time_ms(step, DRYRUN_TIMED_STEPS, warmup=0)
    bound_s = max(rep.compute_s, rep.memory_s)
    err = abs(cost.peak - peak) / peak
    print(f"dryrun 1x1 {arch} {kind} {batch}x{seq}: flops dry={cost.flops} card={flops} "
          f"peak dry={cost.peak} card={peak} (rel {err:.4f}, bound {DRYRUN_PEAK_RTOL}) "
          f"step_ms={ms:.3f} (mean of {DRYRUN_TIMED_STEPS}) roofline_ms="
          f"{bound_s * 1e3:.3f} (compute {rep.compute_s * 1e3:.3f}, memory "
          f"{rep.memory_s * 1e3:.3f}) ratio={ms / (bound_s * 1e3):.2f} "
          f"bytes_dry={cost.bytes}")
    if flops != cost.flops:
        raise SystemExit(f"dry-run case {arch} {kind}: dry-run FLOPs {cost.flops} != the "
                         f"card's {flops}")
    if err > DRYRUN_PEAK_RTOL:
        raise SystemExit(f"dry-run case {arch} {kind}: peak estimate {cost.peak} B is "
                         f"{err:.1%} from the card's {peak} B")
    del step, out
    torch.cuda.empty_cache()


def dryrun_phase(dev) -> dict:
    """Phase 15: the dry run. Returns its launch counts of the port's
    kernels (none: meta shards and torch ops, the GBDT cell's plain
    versions on the host)."""
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts as read_counts
    from repro_torch.kernels import reset_launch_counts as zero_counts

    if dist.is_initialized():
        raise SystemExit("phase 15 needs no process group in this process")
    t0 = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        procs = _dryrun_cells_start(out)
        try:
            for case in DRYRUN_CASES:
                dryrun_card_case(dev, *case)
        except BaseException:
            for _, _, proc in procs:
                proc.kill()
                proc.wait()
            raise
        _dryrun_cells_finish(procs, out, t0)
    counts = read_counts()
    if any(counts.values()):
        raise SystemExit(f"the dry run launched a kernel: {counts}")
    print(f"dry run path launches: {json.dumps(counts)} ({time.perf_counter() - t0:.1f} s)")
    return counts


# ------------------------------------------- phase 16: the sharded LM program
def lm_sharded_phase(dev) -> dict:
    """Phase 16: the sharded LM program on the card, as a world of one over
    NCCL on a 1 x 1 mesh of the card (`tests/torch_lm_shard_ranks.card_of_one`;
    gloo ranks sharing a card die on DTensor's all-gather of CUDA tensors
    under torch 2.11, ROADMAP queue 3): the ten REDUCED archs
    (`torch_lm_shard_ranks.ARCHS`, each with its own batch: codes for
    musicgen, patch embeddings for llava) in f32, prefill, 3 greedy decode
    steps and a train step on the mesh against no mesh (the gloo test's
    tolerances); each state after one
    step saved sharded and restored with its `state_shardings` onto the mesh
    and with none, both bit for bit, and one more step from it against the
    uninterrupted one. The worlds of 2 and 4 ranks run in the four-card tests
    of `tests/test_torch_cuda.py`. Returns its launch counts of the port's
    kernels (none)."""
    from repro_torch.kernels import launch_counts as read_counts
    from repro_torch.kernels import reset_launch_counts as zero_counts

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_lm_shard_ranks as ranks

    t0 = time.perf_counter()
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_shard_") as out:
        gaps = ranks.card_of_one(out, dev)
    print(f"lm shard 16: a world of one over NCCL on a 1 x 1 mesh of the card, "
          f"{len(ranks.ARCHS)} REDUCED archs at f32: prefill, {ranks.DECODE_STEPS} decode "
          f"steps and a train step on the mesh within the gloo test's tolerances of no "
          f"mesh (decode logits within {gaps['decode']:.3e}, tokens equal); each state "
          f"saved sharded and restored with state_shardings and with none bit for bit; "
          f"the next step from it within {gaps['restored_step']:.3e} of the "
          f"uninterrupted one. The four-card runs (NCCL, one card a rank; llava-next-34b "
          f"and moonshot-v1-16b-a3b trained at full width) are `pytest -m cuda -k 'lm_ "
          f"and cards' tests/test_torch_cuda.py` on four cards, the second-card "
          f"launches `-k second_card`")
    counts = read_counts()
    if any(counts.values()):
        raise SystemExit(f"the sharded LM phase launched a kernel: {counts}")
    print(f"lm sharded path launches: {json.dumps(counts)} ({time.perf_counter() - t0:.1f} s)")
    return counts


PAPER = None  # the paper configuration (repro_torch.configs.xgb_paper.CONFIG)


def _load_paper_config() -> None:
    global PAPER
    from repro_torch.configs.xgb_paper import CONFIG

    PAPER = CONFIG


if __name__ == "__main__":
    sys.exit(main())
