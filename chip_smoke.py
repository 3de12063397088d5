"""Drive the PyTorch port of ALID on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of `src/repro_torch/csrc/` (nvcc, at
first use), then runs the phases below, failing with a non-zero exit on
any error. The late library (`kernels._build.LATE_SOURCES`,
affinity_matvec.cu: minutes of nvcc) builds on a thread of its own from
the start, so phases 7, 8, 9, 12 and 13, which need none of its kernels,
run first, in that order, then phases 2-6, 10 and 11:

1. environment: torch / CUDA versions, the kernel build time (and how
   long after phase 13 the late library was still awaited), the card's
   name and power limit (nvidia-smi);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the main path (lsh_hash at 1,000,000 x 128 and at the CIVS
   probe's 3,584 x 128, each with its plan's route, NaN pads on both
   routes and the probe's keys equal to the store build's, beside the
   device time of an empty kernel as the floor of one launch;
   roi_filter, affinity_matvec and lid_sweep over 32
   seeds), each with its error, its device time (25 calls replayed from a
   CUDA graph) and per-call time (CUDA events, median of 25 after
   warm-up), the plain version's device time from a CUDA graph (per call
   for lid_sweep's, which checks its lanes on the host every step), and
   the card's bound. affinity_matvec and lid_sweep bit-equal to their
   plain versions: the matvec at the fit's two shapes (32 x 240 x 240 and
   32 x 240 x 112, both timed), at d = 256 in passes and at d = 2,048 on
   its "global" route; the sweep on every cluster size of its plan (B = 1,
   32, 40, 100), d = 256, the in-sweep refresh, cap 560 and the "global"
   route (cap 2,000 x d 256), NaN-poisoned padded slots, and lanes
   converged on entry (unchanged); its one-step, 8-step and converged
   calls timed; then the four fit kernels on bf16 rows (bf16 point
   storage, ROADMAP B P1) at the main path's shapes: lsh_hash at
   1,000,000 x 128 (stream route) and 3,584 x 128 (probe route),
   roi_filter at 32 x 7,168 x 128, affinity_matvec at 32 x 240 x 240 and
   32 x 240 x 112 (smem route) and at d = 2,048 (global route), lid_sweep
   at 32 x (240, 128) (smem route) and 2 x (2,000, 256) (global route),
   each bit-equal to its plain version at bf16 (lsh_hash within the
   key-flip rule) and to the f32 kernel on the upcast rows (lsh_hash
   too), timed beside the f32 case, with a bound that reads the rows at 2
   bytes;
3. end-to-end parity: one fit through the kernels and one through the plain
   versions, both on the card, at n = 20,000 x 128: equal canonical labels
   and round counts, densities within tolerance;
3b. the out-of-core engines at n = 20,000 x 128 (200 blobs of 40, an LSH
   segment of one median NN distance, so that probe 128 covers every
   bucket; the largest bucket is checked): the sharded engine (8 shards)
   and the streamed engine (8 shards) in three pipeline configurations
   (synchronous: no scratch, no cache, no reader; the default: scratch,
   LRU, reader 2 ahead; reader 7 ahead), each through the kernels,
   against the replicated fit through the kernels: equal canonical labels
   and rounds, densities within rtol 1e-6; the replicated fit through
   backend="ref" on the card against it too (the out-of-core engines
   through backend="ref" are the CPU tests', the same code bit for bit);
   every streamed run took no fallback (`PipelineStats`: no
   retry, corruption, tier fallback or reader death, and with the reader
   on, every shard came from the reader, none inline); then the same data
   at bf16 storage: the replicated fit through the kernels and through
   backend="ref", the sharded engine and the streamed engine (default
   pipeline), all bit-identical (labels, rounds, densities);
4. the full-width fit, SIFT1M's shape (1,000,000 x 128 f32) in the paper's
   size-limited regime, with every fit kernel's launch count, which must
   be > 0;
4b. the same fit on the sharded engine (8 shards, the 512 MB store on the
   card): every point once in the shards, every shard ball covers its
   members (f64, the routing test's slack), `global_bucket_sizes` equal
   to the replicated engine's bucket sizes, the four fit kernels launched;
   wall time, peak device memory, clusters, AVG-F and the agreement with
   phase 4's labels printed (not gated: probe 16 is below the largest
   bucket at this width);
4c. the same fit, cut to 16 of its 64 rounds (printed; the width, the
   shards and the data are not cut), on the streamed engine from the
   points written as .npy in a temporary directory and read through
   MemmapSource (8 shards, scratch beside it, a 1 GiB LRU, the reader 2
   bundles ahead): the
   streamed store equal to 4b's (order, global indices, validity, the
   per-shard sorted keys and permutations, bucket sizes), the four fit
   kernels launched, the fit's peak device memory below phase 4's, no
   fallback taken (as in 3b); wall time and the `PipelineStats` report
   printed;
4d. fault tolerance: crash at round 3 and resume, bit-identical, on the
   replicated engine at full width against phase 4's labels (the
   streamed engine's crash and resume and its fault arms at n = 20,000
   are the CPU tests' since phases 12 and 13 needed their time);
   `run_palid --quick` on the card with `--engine sharded --shards 4`,
   `--engine streamed --shards 4 --inject-faults transient:0.1`
   (fault-parity=True), `--checkpoint-dir` and then `--resume`; the
   launches of 4b, 4c and 4d's full-width crash and resume, each read on
   its own, are added to the kernel table's (run_palid's toy fits are
   not);
4e. the full-width fit at bf16 storage (`EngineSpec(dtype="bfloat16")`,
   phase 4's data and config) on the replicated and the sharded engine,
   the four fit kernels launched on each, wall time, peak device memory,
   clusters and AVG-F printed; the replicated bf16 fit bit-identical to
   the f32 fit of the bf16-rounded rows with k pinned to its k (labels,
   rounds, densities, support ids and weights: the storage identity);
   then 5b's short arm on it: an 8-row insert and a support-member delete
   through the kernels and through backend="ref", state arrays bit-equal,
   commit, rollback(0) and forward again bit-identical; and `run_palid
   --quick --dtype bfloat16` on the card; the bf16 runs' launches (3b,
   4e, the online arm) are added to the kernel table's (each kernel's
   `bf16` entry holds them and its bf16 times);
5. serving at full width on phase 4's Clustering (2,048 clusters x 240
   supports x 128): the assign kernels against their plain version on 256
   queries of the serving mix (dataset rows, jittered rows, far noise; the
   tiles kernel), on a NaN-poisoned, masked 64-slot batch and on a 4-row
   batch (the lanes kernel, which serves a batch's occupied slots), and at
   d = 2,048 (64 clusters, 64 and 4 rows, NaN pads; C2), labels and scores
   bit-equal; the device time of a 64-slot and of a 4-row batch, per-call
   time, the plain version's time, the bound, and the device time of the
   cuBLAS composition (matmul expansion, exp, segment sum, argmax) as a
   yardstick the port never calls, which the 64-slot batch must beat;
   then the serving path from launch counts at 0: a 4,096-row bulk
   `predict`, `ClusterService(batch_slots=64)` over 1,024 queries, and
   `run_palid._serve_bench` (ClusterServer + open-loop traffic at 2,000
   requests/s), whose labels must equal per-query assignment and whose
   `assign` launches must be > 0 (printed by kernel);
5b. online updates on phase 4's fit (`OnlineClustering` on the card, from
   launch counts at 0, epochs in a temporary directory removed at the
   end): (a) epoch 0 with the seconds of construction, verify and save and
   the snapshot's bytes, and the ROI refresh of every cluster (one
   single-lane call each); (b) inserts of 1, 8 and 64 jittered rows of
   labeled points, each committed and rolled back to epoch 0, with the
   seconds of routing, ROI refresh, warm LID and in all
   (`OnlineClustering.insert_seconds`), of the commit and of the next
   refresh; every row routed, verify clean, only clusters whose ball a
   row hit moved, and no more re-convergences than such clusters; (c) the 8-row insert and a
   support-member delete through the kernels and through backend="ref"
   on the card: the state arrays bit-equal; (d) 5 far noise points
   (`serving_mix`'s, inserted first: every dataset point lies in ~2,040
   of the 2,048 balls) deleted and re-inserted, bit-identical, then
   commit, rollback(0) and forward again, bit-identical, with the
   rollback's seconds; (e) two planted
   blobs of 80 rows buffered and flushed (a fit at the resident k): new
   clusters form, earlier labels unchanged, and the flush itself launches
   `lsh_hash`, `roi_filter`, `affinity_matvec` and `lid_sweep`; (f) `LiveServing` on a 64-slot
   `ClusterServer`: publish (timed), probe, commit_and_publish,
   rollback_and_publish(0), probe again: the same label, versions [1, 2],
   2 swaps, 1 rollback; the phase's launches are read here; (g)
   `run_palid --online --quick` on the card prints bit-identical=True
   (its own toy fit's launches are not the phase's); (h) `lid_sweep`,
   `affinity_matvec`, `lsh_hash`, `roi_filter` and `assign` launches of
   (a)-(f) > 0, added to the kernel table's;
6. the full-matrix path (estimate_k, affinity_matrix through the affinity
   kernel, IID / DS peeling, the paper's baselines): (a) the affinity
   kernel's two routes bit-equal to its plain version: the symmetric
   route (q and c one tensor) on rows of the full-width 40,000 x 40,000 x
   128 block (symmetric bitwise), the general route (the same rows as a
   second tensor) on the whole block against it, LID columns, ragged
   shapes, a batch, NaN rows and calls past 2**31 entries on both, each
   case's route printed; both routes' device times, per-call time, plain
   time, each route's bound (the symmetric call needs the pairs i <= j,
   the general one all n^2) and the cuBLAS composition's time, which both
   must beat;
   (b) `lid_solve_unfused` (affinity kernel) bit-equal to `lid_solve`
   (lid_sweep kernel); (c) IID and DS peels at n = 4,000 equal on the
   kernel's and the plain version's matrices, and one IID solve from CUDA
   graphs equal to the eager loop, with the time of each; (d) the
   full-width IID run, `launch/full_matrix.py` at 40,000 x 128, whose
   `affinity` launches (symmetric route) must be > 0; (e) every baseline
   on the CPU tests'
   `easy` data, each above its AVG-F floor, and SEA run twice with the
   same bits;
7. LM serving (h2o-danube-1.8b at full width, bf16, random weights from
   the port's threefry): (a) the flash_attention kernel against its plain
   version on numpy-seeded inputs at the serving path's shapes (prefill:
   4 rows x 32 heads x 5,120 queries over 5,137 cache slots, dh 80,
   window 4,096, one long row and three left-padded short ones; decode:
   one query at slot 5,120), in bf16 and f32, `launch.serve`'s own
   batches at their shapes (prefill and every decode step, q the model's
   transposed view), then gemma2's dh 128 with softcap 50 (local and
   full), a chunked mask and ragged shapes, by the rule of
   `kernels.flash_attention.compare_with_plain` (fully masked rows
   exactly 0), two calls bitwise equal, each case's `kernel_plan` (the
   bf16 prefills' wgmma tile, the decode's split count) printed, with the
   kernel's device and per-call time, the plain version's, the bound, and
   the time of `scaled_dot_product_attention` with the same mask as a
   yardstick the port never calls (the bf16 prefill's wgmma kernel must
   beat it), the SIMT tiles kernel forced at the same prefill (within the
   rule, timed), and the prefill's kernel with the batch on grid.z
   against it folded into grid.x, timed in turns; (b) from launch counts
   at 0, `launch.serve`'s own request mix on BatchServer, then one batch
   packing a 5,120-token prompt with three short ones, with tokens/s,
   prefill seconds, decode ms per step and peak memory, and
   `flash_attention` launches > 0, the wgmma kernel's among them (printed
   by kernel); (c) for the packed batch and each
   of the mix's batches, the generated tokens fed back through the model
   with the kernel and with the plain attention: the kernel's argmax is
   the served tokens, the logits differ by at most (layers + 1) bf16
   ulps at their scale, at least 16 steps have a plain top-2 gap over
   twice the step's largest difference, and on those the argmaxes agree;
8. BST serving and the segment sums: (a) the embedding_bag kernel
   bit-equal to its plain version (f32 and bf16) at BST's three bag
   shapes as the model builds them from `bst_batch` ids (serve_p99 1,024
   bags, serve_bulk 524,288, retrieval_cand 2,000,000 of one user), plus
   interspersed pads, empty bags, mean mode, the serve_bulk entries in a
   random order (the unsorted placement, timed too) and ids at and past
   the table's end (read as its last row); the segment_matmul kernel
   bit-equal to its plain version at ogb_products' shape (61,859,328 x
   100 messages into 2,449,029 nodes, skewed in-degrees, the registry's
   188 trailing pad edges; leading pads; unvisited row blocks exactly 0;
   f32 and bf16), through `ops.segment_matmul` from launch counts at 0;
   each timed beside F.embedding_bag / index_add_ as yardsticks the port
   never calls; (b) the flash_attention kernel at BST's shape (B = 512,
   262,144 and 1,000,000; H = Hkv = 8, Sq = Sk = 21, dh = 4, f32, not
   causal, q, k and v the model's views; the small kernel) against its
   plain version on slabs of rows; (c) BST's CONFIG at full width
   (random weights from the port's threefry, 574 MB), from launch counts
   at 0: make_bst_serve_step at 512 and 262,144 rows and
   make_bst_retrieval_step at 1,000,000 candidates,
   with step seconds, peak memory and one profiled step each (the
   device's idle share, time by kernel), embedding_bag and
   flash_attention launches > 0, and each batch's logits within 1e-4 +
   1e-4 |ref| of backend="ref";
9. the GNNs' forwards (random weights from the port's threefry, the
   registry's `make_cell` configs, every aggregation, SAGE's mean count
   and the graph pool through segment_matmul), each from launch counts at
   0 through the kernel and through backend="ref" on the card: outputs
   bit-equal, finite, of the cell's shape, segment_matmul launches > 0,
   wall time and peak device memory printed, and `gnn_loss` of the cell's
   kind finite: (a) GIN-TU (5 x 64, f32, sum) and GraphSAGE-Reddit (2 x
   128, f32, mean) at ogb_products, full batch, on one graph from
   `synth_full_graph_batch` (2,449,408 nodes, 61,859,328 edges, 188 of
   them pads; the in-degree's maximum, 99.99th percentile and mean
   printed), each forward profiled (the device's idle share) and its
   first layer split into the gather h[src], the layout sort, the segment
   kernel and the MLPs; (b) MeshGraphNet (15 x 128, bf16) and GraphCast
   (16 x 512, bf16) at full_graph_sm with the registry's edge features;
   (c) all four at molecule (128 graphs of 30 nodes and 64 edges), pooled
   per graph; (d) `examples/torch_gnn_cluster.py` on the card, which must
   find a cluster; phase 9's segment_matmul launches are added to the
   kernel table's;
10. the mesh engine (PALID over `torch.distributed`): (a) phase 4's
   full-width fit on the mesh engine at world size 1 over NCCL in this
   process, on the replicated store and on 8 shards, bit-identical to
   phase 4's and 4b's fits, with the all-gather's seconds and bytes a
   round (the fits of (a)-(c) time their collectives,
   `timed_collectives`, a device sync around each); then
   two gloo ranks sharing the one card (NCCL refuses two
   ranks on one device), spawned once: (b) the full-width fit from a .npy
   through MemmapSource on the replicated store, bit-identical to phase
   4's fit, each rank launching the four fit kernels; (c) 3b's data on 8
   shards split over the ranks, bit-identical to 3b's sharded fit, with
   the bytes each rank broadcasts and holds, and the split store built
   alone on each rank, whose peak device bytes must stay below the whole
   store's; (d) GIN
   and SAGE at ogb_products, full batch, and MeshGraphNet and GraphCast
   at full_graph_sm, the nodes and edges split over the ranks, held to
   phase 9's one-process forwards within the CPU tests' tolerances, each
   rank launching segment_matmul, with each rank's peak device memory;
   the collectives the ranks ran on CUDA tensors are printed (gloo takes
   them; none goes through the host); (e) `run_palid --quick --engine
   mesh --devices 1` (one NCCL rank) and `--devices 2` refused with the
   card count; phase
   10's launches (a)-(d) are added to the kernel table's;
11. the tooling: (a) `run_palid --check` on the card (the port's contract
   checker, `repro_torch.analysis`), its report written to
   chiprun_out/CHECK_report_torch.json: it must exit 0 with its report
   ok, all ten ops shape-checked ref against kernel, the ten poison
   scenarios run on both backends (20 runs), the static shared bytes of
   every source read from the built library, and every kernel's dynamic
   + static shared bytes within 232,448 at the contract cases and the
   main path's full-width shapes (printed by case and `smem_bytes_by_op`),
   each of the nine kernels launched; (b) the JAX package's golden
   fixtures (tests/golden_torch, read with numpy): every op through the
   kernels against the reference's outputs (`lsh_hash` under its
   key-flip rule, `flash_attention` under its kernel rule), the small fit
   + predict through the kernels, and the fits at phase 3b's data
   (fit_parity) and at its shape on data where every LID of the
   reference converges within t_lid (fit_converged) on the replicated,
   sharded (8 shards), streamed (default pipeline) and mesh (world size
   1, NCCL) engines, each compared with the reference and printed;
   fit_parity differs from the reference's (ROADMAP C4), so the gate
   there is the four engines equal to one another and to 3b's fit, and
   the reference's round count; fit_converged is held to the reference
   in full on each engine (`utils.golden.check_fit`); phase 11's
   launches are added to the kernel table's;
12. MoE serving (ROADMAP A16): (a) the attention kernel at the MoE
   models' shapes, bf16, dh 128: llama4-scout's GQA rep 5 (40 / 8 heads)
   prefill of a 9,216-token row and three left-padded short rows in its
   chunked layer (chunk 8,192) and its NoPE full layer, and a decode step
   at slot 9,216; kimi-k2's rep 8 (64 / 8 heads) 5,120-token prefill and
   a decode step; each against its plain version by the stated rule, two
   calls bitwise equal, the prefills on the wgmma kernel, with the plan,
   the kernel's, the plain version's and SDPA's times and the bound;
   (b) llama4-scout at full width and 4 layers (one group of its 3:1
   pattern), (c) kimi-k2 at full width and 1 layer, bf16, random weights
   from the port's threefry drawn in slices (the init timed): from launch
   counts at 0, launch.serve's mix and a batch packing the long prompt
   with three short ones on BatchServer, with the parameter bytes, peak
   memory, prefill seconds, decode ms a step, tokens/s and the
   flash_attention launches by kernel (wgmma among them); (d) 7c's
   teacher-forced check of each batch, with every layer's routing
   recorded in the kernel run and in the plain run (whose rows attending
   nothing are zeroed as the kernel's are, since under MoE pad tokens
   take capacity): a token's ordered top-k may change only where the
   plain logit gap at the first position they part is within twice the
   bound its measured input difference allows, each layer's capacity and
   drops printed, and
   logits within (layers + 1) bf16 ulps on the rows whose routing agreed
   in every layer; (e) llama4 at full width, 1 layer, over two gloo ranks
   sharing the card with a ("model",) axis of 2 (8 experts a rank): a
   4 x 1,024-token prefill forward held to the one-process forward whose
   MoE dispatches the same token shards, with the all-to-all's bytes and
   seconds; phase 12's launches are added to the kernel table's
   flash_attention rows;
13. training (ROADMAP A16): (a) the three backward kernels, the port's
   own (the JAX package differentiates its plain versions), against
   their plain versions on the card: the attention backward
   (`csrc/flash_attention_bwd.cu`) at danube's 32 / 8 heads x 80 over a
   5,120-token row (window 4,096), a gemma2 global layer (32 / 16 x 128,
   4,096, softcap 50), a llama4 chunked layer past one chunk (40 / 8 x
   128, 9,216, chunk 8,192), all bf16, lm-100m's (8 x 12 / 4 x 64, 256)
   and BST's (65,536 x 8 x 21 x 21 x 4, the small route) in f32, dq / dk
   / dv by `compare_with_plain`'s rule and two calls bitwise equal, each
   with its device time, per-call time, the plain version's, the bound
   and SDPA's forward + backward where SDPA can express the mask; the
   segment_matmul backward at ogb_products' shape and the embedding_bag
   backward at BST train_batch's bags, bitwise, beside index_select /
   index_add_; (b) h2o-danube-1.8b's CONFIG at full width and depth
   (24 layers, bf16, remat, AdamW with the f32 master) for 3 steps of
   lm_batch at 4 x 4,096 from launch counts at 0: step seconds,
   tokens/s, peak memory (< 80 GB), a finite loss, grad_norm, the
   backward kernels' launches; at 2 layers (the width kept) and 1 x
   5,120 tokens: the kernel route's loss and gradients against
   backend="ref" (LOSS_TOL, GRAD_TOL, NORM_TOL) and each layer's
   attention backward, recorded on the model's own inputs, against the
   plain backward by `compare_with_plain`'s rule, three faults planted
   in that backward each failing one of these gates
   (PLANTED_BWD_FAULTS), remat on and off bit-equal, two runs of a train
   step
   bit-equal, and train_loop crashed at step 2 and resumed equal to the
   uninterrupted 4 steps, params and optimizer state, bit for bit; (c)
   GIN-TU and GraphSAGE-Reddit train steps at ogb_products, full batch,
   f32, and (d) BST's CONFIG train step at 65,536 rows: the kernel
   route's loss and gradients against backend="ref" (the loss within
   1e-5 relative, each leaf's 2-norm gap within 5e-3), two train steps
   bit-equal, step seconds and peak memory; (e) `launch.train --steps
   20` on the card, the loss falling; phase 13's launches (b)-(d) are
   added to the kernel table's, which gains the three backward kernels'
   rows (port_only);

then prints the kernel table as one JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}. Without a CUDA
device, or without the repository's `src/` beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# published peaks of one H100 SXM (dense, 700 W): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, bf16 FLOP/s in them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TIMED_RUNS = 25
# the size of the parity fits (the full-width fit's configuration is
# repro_torch.launch.full_width)
PARITY_N = 20_000
DEVICE = "cuda:0"

# the JAX package's Pallas kernels the nine CUDA kernels replace
REPLACES = {
    "lsh_hash": "src/repro/kernels/lsh_hash.py:41",
    "roi_filter": "src/repro/kernels/roi_filter.py:46",
    "affinity_matvec": "src/repro/kernels/affinity_matvec.py:50",
    "lid_sweep": "src/repro/kernels/lid_sweep.py:149",
    "assign": "src/repro/kernels/assign.py:52",
    "affinity": "src/repro/kernels/affinity.py:34",
    "flash_attention": "src/repro/kernels/flash_attention.py:102",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:102",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:56",
    "segment_matmul": "src/repro/kernels/segment_matmul.py:72",
    # the backward kernels have no TPU kernel (port-only: the JAX package
    # differentiates its plain versions); each names its forward's
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:102",
    "segment_matmul_bwd": "src/repro/kernels/segment_matmul.py:72",
    "embedding_bag_bwd": "src/repro/kernels/embedding_bag.py:56",
}
# the kernels of the fit (phase 4); serving and the full-matrix path run
# the others
FIT_KERNELS = ("lsh_hash", "roi_filter", "affinity_matvec", "lid_sweep")
# the CUDA kernels behind flash_attention and embedding_bag, by name in a
# profile
FLASH_KERNELS = ("flash_kernel", "flash_split_kernel", "flash_combine_kernel",
                 "flash_small_kernel", "flash_wgmma_kernel")
# the source of a kernel table row where it is not csrc/<name>.cu
SOURCES = {"flash_attention_wgmma": "src/repro_torch/csrc/flash_wgmma.cu",
           "segment_matmul_bwd": "src/repro_torch/csrc/segment_bwd.cu",
           "embedding_bag_bwd": "src/repro_torch/csrc/segment_bwd.cu"}
BAG_KERNELS = ("bag_pass_kernel", "bag_sum_kernel")
# serving: run_palid's defaults, and the bulk predict's rows
SERVE_RATE = 2000.0
BULK_ROWS = 4096
# lsh_hash at the CIVS probe: seeds_per_round x a_cap support rows
PROBE_ROWS = 32 * 112


class SmokeFailure(RuntimeError):
    pass


_START = time.perf_counter()


def stamp(what: str) -> None:
    """The script's elapsed seconds at the end of a phase."""
    print(f"[time] {what} done at {time.perf_counter() - _START:.1f}s")


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def call_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median time of one call of fn() as the card sees it: CUDA events
    around each call, after two warm-up calls. For a small kernel this is
    set by the host's time to enqueue the call, not by the kernel."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, runs: int = TIMED_RUNS, replays: int = 5) -> float:
    """Device time of one call of fn(): `runs` calls captured in one CUDA
    graph, replayed `replays` times between CUDA events; the median replay
    over `runs`. Without the host's enqueue this is the time of the call's
    launches on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def timings(kernel, plain, plain_in_graph: bool = True,
            plain_runs: int = TIMED_RUNS) -> dict:
    """The kernel's device time (CUDA graph) and per-call time, and the
    plain version's time measured as the kernel's device time is, from a
    CUDA graph (of `plain_runs` calls); per call (CUDA events, the host's
    enqueue included) only where the plain version waits on the host
    inside a call, as lid_sweep's does after every step, so that no graph
    can hold it."""
    return dict(ms=graph_ms(kernel), call_ms=call_ms(kernel),
                plain_ms=graph_ms(plain, runs=plain_runs) if plain_in_graph
                else call_ms(plain), plain_in_graph=plain_in_graph)


def time_line(t: dict) -> str:
    how = ("device time, CUDA graph" if t["plain_in_graph"] else
           "per call incl. the host's enqueue and its per-step host "
           "checks, CUDA events: it cannot be captured in a graph")
    return (f"kernel_ms={t['ms']:.4f} (device time, CUDA graph) "
            f"kernel_call_ms={t['call_ms']:.4f} (per call incl. the host's "
            f"enqueue, CUDA events) plain_ms={t['plain_ms']:.4f} ({how})")


def bound(n_bytes: float, n_ops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernels ----
def live_states(bsz, cap, d, dev, seed=0, n_valid=None):
    """A batch of full-range LID states with an exact Ax, so the sweep
    iterates: clustered rows, x = the seed slot, Ax refreshed."""
    from repro_torch.core.lid import LIDState, refresh_ax
    rng = np.random.default_rng(seed)
    n_valid = cap if n_valid is None else n_valid
    centers = rng.normal(size=(bsz, 4, d)) * 3.0
    pts = centers[:, rng.integers(0, 4, cap)] + rng.normal(size=(bsz, cap, d))
    v = torch.tensor(pts, dtype=torch.float32, device=dev)
    mask = torch.zeros((bsz, cap), dtype=torch.bool, device=dev)
    mask[:, :n_valid] = True
    v = torch.where(mask[..., None], v, 0.0)
    idx = torch.where(mask, torch.arange(cap, device=dev,
                                         dtype=torch.int32)[None], -1)
    x = torch.zeros((bsz, cap), dtype=torch.float32, device=dev)
    x[:, 0] = 1.0
    st = LIDState(idx.to(torch.int32), mask, v, x, torch.zeros_like(x),
                  torch.zeros(bsz, dtype=torch.int32, device=dev),
                  torch.zeros(bsz, dtype=torch.bool, device=dev))
    return refresh_ax(st, k_for(d), backend="ref")


def k_for(d: int) -> float:
    # cluster-scale NN distances of the blobs above are ~sqrt(2 d)
    return float(np.float32(np.log(1 / 0.95) / np.sqrt(2.0 * d) * 4))


def check_lsh_hash(dev, out, data):
    """On the full-width fit's own points, projections and seg_len: the
    store build's 1,000,000 points (stream route) and the CIVS probe's
    3,584 (probe route)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.lsh_hash import key_flips, lsh_hash_cuda, plan
    from repro_torch.lsh.pstable import make_projections
    from repro_torch.random import PRNGKey, split
    points, lshp = data
    x = torch.as_tensor(points, device=dev)
    n, d = x.shape
    n_tables, n_proj, seg = lshp.n_tables, lshp.n_projections, lshp.seg_len
    proj, bias = make_projections(split(PRNGKey(0))[1], lshp, d, dev)
    got = lsh_hash_cuda(x, proj, bias, seg)
    want = ref.lsh_hash_ref(x, proj, bias, seg)
    torch.cuda.synchronize()
    n_flip, near = key_flips(x, proj, bias, seg, got, want)
    agree = 1.0 - n_flip / float(n * n_tables)
    print(f"[kernel] lsh_hash n={n} d={d} L={n_tables} m={n_proj} "
          f"plan={tuple(plan(n, d, n_tables, n_proj))}: flips={n_flip} "
          f"agree={agree:.7f} flips_near_integer={near}")
    need(agree >= 0.99999, "lsh_hash agrees on < 99.999% of pairs")
    need(near, "lsh_hash flipped a key whose z/seg_len is not within 1e-4 "
         "of an integer")
    # ragged tail + NaN rows, on both routes: valid rows unchanged
    for rows in (1000, 20_000):
        clean = torch.cat([x[:rows], torch.zeros((7, d), device=dev)])
        dirty = clean.clone()
        dirty[rows:] = float("nan")
        need(torch.equal(lsh_hash_cuda(clean, proj, bias, seg)[:rows],
                         lsh_hash_cuda(dirty, proj, bias, seg)[:rows]),
             f"lsh_hash: NaN pad rows changed valid keys ({rows} rows, "
             f"{plan(rows + 7, d, n_tables, n_proj).route} route)")
    # both routes sum in one order: a point's keys do not depend on it
    rows = PROBE_ROWS
    xp = x[:rows].contiguous()
    pl = plan(rows, d, n_tables, n_proj)
    need(torch.equal(lsh_hash_cuda(xp, proj, bias, seg), got[:rows]),
         "lsh_hash: the probe and stream routes give other keys")
    print(f"[kernel] lsh_hash NaN pad rows change no valid key on either "
          f"route; the probe's {rows} rows (plan={tuple(pl)}) get the "
          "store build's keys bitwise")
    t = timings(lambda: lsh_hash_cuda(x, proj, bias, seg),
                lambda: ref.lsh_hash_ref(x, proj, bias, seg))
    lm = n_tables * n_proj
    b_ms, b_by = bound(4 * (n * d + lm * d + lm + n * n_tables),
                       2 * n * lm * d)
    out["lsh_hash"] = dict(t, max_abs_err=n_flip / float(n * n_tables),
                           bound_ms=b_ms, bound_by=b_by,
                           plan=plan(n, d, n_tables, n_proj).route)
    print(f"[kernel] lsh_hash {time_line(t)} bound_ms={b_ms:.4f} ({b_by}) "
          "library_ms=null (no single PyTorch call computes projection + "
          "floor + fold); max_abs_err is the fraction of flipped keys")
    # the CIVS probe: 32 seeds x a_cap 112 support rows a call (436 of the
    # fit's 437 launches; the store build above is the other), against the
    # floor of one launch: an empty kernel's device time
    tp = timings(lambda: lsh_hash_cuda(xp, proj, bias, seg),
                 lambda: ref.lsh_hash_ref(xp, proj, bias, seg))
    floor_ms = graph_ms(lambda: _build.empty_kernel(dev))
    pb_ms, pb_by = bound(4 * (rows * d + lm * d + lm + rows * n_tables),
                         2 * rows * lm * d)
    out["lsh_hash"]["probe"] = dict(rows=rows, ms=tp["ms"],
                                    call_ms=tp["call_ms"],
                                    plain_ms=tp["plain_ms"], bound_ms=pb_ms,
                                    bound_by=pb_by, plan=pl.route,
                                    launch_floor_ms=floor_ms)
    print(f"[kernel] lsh_hash probe n={rows}: {time_line(tp)} "
          f"bound_ms={pb_ms:.5f} ({pb_by}) launch_floor_ms={floor_ms:.5f} "
          "(an empty kernel, device time, CUDA graph)")


def check_roi_filter(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.roi_filter import roi_filter_cuda
    bsz, per_seed, d = 32, 112 * 4 * 16, 128
    g = torch.Generator(device="cpu").manual_seed(2)
    vc = torch.randn((bsz, per_seed, d), generator=g).to(dev)
    center = torch.randn((bsz, d), generator=g).to(dev)
    radius = torch.full((bsz,), 0.98 * np.sqrt(2 * d), device=dev)
    valid = (torch.rand((bsz, per_seed), generator=g) < 0.7).to(dev)
    gd, gv, gn = roi_filter_cuda(vc, center, radius, valid)
    wd, wv, wn = ref.roi_filter_ref(vc, center, radius, valid)
    err = float((gd - wd).abs().max())
    # ok may differ only where dist sits within rounding of the radius
    edge = (wd - radius[:, None]).abs() <= 1e-5 * radius[:, None]
    need(err <= 1e-5 * float(wd.abs().max()), f"roi_filter dist err {err}")
    need(bool(((gv == wv) | edge).all()), "roi_filter ok mask differs")
    need(bool(((torch.isinf(gn) == torch.isinf(wn)) | edge).all()),
         "roi_filter -inf sentinels differ")
    # NaN/Inf poison in invalid rows + a ragged batch: valid rows unchanged
    small = vc[:3, :777].clone()
    sval = valid[:3, :777].clone()
    sval[:, 700:] = False
    dirty = small.clone()
    dirty[:, 700:740] = float("nan")
    dirty[:, 740:] = float("inf")
    a = roi_filter_cuda(small, center[:3], radius[:3], sval)
    b = roi_filter_cuda(dirty, center[:3], radius[:3], sval)
    need(all(torch.equal(p[:, :700], q[:, :700]) for p, q in zip(a, b)),
         "roi_filter: poisoned invalid rows changed valid outputs")
    need(bool((~b[1][:, 700:]).all()) and bool(
        (b[2][:, 700:] == float("-inf")).all()),
         "roi_filter: poisoned invalid rows must give ok=False, neg=-inf")
    t = timings(lambda: roi_filter_cuda(vc, center, radius, valid),
                lambda: ref.roi_filter_ref(vc, center, radius, valid))
    rows = bsz * per_seed
    b_ms, b_by = bound(4 * rows * d + 4 * bsz * (d + 1) + rows * (1 + 9),
                       3 * rows * d)
    out["roi_filter"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    same = (torch.equal(gd, wd) and torch.equal(gv, wv)
            and torch.equal(gn, wn))
    print(f"[kernel] roi_filter B={bsz} C={per_seed} d={d}: "
          f"max_abs_err={err:.3e} max_rel_err="
          f"{float(((gd - wd).abs() / wd.clamp_min(1e-30)).max()):.3e} "
          f"bitwise_equal={same} {time_line(t)} bound_ms={b_ms:.4f} "
          f"({b_by}) library_ms=null (no single PyTorch call computes "
          "distance + radius mask + -inf scores)")


def matvec_bound(bsz: int, m: int, n: int, d: int) -> tuple[float, str]:
    """Inputs read once, the output written once; per pair the d-long dot
    (an FMA counted as two operations), the norms, and the affinity's and
    the weighted sum's handful."""
    return bound(4 * bsz * (m * d + n * d + m + 2 * n + m),
                 bsz * (2 * m * n * d + 2 * (m + n) * d + 8 * m * n))


def check_affinity_matvec(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda, plan
    bsz, cap, a_cap, d = 32, 240, 112, 128
    k = k_for(d)
    st = live_states(bsz, cap, d, dev, seed=3)
    g = torch.Generator(device="cpu").manual_seed(3)
    w = torch.rand((bsz, cap), generator=g).to(dev)
    shapes = {}
    # the fit's two shapes (ROI pi(x) over the range; the CIVS support
    # rebuild against a_cap rows), then d = 256 in passes and d = 2,048
    # read in place (the "global" route)
    for n_c, dd in ((cap, d), (a_cap, d), (560, 256), (37, 2048)):
        if dd == d:  # the support side contiguous, as the fit gives it
            q, qi = st.v_beta, st.beta_idx
            c, ci, wc = (t[:, :n_c].contiguous()
                         for t in (st.v_beta, st.beta_idx, w))
        else:
            gb = torch.Generator(device="cpu").manual_seed(dd)
            q = torch.randn((4, cap, dd), generator=gb).to(dev)
            qi = torch.arange(cap, dtype=torch.int32, device=dev).repeat(4, 1)
            half = min(cap, n_c // 2)  # columns equal to rows
            c = torch.cat([q[:, :half], torch.randn(
                (4, n_c - half, dd), generator=gb).to(dev)], 1)
            ci = torch.arange(n_c, dtype=torch.int32, device=dev).repeat(4, 1)
            wc = torch.rand((4, n_c), generator=gb).to(dev)
        pl = plan(q.shape[1], n_c, dd)
        got = affinity_matvec_cuda(q, qi, c, ci, wc, k)
        want = ref.affinity_matvec_ref(q, qi, c, ci, wc, k)
        err = float((got - want).abs().max())
        same = torch.equal(got, want)
        print(f"[kernel] affinity_matvec B={q.shape[0]} ({q.shape[1]},{dd}) "
              f"x ({n_c},{dd}) plan={pl.route} rows={pl.rows} "
              f"classes={pl.classes} groups={pl.groups} "
              f"groups_a_pass={pl.gpp} smem={pl.smem}B: max_abs_err="
              f"{err:.3e} bitwise_equal={same}")
        need(same, f"affinity_matvec differs from its plain version at "
             f"n={n_c} d={dd}")
        if dd != d:
            continue
        t = timings(lambda: affinity_matvec_cuda(q, qi, c, ci, wc, k),
                    lambda: ref.affinity_matvec_ref(q, qi, c, ci, wc, k))
        b_ms, b_by = matvec_bound(bsz, cap, n_c, d)
        shapes[n_c] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
        print(f"[kernel] affinity_matvec n={n_c} {time_line(t)} "
              f"bound_ms={b_ms:.5f} ({b_by}) library_ms=null (no single "
              "PyTorch call computes the masked affinity matvec)")
    # c-side pad rows with weight 0 and large finite garbage: unchanged
    c = st.v_beta.clone()
    wz = w.clone()
    wz[:, 200:] = 0.0
    base = affinity_matvec_cuda(st.v_beta, st.beta_idx, c, st.beta_idx, wz, k)
    c[:, 200:] = 1e6
    need(torch.equal(base, affinity_matvec_cuda(st.v_beta, st.beta_idx, c,
                                                st.beta_idx, wz, k)),
         "affinity_matvec: weight-0 pad rows changed the output")
    out["affinity_matvec"] = dict(
        shapes[cap], shapes={f"32x{cap}x{n}": {key: v[key] for key in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")}
            for n, v in shapes.items()})


def _sweep_pair(st, k, **kw):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda
    args = (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
            st.converged, k)
    got = lid_sweep_cuda(*args, **kw)
    want = ref.lid_sweep_ref(*args, kw["n_steps"], kw["max_iters"],
                             kw["tol"], 2.0, kw.get("refresh_every", 0))
    return got, want


def check_lid_sweep(dev, out):
    from repro_torch.kernels import ref
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda, plan
    timed = None
    # (B, cap, d, refresh_every, n_steps): the fit's shape first (32 seeds:
    # clusters of 4 blocks), then one cluster size of each other kind, d =
    # 256 (a slice of a 2-block cluster would not fit: 4 blocks at B = 32),
    # the in-sweep refresh, and rows read in place from device memory
    cases = [(32, 240, 128, 0, 8), (32, 240, 256, 0, 8), (32, 240, 256, 4, 8),
             (32, 200, 128, 4, 16), (1, 240, 128, 0, 8), (40, 240, 128, 0, 8),
             (100, 240, 128, 0, 8), (4, 560, 256, 0, 8),
             (2, 2000, 256, 0, 4)]
    routes = set()
    for bsz, cap, d, refresh, steps in cases:
        k = k_for(d)
        st = live_states(bsz, cap, d, dev, seed=cap + d)
        kw = dict(n_steps=steps, max_iters=256, tol=1e-5,
                  refresh_every=refresh)
        (gx, gax, git, gcv), (wx, wax, wit, wcv) = _sweep_pair(st, k, **kw)
        err = max(float((gx - wx).abs().max()), float((gax - wax).abs().max()))
        pl = plan(bsz, cap, d)
        routes.add((pl.route, pl.cluster))
        same = all(torch.equal(a, b) for a, b in
                   zip((gx, gax, git, gcv), (wx, wax, wit, wcv)))
        print(f"[kernel] lid_sweep B={bsz} cap={cap} d={d} refresh_every="
              f"{refresh} n_steps={steps} plan={pl.route} cluster="
              f"{pl.cluster} rows_a_block={pl.rows_per} threads={pl.threads} "
              f"dyn_smem={pl.smem}B: max_abs_err(x,ax)={err:.3e} "
              f"bitwise_equal={same} iters={int(git.sum())} "
              f"(plain {int(wit.sum())})")
        need(bool(int(wit.min()) > 1), "lid_sweep: the states did not iterate")
        need(same, "lid_sweep differs from its plain version")
        if timed is None:
            timed = (st, k, kw, err)
    need({c for _, c in routes} == {1, 2, 4, 8} and
         {r for r, _ in routes} == {"smem", "global"},
         f"lid_sweep: the cases ran routes {sorted(routes)}, not every "
         "cluster size and both routes")
    # masked-off rows poisoned with NaN/Inf (refresh off) or large finite
    # garbage (refresh on, where they are weight-0 terms): valid slots equal
    for refresh, finite in ((0, False), (4, True)):
        st = live_states(4, 96, 128, dev, seed=9, n_valid=70)
        dirty = st.v_beta.clone()
        if finite:
            dirty[:, 70:] = 1e6
        else:
            dirty[:, 70:80] = float("nan")
            dirty[:, 80:] = float("inf")
        args = (st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
                st.converged, k_for(128))
        kw = dict(n_steps=16, max_iters=64, tol=1e-5, refresh_every=refresh)
        a = lid_sweep_cuda(st.v_beta, *args, **kw)
        b = lid_sweep_cuda(dirty, *args, **kw)
        need(int(a[2].min()) >= 2, "lid_sweep poison case did not iterate")
        need(all(torch.equal(p, q) for p, q in zip(a, b)),
             f"lid_sweep: poisoned pad rows changed valid slots "
             f"(refresh_every={refresh})")
    st, k, kw, err = timed
    args = (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
            st.converged, k)
    got = lid_sweep_cuda(*args, **kw)
    # lanes converged (or at max_iters) on entry: returned unchanged
    done_in = (got[0], got[1], got[2], torch.ones_like(got[3]))
    again = lid_sweep_cuda(st.v_beta, st.beta_idx, st.beta_mask, *done_in, k,
                           **kw)
    need(all(torch.equal(p, q) for p, q in zip(again, done_in)),
         "lid_sweep: converged lanes changed")
    t = timings(lambda: lid_sweep_cuda(*args, **kw),
                lambda: ref.lid_sweep_ref(*args, kw["n_steps"],
                                          kw["max_iters"], kw["tol"]),
                plain_in_graph=False)
    one = graph_ms(lambda: lid_sweep_cuda(*args, **dict(kw, n_steps=1)))
    idle = graph_ms(lambda: lid_sweep_cuda(st.v_beta, st.beta_idx,
                                           st.beta_mask, *done_in, k, **kw))
    print(f"[kernel] lid_sweep device time of a one-step call {one:.4f} ms, "
          f"of a {kw['n_steps']}-step call {t['ms']:.4f} ms: "
          f"~{(t['ms'] - one) / (kw['n_steps'] - 1):.4f} ms per further "
          f"step; of a call on converged lanes {idle:.4f} ms")
    # the work this run's data needs: one pass over the rows, and per
    # executed step the pi/score lanes plus one affinity column
    cap, d = st.v_beta.shape[1:]
    bsz = st.v_beta.shape[0]
    steps = float((got[2] - st.n_iters).sum())
    b_ms, b_by = bound(4 * bsz * (cap * d + 4 * cap + 2 * cap) + 8 * bsz,
                       steps * (2 * cap * d + 16 * cap) + bsz * 2 * cap * d)
    out["lid_sweep"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                            one_step_ms=one, converged_ms=idle)
    print(f"[kernel] lid_sweep {time_line(t)} bound_ms={b_ms:.5f} ({b_by}) "
          f"steps={int(steps)} library_ms=null (no PyTorch call runs LID "
          "iterations)")


# ----------------------------------------------- bf16 point storage ----
def bf16_entry(t: dict, err: float, b: tuple, f32_ms: float,
               **extra) -> dict:
    """A kernel's bf16 case for the table: its timings, error and bound
    beside the f32 case's device time."""
    return dict(ms=t["ms"], call_ms=t["call_ms"], plain_ms=t["plain_ms"],
                max_abs_err=err, bound_ms=b[0], bound_by=b[1],
                f32_ms=f32_ms, **extra)


def bf16_line(name: str, t: dict, b: tuple, f32_ms: float) -> str:
    return (f"[bf16] {name} {time_line(t)} bound_ms={b[0]:.5f} ({b[1]}, "
            f"rows at 2 bytes) f32 kernel_ms={f32_ms:.4f}")


def check_bf16_kernels(dev, out, data):
    """Phase 2's bf16 cases (ROADMAP B P1): each of the fit's four kernels
    on bf16 rows at the main path's shapes, against its plain version
    (bitwise; lsh_hash within the key-flip rule) and against the f32
    kernel on the upcast rows (bitwise, lsh_hash included), timed beside
    the f32 case with a bound that reads the rows at 2 bytes."""
    from repro_torch.core.lid import refresh_ax
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.affinity_matvec import affinity_matvec_cuda
    from repro_torch.kernels.affinity_matvec import plan as mv_plan
    from repro_torch.kernels.lid_sweep import lid_sweep_cuda
    from repro_torch.kernels.lid_sweep import plan as sweep_plan
    from repro_torch.kernels.lsh_hash import key_flips, lsh_hash_cuda
    from repro_torch.kernels.lsh_hash import plan as lsh_plan
    from repro_torch.kernels.roi_filter import roi_filter_cuda
    from repro_torch.lsh.pstable import make_projections
    from repro_torch.random import PRNGKey, split

    def bf16(t):
        return ops.to_storage(t, "bfloat16")

    def same(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(p, q) for p, q in zip(a, b))
        return torch.equal(a, b)

    # lsh_hash: the store build's 1,000,000 rows (stream) and the probe's
    # 3,584 (probe), the full-width fit's own points rounded to bf16
    points, lshp = data
    xb = bf16(torch.as_tensor(points, device=dev))
    n, d = xb.shape
    n_tables, n_proj, seg = lshp.n_tables, lshp.n_projections, lshp.seg_len
    proj, bias = make_projections(split(PRNGKey(0))[1], lshp, d, dev)
    lm = n_tables * n_proj
    for rows in (n, PROBE_ROWS):
        x = xb[:rows].contiguous()
        got = lsh_hash_cuda(x, proj, bias, seg)
        want = ref.lsh_hash_ref(x, proj, bias, seg)
        up = lsh_hash_cuda(x.float(), proj, bias, seg)
        torch.cuda.synchronize()
        n_flip, near = key_flips(x.float(), proj, bias, seg, got, want)
        route = lsh_plan(rows, d, n_tables, n_proj).route
        print(f"[bf16] lsh_hash n={rows} d={d} plan={route}: flips against "
              f"the plain version {n_flip}, near an integer {near}; equal "
              f"to the f32 kernel on the upcast rows {torch.equal(got, up)}")
        need(torch.equal(got, up), f"lsh_hash bf16 differs from the f32 "
             f"kernel on the upcast rows ({route})")
        need(near and n_flip <= max(1.0, 1e-5 * rows * n_tables),
             f"lsh_hash bf16: {n_flip} flips outside the rule ({route})")
        t = timings(lambda: lsh_hash_cuda(x, proj, bias, seg),
                    lambda: ref.lsh_hash_ref(x, proj, bias, seg))
        b = bound(2 * rows * d + 4 * (lm * d + lm + rows * n_tables),
                  2 * rows * lm * d)
        f32_ms = (out["lsh_hash"]["ms"] if rows == n
                  else out["lsh_hash"]["probe"]["ms"])
        entry = bf16_entry(t, n_flip / float(rows * n_tables), b, f32_ms,
                           plan=route)
        if rows == n:
            out["lsh_hash"]["bf16"] = entry
        else:
            out["lsh_hash"]["bf16"]["probe"] = entry
        print(bf16_line(f"lsh_hash n={rows}", t, b, f32_ms))
    del xb, got, want, up

    # roi_filter: check_roi_filter's inputs, the candidates rounded
    bsz, per_seed, d = 32, 112 * 4 * 16, 128
    g = torch.Generator(device="cpu").manual_seed(2)
    vc = bf16(torch.randn((bsz, per_seed, d), generator=g).to(dev))
    center = torch.randn((bsz, d), generator=g).to(dev)
    radius = torch.full((bsz,), 0.98 * np.sqrt(2 * d), device=dev)
    valid = (torch.rand((bsz, per_seed), generator=g) < 0.7).to(dev)
    got = roi_filter_cuda(vc, center, radius, valid)
    want = ref.roi_filter_ref(vc, center, radius, valid)
    up = roi_filter_cuda(vc.float(), center, radius, valid)
    err = float((got[0] - want[0]).abs().max())
    print(f"[bf16] roi_filter B={bsz} C={per_seed} d={d}: bitwise equal to "
          f"the plain version {same(got, want)}, to the f32 kernel on the "
          f"upcast rows {same(got, up)}")
    need(same(got, want) and same(got, up), "roi_filter bf16 differs")
    t = timings(lambda: roi_filter_cuda(vc, center, radius, valid),
                lambda: ref.roi_filter_ref(vc, center, radius, valid))
    rows = bsz * per_seed
    b = bound(2 * rows * d + 4 * bsz * (d + 1) + rows * (1 + 9),
              3 * rows * d)
    out["roi_filter"]["bf16"] = bf16_entry(t, err, b, out["roi_filter"]["ms"])
    print(bf16_line("roi_filter", t, b, out["roi_filter"]["ms"]))
    del vc, got, want, up

    # affinity_matvec: the fit's two shapes (smem route), then d = 2,048
    # read in place (the global route)
    bsz, cap, a_cap, d = 32, 240, 112, 128
    k = k_for(d)
    st = live_states(bsz, cap, d, dev, seed=3)
    v = bf16(st.v_beta)
    g = torch.Generator(device="cpu").manual_seed(3)
    w = torch.rand((bsz, cap), generator=g).to(dev)
    shapes = {}
    gb = torch.Generator(device="cpu").manual_seed(2048)
    wide = bf16(torch.randn((4, cap, 2048), generator=gb).to(dev))
    wide_i = torch.arange(cap, dtype=torch.int32, device=dev).repeat(4, 1)
    for n_c, q, qi, wc in ((cap, v, st.beta_idx, w),
                           (a_cap, v, st.beta_idx, w),
                           (37, wide, wide_i, w[:4])):
        c, ci, wcc = (t_[:, :n_c].contiguous() for t_ in (q, qi, wc))
        pl = mv_plan(q.shape[1], n_c, q.shape[2])
        got = affinity_matvec_cuda(q, qi, c, ci, wcc, k)
        want = ref.affinity_matvec_ref(q, qi, c, ci, wcc, k)
        up = affinity_matvec_cuda(q.float(), qi, c.float(), ci, wcc, k)
        print(f"[bf16] affinity_matvec B={q.shape[0]} ({q.shape[1]},"
              f"{q.shape[2]}) x ({n_c},{q.shape[2]}) plan={pl.route}: "
              f"bitwise equal to the plain version {same(got, want)}, to "
              f"the f32 kernel on the upcast rows {same(got, up)}")
        need(same(got, want) and same(got, up), f"affinity_matvec bf16 "
             f"differs ({pl.route}, n={n_c})")
        if q is wide:
            continue
        t = timings(lambda: affinity_matvec_cuda(q, qi, c, ci, wcc, k),
                    lambda: ref.affinity_matvec_ref(q, qi, c, ci, wcc, k))
        b = bound(bsz * (2 * (cap + n_c) * d + 4 * (2 * cap + 2 * n_c)),
                  bsz * (2 * cap * n_c * d + 2 * (cap + n_c) * d
                         + 8 * cap * n_c))
        f32 = out["affinity_matvec"]["shapes"][f"32x{cap}x{n_c}"]["ms"]
        shapes[n_c] = bf16_entry(t, float((got - want).abs().max()), b, f32)
        print(bf16_line(f"affinity_matvec n={n_c}", t, b, f32))
    out["affinity_matvec"]["bf16"] = dict(
        shapes[cap], shapes={f"32x{cap}x{n}": e for n, e in shapes.items()})
    del wide

    # lid_sweep: the fit's 32 x (240, 128) (smem route, clusters of 4)
    # and rows read in place (cap 2,000 x d 256, global route)
    timed = None
    routes = set()
    for bsz, cap, d, steps in ((32, 240, 128, 8), (2, 2000, 256, 4)):
        k = k_for(d)
        st = live_states(bsz, cap, d, dev, seed=cap + d)
        st = refresh_ax(st._replace(v_beta=bf16(st.v_beta)), k,
                        backend="ref")
        kw = dict(n_steps=steps, max_iters=256, tol=1e-5)
        got, want = _sweep_pair(st, k, **kw)
        up = lid_sweep_cuda(st.v_beta.float(), *_sweep_args(st, k)[1:],
                            **kw)
        pl = sweep_plan(bsz, cap, d)
        routes.add(pl.route)
        print(f"[bf16] lid_sweep B={bsz} cap={cap} d={d} plan={pl.route} "
              f"cluster={pl.cluster}: bitwise equal to the plain version "
              f"{same(got, want)}, to the f32 kernel on the upcast rows "
              f"{same(got, up)}, iters={int(got[2].sum())}")
        need(int(want[2].min()) > 1, "lid_sweep bf16: no iteration")
        need(same(got, want) and same(got, up), f"lid_sweep bf16 differs "
             f"({pl.route})")
        if timed is None:
            err = max(float((got[0] - want[0]).abs().max()),
                      float((got[1] - want[1]).abs().max()))
            timed = (st, k, kw, got, err)
    need(routes == {"smem", "global"}, f"lid_sweep bf16 routes {routes}")
    st, k, kw, got, err = timed
    args = _sweep_args(st, k)
    t = timings(lambda: lid_sweep_cuda(*args, **kw),
                lambda: ref.lid_sweep_ref(*args, kw["n_steps"],
                                          kw["max_iters"], kw["tol"]),
                plain_in_graph=False)
    bsz, cap, d = st.v_beta.shape
    steps = float((got[2] - st.n_iters).sum())
    b = bound(2 * bsz * cap * d + 4 * bsz * (4 * cap + 2 * cap) + 8 * bsz,
              steps * (2 * cap * d + 16 * cap) + bsz * 2 * cap * d)
    out["lid_sweep"]["bf16"] = bf16_entry(t, err, b, out["lid_sweep"]["ms"])
    print(bf16_line("lid_sweep 8 steps", t, b, out["lid_sweep"]["ms"]))


def _sweep_args(st, k) -> tuple:
    return (st.v_beta, st.beta_idx, st.beta_mask, st.x, st.ax, st.n_iters,
            st.converged, k)


# ---------------------------------------------------------------- fits ----
def cli_blobs(n: int, d: int, clusters: int = 20):
    """`run_palid`'s synthetic data rule: 40% of the points in `clusters`
    blobs, the rest uniform noise, a_cap = max(64, cluster_size + 32)."""
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    cluster_size = max(4, int(n * 0.4) // clusters)
    spec = make_blobs_with_noise(clusters, cluster_size,
                                 n - clusters * cluster_size, d=d, seed=0)
    return spec, auto_lsh_params(spec.points), max(64, cluster_size + 32)


def check_parity_fit(dev):
    from repro_torch.core.alid import ALIDConfig, EngineSpec
    from repro_torch.core.engine import fit
    from repro_torch.random import PRNGKey
    from repro_torch.utils import canonical_labels
    spec, lshp, a_cap = cli_blobs(PARITY_N, 128)
    max_rounds = 64
    res = {}
    for backend in ("auto", "ref"):
        cfg = ALIDConfig(a_cap=a_cap, delta=128, lsh=lshp,
                         seeds_per_round=32, max_rounds=max_rounds,
                         spec=EngineSpec(backend=backend))
        t0 = time.perf_counter()
        res[backend] = fit(spec.points, cfg, PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        print(f"[parity] backend={backend} n={PARITY_N} d=128 a_cap={a_cap} "
              f"max_rounds={max_rounds} (not cut): "
              f"{time.perf_counter() - t0:.2f}s rounds="
              f"{res[backend].n_rounds} clusters={res[backend].n_clusters}")
    a, b = res["auto"], res["ref"]
    same = np.array_equal(canonical_labels(a.labels),
                          canonical_labels(b.labels))
    dens_err = (float(np.max(np.abs(np.sort(a.densities)
                                    - np.sort(b.densities))))
                if a.n_clusters == b.n_clusters and a.n_clusters else 0.0)
    print(f"[parity] labels_equal={same} rounds {a.n_rounds}/{b.n_rounds} "
          f"clusters {a.n_clusters}/{b.n_clusters} "
          f"max_density_diff={dens_err:.3e} (tolerance 1e-4)")
    need(a.n_clusters > 0, "the parity fit found no cluster")
    need(same, "kernel and plain fits gave different canonical labels")
    need(a.n_rounds == b.n_rounds, "kernel and plain fits differ in rounds")
    need(dens_err <= 1e-4, "kernel and plain densities differ > 1e-4")


def full_data():
    from repro_torch.launch import full_width
    t0 = time.perf_counter()
    spec, lshp = full_width.data()
    print(f"[fit] data n={spec.points.shape[0]} d={spec.points.shape[1]} "
          f"made in {time.perf_counter() - t0:.2f}s, {lshp}")
    return spec, lshp


def full_fit(dev, spec, lshp):
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    from repro_torch.utils import avg_f1_score
    n = spec.points.shape[0]
    cfg = full_width.config(lshp)
    engine = make_engine(cfg.spec, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(spec.points, cfg, PRNGKey(0), engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    bsizes = engine.bucket_sizes.cpu().numpy()
    engine.close()
    del engine
    counts = ops.launch_counts()
    routes = {name: paths for name, paths in ops.path_counts().items()
              if name in FIT_KERNELS}
    members = int((res.labels >= 0).sum())
    print(f"[fit] SIFT1M shape {n}x128, a_cap={cfg.a_cap} "
          f"delta={cfg.delta} seeds_per_round={cfg.seeds_per_round} "
          f"max_rounds={cfg.max_rounds} (not cut): "
          f"wall={wall:.2f}s k={res.k:.6g} rounds={res.n_rounds} "
          f"clusters={res.n_clusters} members={members} "
          f"AVG-F={avg_f1_score(spec.labels, res.labels):.4f} (reported, "
          "not gated) max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} (the fit's own: {peak}) "
          f"launches={counts} routes={routes}")
    need(res.n_clusters > 0, "the full-width fit found no cluster")
    need(np.isfinite(res.densities).all()
         and res.labels.shape == (n,), "full-width fit output")
    for name in FIT_KERNELS:
        need(counts[name] > 0, f"kernel {name} was never launched by the fit")
    return res, counts, dict(peak=peak, bucket_sizes=bsizes)


# ------------------------------------------------ the out-of-core engines ----
# phase 3b's data: run_palid's rule at n = 20,000 with 200 blobs of 40, and
# an LSH segment of one median NN distance (auto_lsh_params' seg_scale 1),
# so that probe 128 covers every bucket and every engine is exact
PARITY_ENGINE_DATA = dict(n_clusters=200, cluster_size=40, n_noise=12_000,
                          d=128, seed=0)
PARITY_PROBE = 128
# the out-of-core engines of 3b, 4b-4d: 8 shards; phase 3b's three pipeline
# configurations of the streamed engine
N_SHARDS = 8
STREAM_CONFIGS = {
    "sync": dict(prefetch_depth=0, cache_bytes=0, scratch_dir=None),
    "default": dict(),                   # scratch, LRU, depth 2
    "depth7": dict(prefetch_depth=7),
}
# 4c: the LRU holds all 8 of the full-width store's bundles (the
# --cache-bytes knob), the reader runs 2 bundles ahead; the fit is cut to
# 16 of full_width's 64 rounds to keep the script inside its time limit
# (each round reads every shard through the reader: ~2.2 s a round); the
# store, the width, the shards and the data are not cut
STREAM_CACHE_BYTES = 1 << 30
STREAM_DEPTH = 2
STREAM_ROUNDS = 16


def engine_parity_data():
    """Phase 3b's points and config; the largest bucket must fit the
    probe."""
    from repro_torch.core.alid import ALIDConfig
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    from repro_torch.lsh.pstable import build_lsh
    from repro_torch.random import PRNGKey
    spec = make_blobs_with_noise(**PARITY_ENGINE_DATA)
    lshp = auto_lsh_params(spec.points, probe=PARITY_PROBE, seg_scale=1.0)
    tables = build_lsh(torch.as_tensor(spec.points, device=DEVICE), lshp,
                       PRNGKey(0), backend="ref")
    largest = max(int(torch.unique(t, return_counts=True)[1].max())
                  for t in tables.sorted_keys)
    print(f"[parity] engines' data {spec.points.shape}: {lshp}, the largest "
          f"bucket {largest} <= probe {PARITY_PROBE}")
    need(largest <= PARITY_PROBE, "phase 3b: a bucket exceeds the probe")
    cfg = ALIDConfig(a_cap=PARITY_ENGINE_DATA["cluster_size"] + 32,
                     delta=128, lsh=lshp, seeds_per_round=32, max_rounds=64)
    return spec, cfg


def same_fit(a, b) -> tuple[bool, str]:
    """Equal canonical labels and rounds, densities within rtol 1e-6."""
    from repro_torch.utils import canonical_labels
    labels = np.array_equal(canonical_labels(a.labels),
                            canonical_labels(b.labels))
    dens = (a.n_clusters == b.n_clusters and np.allclose(
        np.sort(a.densities), np.sort(b.densities), rtol=1e-6, atol=0))
    ok = labels and a.n_rounds == b.n_rounds and dens
    return ok, (f"labels_equal={labels} rounds {a.n_rounds}/{b.n_rounds} "
                f"clusters {a.n_clusters}/{b.n_clusters} "
                f"densities_rtol_1e-6={dens}")


def need_clean(engine, what: str) -> None:
    """A streamed fit took no fallback: no retry, corruption, tier
    fallback, reader death or abandoned reader, and with the reader on,
    the reader produced every shard (none fetched inline)."""
    depth = engine.spec.prefetch_depth
    fell = engine.stats.fallbacks(prefetched=depth > 0)
    snap = engine.stats.snapshot()
    print(f"[pipeline] {what}: shards {snap['shards_streamed']}, by the "
          f"reader {snap['shards_prefetched']} (depth {depth}), "
          f"fallbacks {fell}")
    need(not fell, f"{what}: the pipeline fell back: {fell}")
    need(snap["shards_streamed"] > 0, f"{what}: no shard streamed")


def check_engine_parity(dev, spec, cfg) -> dict:
    """Phase 3b: the sharded engine and the streamed engine in three
    pipeline configurations against the replicated fit, through the
    kernels, at n = 20,000 x 128, and the replicated fit through
    backend="ref" against the kernels' one; every streamed run takes no
    fallback. Returns the kernel path's sharded fit (phase 10c's
    reference) and its replicated fit (phase 11b's)."""
    import tempfile

    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.random import PRNGKey
    out = {}
    with tempfile.TemporaryDirectory(prefix="alid_parity_") as tmp:
        for backend in ("auto", "ref"):
            runs = [("replicated", EngineSpec(backend=backend))]
            # the out-of-core engines through backend="ref" are the CPU
            # tests' (tests/test_torch_engine.py, test_torch_pipeline.py:
            # the same code, bit for bit); here they run on the kernels
            if backend == "auto":
                runs += [("sharded", EngineSpec(engine="sharded",
                                                n_shards=N_SHARDS))]
                runs += [(f"streamed-{name}", EngineSpec(
                    engine="streamed", n_shards=N_SHARDS,
                    **{"scratch_dir": tmp, **kw}))
                    for name, kw in STREAM_CONFIGS.items()]
            base = None
            for name, espec in runs:
                engine = make_engine(espec, device=dev)
                t0 = time.perf_counter()
                res = fit(spec.points, cfg._replace(spec=espec), PRNGKey(0),
                          engine=engine)
                torch.cuda.synchronize()
                if espec.engine == "streamed":
                    need_clean(engine, f"phase 3b {name} ({backend})")
                engine.close()
                line = (f"[parity] {name} backend={backend} "
                        f"{time.perf_counter() - t0:.2f}s rounds="
                        f"{res.n_rounds} clusters={res.n_clusters}")
                if base is None:
                    base = res
                    need(res.n_clusters > 0, "phase 3b found no cluster")
                    print(line)
                else:
                    ok, why = same_fit(res, base)
                    print(f"{line} against replicated: {why}")
                    need(ok, f"phase 3b: {name} ({backend}) differs from "
                         "the replicated fit")
                out[(name, backend)] = res
    ok, why = same_fit(out[("replicated", "auto")], out[("replicated", "ref")])
    print(f"[parity] engines' data, kernel vs plain replicated: {why}")
    need(ok, "phase 3b: kernel and plain replicated fits differ")
    return out[("sharded", "auto")], slim(out[("replicated", "auto")])


def bitwise_fit(a, b) -> tuple[bool, str]:
    """Labels, rounds and densities equal bit for bit."""
    labels = np.array_equal(a.labels, b.labels)
    dens = (a.densities.shape == b.densities.shape and np.array_equal(
        a.densities.view(np.uint32), b.densities.view(np.uint32)))
    ok = labels and a.n_rounds == b.n_rounds and dens
    return ok, (f"labels_bitwise={labels} rounds {a.n_rounds}/{b.n_rounds} "
                f"clusters {a.n_clusters}/{b.n_clusters} "
                f"densities_bitwise={dens}")


def check_engine_parity_bf16(dev, spec, cfg) -> dict:
    """Phase 3b at bf16 storage: the replicated fit through the kernels,
    through backend="ref", the sharded engine (8 shards) and the streamed
    engine in its default pipeline configuration, at n = 20,000 x 128:
    bit-identical labels, rounds and densities (the contract of the JAX
    package's test_bf16_engine_parity_interpret). Returns the kernels'
    launches."""
    import tempfile

    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.kernels import ops
    from repro_torch.random import PRNGKey
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="alid_bf16_") as tmp:
        runs = (("replicated", EngineSpec(dtype="bfloat16")),
                ("replicated-ref", EngineSpec(dtype="bfloat16",
                                              backend="ref")),
                ("sharded", EngineSpec(engine="sharded", n_shards=N_SHARDS,
                                       dtype="bfloat16")),
                ("streamed-default", EngineSpec(
                    engine="streamed", n_shards=N_SHARDS, scratch_dir=tmp,
                    dtype="bfloat16")))
        base = None
        for name, espec in runs:
            engine = make_engine(espec, device=dev)
            t0 = time.perf_counter()
            res = fit(spec.points, cfg._replace(spec=espec), PRNGKey(0),
                      engine=engine)
            torch.cuda.synchronize()
            if espec.engine == "streamed":
                need_clean(engine, f"phase 3b {name} (bf16)")
            engine.close()
            line = (f"[parity-bf16] {name} {time.perf_counter() - t0:.2f}s "
                    f"rounds={res.n_rounds} clusters={res.n_clusters}")
            if base is None:
                base = res
                need(res.n_clusters > 0, "phase 3b bf16 found no cluster")
                print(line)
                continue
            ok, why = bitwise_fit(res, base)
            print(f"{line} against the replicated kernel fit: {why}")
            need(ok, f"phase 3b bf16: {name} is not bit-identical to the "
                 "replicated kernel fit")
    return ops.launch_counts()


def store_summary(gidx, valid, sorted_keys, perm, bsizes) -> dict:
    """A store's integer leaves as host int64 arrays."""
    def host(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.astype(np.int64)
    return dict(global_idx=host(gidx), valid=host(valid),
                sorted_keys=host(sorted_keys), perm=host(perm),
                bucket_sizes=host(bsizes))


def agreement(a, b) -> float:
    """The share of points with equal canonical labels."""
    from repro_torch.utils import canonical_labels
    return float(np.mean(canonical_labels(a) == canonical_labels(b)))


def full_fit_sharded(dev, spec, lshp, rep, rep_info) -> tuple:
    """Phase 4b: the sharded engine at full width (8 shards, the store on
    the card). Returns (its store's integer leaves, launches)."""
    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.civs import _ROUTE_EPS
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.core.store import global_bucket_sizes
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    from repro_torch.utils import avg_f1_score
    n = spec.points.shape[0]
    cfg = full_width.config(lshp)._replace(
        spec=EngineSpec(engine="sharded", n_shards=N_SHARDS))
    engine = make_engine(cfg.spec, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fit(spec.points, cfg, PRNGKey(0), engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = ops.launch_counts()
    store = engine.store
    members = torch.sort(store.global_idx[store.valid]).values
    partition = bool(torch.equal(members, torch.arange(n, device=dev)))
    # the balls in f64 against the routing test's own slack
    dist = torch.sqrt(((store.shards.double()
                        - store.centers.double()[:, None]) ** 2).sum(-1))
    radii = store.radii.double()[:, None]
    covered = bool(((dist <= radii + _ROUTE_EPS * (1.0 + radii))
                    | ~store.valid).all())
    bsizes = global_bucket_sizes(store).cpu().numpy()
    same_b = np.array_equal(bsizes, rep_info["bucket_sizes"])
    rep_info["sharded_peak"] = peak
    summary = store_summary(store.global_idx, store.valid,
                            store.tables.sorted_keys, store.tables.perm,
                            bsizes)
    engine.close()
    del engine, store, dist
    torch.cuda.empty_cache()
    print(f"[sharded] full width {n}x128, {N_SHARDS} shards, "
          f"max_rounds={cfg.max_rounds} (not cut): wall={wall:.2f}s "
          f"rounds={res.n_rounds} clusters={res.n_clusters} "
          f"AVG-F={avg_f1_score(spec.labels, res.labels):.4f} peak device "
          f"memory of the fit {peak} (replicated {rep_info['peak']}); "
          f"launches={counts}")
    print(f"[sharded] every point once in the shards: {partition}; every "
          f"ball covers its members: {covered}; global_bucket_sizes == the "
          f"replicated engine's bucket_sizes: {same_b}; agreement with "
          f"phase 4's labels {agreement(res.labels, rep.labels):.6f}, "
          f"clusters {res.n_clusters}/{rep.n_clusters} (not gated: probe "
          f"{lshp.probe} is below the largest bucket at this width)")
    need(partition, "4b: the shards are not a partition of the points")
    need(covered, "4b: a shard ball misses one of its members")
    need(same_b, "4b: global bucket sizes differ from the replicated ones")
    need(res.n_clusters > 0 and np.isfinite(res.densities).all(),
         "4b: sharded fit output")
    for name in FIT_KERNELS:
        need(counts[name] > 0, f"4b: kernel {name} was never launched")
    return summary, counts, res


def full_fit_streamed(dev, spec, lshp, rep_info, sharded) -> tuple:
    """Phase 4c: the streamed engine at full width from a .npy on disk
    through MemmapSource (8 shards, scratch beside it, a 1 GiB LRU, the
    reader 2 bundles ahead). Returns (launches, result)."""
    import tempfile

    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.core.source import MemmapSource
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    from repro_torch.utils import avg_f1_score
    n = spec.points.shape[0]
    with tempfile.TemporaryDirectory(prefix="alid_stream_") as tmp:
        path = Path(tmp) / "points.npy"
        np.save(path, spec.points)
        cfg = full_width.config(lshp, STREAM_ROUNDS)._replace(
            spec=EngineSpec(engine="streamed", n_shards=N_SHARDS,
                            scratch_dir=tmp, cache_bytes=STREAM_CACHE_BYTES,
                            prefetch_depth=STREAM_DEPTH))
        engine = make_engine(cfg.spec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fit(MemmapSource(path), cfg, PRNGKey(0), engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        counts = ops.launch_counts()
        st = engine._store
        got = store_summary(st.global_idx, st.valid, st.sorted_keys,
                            st.perm, st.bucket_sizes)
        same_order = np.array_equal(
            st.order.astype(np.int64), sharded["global_idx"].reshape(-1)[:n])
        stats = engine.stats.snapshot()
        report = engine.stats.report()
        need_clean(engine, "4c")
        engine.close()
    diff = [k for k in got if not np.array_equal(got[k], sharded[k])]
    print(f"[streamed] full width {n}x128 from a .npy (MemmapSource), "
          f"{N_SHARDS} shards, scratch beside it, cache_bytes="
          f"{STREAM_CACHE_BYTES}, prefetch_depth={STREAM_DEPTH}, "
          f"max_rounds={cfg.max_rounds} (cut from "
          f"{full_width.MAX_ROUNDS}; width, shards and data not cut): "
          f"wall={wall:.2f}s rounds={res.n_rounds} clusters="
          f"{res.n_clusters} AVG-F="
          f"{avg_f1_score(spec.labels, res.labels):.4f}; peak device "
          f"memory of the fit {peak} (replicated {rep_info['peak']}); "
          f"launches={counts}")
    print(f"[streamed] {report}")
    print(f"[streamed] stats {json.dumps(stats)}")
    print(f"[streamed] store equal to 4b's: order {same_order}, differing "
          f"leaves {diff}; agreement with 4b's labels after "
          f"{cfg.max_rounds} rounds (not gated) "
          f"{agreement(res.labels, sharded['labels']):.6f}")
    need(same_order and not diff, "4c: the streamed store differs from "
         "the sharded one")
    need(peak < rep_info["peak"], "4c: the streamed fit's device peak is "
         "not below the replicated fit's")
    need(res.n_clusters > 0 and np.isfinite(res.densities).all(),
         "4c: streamed fit output")
    for name in FIT_KERNELS:
        need(counts[name] > 0, f"4c: kernel {name} was never launched")
    return counts, res


def check_fault_tolerance(dev, full_spec, full_lshp, rep) -> dict:
    """Phase 4d: crash at round 3 and resume on the replicated engine at
    full width against phase 4's labels; run_palid's sharded, faulty
    streamed (transient source faults, fault parity) and checkpoint /
    resume runs. The streamed engine's crash and resume at n = 20,000 and
    its fault arms there (transient faults, forced scratch corruption, a
    killed reader) are the CPU tests' (tests/test_torch_resilience.py,
    test_torch_pipeline.py): their time went to phases 12 and 13.
    Returns the launches of the full-width crash and resume (run_palid's
    toy fits are not in them)."""
    import tempfile

    from repro_torch.core.engine import fit
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width, run_palid
    from repro_torch.random import PRNGKey
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="alid_faults_") as tmp:
        ckpt = str(Path(tmp) / "full_ckpt")
        fcfg = full_width.config(full_lshp)
        t0 = time.perf_counter()
        try:
            fit(full_spec.points, fcfg, PRNGKey(0), checkpoint_dir=ckpt,
                crash_at_round=3, device=dev)
            need(False, "4d: the injected crash did not happen")
        except RuntimeError as exc:
            need("injected crash at round 3" in str(exc), f"4d: {exc}")
        # no checkpoint after the resume point: saving every round of a
        # full-width fit would write up to 0.25 GB of supports a round
        res = fit(full_spec.points, fcfg, PRNGKey(0), checkpoint_dir=ckpt,
                  resume=True, checkpoint_every=fcfg.max_rounds + 1,
                  device=dev)
        same = (np.array_equal(res.labels, rep.labels)
                and res.n_rounds == rep.n_rounds
                and np.array_equal(res.densities, rep.densities))
        print(f"[faults] replicated full width, crash at round 3 then "
              f"resume: {time.perf_counter() - t0:.2f}s, bit-identical to "
              f"phase 4: {same}")
        need(same, "4d: the resumed full-width fit differs from phase 4")
        resume_counts = ops.launch_counts()
        print(f"[faults] launches of 4d's full-width crash and resume: "
              f"{resume_counts}")
        for name in FIT_KERNELS:
            need(resume_counts[name] > 0,
                 f"4d: kernel {name} was never launched at full width")

        cli_ckpt = str(Path(tmp) / "cli_ckpt")
        for flags in (["--engine", "sharded", "--shards", "4"],
                      ["--engine", "streamed", "--shards", "4",
                       "--inject-faults", "transient:0.1"],
                      ["--checkpoint-dir", cli_ckpt],
                      ["--checkpoint-dir", cli_ckpt, "--resume"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run_palid.main(["--quick", *flags])
            lines = [ln for ln in out.getvalue().splitlines()
                     if ln.startswith("[palid]")]
            for ln in lines:
                print(f"[faults] cli {' '.join(flags)}: {ln}")
            need(any(ln.startswith("[palid] n=") for ln in lines),
                 f"4d: run_palid {flags}")
            if "--inject-faults" in flags:
                need(any("fault-parity=True" in ln for ln in lines),
                     "4d: run_palid --inject-faults lost fault parity")
    return resume_counts


# ------------------------------------------------------------- serving ----
def full_fit_bf16(dev, spec, lshp, rep, rep_info) -> tuple:
    """Phase 4e: the full-width fit at bf16 storage on the replicated and
    the sharded engine (the four fit kernels launched on each; wall time,
    peak device memory, clusters and AVG-F printed), and the storage
    identity: the replicated bf16 fit equals, bit for bit, the f32 fit of
    the bf16-rounded rows with k pinned to the bf16 fit's k (labels,
    rounds, densities, support ids and weights). Returns (the replicated
    bf16 fit, its config, the phase's launches)."""
    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    from repro_torch.utils import avg_f1_score
    n = spec.points.shape[0]
    launches = dict.fromkeys(FIT_KERNELS, 0)
    fits = {}
    for name, espec in (("replicated", EngineSpec(dtype="bfloat16")),
                        ("sharded", EngineSpec(engine="sharded",
                                               n_shards=N_SHARDS,
                                               dtype="bfloat16"))):
        cfg = full_width.config(lshp)._replace(spec=espec)
        engine = make_engine(espec, device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fit(spec.points, cfg, PRNGKey(0), engine=engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        engine.close()
        del engine
        counts = ops.launch_counts()
        f32_peak = (rep_info["peak"] if name == "replicated"
                    else rep_info.get("sharded_peak"))
        print(f"[bf16-fit] {name} full width {n}x128 dtype=bfloat16, "
              f"max_rounds={cfg.max_rounds} (not cut): wall={wall:.2f}s "
              f"k={res.k:.6g} rounds={res.n_rounds} clusters="
              f"{res.n_clusters} members={int((res.labels >= 0).sum())} "
              f"AVG-F={avg_f1_score(spec.labels, res.labels):.4f} peak "
              f"device memory of the fit {peak} (f32: {f32_peak}); "
              f"launches={ {k: counts[k] for k in FIT_KERNELS} }")
        need(res.n_clusters > 0 and np.isfinite(res.densities).all()
             and res.labels.shape == (n,), f"4e: {name} bf16 fit output")
        for k in FIT_KERNELS:
            need(counts[k] > 0, f"4e: kernel {k} was never launched by the "
                 f"{name} bf16 fit")
            launches[k] += counts[k]
        fits[name] = (res, cfg)
        torch.cuda.empty_cache()
    res16, cfg16 = fits["replicated"]
    # the storage identity, on the card with no JAX
    rounded = ops.to_storage(torch.as_tensor(spec.points, device=dev),
                             "bfloat16").float().cpu().numpy()
    cfg32 = full_width.config(lshp)._replace(k=res16.k)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    want = fit(rounded, cfg32, PRNGKey(0), device=dev)
    counts = ops.launch_counts()
    for k in FIT_KERNELS:
        launches[k] += counts[k]
    ok, why = bitwise_fit(res16, want)
    sup = (np.array_equal(res16.support_idx, want.support_idx)
           and np.array_equal(res16.support_w.view(np.uint32),
                              want.support_w.view(np.uint32)))
    print(f"[bf16-fit] replicated bf16 fit against the f32 fit of the "
          f"bf16-rounded rows at k={res16.k:.9g} pinned "
          f"({time.perf_counter() - t0:.2f}s): {why} "
          f"supports_bitwise={sup}; against phase 4's f32 fit: agreement "
          f"{agreement(res16.labels, rep.labels):.6f}, clusters "
          f"{res16.n_clusters}/{rep.n_clusters}, k {res16.k:.9g}/"
          f"{rep.k:.9g}")
    need(ok and sup, "4e: the bf16 fit is not the f32 fit of the rounded "
         "rows at its k")
    del rounded, want, fits
    torch.cuda.empty_cache()
    return res16, cfg16, launches


def check_online_bf16(dev, res, points, cfg) -> dict:
    """5b's short arm at bf16 on 4e's fit: an 8-row insert and a
    support-member delete through the kernels and through backend="ref"
    on the card, the state arrays bit-equal; then commit, rollback(0) and
    forward again, bit-identical; `lid_sweep` and `affinity_matvec` (the
    warm LIDs and ROI refreshes) launched. Returns the launches."""
    import tempfile

    from repro_torch.core.online import OnlineClustering
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="alid_online_bf16_") as tmp:
        t0 = time.perf_counter()
        oc = OnlineClustering(res, points, cfg, ckpt_dir=f"{tmp}/kernel",
                              keep=3, auto_flush=False, device=dev)
        ref_cfg = cfg._replace(spec=cfg.spec._replace(backend="ref"))
        plain = OnlineClustering(res, points, ref_cfg, ckpt_dir=f"{tmp}/ref",
                                 keep=1, auto_flush=False, device=dev)
        build_s = time.perf_counter() - t0
        base = online_state(oc)
        labeled = np.flatnonzero(base["labels"] >= 0)
        rows = jittered(points, labeled, 8, np.random.default_rng(5))
        dense = int(np.argmax(base["densities"]))
        victim = int(base["sup_idx"][dense][base["sup_w"][dense] > 0][1])
        moved = []
        t0 = time.perf_counter()
        for o in (oc, plain):
            stats0 = o.stats.snapshot()
            o.insert(rows)
            o.delete([victim])
            moved.append({key: value - stats0[key]
                          for key, value in o.stats.snapshot().items()})
        diff = state_diff(oc, online_state(plain))
        print(f"[online-bf16] {oc.n_clusters} clusters, dtype "
              f"{cfg.spec.dtype}: construction of both {build_s:.2f}s; "
              f"8-row insert + delete of support member {victim}, kernels "
              f"vs backend='ref' on the card ({time.perf_counter() - t0:.2f}"
              f"s): arrays differing: {diff or 'none'}; stats moved alike: "
              f"{moved[0] == moved[1]} {moved[0]}")
        need(moved[0]["routed"] == 8 and moved[0]["reconverges"] > 0,
             "online bf16: the insert was not routed and re-converged")
        need(diff == [] and moved[0] == moved[1], f"online bf16: kernel "
             f"and plain states differ in {diff}")
        del plain
        ep = oc.commit({"bf16": True})
        mutated = online_state(oc)
        oc.rollback(0)
        back_diff = state_diff(oc, base)
        oc.rollback(ep.id)
        fwd_diff = state_diff(oc, mutated)
        print(f"[online-bf16] commit -> epoch {ep.id}; rollback(0) "
              f"differing from epoch 0: {back_diff or 'none'}; "
              f"rollback({ep.id}) differing: {fwd_diff or 'none'}")
        need(back_diff == [] and fwd_diff == [], "online bf16: rollback "
             "round trip")
    counts = ops.launch_counts()
    # warm LIDs and ROI refreshes: no flush, so no hashing or filtering
    for k in ("lid_sweep", "affinity_matvec"):
        need(counts[k] > 0, f"online bf16: kernel {k} was never launched")
    return counts


def check_cli_bf16(dev) -> None:
    """`run_palid --quick --dtype bfloat16` on the card."""
    from repro_torch.launch import run_palid
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_palid.main(["--quick", "--dtype", "bfloat16"])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[palid] n=")]
    print(f"[cli-bf16] {lines}")
    need(len(lines) == 1 and "dtype=bfloat16" in lines[0]
         and "clusters=0 " not in lines[0], "run_palid --dtype bfloat16")


def serving_mix(points, n: int, seed: int = 3) -> np.ndarray:
    """benchmarks/serving_latency.py's query mix on this data: dataset rows,
    rows jittered by N(0, 0.05), and far noise (uniform in [-60, 60] + 300),
    in the proportions 7 : 7 : 2, shuffled."""
    rng = np.random.default_rng(seed)
    n_far = n // 8
    n_rows = (n - n_far) // 2
    base = points[rng.integers(0, len(points), size=n - n_far)]
    jitter = rng.normal(scale=0.05, size=base.shape)
    jitter[:n_rows] = 0.0
    far = rng.uniform(-60, 60, size=(n_far, points.shape[1])) + 300.0
    queries = np.concatenate([base + jitter, far]).astype(np.float32)
    rng.shuffle(queries)
    return queries


def composition(q, sup_v, sup_w, dens, k: float, t: float):
    """The assignment as PyTorch library calls (cuBLAS matmul expansion,
    exp, segment sum, argmax, threshold): timed as a yardstick, never
    called by the port."""
    n_c, a_cap, d = sup_v.shape
    s = sup_v.reshape(n_c * a_cap, d)
    d2 = ((q * q).sum(-1)[:, None] + (s * s).sum(-1)[None]
          - 2.0 * torch.matmul(q, s.T))
    aff = torch.exp(-k * torch.sqrt(d2.clamp_min(0.0)))
    score = (aff.view(-1, n_c, a_cap) * sup_w).sum(-1)
    best = score.argmax(-1)
    bscore = score.gather(1, best[:, None])[:, 0]
    return torch.where(bscore >= t * dens[best], best, -1), bscore


def assign_bound(m: int, n_c: int, a_cap: int, d: int) -> tuple[float, str]:
    """The assign call's bound: q, the supports, weights and densities read
    once, labels and scores written once; the dots, norms and per pair the
    distance, exp and weighted sum, and the argmax."""
    return bound(4 * (m * d + n_c * a_cap * (d + 1) + n_c) + 8 * m,
                 2 * m * n_c * a_cap * d + 2 * n_c * a_cap * d + 2 * m * d
                 + 9 * m * n_c * a_cap + 2 * m * n_c)


def check_assign(dev, out, res, mix):
    """The assign kernels against their plain version at full width: the
    tiles kernel on 256 rows and a NaN-poisoned, masked 64-slot batch, the
    lanes kernel on a 4-row batch (serving's occupied slots), both at d =
    2,048 (C2); each timed beside its bound and the cuBLAS composition."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign import assign_cuda, plan
    sup_v, sup_w, dens = (torch.as_tensor(x, device=dev) for x in
                          (res.support_v, res.support_w, res.densities))
    n_c, a_cap, d = sup_v.shape
    k, thr = res.k, 0.5
    q = torch.as_tensor(mix[:256], device=dev)
    got = assign_cuda(q, sup_v, sup_w, dens, k, thr)
    want = ref.assign_ref(q, sup_v, sup_w, dens, k, thr)
    torch.cuda.synchronize()
    err = float((got[1] - want[1]).abs().max())
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    labelled = int((got[0] >= 0).sum())
    print(f"[serve] assign m=256 C={n_c} A={a_cap} d={d} k={k:.6g} "
          f"threshold={thr} plan={plan(256, n_c, a_cap, d)}: labelled="
          f"{labelled} max_abs_err={err:.3e} bitwise_equal={same}")
    need(same, "assign: labels or scores differ from the plain version")
    need(labelled > 0, "assign: no query of the mix was labelled")
    # a NaN-poisoned, masked 64-slot batch: pads -1 / 0.0, real rows equal
    valid = torch.arange(64, device=dev) < 40
    dirty = q[:64].clone()
    dirty[40:] = float("nan")
    g = assign_cuda(dirty, sup_v, sup_w, dens, k, thr, valid)
    w = ref.assign_ref(dirty, sup_v, sup_w, dens, k, thr, valid)
    need(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]),
         "assign: masked batch differs from the plain version")
    need(bool((g[0][40:] == -1).all()) and bool((g[1][40:] == 0.0).all()),
         "assign: masked pad slots must come out -1 and 0.0")
    need(torch.equal(g[0][:40], got[0][:40])
         and torch.equal(g[1][:40], got[1][:40]),
         "assign: poisoned pad rows changed the real rows")
    print("[serve] assign masked 64-slot batch, NaN pads: bitwise_equal=True")
    # the occupied prefix of a batch: 4 rows on the lanes kernel, each row
    # bitwise the 256-row call's
    q4 = q[:4].contiguous()
    g4 = assign_cuda(q4, sup_v, sup_w, dens, k, thr)
    need(torch.equal(g4[0], got[0][:4]) and torch.equal(g4[1], got[1][:4]),
         "assign: a 4-row batch differs from the same rows in a full one")
    print(f"[serve] assign 4-row batch plan={plan(4, n_c, a_cap, d)}: "
          f"bitwise equal to the same rows of the 256-row call")
    check_assign_wide(dev)
    timed = {}
    for m, qm in ((64, q[:64]), (4, q4)):
        t = timings(lambda: assign_cuda(qm, sup_v, sup_w, dens, k, thr),
                    lambda: ref.assign_ref(qm, sup_v, sup_w, dens, k, thr),
                    plain_runs=3)
        lib = composition(qm, sup_v, sup_w, dens, k, thr)
        agree = float((lib[0] == got[0][:m]).float().mean())
        lib_ms = graph_ms(lambda: composition(qm, sup_v, sup_w, dens, k,
                                              thr))
        b_ms, b_by = assign_bound(m, n_c, a_cap, d)
        t.update(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                 composition_ms=lib_ms,
                 plan=plan(m, n_c, a_cap, d).kernel)
        timed[m] = t
        print(f"[serve] assign one {m}-row batch ({t['plan']} kernel): "
              f"{time_line(t)} bound_ms={b_ms:.4f} ({b_by}) library_ms=null "
              "(no one PyTorch call computes distance + exp + segment sum + "
              f"argmax + threshold); cuBLAS composition {lib_ms:.4f} ms "
              f"(device time, CUDA graph; yardstick, labels agree on "
              f"{agree:.4f} of the rows)")
    need(timed[64]["ms"] < timed[64]["composition_ms"], "assign: the 64-slot "
         "batch is not faster than the cuBLAS composition")
    out["assign"] = dict(timed[64], rows4={
        key: timed[4][key] for key in ("ms", "call_ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "composition_ms", "plan")})
    return sup_v, sup_w, dens


def check_assign_wide(dev):
    """C2: d = 2,048 (past the old kernel's 1,184) at 64 and 4 rows, bitwise
    equal to the plain version, NaN-poisoned masked pads included."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assign import assign_cuda, plan
    rng = np.random.default_rng(21)
    n_c, a_cap, d = 64, 240, 2048
    centers = rng.normal(size=(n_c, d)).astype(np.float32) * 4.0
    sup_v = torch.as_tensor(centers[:, None] + rng.normal(
        size=(n_c, a_cap, d)).astype(np.float32), device=dev)
    sup_w = torch.as_tensor(rng.uniform(0, 1, (n_c, a_cap)).astype(
        np.float32), device=dev)
    sup_w /= sup_w.sum(1, keepdim=True)
    dens = torch.as_tensor(rng.uniform(0.0, 0.05, n_c).astype(np.float32),
                           device=dev)
    q = torch.as_tensor(centers[rng.integers(0, n_c, 64)] + rng.normal(
        size=(64, d)).astype(np.float32), device=dev)
    k = float(np.float32(1.0 / np.sqrt(2.0 * d)))
    valid = torch.arange(64, device=dev) % 5 != 3
    q[~valid] = float("nan")
    for m in (64, 4):
        args = (q[:m], sup_v, sup_w, dens, k, 0.5, valid[:m])
        got, want = assign_cuda(*args), ref.assign_ref(*args)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        labelled = int((got[0] >= 0).sum())
        print(f"[serve] assign C2 case: m={m} C={n_c} A={a_cap} d={d} plan="
              f"{plan(m, n_c, a_cap, d)}: labelled={labelled} "
              f"bitwise_equal={same}")
        need(same, f"assign at d={d}, m={m}: differs from the plain version")
        need(labelled > 0, f"assign at d={d}: nothing labelled")


def check_serving(dev, res, points, mix, sup):
    """The serving path from launch counts at 0: bulk predict, the
    ClusterService, and run_palid's open-loop ClusterServer bench."""
    from repro_torch.core.alid import assign_labels
    from repro_torch.kernels import ops
    from repro_torch.launch import run_palid
    from repro_torch.serve import ClusterService
    queries = run_palid.serve_queries(points)
    # the reference: each query assigned alone, through predict's own path
    # (assign_labels) on the resident supports
    t0 = time.perf_counter()
    alone = np.asarray([assign_labels(v[None], *sup, res.k, 0.5,
                                      device=dev)[0] for v in queries],
                       np.int32)
    print(f"[serve] per-query assignment of {len(queries)} queries: "
          f"{time.perf_counter() - t0:.2f}s, labelled="
          f"{int((alone >= 0).sum())}")
    ops.reset_launch_counts()

    bulk_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bulk = res.predict(mix, device=dev)
        bulk_s.append(time.perf_counter() - t0)
    print(f"[serve] bulk predict of {len(mix)} rows (supports uploaded per "
          f"call, host clock): {' '.join(f'{x * 1e3:.2f}' for x in bulk_s)} "
          f"ms, labelled={int((bulk >= 0).sum())}")
    need(bulk.shape == (len(mix),) and bulk.dtype == np.int32,
         "bulk predict output")

    svc = ClusterService(res, batch_slots=64, device=dev)
    t0 = time.perf_counter()
    rids = [svc.submit(v) for v in queries]
    served = svc.serve()
    svc_s = time.perf_counter() - t0
    svc_labels = np.asarray([served[r] for r in rids], np.int32)
    print(f"[serve] ClusterService(batch_slots=64) over {len(queries)} "
          f"queries: {svc_s * 1e3:.2f} ms, equal to per-query "
          f"assignment: {np.array_equal(svc_labels, alone)}")
    need(np.array_equal(svc_labels, alone),
         "ClusterService labels differ from per-query assignment")

    out = run_palid._serve_bench(res, points, SERVE_RATE, device=dev)
    need(out is not None, "serve bench skipped")
    same = np.array_equal(out["labels"], svc_labels)
    st = out["stats"]
    print(f"[serve] ClusterServer open loop at {SERVE_RATE:.0f} req/s: "
          f"p50={out['latency_ms_p50']:.4f} ms p99="
          f"{out['latency_ms_p99']:.4f} ms max={out['latency_ms_max']:.4f} "
          f"ms throughput={out['throughput_rps']:.1f} req/s occupancy="
          f"{out['occupancy']:.4f} batches={st['batches']} compute_s="
          f"{st['compute_s']:.4f} pack_s={st['pack_s']:.4f} queue_wait_s="
          f"{st['queue_wait_s']:.4f}; labels equal to the service's: {same}")
    need(same, "ClusterServer labels differ from ClusterService labels")
    counts = ops.launch_counts()
    print(f"[serve] launches of the serving path: {counts}; assign by "
          f"kernel: {ops.path_counts()['assign']}")
    need(counts["assign"] > 0, "the serving path never launched assign")
    return counts


# ------------------------------------------------------ online updates ----
# the online path's state arrays, its kernels, its deltas (rows) and the
# epochs it must keep: the baseline and the five commits of 5b
ONLINE_ARRAYS = ("points", "alive", "labels", "sup_idx", "sup_w", "sup_v",
                 "densities", "live")
ONLINE_KERNELS = ("lid_sweep", "affinity_matvec", "lsh_hash", "roi_filter",
                  "assign")
ONLINE_DELTAS = (1, 8, 64)
ONLINE_KEEP = 6
BLOB_ROWS = 80


def online_state(oc) -> dict:
    return {name: getattr(oc, name).copy() for name in ONLINE_ARRAYS}


def state_diff(oc, want: dict) -> list[str]:
    """The state arrays of `oc` that are not bitwise `want`'s."""
    return [name for name in ONLINE_ARRAYS
            if not np.array_equal(getattr(oc, name), want[name])]


def rows_differ(now, was) -> np.ndarray:
    """(clusters,) bool: the rows of `now` (cut to `was`'s clusters) whose
    bytes differ from `was`'s."""
    c = was.shape[0]
    return (np.ascontiguousarray(now[:c]).view(np.uint8).reshape(c, -1)
            != np.ascontiguousarray(was).view(np.uint8).reshape(c, -1)).any(1)


def routing_hits(oc, rows) -> np.ndarray:
    """(m, clusters) bool: the online router's ball test (`OnlineClustering.
    _route_and_update`) on the cached balls (after `timed_refresh`, those
    the next insert routes on); dead clusters hit nothing."""
    from repro_torch.core.civs import _ROUTE_EPS
    dist = np.sqrt(((rows.astype(np.float64)[:, None]
                     - oc._roi_center[None]) ** 2).sum(-1))
    rad = oc._roi_radius[None]
    return (dist <= rad + _ROUTE_EPS * (1.0 + rad)) & oc.live[None]


def timed_refresh(oc, what: str) -> float:
    """Seconds of one ROI refresh of every dirty cluster (all live ones
    after construction and after a rollback: one single-lane call each)."""
    n_dirty = len(oc._roi_dirty)
    t0 = time.perf_counter()
    oc._refresh_rois()
    secs = time.perf_counter() - t0
    print(f"[online] ROI refresh of {n_dirty} clusters {what} (one "
          f"single-lane estimate_roi call each): {secs:.4f}s")
    return secs


def jittered(points, labeled, m: int, rng) -> np.ndarray:
    src = rng.choice(labeled, size=m, replace=False)
    return (points[src] + 0.01 * rng.standard_normal(
        (m, points.shape[1]))).astype(np.float32)


def far_rows(d: int, count: int, seed: int = 13) -> np.ndarray:
    """`serving_mix`'s far noise: uniform in [-60, 60] + 300 per coordinate,
    outside the data's box and so outside every ball."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-60, 60, size=(count, d)) + 300.0).astype(np.float32)


def planted_blobs(d: int, k: float, seed: int = 11) -> np.ndarray:
    """Two blobs of 80 rows around +-(300, ..., 300), far outside the data
    ([-60, 60] per coordinate) and so outside every ball, tight at the
    resident k (k times a typical pairwise distance ~0.02)."""
    rng = np.random.default_rng(seed)
    sigma = 0.02 / (k * math.sqrt(2.0 * d))
    return np.concatenate([
        s * 300.0 + sigma * rng.standard_normal((BLOB_ROWS, d))
        for s in (1.0, -1.0)]).astype(np.float32)


def check_online(dev, res, points, cfg) -> dict:
    """Phase 5b: online updates on phase 4's fit, from launch counts at 0
    (a)-(h) as the module docstring lists them. Returns the launches."""
    import tempfile

    from repro_torch.checkpoint.manager import save_checkpoint
    from repro_torch.core.online import OnlineClustering
    from repro_torch.kernels import ops
    from repro_torch.launch import run_palid
    from repro_torch.serve import ClusterServer, LiveServing
    n = points.shape[0]
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="alid_online_") as tmp:
        tmp = Path(tmp)
        # (a) epoch 0
        t0 = time.perf_counter()
        oc = OnlineClustering(res, points, cfg, ckpt_dir=str(tmp / "kernel"),
                              keep=ONLINE_KEEP, auto_flush=False, device=dev)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        problems = oc.verify()
        verify_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        probe_dir = save_checkpoint(str(tmp / "probe"), 0, oc._to_tree(),
                                    keep=1)
        save_s = time.perf_counter() - t0
        snap_bytes = sum(f.stat().st_size for f in Path(probe_dir).iterdir())
        size = sum(f.stat().st_size
                   for f in (tmp / "kernel" / "step_00000000").iterdir())
        print(f"[online] epoch 0 over {n} points, {oc.n_clusters} clusters "
              f"x cap {oc.cap}: construction {build_s:.4f}s (copy, verify, "
              f"save), verify {verify_s:.4f}s, save {save_s:.4f}s, snapshot "
              f"{size} bytes on disk (the probe save {snap_bytes})")
        need(problems == [] and oc.epochs() == [0], "online: epoch 0")
        base = online_state(oc)
        timed_refresh(oc, "after construction")

        # (b) inserts of 1, 8 and 64 jittered rows of labeled points
        labeled = np.flatnonzero(base["labels"] >= 0)
        rng = np.random.default_rng(5)
        deltas = {}
        for m in ONLINE_DELTAS:
            if oc.epoch_id != 0:
                t0 = time.perf_counter()
                oc.rollback(0)
                print(f"[online] rollback to epoch 0 (untimed for the "
                      f"insert): {time.perf_counter() - t0:.4f}s")
                need(state_diff(oc, base) == [], "online: rollback(0)")
                timed_refresh(oc, "after the rollback")
            rows = deltas[m] = jittered(points, labeled, m, rng)
            before = online_state(oc)
            stats0 = oc.stats.snapshot()
            # the balls are fresh, so the insert routes on these
            hit = routing_hits(oc, rows).any(0)
            ids = oc.insert(rows)
            secs = dict(oc.insert_seconds)
            # the balls this insert moved, refreshed by the next routing
            secs["next_refresh"] = timed_refresh(
                oc, f"that the {m}-row insert moved")
            t0 = time.perf_counter()
            problems = oc.verify()
            verify_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ep = oc.commit({"delta": m})
            commit_s = time.perf_counter() - t0
            stats = oc.stats.snapshot()
            moved = {key: stats[key] - stats0[key] for key in stats}
            changed = np.zeros(hit.shape[0], bool)
            for name in ("sup_idx", "sup_w", "sup_v", "densities", "live"):
                changed |= rows_differ(getattr(oc, name), before[name])
            strays = int((changed & ~hit).sum())
            print(f"[online] insert of {m} jittered rows: total "
                  f"{secs['total']:.4f}s = id allocation {secs['alloc']:.4f}"
                  f" + ROI refresh {secs['refresh']:.4f} + routing "
                  f"{secs['routing']:.4f} + warm LID (the loop over the hit "
                  f"clusters) {secs['reconverge']:.4f} (+ the refresh of the "
                  f"balls it moved, at the next routing: "
                  f"{secs['next_refresh']:.4f}); verify {verify_s:.4f}s, "
                  f"commit (verify + save) {commit_s:.4f}s -> epoch {ep.id}; "
                  f"balls of {int(hit.sum())} clusters hit, "
                  f"{moved['reconverges']} re-converged "
                  f"({moved['noop_reconverges']} no-op), {int(changed.sum())}"
                  f" moved; {int((~hit).sum())} clusters no row hit, of "
                  f"which {strays} moved; stats moved {moved}; "
                  f"{oc.stats.report()}")
            need(moved["routed"] == m, f"online: {m} rows routed "
                 f"{moved['routed']}")
            need(problems == [], f"online: verify after {m} rows: "
                 f"{problems[:3]}")
            need(strays == 0, f"online: {strays} clusters whose ball no row "
                 f"hit moved ({m} rows)")
            need(moved["reconverges"] <= int(hit.sum()), f"online: "
                 f"{moved['reconverges']} re-convergences for "
                 f"{int(hit.sum())} hit balls ({m} rows)")
            need(len(ids) == m, "online: insert ids")

        # (c) the kernels against the plain versions: the same 8-row insert
        # and one support-member delete, backend="ref" on the card
        oc.rollback(0)
        ref_cfg = cfg._replace(spec=cfg.spec._replace(backend="ref"))
        plain = OnlineClustering(res, points, ref_cfg,
                                 ckpt_dir=str(tmp / "ref"), keep=1,
                                 auto_flush=False, device=dev)
        dense = int(np.argmax(base["densities"]))
        victim = int(base["sup_idx"][dense][base["sup_w"][dense] > 0][1])
        moved = []
        for o in (oc, plain):
            stats0 = o.stats.snapshot()
            o.insert(deltas[8])
            o.delete([victim])
            moved.append({key: value - stats0[key]
                          for key, value in o.stats.snapshot().items()})
        diff = state_diff(oc, online_state(plain))
        same_stats = moved[0] == moved[1]
        print(f"[online] 8-row insert + delete of support member {victim} "
              f"(cluster {dense}), kernels vs backend='ref' on the card: "
              f"arrays differing: {diff or 'none'}; stats moved alike: "
              f"{same_stats} {moved[0]}")
        need(diff == [] and same_stats, f"online: kernel and plain states "
             f"differ in {diff}")
        del plain

        # (d) round trips: far noise out and back in, then rollback(0) and
        # forward again
        # (d) points outside every ball: at full width every dataset point
        # lies in ~2,040 of the 2,048 balls (k is noise-scale), so the 5
        # far noise rows are the serving mix's, inserted first
        stats0 = oc.stats.snapshot()
        far = oc.insert(far_rows(points.shape[1], 5))
        need(oc.stats.snapshot()["buffered"] - stats0["buffered"] == 5,
             "online: the far noise rows were not buffered")
        rows = oc.points[far].copy()
        before = online_state(oc)
        outliers = list(oc.outliers)
        oc.delete(far)
        t0 = time.perf_counter()
        back = oc.insert(rows)
        insert_s = time.perf_counter() - t0
        diff = state_diff(oc, before)
        print(f"[online] delete + re-insert of 5 far noise points (outside "
              f"every ball): the insert {insert_s:.4f}s; ids recycled "
              f"{np.array_equal(back, far)}, outlier buffer restored "
              f"{oc.outliers == outliers}, arrays differing: "
              f"{diff or 'none'}")
        need(np.array_equal(back, far) and diff == []
             and oc.outliers == outliers, "online: delete -> insert round "
             "trip")
        oc.delete(far)          # out of the flush's buffer in (e)
        ep = oc.commit({"round_trip": True})
        mutated = online_state(oc)
        t0 = time.perf_counter()
        oc.rollback(0)
        rollback_s = time.perf_counter() - t0
        back_diff = state_diff(oc, base)
        t0 = time.perf_counter()
        oc.rollback(ep.id)
        forward_s = time.perf_counter() - t0
        fwd_diff = state_diff(oc, mutated)
        print(f"[online] commit -> epoch {ep.id}; rollback(0) {rollback_s:.4f}"
              f"s, arrays differing from epoch 0: {back_diff or 'none'}; "
              f"rollback({ep.id}) {forward_s:.4f}s, differing: "
              f"{fwd_diff or 'none'}; retained {oc.epochs()}")
        need(back_diff == [] and fwd_diff == [], "online: rollback round "
             "trip")

        # (e) a flush of two planted blobs far from every ball
        blobs = planted_blobs(points.shape[1], oc.k)
        pre = oc.labels.copy()
        c0 = oc.densities.shape[0]
        stats0 = oc.stats.snapshot()
        ids = oc.insert(blobs)
        buffered = oc.stats.snapshot()["buffered"] - stats0["buffered"]
        pre_counts = ops.launch_counts()
        t0 = time.perf_counter()
        new = oc.flush_outliers()
        flush_s = time.perf_counter() - t0
        flush_launches = {name: count - pre_counts[name] for name, count
                          in ops.launch_counts().items()
                          if name in ONLINE_KERNELS[:4]}
        claimed = int((oc.labels[ids] >= c0).sum())
        # every id but the blobs' (which may recycle freed ids)
        others = np.setdiff1d(np.arange(pre.shape[0]), ids)
        kept = np.array_equal(oc.labels[others], pre[others])
        problems = oc.verify()
        print(f"[online] 2 planted blobs of {BLOB_ROWS} rows: buffered "
              f"{buffered}, flush_outliers (a fit at the resident k) "
              f"{flush_s:.4f}s: {new} new clusters, {claimed} rows claimed, "
              f"earlier labels unchanged: {kept}, verify: "
              f"{problems[:3] or 'ok'}; the flush's launches "
              f"{flush_launches}")
        need(buffered == 2 * BLOB_ROWS, "online: the blobs were not buffered")
        for name, count in flush_launches.items():
            need(count > 0, f"online: the flush's fit never launched {name}")
        need(new >= 1, "online: the flush formed no cluster")
        need(kept and problems == [],
             "online: the flush changed earlier labels or broke verify")

        # (f) LiveServing on a 64-slot ClusterServer
        oc.rollback(0)
        probe = points[labeled[0]]
        with ClusterServer(batch_slots=64, queue_limit=256, policy="block",
                           device=dev) as server:
            live = LiveServing(server, oc, name="online")
            t0 = time.perf_counter()
            live.publish()
            publish_s = time.perf_counter() - t0
            lab_pre = live.submit(probe).result(timeout=600)
            oc.insert(deltas[8])
            t0 = time.perf_counter()
            ep, _ = live.commit_and_publish({"delta": 8})
            cp_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            eid, _ = live.rollback_and_publish(0)
            rp_s = time.perf_counter() - t0
            lab_post = live.submit(probe).result(timeout=600)
            info = live.info()
            st = server.stats.snapshot()
        versions = [r["version"] for r in info]
        print(f"[online] LiveServing: publish of {oc.n_clusters} clusters "
              f"{publish_s:.4f}s, commit_and_publish {cp_s:.4f}s (epoch "
              f"{ep.id}), rollback_and_publish(0) {rp_s:.4f}s; probe label "
              f"{lab_pre} before, {lab_post} after; versions {versions}, "
              f"version_swaps {st['version_swaps']}, rollbacks "
              f"{st['rollbacks']}")
        need(lab_pre == lab_post, "online: the probe's label changed")
        need(eid == 0 and versions == [1, 2] and st["version_swaps"] == 2
             and st["rollbacks"] == 1, "online: LiveServing versions/stats")
        # the phase's launches: (a)-(f), before the CLI's own toy fit
        counts = ops.launch_counts()
        paths = ops.path_counts()

        # (g) the CLI
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run_palid.main(["--online", "--quick"])
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("[palid]")]
        for ln in lines:
            print(f"[online] cli: {ln}")
        need(any(ln.startswith("[palid] online") and "bit-identical=True"
                 in ln for ln in lines), "online: run_palid --online")
    # (h) the phase's launches, as read after (f)
    print(f"[online] launches of the online path, (a)-(f): "
          f"{ {name: counts[name] for name in ONLINE_KERNELS} }; by route: "
          f"{ {name: by for name, by in paths.items() if name in ONLINE_KERNELS} }")
    for name in ONLINE_KERNELS:
        need(counts[name] > 0, f"online: kernel {name} was never launched")
    return counts


# -------------------------------------------------------- full matrix ----
def full_matrix_args() -> list[str]:
    """launch/full_matrix.py's arguments for the full-matrix configuration:
    200 blobs of 80 and 24,000 noise points in d = 128 (n = 40,000)."""
    return [f"--{key.replace('_', '-')}={val}"
            for key, val in FULL_MATRIX.items()]


FULL_MATRIX = dict(n_clusters=200, cluster_size=80, n_noise=24_000, d=128,
                   seed=0)
# phase 6c's peels: the same data rule at n = 4,000
PEEL_DATA = dict(n_clusters=20, cluster_size=80, n_noise=2_400, d=128,
                 seed=0)
SLAB = 256        # rows of the full-width block checked against the plain
BIG = (65_537, 32_800, 16)   # a block of more than 2**31 entries
BIG_SYM = 46_400              # a symmetric one: 46,400^2 > 2**31


def affinity_library(v, k: float):
    """The affinity as PyTorch library calls (cuBLAS q c^T, then the norms,
    clamp, sqrt and exp in place; TF32 off): timed as a yardstick, never
    called by the port."""
    q2 = (v * v).sum(-1)
    g = torch.mm(v, v.T)
    g.mul_(-2.0).add_(q2[:, None]).add_(q2[None, :]).clamp_min_(0.0)
    return g.sqrt_().mul_(-k).exp_()


def nan_equal(a, b) -> bool:
    """Bit-equal where both are numbers, NaN at the same places."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def check_affinity(dev, out):
    """6a: the affinity kernel's two routes against its plain version,
    bitwise: symmetric (q and c one tensor, affinity_matrix's call) and
    general (everything else)."""
    from repro_torch.core.affinity import estimate_k
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.kernels import ref
    from repro_torch.kernels.affinity import affinity_cuda, plan
    spec = make_blobs_with_noise(**FULL_MATRIX)
    v = torch.as_tensor(spec.points, device=dev)
    w = v.clone()    # the same rows as another tensor: the general route
    n, d = v.shape
    k = estimate_k(v)
    a = affinity_cuda(v, v, k)
    torch.cuda.synchronize()
    err = 0.0
    for lo in (0, n - SLAB):
        want = ref.affinity_ref(v[lo:lo + SLAB], v, k)
        err = max(err, float((a[lo:lo + SLAB] - want).abs().max()))
        need(torch.equal(a[lo:lo + SLAB], want),
             f"affinity: rows [{lo}, {lo + SLAB}) of the {n} x {n} block "
             "differ from the plain version")
    sym = torch.equal(a, a.T)
    print(f"[affinity] {n}x{n}x{d} k={k:.6g} route=symmetric "
          f"plan={tuple(plan(n, n, d, True))}: rows [0, {SLAB}) and "
          f"[{n - SLAB}, {n}) bitwise_equal=True, symmetric={sym}")
    need(sym, "affinity: the full-width block is not bitwise symmetric")
    same = torch.equal(affinity_cuda(v, w, k), a)
    print(f"[affinity] {n}x{n}x{d} route=general "
          f"plan={tuple(plan(n, n, d, False))}: the whole block bitwise "
          f"equal to the symmetric route's {same}")
    need(same, "affinity: the general route's block differs")
    del a
    torch.cuda.empty_cache()
    cases = []
    for cap, dd in ((240, 128), (560, 256)):         # a LID column
        st = live_states(1, cap, dd, dev, seed=cap)
        cases.append((f"LID column ({cap}, 1, {dd})", st.v_beta[0],
                      st.v_beta[0, 7:8], k_for(dd)))
    g = torch.Generator(device="cpu").manual_seed(6)
    for m_, n_, d_ in ((1, 300, 7), (130, 257, 100)):
        cases.append((f"ragged ({m_}, {n_}, {d_})",
                      torch.randn((m_, d_), generator=g).to(dev),
                      torch.randn((n_, d_), generator=g).to(dev), 0.37))
    sq = torch.randn((3, 257, 100), generator=g).to(dev)
    cases.append(("batched (3, 257, 257, 100), q is c", sq, sq, 0.37))
    for name, q, c, kk in cases:
        same = torch.equal(affinity_cuda(q, c, kk), ref.affinity_ref(q, c, kk))
        route = plan(q.shape[-2], c.shape[-2], q.shape[-1],
                     q is c).route
        print(f"[affinity] {name} route={route}: bitwise_equal={same}")
        need(same, f"affinity: {name} differs from the plain version")
    q = torch.randn((70, 40), generator=g).to(dev)
    c = torch.randn((90, 40), generator=g).to(dev)
    q[3, 7] = float("nan")
    c[11] = float("nan")
    got, want = affinity_cuda(q, c, 0.5), ref.affinity_ref(q, c, 0.5)
    need(nan_equal(got, want) and bool(torch.isnan(got[3]).all()),
         "affinity: NaN rows come out other than in the plain version")
    c[3, 7] = float("nan")
    got, want = affinity_cuda(c, c, 0.5), ref.affinity_ref(c, c, 0.5)
    need(nan_equal(got, want) and bool(torch.isnan(got[:, 11]).all()),
         "affinity: NaN rows come out other than in the plain version "
         "(symmetric route)")
    print("[affinity] NaN-poisoned rows, route=general and route=symmetric: "
          "NaN where the plain version puts it, other entries "
          "bitwise_equal=True")
    m_, n_, d_ = BIG
    qb = torch.randn((m_, d_), generator=g).to(dev)
    cb = torch.randn((n_, d_), generator=g).to(dev)
    for name, q, c in ((f"{m_}x{n_}x{d_} route=general", qb, cb),
                       (f"{BIG_SYM}x{BIG_SYM}x{d_} route=symmetric",
                        qb[:BIG_SYM], qb[:BIG_SYM])):
        big = affinity_cuda(q, c, 0.37)
        tail = torch.equal(big[-64:], ref.affinity_ref(q[-64:], c, 0.37))
        head = torch.equal(big[:64], ref.affinity_ref(q[:64], c, 0.37))
        print(f"[affinity] {name} = {big.numel()} entries (2**31 = "
              f"{2 ** 31}): last 64 rows bitwise_equal={tail}, first 64 "
              f"rows bitwise_equal={head}")
        need(big.numel() > 2 ** 31 and tail and head,
             f"affinity: the block past 2**31 entries differs ({name})")
        del big
        torch.cuda.empty_cache()
    del qb, cb
    torch.cuda.empty_cache()
    t = dict(ms=graph_ms(lambda: affinity_cuda(v, v, k), runs=3, replays=3),
             call_ms=call_ms(lambda: affinity_cuda(v, v, k), runs=5),
             plain_ms=graph_ms(lambda: ref.affinity_ref(v, v, k), runs=1,
                               replays=1),
             plain_in_graph=True)
    general_ms = graph_ms(lambda: affinity_cuda(v, w, k), runs=3, replays=3)
    lib_ms = graph_ms(lambda: affinity_library(v, k), runs=3, replays=3)
    lib = affinity_library(v, k)
    lib_err = float((lib[:SLAB] - affinity_cuda(v[:SLAB], v, k)).abs().max())
    del lib
    torch.cuda.empty_cache()
    # each input read once and the result written once; the dots, the
    # norms, and per pair add, double, subtract, scale, sqrt and exp. The
    # symmetric call (one tensor) needs the pairs i <= j, n (n + 1) / 2;
    # the general call (two tensors) all n^2
    pairs = n * (n + 1) // 2
    b_ms, b_by = bound(4 * (n * d + n * n), 2 * pairs * d + 2 * n * d
                       + 6 * pairs)
    gb_ms, gb_by = bound(4 * (2 * n * d + n * n),
                         2 * n * n * d + 4 * n * d + 6 * n * n)
    out["affinity"] = dict(t, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, general_ms=general_ms,
                           general_bound_ms=gb_ms, general_bound_by=gb_by)
    print(f"[affinity] {n}x{n}x{d}: {time_line(t)} (route=symmetric) "
          f"bound_ms={b_ms:.4f} ({b_by}, the pairs i <= j) "
          f"general_ms={general_ms:.4f} (route=general, device time, CUDA "
          f"graph) general_bound_ms={gb_ms:.4f} ({gb_by}, all n^2 pairs) "
          f"library_ms={lib_ms:.4f} "
          f"(cuBLAS q c^T + norms, clamp, sqrt, exp; device time, CUDA "
          f"graph; a yardstick the port never calls; max_abs_err against "
          f"the kernel {lib_err:.3e})")
    need(t["ms"] < lib_ms and general_ms < lib_ms,
         "affinity: a route is not faster than the cuBLAS composition")
    return k


def check_lid_unfused(dev):
    """6b: lid_solve_unfused (affinity kernel) == lid_solve (lid_sweep)."""
    from repro_torch.core.lid import lid_solve, lid_solve_unfused
    from repro_torch.kernels import ops
    for bsz, cap, d in ((32, 240, 128), (32, 240, 256), (8, 560, 256)):
        st = live_states(bsz, cap, d, dev, seed=cap + d)
        k = k_for(d)
        ops.reset_launch_counts()
        fused = lid_solve(st, k, max_iters=200)
        t0 = time.perf_counter()
        unfused = lid_solve_unfused(st, k, max_iters=200)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        same = all(torch.equal(getattr(fused, f), getattr(unfused, f))
                   for f in ("x", "ax", "n_iters", "converged"))
        print(f"[lid] unfused vs fused B={bsz} cap={cap} d={d}: "
              f"bitwise_equal={same} iters={int(unfused.n_iters.sum())} "
              f"(max {int(unfused.n_iters.max())}) unfused_s={dt:.3f} "
              f"launches lid_sweep={counts['lid_sweep']} "
              f"affinity={counts['affinity']}")
        need(int(unfused.n_iters.max()) > 2, "lid: the states did not iterate")
        need(counts["affinity"] > 0 and counts["lid_sweep"] > 0,
             "lid: a loop did not go through its kernel")
        need(same, "lid_solve_unfused differs from lid_solve")


def check_peel_parity(dev):
    """6c: IID and DS peels on the kernel's and the plain version's matrix
    at n = 4,000."""
    from repro_torch.core.affinity import affinity_matrix, estimate_k
    from repro_torch.core.iid import iid_solve, uniform_on
    from repro_torch.core.peeling import ds_detect, iid_detect
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.utils import avg_f1_score
    spec = make_blobs_with_noise(**PEEL_DATA)
    v = torch.as_tensor(spec.points, device=dev)
    k = estimate_k(v)
    mats = {b: affinity_matrix(v, k, backend=b) for b in ("kernel", "ref")}
    sym = {b: torch.equal(a, a.T) for b, a in mats.items()}
    same = torch.equal(mats["kernel"], mats["ref"])
    print(f"[peel] n={v.shape[0]} d={v.shape[1]} k={k:.6g}: matrices "
          f"bitwise_equal={same} symmetric={sym}")
    need(same and all(sym.values()), "peel: the kernel's and the plain "
         "matrices differ or are not symmetric")
    # one IID solve from the barycenter, eager and from CUDA graphs
    x0 = uniform_on(torch.ones(v.shape[0], dtype=torch.bool, device=dev))
    loops = {}
    for graphs in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = iid_solve(mats["kernel"], x0, max_iters=3000, graphs=graphs)
        torch.cuda.synchronize()
        loops[graphs] = (r, (time.perf_counter() - t0) / int(r.n_iters))
    eq = all(torch.equal(getattr(loops[False][0], f),
                         getattr(loops[True][0], f)) for f in r._fields)
    print(f"[peel] iid_solve {int(r.n_iters)} iterations: "
          f"{loops[False][1] * 1e6:.1f} us each eager, "
          f"{loops[True][1] * 1e6:.1f} us from CUDA graphs of 64 (host "
          f"clock, capture included); bitwise_equal={eq}")
    need(eq, "iid_solve: the graph replays differ from the eager loop")
    for name, detect in (("iid", iid_detect), ("ds", ds_detect)):
        res = {}
        for b, a in mats.items():
            t0 = time.perf_counter()
            res[b] = detect(a)
            res[b + "_s"] = time.perf_counter() - t0
        g, w = res["kernel"], res["ref"]
        eq = (np.array_equal(g.labels, w.labels)
              and np.array_equal(g.densities, w.densities)
              and g.n_rounds == w.n_rounds)
        print(f"[peel] {name}_detect kernel matrix vs plain matrix: "
              f"equal={eq} rounds={g.n_rounds} clusters={len(g.densities)} "
              f"AVG-F={avg_f1_score(spec.labels, g.labels):.4f} "
              f"seconds {res['kernel_s']:.2f} / {res['ref_s']:.2f}")
        need(eq, f"peel: {name}_detect differs between the matrices")


def full_matrix_run(dev):
    """6d: the full-width IID run from launch counts at 0."""
    from repro_torch.kernels import ops
    from repro_torch.launch import full_matrix
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = full_matrix.main(["--solver", "iid", f"--device={dev}",
                            *full_matrix_args()])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = ops.path_counts()["affinity"]
    print(f"[full-matrix] n={res['n']} d={res['d']} (not cut): wall="
          f"{wall:.2f}s affinity_matrix_s={res['matrix_s']:.4f} "
          f"iid_peel_s={res['peel_s']:.2f} rounds={res['rounds']} "
          f"clusters={res['clusters']} AVG-F={res['avg_f']:.4f} (reported, "
          f"not gated) max_memory_allocated={res['peak_bytes']} "
          f"launches={counts} affinity routes={routes}")
    peel = res["result"]
    need(peel.labels.shape == (res["n"],) and res["rounds"] > 0
         and np.isfinite(peel.densities).all(), "full-matrix output")
    need(counts["affinity"] > 0 and routes["symmetric"] > 0,
         "the full-matrix path never launched the affinity kernel's "
         "symmetric route")
    return counts


def check_baselines(dev):
    """6e: every baseline on the card, on tests/test_baselines.py's easy
    data, above that file's AVG-F floor."""
    from repro_torch.core import baselines as tb
    from repro_torch.core.affinity import affinity_matrix, estimate_k
    from repro_torch.core.peeling import ds_detect, iid_detect
    from repro_torch.data import make_blobs_with_noise
    from repro_torch.utils import avg_f1_score
    spec = make_blobs_with_noise(n_clusters=4, cluster_size=25, n_noise=60,
                                 d=8, seed=7, overlap_pairs=0)
    pts = spec.points
    k = estimate_k(torch.as_tensor(pts, device=dev))
    a = affinity_matrix(torch.as_tensor(pts, device=dev), k)
    runs = [("iid_detect", 0.75, lambda: iid_detect(a).labels),
            ("ds_detect", 0.7, lambda: ds_detect(a).labels),
            ("sea_detect", 0.4, lambda: tb.sea_detect(pts, k,
                                                      device=dev).labels),
            ("affinity_propagation", 0.5,
             lambda: tb.affinity_propagation(pts, device=dev)[0]),
            ("kmeans", 0.5, lambda: tb.kmeans(pts, 5, device=dev)[0]),
            ("spectral_clustering", 0.5,
             lambda: tb.spectral_clustering(pts, 5, k, device=dev)),
            ("mean_shift", 0.5,
             lambda: tb.mean_shift(pts, bandwidth=12.0, device=dev)[0])]
    for name, floor, run in runs:
        t0 = time.perf_counter()
        score = avg_f1_score(spec.labels, run())
        print(f"[baseline] {name}: AVG-F={score:.4f} (floor {floor}) "
              f"{time.perf_counter() - t0:.2f}s")
        need(score > floor, f"{name}: AVG-F {score} <= {floor}")
    # SEA's transpose product adds in input order (ops.segment_matmul):
    # two runs give the same bits
    a, b = (tb.sea_detect(pts, k, device=dev) for _ in range(2))
    same = np.array_equal(a.labels, b.labels) and \
        np.array_equal(a.densities, b.densities)
    print(f"[baseline] sea_detect twice: labels and densities bitwise "
          f"equal {same} (densities {a.densities.tolist()})")
    need(same, "sea_detect: two runs on the card differ")


# ---------------------------------------------------------- LM serving ----
LM_ARCH = "h2o-danube-1.8b"
LONG_PROMPT = 5120       # a multiple of the plain version's q blocks
SHORT_PROMPTS = (7, 9, 11)
MAX_NEW = 16
MIX_REQUESTS, MIX_SLOTS = 6, 4           # launch.serve's defaults
# 7c: per batch, the steps whose plain top-2 gap must clear twice the
# step's kernel-plain difference, so that the argmax comparison is not
# vacuous
MIN_CLEAR_STEPS = 16


def mix_batches(vocab: int):
    """launch.serve's requests as BatchServer packs them: per batch, the
    left-padded tokens (slots, maxp) and the lengths (slots,)."""
    from repro_torch.launch.serve import mix_prompts
    from repro_torch.serve.engine import pack_prompts
    prompts = mix_prompts(vocab, MIX_REQUESTS)
    return [pack_prompts(prompts[i:i + MIX_SLOTS], MIX_SLOTS)
            for i in range(0, len(prompts), MIX_SLOTS)]


def flash_shapes():
    """7a's cases: (name, B, H, Hkv, Sq, Sk, dh, q_offsets, kv_start, mask
    keywords, dtype, q as the model's transposed view). The first two are
    the packed batch's (prefill, then a decode step at slot 5,120); the
    mix cases are launch.serve's batches at their own shapes, with the
    model's keywords: prefill and every decode step."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import _attn_kwargs
    sk = LONG_PROMPT + MAX_NEW + 1
    ks = [0] + [LONG_PROMPT - n for n in SHORT_PROMPTS]
    local = dict(window=4096)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        out += [(f"prefill {tag}", 4, 32, 8, LONG_PROMPT, sk, 80, [0], ks,
                 local, dt, False),
                (f"decode {tag}", 4, 32, 8, 1, sk, 80, [LONG_PROMPT], ks,
                 local, dt, False)]
    cfg = get_arch(LM_ARCH).CONFIG
    kw = _attn_kwargs(cfg, cfg.pattern[0])
    for i, (toks, lens) in enumerate(mix_batches(cfg.vocab)):
        maxp = toks.shape[1]
        mk = (maxp - lens).tolist()
        shape = (MIX_SLOTS, cfg.n_heads, cfg.n_kv_heads)
        out += [(f"mix batch {i} prefill", *shape, maxp, maxp + MAX_NEW + 1,
                 cfg.head_dim, [0], mk, kw, cfg.dtype, True),
                (f"mix batch {i} decode", *shape, 1, maxp + MAX_NEW + 1,
                 cfg.head_dim, list(range(maxp, maxp + MAX_NEW - 1)), mk, kw,
                 cfg.dtype, True)]
    gemma_ks = [0, 1500]
    out += [("gemma2 local dh128 softcap", 2, 32, 16, 2048, 2065, 128, [0],
             gemma_ks, dict(window=1024, softcap=50.0), torch.bfloat16,
             False),
            ("gemma2 full dh128 softcap", 2, 32, 16, 2048, 2065, 128, [0],
             gemma_ks, dict(softcap=50.0), torch.bfloat16, False),
            ("chunked", 2, 8, 2, 2048, 2065, 128, [0], [0, 300],
             dict(chunk=512), torch.bfloat16, False),
            ("ragged", 3, 12, 4, 777, 1301, 80, [524], [0, 40, 1000],
             dict(window=300), torch.float32, False)]
    return out


def flash_inputs(dev, b, h, hkv, sq, sk, dh, dtype, seed, q_view=False):
    """q, k, v; with `q_view` q is the (B, S, H, dh) projection's transposed
    view, as the model passes it."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dtype)
    q = t((b, sq, h, dh)).transpose(1, 2) if q_view else t((b, h, sq, dh))
    return q, t((b, hkv, sk, dh)), t((b, hkv, sk, dh))


def sdpa(q, k, v, mask):
    """torch's fused attention with the same boolean mask: a yardstick the
    port never calls."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask[:, None], enable_gqa=True)


def check_flash_attention(dev, out):
    """7a: the attention kernel against its plain version, by the stated
    rule, at the serving path's shapes and the other masks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda, kernel_plan, smem_plan, wgmma_plan
    timed = {}
    for seed, (name, b, h, hkv, sq, sk, dh, offs, ks, kw, dt, q_view) in \
            enumerate(flash_shapes()):
        mask_kw = {x: kw[x] for x in ("causal", "window", "chunk")
                   if kw.get(x) is not None}
        plans = sorted({kernel_plan(b, h, hkv, sq, sk, dh, off, **mask_kw,
                                    bf16=dt == torch.bfloat16)
                        for off in offs}, key=str)
        plan = "; ".join(
            (f"{p.kernel} {smem_plan(dh, h // hkv, sq)[:3]}"
             if p.kernel == "tiles" else
             f"{p.kernel} {wgmma_plan(dh, h // hkv, sq)}"
             if p.kernel == "wgmma" else f"{p.kernel} n_split={p.n_split} "
             f"from slot {p.split_lo}, {p.split_len} slots a chunk"
             if p.kernel == "split" else p.kernel) for p in plans)
        q, k, v = flash_inputs(dev, b, h, hkv, sq, sk, dh, dt, seed, q_view)
        kv_start = torch.tensor(ks, dtype=torch.int32, device=dev)
        bad = masked_nonzero = compared = 0
        err = 0.0
        for off in offs:
            got = flash_attention_cuda(q, k, v, off, kv_start=kv_start, **kw)
            want = ref.attention_ref(q, k, v, q_offset=off,
                                     kv_start=kv_start, **kw)
            torch.cuda.synchronize()
            mask = ref.attention_mask(sq, sk, off, kv_start, device=dev,
                                      **mask_kw)
            rows = mask.any(-1)
            res = compare_with_plain(got, want, rows)
            bad += res["bad"]
            masked_nonzero += res["masked_nonzero"]
            compared += int(rows.sum())
            err = max(err, res["max_abs_err"])
            again = flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                         **kw)
            need(torch.equal(got, again), f"flash_attention {name}: two "
                 "calls differ")
        at = (f"q_offset={offs[0]}" if len(offs) == 1 else
              f"q_offset {offs[0]}..{offs[-1]} ({len(offs)} steps)")
        print(f"[flash] {name}: B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} "
              f"dh={dh} {at} kv_start={ks} {kw}{' q a view' * q_view} "
              f"plan: {plan}; two calls bitwise equal; compared rows "
              f"{compared} of {b * sq * len(offs)}, outside the rule {bad}, "
              f"max_abs_err={err:.3e}, nonzero on rows attending nothing "
              f"{masked_nonzero}")
        need(bad == 0, f"flash_attention {name}: {bad} entries differ from "
             "the plain version beyond the rule")
        need(masked_nonzero == 0, f"flash_attention {name}: rows that "
             "attend nothing are not 0")
        if name in ("prefill bf16", "decode bf16"):
            off = offs[0]

            def kernel():
                return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                            **kw)

            def plain():
                return ref.attention_ref(q, k, v, q_offset=off,
                                         kv_start=kv_start, **kw)
            lib = sdpa(q, k, v, mask)
            lib_err = compare_with_plain(lib.float(), want.float(), rows)
            # each attended (q, k) pair: 2 dh for the logit, 2 dh for p v;
            # q read and out written once, and of k and v each slot that
            # some query of its row attends, once for each kv head
            pairs = int(mask.sum()) * h
            slots = int(mask.any(1).sum())
            es = q.element_size()
            b_ms, b_by = bound(es * (2 * b * h * sq * dh
                                     + 2 * hkv * slots * dh),
                               4 * dh * pairs, BF16_FLOP_PER_S)
            runs = 5 if sq > 1 else TIMED_RUNS
            if sq > 1:
                grid_cmp = prefill_grids(q, k, v, off, kv_start, kw)
                tiles = prefill_tiles(q, k, v, off, kv_start, kw, want, rows)
            t = dict(ms=graph_ms(kernel, runs=runs), call_ms=call_ms(kernel),
                     plain_ms=graph_ms(plain, runs=1 if sq > 1 else runs,
                                       replays=3),
                     plain_in_graph=True,
                     library_ms=graph_ms(lambda: sdpa(q, k, v, mask),
                                         runs=runs),
                     max_abs_err=err, bound_ms=b_ms,
                     bound_by=b_by, pairs=pairs, plan=plan)
            if sq > 1:
                t["tiles"] = tiles
            timed[name.split()[0]] = t
            print(f"[flash] {name}: {time_line(t)} bound_ms={b_ms:.4f} "
                  f"({b_by}; {pairs} attended pairs x 4 dh operations at "
                  f"the bf16 tensor-core peak, or q and out once and the "
                  f"{slots} (row, slot)s some query attends of k and v "
                  f"once per kv head) library_ms={t['library_ms']:.4f} "
                  f"(scaled_dot_product_attention, same mask, enable_gqa; "
                  f"device time, CUDA graph; a yardstick the port never "
                  f"calls; its max_abs_err on attended rows "
                  f"{lib_err['max_abs_err']:.3e})")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    pre = timed["prefill"]
    # flash_attention.cu's kernels: the SIMT tiles kernel at the prefill
    # shape (forced), the split kernel at decode; flash_wgmma.cu's kernel:
    # the plan's at the prefill shape
    out["flash_attention"] = dict(
        {key: pre[key] for key in ("plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "pairs")},
        ms=pre["tiles"]["ms"], call_ms=pre["tiles"]["call_ms"],
        max_abs_err=pre["tiles"]["max_abs_err"], decode={
            key: timed["decode"][key] for key in
            ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "max_abs_err", "plan")})
    out["flash_attention_wgmma"] = dict(
        {key: pre[key] for key in ("ms", "call_ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err",
                                   "plan")}, prefill_grid=grid_cmp)
    need(pre["ms"] < pre["library_ms"], "flash_attention prefill bf16: the "
         "wgmma kernel is not faster than SDPA with the same mask")
    print(f"[flash] prefill bf16: wgmma kernel {pre['ms']:.4f} ms, SIMT "
          f"tiles kernel {pre['tiles']['ms']:.4f} ms, SDPA "
          f"{pre['library_ms']:.4f} ms, bound {pre['bound_ms']:.4f} ms "
          f"(device time, same run)")
    print(f"[flash] decode bf16: kernel {timed['decode']['ms']:.4f} ms vs "
          f"SDPA {timed['decode']['library_ms']:.4f} ms (device time, same "
          f"run): no slower than SDPA "
          f"{timed['decode']['ms'] <= timed['decode']['library_ms']}")


def prefill_tiles(q, k, v, off, kv_start, kw, want, rows):
    """The SIMT tiles kernel forced at the prefill shape that the plan
    gives the wgmma kernel: within the rule, two calls bitwise equal, its
    device time (CUDA graph) and per-call time."""
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda

    def run():
        return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                    force_tiles=True, **kw)
    got = run()
    res = compare_with_plain(got, want, rows)
    need(res["bad"] == 0 and res["masked_nonzero"] == 0 and
         torch.equal(got, run()), f"flash_attention prefill, SIMT tiles "
         f"kernel: {res}")
    t = dict(ms=graph_ms(run, runs=5), call_ms=call_ms(run),
             max_abs_err=res["max_abs_err"])
    print(f"[flash] prefill bf16, SIMT tiles kernel (forced): within the "
          f"rule, max_abs_err={res['max_abs_err']:.3e}; kernel_ms="
          f"{t['ms']:.4f} (device time, CUDA graph) kernel_call_ms="
          f"{t['call_ms']:.4f}")
    return t


def prefill_grids(q, k, v, off, kv_start, kw):
    """The plan's kernel at the prefill shape with the batch on grid.z and
    folded into grid.x (the fold takes batches past 65,535 rows), timed in
    turns (z, x, x, z; device time, CUDA graphs); both give the same
    bits."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    def run(on_z):
        return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                    batch_on_z=on_z, **kw)
    need(torch.equal(run(True), run(False)), "flash_attention prefill: the "
         "grid.z and grid.x launches differ")
    ms = {True: [], False: []}
    for on_z in (True, False, False, True):
        ms[on_z].append(graph_ms(lambda: run(on_z), runs=5, replays=3))
    res = dict(z_ms=min(ms[True]), x_ms=min(ms[False]), z_runs=ms[True],
               x_runs=ms[False])
    print(f"[flash] prefill bf16 grids (device time, CUDA graph, in turns "
          f"z, x, x, z): batch on grid.z {ms[True]} ms, folded into grid.x "
          f"{ms[False]} ms; bitwise equal")
    return res


def packed_batch(vocab: int, seed: int = 14):
    """7b's batch: one 5,120-token prompt and three short ones."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in (LONG_PROMPT, *SHORT_PROMPTS)]


def serve_lm(dev):
    """7b: danube at full width on BatchServer, from launch counts at 0:
    launch.serve's own mix, then the packed long batch."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer as lm_m
    from repro_torch.random import PRNGKey
    from repro_torch.serve import BatchServer, ServeConfig
    cfg = get_arch(LM_ARCH).CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm_m.init_params(PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    w_bytes = lm_m.param_bytes(params)
    print(f"[lm] {cfg.name} CONFIG: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, {cfg.dtype}; {cfg.param_count()} parameters, "
          f"{w_bytes} bytes; init_params on the card "
          f"{time.perf_counter() - t0:.2f}s")
    n_norm = (2 * cfg.n_layers + 1) * cfg.d_model       # the f32 norm scales
    need(w_bytes == 2 * (cfg.param_count() - n_norm) + 4 * n_norm,
         "the weights are not the configuration's parameters in bf16")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mix = serve_cli.run(params, cfg, requests=MIX_REQUESTS, max_new=MAX_NEW,
                        slots=MIX_SLOTS, device=dev)
    need(mix["tokens"] == MIX_REQUESTS * MAX_NEW and all(
        r.shape == (MAX_NEW,) and ((r >= 0) & (r < cfg.vocab)).all()
        for r in mix["results"].values()), "launch.serve mix output")
    print(f"[lm] launch.serve mix: {MIX_REQUESTS} requests, {mix['tokens']} "
          f"tokens, {mix['tokens'] / mix['seconds']:.1f} tok/s (host clock, "
          f"kernel build excluded); batches {mix['batch_stats']}")
    prompts = packed_batch(cfg.vocab)
    srv = BatchServer(params, cfg, batch_slots=4,
                      scfg=ServeConfig(max_new_tokens=MAX_NEW), device=dev)
    ids = [srv.submit(p) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = srv.batch_stats[0]
    gen = np.stack([res[i] for i in ids])
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = (4 * (LONG_PROMPT + MAX_NEW + 1) * cfg.n_layers * 2
                   * cfg.n_kv_heads * cfg.head_dim * 2)
    print(f"[lm] packed batch (prompts {[len(p) for p in prompts]}, "
          f"{MAX_NEW} new tokens each, greedy): wall {wall:.3f}s, "
          f"{gen.size / wall:.1f} tok/s, prefill {st['prefill_s']:.4f}s, "
          f"decode {st['decode_s'] / st['decode_steps'] * 1e3:.3f} ms/step "
          f"over {st['decode_steps']} steps (host clock, each ending in a "
          f"synchronise); max_memory_allocated={peak} (weights {w_bytes}, "
          f"cache {cache_bytes}; prefill computes the last position's "
          f"logits only); launches={counts}")
    need(gen.shape == (4, MAX_NEW) and ((gen >= 0) & (gen < cfg.vocab)).all(),
         "packed batch output")
    need(counts["flash_attention"] > 0, "LM serving never launched the "
         "flash_attention kernel")
    paths = ops.path_counts()["flash_attention"]
    print(f"[lm] flash_attention launches by kernel: {paths}")
    need(paths["wgmma"] > 0, "LM serving's prefill never launched the "
         "wgmma kernel")
    counts["flash_attention_wgmma"] = paths["wgmma"]
    counts["flash_attention"] -= paths["wgmma"]
    mix_served = [mix["results"][i] for i in mix["ids"]]
    return cfg, params, prompts, gen, mix_served, counts


def teacher_forced(dev, cfg, params, name, toks, lens, gen, profiled=False):
    """7c for one batch: the generated tokens `gen` (B, MAX_NEW) fed back
    through the model after the left-padded prompts `toks` (B, P), with
    the kernel and with the plain attention; the logits of every step
    compared."""
    from repro_torch.models import transformer as lm_m
    from torch.profiler import ProfilerActivity, profile
    b, p = toks.shape
    toks = torch.as_tensor(toks, device=dev).long()
    pad = torch.as_tensor(p - lens, dtype=torch.int32, device=dev)
    g = torch.as_tensor(gen, device=dev).long()
    logits = {}
    for backend in ("kernel", "ref"):
        t0 = time.perf_counter()
        cache = lm_m.init_cache(cfg, b, p + MAX_NEW + 1, device=dev)
        step, cache = lm_m.prefill_with_cache(params, cfg, cache, toks, pad,
                                              backend=backend)
        steps = [step]
        torch.cuda.synchronize()
        # the kernel's decode steps run under the profiler (device activity
        # only): the device's busy time against the window's wall time
        with profile(activities=[ProfilerActivity.CUDA],
                     record_shapes=False) if profiled and \
                backend == "kernel" else contextlib.nullcontext() as prof:
            t1 = time.perf_counter()
            for t in range(MAX_NEW - 1):
                step, cache = lm_m.decode_step(params, cfg, cache,
                                               g[:, t:t + 1], p + t, pad,
                                               backend=backend)
                steps.append(step)
            torch.cuda.synchronize()
            window = time.perf_counter() - t1
        logits[backend] = torch.stack(steps, dim=1)       # (B, MAX_NEW, V)
        torch.cuda.synchronize()
        print(f"[lm] teacher-forced {name} {backend}: "
              f"{time.perf_counter() - t0:.2f}s")
        if prof is not None:
            kernels = [e for e in prof.key_averages()
                       if e.device_type.name == "CUDA"]
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            attn = sum(e.self_device_time_total for e in kernels
                       if any(n in e.key for n in FLASH_KERNELS)) / 1e6
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            print(f"[lm] decode window, {MAX_NEW - 1} steps through the "
                  f"kernel (profiled, device activity only): wall "
                  f"{window:.4f}s, device busy {busy:.4f}s, idle_share="
                  f"{1 - busy / window:.4f}, flash_attention {attn:.4f}s "
                  f"({attn / busy:.3f} of busy); top kernels: "
                  + "; ".join(f"{e.self_device_time_total / 1e3:.2f} ms "
                              f"x{e.count} {e.key[:60]}" for e in top[:5]))
        del cache
        torch.cuda.empty_cache()
    kern, plain = logits["kernel"], logits["ref"]
    need(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
         f"teacher-forced {name}: logits are not finite")
    # the serve loop's tokens come back from the kernel's teacher-forced
    # pass: the loop fed each step what it sampled
    same_tokens = torch.equal(kern.argmax(-1).cpu(), g.cpu())
    delta = (kern - plain).abs()
    diff = float(delta.max())
    # the stated limit: attention outputs one bf16 ulp apart, carried
    # through every layer, each adding at most one ulp at the logits'
    # scale, plus the logits' own rounding to bf16
    top_ulp = 2.0 ** (math.floor(math.log2(float(plain.abs().max()))) - 7)
    limit = (cfg.n_layers + 1) * top_ulp
    top2 = plain.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    # a step's argmax cannot flip where its plain top-2 gap exceeds twice
    # that step's largest difference, so agreement there follows from the
    # difference; the count of such steps says the differences are small
    # beside the model's own gaps, step by step
    step_diff = delta.amax(-1)
    clear = gap > 2 * step_diff
    agree = kern.argmax(-1) == plain.argmax(-1)
    print(f"[lm] teacher-forced {name} logits ({b} rows x {MAX_NEW} steps x "
          f"{cfg.vocab}): the serve loop's tokens reproduced {same_tokens}; "
          f"max |kernel - plain| {diff:.4e} = {diff / top_ulp:g} bf16 ulps "
          f"at the logits' scale (limit {limit:.4e}: {cfg.n_layers} layers "
          f"+ 1 x "
          f"{top_ulp:.4e}, the ulp at the largest |logit| "
          f"{float(plain.abs().max()):.3f}); argmax equal on "
          f"{int(agree.sum())} of {agree.numel()} steps, on "
          f"{int((agree & clear).sum())} of {int(clear.sum())} whose plain "
          f"top-2 gap exceeds twice the step's largest difference (at "
          f"least {MIN_CLEAR_STEPS} required; {int((gap > 2 * diff).sum())}"
          f" exceed twice the batch's, {2 * diff:.4e})")
    need(same_tokens, f"teacher-forced {name}: the kernel's argmax is not "
         "the served tokens")
    need(diff <= limit, f"teacher-forced {name}: kernel and plain logits "
         f"differ by {diff} > {limit}")
    need(int(clear.sum()) >= MIN_CLEAR_STEPS, f"teacher-forced {name}: only "
         f"{int(clear.sum())} steps have a clear top-2 gap")
    need(bool(agree[clear].all()), f"teacher-forced {name}: kernel and "
         "plain argmax differ where the plain top-2 gap exceeds twice the "
         "step's largest difference")
    return diff


def teacher_force_all(dev, cfg, params, prompts, gen, mix_served):
    """7c: the packed batch (its decode window profiled), then each of
    launch.serve's batches. A mix batch's empty slots are not returned by
    the server, so the batch is generated again through the kernel, whose
    real rows must equal what the server returned."""
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve.engine import pack_prompts
    toks, lens = pack_prompts(prompts, len(prompts))
    teacher_forced(dev, cfg, params, "packed batch", toks, lens, gen,
                   profiled=True)
    for i, (toks, lens) in enumerate(mix_batches(cfg.vocab)):
        full = generate(params, cfg, toks, ServeConfig(max_new_tokens=MAX_NEW),
                        prompt_lens=lens, device=dev).cpu().numpy()
        served = np.stack(mix_served[i * MIX_SLOTS:(i + 1) * MIX_SLOTS])
        need(np.array_equal(full[:len(served)], served), f"mix batch {i}: "
             "generate again differs from what the server returned")
        teacher_forced(dev, cfg, params, f"mix batch {i}", toks, lens, full)


# ------------------------------------------------------------ BST, GNN ----
BST_SHAPES = (("serve_p99", 512), ("serve_bulk", 262_144),
              ("retrieval_cand", 1_000_000))
# ogb_products (the JAX registry's GNN_SHAPES): N nodes, E edges padded to
# a multiple of 512 with -1 edges, d_feat-wide messages (a first SAGE
# layer's aggregation)
OGB_NODES, OGB_EDGES, OGB_DIM = 2_449_029, 61_859_140, 100
OGB_PADDED = OGB_EDGES + (-OGB_EDGES) % 512
# 8c: |kernel - plain| <= LOGIT_ATOL + LOGIT_RTOL |plain| for every logit
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
REF_CHUNK = 262_144      # candidates a plain retrieval pass scores


def bag_args(dev, batch: int, step: int, retrieval: bool = False):
    """embedding_bag's arguments as the model builds them from a bst_batch
    drawn on the card: its multi-hot ids (retrieval: one user's, tiled
    over the candidates, so every bag is the same user's)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import bst_batch
    from repro_torch.models import bst as bst_m
    cfg = get_arch("bst").CONFIG
    ids = bst_batch(step, batch=1 if retrieval else batch,
                    seq_len=cfg.seq_len, item_vocab=cfg.item_vocab,
                    cat_vocab=cfg.cat_vocab, device=dev)["multi_ids"]
    if retrieval:
        ids = ids.expand(batch, *ids.shape[1:])
    return bst_m.bag_inputs(cfg, ids)


def bag_bound(table, idx, n_bags):
    """ms, what bounds it: the ids and bag ids read once, each distinct
    table row named once, the bags written once; one add per element."""
    valid = idx[(idx >= 0) & (idx < table.shape[0])]
    rows = int(torch.unique(valid).numel())
    es, dim = table.element_size(), table.shape[1]
    return bound(8 * idx.numel() + es * dim * (rows + n_bags),
                 dim * valid.numel()) + (rows,)


def check_embedding_bag(dev, out):
    """8a, EmbeddingBag: the kernel bit-equal to its plain version at BST's
    three shapes (f32 and bf16), with pads and empty bags, and mean; each
    shape timed with F.embedding_bag as the yardstick."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    g = torch.Generator(device=dev).manual_seed(15)
    table32 = torch.randn((131_072, 32), generator=g, device=dev) * 0.02
    tables = {"f32": table32, "bf16": table32.to(torch.bfloat16)}
    timed = {}
    err = 0.0
    for step, (shape, batch) in enumerate(BST_SHAPES):
        idx, bags, n_bags = bag_args(dev, batch, step,
                                     shape == "retrieval_cand")
        cases = [(tag, t, idx, bags, "sum") for tag, t in tables.items()]
        if shape == "serve_bulk":   # short fields: pads anywhere, empty bags
            pidx = idx.clone()
            pidx[torch.rand(idx.shape, generator=g, device=dev) < 0.3] = -1
            pidx.view(-1, 8)[::13] = -1
            pbags = torch.where(pidx >= 0, bags, -1)
            # the same entries in a random order: the unsorted placement
            order = torch.randperm(idx.numel(), generator=g, device=dev)
            uidx, ubags = pidx[order], pbags[order]
            # ids at and past the table's end read its last row (C3)
            vidx = pidx.clone()
            vidx[::37] = table32.shape[0] + torch.arange(
                vidx[::37].numel(), device=dev, dtype=vidx.dtype) % 3
            vbags = torch.where(vidx >= 0, bags, -1)
            cases += [("f32 pads", table32, pidx, pbags, "sum"),
                      ("bf16 pads", tables["bf16"], pidx, pbags, "mean"),
                      ("f32 pads", table32, pidx, pbags, "mean"),
                      ("f32 unsorted", table32, uidx, ubags, "sum"),
                      ("bf16 unsorted", tables["bf16"], uidx, ubags, "mean"),
                      ("f32 ids >= V", table32, vidx, vbags, "sum"),
                      ("bf16 ids >= V", tables["bf16"], vidx, vbags,
                       "mean")]
        for tag, t, i, b, mode in cases:
            got = embedding_bag_cuda(t, i, b, n_bags, mode)
            want = ref.embedding_bag_ref(t, i, b, n_bags, mode)
            same = torch.equal(got, want)
            err = max(err, float((got.float() - want.float()).abs().max()))
            hit = torch.zeros(n_bags, dtype=torch.bool, device=dev)
            hit[b[(b >= 0) & (i >= 0)].long()] = True
            print(f"[bag] {shape} {tag} {mode}: {n_bags} bags of {i.numel()} "
                  f"ids ({int((b < 0).sum())} pads, "
                  f"{int((i >= t.shape[0]).sum())} ids >= V, "
                  f"{int((~hit).sum())} empty bags) table {tuple(t.shape)}: "
                  f"bitwise_equal={same}")
            need(same, f"embedding_bag {shape} {tag} {mode}: kernel differs "
                 "from its plain version")
            need(bool((got[~hit] == 0).all()),
                 f"embedding_bag {shape}: empty bags are not 0")
        counts = torch.full((idx.numel() // 8,), 8, device=dev)
        offsets = torch.cumsum(counts, 0) - counts
        lib_idx = idx.long()

        def kernel():
            return embedding_bag_cuda(table32, idx, bags, n_bags)

        def plain():
            return ref.embedding_bag_ref(table32, idx, bags, n_bags)

        def library():
            return torch.nn.functional.embedding_bag(lib_idx, table32,
                                                     offsets, mode="sum")
        lib_same = bool(torch.allclose(library(), kernel(), rtol=1e-6,
                                       atol=1e-7))
        b_ms, b_by, rows = bag_bound(table32, idx, n_bags)
        t = dict(ms=graph_ms(kernel), call_ms=call_ms(kernel),
                 plain_ms=call_ms(plain, runs=5), plain_in_graph=False,
                 library_ms=graph_ms(library), max_abs_err=err,
                 bound_ms=b_ms, bound_by=b_by)
        timed[shape] = t
        print(f"[bag] {shape} f32: {time_line(t)} bound_ms={b_ms:.5f} "
              f"({b_by}; {rows} distinct rows) library_ms="
              f"{t['library_ms']:.4f} (F.embedding_bag with offsets, sum; "
              f"device time, CUDA graph; a yardstick the port never calls; "
              f"within 1e-6 of the kernel: {lib_same}); the op is a memset "
              f"and 2 kernels; no slower than the library "
              f"{t['ms'] <= t['library_ms']}")
        if shape == "serve_bulk":
            t["unsorted_ms"] = graph_ms(lambda: embedding_bag_cuda(
                table32, uidx, ubags, n_bags), runs=3, replays=3)
            print(f"[bag] {shape} f32 unsorted (the same entries in a "
                  f"random order, one-block placement): kernel_ms="
                  f"{t['unsorted_ms']:.4f} (device time, CUDA graph)")
            del uidx, ubags, pidx, pbags, vidx, vbags
        del idx, bags, cases
        torch.cuda.empty_cache()
    out["embedding_bag"] = dict(timed["serve_bulk"], shapes={
        k: {key: v[key] for key in ("ms", "call_ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")}
        for k, v in timed.items()})


def ogb_segments(dev, leading: bool = False):
    """ogb_products' destination ids: N nodes with Pareto(2) in-degrees
    (a heavy tail; capped at 20,000) summing to E, every 1,000th block of
    128 nodes with no edge, ascending (edges sorted by destination), and
    the registry's 188 pad edges (-1) after them, or before them with
    `leading`."""
    g = torch.Generator(device=dev).manual_seed(8)
    u = torch.rand(OGB_NODES, generator=g, device=dev, dtype=torch.float64)
    w = (1.0 - u) ** -0.5
    w[(torch.arange(OGB_NODES, device=dev) // 128) % 1000 == 7] = 0.0
    deg = (w / w.sum() * OGB_EDGES).floor().clamp(max=20_000).long()
    short = OGB_EDGES - int(deg.sum())
    live = torch.nonzero(w > 0).flatten()
    deg[live] += short // live.numel()
    extra = live[torch.randperm(live.numel(), generator=g,
                                device=dev)[:short % live.numel()]]
    deg[extra] += 1
    seg = torch.repeat_interleave(
        torch.arange(OGB_NODES, dtype=torch.int32, device=dev), deg)
    pads = torch.full((OGB_PADDED - OGB_EDGES,), -1, dtype=torch.int32,
                      device=dev)
    return torch.cat([pads, seg] if leading else [seg, pads]), deg


def check_segment_matmul(dev, out):
    """8a, segment sums: the kernel bit-equal to its plain version at
    ogb_products' shape (f32 and bf16, trailing pads as the registry pads;
    leading pads; unvisited row blocks exactly 0), timed with index_add_
    as the yardstick."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_matmul import segment_matmul_cuda
    seg, deg = ogb_segments(dev)
    err = 0.0
    print(f"[segment] ogb_products: N={OGB_NODES} E={OGB_EDGES} padded to "
          f"{OGB_PADDED} ({OGB_PADDED - OGB_EDGES} pad edges), d={OGB_DIM}; "
          f"in-degree max {int(deg.max())}, mean {OGB_EDGES / OGB_NODES:.2f}, "
          f"{int((deg == 0).sum())} nodes with none")
    g = torch.Generator(device=dev).manual_seed(9)
    msg = torch.randn((OGB_PADDED, OGB_DIM), generator=g, device=dev)
    empty = deg == 0
    for tag, s in (("trailing pads", seg), ("leading pads",
                                            ogb_segments(dev, True)[0])):
        got = segment_matmul_cuda(msg, s, OGB_NODES)
        want = ref.segment_matmul_ref(msg, s, OGB_NODES)
        same = torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
        print(f"[segment] f32 {tag}: bitwise_equal={same}, unvisited rows "
              f"exactly 0: {bool((got[empty] == 0).all())}")
        need(same, f"segment_matmul f32 {tag}: kernel differs from its "
             "plain version")
        need(bool((got[empty] == 0).all()), "segment_matmul: unvisited rows "
             "are not 0")
        del got, want
    n_valid = OGB_EDGES

    def kernel():
        return segment_matmul_cuda(msg, seg, OGB_NODES)

    def plain():
        return ref.segment_matmul_ref(msg, seg, OGB_NODES)

    def library():
        return torch.zeros((OGB_NODES, OGB_DIM), device=dev).index_add_(
            0, seg[:n_valid], msg[:n_valid])
    lib_err = float((library() - kernel()).abs().max())
    b_ms, b_by = bound(4 * OGB_PADDED * (OGB_DIM + 1)
                       + 4 * OGB_NODES * OGB_DIM, OGB_EDGES * OGB_DIM)
    t = dict(ms=graph_ms(kernel, runs=5), call_ms=call_ms(kernel, runs=5),
             plain_ms=call_ms(plain, runs=1), plain_in_graph=False,
             library_ms=graph_ms(library, runs=5), max_abs_err=err,
             bound_ms=b_ms, bound_by=b_by)
    print(f"[segment] f32: {time_line(t)} bound_ms={b_ms:.4f} ({b_by}: "
          f"messages and ids read once, rows written once) library_ms="
          f"{t['library_ms']:.4f} (index_add_, atomics; device time, CUDA "
          f"graph; a yardstick the port never calls; max |library - "
          f"kernel| {lib_err:.3e})")
    ops.reset_launch_counts()          # the op's own path, "auto"
    main = ops.segment_matmul(msg, seg, OGB_NODES)
    t["launches"] = ops.launch_counts()["segment_matmul"]
    need(torch.equal(main, kernel()) and t["launches"] > 0,
         "ops.segment_matmul did not go through its kernel")
    del main
    msg16 = msg.to(torch.bfloat16)
    del msg
    torch.cuda.empty_cache()
    got = segment_matmul_cuda(msg16, seg, OGB_NODES)
    want = ref.segment_matmul_ref(msg16, seg, OGB_NODES)
    same = torch.equal(got, want)
    t["max_abs_err"] = max(err, float((got.float() - want.float()).abs()
                                      .max()))
    t["bf16_ms"] = graph_ms(lambda: segment_matmul_cuda(msg16, seg,
                                                        OGB_NODES), runs=5)
    print(f"[segment] bf16 trailing pads: bitwise_equal={same}; kernel_ms="
          f"{t['bf16_ms']:.4f} (device time, CUDA graph)")
    need(same, "segment_matmul bf16: kernel differs from its plain version")
    out["segment_matmul"] = t
    del msg16, got, want, seg
    torch.cuda.empty_cache()


def check_bst_attention(dev, out):
    """8b: the attention kernel at BST's shape (H = Hkv = 8, Sq = Sk = 21,
    dh = 4, f32, not causal; kernel_plan's "small" kernel, q, k and v the
    model's transposed views) for B = 512, 262,144 and 1,000,000 against
    its plain version on slabs of rows (the op is independent across the
    batch): the first and last 65,536 rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda, kernel_plan
    timed = {}
    for seed, (shape, b) in enumerate(BST_SHAPES):
        q, k, v = bst_qkv(dev, b, 100 + seed)
        plan = kernel_plan(b, 8, 8, 21, 21, 4, causal=False).kernel
        got = flash_attention_cuda(q, k, v, 0, causal=False)
        slabs = [(0, min(b, 65_536))] + ([(b - 65_536, b)] if b > 65_536
                                         else [])
        bad, err = 0, 0.0
        for lo, hi in slabs:
            want = ref.attention_ref(q[lo:hi], k[lo:hi], v[lo:hi],
                                     causal=False)
            res = compare_with_plain(got[lo:hi], want, torch.ones(
                (hi - lo, 21), dtype=torch.bool, device=dev))
            bad += res["bad"]
            err = max(err, res["max_abs_err"])
        print(f"[flash] BST {shape}: B={b} H=Hkv=8 Sq=Sk=21 dh=4 f32 not "
              f"causal, q, k, v the model's views, plan {plan}: rows "
              f"{slabs} compared, outside the rule {bad}, max_abs_err="
              f"{err:.3e}")
        need(bad == 0, f"flash_attention BST {shape}: outside the rule")
        pairs = b * 8 * 21 * 21
        b_ms, b_by = bound(4 * 4 * b * 8 * 21 * 4, 4 * 4 * pairs)
        if shape == "serve_bulk":
            def kernel():
                return flash_attention_cuda(q, k, v, 0, causal=False)

            def plain():
                return ref.attention_ref(q, k, v, causal=False)
            t = dict(ms=graph_ms(kernel, runs=5), call_ms=call_ms(kernel),
                     plain_ms=graph_ms(plain, runs=3, replays=3),
                     plain_in_graph=True, library_ms=graph_ms(
                         lambda: torch.nn.functional.
                         scaled_dot_product_attention(q, k, v), runs=5),
                     max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                     plan=plan)
            timed = t
            print(f"[flash] BST {shape}: {time_line(t)} bound_ms={b_ms:.4f} "
                  f"({b_by}; {pairs} pairs x 4 dh f32 operations at 67 "
                  f"TFLOP/s, or q, k, v, out once) library_ms="
                  f"{t['library_ms']:.4f} (scaled_dot_product_attention; "
                  "device time, CUDA graph; a yardstick the port never "
                  f"calls); no slower than the plain version "
                  f"{t['ms'] <= t['plain_ms']}")
        del q, k, v, got
        torch.cuda.empty_cache()
    out["flash_attention"]["bst"] = {
        key: timed[key] for key in ("ms", "call_ms", "plain_ms", "library_ms",
                                    "bound_ms", "bound_by", "max_abs_err",
                                    "plan")}


def bst_qkv(dev, b: int, seed: int):
    """q, k and v of BST's attention as the model makes them: (B, 8, 21,
    4) views of three (B, 21, 32) projections (numpy-seeded, f32)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (b, 21, 32), dtype=np.float32)).to(dev).view(b, 21, 8, 4)
        .transpose(1, 2) for _ in range(3))


def bst_batches(dev):
    """8c's batches, drawn on the card: serve_p99 and serve_bulk as
    bst_batch gives them, and retrieval_cand as one user's context (row 0
    of a 1,000,000-row batch) against that batch's targets."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import bst_batch
    cfg = get_arch("bst").CONFIG
    out = []
    for step, (shape, b) in enumerate(BST_SHAPES):
        batch = bst_batch(step, batch=b, seq_len=cfg.seq_len,
                          item_vocab=cfg.item_vocab, cat_vocab=cfg.cat_vocab,
                          device=dev)
        if shape == "retrieval_cand":
            user = ("seq_items", "seq_cats", "dense_feats", "multi_ids")
            batch = dict({k: batch[k][:1] for k in user},
                         cand_items=batch["target_item"],
                         cand_cats=batch["target_cat"])
        else:
            batch.pop("labels")
        out.append((shape, b, batch))
    return out


def plain_logits(step, params, shape, batch):
    """The same batch through backend="ref"; retrieval in chunks of
    candidates (one user's context each time)."""
    if shape != "retrieval_cand":
        return step(params, batch)
    parts = []
    for lo in range(0, batch["cand_items"].shape[0], REF_CHUNK):
        part = dict(batch, cand_items=batch["cand_items"][lo:lo + REF_CHUNK],
                    cand_cats=batch["cand_cats"][lo:lo + REF_CHUNK])
        parts.append(step(params, part))
    return torch.cat(parts)


def profile_bst_step(step, params, batch, shape):
    """One more step under torch.profiler (device activity only): the
    device's busy time against the step's wall time, and where it goes."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6

    def share(*names):
        return sum(e.self_device_time_total for e in kernels
                   if any(n in e.key for n in names)) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    print(f"[bst] {shape} step profiled (device activity only): wall "
          f"{wall:.4f}s, device busy {busy:.4f}s, idle_share="
          f"{1 - busy / wall:.4f}; flash_attention "
          f"{share(*FLASH_KERNELS):.4f}s, embedding_bag "
          f"{share(*BAG_KERNELS):.4f}s, sorts "
          f"{share('Sort', 'sort'):.4f}s; top: " + "; ".join(
              f"{e.self_device_time_total / 1e3:.3f} ms x{e.count} "
              f"{e.key[:50]}" for e in top[:6]))


def serve_bst(dev):
    """8c: BST's CONFIG at full width on the card, from launch counts at 0:
    make_bst_serve_step at 512 and 262,144, make_bst_retrieval_step at
    1,000,000 candidates; then each batch's logits through backend="ref"
    against the kernel path's."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import bst as bst_m
    from repro_torch.random import PRNGKey
    from repro_torch.train.steps import make_bst_retrieval_step, \
        make_bst_serve_step
    cfg = get_arch("bst").CONFIG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bst_m.init_params(PRNGKey(0), cfg, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[bst] {cfg.name} CONFIG: embed_dim {cfg.embed_dim}, seq_len "
          f"{cfg.seq_len}, {cfg.n_blocks} block x {cfg.n_heads} heads, MLP "
          f"{cfg.mlp}, tables {cfg.item_vocab} / {cfg.cat_vocab} / "
          f"{cfg.multi_vocab}; {n_par} parameters, {w_bytes} bytes; "
          f"init_params on the card {time.perf_counter() - t0:.2f}s")
    need(n_par == cfg.param_count() and w_bytes == 4 * n_par,
         "the weights are not the configuration's parameters in f32")
    batches = bst_batches(dev)
    steps = {"kernel": (make_bst_serve_step(cfg),
                        make_bst_retrieval_step(cfg)),
             "ref": (make_bst_serve_step(cfg, backend="ref"),
                     make_bst_retrieval_step(cfg, backend="ref"))}
    ops.reset_launch_counts()
    logits = {}
    for shape, b, batch in batches:
        step = steps["kernel"][shape == "retrieval_cand"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            y = step(params, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        logits[shape] = y
        unit = "candidates" if shape == "retrieval_cand" else "rows"
        print(f"[bst] {shape}: {b} {unit}, "
              f"step seconds {', '.join(f'{s:.4f}' for s in secs)} (host "
              f"clock, each ending in a synchronise; the first includes "
              f"warm-up), {b / statistics.median(secs):.0f} scored/s; "
              f"max_memory_allocated={peak}")
        need(y.shape == (b,) and bool(torch.isfinite(y).all()),
             f"BST {shape}: logits not finite or of the wrong shape")
        profile_bst_step(step, params, batch, shape)
    counts = ops.launch_counts()
    print(f"[bst] launches of the BST serving path: {counts}")
    need(counts["embedding_bag"] > 0 and counts["flash_attention"] > 0,
         "BST serving never launched embedding_bag or flash_attention")
    for shape, b, batch in batches:
        step = steps["ref"][shape == "retrieval_cand"]
        want = plain_logits(step, params, shape, batch)
        got = logits.pop(shape)
        diff = (got - want).abs()
        worst = float((diff - LOGIT_RTOL * want.abs()).max())
        print(f"[bst] {shape} logits, kernel path vs backend='ref': max "
              f"|diff| {float(diff.max()):.3e} on logits up to "
              f"{float(want.abs().max()):.3f}; rule |diff| <= {LOGIT_ATOL} "
              f"+ {LOGIT_RTOL} |ref| holds: {worst <= LOGIT_ATOL}")
        need(worst <= LOGIT_ATOL, f"BST {shape}: kernel-path logits differ "
             "from backend='ref' beyond the rule")
        del got, want
    del params, batches
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- GNNs ----
# phase 9: (a) GIN and GraphSAGE at ogb_products, full batch, on one graph;
# (b) MeshGraphNet and GraphCast at full_graph_sm (at ogb_products their
# edge state does not fit one card: PERF.md section 4); (c) all four at
# molecule, pooled per graph
GNN_OGB_ARCHS = ("gin-tu", "graphsage-reddit")
GNN_SM_ARCHS = ("meshgraphnet", "graphcast")
GNN_ARCHS = GNN_OGB_ARCHS + GNN_SM_ARCHS
GNN_SEED = 0
# the kernels of a GNN layer by name in a profile: the gather h[src], the
# segment op's layout (a stable radix sort of the keys, then searchsorted)
# and the segment kernel; the rest is the MLPs' products and elementwise ops
GATHER_KERNELS = ("index", "gather")
SORT_KERNELS = ("radix", "sort", "searchsorted")
SEGMENT_KERNELS = ("segment_matmul_kernel",)


def gnn_graph(dev, shape: str, cfg):
    """The registry's batch for `shape` on the card, from the port's data
    functions (seed GNN_SEED), as a GraphBatch and its batch dict."""
    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.data.graphs import molecule_batch, \
        synth_full_graph_batch
    from repro_torch.models.gnn import GraphBatch
    spec = GNN_SHAPES[shape]
    if shape == "molecule":
        batch = molecule_batch(spec["batch"], spec["n_nodes"],
                               spec["n_edges"], spec["d_feat"], cfg.n_out,
                               GNN_SEED, 0, device=dev)
        n_graphs = spec["batch"]
    else:
        mse = cfg.kind in ("mgn", "graphcast")
        batch = synth_full_graph_batch(
            spec["n_nodes"], spec["n_edges"], spec["d_feat"],
            "node_mse" if mse else "node_ce", cfg.n_out, GNN_SEED,
            with_edge_feat=mse, device=dev)
        n_graphs = 1
    return GraphBatch(batch["node_feat"], batch["edge_src"],
                      batch["edge_dst"], batch.get("edge_feat"),
                      batch.get("graph_ids"), n_graphs), batch


def check_specs(cell, batch, what: str) -> None:
    """The batch holds what the cell's input specs declare, at their
    shapes and dtypes."""
    for k, (shape, dtype) in cell.input_specs().items():
        if k not in batch:
            continue      # edge features of a molecule: the model's zeros
        need(tuple(batch[k].shape) == shape and batch[k].dtype == dtype,
             f"{what}: {k} is {tuple(batch[k].shape)} {batch[k].dtype}, "
             f"the cell declares {shape} {dtype}")


def timed_forward(params, cfg, g, backend: str):
    """One forward from launch counts at 0: (output, host seconds ending
    in a synchronise, peak device bytes above the start, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models import gnn as gnn_m
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = gnn_m.forward(params, cfg, g, backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, torch.cuda.max_memory_allocated() - base,
            ops.launch_counts()["segment_matmul"])


def device_kernels(fn):
    """fn() under torch.profiler (device activity only): (wall seconds,
    [(kernel name, device seconds)])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [(e.key, e.self_device_time_total / 1e6)
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]


def split_layer(kernels) -> dict:
    """A layer's device seconds by part: gather, sort (the layout), the
    segment kernel, the rest (MLPs, elementwise)."""
    parts = dict(gather=0.0, sort=0.0, kernel=0.0, rest=0.0)
    for name, secs in kernels:
        low = name.lower()
        if any(k in low for k in SEGMENT_KERNELS):
            parts["kernel"] += secs
        elif any(k in low for k in SORT_KERNELS):
            parts["sort"] += secs
        elif any(k in low for k in GATHER_KERNELS):
            parts["gather"] += secs
        else:
            parts["rest"] += secs
    return parts


def gnn_case(dev, arch: str, shape: str, g, batch, profiled: bool,
             keep=None) -> dict:
    """One (arch, shape) forward on the card through the kernels and
    through backend="ref", each from launch counts at 0: bit-equal
    outputs of the expected shape, finite, segment_matmul launched;
    `gnn_loss` of the cell's kind; with `profiled`, the forward's idle
    share and layer 0's time by part. Returns the case's numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as gnn_m
    from repro_torch.models import layers as L
    from repro_torch.random import PRNGKey
    from repro_torch.train.steps import gnn_loss
    cell = get_arch(arch).make_cell(shape)
    cfg = cell.model_cfg
    check_specs(cell, batch, f"9 {arch} {shape}")
    params = gnn_m.init_params(PRNGKey(0), cfg, device=dev)
    n_par = sum(t.numel() for t in _leaves(params))
    out, wall, peak, launches = timed_forward(params, cfg, g, "auto")
    again = timed_forward(params, cfg, g, "auto")
    want_rows = g.n_graphs if cfg.graph_level else g.node_feat.shape[0]
    need(out.shape == (want_rows, cfg.n_out)
         and bool(torch.isfinite(out.float()).all()),
         f"9 {arch} {shape}: output {tuple(out.shape)} not finite or of "
         "the wrong shape")
    need(launches > 0, f"9 {arch} {shape}: segment_matmul never launched")
    need(torch.equal(again[0], out), f"9 {arch} {shape}: two kernel "
         "forwards differ")
    ref, ref_wall, ref_peak, ref_launches = timed_forward(params, cfg, g,
                                                          "ref")
    same = torch.equal(out, ref)
    loss, _ = gnn_loss(params, cfg, batch, cell.loss_kind)
    need(bool(torch.isfinite(loss)), f"9 {arch} {shape}: loss not finite")
    print(f"[gnn] {arch} {shape}: {cfg.n_layers} layers, d {cfg.d_hidden}, "
          f"{str(cfg.dtype).split('.')[-1]}, {cfg.aggregator}, n_out "
          f"{cfg.n_out}, {n_par} parameters; N={g.node_feat.shape[0]} "
          f"E={g.edge_src.shape[0]}; forward {wall:.4f}s then "
          f"{again[1]:.4f}s (host clock ending in a synchronise; the first "
          f"includes warm-up), peak device memory above its start {peak}; "
          f"segment_matmul launches {launches}; backend='ref' forward "
          f"{ref_wall:.4f}s, peak {ref_peak}, launches {ref_launches}; "
          f"bitwise_equal={same}; {cell.loss_kind} {float(loss):.6f}")
    need(same, f"9 {arch} {shape}: kernel forward differs from "
         "backend='ref'")
    need(ref_launches == 0, f"9 {arch} {shape}: backend='ref' launched")
    res = dict(launches=launches, ms=again[1] * 1e3, first_ms=wall * 1e3,
               plain_ms=ref_wall * 1e3, peak=peak)
    if keep is not None:           # phase 10d's reference, on the host
        keep[arch] = out.float().cpu().numpy()
    del out, again, ref
    if profiled:
        fwall, kernels = device_kernels(
            lambda: gnn_m.forward(params, cfg, g))
        busy = sum(t for _, t in kernels)
        edges = gnn_m.edges_of(g)
        h0 = L.mlp_apply(params["encoder"], g.node_feat.to(cfg.dtype))
        lwall, lkernels = device_kernels(
            lambda: gnn_m.apply_layer(params["layers"][0], cfg, h0, None,
                                      edges))
        parts = split_layer(lkernels)
        top = sorted(lkernels, key=lambda k: -k[1])[:8]
        # the aggregation's segment kernel (messages h[src], d wide): each
        # message and key read once, each node's row written once
        n_rows, n_edges = g.node_feat.shape[0], g.edge_src.shape[0]
        d, size = h0.shape[1], h0.element_size()
        b_ms, b_by = bound(n_edges * (size * d + 4) + n_rows * size * d,
                           n_edges * d)
        fparts = split_layer(kernels)
        print(f"[gnn] {arch} {shape} forward profiled (device activity "
              f"only): wall {fwall:.4f}s, device busy {busy:.4f}s, "
              f"idle_share={1 - busy / fwall:.4f}; device ms over its "
              f"{cfg.n_layers} layers, encoder and decoder: gather h[src] "
              f"{fparts['gather'] * 1e3:.4f}, layout sort "
              f"{fparts['sort'] * 1e3:.4f}, segment kernel "
              f"{fparts['kernel'] * 1e3:.4f}, MLPs and elementwise "
              f"{fparts['rest'] * 1e3:.4f}")
        print(f"[gnn] {arch} {shape} layer 0 profiled: wall {lwall:.4f}s, "
              f"device ms: gather h[src] {parts['gather'] * 1e3:.4f}, "
              f"layout sort {parts['sort'] * 1e3:.4f}, segment kernel "
              f"{parts['kernel'] * 1e3:.4f}, MLPs and elementwise "
              f"{parts['rest'] * 1e3:.4f}; the aggregation's bound at d "
              f"{d}: {b_ms:.4f} ms ({b_by}); top: " + "; ".join(
                  f"{t * 1e3:.3f} ms {k[:60]}" for k, t in top))
        res.update(idle_share=1 - busy / fwall, bound_ms=b_ms,
                   forward_ms={k: v * 1e3 for k, v in fparts.items()},
                   layer_ms={k: v * 1e3 for k, v in parts.items()})
        del edges, h0
    del params
    torch.cuda.empty_cache()
    return res


def check_gnns(dev, keep: dict) -> dict:
    """Phase 9: the four GNNs' forwards on the card. (a) GIN-TU and
    GraphSAGE-Reddit at ogb_products on one graph, profiled; (b)
    MeshGraphNet and GraphCast at full_graph_sm; (c) all four at molecule;
    (d) examples/torch_gnn_cluster.py. Returns the phase's numbers and
    segment_matmul launches. The kernel forwards of (a) and (b) go into
    `keep` (arch -> host f32 output) for phase 10d."""
    import importlib.util

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import GNN_SHAPES, pad_to
    from repro_torch.kernels import ops
    out = {"cases": {}, "launches": 0}
    spec = GNN_SHAPES["ogb_products"]
    cfg = get_arch(GNN_OGB_ARCHS[0]).make_cell("ogb_products").model_cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, batch = gnn_graph(dev, "ogb_products", cfg)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    n, e = g.node_feat.shape[0], g.edge_src.shape[0]
    valid = g.edge_src >= 0
    deg = torch.bincount(g.edge_dst[valid].long(), minlength=n)
    n_valid = int(valid.sum())
    top = torch.sort(deg).values
    print(f"[gnn] ogb_products graph: N={n} E={e} ({e - n_valid} pad "
          f"edges), built in {build:.2f}s (host draws, sort on the card); "
          f"in-degree max {int(top[-1])}, 99.99th percentile "
          f"{int(top[int(0.9999 * (n - 1))])}, mean "
          f"{n_valid / spec['n_nodes']:.2f} over the {spec['n_nodes']} "
          f"nodes")
    need(n == pad_to(spec["n_nodes"]) and e == pad_to(spec["n_edges"])
         and n_valid == spec["n_edges"], "9a: graph sizes")
    del valid, deg, top
    for arch in GNN_OGB_ARCHS:
        res = gnn_case(dev, arch, "ogb_products", g, batch, profiled=True,
                       keep=keep)
        out["cases"][f"{arch} ogb_products"] = res
        out["launches"] += res["launches"]
    del g, batch
    torch.cuda.empty_cache()
    for arch in GNN_SM_ARCHS:
        cfg = get_arch(arch).make_cell("full_graph_sm").model_cfg
        g, batch = gnn_graph(dev, "full_graph_sm", cfg)
        res = gnn_case(dev, arch, "full_graph_sm", g, batch, profiled=False,
                       keep=keep)
        out["cases"][f"{arch} full_graph_sm"] = res
        out["launches"] += res["launches"]
    for arch in GNN_ARCHS:
        cfg = get_arch(arch).make_cell("molecule").model_cfg
        g, batch = gnn_graph(dev, "molecule", cfg)
        res = gnn_case(dev, arch, "molecule", g, batch, profiled=False)
        out["cases"][f"{arch} molecule"] = res
        out["launches"] += res["launches"]
    path = Path(__file__).resolve().parent / "examples" / \
        "torch_gnn_cluster.py"
    loader = importlib.util.spec_from_file_location("torch_gnn_cluster",
                                                    path)
    example = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(example)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, f = example.main(["--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[gnn] examples/torch_gnn_cluster.py on the card: {wall:.2f}s, "
          f"{res.n_clusters} clusters, AVG-F {f:.3f}; launches {launches}")
    need(res.n_clusters > 0, "9d: the example found no cluster")
    need(launches["segment_matmul"] > 0, "9d: the example's SAGE never "
         "launched segment_matmul")
    out["launches"] += launches["segment_matmul"]
    out["example"] = dict(clusters=res.n_clusters, avg_f=f)
    return out


# ----------------------------------------------------- the mesh engine ----
# phase 10: two gloo ranks share the one card in (b)-(d) (NCCL refuses two
# ranks on one device); (a) and (e) are NCCL at world size 1
MESH_RANKS = 2
# 10d: the CPU tests' tolerances (tests/test_torch_gnn_mesh.py): f32 within
# 2e-6 of the largest |output|, bf16 within (layers + 1) bf16 ulps
GNN_MESH_F32_TOL = 2e-6
GNN_MESH_CASES = (("gin-tu", "ogb_products"),
                  ("graphsage-reddit", "ogb_products"),
                  ("meshgraphnet", "full_graph_sm"),
                  ("graphcast", "full_graph_sm"))


def same_flags() -> None:
    """The matmul settings main() gives the card, for a rank process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def slim(res) -> dict:
    return dict(labels=res.labels, densities=res.densities,
                n_rounds=res.n_rounds, n_clusters=res.n_clusters)


class Slim:
    """A rank's fit as `bitwise_fit` reads it."""

    def __init__(self, d: dict):
        self.__dict__.update(d)


@contextlib.contextmanager
def nccl_world1(dev):
    """A world-size-1 NCCL process group in this process (the mesh engine
    at world size 1), destroyed on exit."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="alid_world1_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1, device_id=dev,
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield dist
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_w1(dev, points, lshp, rep, shd) -> dict:
    """10(a): the full-width fit on the mesh engine at world size 1 over
    NCCL in this process, on the replicated store and on 8 shards,
    bit-identical to phase 4's and 4b's fits. Returns the launches."""
    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.distributed.context import (collective_stats,
                                                 reset_collective_stats,
                                                 timed_collectives)
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    total = dict.fromkeys(FIT_KERNELS, 0)
    with nccl_world1(dev) as dist:
        for name, espec, want in (
                ("replicated", EngineSpec(engine="mesh"), rep),
                (f"{N_SHARDS} shards",
                 EngineSpec(engine="mesh", n_shards=N_SHARDS), shd)):
            cfg = full_width.config(lshp)._replace(spec=espec)
            engine = make_engine(cfg.spec, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            reset_collective_stats()
            t0 = time.perf_counter()
            with timed_collectives():
                res = fit(points, cfg, PRNGKey(0), engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            st = collective_stats()
            backend = dist.get_backend(engine.group)
            engine.close()
            del engine
            ag = st["all_gather"]
            ok, why = bitwise_fit(res, want)
            print(f"[mesh] 10a full width, world 1 ({backend}), {name}: "
                  f"wall={wall:.2f}s rounds={res.n_rounds} clusters="
                  f"{res.n_clusters}; all-gather {ag['calls']} calls, "
                  f"{ag['bytes'] / res.n_rounds:.0f} bytes and "
                  f"{ag['seconds'] / res.n_rounds * 1e3:.4f} ms a round; "
                  f"collectives {json.dumps(st)}; peak device memory "
                  f"{torch.cuda.max_memory_allocated()}; launches "
                  f"{ {k: counts[k] for k in FIT_KERNELS} }; against "
                  f"{'phase 4' if espec.n_shards == 0 else '4b'}: {why}")
            need(backend == "nccl", "10a: the group is not NCCL")
            need(ok, f"10a: the world-1 mesh fit ({name}) is not "
                 "bit-identical to the one-process fit")
            for k in FIT_KERNELS:
                need(counts[k] > 0, f"10a: kernel {k} was never launched")
                total[k] += counts[k]
            del res
            torch.cuda.empty_cache()
    return total


def _rank_gnn(rank, dev, ref_dir) -> dict:
    """10(d) on one rank: each GNN_MESH_CASES forward under a one-axis
    mesh over the ranks; rank 0 holds the gathered output to phase 9's."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.context import (collective_stats,
                                                 mesh_context,
                                                 reset_collective_stats)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import data_context
    from repro_torch.models import gnn as gnn_m
    from repro_torch.random import PRNGKey
    out = {}
    graphs: dict = {}
    with mesh_context(data_context("cuda")):
        for arch, shape in GNN_MESH_CASES:
            cfg = get_arch(arch).make_cell(shape).model_cfg
            if shape not in graphs:
                graphs.clear()
                torch.cuda.empty_cache()
                graphs[shape] = gnn_graph(dev, shape, cfg)[0]
            g = graphs[shape]
            params = gnn_m.init_params(PRNGKey(0), cfg, device=dev)
            split = gnn_m.mesh_split(g.node_feat.shape[0],
                                     g.edge_src.shape[0])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            reset_collective_stats()
            t0 = time.perf_counter()
            y = gnn_m.forward(params, cfg, g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()["segment_matmul"]
            res = dict(wall=wall, launches=launches,
                       collectives=collective_stats(),
                       peak=torch.cuda.max_memory_allocated(),
                peak_above=torch.cuda.max_memory_allocated() - base,
                split=None if split is None else split.size,
                layers=cfg.n_layers, dtype=str(cfg.dtype).split(".")[-1],
                shape=tuple(y.shape),
                finite=bool(torch.isfinite(y.float()).all()))
            if rank == 0:
                ref = torch.from_numpy(np.load(Path(ref_dir) / f"{arch}.npy"))
                yh = y.float().cpu()
                res.update(err=float((yh - ref).abs().max()),
                           scale=float(ref.abs().max()),
                           ref_shape=tuple(ref.shape))
            out[arch] = res
            del y, params
    return out


def _rank_store_build(dev, ppoints, pcfg) -> dict:
    """10(c)'s split store built alone on this rank: the device bytes it
    allocated at its peak and holds after, beside the bytes of the whole
    store (`build_store` of the same data on the card)."""
    import torch.distributed as dist

    from repro_torch.core.source import as_source
    from repro_torch.core.store import build_mesh_store, build_store
    from repro_torch.random import PRNGKey

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = build_mesh_store(as_source(ppoints), pcfg.lsh, PRNGKey(0),
                          N_SHARDS, dist.group.WORLD, device=dev)
    torch.cuda.synchronize()
    out = dict(peak=torch.cuda.max_memory_allocated() - base,
               held=torch.cuda.memory_allocated() - base)
    del st
    full = build_store(torch.as_tensor(ppoints, device=dev), pcfg.lsh,
                       PRNGKey(0), n_shards=N_SHARDS)
    out["full"] = nbytes(full.shards, full.valid, full.global_idx,
                         full.shard_of, full.slot_of, full.centers,
                         full.radii, *full.tables)
    del full
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank, world, npy, lshp, ppoints, pcfg, ref_dir) -> dict:
    """Phase 10 (b)-(d) on one of the gloo ranks sharing the card."""
    import torch.distributed as dist

    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.core.source import MemmapSource
    from repro_torch.distributed.context import (collective_stats,
                                                 reset_collective_stats,
                                                 timed_collectives)
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    same_flags()
    dev = torch.device(DEVICE)
    out = {"backend": dist.get_backend(),
           "build": _rank_store_build(dev, ppoints, pcfg)}
    used: set = set()
    for name, data, cfg in (
            ("b", MemmapSource(npy), full_width.config(lshp)._replace(
                spec=EngineSpec(engine="mesh"))),
            ("c", ppoints, pcfg._replace(spec=EngineSpec(
                engine="mesh", n_shards=N_SHARDS)))):
        engine = make_engine(cfg.spec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        reset_collective_stats()
        t0 = time.perf_counter()
        with timed_collectives():
            res = fit(data, cfg, PRNGKey(0), engine=engine)
        torch.cuda.synchronize()
        st = collective_stats()
        used |= set(st)
        out[name] = dict(slim(res), wall=time.perf_counter() - t0,
                         launches=ops.launch_counts(), collectives=st,
                         peak=torch.cuda.max_memory_allocated(),
                         backend=dist.get_backend(engine.group))
        if engine.store is not None:
            out[name].update(held=engine.store.shards.shape[0],
                             payload=engine.store.payload_bytes())
        engine.close()
        del engine, res
        torch.cuda.empty_cache()
    out["d"] = _rank_gnn(rank, dev, ref_dir)
    used |= {op for o in out["d"].values() for op in o["collectives"]}
    out["cuda_ops"] = sorted(used)
    return out


def check_mesh(dev, points, lshp, rep, shd, pspec, pcfg, shd_3b,
               gnn_ref: dict) -> dict:
    """Phase 10 (b)-(e); (a) runs before it. Returns the launches of
    (b)-(d), summed over the ranks."""
    import tempfile

    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.kernels import ops
    from repro_torch.launch import run_palid
    total = dict.fromkeys(FIT_KERNELS + ("segment_matmul",), 0)
    with tempfile.TemporaryDirectory(prefix="alid_mesh_") as tmp:
        npy = Path(tmp) / "points.npy"
        np.save(npy, points)
        for arch, y in gnn_ref.items():
            np.save(Path(tmp) / f"{arch}.npy", y)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        outs = run_ranks(mesh_rank, MESH_RANKS, str(npy), lshp,
                         pspec.points, pcfg, tmp,
                         devices=[DEVICE] * MESH_RANKS, backend="gloo",
                         timeout=600)
        spawn_wall = time.perf_counter() - t0
    for r, out in enumerate(outs):
        need(out["backend"] == "gloo", f"10: rank {r}'s group is not gloo")
        for name in ("b", "c"):
            o = out[name]
            ag = o["collectives"]["all_gather"]
            print(f"[mesh] 10{name} rank {r}/{MESH_RANKS} "
                  f"({o['backend']}, {DEVICE}): wall={o['wall']:.2f}s "
                  f"rounds={o['n_rounds']} clusters={o['n_clusters']}; "
                  f"all-gather {ag['bytes'] / o['n_rounds']:.0f} bytes and "
                  f"{ag['seconds'] / o['n_rounds'] * 1e3:.4f} ms a round; "
                  f"collectives {json.dumps(o['collectives'])}; peak device "
                  f"memory {o['peak']}; launches "
                  f"{ {k: o['launches'][k] for k in FIT_KERNELS} }"
                  + (f"; holds {o['held']} of {N_SHARDS} shards, "
                     f"{o['payload']} payload bytes with its slot"
                     if "held" in o else ""))
            for k in FIT_KERNELS:
                need(o["launches"][k] > 0, f"10{name}: rank {r} never "
                     f"launched {k}")
                total[k] += o["launches"][k]
    for name, want, what in (("b", rep, "phase 4's fit"),
                             ("c", shd_3b, "3b's sharded fit")):
        got = Slim(outs[0][name])
        for r in range(1, MESH_RANKS):
            ok, why = bitwise_fit(Slim(outs[r][name]), got)
            need(ok, f"10{name}: ranks 0 and {r} returned different fits: "
                 f"{why}")
        bit, why = bitwise_fit(got, want)
        print(f"[mesh] 10{name} against {what}: {why}")
        # a rank runs 16 of the 32 lanes; every op of the fit gives a lane
        # the same bits whatever lanes share its batch (ROADMAP C)
        need(bit, f"10{name}: the mesh fit is not bit-identical to {what}")
    c0 = outs[0]["c"]
    shard_payload = c0["payload"] // (c0["held"] + 1)
    need(all(o["c"]["held"] == N_SHARDS // MESH_RANKS for o in outs),
         "10c: a rank holds other than S/W shards")
    sent = [o["c"]["collectives"].get("broadcast", {}).get("bytes", 0)
            for o in outs]
    print(f"[mesh] 10c bytes broadcast by each rank: {sent}; each holds "
          f"{c0['held']} shards + one slot (~{shard_payload} bytes a shard)")
    for r, out in enumerate(outs):
        b = out["build"]
        print(f"[mesh] 10c rank {r}/{MESH_RANKS} split-store build alone: "
              f"peak {b['peak']} B allocated above its start, {b['held']} B "
              f"held after; the whole store is {b['full']} B")
        need(b["peak"] < b["full"], f"10c: rank {r}'s store build peaked "
             "at the whole store's bytes or more")
    for arch, _ in GNN_MESH_CASES:
        for r, out in enumerate(outs):
            o = out["d"][arch]
            coll = {op: (v["calls"], v["bytes"])
                    for op, v in o["collectives"].items()}
            line = (f"[mesh] 10d {arch} rank {r}/{MESH_RANKS}: split "
                    f"{o['split']} ways, {o['dtype']}, forward "
                    f"{o['wall']:.4f}s (warm-up included), collectives' "
                    f"(calls, bytes) {coll}; segment_matmul launches "
                    f"{o['launches']}, peak device memory {o['peak']} "
                    f"({o['peak_above']} above its start), output "
                    f"{o['shape']}")
            need(o["split"] == MESH_RANKS and o["finite"],
                 f"10d {arch}: rank {r} did not split or is not finite")
            need(o["launches"] > 0, f"10d {arch}: rank {r} never launched "
                 "segment_matmul")
            total["segment_matmul"] += o["launches"]
            if r == 0:
                if o["dtype"] == "bfloat16":
                    ulp = 2.0 ** (math.floor(math.log2(o["scale"])) - 7)
                    tol, rule = (o["layers"] + 1) * ulp, "(layers+1) ulps"
                else:
                    tol, rule = GNN_MESH_F32_TOL * o["scale"], "2e-6 rel"
                line += (f"; against phase 9's forward: max |diff| "
                         f"{o['err']:.3e} at scale {o['scale']:.4e}, "
                         f"tolerance {tol:.3e} ({rule})")
                need(o["ref_shape"] == o["shape"] and o["err"] <= tol,
                     f"10d {arch}: the mesh forward is off phase 9's")
            print(line)
    ops_used = sorted({op for o in outs for op in o["cuda_ops"]})
    print(f"[mesh] gloo ran these collectives on CUDA tensors on each rank: "
          f"{ops_used}; ops moved through the host: none; the ranks' "
          f"spawn, fits and forwards took {spawn_wall:.2f}s")

    # (e) the CLI
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_palid.main(["--quick", "--engine", "mesh", "--devices", "1"])
    line = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith("[palid] n=")]
    print(f"[mesh] 10e run_palid --quick --engine mesh --devices 1 "
          f"({time.perf_counter() - t0:.2f}s): {line}")
    need(len(line) == 1 and "engine=mesh" in line[0]
         and "devices=1" in line[0], "10e: run_palid --engine mesh "
         "--devices 1 line")
    try:
        run_palid.main(["--quick", "--devices", "2"])
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    count = torch.cuda.device_count()
    print(f"[mesh] 10e run_palid --quick --devices 2 on {count} card(s): "
          f"refused: {refused!r}")
    need(f"this host has {count}" in refused, "10e: --devices 2 not "
         "refused with the card count")
    return total


# ----------------------------------------------------------- the tooling ----
# where phase 11 writes the checker's report (gitignored)
CHECK_DIR = Path(__file__).resolve().parent / "chiprun_out"
# the kernels of the launch counts (`ops.launch_counts()`)
OPS_KERNELS = ("lsh_hash", "roi_filter", "affinity_matvec", "lid_sweep",
               "assign", "affinity", "flash_attention", "embedding_bag",
               "segment_matmul")


def check_analysis(dev) -> dict:
    """11(a): `run_palid --check` on the card (the port's checker: the
    dispatch and concurrency lints, then the runtime pass through the
    kernels), its report written under chiprun_out/. Returns the pass's
    launches."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import run_palid
    CHECK_DIR.mkdir(exist_ok=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.chdir(CHECK_DIR), contextlib.redirect_stdout(buf):
        try:
            run_palid.main(["--check"])
            code = 0
        except SystemExit as e:
            code = e.code
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[check] run_palid --check: exit {code} in {wall:.2f}s; "
          f"{buf.getvalue().strip().splitlines()[-1]}")
    report = json.loads((CHECK_DIR / run_palid.CHECK_REPORT).read_text())
    info = report["passes"]["contracts"]
    for row in info["smem_cases"]:
        print(f"[check] smem {row['op']} at {row['shape']} ({row['route']}): "
              f"{row['dynamic']} dynamic + {row['static']} static bytes")
    print(f"[check] smem_bytes_by_op {json.dumps(info['smem_bytes_by_op'])} "
          f"(budget {info['smem_budget_bytes']}); static bytes by source "
          f"{json.dumps(info['static_smem_by_source'])}")
    print(f"[check] ops shape-checked ref against kernel "
          f"{info['ops_shape_checked']}, poison runs "
          f"{info['poison_runs_by_backend']}, suppressed findings "
          f"{len(report['suppressed'])}; launches {launches}")
    need(code == 0 and report["ok"], "11a: run_palid --check failed: "
         + "; ".join(v["message"] for v in report["violations"]))
    need(info["ops_shape_checked"] == len(contracts.OP_CASES) == 10,
         "11a: not every op was shape-checked ref against kernel")
    need(info["poison_runs_by_backend"] == {"ref": 10, "kernel": 10},
         "11a: the poison scenarios did not all run on both backends")
    need(isinstance(info["static_smem_by_source"], dict) and set(
        info["static_smem_by_source"]) == set(_build.STATIC_SMEM_SOURCES),
        "11a: the static shared bytes were not read")
    need(all(b <= contracts.SMEM_BUDGET
             for b in info["smem_bytes_by_op"].values()),
         "11a: a kernel asks more shared memory than a block has")
    for name in OPS_KERNELS:
        need(launches[name] > 0, f"11a: kernel {name} was never launched")
    return launches


def check_golden(dev, fits_3b) -> dict:
    """11(b): the JAX package's golden outputs (tests/golden_torch) on the
    card: the ops through the kernels, the small fit + predict through
    them, and the fits at phase 3b's data (fit_parity) and at its shape
    on data where every LID converges (fit_converged) on the replicated,
    sharded (8 shards), streamed (default pipeline) and mesh (world size
    1, NCCL) engines. Returns the phase's launches."""
    import tempfile

    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import ops
    from repro_torch.utils import golden
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bad = {k: v for k, v in golden.check_ops(dev, "kernel").items() if v}
    print(f"[golden] ops through the kernels against the JAX package: "
          f"{'all hold' if not bad else bad} ({time.perf_counter() - t0:.2f}"
          "s)")
    need(not bad, f"11b: the kernels' ops differ from the JAX package's: "
         f"{bad}")
    problems, res = golden.check_fit("fit_small", EngineSpec(), device=dev)
    print(f"[golden] fit_small replicated through the kernels: clusters "
          f"{res.n_clusters} rounds {res.n_rounds}; fit + predict "
          f"{'hold' if not problems else problems}")
    need(not problems, f"11b: fit_small differs from the JAX package's: "
         f"{problems}")
    fits = {}
    with tempfile.TemporaryDirectory(prefix="alid_golden_") as tmp:
        for fixture in ("fit_parity", "fit_converged"):
            _, _, want = golden.fit_data(fixture)
            for name, espec in (
                    ("replicated", EngineSpec()),
                    ("sharded", EngineSpec(engine="sharded",
                                           n_shards=N_SHARDS)),
                    ("streamed", EngineSpec(engine="streamed",
                                            n_shards=N_SHARDS,
                                            scratch_dir=tmp)),
                    ("mesh", EngineSpec(engine="mesh"))):
                t1 = time.perf_counter()
                with (nccl_world1(dev) if name == "mesh"
                      else contextlib.nullcontext()):
                    engine = make_engine(espec, device=dev)
                    problems, res = golden.check_fit(
                        fixture, espec, device=dev, engine=engine)
                    torch.cuda.synchronize()
                    if name == "streamed":
                        need_clean(engine, f"11b {fixture} streamed")
                    engine.close()
                print(f"[golden] {fixture} {name}: "
                      f"{time.perf_counter() - t1:.2f}s clusters "
                      f"{res.n_clusters} rounds {res.n_rounds} k {res.k!r};"
                      f" against the JAX package (clusters "
                      f"{want['densities'].size}, rounds "
                      f"{int(want['n_rounds'])}, k {float(want['k'])!r}): "
                      f"{'holds' if not problems else problems}")
                if fixture == "fit_parity":
                    fits[name] = res
                    continue
                # every LID of the reference converges here (ROADMAP C4):
                # each engine is held to the JAX package in full
                need(not problems, f"11b: fit_converged on {name} differs "
                     f"from the JAX package's: {problems}")
    _, _, want = golden.fit_data("fit_parity")
    # the JAX package's fit at this data is not reproduced (ROADMAP C4):
    # the port's engines must agree with each other and with phase 3b,
    # and with the reference's round count
    for name, res in fits.items():
        for other, base in (("replicated", fits["replicated"]),
                            ("3b", fits_3b)):
            ok, why = same_fit(res, base)
            need(ok, f"11b: fit_parity on {name} differs from {other}: "
                 f"{why}")
        need(res.n_rounds == int(want["n_rounds"]),
             f"11b: fit_parity on {name} took {res.n_rounds} rounds, the "
             f"JAX package {int(want['n_rounds'])}")
    launches = ops.launch_counts()
    print(f"[golden] launches {launches}")
    for name in FIT_KERNELS + ("assign",):
        need(launches[name] > 0, f"11b: kernel {name} was never launched")
    return launches



# ------------------------------------------------------------ MoE serving --
MOE_ARCHS = ("llama4-scout-17b-16e", "kimi-k2-1t-a32b")
# depth cut to what one card holds: llama4 one group of its 3:1 pattern
# (chunked and NoPE layers both), kimi one layer; width never cut
MOE_LAYERS = {"llama4-scout-17b-16e": 4, "kimi-k2-1t-a32b": 1}
# the packed batch's long prompt: multiples of the plain version's q blocks
# (kernels/ref.py), llama4's past its chunk of 8,192
MOE_LONG = {"llama4-scout-17b-16e": 9216, "kimi-k2-1t-a32b": 5120}
MOE_MESH_TOKENS = (4, 1024)
# 12d: per batch, the steps whose plain top-2 gap must clear twice the
# step's kernel-plain difference among the rows compared
MOE_MIN_CLEAR_STEPS = 8


def moe_config(arch: str, n_layers: int | None = None):
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(arch).CONFIG
    n = MOE_LAYERS[arch] if n_layers is None else n_layers
    if n % len(cfg.pattern):
        cfg = dataclasses.replace(cfg, pattern=cfg.pattern[:1])
    return dataclasses.replace(cfg, n_layers=n)


def moe_flash_shapes():
    """12a's cases: (name, B, H, Hkv, Sq, Sk, dh, q_offsets, kv_start, mask
    keywords, dtype, q as the model's view): each model's packed batch
    (its long row and three left-padded short rows), the prefill and a
    decode step at the long prompt's slot, llama4's chunked layer and its
    NoPE full layer."""
    from repro_torch.models.transformer import _attn_kwargs
    out = []
    for arch in MOE_ARCHS:
        cfg = moe_config(arch)
        long = MOE_LONG[arch]
        sk = long + MAX_NEW + 1
        ks = [0] + [long - n for n in SHORT_PROMPTS]
        short = arch.split("-")[0]
        for kind in dict.fromkeys(cfg.pattern):
            kw = _attn_kwargs(cfg, kind)
            shape = (4, cfg.n_heads, cfg.n_kv_heads)
            tag = f"{short} {kind} rep {cfg.n_heads // cfg.n_kv_heads}"
            out += [(f"{tag} prefill", *shape, long, sk, cfg.head_dim, [0],
                     ks, kw, cfg.dtype, True),
                    (f"{tag} decode", *shape, 1, sk, cfg.head_dim, [long],
                     ks, kw, cfg.dtype, True)]
    return out


def device_inputs(dev, b, h, hkv, sq, sk, dh, dtype, seed):
    """q as the model's (B, S, H, dh) projection's transposed view, k, v:
    standard normal draws made on the device from `seed` (12a's 9,216-row
    slabs take seconds to draw on the host)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def t(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)
    return (t((b, sq, h, dh)).transpose(1, 2), t((b, hkv, sk, dh)),
            t((b, hkv, sk, dh)))


def sdpa_expanded(q, k, v, mask):
    """SDPA with the same boolean mask on kv repeated to every head, on
    the memory-efficient backend (no logits tensor): a yardstick the port
    never calls."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    rep = q.shape[1] // k.shape[1]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
            attn_mask=mask[:, None])


def check_moe_attention(dev, out) -> None:
    """12a: the attention kernel against its plain version at the MoE
    models' shapes (GQA rep 5 and 8 at dh 128, llama4's chunk of 8,192 and
    NoPE layer), by the stated rule, two calls bitwise equal; the bf16
    prefills on the wgmma kernel; each case timed with its bound, the
    plain version and SDPA."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain, \
        flash_attention_cuda, kernel_plan, wgmma_plan
    cases = {}
    for seed, (name, b, h, hkv, sq, sk, dh, offs, ks, kw, dt, _) in \
            enumerate(moe_flash_shapes(), start=100):
        off = offs[0]
        mask_kw = {x: kw[x] for x in ("causal", "window", "chunk")
                   if kw.get(x) is not None}
        plan = kernel_plan(b, h, hkv, sq, sk, dh, off, **mask_kw,
                           bf16=dt == torch.bfloat16)
        desc = (f"wgmma {wgmma_plan(dh, h // hkv, sq)}"
                if plan.kernel == "wgmma" else
                f"split n_split={plan.n_split} from slot {plan.split_lo}, "
                f"{plan.split_len} slots a chunk" if plan.kernel == "split"
                else plan.kernel)
        if sq > 1:
            need(plan.kernel == "wgmma", f"12a {name}: the bf16 prefill "
                 f"plans {plan.kernel}, not the wgmma kernel")
        q, k, v = device_inputs(dev, b, h, hkv, sq, sk, dh, dt, seed)
        kv_start = torch.tensor(ks, dtype=torch.int32, device=dev)

        def kernel():
            return flash_attention_cuda(q, k, v, off, kv_start=kv_start,
                                        **kw)

        def plain():
            return ref.attention_ref(q, k, v, q_offset=off,
                                     kv_start=kv_start, **kw)
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        need(torch.equal(got, again), f"12a {name}: two calls differ")
        mask = ref.attention_mask(sq, sk, off, kv_start, device=dev,
                                  **mask_kw)
        rows = mask.any(-1)
        res = compare_with_plain(got, want, rows)
        print(f"[moe-flash] {name}: B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} "
              f"dh={dh} q_offset={off} kv_start={ks} {kw} q a view; plan: "
              f"{desc}; two calls bitwise equal; compared rows "
              f"{int(rows.sum())} of {b * sq}, outside the rule "
              f"{res['bad']}, max_abs_err={res['max_abs_err']:.3e}, "
              f"nonzero on rows attending nothing {res['masked_nonzero']}")
        need(res["bad"] == 0, f"12a {name}: {res['bad']} entries differ "
             "from the plain version beyond the rule")
        need(res["masked_nonzero"] == 0, f"12a {name}: rows that attend "
             "nothing are not 0")
        pairs = int(mask.sum()) * h
        slots = int(mask.any(1).sum())
        b_ms, b_by = bound(q.element_size() * (2 * b * h * sq * dh
                                               + 2 * hkv * slots * dh),
                           4 * dh * pairs, BF16_FLOP_PER_S)
        runs = 5 if sq > 1 else TIMED_RUNS
        t = dict(ms=graph_ms(kernel, runs=runs), call_ms=call_ms(kernel),
                 plain_ms=graph_ms(plain, runs=1 if sq > 1 else runs,
                                   replays=3),
                 plain_in_graph=True, max_abs_err=res["max_abs_err"],
                 bound_ms=b_ms, bound_by=b_by, pairs=pairs, plan=desc)
        try:
            lib = sdpa_expanded(q, k, v, mask)
            lib_note = (f"its max_abs_err "
                        f"{compare_with_plain(lib, want, rows)['max_abs_err']:.3e}")
            t["library_ms"] = graph_ms(
                lambda: sdpa_expanded(q, k, v, mask), runs=runs)
            del lib
        except RuntimeError as exc:   # the yardstick only: no port path
            t["library_ms"] = None
            lib_note = f"not run: {str(exc).splitlines()[0][:120]}"
            torch.cuda.empty_cache()
        cases[name] = t
        lib_ms = ("none" if t["library_ms"] is None
                  else f"{t['library_ms']:.4f}")
        print(f"[moe-flash] {name}: {time_line(t)} bound_ms={b_ms:.4f} "
              f"({b_by}) library_ms={lib_ms} (SDPA, memory-efficient "
              f"backend, kv repeated to {h} heads, same mask; {lib_note});"
              f" {t['ms'] / b_ms:.2f}x the bound")
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
    out["flash_attention"]["moe"] = cases


def moe_param_check(cfg, params) -> int:
    """The weights are the configuration's parameters: bf16 but the f32
    norms and routers. Returns their bytes."""
    from repro_torch.models import transformer as lm_m
    w_bytes = lm_m.param_bytes(params)
    n_f32 = ((2 * cfg.n_layers + 1) * cfg.d_model
             + cfg.n_layers * cfg.d_model * cfg.moe.n_experts)
    need(w_bytes == 2 * (cfg.param_count() - n_f32) + 4 * n_f32,
         f"{cfg.name}: the weights are not the configuration's parameters")
    return w_bytes


def moe_init_timed(dev, cfg, experts=None):
    from repro_torch.models import transformer as lm_m
    from repro_torch.random import PRNGKey
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm_m.init_params(PRNGKey(0), cfg, device=dev, experts=experts)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def moe_capacity_line(log, cfg) -> str:
    return "; ".join(
        f"layer {i % cfg.n_layers}: capacity {r['capacity']}, dropped "
        f"{r['dropped']} of {r['eidx'].numel()}"
        for i, r in enumerate(log[:cfg.n_layers]))


def serve_moe(dev, arch: str):
    """12b / 12c: one MoE model at full width (depth MOE_LAYERS) on
    BatchServer, from launch counts at 0: launch.serve's own mix, then a
    batch packing the long prompt with three short ones."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import BatchServer, ServeConfig
    cfg = moe_config(arch)
    params, init_s = moe_init_timed(dev, cfg)
    w_bytes = moe_param_check(cfg, params)
    e = cfg.moe
    full = get_arch(arch).CONFIG
    print(f"[moe] {arch} CONFIG at {cfg.n_layers} of {full.n_layers} "
          f"layers ({cfg.pattern}): d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads / {cfg.n_kv_heads} kv heads x {cfg.head_dim}, {e.n_experts}"
          f" experts top-{e.top_k} ({e.router}) x d_ff {e.d_ff} + "
          f"{e.n_shared} shared, vocab {cfg.vocab}, {cfg.dtype}; "
          f"{cfg.param_count()} parameters, {w_bytes} bytes; the sliced "
          f"init on the card {init_s:.2f}s")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    mix = serve_cli.run(params, cfg, requests=MIX_REQUESTS, max_new=MAX_NEW,
                        slots=MIX_SLOTS, device=dev)
    need(mix["tokens"] == MIX_REQUESTS * MAX_NEW and all(
        r.shape == (MAX_NEW,) and ((r >= 0) & (r < cfg.vocab)).all()
        for r in mix["results"].values()), f"12 {arch}: launch.serve mix")
    print(f"[moe] {arch} launch.serve mix: {mix['tokens']} tokens, "
          f"{mix['tokens'] / mix['seconds']:.1f} tok/s (host clock); "
          f"batches {mix['batch_stats']}")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (MOE_LONG[arch], *SHORT_PROMPTS)]
    srv = BatchServer(params, cfg, batch_slots=4,
                      scfg=ServeConfig(max_new_tokens=MAX_NEW), device=dev)
    ids = [srv.submit(p) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = srv.serve()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    paths = ops.path_counts()["flash_attention"]
    st = srv.batch_stats[0]
    gen = np.stack([res[i] for i in ids])
    peak = torch.cuda.max_memory_allocated()
    step_ms = st["decode_s"] / st["decode_steps"] * 1e3
    print(f"[moe] {arch} packed batch (prompts {[len(p) for p in prompts]},"
          f" {MAX_NEW} new tokens each, greedy): wall {wall:.3f}s, "
          f"{gen.size / wall:.1f} tok/s, prefill {st['prefill_s']:.4f}s, "
          f"decode {step_ms:.3f} ms/step over {st['decode_steps']} steps "
          f"(host clock, each ending in a synchronise); "
          f"max_memory_allocated={peak} (weights {w_bytes}); launches="
          f"{counts}; flash_attention launches by kernel {paths}")
    need(gen.shape == (4, MAX_NEW) and ((gen >= 0) & (gen < cfg.vocab)).all(),
         f"12 {arch}: packed batch output")
    need(counts["flash_attention"] > 0, f"12 {arch}: serving never launched "
         "the flash_attention kernel")
    need(paths["wgmma"] > 0, f"12 {arch}: the prefill never launched the "
         "wgmma kernel")
    counts = {"flash_attention": counts["flash_attention"] - paths["wgmma"],
              "flash_attention_wgmma": paths["wgmma"]}
    summary = dict(params_bytes=w_bytes, peak=peak, init_s=init_s,
                   prefill_s=st["prefill_s"], decode_ms=step_ms,
                   tok_s=gen.size / wall, launches=counts)
    mix_served = [mix["results"][i] for i in mix["ids"]]
    return cfg, params, prompts, gen, mix_served, summary


def moe_routing_diff(params, cfg, klog, plog):
    """The routing of the kernel run against the plain run, call by call
    and layer by layer: every token whose ordered top-k or kept entries
    differ. Where a token's top-k lists first differ at position j, the
    plain run's expert a there and the kernel's b satisfy l(a) >= l(b) in
    the plain logits and the reverse in the kernel's, so the plain gap
    between its j-th and (j+1)-th logit is at most |d l_a| + |d l_b|; the
    router's product bounds each change by ||dx||_2 max_e ||W_r[:, e]||_2
    (dx the token's measured MoE-input difference), plus the f32
    product's rounding, taken as 2**-20 of the token's largest |logit|.
    Each flip must lie within twice that. Returns (flips, keep changes
    without a flip, rows rerouted per call, worst flip (gap, bound)),
    raising need() on a flip outside the rule."""
    n_pos = cfg.n_layers
    flips, keeps, worst = [], [], (0.0, 0.0)
    rerouted = []
    for j, (kr, pr) in enumerate(zip(klog, plog)):
        layer = j % n_pos
        g, i = divmod(layer, len(cfg.pattern))
        k = cfg.moe.top_k
        ke, pe = kr["eidx"], pr["eidx"]
        kx, px = kr["x"].float(), pr["x"].float()
        flip = (ke != pe).any(-1)
        kept = (kr["keep"] != pr["keep"]).view(-1, k).any(-1)
        moved = flip | kept
        rerouted.append(moved)
        if bool(flip.any()):
            w = params["blocks"][f"layer{i}"]["moe"]["router"][g].float()
            logits = px[flip] @ w
            top = logits.sort(-1, descending=True).values
            first = (ke[flip] != pe[flip]).int().argmax(-1, keepdim=True)
            gap = (top.gather(1, first) - top.gather(1, first + 1))[:, 0]
            lim = 2 * ((kx[flip] - px[flip]).norm(dim=-1)
                       * w.norm(dim=0).max()
                       + 2.0 ** -20 * logits.abs().amax(-1))
            need(bool((gap <= lim).all()), f"12d: layer {layer} call "
                 f"{j // n_pos}: {int((gap > lim).sum())} routing flips "
                 "where the plain run's gap exceeds the bound")
            flips.append((j // n_pos, layer, int(flip.sum()),
                          float(gap.max()), float(lim.max())))
            if float(gap.max()) > worst[0]:
                worst = (float(gap.max()), float(lim.max()))
        if bool((kept & ~flip).any()):
            keeps.append((j // n_pos, layer, int((kept & ~flip).sum())))
    return flips, keeps, rerouted, worst


@contextlib.contextmanager
def plain_rows_attending_nothing_zero():
    """The plain attention with the rows that attend no key written 0, as
    the kernel writes them (the plain version writes the mean of V there:
    ROADMAP C's accepted divergence). Those rows are a packed batch's pad
    slots; in a MoE layer the pads are routed and take capacity, so their
    values decide which real tokens an expert drops, and the kernel and
    plain runs are compared on equal pads."""
    from unittest import mock

    from repro_torch.kernels import ref
    plain = ref.attention_ref

    def zeroed(q, k, v, *, causal=True, window=None, chunk=None,
               q_offset=0, kv_start=None, **kw):
        out = plain(q, k, v, causal=causal, window=window, chunk=chunk,
                    q_offset=q_offset, kv_start=kv_start, **kw)
        mask = ref.attention_mask(q.shape[2], k.shape[2], q_offset, kv_start,
                                  causal=causal, window=window, chunk=chunk,
                                  device=q.device)
        rows = mask.any(-1).expand(q.shape[0], q.shape[2])
        return out * rows[:, None, :, None].to(out.dtype)
    with mock.patch.object(ref, "attention_ref", zeroed):
        yield


def teacher_forced_moe(dev, cfg, params, name, toks, lens, gen) -> dict:
    """12d for one batch: 7c's check (the served tokens fed back through
    the model with the kernel and with the plain attention, whose rows
    attending nothing are zeroed as the kernel's are:
    `plain_rows_attending_nothing_zero`) with every layer's routing
    recorded in both runs: flips must obey `moe_routing_diff`'s rule, and
    logits are compared only on rows whose every token kept its routing
    in every layer (their prompt tokens and their decode steps up to each
    step)."""
    from repro_torch.models import moe as moe_m
    from repro_torch.models import transformer as lm_m
    b, p = toks.shape
    toks = torch.as_tensor(toks, device=dev).long()
    pad = torch.as_tensor(p - lens, dtype=torch.int32, device=dev)
    g = torch.as_tensor(gen, device=dev).long()
    logits, logs = {}, {}
    for backend in ("kernel", "ref"):
        t0 = time.perf_counter()
        with moe_m.recording(keep_inputs=True) as log, (
                plain_rows_attending_nothing_zero() if backend == "ref"
                else contextlib.nullcontext()):
            cache = lm_m.init_cache(cfg, b, p + MAX_NEW + 1, device=dev)
            step, cache = lm_m.prefill_with_cache(params, cfg, cache, toks,
                                                  pad, backend=backend)
            steps = [step]
            for t in range(MAX_NEW - 1):
                step, cache = lm_m.decode_step(params, cfg, cache,
                                               g[:, t:t + 1], p + t, pad,
                                               backend=backend)
                steps.append(step)
        logits[backend] = torch.stack(steps, dim=1)
        logs[backend] = log
        torch.cuda.synchronize()
        print(f"[moe] teacher-forced {name} {backend}: "
              f"{time.perf_counter() - t0:.2f}s")
        del cache
        torch.cuda.empty_cache()
    kern, plain = logits["kernel"], logits["ref"]
    need(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
         f"12d {name}: logits are not finite")
    same_tokens = torch.equal(kern.argmax(-1).cpu(), g.cpu())
    need(same_tokens, f"12d {name}: the kernel's argmax is not the served "
         "tokens")
    flips, keeps, rerouted, worst = moe_routing_diff(
        params, cfg, logs["kernel"], logs["ref"])
    n_pos = cfg.n_layers
    # a row stays clean up to step s if none of its tokens routed
    # differently in any layer of the prefill (call 0) or of steps 1..s
    clean = torch.ones((b, MAX_NEW), dtype=torch.bool, device=dev)
    for j, moved in enumerate(rerouted):
        call = j // n_pos
        hit = moved.view(b, -1).any(-1)
        clean[hit, call:] = False
    delta = (kern - plain).abs()
    top_ulp = 2.0 ** (math.floor(math.log2(float(plain.abs().max()))) - 7)
    limit = (cfg.n_layers + 1) * top_ulp
    diff = float(delta[clean].max()) if bool(clean.any()) else 0.0
    top2 = plain.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    clear = clean & (gap > 2 * delta.amax(-1))
    agree = kern.argmax(-1) == plain.argmax(-1)
    caps = moe_capacity_line(logs["kernel"], cfg)
    print(f"[moe] teacher-forced {name} ({b} rows x {MAX_NEW} steps x "
          f"{cfg.vocab}): the served tokens reproduced {same_tokens}; "
          f"prefill routing {caps}; top-k flips (call, layer, tokens, "
          f"largest plain gap, largest bound) {flips or 'none'}, worst gap "
          f"{worst[0]:.4e} against its bound {worst[1]:.4e}; kept-set "
          f"changes without a flip (call, layer, tokens) {keeps or 'none'};"
          f" steps compared {int(clean.sum())} of {clean.numel()}; max "
          f"|kernel - plain| there {diff:.4e} = {diff / top_ulp:g} bf16 "
          f"ulps at the logits' scale (limit {limit:.4e}: {cfg.n_layers} "
          f"layers + 1); argmax equal on {int((agree & clear).sum())} of "
          f"{int(clear.sum())} clear steps")
    need(diff <= limit, f"12d {name}: kernel and plain logits differ by "
         f"{diff} > {limit} where the routing agreed")
    need(int(clear.sum()) >= MOE_MIN_CLEAR_STEPS, f"12d {name}: only "
         f"{int(clear.sum())} compared steps have a clear top-2 gap")
    need(bool(agree[clear].all()), f"12d {name}: kernel and plain argmax "
         "differ where the routing agreed and the plain top-2 gap exceeds "
         "twice the step's largest difference")
    return dict(flips=len(flips), diff=diff, compared=int(clean.sum()))


def teacher_force_moe(dev, cfg, params, prompts, gen, mix_served) -> None:
    """12d: the packed batch and launch.serve's batches (each generated
    again through the kernel, its real rows equal to what the server
    returned)."""
    from repro_torch.serve import ServeConfig, generate
    from repro_torch.serve.engine import pack_prompts
    toks, lens = pack_prompts(prompts, len(prompts))
    teacher_forced_moe(dev, cfg, params, f"{cfg.name} packed batch", toks,
                       lens, gen)
    for i, (toks, lens) in enumerate(mix_batches(cfg.vocab)):
        full = generate(params, cfg, toks, ServeConfig(max_new_tokens=MAX_NEW),
                        prompt_lens=lens, device=dev).cpu().numpy()
        served = np.stack(mix_served[i * MIX_SLOTS:(i + 1) * MIX_SLOTS])
        need(np.array_equal(full[:len(served)], served), f"12d mix batch "
             f"{i}: generate again differs from what the server returned")
        teacher_forced_moe(dev, cfg, params, f"{cfg.name} mix batch {i}",
                           toks, lens, full)


def _shard_dispatch(moe_m, shards):
    """moe_apply with every token shard of the mesh run dispatched on its
    own over all experts (no collectives): what the all-to-all computes,
    in one process."""
    def apply(params, cfg, x):
        b, s, d = x.shape
        out = torch.empty_like(x)
        aux = []
        for bsl, ssl in shards(b, s):
            xs = x[bsl, ssl]
            o, a = moe_m._dispatch_combine(params, cfg, xs.reshape(-1, d))
            out[bsl, ssl] = o.view(xs.shape)
            aux.append(a)
        out = out + moe_m._shared_ffn(params, x)
        return out, torch.stack(aux).mean()
    return apply


def moe_mesh_rank(rank, world, tokens, ref_path) -> dict:
    """12e on one of two gloo ranks sharing the card: llama4 at full width,
    one layer, this rank's 8 of the 16 experts; the prefill forward over a
    ("model",) mesh of 2, its logits against the one-process reference."""
    import torch.distributed as dist

    from repro_torch.distributed.context import (collective_stats,
                                                 mesh_context,
                                                 reset_collective_stats,
                                                 timed_collectives)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import model_context
    from repro_torch.models import transformer as lm_m
    same_flags()
    dev = torch.device(DEVICE)
    cfg = moe_config(MOE_ARCHS[0], 1)
    per = cfg.moe.n_experts // world
    params, init_s = moe_init_timed(dev, cfg, (rank * per, (rank + 1) * per))
    toks = torch.as_tensor(tokens, device=dev).long()
    ctx = model_context(dev.type)
    ops.reset_launch_counts()
    reset_collective_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mesh_context(ctx), timed_collectives():
        logits, aux = lm_m.forward(params, cfg, toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths = ops.path_counts()["flash_attention"]
    launches = ops.launch_counts()
    want = torch.load(ref_path, map_location=dev)
    # the reference's logits from its final hidden state, through this
    # rank's head (the same weights)
    ref_logits = lm_m._head(params, cfg, want["hidden"])
    return dict(backend=dist.get_backend(), init_s=init_s, wall=wall,
                experts=params["blocks"]["layer0"]["moe"]["w_gate"].shape[1],
                bitwise=torch.equal(logits, ref_logits),
                diff=float((logits - ref_logits).abs().max()),
                top=float(ref_logits.abs().max()), aux=float(aux),
                aux_ref=float(want["aux"]), collectives=collective_stats(),
                launches=launches, paths=paths,
                peak=torch.cuda.max_memory_allocated())


def check_moe_mesh(dev) -> dict:
    """12e: llama4 at full width, one layer, over two gloo ranks sharing
    the card with a model axis of 2 (8 experts a rank): a 4 x 1,024-token
    prefill forward. Every rank passes the whole batch; each takes half
    the sequence, and the all-to-all carries the dispatch buffers to the
    experts' owner and back. Held to the one-process forward whose MoE
    dispatches each of those token shards on its own (the capacity is a
    shard's, as in the JAX package's shard_map), bitwise where that holds,
    else within (layers + 1) bf16 ulps at the logits' scale (the experts'
    batched products then run at other shapes: 8 experts x 2 shards' slots
    a rank against 16 x one shard's)."""
    import tempfile
    from unittest import mock

    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_m
    from repro_torch.models import transformer as lm_m
    cfg = moe_config(MOE_ARCHS[0], 1)
    tokens = np.random.default_rng(16).integers(
        0, cfg.vocab, MOE_MESH_TOKENS).astype(np.int32)
    b, s = MOE_MESH_TOKENS

    def shards(bb, ss):
        half = ss // 2
        return [(slice(0, bb), slice(0, half)), (slice(0, bb),
                                                 slice(half, ss))]
    params, init_s = moe_init_timed(dev, cfg)
    head, hidden = lm_m._head, []

    def keep_hidden(p, c, x):
        hidden.append(x)
        return head(p, c, x)
    toks = torch.as_tensor(tokens, device=dev).long()
    with mock.patch.object(lm_m, "moe_apply", _shard_dispatch(
            moe_m, shards)), mock.patch.object(lm_m, "_head", keep_hidden):
        logits, aux = lm_m.forward(params, cfg, toks)
    whole, _ = lm_m.forward(params, cfg, toks)
    torch.cuda.synchronize()
    whole_diff = float((whole - logits).abs().max())
    del params, whole, logits
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="alid_moe_mesh_") as tmp:
        ref_path = str(Path(tmp) / "ref.pt")
        torch.save({"hidden": hidden[0], "aux": aux}, ref_path)
        del hidden
        t0 = time.perf_counter()
        outs = run_ranks(moe_mesh_rank, 2, tokens, ref_path,
                         devices=[DEVICE] * 2, backend="gloo", timeout=600)
        spawn_wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        top_ulp = 2.0 ** (math.floor(math.log2(o["top"])) - 7)
        limit = 2 * top_ulp
        a2a = o["collectives"].get("all_to_all", {})
        print(f"[moe-mesh] rank {r} ({o['backend']}): {o['experts']} "
              f"experts, init {o['init_s']:.2f}s, forward {o['wall']:.3f}s "
              f"(collectives timed, a sync around each), all_to_all "
              f"{a2a.get('calls')} calls {a2a.get('bytes')} bytes "
              f"{a2a.get('seconds', 0.0):.4f}s; collectives "
              f"{o['collectives']}; logits bitwise the one-process shard "
              f"dispatch's {o['bitwise']}, max |diff| {o['diff']:.4e} = "
              f"{o['diff'] / top_ulp:g} bf16 ulps at the logits' scale "
              f"(limit {limit:.4e}); aux {o['aux']!r} against "
              f"{o['aux_ref']!r}; launches {o['launches']} (flash by kernel "
              f"{o['paths']}); peak {o['peak']}")
        need(o["backend"] == "gloo", f"12e: rank {r}'s group is not gloo")
        need(a2a.get("calls", 0) == 2, f"12e: rank {r} made "
             f"{a2a.get('calls', 0)} all_to_all calls, not 2")
        need(o["diff"] <= limit, f"12e: rank {r}'s logits differ from the "
             f"one-process forward by {o['diff']} > {limit}")
        need(abs(o["aux"] - o["aux_ref"]) <= 1e-6 * max(1.0, o["aux_ref"]),
             f"12e: rank {r}'s aux differs")
        need(o["launches"]["flash_attention"] > 0, f"12e: rank {r} never "
             "launched flash_attention")
    print(f"[moe-mesh] two ranks spawned, run and joined in "
          f"{spawn_wall:.2f}s; the one-process reference's init "
          f"{init_s:.2f}s; the whole-batch forward (one capacity for all "
          f"{b * s} tokens) differs from the shard dispatch by "
          f"{whole_diff:.4e} (the capacity and drops differ)")
    wgmma = sum(o["paths"]["wgmma"] for o in outs)
    return {"flash_attention": sum(o["launches"]["flash_attention"]
                                   for o in outs) - wgmma,
            "flash_attention_wgmma": wgmma}


def check_moe(dev, stats) -> dict:
    """Phase 12: MoE serving. Returns the phase's flash_attention
    launches (the serving runs (b), (c) and (e)'s forwards) by table
    row."""
    check_moe_attention(dev, stats)
    stamp("phase 12a")
    counts = {"flash_attention": 0, "flash_attention_wgmma": 0}
    summary = {}
    for arch in MOE_ARCHS:
        cfg, params, prompts, gen, mix_served, s = serve_moe(dev, arch)
        for k2, v in s.pop("launches").items():
            counts[k2] += v
        summary[arch] = s
        teacher_force_moe(dev, cfg, params, prompts, gen, mix_served)
        del params, gen
        torch.cuda.empty_cache()
        stamp(f"phase 12 {arch}")
    mesh = check_moe_mesh(dev)
    stamp("phase 12e")
    print(f"[moe] phase 12e launches (both ranks) {mesh}")
    for k2, v in mesh.items():
        counts[k2] += v
    stats["flash_attention"]["moe"]["serving"] = summary
    print(f"[moe] phase 12 launches {counts}; serving {summary}")
    return counts


# ------------------------------------------------------------ training ----
# 13a: the attention backward at the training paths' shapes: (name, B, H,
# Hkv, S, dh, dtype, mask); danube's train_4k layers over a 5,120-token
# row, a gemma2 global layer, a llama4 chunked layer past one chunk,
# lm-100m (examples/torch_train_lm_100m.py) and BST's block
FLASH_BWD_CASES = (
    ("danube", 1, 32, 8, 5120, 80, torch.bfloat16,
     dict(causal=True, window=4096)),
    ("gemma2_global", 1, 32, 16, 4096, 128, torch.bfloat16,
     dict(causal=True, softcap=50.0)),
    ("llama4_chunked", 1, 40, 8, 9216, 128, torch.bfloat16,
     dict(causal=True, chunk=8192)),
    ("lm_100m", 8, 12, 4, 256, 64, torch.float32, dict(causal=True)),
    ("bst", 65_536, 8, 8, 21, 4, torch.float32, dict(causal=False)),
)
# 13b: h2o-danube-1.8b's CONFIG at full width and depth, its train_4k
# sequence; the cell's global batch of 256 (a pod's) cut to 4 for one card
TRAIN_ARCH = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3
# 13b's checks at the full width cut to 2 layers: one 5,120-token row
CHECK_LAYERS, CHECK_SEQ = 2, 5120
# 13b's 2-layer gates, kernel route against backend="ref" on one bf16
# model: |loss_kernel - loss_ref| <= LOSS_TOL (5x the 1.02e-4 measured on
# an H100); each gradient leaf's largest |g_kernel - g_ref| <= GRAD_TOL x
# its largest |g_ref| and ||g_kernel - g_ref|| <= NORM_TOL x ||g_ref|| (2x
# the 1.00e-2 and 1.023e-2 measured, both at the embedding: the kernel's
# D = rowsum(dO o O) reads the bf16-rounded output); and each layer's
# attention backward, on the inputs the model gave it, within
# compare_with_plain's rule of the plain backward (one bf16 ulp). The
# planted faults of PLANTED_BWD_FAULTS must each fail one of these gates.
LOSS_TOL = 5e-4
GRAD_TOL = 2e-2
NORM_TOL = 2e-2
# (name, what it does to the first backward call's (dq, dk, dv), i.e. the
# last layer's): dk of one kv head zeroed; dq of one 64-row tile of one
# head halved, as an lse off by ln 2 in that tile of the dq kernel gives;
# dv of one 64-row kv tile of one kv head zeroed
PLANTED_BWD_FAULTS = (
    ("dk of kv head 0 zeroed", lambda dq, dk, dv: dk[:, 0].zero_()),
    ("dq of head 0 rows 2048-2111 halved",
     lambda dq, dk, dv: dq[:, 0, 2048:2112].mul_(0.5)),
    ("dv of kv head 0 rows 2048-2111 zeroed",
     lambda dq, dk, dv: dv[:, 0, 2048:2112].zero_()),
)
# 13c, 13d: each f32 leaf's ||g_kernel - g_ref|| <= F32_NORM_TOL x ||g_ref||
# (2-norms), and the losses within F32_LOSS_TOL relative. Not the largest
# entry: the kernel's and the plain attention's f32 roundings put a few of
# BST's MLP pre-activations on the other side of leaky_relu's kink (8 of
# 65,536 x 1,792 on an H100), which moves those rows' gradients whole,
# and an embedding row that one such row alone names
# then differs by up to 4.2e-2 of its table's largest entry, while each
# leaf's norm moves <= 1.02e-3 (dense leaves <= 1.2e-4)
F32_NORM_TOL = 5e-3
F32_LOSS_TOL = 1e-5
# the optimizer of every train step of phase 13 (AdamW, the f32 master for
# bf16 params)
TRAIN_LR = 3e-4


def tree_equal(a, b) -> bool:
    """Every leaf of two trees bit-equal (dtype, shape, bits)."""
    from repro_torch.train.optimizers import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def clone_tree(tree):
    from repro_torch.train.optimizers import tree_map
    return tree_map(torch.clone, tree)


def grad_gap(got, want) -> dict:
    """Over the leaves, the largest max|got - want| / max|want| and the
    largest ||got - want|| / ||want|| (0 where both are 0), each with the
    leaf it is at."""
    out = {"max": 0.0, "max_at": "", "norm": 0.0, "norm_at": ""}

    def ratio(d, m):
        return d / m if m > 0 else (0.0 if d == 0 else math.inf)

    def walk(g, w, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
            return
        if isinstance(g, list):
            for i, (x, y) in enumerate(zip(g, w)):
                walk(x, y, f"{path}/{i}")
            return
        if not g.numel():
            return
        d = g.float() - w.float()
        for key, r in (("max", ratio(float(d.abs().max()),
                                     float(w.float().abs().max()))),
                       ("norm", ratio(float(d.norm()),
                                      float(w.float().norm())))):
            if r > out[key]:
                out[key], out[f"{key}_at"] = r, path
    walk(got, want, "")
    return out


def attended_pairs(b, h, sq, sk, mask_kw, dev) -> int:
    """Query-key pairs the mask lets through, over the batch and q heads."""
    from repro_torch.kernels import ref
    kw = {k: mask_kw.get(k) for k in ("causal", "window", "chunk")}
    kw["causal"] = bool(kw["causal"])
    m = ref.attention_mask(sq, sk, causal=kw["causal"], window=kw["window"],
                           chunk=kw["chunk"], device=dev)
    return int(m.sum()) * b * h


def sdpa_fwd_bwd(q, k, v, dout, mask_kw):
    """SDPA forward + backward with the same mask, or None where SDPA has
    no form of it (softcap): a yardstick the port never calls."""
    from repro_torch.kernels import ref
    if mask_kw.get("softcap"):
        return None
    sq, sk = q.shape[2], k.shape[2]
    causal_only = mask_kw.get("causal") and not mask_kw.get("window") and \
        not mask_kw.get("chunk")
    mask = None
    if not causal_only and (mask_kw.get("window") or mask_kw.get("chunk")):
        mask = ref.attention_mask(sq, sk, causal=bool(mask_kw.get("causal")),
                                  window=mask_kw.get("window"),
                                  chunk=mask_kw.get("chunk"),
                                  device=q.device)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, is_causal=bool(causal_only),
            enable_gqa=True)
        out.backward(dout)
    return run


def check_flash_bwd(dev, out) -> None:
    """13a, the attention backward: the kernel (`flash_attention_bwd_cuda`,
    two launches or the small route's one) against its plain version
    (`ref.attention_bwd_ref`) on the card, dq / dk / dv by
    `compare_with_plain`'s rule, two calls bitwise equal, with its device
    time, per-call time, the plain version's time, the bound and SDPA's
    forward + backward where SDPA can express the mask."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import bwd_plan, \
        compare_with_plain, flash_attention_bwd_cuda, flash_attention_cuda
    cases, err = {}, 0.0
    for seed, (name, b, h, hkv, s, dh, dt, kw) in enumerate(FLASH_BWD_CASES):
        q, k, v = device_inputs(dev, b, h, hkv, s, s, dh, dt, 700 + seed)
        gen = torch.Generator(device=dev).manual_seed(800 + seed)
        dout = torch.randn((b, h, s, dh), generator=gen, device=dev).to(dt)
        o = flash_attention_cuda(q, k, v, 0, **kw)
        plan = bwd_plan(h, hkv, s, s, dh)

        def kernel():
            return flash_attention_bwd_cuda(q, k, v, o, dout, **kw)

        def plain():
            return ref.attention_bwd_ref(q, k, v, o, dout, **kw)
        got, want = kernel(), plain()
        again = kernel()
        rows = torch.ones((b, s), dtype=torch.bool, device=dev)
        bad = 0
        for g, w in zip(got, want):
            c = compare_with_plain(g, w, rows)
            bad += c["bad"]
            err = max(err, c["max_abs_err"])
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        del got, want, again
        pairs = attended_pairs(b, h, s, s, kw, dev)
        esz = q.element_size()
        # q, o, dout read and dq written; k, v read and dk, dv written
        n_bytes = esz * 4 * (q.numel() + k.numel())
        b_ms, b_by = bound(n_bytes, 10 * dh * pairs,
                           BF16_FLOP_PER_S if dt == torch.bfloat16
                           else F32_FLOP_PER_S)
        runs = 2 if pairs > 1e8 else 5
        t = dict(ms=graph_ms(kernel, runs=runs, replays=3),
                 call_ms=call_ms(kernel, runs=3),
                 plain_ms=graph_ms(plain, runs=1, replays=3),
                 plain_in_graph=True)
        fwd_ms = graph_ms(lambda: flash_attention_cuda(q, k, v, 0, **kw),
                          runs=runs, replays=3)
        lib = sdpa_fwd_bwd(q, k, v, dout, kw)
        lib_ms = call_ms(lib, runs=3) if lib is not None else None
        cases[name] = dict(
            shape=f"{b} x {h}/{hkv} x {s} x {dh} {str(dt)[6:]} {kw}",
            route=plan.kernel, ms=t["ms"], call_ms=t["call_ms"],
            plain_ms=t["plain_ms"], forward_ms=fwd_ms, bound_ms=b_ms,
            bound_by=b_by, sdpa_fwd_bwd_ms=lib_ms, pairs=pairs,
            bad=bad, repeat_bitwise=same,
            tflops=10 * dh * pairs / (t["ms"] * 1e9))
        print(f"[train] 13a flash backward {name} ({cases[name]['shape']}, "
              f"route {plan.kernel}, rp {plan.rp} bc {plan.bc} bk "
              f"{plan.bk}): outside compare_with_plain's rule {bad}, "
              f"repeat bitwise {same}; {time_line(t)} forward_ms="
              f"{fwd_ms:.4f} bound_ms={b_ms:.4f} ({b_by}: {pairs} attended "
              f"pairs x 10 dh FLOP) sdpa_fwd_bwd_ms="
              f"{'n/a (softcap)' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"(per call, a yardstick the port never calls); "
              f"{cases[name]['tflops']:.2f} TFLOP/s at 10 dh a pair",
              flush=True)
        need(bad == 0, f"flash_attention backward {name}: the kernel is "
             "outside compare_with_plain's rule of its plain version")
        need(same, f"flash_attention backward {name}: two calls differ")
        del q, k, v, o, dout
        torch.cuda.empty_cache()
    head = cases["danube"]
    out["flash_attention_bwd"] = dict(
        max_abs_err=err, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["sdpa_fwd_bwd_ms"], cases=cases, port_only=True)


def check_segment_bwd(dev, out) -> None:
    """13a, the segment sums' backward: segment_matmul's (the row gather)
    at ogb_products' shape and embedding_bag's (the table's segment sum)
    at BST train_batch's multi-hot bags over the 131,072 x 32 table, each
    bit-equal to its plain version, timed beside a library call."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.data.recsys import bst_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_bwd_cuda
    from repro_torch.kernels.segment_matmul import segment_matmul_bwd_cuda
    from repro_torch.models.bst import bag_inputs
    seg, _ = ogb_segments(dev)
    g = torch.Generator(device=dev).manual_seed(19)
    d_out = torch.randn((OGB_NODES, OGB_DIM), generator=g, device=dev)

    def kernel():
        return segment_matmul_bwd_cuda(d_out, seg, OGB_PADDED)
    got = kernel()
    want = ref.segment_matmul_bwd_ref(d_out, seg, OGB_PADDED)
    same = torch.equal(got, want)
    pads_zero = bool((got[OGB_EDGES:] == 0).all())
    del got, want
    torch.cuda.empty_cache()
    need(same and pads_zero, "segment_matmul backward: the kernel differs "
         "from its plain version at ogb_products")
    b_ms, b_by = bound(4 * OGB_PADDED * (OGB_DIM + 1)
                       + 4 * OGB_NODES * OGB_DIM, 0)
    t = dict(ms=graph_ms(kernel, runs=1, replays=3),
             call_ms=call_ms(kernel, runs=2),
             plain_ms=call_ms(lambda: ref.segment_matmul_bwd_ref(
                 d_out, seg, OGB_PADDED), runs=1), plain_in_graph=False)
    lib_ms = call_ms(lambda: d_out.index_select(0, seg[:OGB_EDGES].long()),
                     runs=2)
    print(f"[train] 13a segment_matmul backward {OGB_PADDED} x {OGB_DIM} "
          f"f32 from {OGB_NODES} rows: bitwise_equal={same}, pad rows 0 "
          f"{pads_zero}; {time_line(t)} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms={lib_ms:.4f} (index_select of the valid rows, per "
          "call; a yardstick the port never calls)", flush=True)
    out["segment_matmul_bwd"] = dict(
        max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, call_ms=t["call_ms"],
        port_only=True)
    del d_out, seg
    torch.cuda.empty_cache()

    cfg = get_arch("bst").CONFIG
    rows = RECSYS_SHAPES["train_batch"]["batch"]
    batch = bst_batch(0, batch=rows, seq_len=cfg.seq_len,
                      item_vocab=cfg.item_vocab, cat_vocab=cfg.cat_vocab,
                      multi_vocab=cfg.multi_vocab, device=dev)
    idx, bags, n_bags = bag_inputs(cfg, batch["multi_ids"])
    d_bags = torch.randn((n_bags, cfg.embed_dim), generator=g, device=dev)

    def bag_kernel():
        return embedding_bag_bwd_cuda(d_bags, idx, bags, cfg.multi_vocab)
    got = bag_kernel()
    want = ref.embedding_bag_bwd_ref(d_bags, idx, bags, cfg.multi_vocab)
    same = torch.equal(got, want)
    need(same, "embedding_bag backward: the kernel differs from its plain "
         "version at BST's train_batch bags")
    rows_named = int(torch.unique(idx).numel())
    b_ms, b_by = bound(8 * idx.numel() + 4 * n_bags * cfg.embed_dim
                       + 4 * cfg.multi_vocab * cfg.embed_dim,
                       idx.numel() * cfg.embed_dim)

    def library():
        return torch.zeros((cfg.multi_vocab, cfg.embed_dim),
                           device=dev).index_add_(0, idx.long(),
                                                  d_bags[bags.long()])
    t = dict(ms=graph_ms(bag_kernel, runs=5), call_ms=call_ms(bag_kernel),
             plain_ms=call_ms(lambda: ref.embedding_bag_bwd_ref(
                 d_bags, idx, bags, cfg.multi_vocab), runs=1),
             plain_in_graph=False)
    lib_ms = graph_ms(library, runs=5)
    print(f"[train] 13a embedding_bag backward: {idx.numel()} ids in "
          f"{n_bags} bags of {cfg.multi_bag} into {cfg.multi_vocab} x "
          f"{cfg.embed_dim} f32 ({rows_named} rows named): bitwise_equal="
          f"{same}; {time_line(t)} bound_ms={b_ms:.4f} ({b_by}) library_ms="
          f"{lib_ms:.4f} (index_add_ of the gathered rows, atomics; device "
          "time, CUDA graph; a yardstick the port never calls)", flush=True)
    out["embedding_bag_bwd"] = dict(
        max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, call_ms=t["call_ms"],
        port_only=True)


def train_counts() -> dict:
    """The launches since the last reset, by kernel table row."""
    from repro_torch.kernels import ops
    c = ops.launch_counts()
    wg = ops.path_counts()["flash_attention"]["wgmma"]
    c["flash_attention_wgmma"] = wg
    c["flash_attention"] -= wg
    return c


def timed_steps(step_fn, params, opt_state, batches, what: str):
    """Run the steps; (params, opt_state, per-step seconds, last metrics)."""
    secs, metrics = [], {}
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(f"[train] {what} step {i + 1}: {secs[-1]:.3f}s loss "
              f"{float(metrics['loss']):.6f} grad_norm "
              f"{float(metrics['grad_norm']):.6f}", flush=True)
    return params, opt_state, secs, metrics


def train_danube(dev) -> dict:
    """13b: h2o-danube-1.8b's CONFIG at full width and depth (24 layers,
    bf16, remat, AdamW with the f32 master) for TRAIN_STEPS steps of
    lm_batch at TRAIN_BATCH x TRAIN_SEQ, from launch counts at 0."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.random import PRNGKey
    from repro_torch.train import steps as S
    from repro_torch.train.optimizers import OptConfig
    cfg = get_arch(TRAIN_ARCH).CONFIG
    need(cfg.remat and cfg.dtype == torch.bfloat16, "danube's CONFIG is not "
         "bf16 with remat")
    opt = OptConfig(lr=TRAIN_LR, warmup=1, decay_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt_state = S.init_train_state(PRNGKey(0), "lm", cfg, opt,
                                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in _leaves(params))
    state_bytes = torch.cuda.memory_allocated(dev)
    print(f"[train] 13b {cfg.name} CONFIG: {n_par} params, {cfg.n_layers} "
          f"layers, bf16, remat; params + AdamW state (m, v, f32 master) "
          f"{state_bytes} bytes on the card; init {init_s:.2f}s; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} (train_4k's sequence; its global "
          f"batch of 256 cut to {TRAIN_BATCH} for one card)", flush=True)
    step_fn = S.make_lm_train_step(cfg, opt)
    batches = [lm_batch(i, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        vocab=cfg.vocab, device=dev)
               for i in range(TRAIN_STEPS)]
    ops.reset_launch_counts()
    params, opt_state, secs, metrics = timed_steps(
        step_fn, params, opt_state, batches, "13b danube")
    counts = train_counts()
    bwd_paths = ops.path_counts()["flash_attention_bwd"]
    peak = torch.cuda.max_memory_allocated(dev)
    loss = float(metrics["loss"])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] 13b danube: step seconds {[round(x, 3) for x in secs]}, "
          f"{tokens / min(secs):.1f} tokens/s (best step), peak memory "
          f"{peak} bytes, last loss {loss:.6f}, grad_norm "
          f"{float(metrics['grad_norm']):.6f}; launches {counts}; "
          f"backward kernels {bwd_paths}", flush=True)
    need(math.isfinite(loss), "13b: the loss is not finite")
    need(peak < 80e9, "13b: the peak passed the card's 80 GB")
    need(counts["flash_attention_bwd"] > 0 and counts["segment_matmul"] > 0,
         "13b: the backward kernels were not launched")
    need(counts["flash_attention_wgmma"] > 0, "13b: the forward did not "
         "run the wgmma kernel")
    del params, opt_state, batches
    torch.cuda.empty_cache()
    return dict(counts=counts, step_s=secs, peak=peak, loss=loss,
                tokens_per_s=tokens / min(secs))


def danube_2layer(dev, remat: bool):
    """danube's CONFIG at 2 of 24 layers (the width kept) and its params."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.random import PRNGKey
    from repro_torch.models import transformer as lm_m
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).CONFIG,
                              n_layers=CHECK_LAYERS, remat=remat)
    return cfg, lm_m.init_params(PRNGKey(0), cfg, device=dev)


@contextlib.contextmanager
def recorded_attention_bwd(fault=None):
    """Within: each call of the attention's backward kernel from
    `ops.flash_attention`'s autograd Function keeps its inputs and a copy
    of its (dq, dk, dv); `fault(dq, dk, dv)`, where given, changes the
    first call's outputs in place before autograd reads them (a planted
    fault). Yields the list of (inputs, kw, outputs)."""
    from repro_torch.kernels import ops
    real = ops.flash_attention_bwd_cuda
    rec = []

    def wrapped(q, k, v, out, dout, **kw):
        grads = real(q, k, v, out, dout, **kw)
        if fault is not None and not rec:
            fault(*grads)
        rec.append(((q, k, v, out, dout), kw,
                    tuple(g.clone() for g in grads)))
        return grads
    ops.flash_attention_bwd_cuda = wrapped
    try:
        yield rec
    finally:
        ops.flash_attention_bwd_cuda = real


def attention_bwd_outside_rule(rec) -> int:
    """Entries of the recorded backward calls' dq, dk, dv outside
    `compare_with_plain`'s rule of the plain backward on the same inputs
    (every row of these causal or windowed calls attends its own key).
    Each pair is first scaled by the power of 2 that brings the plain
    tensor's largest |entry| into [0.5, 1), as 13a's unit-scale inputs
    have it: exact in bf16, so the ulp test is unchanged and the rule's
    atol of 1e-5 stays relative to the tensor's size (a model's gradients
    are far below 1, where the bare atol would pass any entry)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import compare_with_plain
    bad = 0
    for inputs, kw, got in rec:
        with torch.no_grad():
            want = ref.attention_bwd_ref(*inputs, **kw)
        for g, w in zip(got, want):
            top = float(w.float().abs().max())
            sc = 2.0 ** -math.frexp(top)[1] if top > 0 else 1.0
            rows = torch.ones(g.shape[0], g.shape[2], dtype=torch.bool,
                              device=g.device)
            bad += compare_with_plain(g * sc, w * sc, rows)["bad"]
        del want
    return bad


def check_planted_faults(grad_fn, g_r) -> list:
    """Each of PLANTED_BWD_FAULTS planted in the kernel route's backward
    must fail one of 13b's gradient gates: its readings, printed."""
    out = []
    for name, fault in PLANTED_BWD_FAULTS:
        with recorded_attention_bwd(fault) as rec:
            g_f = grad_fn()
        gap = grad_gap(g_f, g_r)
        bad = attention_bwd_outside_rule(rec)
        caught = [w for w, hit in (("max", gap["max"] > GRAD_TOL),
                                   ("norm", gap["norm"] > NORM_TOL),
                                   ("layers", bad > 0)) if hit]
        print(f"[train] 13b planted fault '{name}': largest max|dg| / "
              f"max|g_ref| {gap['max']:.3e} at {gap['max_at']}, largest "
              f"||dg|| / ||g_ref|| {gap['norm']:.3e} at {gap['norm_at']}, "
              f"per-layer entries outside the rule {bad}; caught by "
              f"{caught or 'no gate'}", flush=True)
        need(bool(caught), f"13b: the planted fault '{name}' passed every "
             "gate")
        out.append(dict(name=name, gap=gap, bad=bad, caught=caught))
        del g_f, rec
    return out


def check_train_2layer(dev) -> dict:
    """13b's checks at 2 layers, the width kept, one 5,120-token row: the
    kernel route's loss and gradients against backend="ref"'s; remat on
    and off bit-equal; two runs of a train step bit-equal; train_loop
    crashed at step 2 and resumed equal to the uninterrupted 4-step run,
    params and optimizer state, bit for bit. Returns the launches of the
    kernel route's runs."""
    import dataclasses
    import tempfile
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.train import steps as S
    from repro_torch.train.optimizers import OptConfig, init_opt_state
    from repro_torch.train.trainer import TrainerConfig, train_loop
    cfg, params = danube_2layer(dev, remat=True)
    tokens = lm_batch(0, batch=1, seq_len=CHECK_SEQ, vocab=cfg.vocab,
                      device=dev)
    ops.reset_launch_counts()
    with recorded_attention_bwd() as rec:
        (loss_k, _), g_k = S.value_and_grad(
            lambda p: S.lm_loss(p, cfg, tokens), params)
    counts = train_counts()
    layers_bad = attention_bwd_outside_rule(rec)
    n_calls = len(rec)
    del rec
    (loss_r, _), g_r = S.value_and_grad(
        lambda p: S.lm_loss(p, cfg, tokens, backend="ref"), params)
    gap = grad_gap(g_k, g_r)
    dl = abs(float(loss_k) - float(loss_r))
    print(f"[train] 13b 2 layers, 1 x {CHECK_SEQ}: loss kernel "
          f"{float(loss_k):.6f} ref {float(loss_r):.6f} (|diff| {dl:.3e}, "
          f"gate {LOSS_TOL}); largest leaf max|dg| / max|g_ref| "
          f"{gap['max']:.3e} at {gap['max_at']} (gate {GRAD_TOL}), largest "
          f"||dg|| / ||g_ref|| {gap['norm']:.3e} at {gap['norm_at']} (gate "
          f"{NORM_TOL}); the {n_calls} backward calls' entries outside "
          f"compare_with_plain's rule {layers_bad}", flush=True)
    need(n_calls == CHECK_LAYERS, "13b: the backward kernel ran "
         f"{n_calls} times for {CHECK_LAYERS} layers")
    need(dl <= LOSS_TOL, "13b: the kernel route's loss is not the plain "
         "route's within the gate")
    need(gap["max"] <= GRAD_TOL and gap["norm"] <= NORM_TOL,
         "13b: the kernel route's gradients are not the plain route's "
         "within the gates")
    need(layers_bad == 0, "13b: a layer's attention backward is outside "
         "compare_with_plain's rule of the plain backward")
    check_planted_faults(lambda: S.value_and_grad(
        lambda p: S.lm_loss(p, cfg, tokens), params)[1], g_r)
    del g_r
    cfg_nr = dataclasses.replace(cfg, remat=False)
    (loss_n, _), g_n = S.value_and_grad(
        lambda p: S.lm_loss(p, cfg_nr, tokens), params)
    remat_same = tree_equal(g_k, g_n) and torch.equal(loss_k, loss_n)
    print(f"[train] 13b remat on == off, bitwise: {remat_same}", flush=True)
    need(remat_same, "13b: remat changed the gradients' bits")
    del g_n, g_k
    opt = OptConfig(lr=TRAIN_LR, warmup=1, decay_steps=8)
    state0 = init_opt_state(opt, params)
    step_fn = S.make_lm_train_step(cfg, opt)
    runs = []
    for _ in range(2):
        p, s = clone_tree(params), clone_tree(state0)
        p, s, m = step_fn(p, s, tokens)
        runs.append((p, s, float(m["loss"])))
    repeat = tree_equal(runs[0][0], runs[1][0]) and \
        tree_equal(runs[0][1], runs[1][1])
    print(f"[train] 13b two runs of one train step bit-equal (params and "
          f"AdamW state): {repeat}", flush=True)
    need(repeat, "13b: two runs of one train step differ")
    del runs

    def batch_fn(step):
        return lm_batch(step, batch=1, seq_len=CHECK_SEQ, vocab=cfg.vocab,
                        device=dev)
    t0 = time.perf_counter()
    whole = train_loop(step_fn, batch_fn, clone_tree(params),
                       clone_tree(state0),
                       TrainerConfig(total_steps=4, log_every=4))
    with tempfile.TemporaryDirectory(prefix="alid_train_") as tmp:
        tc = TrainerConfig(total_steps=4, log_every=4, ckpt_every=2,
                           ckpt_dir=tmp, keep=2, crash_at_step=2)
        try:
            train_loop(step_fn, batch_fn, clone_tree(params),
                       clone_tree(state0), tc)
            crashed = False
        except RuntimeError:
            crashed = True
        tc = TrainerConfig(total_steps=4, log_every=4, ckpt_every=2,
                           ckpt_dir=tmp, keep=2)
        resumed = train_loop(step_fn, batch_fn, clone_tree(params),
                             clone_tree(state0), tc)
    exact = crashed and tree_equal(whole[0], resumed[0]) and \
        tree_equal(whole[1], resumed[1])
    print(f"[train] 13b train_loop crashed at step 2 ({crashed}) and "
          f"resumed == the uninterrupted 4 steps, params and AdamW state "
          f"bitwise: {exact} ({time.perf_counter() - t0:.1f}s)", flush=True)
    need(exact, "13b: the resumed run is not the uninterrupted one")
    del whole, resumed, params, state0
    torch.cuda.empty_cache()
    return counts


def check_train_step(dev, name, step_k, loss_k, loss_r, params, state,
                     batch) -> dict:
    """13c / 13d: the kernel route's loss and gradients against
    backend="ref"'s (f32 gates), two runs of the kernel route's train step
    bit-equal, its step seconds and peak memory. Returns its launches."""
    from repro_torch.kernels import ops
    from repro_torch.train import steps as S
    # the plain route first, on a released cache: its autograd holds two
    # (E, d) message gradients at once (SAGE at ogb_products: 2 x 31.7 GB)
    torch.cuda.empty_cache()
    (lr_, _), gr = S.value_and_grad(loss_r, params)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    (lk, _), gk = S.value_and_grad(loss_k, params)
    counts = train_counts()
    gap = grad_gap(gk, gr)
    dl = abs(float(lk) - float(lr_)) / max(abs(float(lr_)), 1e-30)
    del gk, gr
    torch.cuda.empty_cache()
    print(f"[train] {name}: loss kernel {float(lk):.7f} ref {float(lr_):.7f}"
          f" (relative {dl:.3e}, gate {F32_LOSS_TOL}); largest leaf "
          f"||dg|| / ||g_ref|| {gap['norm']:.3e} at {gap['norm_at']} (gate "
          f"{F32_NORM_TOL}), largest max|dg| / max|g_ref| {gap['max']:.3e} "
          f"at {gap['max_at']}", flush=True)
    need(dl <= F32_LOSS_TOL and gap["norm"] <= F32_NORM_TOL,
         f"{name}: the kernel route's gradients are not the plain route's "
         "within the gates")
    outs, secs = [], []
    for _ in range(2):
        p, s = clone_tree(params), clone_tree(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        p, s, m = step_k(p, s, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) - base
        outs.append((p, s))
    same = tree_equal(outs[0][0], outs[1][0]) and \
        tree_equal(outs[0][1], outs[1][1])
    print(f"[train] {name}: two train steps bit-equal {same}; step seconds "
          f"{[round(x, 4) for x in secs]}, peak memory above the state "
          f"{peak} bytes", flush=True)
    need(same, f"{name}: two runs of the train step differ")
    del outs
    torch.cuda.empty_cache()
    return dict(counts=counts, step_s=secs, peak=peak, grad_gap=gap)


def train_gnns(dev) -> dict:
    """13c: GIN-TU and GraphSAGE-Reddit train steps at ogb_products, full
    batch, f32 (the registry's `make_cell` configs, as phase 9)."""
    from repro_torch.configs import get_arch
    from repro_torch.random import PRNGKey
    from repro_torch.train import steps as S
    from repro_torch.train.optimizers import OptConfig
    cfg = get_arch(GNN_OGB_ARCHS[0]).make_cell("ogb_products").model_cfg
    _, batch = gnn_graph(dev, "ogb_products", cfg)
    res = {}
    for arch in GNN_OGB_ARCHS:
        cell = get_arch(arch).make_cell("ogb_products")
        cfg, kind = cell.model_cfg, "node_ce"
        opt = OptConfig(lr=TRAIN_LR)
        params, state = S.init_train_state(PRNGKey(0), "gnn", cfg, opt,
                                           device=dev)
        res[arch] = check_train_step(
            dev, f"13c {arch} at ogb_products",
            S.make_gnn_train_step(cfg, opt, kind),
            lambda p: S.gnn_loss(p, cfg, batch, kind),
            lambda p: S.gnn_loss(p, cfg, batch, kind, backend="ref"),
            params, state, batch)
        del params, state
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()
    return res


def train_bst(dev) -> dict:
    """13d: BST's CONFIG train step at RECSYS_SHAPES["train_batch"]
    (65,536 rows, f32), the same checks as 13c."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.data.recsys import bst_batch
    from repro_torch.random import PRNGKey
    from repro_torch.train import steps as S
    from repro_torch.train.optimizers import OptConfig
    cfg = get_arch("bst").CONFIG
    batch = bst_batch(0, batch=RECSYS_SHAPES["train_batch"]["batch"],
                      seq_len=cfg.seq_len, item_vocab=cfg.item_vocab,
                      cat_vocab=cfg.cat_vocab, multi_vocab=cfg.multi_vocab,
                      device=dev)
    opt = OptConfig(lr=TRAIN_LR)
    params, state = S.init_train_state(PRNGKey(0), "recsys", cfg, opt,
                                       device=dev)
    out = check_train_step(
        dev, "13d BST at train_batch", S.make_bst_train_step(cfg, opt),
        lambda p: S.bst_loss(p, cfg, batch),
        lambda p: S.bst_loss(p, cfg, batch, backend="ref"),
        params, state, batch)
    del params, state, batch
    torch.cuda.empty_cache()
    return out


def train_cli() -> None:
    """13e: `python -m repro_torch.launch.train --steps 20` (the smoke
    config) on the card, in this process."""
    from repro_torch.launch import train as train_cli_m
    hist = train_cli_m.main(["--steps", "20"])
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] 13e launch.train --steps 20 on the card: loss {first:.4f}"
          f" -> {last:.4f}", flush=True)
    need(math.isfinite(last) and last < first, "13e: the smoke training's "
         "loss did not fall")


def check_training(dev, stats) -> dict:
    """Phase 13: training. Returns the phase's launches by table row (13b,
    13b's 2-layer kernel runs, 13c, 13d)."""
    check_flash_bwd(dev, stats)
    check_segment_bwd(dev, stats)
    stamp("phase 13a")
    danube = train_danube(dev)
    stamp("phase 13b danube")
    two = check_train_2layer(dev)
    stamp("phase 13b 2-layer checks")
    gnns = train_gnns(dev)
    bst = train_bst(dev)
    stamp("phase 13c, 13d")
    train_cli()
    stamp("phase 13e")
    counts: dict = {}
    for c in (danube["counts"], two, *(g["counts"] for g in gnns.values()),
              bst["counts"]):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    for name in ("flash_attention_bwd", "segment_matmul_bwd",
                 "embedding_bag_bwd", "embedding_bag", "segment_matmul"):
        need(counts.get(name, 0) > 0, f"phase 13 never launched {name}")
    stats["flash_attention_bwd"]["training"] = dict(
        danube_step_s=danube["step_s"], danube_peak=danube["peak"],
        danube_tokens_per_s=danube["tokens_per_s"],
        danube_loss=danube["loss"],
        gnn_step_s={k: v["step_s"] for k, v in gnns.items()},
        gnn_peak={k: v["peak"] for k, v in gnns.items()},
        bst_step_s=bst["step_s"], bst_peak=bst["peak"])
    print(f"[train] phase 13 launches {counts}", flush=True)
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def model_zoo(dev, stats) -> tuple:
    """Phases 7, 8, 9, 12 and 13, which need no kernel of the late library
    (`kernels._build.LATE_SOURCES`): they run first, while it builds.
    Returns their launches by kernel table row and phase 9's forwards
    (phase 10's references)."""
    counts: dict = {}
    check_flash_attention(dev, stats)
    cfg, params, prompts, gen, mix_served, lm_counts = serve_lm(dev)
    counts["flash_attention"] = lm_counts["flash_attention"]
    counts["flash_attention_wgmma"] = lm_counts["flash_attention_wgmma"]
    teacher_force_all(dev, cfg, params, prompts, gen, mix_served)
    del params, gen, mix_served
    torch.cuda.empty_cache()
    stamp("phase 7")

    check_embedding_bag(dev, stats)
    check_segment_matmul(dev, stats)
    check_bst_attention(dev, stats)
    bst_counts = serve_bst(dev)
    counts["embedding_bag"] = bst_counts["embedding_bag"]
    counts["segment_matmul"] = stats["segment_matmul"].pop("launches")
    torch.cuda.empty_cache()
    stamp("phase 8")

    gnn_ref: dict = {}
    gnn = check_gnns(dev, gnn_ref)
    stamp("phase 9")
    print(f"[gnn] segment_matmul launches: 8a's one call "
          f"{counts['segment_matmul']} + phase 9's {gnn['launches']}")
    counts["segment_matmul"] += gnn["launches"]
    stats["segment_matmul"]["gnn"] = {
        k: {key: v[key] for key in ("launches", "ms", "plain_ms",
                                    "idle_share", "forward_ms", "layer_ms",
                                    "bound_ms") if key in v}
        for k, v in gnn["cases"].items()}
    stats["flash_attention"]["bst"]["launches"] = \
        bst_counts["flash_attention"]

    moe_counts = check_moe(dev, stats)
    for name, n in moe_counts.items():
        counts[name] = counts.get(name, 0) + n
    stats["flash_attention"]["moe"]["launches"] = moe_counts
    stamp("phase 12")

    train = check_training(dev, stats)
    for name, n in train.items():
        counts[name] = counts.get(name, 0) + n
    for name in ("flash_attention", "flash_attention_wgmma", "embedding_bag",
                 "segment_matmul"):
        stats[name]["training_launches"] = train.get(name, 0)
    torch.cuda.empty_cache()
    stamp("phase 13")
    return counts, gnn_ref


def print_ptxas(report: Path) -> None:
    for line in report.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")


def main() -> int:
    from repro_torch.kernels import _build
    from repro_torch.launch import full_width
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products accumulate in f32 and round once, as XLA's dot does
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = nvidia_smi()
    print(f"[env] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _build.start_background_build()
    _build.library()
    print(f"[env] kernel build and load {time.perf_counter() - t0:.2f}s "
          f"(the late library, {', '.join(_build.LATE_SOURCES)}, builds "
          "meanwhile)")
    stamp("the build")
    print_ptxas(_build.BUILD_DIR / "ptxas.txt")
    stats: dict = {}
    zoo_counts, gnn_ref = model_zoo(dev, stats)
    t0 = time.perf_counter()
    _build.library().affinity_matvec_launch
    print(f"[env] the late library loaded {time.perf_counter() - t0:.2f}s "
          "after phase 13")
    stamp("the late library")
    print_ptxas(_build.BUILD_DIR / "ptxas-late.txt")

    spec, lshp = full_data()
    check_lsh_hash(dev, stats, (spec.points, lshp))
    check_roi_filter(dev, stats)
    check_affinity_matvec(dev, stats)
    check_lid_sweep(dev, stats)
    check_bf16_kernels(dev, stats, (spec.points, lshp))
    stamp("phase 2")
    check_parity_fit(dev)
    pspec, pcfg = engine_parity_data()
    shd_3b, rep_3b = check_engine_parity(dev, pspec, pcfg)
    bf16_counts = check_engine_parity_bf16(dev, pspec, pcfg)
    stamp("phases 3, 3b")
    res, counts, rep_info = full_fit(dev, spec, lshp)
    for name, n in zoo_counts.items():
        counts[name] = counts.get(name, 0) + n
    sharded, ooc_counts, shd = full_fit_sharded(dev, spec, lshp, res,
                                                rep_info)
    sharded["labels"] = shd.labels
    stm_counts, _ = full_fit_streamed(dev, spec, lshp, rep_info, sharded)
    del sharded
    stamp("phases 4-4c")
    resume_counts = check_fault_tolerance(dev, spec, lshp, res)
    torch.cuda.empty_cache()
    stamp("phase 4d")
    res16, cfg16, fit16_counts = full_fit_bf16(dev, spec, lshp, res,
                                               rep_info)
    online16 = check_online_bf16(dev, res16, spec.points, cfg16)
    check_cli_bf16(dev)
    del res16
    torch.cuda.empty_cache()
    stamp("phase 4e")
    print(f"[bf16] launches of the fit kernels at bf16 storage: 3b "
          f"{ {k: bf16_counts[k] for k in FIT_KERNELS} }, + 4e "
          f"{fit16_counts}, + the online arm "
          f"{ {k: online16[k] for k in FIT_KERNELS} }")
    for name in FIT_KERNELS:
        stats[name]["bf16"]["launches"] = (bf16_counts[name]
                                           + fit16_counts[name]
                                           + online16[name])
        counts[name] += stats[name]["bf16"]["launches"]
    print(f"[ooc] launches of the fit kernels: replicated "
          f"{ {k: counts[k] for k in FIT_KERNELS} }, + sharded "
          f"{ {k: ooc_counts[k] for k in FIT_KERNELS} }, + streamed "
          f"{ {k: stm_counts[k] for k in FIT_KERNELS} }, + full-width "
          f"resume { {k: resume_counts[k] for k in FIT_KERNELS} }")
    for name in FIT_KERNELS:
        counts[name] += ooc_counts[name] + stm_counts[name] \
            + resume_counts[name]
    mix = serving_mix(spec.points, BULK_ROWS)
    sup = check_assign(dev, stats, res, mix)
    counts["assign"] = check_serving(dev, res, spec.points, mix,
                                     sup)["assign"]
    online = check_online(dev, res, spec.points, full_width.config(lshp))
    for name in ONLINE_KERNELS:
        counts[name] += online[name]
    # phase 10 holds its fits to phase 4's and 4b's, on phase 4's data
    mesh_ref = (spec.points, lshp, slim(res), slim(shd))
    del res, shd, sup, mix, spec
    torch.cuda.empty_cache()
    stamp("phases 5, 5b")

    check_affinity(dev, stats)
    check_lid_unfused(dev)
    check_peel_parity(dev)
    counts["affinity"] = full_matrix_run(dev)["affinity"]
    check_baselines(dev)
    torch.cuda.empty_cache()
    stamp("phase 6")

    points, lshp, rep, shd = mesh_ref
    w1 = mesh_w1(dev, points, lshp, Slim(rep), Slim(shd))
    ranks = check_mesh(dev, points, lshp, Slim(rep), Slim(shd), pspec,
                       pcfg, shd_3b, gnn_ref)
    del mesh_ref, points, gnn_ref
    print(f"[mesh] phase 10 launches: 10a {w1}, + the ranks of 10b-10d "
          f"{ranks}")
    for name in FIT_KERNELS:
        counts[name] += w1[name] + ranks[name]
    counts["segment_matmul"] += ranks["segment_matmul"]
    stats["segment_matmul"]["gnn"]["mesh"] = {
        "launches": ranks["segment_matmul"]}
    stamp("phase 10")

    check_counts = check_analysis(dev)
    golden_counts = check_golden(dev, Slim(rep_3b))
    del rep_3b
    print(f"[tooling] phase 11 launches: 11a {check_counts}, + 11b "
          f"{golden_counts}")
    for name in OPS_KERNELS:
        counts[name] += check_counts[name] + golden_counts[name]
    stamp("phase 11")

    table = []
    for name, s in stats.items():
        table.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, f"src/repro_torch/csrc/{name}.cu"),
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
            **{key: s[key] for key in ("decode", "bst", "prefill_grid",
                                       "shapes", "unsorted_ms", "bf16_ms",
                                       "rows4", "composition_ms", "plan",
                                       "probe", "one_step_ms",
                                       "converged_ms", "general_ms",
                                       "general_bound_ms",
                                       "general_bound_by", "gnn", "bf16",
                                       "moe", "cases", "training",
                                       "port_only", "call_ms",
                                       "training_launches")
               if key in s}})
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
