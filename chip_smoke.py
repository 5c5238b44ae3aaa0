#!/usr/bin/env python3
"""GPU smoke for euler_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and nvcc:

    python3 chip_smoke.py [--model-dir CKPT] [--seed 0]

Phases, each of which raises (exit code != 0) when it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA library of the port from the sources in the
     checkout, one nvcc per source, all started together;
  3. hold each kernel against its plain PyTorch version on the card:
     gather_weighted_sum within rtol = atol = 1e-5 at F in {1, 2, 4, 8,
     16, 32, 64, 128, 200, 256, 512, 67}, N in {1, 127, 1280, 12800}, D in
     {1, 3, 10, 25, 64}, iota (the grid path's layout) and random slots, f32
     and bf16 x, slots outside [0, n_src) (against the plain version with
     them masked out) and 64-bit offsets; gather_weighted_sum_dx against
     the plain backward on the same sweep, bitwise for unique slots (iota,
     permuted) and within 1e-5 of the f32 sum for repeated ones, at 64-bit
     offsets and through torch.autograd.grad ('cuda' against 'ref');
     paged_gather (int32
     and f32 planes), paged_gather_dequant and paged_cdf_count bitwise, at
     W in {1, 1024, 10240, 100000} draws-rows, k in {1, 10}, page sizes
     {8, 16, 128}, with padding lanes, r = 0 and r = 0xFFFFFFFF, the first
     and last elements and odd and even bf16 halves; paged_sample_hop
     bitwise against paged_sample_hop_ref on tables the flow's own staging
     (DeviceGraphTables) builds from a 3 000-node graph with hubs of 256,
     257, 270, 600 and 4 200 edges (past 32 pages at every page size),
     degree-0 rows and two trailing degree-0 nodes: page sizes {1, 8, 16,
     128} x packed bf16 and f32 weight planes (3 zero-weight rows) and unit
     weights x k in {1, 3, 10, 12, 17, 33}, every row plus the hubs 8 times,
     draws at page bounds and one below and above, r = 0 and 0xFFFFFFFF,
     and the train path's hop shapes at page size 16;
  4. serve supervised GraphSAGE at full width — random_graph with 200 000
     nodes, out-degree 10, 64-wide f32 features; fanouts 10,10; dims
     128,128; buckets 8,32,128 — through `tools.serve.build_runtime` and
     `InferenceRuntime.warmup`/`predict`, weights from a seeded
     torch.Generator (or --model-dir). The launch counts, reset just
     before, show the path went through the kernels. The embeddings are
     compared (rtol = atol = 1e-4) with kernel mode 'ref' on the card and
     with the port on the CPU, from fresh flows with the same seeds;
     then the median predict latency per bucket, the device idle share,
     and gather_weighted_sum's times (with the launch geometry) and its
     dx kernel's at the shapes one bucket-128 predict launches, each held
     first against its plain version at those shapes (the forward within
     1e-5, dx bitwise);
  5. train supervised GraphSAGE at full width on the paged device lane —
     skewed_weighted_graph with 200 000 nodes (seed 13; degree 8-15, 1 %
     hubs at 96-159, bf16 weight plane), DeviceSageFlow(fanouts 10,10,
     batch 1024, layout paged, page size 16), dims 128,128, adam lr 0.01 —
     through `Estimator.train`: (a) 20 steps in kernel mode 'auto', whose
     launch counts (reset just before) must grow by 2 paged_sample_hop
     launches (one a hop, and none of kernels 2-4), 3 gather_weighted_sum
     launches and 1 gather_weighted_sum_dx launch (layer 1's backward:
     layer 0's x are features, with no gradient) a step, with finite,
     falling losses;
     (b) the first 3 steps again in mode 'ref' on the card: bitwise equal
     batches, losses within 1e-4 relative; (c) 2 steps of the port on the
     CPU from the same draws: losses within 1e-4; (d) 3 steps with the f32
     weight plane: bitwise equal batches, 2 hop launches a step; (e)
     `save()`, and the port's InferenceRuntime serves that checkpoint.
     Then the median step time, the device idle share and the kernel
     launches a step over 10 profiled steps; paged_sample_hop per hop on
     the path's tables, rows and draws (held bitwise first), cycled past the
     L2 and L2-warm (200 calls), against its plain version and the
     composition of kernels 2-4 it replaced (mode 'cuda'; 50 calls each)
     and its bound; then `train_grouped`:
     the 20 steps again at steps_per_call 16 (one call of 16 and a
     remainder of 4; the first step eager, then 19 replays of the
     captured step), with the same launches a step, counted launches equal
     to the captured ones times the replays, losses within 1e-4 relative
     of (a)'s K = 1 run, and calls of 16 steps timed at K = 1 and K = 16
     (median step, device time, idle share, kernels on the card a step
     by profiler record); each of kernels 2-4 at
     the inputs the hop's plain version gives them, against its plain
     version, `flat[fidx]` (paged_gather) and its bound; and
     gather_weighted_sum's and its dx kernel's at the shapes of one step,
     checked as in 4;
  6. retrieve at full width — 1 000 000 unique random u64 ids x 128-wide
     f32 vectors (seeded; 8 vectors copied to 80 rows each, so the
     queries that are those vectors tie at the k-th place), a `cat`
     attribute in 0..3, metric cosine, k 32 — written as a checkpoint
     leaf by `CheckpointStore.save_leaves`, loaded through
     `EmbeddingCorpus.from_checkpoint` and searched through the
     `_CorpusEngine` at every bucket (1, 4, 16, 64), unfiltered and
     filtered by cat in {0, 2}: one paged_topk_score and one
     paged_topk_select launch per search (counts reset just before), the
     scorer's template as the FMA guard chose it; answers bitwise equal to
     impl 'ref' on the card (the plain scorer, `torch.where` and
     `canonical_topk`), to `numpy_topk_oracle` (buckets 1-16 and 4
     queries of bucket 64) and to a 2-shard `merge_topk`. Then per bucket
     the median search latency, the device time split into the scorer,
     the select kernel, the rest of the selection and copies, the idle
     share, the scorer under both templates against its plain version,
     torch.matmul and its bound, and the select kernel against its plain
     version, stage 2, `canonical_topk`, `torch.topk` over the masked
     scores and its bound;
     6b. `retrieve_lane`, bench.py's retrieval lane as written
     (bench.py:1151-1223) at its accelerator sizes — a 20 000 x 64 cosine
     corpus from default_rng(17) with a `cat` column, two RetrievalServers
     (2 shards x 1 replica), one RetrievalClient, 300 queries of 4 at k
     32, unfiltered then filtered by cat in {0, 2}: queries/s, p50, p99,
     filtered over unfiltered, merge overhead, retrieval_bit_parity
     (every answer bitwise `numpy_topk_oracle`), kernels 5 and 5b exactly
     2 launches a query, one shard's engine in process, the card's share
     of a profiled window;
     6c. `retrieve_fleet`, phase 6's cell served over TCP — its checkpoint
     and a second one of fresh vectors, 2 shards x 2 replicas of
     RetrievalServer on the card loading the corpus through
     `EmbeddingCorpus.from_checkpoint` (one prebuilt corpus a step), a
     RetrievalClient hedging at 50 ms, 8 client threads sending bucket-4
     and bucket-16 queries, unfiltered and filtered: every answer bitwise
     the answer of one in-process `_CorpusEngine` over its version; a
     steady window and a profiled one (queries/s, p50, p99, hedges issued
     and denied, the card's busy and idle share), a rolling
     `reload_all(canary_q=...)` to the second checkpoint under load
     (every replica swapped with canary parity false, every answer of one
     version, version rounds, each reload's build_s, peak device memory),
     one replica stopped mid-window (failover, answers bitwise) and a
     tenant past its TenantQuota (a typed OverloadError); kernels 5 and 5b
     exactly one launch each a shard search in every window;
     6d. `retrieve_selftest`, `python -m euler_tpu_torch.tools.retrieve
     --selftest` in a process of its own on the card: exit 0 and
     "selftest": "ok";
  7. train the north-star quality config through the host-batch lane —
     products_like_graph() (50 000 nodes, 47 Zipf classes, 100-wide
     features, average degree 16, seed 0), SageDataFlow(fanouts 10,5) and
     128 train roots a step from one default_rng(0), dims 128,128, adam lr
     0.01, the JAX package's tests/test_quality.py:383-430 — 500 steps
     through `Estimator.train`: exactly 3 gather_weighted_sum and 1
     gather_weighted_sum_dx launches a step (counts reset just before),
     finite, falling losses; `evaluate` on the first 5 000 test nodes in
     10 batches of 500 (3 launches each) with f1 in (0.74, 0.84), the JAX
     test's band; the first 3 steps again in mode 'ref' on the card and 2
     on the CPU from the same host batches (losses within 1e-4 relative);
     a Prefetcher(workers=1, device_put=True) run bitwise equal to the
     plain one; then the median step, its host sampling part, device time,
     H2D copies, idle share and top device ops, without a Prefetcher and
     with one of 2 and of 1 workers; then 32 steps at steps_per_call 16
     over `stack_batches` against 32 at K = 1 from the same init and
     batches, bitwise, and calls of 16 steps timed at both K;
     7b. the same config with the graph written to a dir and loaded with
     `Graph.load(native=True)`, so each batch's fanout is one call of the
     C++ engine: 500 steps (3 + 1 launches a step), f1 in the band, then
     the median step and its sampling part without a Prefetcher and with
     Prefetcher(workers=2, device_put=True), beside phase 7's numpy ones;
  8. the trainer CLI (`python -m euler_tpu_torch.tools.train`, the
     products graph written to a dir, dims 128,128, batch 128, max degree
     10, a checkpoint every 10 steps) as subprocesses: 40 steps straight
     against 20 then a fresh --resume process up to 40, per-step losses and
     the final checkpoint bitwise equal; a SIGTERM after the first
     committed checkpoint gives exit 3 and a checkpoint at the preempted
     step; the split against the straight run again with --native (the
     engine's draws), bitwise; then the same trainer in process, 3 + 1
     launches a step;
  9. on the CLI's checkpoint, `Estimator.infer` in chunks of 128 against
     `InferenceRuntime.predict` at bucket 128, both over
     FullNeighborDataFlow, 1 000 test ids: bitwise equal, 3 launches a
     chunk;
 10. the headline training leg, bench.py's accelerator cell
     (bench.py:1774-1804, :1832-1870) — random_graph with 200 000 nodes,
     out-degree 15, 64-wide features (seed 0), DeviceSageFlow(fanouts
     10,10, batch 1024, layout auto: dense), DeviceFeatureCache, dims
     128,128, adam lr 0.01 — at steps_per_call 1 and 64, f32 and bf16
     convs: 128 warm-up steps (K = 64's losses within 1e-4 of K = 1's),
     then 30 calls of 64 steps with exactly 3 gather_weighted_sum and 1
     gather_weighted_sum_dx launches a step (one capture at K = 64, whose
     launches times its replays are the counts), and
     graphsage_sampled_edges_per_sec_per_chip (bench.py:350-355's 112 640
     edges a step over the calls' host-clock time), the median step,
     device time, idle share and kernels on the card a step (kernel 1 on
     bf16 features once a step under bf16 convs);
 11. bench.py's host training leg (bench.py:1806-1870 with the device
     flow off) — the same graph written to a dir and loaded with
     `Graph.load(native=True)`, DeviceFeatureCache,
     SageDataFlow(fanouts 10,10, feature_mode rows, lean) shipping int32
     rows, 1 024 roots a batch, Prefetcher(stack_batches(batch_fn, 16),
     depth 4, workers 4, device_put), bf16 convs, steps_per_call 16 — 32
     warm-up steps then 30 calls of 16 steps with exactly 3
     gather_weighted_sum and 1 dx launches a step:
     graphsage_sampled_edges_per_sec_per_chip, the median call, idle share,
     H2D time, kernels on the card a step, the engine's calls and ms a
     step, one batch_fn and the stacking of one window alone; then again
     with one worker;
 12. self-checks of the rows-mode lean lane on that graph: a lean batch
     moved and hydrated on the card is bitwise its host upgrade and the
     non-lean rows batch of the same roots and seed; every valid fused
     draw is an edge of the graph and every row resolves to its id; two
     flows of one seed draw the same batches, which the port trains (sgd)
     on the card and on the CPU to the same first 3 losses (1e-4 relative);
     16 lean steps at K = 16 through a one-worker Prefetcher are bitwise
     the same steps at K = 1;
 13. `serve_tcp`, bench.py's serving lane at its accelerator sizes
     (bench.py:1993-2100, :2019-2022) over TCP — phase 4's graph,
     SageDataFlow(fanouts 10,10, label "label", default_rng(5)), dims
     128,128, a 1-step checkpoint from `Estimator.train` (roots from
     default_rng(7)), one bucket of 128, `ModelServer(max_wait_us=2000)`,
     one warm probe through the wire (its first and second request timed),
     then 16 client threads, each with its own `ServingClient`, sending 50
     requests of 16 ids from default_rng(100 + k): requests/s, p50 and p99,
     batches_per_100_requests, then 10 requests a client under
     torch.profiler (device time a request, idle share); kernel-1
     launches exactly 3 a device batch (counts reset just before), no dx,
     no rejection;
 14. `serve_parity`, the same graph and checkpoint over
     FullNeighborDataFlow(2 hops, max degree 10) at bucket 128: the rows
     of 16 concurrent clients (4 requests each) bitwise the runtime's
     direct predict, with fewer device batches than requests;
     `predict(ids, deadline_ms=0.001)` raises a typed DeadlineExceededError
     over the wire; a server with max_queue 1 under 8 clients of 20
     full-bucket requests answers some and rejects some with a typed
     OverloadError (as many as the server counts), none hanging; an
     unknown op gets an error frame and the connection keeps serving;
 15. `serve_fleet`, bench.py's fleet lane (bench.py:2214-2420) — 4
     ModelServers on the card over random_graph(8 000, out-degree 8,
     32-wide, seed 11), FullNeighborDataFlow(2 hops, max degree 6), dims
     32,32, bucket 32, a 1-step checkpoint: routed rows under
     consistent_hash and least_loaded bitwise `Estimator.infer`; 12
     clients x 30 requests of 32 ids through 1 replica and through 4
     (fleet_scaling_4x), then 10 requests a client under torch.profiler
     (the card's device time and idle share), every routed row held bitwise to `Estimator.infer`; a chaos `server
     delay` of 0.25 s on replica 3's predicts, 12 clients x 16 requests
     unhedged and hedged at a pinned 62.5 ms (the router's default pool of
     attempt threads, then 64), hedges within the RetryBudget; kernel-1
     launches exactly 3 a device batch summed over the replicas; a reload
     of the same checkpoint on one replica with canary parity; the host's
     core count;
 16. `unsup_train`, GraphSAGEUnsupervised on phase 5's graph (bf16 weight
     plane) through DeviceUnsupSageFlow(fanouts 10,10, batch 512, 5
     negatives, layout paged, page size 16), dims 128,128, adam lr 0.01:
     20 steps in mode auto with exactly 7 paged_sample_hop launches a step
     (the pos draw, then one a hop of the src, pos and negs fanouts), 9 of
     gather_weighted_sum and 3 of its dx (one a MiniBatch), none of kernels
     2-4; the first 3 steps in mode ref on the card (bitwise batches,
     losses within 1e-4 relative); the dense layout's triples from the
     same draws, bitwise; 20 steps at steps_per_call 16 (replays, the same
     launches, losses within 1e-4 of K = 1's); 3 host-lane steps
     (unsupervised_batches over SageDataFlow) on the card, 9 + 3 launches
     a step, and on the CPU (losses within 1e-4); calls of 8 steps timed
     at K = 1 and K = 16 (median step, device ms, idle share, the port's
     kernels on the card a step by profiler record);
 17. `skipgram_train`, DeepWalk, node2vec (p 0.5, q 2) and LINE at dim
     128 on phase 4's graph, batch 512, 5 negatives, walk 5, window 2,
     adam lr 0.01: 20 steps each through DeviceWalkFlow / DeviceEdgeFlow
     (no launch of the port's kernels), the first 2 again on the CPU from
     the card's draws (bitwise batches, losses within 1e-4) and 2 through
     deepwalk_batches / line_batches on the card and the CPU; calls of 8
     steps timed; then on cora_like (tests/test_quality.py:467-507's
     recipe) LINE after 2 000 steps with MRR in (0.87, 0.97) and DeepWalk
     after 600 in (0.87, 0.995);
 18. `kg_train`, the six TransX variants at FB15k's shape (14 951
     entities, 1 345 relations, 483 142 triples drawn from seed 5), dim
     100, batch 512, 8 negatives, adam lr 0.01: 20 steps each through
     DeviceKGFlow with finite losses, the first 2 again on the CPU from the
     card's draws (bitwise batches, losses within 1e-4); TransE through
     kg_batches on the card and the CPU, and timed in calls of 8 steps;
     then on fb15k_like (tests/test_quality.py:510-546) the untrained
     control's MeanRank > 600, and after 1 500 steps MeanRank in (30, 420)
     and Hit@10 in (0.32, 0.55);
 19. `kg_retrieve`, phase 18's trained TransE entity table from its
     committed checkpoint through `EmbeddingCorpus.from_checkpoint(leaf=)`
     (cosine, padding rows masked out), 16 (head, relation) queries at
     buckets 1, 4 and 16, k 10: answers bitwise numpy_topk_oracle's, one
     paged_topk_score and one paged_topk_select launch a search;
 20. `run_model_cli`, `python -m euler_tpu_torch.examples.run_model` for
     graphsage_unsup, deepwalk, line, transe, gcn and gat on --synthetic
     data with and without --device-flow (12 processes at once), then
     evaluate (transe) and infer (deepwalk, line, graphsage_unsup) on the
     device-flow runs (4 at once): each exits 0;
 21. `conv_train`, the conv zoo's first half (GCN, GAT as run_model builds
     it — improved, one head —, GraphConv, APPNP, SGCN, TAGCN, ARMA)
     through SuperviseModel on phase 5's paged device lane (bf16 weight
     plane, DeviceSageFlow(fanouts 10,10, batch 1024, paged, P = 16)),
     dims 128,128, adam lr 0.01: 20 steps each in mode auto with exactly 2
     paged_sample_hop launches a step, GAT also 3 gather_weighted_sum and
     3 gather_weighted_sum_dx launches a step (its grid path gathers h_src
     = W·x_src with its softmax weights, and h_src carries a gradient in
     every conv call), the other convs none; the first 3 steps in mode
     ref on the card and 2 on the CPU from the card's draws (bitwise
     batches, losses within 1e-4 relative); GCN and GAT at steps_per_call
     16 (replays, the same launches, losses within 1e-4 of K = 1's); calls
     of 8 steps timed (median step, device ms, idle share, the port's
     kernels on the card a step) at K = 1, and at K = 16 for GCN and GAT;
 22. `conv_quality`, the JAX package's full-graph quality recipes
     (tests/test_quality.py:82-96, :136-170, :244-263, :306-320) through
     `examples/conv_quality.py` on the card: FullGraphFlow(gcn_norm=True)
     on cora_like, 200 adam steps at lr 0.01 on the 140-label split from
     the JAX test's init (`params.flax_init`, seed 0), F1 on the 1 000
     test nodes in the JAX tests' bands — GCN [16, 16] (0.79, 0.88),
     APPNP (0.78, 0.90), GAT [64, 64] 4 heads improved (0.70, 0.86), SGCN
     (0.79, 0.92), TAGCN (0.70, 0.86), ARMA (0.65, 0.82) — and GAT at the
     640-label pool after 300 steps in (0.86, 0.97); no kernel of the
     port launches (the whole-graph block has no grid).
The native engine's draws depend on the host's core count (it splits a
call over its threads and seeds each chunk from its start), so they are
compared within one machine only; `os.cpu_count()` is printed beside them.
Then kernel 1 and its dx at the host lane's shapes, at the unsupervised
step's and at GAT's step's (h_src, F = 128, in each of a step's three
calls, with GAT's masked softmax weights), each held first against its
plain version; and the dx kernel at GAT's shapes with repeated slots,
within 1e-5.
In phase 3, paged_topk_score is also held bitwise to its plain version
for dp in {1, 8, 32, 64, 128, 256}, nrows in {1, 127, 1001, 100003}, B in
{1, 2, 3, 8, 16, 20, 64, 65}, sig12 and raw f32 operands with a padded tail, an
unaligned table, and 64-bit offsets (2^24 + 3 rows x 128, B = 130): the
mul/add template in every case and the FMA template where the guard
`products_exact` accepts the operands (it must accept the sig12 ones and
reject raw f32 and sig12 operands scaled past the normal range of the
products). paged_topk_select is held bitwise to its plain version, and
with `topk_keys` to `canonical_topk`, for tiles 1024 and 8192, k in {1,
32, 100, T, T + 1, > nrows}, nrows in {1, 1000, 10007, 100003}, absent,
all-false, 3-row and random masks, 13 real queries of a bucket of 16, ties
everywhere, +-0.0, -inf and 90 equal maxima across each tile border.
The line before the last is the `kernels` JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores, the rate the kernel's f32 multiply-adds run at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20

NUM_NODES, OUT_DEGREE, FEAT_DIM, LABEL_DIM, GRAPH_SEED = 200_000, 10, 64, 2, 3
DIMS, FANOUTS, BUCKETS = "128,128", "10,10", "8,32,128"
REQUEST_SIZES = (1, 8, 16, 32, 100, 128, 300)
KERNEL_TOL = 1e-5
# kernel 1's sweep: the paths' widths (16 train, 64 serve, 128 hidden), every
# lane group (F = 1-32), chunked rows (200-512) and the scalar path (67)
GWS_SWEEP_F = (1, 2, 4, 8, 16, 32, 64, 128, 200, 256, 512, 67)
GWS_SWEEP_N = (1, 127, 1280, 12800)
GWS_SWEEP_D = (1, 3, 10, 25, 64)
SERVE_TOL = 1e-4

# the training cell: bench.py's paged lane (`_paged_device_ab`, the graph
# of `_skewed_weighted_graph`) at the headline training shape
TRAIN_NODES, TRAIN_GRAPH_SEED, TRAIN_FEAT = 200_000, 13, 16
TRAIN_BATCH, TRAIN_FANOUTS, TRAIN_DIMS, PAGE_SIZE = 1024, [10, 10], [128, 128], 16
TRAIN_STEPS, REF_STEPS, CPU_STEPS, F32_STEPS = 20, 3, 2, 3
TIMED_STEPS, PROFILED_STEPS = 15, 10
TRAIN_TOL = 1e-4
PAGED_KERNELS = ("paged_gather", "paged_gather_dequant", "paged_cdf_count")
# kernel 2-4h, one hop of the paged draw, and the graph of its sweep: hubs
# of 256 / 257 / 270 edges (32 / 33 / 34 pages at P = 8), 600 (38 at P =
# 16) and 4 200 (33 at P = 128)
HOP_KERNEL = "paged_sample_hop"
HOP_NODES, HOP_GRAPH_SEED, HOP_HUBS = 3000, 21, (256, 257, 270, 600, 4200)
HOP_PAGE_SIZES = (1, 8, 16, 128)
HOP_KS = (1, 3, 10, 12, 17, 33)
HOP_SLOW_ITERS = 50  # calls of the plain hop and the composition in their timing
# one DRAM sector: the least a gather of one 4-byte word moves
SECTOR_BYTES = 32

# the retrieval cell: one shard of GraphSAGE dims=[128, 128] embeddings,
# searched as bench.py's retrieval lane searches (cosine, k 32, a `cat`
# filter), at the width of a real shard
RETR_ROWS, RETR_DIM, RETR_K, RETR_STEP = 1_000_000, 128, 32, 1
RETR_BUCKETS = (1, 4, 16, 64)
RETR_FILTER = [[["cat", "in", [0, 2]]]]
RETR_HOT, RETR_COPIES = 8, 80
RETR_ORACLE_BUCKET, RETR_ORACLE_EXTRA = 16, (16, 31, 47, 63)
RETR_TIMED, RETR_PROFILED, RETR_WARM_ROWS = 20, 10, 65_536
# the retrieval front end: bench.py's retrieval lane at its accelerator
# sizes (bench.py:1151-1223: 20 000 x 64 cosine from default_rng(17), 2
# shards x 1 replica, 300 queries of 4, k 32, filter cat in {0, 2}); then
# the retrieval cell above served over TCP by 2 shards x 2 replicas through
# a hedged client, with a second checkpoint of fresh vectors to roll to
LANE_ROWS, LANE_DIM, LANE_QUERIES, LANE_BATCH, LANE_K, LANE_SEED = 20_000, 64, 300, 4, 32, 17
LANE_PROFILED = 50  # the lane's queries in a profiled window
RF_SHARDS, RF_REPLICAS, RF_BUCKETS, RF_SETS = 2, 2, (4, 16), 8
RF_CLIENTS, RF_REQS, RF_PROFILED, RF_HEDGE_MS, RF_SEED = 8, 40, 10, 50.0, 29
RF_ROLL_ANSWERS = 2 * RF_CLIENTS  # answers of each version the roll must see
RF_TENANT_QPS = 0.001  # one admit a tenant, then a dry bucket
SELFTEST_WAIT_S = 300
TOPK_SWEEP_DP = (1, 8, 32, 64, 128, 256)
TOPK_SWEEP_ROWS = (1, 127, 1001, 100_003)
TOPK_SWEEP_B = (1, 2, 3, 8, 16, 20, 64, 65)  # every block shape of the scorer
PROFILE_WINDOWS = 3
SELECT_TILES = (1024, 8192)
SELECT_ROWS = (1, 1000, 10_007, 100_003)
SELECT_BP, SELECT_B = 16, 13

# the host-batch training cells: the JAX package's north-star quality
# config (tests/test_quality.py:383-430) and its trainer CLI
# (euler_tpu/tools/train.py) on the same products-like graph
NS_FEAT, NS_CLASSES, NS_DIMS, NS_FANOUTS, NS_BATCH = 100, 47, [128, 128], [10, 5], 128
NS_STEPS, NS_EVAL, NS_EVAL_BATCH, NS_F1_BAND = 500, 5000, 500, (0.74, 0.84)
NS_TIMED, NS_PROFILED, NS_SAME_STEPS = 30, 10, 20
CLI_MAX_DEGREE, CLI_CADENCE, CLI_STEPS, CLI_COUNTED = 10, 10, 40, 5
CLI_WAIT_S = 300  # bound on every wait for a trainer process
INFER_IDS, INFER_BUCKET = 1000, 128
# kernel 1 at the host lane's shapes (N roots of the hop, D slots, F):
# a north-star step's three launches (its dx is the third's), the CLI's
# hop 1 and an evaluate batch's three
HOST_SHAPES = (("ns layer0 hop0", 128, 10, 100), ("ns layer0 hop1", 1280, 5, 100),
               ("ns layer1 hop0", 128, 10, 128), ("cli layer0 hop1", 1280, 10, 100),
               ("eval layer0 hop0", 500, 10, 100), ("eval layer0 hop1", 5000, 5, 100),
               ("eval layer1 hop0", 500, 10, 128))

# steps_per_call on both training lanes: K = 16 runs beside K = 1, then the
# headline cell, bench.py's accelerator training leg (bench.py:1774-1804,
# :1832-1870): random_graph 200 000 nodes, out-degree 15, 64-wide features
# (seed 0), DeviceSageFlow(fanouts 10,10, batch 1024, layout auto -> dense),
# DeviceFeatureCache, dims 128,128, adam lr 0.01, 2K warm-up steps then 30
# calls of K = 64, at K 1 and 64, f32 and bf16 convs
GROUP_K, GROUP_CALLS = 16, 10
HEAD_NODES, HEAD_DEGREE, HEAD_FEAT, HEAD_SEED = 200_000, 15, 64, 0
HEAD_BATCH, HEAD_FANOUTS, HEAD_DIMS, HEAD_K = 1024, [10, 10], [128, 128], 64
HEAD_WARMUP, HEAD_CALLS = 2 * HEAD_K, 30
# the host headline cell, bench.py's host training leg (bench.py:1806-1870
# with the device flow off, :293-364): the headline's graph written to a
# graph dir and served by the native engine, SageDataFlow(fanouts 10,10,
# feature_mode rows, lean) into DeviceFeatureCache, 1 024 roots a batch
# from default_rng(SeedSequence([17, n])), Prefetcher(stack_batches(
# batch_fn, 16), depth 4, workers 4, device_put), bf16 convs, adam lr 0.01,
# 2K warm-up steps then 30 calls of K = 16; again with workers 1
HH_K, HH_DEPTH, HH_WORKERS, HH_ROOT_SEED = 16, 4, (4, 1), 17
HH_WARMUP, HH_CALLS, HH_TIMED = 2 * HH_K, 30, 20
# the rows-lane self-checks: steps of lean batches at K = 16 against K = 1
LANE_STEPS = 16
# the serving front end: bench.py's serving lane at its accelerator sizes
# (bench.py:1993-2100, :2019-2022) on phase 4's graph, a 1-step checkpoint,
# one bucket of 128, 16 clients x 50 requests of 16 ids; the parity server
# over FullNeighborDataFlow; the fleet lane (bench.py:2214-2420): 4
# replicas on one card over random_graph(8 000, 8, 32-wide, seed 11)
TCP_FANOUTS, TCP_BUCKET, TCP_WAIT_US, TCP_IDS = [10, 10], 128, 2000, 16
TCP_CLIENTS, TCP_REQS, TCP_FLOW_SEED, TCP_TRAIN_SEED = 16, 50, 5, 7
PARITY_MAX_DEGREE, PARITY_REQS, OVERLOAD_CLIENTS, OVERLOAD_REQS = 10, 4, 8, 20
FLEET_NODES, FLEET_DEGREE, FLEET_FEAT, FLEET_SEED = 8000, 8, 32, 11
FLEET_DIMS, FLEET_MAX_DEGREE, FLEET_BUCKET, FLEET_IDS = [32, 32], 6, 32, 32
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_REQS, FLEET_TRAIN_SEED = 4, 12, 30, 13
STRAGGLER_REQS, STRAGGLER_S, HEDGE_MS = 16, 0.25, 0.25 * 1e3 * 0.25
ROUTER_WIDE_WORKERS = 64  # > the attempts 12 clients can leave stalled
PROFILED_REQS = 10  # a client's requests in a profiled window
SERVE_WAIT_S = 120  # bound on every wait for a client thread
# the port's kernels as the profiler names them (kernel 1's forward carries
# its x type: `gws_kernel<__nv_bfloat16, ...>` on bf16 features)
CARD_KERNELS = {"gather_weighted_sum": "::gws_kernel<", "gather_weighted_sum_dx": "::gws_dx_kernel<",
                HOP_KERNEL: "paged_sample_hop_kernel"}

# the link-prediction cells (phases 16-20): GraphSAGEUnsupervised on the
# paged device lane's graph (phase 5's), DeepWalk / node2vec / LINE on
# phase 4's serving graph, the TransX family at FB15k's shape, and the JAX
# package's quality bands (tests/test_quality.py:467-546) on its stand-ins
UNSUP_BATCH, UNSUP_NEGS, UNSUP_STEPS, UNSUP_HOST_STEPS = 512, 5, 20, 3
UNSUP_K, UNSUP_CALLS = 8, 5
# launches an unsupervised step: paged_sample_hop once for the pos draw and
# once a hop of each of the three fanouts (src, pos, negs); kernel 1 three
# a MiniBatch (layer 0 over hops 0 and 1, layer 1 over hop 0) and its dx
# one a MiniBatch (layer 1's x carries a gradient, layer 0's are features)
UNSUP_PER_STEP = {HOP_KERNEL: 1 + 3 * len(TRAIN_FANOUTS), "gather_weighted_sum": 9,
                  "gather_weighted_sum_dx": 3}
SG_BATCH, SG_NEGS, SG_DIM, SG_WALK, SG_WINDOW, SG_STEPS, SG_CPU_STEPS = 512, 5, 128, 5, 2, 20, 2
SG_K, SG_CALLS = 8, 5
N2V_P, N2V_Q = 0.5, 2.0
KG_ENT, KG_REL, KG_TRIPLES, KG_SEED = 14_951, 1_345, 483_142, 5
KG_DIM, KG_BATCH, KG_NEGS, KG_STEPS, KG_CPU_STEPS = 100, 512, 8, 20, 2
KGR_QUERIES, KGR_K, KGR_BUCKETS = 16, 10, (1, 4, 16)
CLI_RM_MODELS, CLI_RM_STEPS = ("graphsage_unsup", "deepwalk", "line", "transe", "gcn", "gat"), 20
# the kernels line's paths of phase 16 and the launch counts each reads
UNSUP_PATHS = (("unsup_train", "launches"), ("unsup_train_k16", "launches_k16"),
               ("unsup_host", "launches_host"))
# the conv zoo's first half (phases 21-22): each conv through SuperviseModel
# on phase 5's paged device lane (GAT as run_model builds it: improved, one
# head, so its grid path runs kernel 1), GCN and GAT also at K = 16; then
# the JAX quality tests' full-graph recipes on cora_like
CONV_NAMES = ("gcn", "gat", "graph", "appnp", "sgcn", "tagcn", "arma")
CONV_KWARGS = {"gat": {"improved": True}}
CONV_GROUPED = ("gcn", "gat")
CONV_K, CONV_CALLS = 8, 5
# a GAT step launches kernel 1 once a conv call (layer 0 over hops 0 and 1,
# layer 1 over hop 0) and its dx as often: h_src = W·x_src carries a
# gradient in every call, where SAGE's layer-0 x are features; the other
# convs gather and scatter with index_select / index_add_ (XLA ops in the
# JAX package, never Pallas) and launch neither
CONV_PER_STEP = {"gat": {HOP_KERNEL: 2, "gather_weighted_sum": 3, "gather_weighted_sum_dx": 3}}
# the share of GAT's grid slots kept by the mask in the kernel timings
GAT_KEEP = 0.9


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# the script's clock: each phase line carries the seconds since it started
_START = time.perf_counter()


def _emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def _gws_slots(torch, gen, kind: str, n: int, d: int):
    """(slots int32 [n, d], n_src) of one kind: 'iota' (the grid path's
    layout, every source row cited once), 'perm' (unique, scattered) or
    'random' (repeats)."""
    dev = torch.device("cuda")
    if kind == "iota":
        return torch.arange(n * d, device=dev, dtype=torch.int32).reshape(n, d), n * d
    if kind == "perm":
        n_src = n * d + 17
        perm = torch.randperm(n_src, generator=gen, device=dev)[: n * d]
        return perm.to(torch.int32).reshape(n, d), n_src
    n_src = max(4096, n)
    return torch.randint(0, n_src, (n, d), generator=gen, device=dev, dtype=torch.int32), n_src


def _bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_kernel(torch, gen) -> dict:
    """Phase 3: gather_weighted_sum kernel vs its plain version."""
    from euler_tpu_torch.ops import gather_weighted_sum, gather_weighted_sum_ref

    dev = torch.device("cuda")
    cases, failed, max_err = 0, [], 0.0

    def one(x, slots, w, label, ref_slots=None, ref_w=None):
        nonlocal cases, max_err
        out = gather_weighted_sum(x, slots, w, "cuda")
        ref = gather_weighted_sum_ref(x, slots if ref_slots is None else ref_slots,
                                      w if ref_w is None else ref_w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        cases += 1
        max_err = max(max_err, err)
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            failed.append({"case": label, "max_abs_err": err})

    for dtype in (torch.float32, torch.bfloat16):
        # F = 67 is not a multiple of 4: the scalar-load path; F = 1-32 the
        # lane groups narrower than a warp
        for f in GWS_SWEEP_F:
            for n in GWS_SWEEP_N:
                for d in GWS_SWEEP_D:
                    for kind in ("iota", "random"):
                        slots, n_src = _gws_slots(torch, gen, kind, n, d)
                        x = torch.randn(n_src, f, generator=gen, device=dev).to(dtype)
                        w = torch.rand(n, d, generator=gen, device=dev)
                        one(x, slots, w, f"{dtype} {kind} N={n} D={d} F={f}")
        # slots outside [0, n_src) contribute nothing: held against the
        # plain version with those slots masked out
        for f in (4, 16, 64, 67, 128):
            n, d, n_src = 1280, 10, 4096
            slots = torch.randint(0, n_src, (n, d), generator=gen, device=dev, dtype=torch.int32)
            bad = torch.tensor([-1, n_src, n_src + 7, -2**31, 2**31 - 1], device=dev,
                               dtype=torch.int32)
            pick = torch.randint(0, bad.numel(), (n, d), generator=gen, device=dev)
            out_of_range = torch.rand(n, d, generator=gen, device=dev) < 0.2
            slots = torch.where(out_of_range, bad[pick], slots)
            x = torch.randn(n_src, f, generator=gen, device=dev).to(dtype)
            w = torch.rand(n, d, generator=gen, device=dev)
            one(x, slots, w, f"{dtype} out-of-range slots N={n} D={d} F={f}",
                ref_slots=torch.where(out_of_range, 0, slots),
                ref_w=torch.where(out_of_range, 0.0, w))
    # 64-bit row offsets: slot * F passes 2^31 elements
    f = 512
    n_src = 2**31 // f + 4096
    x = torch.randn(n_src, f, generator=gen, device=dev, dtype=torch.bfloat16)
    slots = torch.randint(
        n_src - 4096, n_src, (1280, 10), generator=gen, device=dev, dtype=torch.int32
    )
    w = torch.rand(1280, 10, generator=gen, device=dev)
    one(x, slots, w, f"bf16 N=1280 D=10 F={f} n_src={n_src} (int64 offsets)")
    del x
    torch.cuda.empty_cache()
    res = {"phase": "kernel_check", "kernel": "gather_weighted_sum",
           "cases": cases, "max_abs_err": max_err, "rtol": KERNEL_TOL,
           "atol": KERNEL_TOL, "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"gather_weighted_sum disagrees with its plain version: {failed}")
    return res


def check_dx(torch, gen) -> dict:
    """Phase 3b: the dx kernel vs the plain backward
    (gather_weighted_sum_dx_ref): bitwise where no slot repeats (iota and
    permuted slots, dx cast to f32 and to bf16), within rtol = atol = 1e-5
    where slots repeat (the f32 sum before the cast: the adds' order
    changes from run to run, and a cast of two f32 sums 1e-7 apart can land
    on neighbouring bf16 values); the 64-bit offsets case; and
    torch.autograd.grad through gather_weighted_sum 'cuda' against 'ref'."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.ops import (
        gather_weighted_sum,
        gather_weighted_sum_dx,
        gather_weighted_sum_dx_ref,
    )

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases, failed, max_err = 0, [], 0.0

    def one(got, want, label, bitwise):
        nonlocal cases, max_err
        torch.cuda.synchronize()
        ok = (torch.equal(_bits(torch, got), _bits(torch, want)) if bitwise
              else torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL))
        err = 0.0
        if got.numel() and not (bitwise and ok):
            err = float((got.float() - want.float()).abs().max())
        cases += 1
        max_err = max(max_err, err)
        if not ok:
            failed.append({"case": label, "max_abs_err": err, "bitwise": bitwise})

    for f in GWS_SWEEP_F:
        for n in GWS_SWEEP_N:
            for d in GWS_SWEEP_D:
                g = torch.randn(n, f, generator=gen, device=dev)
                w = torch.rand(n, d, generator=gen, device=dev)
                for kind in ("iota", "perm", "random"):
                    slots, n_src = _gws_slots(torch, gen, kind, n, d)
                    for dtype in ((f32, bf16) if kind != "random" else (f32,)):
                        one(gather_weighted_sum_dx(w, g, slots, n_src, dtype, "cuda"),
                            gather_weighted_sum_dx_ref(w, g, slots, n_src, dtype),
                            f"{kind} {dtype} N={n} D={d} F={f}", kind != "random")
    # 64-bit offsets: today's 2^31-element bf16 case, iota slots in the
    # table's top rows
    f, n, d = 512, 1280, 10
    n_src = 2**31 // f + 4096
    slots = (n_src - n * d + torch.arange(n * d, device=dev, dtype=torch.int32)).reshape(n, d)
    g = torch.randn(n, f, generator=gen, device=dev)
    w = torch.rand(n, d, generator=gen, device=dev)
    one(gather_weighted_sum_dx(w, g, slots, n_src, bf16, "cuda"),
        gather_weighted_sum_dx_ref(w, g, slots, n_src, bf16),
        f"iota bf16 N={n} D={d} F={f} n_src={n_src} (int64 offsets)", True)
    torch.cuda.empty_cache()
    # the autograd path: dx through the kernel, dw plain in both
    for dtype, kind, f in ((f32, "iota", 128), (f32, "random", 128), (bf16, "iota", 16),
                           (f32, "iota", 67), (f32, "random", 16)):
        slots, n_src = _gws_slots(torch, gen, kind, 1024, 10)
        x0 = torch.randn(n_src, f, generator=gen, device=dev).to(dtype)
        w0 = torch.rand(1024, 10, generator=gen, device=dev)
        gout = torch.randn(1024, f, generator=gen, device=dev)
        grads = {}
        for impl in ("cuda", "ref"):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            before = ops.launch_counts()["gather_weighted_sum_dx"]
            grads[impl] = torch.autograd.grad(gather_weighted_sum(x, slots, w, impl), (x, w), gout)
            launched = ops.launch_counts()["gather_weighted_sum_dx"] - before
            if launched != (impl == "cuda"):
                raise AssertionError(
                    f"autograd under {impl} launched the dx kernel {launched} times")
        for name, a, b in zip(("dx", "dw"), grads["cuda"], grads["ref"]):
            one(a, b, f"autograd {name} {kind} {dtype} F={f}", kind == "iota")
    res = {"phase": "kernel_check", "kernel": "gather_weighted_sum_dx",
           "cases": cases, "max_abs_err": max_err, "rtol": KERNEL_TOL,
           "atol": KERNEL_TOL, "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"gather_weighted_sum_dx disagrees with its plain version: {failed}")
    return res


def write_graph(directory: str) -> None:
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.graph import write_arrays

    g = random_graph(
        num_nodes=NUM_NODES, out_degree=OUT_DEGREE, feat_dim=FEAT_DIM,
        label_dim=LABEL_DIM, seed=GRAPH_SEED,
    )
    for p, shard in enumerate(g.shards):
        write_arrays(os.path.join(directory, f"part_{p}"), shard.arrays)
    g.meta.save(directory)


def serve(torch, data_dir: str, model_dir: str | None, seed: int) -> dict:
    """Phase 4: the served path on the card, checked against 'ref' mode
    and the CPU."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.params import init_like_flax
    from euler_tpu_torch.tools.serve import build_parser, build_runtime

    argv = ["--data", data_dir, "--features", "feat", "--dims", DIMS,
            "--label-dim", str(LABEL_DIM), "--fanouts", FANOUTS,
            "--buckets", BUCKETS, "--seed", str(seed)]
    if model_dir:
        argv += ["--model-dir", model_dir]
    args = build_parser().parse_args(argv)
    params = None
    if not model_dir:
        template = GraphSAGESupervised(
            FEAT_DIM, [int(x) for x in DIMS.split(",")], LABEL_DIM
        )
        params = init_like_flax(template, torch.Generator().manual_seed(seed))
    req_rng = np.random.default_rng(seed + 1)
    requests = [
        req_rng.integers(1, NUM_NODES + 1, size=n).astype(np.uint64)
        for n in REQUEST_SIZES
    ]

    def run(rt):
        rt.flow.rng = np.random.default_rng(args.seed)
        return [rt.predict(r) for r in requests]

    t0 = time.perf_counter()
    rt = build_runtime(args, device="cuda", params=params)
    load_s = time.perf_counter() - t0

    ops.set_kernel_mode("auto")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rt.warmup()
    warmup_s = time.perf_counter() - t0
    outs = run(rt)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    main_batches = rt.device_batches
    want = 3 * main_batches  # two layers: 2 + 1 grid convs per batch
    if launches["gather_weighted_sum"] != want or launches["gather_weighted_sum_dx"]:
        raise AssertionError(
            f"served path launched {launches}, expected {want} gather_weighted_sum "
            f"launches ({main_batches} device batches) and no gather_weighted_sum_dx"
        )
    for r, o in zip(requests, outs):
        if o.shape != (len(r), int(DIMS.split(",")[-1])) or not np.isfinite(o).all():
            raise AssertionError(f"bad embeddings for {len(r)} ids: {o.shape}")

    ops.set_kernel_mode("ref")
    outs_ref = run(rt)
    ops.set_kernel_mode("auto")
    rt_cpu = build_runtime(args, graph=rt.flow.graph, device="cpu", params=params)
    outs_cpu = run(rt_cpu)

    errs = {}
    for name, other in (("ref_on_card", outs_ref), ("port_on_cpu", outs_cpu)):
        errs[name] = max(float(np.abs(a - b).max()) for a, b in zip(outs, other))
        for r, a, b in zip(requests, outs, other):
            np.testing.assert_allclose(
                a, b, rtol=SERVE_TOL, atol=SERVE_TOL,
                err_msg=f"kernel vs {name}, request of {len(r)} ids",
            )
    res = {"phase": "serve", "requests": list(REQUEST_SIZES),
           "device_batches": main_batches, "launches": launches,
           "max_abs_err": errs, "rtol": SERVE_TOL, "atol": SERVE_TOL,
           "load_s": load_s, "warmup_s": warmup_s,
           "params": "--model-dir" if model_dir else f"init_like_flax(seed={seed})"}
    _emit(res)
    return {"runtime": rt, "graph": rt.flow.graph, "launches": launches["gather_weighted_sum"],
            "launches_dx": launches["gather_weighted_sum_dx"], "req_rng": req_rng}


def time_predict(rt, req_rng, reps: int = 30) -> dict:
    """Median predict latency per bucket (host clock; predict returns
    host numpy, so each call ends synchronised), and its host-side
    sampling share."""
    out = {}
    for b in rt.buckets:
        ids = [req_rng.integers(1, NUM_NODES + 1, size=b).astype(np.uint64)
               for _ in range(reps + 3)]
        lat, query = [], []
        for i, r in enumerate(ids):
            t0 = time.perf_counter()
            rt.predict(r)
            t1 = time.perf_counter()
            rt.flow.query_padded(r, b)
            t2 = time.perf_counter()
            if i >= 3:
                lat.append((t1 - t0) * 1e3)
                query.append((t2 - t1) * 1e3)
        out[str(b)] = {"median_ms": statistics.median(lat), "min_ms": min(lat),
                       "max_ms": max(lat), "median_query_ms": statistics.median(query),
                       "reps": reps}
    return out


def _device_records(prof) -> dict:
    """{device op name: (device µs, records)} from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (float(us), int(e.count))
    return out


def _kernel1_us(dev: dict, per: int) -> dict:
    """Device µs of kernel 1's forward and dx launches in a profile
    window, per predict or step."""
    return {part: sum(v for k, v in dev.items() if f"::{name}<" in k) / per
            for part, name in (("forward", "gws_kernel"), ("dx", "gws_dx_kernel"))}


def _profile_window(torch, body, windows: int = PROFILE_WINDOWS, counts: dict | None = None,
                    every: list | None = None) -> tuple[dict, float]:
    """({device op name: device µs}, host-clock ms) of one run of `body`,
    which ends synchronised, under torch.profiler. The body runs once as
    the profiler's warm-up step, then `windows` times as recorded steps,
    and the recorded step with the most device time is kept: CUPTI now
    and then drops kernel records from a window (a drop only ever lowers
    the sum; the same work repeats within ~1 %). The
    profiler's step markers are spans, not device work, and are left out.
    `counts`, when given, receives {device op name: records} of the kept
    window, and `every` one such dict for each window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    runs = []
    for _ in range(windows):
        got = {}
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p, got=got: got.update(_device_records(p))) as prof:
            body()
            prof.step()
            t0 = time.perf_counter()
            body()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        runs.append(({k: v for k, v in got.items() if not k.startswith("ProfilerStep")}, wall_ms))
    kept, wall_ms = max(runs, key=lambda r: sum(us for us, _ in r[0].values()))
    if every is not None:
        every.extend({k: n for k, (_, n) in got.items()} for got, _ in runs)
    if counts is not None:
        counts.update({k: n for k, (_, n) in kept.items()})
    return {k: us for k, (us, _) in kept.items()}, wall_ms


def _time_ms(torch, fn, sets, iters: int) -> dict:
    """One function's time per call over `iters` back-to-back calls,
    cycling through input sets whose total exceeds the L2 cache, so each
    call finds its inputs in device memory as the served path does.
    `device_ms`: the device time of its kernels (torch.profiler, CUPTI);
    `loop_ms`: CUDA events around the whole loop, which includes the
    host's launch cost whenever the host cannot keep ahead."""
    for i in range(min(len(sets), 20)):
        fn(*sets[i])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end) / iters
    def loop():
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()

    counts = {}
    kernels, _ = _profile_window(torch, loop, counts=counts)
    return {"device_ms": sum(kernels.values()) / 1e3 / iters,
            "loop_ms": loop_ms, "device_kernels": sorted(k[:60] for k in kernels),
            "device_ops_per_call": sum(counts.values()) / iters}


def gws_shapes(b: int, f0: int) -> tuple:
    """The three gather_weighted_sum launches of one batch of b roots at
    fanouts 10,10: layer 0 on hops 0 and 1 (F = f0) and layer 1 on hop 0
    (F = 128), D = 10 slots in the grid layout (slot = row * D + j)."""
    return (("layer0 hop0", b, 10, f0), ("layer0 hop1", 10 * b, 10, f0),
            ("layer1 hop0", b, 10, 128))


def _weights(torch, gen, n: int, d: int, attention: bool):
    """Kernel 1's w [n, d]: uniform in [0, 1), or GAT's grid-path weights
    (`attention`): a softmax over each row of normal logits, masked slots
    (a share 1 - GAT_KEEP) filled with -1e9 and zeroed after."""
    dev = torch.device("cuda")
    if not attention:
        return torch.rand(n, d, generator=gen, device=dev)
    keep = torch.rand(n, d, generator=gen, device=dev) < GAT_KEEP
    logits = torch.where(keep, torch.randn(n, d, generator=gen, device=dev), -1e9)
    return torch.softmax(logits, dim=1) * keep.float()


def time_kernels(torch, gen, shapes, what: str, bf16: tuple = (), attention: bool = False) -> list:
    """gather_weighted_sum, its plain version and embedding_bag at
    `shapes` (gws_shapes), inputs cycled past the L2; `warm_ms` the kernel
    on one input set, left in the L2 by the call before, as the path's
    inputs are (the op before has just written them). The shapes labelled
    in `bf16` take bf16 x, as bf16 convs give layer 1 (the VEC-8 path);
    there embedding_bag, which wants its weights in the table's type,
    runs in bf16 on w rounded to bf16 (outside the timed window).
    `attention`: GAT's weights (`_weights`) in place of uniform ones."""
    import torch.nn.functional as F

    from euler_tpu_torch.ops import (
        gather_weighted_sum,
        gather_weighted_sum_ref,
        launch_geometry,
    )

    dev = torch.device("cuda")
    rows = []
    for label, n, d, f in shapes:
        n_src = n * d
        x_dtype = torch.bfloat16 if label in bf16 else torch.float32
        x_bytes = 2 if label in bf16 else 4
        set_bytes = n_src * f * x_bytes + n * d * 8 + n * f * 4
        copies = min(512, max(2, math.ceil(2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(copies):
            x = torch.randn(n_src, f, generator=gen, device=dev).to(x_dtype)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = _weights(torch, gen, n, d, attention)
            sets.append((x, slots, w, slots.long(), w.to(x_dtype)))
        x, slots, w, _, _ = sets[0]
        out, ref = gather_weighted_sum(x, slots, w, "cuda"), gather_weighted_sum_ref(x, slots, w)
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"gather_weighted_sum disagrees with its plain version at "
                                 f"{what} {label}: max abs err {err}")
        iters = max(200, 2 * copies)
        kern = _time_ms(torch, lambda x, s, w, sl, wl: gather_weighted_sum(x, s, w, "cuda"),
                        sets, iters)
        warm = _time_ms(torch, lambda x, s, w, sl, wl: gather_weighted_sum(x, s, w, "cuda"),
                        sets[:1], 200)
        plain = _time_ms(torch, lambda x, s, w, sl, wl: gather_weighted_sum_ref(x, s, w),
                         sets, iters)
        lib = _time_ms(
            torch,
            lambda x, s, w, sl, wl: F.embedding_bag(sl, x, per_sample_weights=wl, mode="sum"),
            sets, iters,
        )
        if kern["device_ms"] <= 0:
            raise AssertionError("the profiler saw no device time for the kernel")
        # each input read once (every table row is cited once in the grid
        # layout), the output written once
        nbytes = n_src * f * x_bytes + n * d * (4 + 4) + n * f * 4
        flops = 2 * n * d * f
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        rows.append({"shape": label, "N": n, "D": d, "F": f, "n_src": n_src,
                     "x_dtype": str(x_dtype).replace("torch.", ""),
                     "geometry": launch_geometry(sets[0][0], sets[0][1]),
                     "max_abs_err": err, "ms": kern["device_ms"], "warm_ms": warm["device_ms"],
                     "plain_ms": plain["device_ms"], "library_ms": lib["device_ms"],
                     "loop_ms": {"kernel": kern["loop_ms"], "plain": plain["loop_ms"],
                                 "library": lib["loop_ms"]},
                     "device_kernels": {"kernel": kern["device_kernels"],
                                        "plain": plain["device_kernels"],
                                        "library": lib["device_kernels"]},
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "input_sets": copies,
                     "iters": iters})
        del sets
    _emit({"phase": "kernel_timing", "kernel": "gather_weighted_sum",
           "what": what, "shapes": rows})
    return rows


def time_dx(torch, gen, shapes, what: str, dtype=None, attention: bool = False) -> list:
    """gather_weighted_sum's dx at `shapes` (gws_shapes), inputs cycled
    past the L2: the dx kernel with its memset, held bitwise against the
    plain backward (`gather_weighted_sum_dx_ref`) first, the plain backward and
    embedding_bag's backward with respect to the table (per-sample
    weights, mode sum; its forward runs outside the timed window);
    `warm_ms` the kernel on one input set, left in the L2. The bound: g,
    slots and w read once, dx written once. `dtype`: dx's type (f32, or
    bf16 as bf16 convs give layer 1's x; embedding_bag then runs on a
    bf16 table, weights and g). `attention`: GAT's weights (`_weights`)."""
    import torch.nn.functional as F

    from euler_tpu_torch.ops import (
        gather_weighted_sum_dx,
        gather_weighted_sum_dx_ref,
        launch_geometry,
    )

    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    dx_bytes = torch.empty((), dtype=dtype).element_size()
    rows = []
    for label, n, d, f in shapes:
        n_src = n * d
        set_bytes = n * f * 4 + n * d * 8 + 3 * n_src * f * dx_bytes
        copies = min(512, max(2, math.ceil(2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(copies):
            g = torch.randn(n, f, generator=gen, device=dev)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = _weights(torch, gen, n, d, attention)
            table = torch.randn(n_src, f, generator=gen, device=dev).to(dtype).requires_grad_()
            out = F.embedding_bag(slots.long(), table, per_sample_weights=w.to(dtype),
                                  mode="sum")
            sets.append((g, slots, w, table, out, g.to(dtype)))
        def run(g, s, w, t, o, gl):
            return gather_weighted_sum_dx(w, g, s, n_src, dtype, "cuda")

        # iota slots: no two adds land on one element, so the kernel is exact
        g, slots, w = sets[0][:3]
        if not torch.equal(_bits(torch, run(*sets[0])),
                           _bits(torch, gather_weighted_sum_dx_ref(w, g, slots, n_src, dtype))):
            raise AssertionError(f"gather_weighted_sum_dx is not bitwise the plain backward "
                                 f"at {what} {label}")
        iters = max(200, 2 * copies)
        timed = {
            "plain": _time_ms(torch, lambda g, s, w, t, o, gl: gather_weighted_sum_dx_ref(
                w, g, s, n_src, dtype), sets, iters),
            "library": _time_ms(torch, lambda g, s, w, t, o, gl: torch.autograd.grad(
                o, t, gl, retain_graph=True), sets, iters),
            "kernel": _time_ms(torch, run, sets, iters),
            "warm": _time_ms(torch, run, sets[:1], 200),
        }
        if timed["kernel"]["device_ms"] <= 0:
            raise AssertionError("the profiler saw no device time for the dx kernel")
        nbytes = n * f * 4 + n * d * (4 + 4) + n_src * f * dx_bytes
        flops = 2 * n * d * f
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        rows.append({"shape": label, "N": n, "D": d, "F": f, "n_src": n_src,
                     "dx_dtype": str(dtype).replace("torch.", ""),
                     "geometry": launch_geometry(sets[0][0], sets[0][1]), "bitwise": True,
                     "ms": timed["kernel"]["device_ms"], "warm_ms": timed["warm"]["device_ms"],
                     "plain_ms": timed["plain"]["device_ms"],
                     "library_ms": timed["library"]["device_ms"],
                     "loop_ms": {k: v["loop_ms"] for k, v in timed.items()},
                     "device_kernels": {k: v["device_kernels"] for k, v in timed.items()},
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops, "input_sets": copies,
                     "iters": iters})
        del sets
    _emit({"phase": "kernel_timing", "kernel": "gather_weighted_sum_dx",
           "what": what, "shapes": rows})
    return rows


def profile_predict(torch, rt, req_rng, reps: int = 20) -> dict:
    """Device busy share of back-to-back bucket-128 predicts: the summed
    device time of every kernel and copy over the host-clock window."""
    b = rt.buckets[-1]
    ids = [req_rng.integers(1, NUM_NODES + 1, size=b).astype(np.uint64)
           for _ in range(reps)]
    rt.predict(ids[0])

    def window():
        for r in ids:
            rt.predict(r)
        torch.cuda.synchronize()

    dev, wall_ms = _profile_window(torch, window)
    busy_ms = sum(dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    top = [(k[:60], v) for k, v in top]
    res = {"phase": "predict_profile", "bucket": b, "reps": reps,
           "wall_ms_per_predict": wall_ms / reps,
           "device_ms_per_predict": busy_ms / reps,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernel1_us_per_predict": _kernel1_us(dev, reps),
           "top_device_us_per_predict": {k: v / reps for k, v in top}}
    _emit(res)
    return res


def _u32_as_i32(torch, t):
    """int64 values in [0, 2^32) → int32 tensor of the same bits."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def _mismatch(torch, a, b) -> tuple[int, float]:
    """(elements whose bits differ, max abs difference of their integer
    bit patterns) between two tensors of 4-byte elements."""
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    diff = ai != bi
    n = int(diff.sum())
    return n, float((ai - bi).abs().max()) if n else 0.0


def check_paged_kernels(torch, gen) -> dict:
    """Phase 3, paged: each paged kernel bitwise against its plain
    version on the card."""
    from euler_tpu_torch.ops import (
        as_lane_rows, paged_cdf_count, paged_cdf_count_ref, paged_gather,
        paged_gather_dequant, paged_gather_dequant_ref, paged_gather_ref,
    )

    dev = torch.device("cuda")
    n_elems = 1 << 22  # a 16 MB plane
    planes = {
        "int32": as_lane_rows(torch.randint(-(2**31), 2**31, (n_elems,), dtype=torch.int32,
                                            generator=gen, device=dev)),
        "f32": as_lane_rows(torch.randn(n_elems, generator=gen, device=dev)),
    }
    cases, failed, worst = 0, [], 0.0

    def one(name, label, got, want):
        nonlocal cases, worst
        torch.cuda.synchronize()
        cases += 1
        n, err = _mismatch(torch, got, want)
        worst = max(worst, err)
        if n or got.shape != want.shape or got.dtype != want.dtype:
            failed.append({"kernel": name, "case": label, "mismatches": n})

    for w in (1, 1024, 10240, 100000):
        for k in (1, 10):
            shape = (w, k)
            fidx = torch.randint(0, n_elems, shape, dtype=torch.int32, generator=gen, device=dev)
            fidx.view(-1)[0] = 0
            fidx.view(-1)[-1] = n_elems - 1
            if w * k > 2:
                fidx.view(-1)[1] = 2**31 - 1  # out of range: clamped
            for plane, table in planes.items():
                one("paged_gather", f"{plane} W={w} k={k}",
                    paged_gather(table, fidx, "cuda"), paged_gather_ref(table, fidx))
            # logical bf16 indices over the int32 plane read as packed words
            lidx = torch.randint(0, 2 * n_elems, shape, dtype=torch.int32, generator=gen, device=dev)
            lidx.view(-1)[0] = 0
            lidx.view(-1)[-1] = 2 * n_elems - 1
            if w * k > 2:
                lidx.view(-1)[1] = 1
            one("paged_gather_dequant", f"W={w} k={k}",
                paged_gather_dequant(planes["int32"], lidx, "cuda"),
                paged_gather_dequant_ref(planes["int32"], lidx))
            for p in (8, 16, 128):
                pages = n_elems // p
                # each page a sorted CDF of u32 values with padding lanes
                # (0xFFFFFFFF) after a random degree
                q = torch.randint(0, 2**32 - 1, (pages, p), dtype=torch.int64,
                                  generator=gen, device=dev).sort(dim=1).values
                deg = torch.randint(1, p + 1, (pages, 1), generator=gen, device=dev)
                q = torch.where(torch.arange(p, device=dev) < deg, q, 2**32 - 1)
                q2d = as_lane_rows(_u32_as_i32(torch, q))
                page = torch.randint(0, pages, shape, dtype=torch.int32, generator=gen, device=dev)
                page.view(-1)[-1] = pages - 1
                r = torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, generator=gen, device=dev)
                r.view(-1)[0] = 0
                r.view(-1)[-1] = -1  # 0xFFFFFFFF: every lane counts
                one("paged_cdf_count", f"W={w} k={k} P={p}",
                    paged_cdf_count(q2d, page, r, p, "cuda"),
                    paged_cdf_count_ref(q2d, page, r, p))
    del planes
    torch.cuda.empty_cache()
    hop_cases, hop_failed = check_hop_kernel(torch, gen)
    failed += hop_failed
    res = {"phase": "kernel_check", "kernel": [*PAGED_KERNELS, HOP_KERNEL],
           "cases": cases + hop_cases, "hop_cases": hop_cases, "check": "bitwise",
           "max_abs_err": worst, "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"paged kernels disagree with their plain versions: {failed}")
    return res


def _hop_degrees() -> np.ndarray:
    """Out-degrees of the hop sweep's graph: hubs past the kernel's 32-lane
    chunk at every page size, skewed rows, degree-0 rows among them and
    two trailing degree-0 nodes."""
    rng = np.random.default_rng(HOP_GRAPH_SEED)
    deg = rng.integers(0, 21, HOP_NODES)
    deg[rng.random(HOP_NODES) < 0.02] = 0
    deg[: len(HOP_HUBS)] = HOP_HUBS
    deg[-2:] = 0
    return deg


def _hop_draws(torch, gen, t, cur, k: int):
    """[W, k] draws for rows `cur` of tables t: u32 bits (as int32), the
    draws of each row of two pages or more set to its page bounds, one
    below and one above them, then r = 0 in the first row and the
    second-last and r = 0xFFFFFFFF in the last (hubs, in the sweep); or f32
    uniforms with 0, the largest float below 1 and slot boundaries j / deg."""
    dev = cur.device
    w = cur.numel()
    if t.unit_w:
        u = torch.rand((w, k), generator=gen, device=dev)
        u[0, 0] = 0.0
        u[1] = torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)).item()
        deg = t.deg[cur.long()].clamp_min(1).float()
        u[:, k // 2] = (torch.arange(w, device=dev) % deg) / deg
        return u
    r = torch.randint(-(2**31), 2**31, (w, k), dtype=torch.int32, generator=gen, device=dev)
    rows = cur.cpu().numpy()
    ps, bound = t.page_start.cpu().numpy(), t.page_bound.cpu().numpy()
    pick = np.random.default_rng(k)
    off = np.array([0, -1, 1])[np.arange(k) % 3]  # at, below and above a bound
    planted = r.cpu().numpy().view(np.uint32)
    for i in np.nonzero(ps[rows + 1] - ps[rows] > 1)[0]:
        pages = bound[ps[rows[i]] : ps[rows[i] + 1]].astype(np.int64)
        planted[i] = np.clip(pages[pick.integers(0, len(pages), k)] + off, 0, 2**32 - 1)
    planted[0, 0], planted[-2, 0], planted[-1, -1] = 0, 0, 2**32 - 1
    return torch.from_numpy(planted.view(np.int32).copy()).to(dev)


def _hop_mismatches(torch, got, want) -> list:
    """The hop outputs (nbr, ew, idx) whose presence, type, shape or bits
    differ between two (nbr, ew, idx) triples."""
    bad = []
    for name, a, b in zip(("nbr", "ew", "idx"), got, want):
        if a is None or b is None:
            if (a is None) != (b is None):
                bad.append(name)
        elif a.dtype != b.dtype or a.shape != b.shape:
            bad.append(name)
        elif not torch.equal(*((a.view(torch.int16), b.view(torch.int16))
                               if a.dtype == torch.bfloat16 else (a, b))):
            bad.append(name)
    return bad


def check_hop_kernel(torch, gen) -> tuple[int, list]:
    """Phase 3, paged_sample_hop: bitwise against its plain version on tables
    staged by the flow itself from a graph with hubs (`_hop_degrees`), at
    every page size of HOP_PAGE_SIZES, with the packed bf16 and the f32
    weight planes (three zero-weight rows among them) and unit weights; every
    row (the padding row and the trailing degree-0 nodes too) plus the hubs
    8 times more, at each k of HOP_KS (lane groups of 8, 16 and 32, and two
    draw blocks a lane); then the train path's hop shapes (1 024 and 10 240
    random rows, k 10) at page size 16. (cases, failed)."""
    from euler_tpu_torch.dataflow.device import DeviceGraphTables
    from euler_tpu_torch.datasets import graph_with_degrees
    from euler_tpu_torch.ops import paged_sample_hop, paged_sample_hop_ref

    dev = torch.device("cuda")
    deg = _hop_degrees()
    zero_rows = [i for i in range(len(HOP_HUBS), len(HOP_HUBS) + 40) if deg[i]][:3]
    graphs = {"unit": graph_with_degrees(deg, HOP_GRAPH_SEED, unit_weights=True),
              "weighted": graph_with_degrees(deg, HOP_GRAPH_SEED, zero_weight_rows=zero_rows)}
    hubs = torch.arange(1, len(HOP_HUBS) + 1, dtype=torch.int32, device=dev)
    prev = os.environ.get("EULER_TPU_PAGE_DTYPE")
    cases, failed = 0, []

    def same(label, got, want):
        nonlocal cases
        torch.cuda.synchronize()
        cases += 1
        bad = _hop_mismatches(torch, got, want)
        if bad:
            failed.append({"kernel": HOP_KERNEL, "case": label, "outputs": bad})

    try:
        for plane in ("bf16", "f32", "unit"):
            os.environ["EULER_TPU_PAGE_DTYPE"] = "f32" if plane == "unit" else plane
            g = graphs["unit" if plane == "unit" else "weighted"]
            for p in HOP_PAGE_SIZES:
                tables = DeviceGraphTables(g, layout="paged", page_size=p, device="cuda")
                t = tables.hop_tables()
                if t.unit_w != (plane == "unit") or t.w_packed != (plane == "bf16" and p > 1):
                    raise AssertionError(f"hop sweep staged plane {plane} at P={p} wrongly")
                cur = torch.cat([torch.arange(t.deg.numel(), dtype=torch.int32, device=dev),
                                 hubs.repeat(8)])
                for k in HOP_KS:
                    draw = _hop_draws(torch, gen, t, cur, k)
                    same(f"{plane} P={p} k={k} W={cur.numel()}",
                         paged_sample_hop(t, cur, draw, "cuda"), paged_sample_hop_ref(t, cur, draw))
                if p == PAGE_SIZE:
                    for w in (TRAIN_BATCH, TRAIN_BATCH * TRAIN_FANOUTS[0]):
                        cur = torch.randint(1, t.deg.numel(), (w,), dtype=torch.int32,
                                            generator=gen, device=dev)
                        draw = _hop_draws(torch, gen, t, cur, TRAIN_FANOUTS[0])
                        same(f"{plane} P={p} k={TRAIN_FANOUTS[0]} W={w} (path shape)",
                             paged_sample_hop(t, cur, draw, "cuda"),
                             paged_sample_hop_ref(t, cur, draw))
                del tables, t
    finally:
        if prev is None:
            os.environ.pop("EULER_TPU_PAGE_DTYPE", None)
        else:
            os.environ["EULER_TPU_PAGE_DTYPE"] = prev
    torch.cuda.empty_cache()
    return cases, failed


class _Tap:
    """Keeps copies of what a flow's draw_inputs and make_batch return for
    their next `n` calls (any nest of tensors), by wrapping the
    instance's methods; they launch no kernel of their own. `close`
    deletes the wrappers, and with them any draw_inputs the instance held
    before."""

    def __init__(self, flow, n: int):
        from euler_tpu_torch.estimator.graph_step import tree_map

        self.flow, self.draws, self.batches = flow, [], []
        draw_inputs, make_batch = flow.draw_inputs, flow.make_batch

        def tap_draws(gen):
            out = draw_inputs(gen)
            if len(self.draws) < n:
                self.draws.append(tree_map(lambda v: v.clone(), out))
            return out

        def tap_batch(*inputs):
            out = make_batch(*inputs)
            if len(self.batches) < n:
                self.batches.append(out)
            return out

        flow.draw_inputs, flow.make_batch = tap_draws, tap_batch

    def close(self):
        del self.flow.draw_inputs, self.flow.make_batch


def _batch_tensors(b) -> dict:
    out = {f"feats[{i}]": f for i, f in enumerate(b.feats)}
    out["root_idx"] = b.root_idx
    out["labels"] = b.labels.float()  # the label table follows the page dtype
    for i, blk in enumerate(b.blocks):
        out[f"blocks[{i}].edge_w"] = blk.edge_w
    return out


def _assert_same_batches(torch, got, want, what: str) -> int:
    """Bitwise equality of lean batches (bf16 weights by their bits)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches against {len(want)}")
    for step, (a, b) in enumerate(zip(got, want)):
        ta, tb = _batch_tensors(a), _batch_tensors(b)
        for key in ta:
            x, y = ta[key].cpu(), tb[key].cpu()
            if x.dtype == torch.bfloat16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{what}: step {step} {key} differs")
    return len(got)


def _assert_close(got, want, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))
    if got.shape != want.shape or not err <= TRAIN_TOL:
        raise AssertionError(f"{what}: losses {got.tolist()} against {want.tolist()}")
    return err


def train(torch, tmp: str, seed: int) -> dict:
    """Phase 5: the training path on the paged device lane, at full width."""
    from euler_tpu_torch.dataflow import DeviceSageFlow, SageDataFlow
    from euler_tpu_torch.datasets import skewed_weighted_graph
    from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import InferenceRuntime

    t0 = time.perf_counter()
    g = skewed_weighted_graph(TRAIN_NODES, TRAIN_GRAPH_SEED)
    edges = int(g.shards[0].adj[0].indptr[-1])
    graph_s = time.perf_counter() - t0
    prev_dtype = os.environ.get("EULER_TPU_PAGE_DTYPE")

    def lane(plane: str, device: str):
        """Flow + feature cache staged under EULER_TPU_PAGE_DTYPE=plane."""
        os.environ["EULER_TPU_PAGE_DTYPE"] = plane
        t = time.perf_counter()
        flow = DeviceSageFlow(g, fanouts=TRAIN_FANOUTS, batch_size=TRAIN_BATCH,
                              label_feature="label", layout="paged", page_size=PAGE_SIZE,
                              device=device)
        cache = DeviceFeatureCache(g, ["feat"], device=device)
        return flow, cache, time.perf_counter() - t

    def estimator(flow, cache, device: str, name: str):
        cfg = EstimatorConfig(model_dir=os.path.join(tmp, name), learning_rate=0.01,
                              optimizer="adam", log_steps=10**9, seed=seed)
        model = GraphSAGESupervised(TRAIN_FEAT, TRAIN_DIMS, 2)
        return Estimator(model, flow, cfg, feature_cache=cache, device=device)

    try:
        # (a) the main path: bf16 weight plane, kernel mode auto
        flow, cache, stage_s = lane("bf16", "cuda")
        if not flow._page_w_packed:
            raise AssertionError("the bf16 run did not stage a packed weight plane")
        est = estimator(flow, cache, "cuda", "main")
        tap = _Tap(flow, REF_STEPS)
        losses, launches, main_s = _run_counted(torch, est, TRAIN_STEPS)
        tap.close()
        # one hop kernel a hop, and none of kernels 2-4 it replaced; kernel
        # 1: layer 0 over hops 0 and 1, layer 1 over hop 0; its dx only for
        # layer 1, whose x (layer 0's hop-1 output) carries a gradient,
        # where layer 0's x are features
        want = {HOP_KERNEL: 2, **{name: 0 for name in PAGED_KERNELS},
                "gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
        for name, per_step in want.items():
            if launches[name] != per_step * TRAIN_STEPS:
                raise AssertionError(
                    f"train path launched {name} {launches[name]} times in "
                    f"{TRAIN_STEPS} steps, expected {per_step} a step"
                )
        if not np.isfinite(losses).all() or not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError(f"losses not finite and falling: {losses}")

        # (b) mode ref on the card: the plain versions, no kernel launch
        est_ref = estimator(flow, cache, "cuda", "ref")
        tap_ref = _Tap(flow, REF_STEPS)
        losses_ref, launches_ref, _ = _run_counted(torch, est_ref, REF_STEPS, "ref")
        tap_ref.close()
        if any(launches_ref.values()):
            raise AssertionError(f"mode ref launched kernels: {launches_ref}")
        same_ref = _assert_same_batches(torch, tap_ref.batches, tap.batches, "auto vs ref")
        err_ref = _assert_close(losses_ref, losses[:REF_STEPS], "auto vs ref")

        # (c) the port on the CPU, from the same draws
        flow_cpu, cache_cpu, _ = lane("bf16", "cpu")
        draws = iter([(r.cpu(), tuple(d.cpu() for d in ds)) for r, ds in tap.draws])
        flow_cpu.draw_inputs = lambda gen: next(draws)
        est_cpu = estimator(flow_cpu, cache_cpu, "cpu", "cpu")
        tap_cpu = _Tap(flow_cpu, CPU_STEPS)
        losses_cpu = est_cpu.train(CPU_STEPS, log=False, save=False)
        tap_cpu.close()
        same_cpu = _assert_same_batches(torch, tap_cpu.batches, tap.batches[:CPU_STEPS],
                                        "card vs CPU")
        err_cpu = _assert_close(losses_cpu, losses[:CPU_STEPS], "card vs CPU")
        del flow_cpu, cache_cpu, est_cpu

        # (d) the f32 weight plane: the hop kernel rounds f32 weights
        flow_f32, cache_f32, _ = lane("f32", "cuda")
        est_f32 = estimator(flow_f32, cache_f32, "cuda", "f32")
        tap_f32 = _Tap(flow_f32, F32_STEPS)
        losses_f32, launches_f32, _ = _run_counted(torch, est_f32, F32_STEPS)
        tap_f32.close()
        if (flow_f32._page_w_packed or launches_f32[HOP_KERNEL] != 2 * F32_STEPS
                or any(launches_f32[name] for name in PAGED_KERNELS)):
            raise AssertionError(f"f32 plane launches: {launches_f32}")
        same_f32 = _assert_same_batches(torch, tap_f32.batches, tap.batches[:F32_STEPS],
                                        "bf16 vs f32 plane")
        del flow_f32, cache_f32, est_f32

        # (e) the checkpoint, served by the port
        path = est.save()
        host_flow = SageDataFlow(g, ["feat"], fanouts=TRAIN_FANOUTS,
                                 rng=np.random.default_rng(seed))
        rt = InferenceRuntime(GraphSAGESupervised(TRAIN_FEAT, TRAIN_DIMS, 2), host_flow,
                              cfg=est.cfg, device="cuda")
        for k, v in est.model.state_dict().items():
            if not torch.equal(rt.params[k], v):
                raise AssertionError(f"served checkpoint differs from the trained {k}")
        emb = rt.predict(np.arange(1, 301, dtype=np.uint64))
        if emb.shape != (300, TRAIN_DIMS[-1]) or not np.isfinite(emb).all():
            raise AssertionError(f"bad served embeddings {emb.shape}")
    finally:
        if prev_dtype is None:
            os.environ.pop("EULER_TPU_PAGE_DTYPE", None)
        else:
            os.environ["EULER_TPU_PAGE_DTYPE"] = prev_dtype

    res = {"phase": "train", "nodes": TRAIN_NODES, "edges": edges,
           "pages": int(flow.page_start[-1]), "max_pages": flow.max_pages,
           "batch": TRAIN_BATCH, "fanouts": TRAIN_FANOUTS, "dims": TRAIN_DIMS,
           "steps": TRAIN_STEPS, "losses": losses, "launches": launches,
           "launches_f32_plane": launches_f32,
           "ref_on_card": {"batches_equal": same_ref, "losses": losses_ref, "max_rel_err": err_ref},
           "port_on_cpu": {"batches_equal": same_cpu, "losses": losses_cpu, "max_rel_err": err_cpu},
           "f32_plane": {"batches_equal": same_f32, "losses": losses_f32},
           "checkpoint": os.path.basename(path), "served": list(emb.shape),
           "graph_s": graph_s, "stage_s": stage_s, "main_run_s": main_s,
           "rtol": TRAIN_TOL}
    _emit(res)
    return {"estimator": est, "flow": flow, "launches": launches, "result": res}


def time_train_steps(torch, est, card: str) -> dict:
    """Median step time (host clock, each step ends synchronised: train()
    brings its losses to the host), then the device busy share over
    PROFILED_STEPS back-to-back steps and the top device ops."""
    est.train(2, log=False, save=False)
    times = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        est.train(1, log=False, save=False)
        times.append((time.perf_counter() - t) * 1e3)
    def window():
        est.train(PROFILED_STEPS, log=False, save=False)
        torch.cuda.synchronize()

    counts = {}
    dev, wall_ms = _profile_window(torch, window, counts=counts)
    busy_ms = sum(dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    copies = sum(n for k, n in counts.items() if k.startswith(("Memcpy", "Memset")))
    res = {"phase": "train_timing", "card": card, "median_step_ms": statistics.median(times),
           "min_step_ms": min(times), "max_step_ms": max(times), "steps": TIMED_STEPS,
           "profiled_steps": PROFILED_STEPS, "wall_ms_per_step": wall_ms / PROFILED_STEPS,
           "device_ms_per_step": busy_ms / PROFILED_STEPS,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           # profiler kernel records a step; memcpy and memset records apart
           "kernel_launches_per_step": (sum(counts.values()) - copies) / PROFILED_STEPS,
           "copies_per_step": copies / PROFILED_STEPS,
           "hop_kernel_us_per_step": sum(
               v for k, v in dev.items() if "paged_sample_hop_kernel" in k) / PROFILED_STEPS,
           "kernel1_us_per_step": _kernel1_us(dev, PROFILED_STEPS),
           "top_device_us_per_step": {k[:60]: v / PROFILED_STEPS for k, v in top}}
    _emit(res)
    return res


def _on_card(counts: dict) -> dict:
    """The port's kernels in a window's profiler records, by name, with
    kernel 1's bf16-input launches apart."""
    on_card = {kernel: sum(n for name, n in counts.items() if tag in name)
               for kernel, tag in CARD_KERNELS.items()}
    on_card["gather_weighted_sum_bf16_x"] = sum(
        n for name, n in counts.items() if CARD_KERNELS["gather_weighted_sum"] in name
        and "bfloat16" in name)
    return on_card


def _call_window(torch, est, k: int, calls: int, card: str, what: str, want: dict) -> dict:
    """`calls` calls of k steps (`est.train(k)`, each ending synchronised:
    train drains its losses): the median step (a call's time over k),
    then over one profiled call the device time and idle share a step and
    the port's kernels run on the card a step (`_on_card`). Those are held
    to `want` a step, as the card saw them, independently of the
    wrappers' counts (which a replay adds from its capture): CUPTI now
    and then drops a record from a window and never adds one, so no
    profiled call may show more than k·want of a kernel, and one at least
    must show exactly k·want of each."""
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        est.train(k, log=False, save=False)
        times.append((time.perf_counter() - t) * 1e3 / k)

    def window():
        est.train(k, log=False, save=False)
        torch.cuda.synchronize()

    counts, every = {}, []
    dev, wall_ms = _profile_window(torch, window, counts=counts, every=every)
    busy_ms = sum(dev.values()) / 1e3
    copies = sum(n for name, n in counts.items() if name.startswith(("Memcpy", "Memset")))
    want = {name: want.get(name, 0) * k for name in _on_card({})}
    seen = [_on_card(c) for c in every]
    if (any(s[name] > n for s in seen for name, n in want.items())
            or not any(s == want for s in seen)):
        raise AssertionError(f"{what}: the port's kernels on the card in the profiled calls of "
                             f"{k} steps were {seen}, expected {want} in one at least and no "
                             f"more in any")
    on_card = {name: n / k for name, n in _on_card(counts).items()}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    h2d_us = sum(us for name, us in dev.items() if name.startswith("Memcpy HtoD"))
    return {"what": what, "card": card, "steps_per_call": k, "calls": calls,
            "h2d_ms_per_step": h2d_us / 1e3 / k,
            "median_step_ms": statistics.median(times), "min_step_ms": min(times),
            "max_step_ms": max(times), "wall_ms_per_step": wall_ms / k,
            "device_ms_per_step": busy_ms / k, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_step": (sum(counts.values()) - copies) / k,
            "copies_per_step": copies / k, "port_kernels_on_card_per_step": on_card,
            "port_kernels_on_card_by_window": seen,
            "captures": est.captures,
            "top_device_us_per_step": {name[:60]: us / k for name, us in top}}


def _replay_launches(est, launches: dict, eager: dict, before: dict | None = None) -> dict:
    """The bookkeeping of a grouped run's counted launches: its eager
    steps' (`eager`) plus each captured graph's recorded launches times
    its replays since the counts were reset (`before`: the graphs'
    replays then); returns the replays by graph. A replay adds its
    capture's launches, so this holds by construction; the evidence that
    replays launch the kernels is the profiler's count (`_call_window`)."""
    want, replays = dict(eager), []
    for key, g in est._graphs.items():
        replays.append(g.replays - (before or {}).get(key, 0))
        for name, n in g.launches.items():
            want[name] = want.get(name, 0) + n * replays[-1]
    _expect_launches(launches, want, "replayed graphs")
    return {"graphs": len(est._graphs), "replays": replays,
            "launches_per_replay": [{n: c for n, c in g.launches.items() if c}
                                    for g in est._graphs.values()]}


def train_grouped(torch, trained: dict, tmp: str, seed: int, card: str) -> dict:
    """Phase 5 at steps_per_call = GROUP_K: TRAIN_STEPS steps (one call of
    16 and a remainder of 4) from the main run's init, each step after
    the first a replay of the captured step: the main run's launches a
    step, losses within TRAIN_TOL of the K = 1 run's; then calls of 16
    steps at K = 1 and K = 16, timed the same way."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised

    est1 = trained["estimator"]
    cfg = EstimatorConfig(model_dir=os.path.join(tmp, "grouped"), learning_rate=0.01,
                          optimizer="adam", log_steps=10**9, seed=seed, steps_per_call=GROUP_K)
    est = Estimator(GraphSAGESupervised(TRAIN_FEAT, TRAIN_DIMS, 2), trained["flow"], cfg,
                    feature_cache=est1.feature_cache, device="cuda")
    ops.reset_launch_counts()
    losses = est.train(TRAIN_STEPS, log=False, save=False)
    launches = ops.launch_counts()
    per_step = {HOP_KERNEL: 2, "gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
    _expect_launches(launches, {k: n * TRAIN_STEPS for k, n in per_step.items()},
                     f"the device lane at K = {GROUP_K}")
    # each capture's first step ran eagerly
    replays = _replay_launches(est, launches,
                               {k: n * est.captures for k, n in per_step.items()})
    err = _assert_close(losses, trained["result"]["losses"], f"K = {GROUP_K} vs K = 1")
    res = {"phase": "train_grouped", "card": card, "steps": TRAIN_STEPS,
           "steps_per_call": GROUP_K, "losses": losses, "max_rel_err": err,
           "bitwise": losses == trained["result"]["losses"], "launches": launches,
           "captures": est.captures, **replays,
           "k1": _call_window(torch, est1, GROUP_K, GROUP_CALLS, card, "K = 1", per_step),
           f"k{GROUP_K}": _call_window(torch, est, GROUP_K, GROUP_CALLS, card,
                                       f"K = {GROUP_K}", per_step)}
    _emit(res)
    return {"launches": launches, "result": res}


def _paged_calls(flow, gen) -> tuple[list, list]:
    """What one flow.sample hands the paged ops, run through the hop's
    plain version (kernel mode 'ref', which launches nothing): ([(kernel
    name, args)] of kernels 2-4 in the order the composition calls them —
    per hop count, neighbour gather, weight gather —, [(tables, cur, draw)]
    of paged_sample_hop per hop)."""
    import euler_tpu_torch.dataflow.device as device_mod
    import euler_tpu_torch.ops.paged as paged_mod
    from euler_tpu_torch import ops

    calls, hops = [], []
    saved = {name: getattr(paged_mod, name) for name in PAGED_KERNELS}
    hop = device_mod.paged_sample_hop

    def wrap(name):
        def inner(*args, **kw):
            calls.append((name, args))
            return saved[name](*args, **kw)
        return inner

    def hop_tap(t, cur, draw, impl):
        hops.append((t, cur, draw))
        return hop(t, cur, draw, impl)

    try:
        for name in saved:
            setattr(paged_mod, name, wrap(name))
        device_mod.paged_sample_hop = hop_tap
        ops.set_kernel_mode("ref")
        flow.sample(gen)
    finally:
        ops.set_kernel_mode("auto")
        device_mod.paged_sample_hop = hop
        for name, fn in saved.items():
            setattr(paged_mod, name, fn)
    return calls, hops


def _sectors(torch, word_idx, words_per_item: int = 1) -> int:
    """Distinct 32-byte sectors that reading `words_per_item` consecutive
    4-byte words from each index touches."""
    per = SECTOR_BYTES // 4
    first = word_idx.long().reshape(-1) // per
    span = max(1, -(-words_per_item // per))
    return int(torch.unique(first[:, None] + torch.arange(span, device=first.device)).numel())


def time_paged_kernels(torch, calls, card: str) -> list:
    """Each of kernels 2-4 at the two hops' shapes of one train step, with
    the inputs the hop's plain version gives them on the main path
    (`_paged_calls`; on the card the hop kernel does their work), the tables
    cycled through copies past the L2 as the step finds them in device
    memory; beside its plain version, `flat[fidx]` for paged_gather, and
    the bound: distinct sectors read (each input byte read once at the
    card's 32-byte granularity) plus the index, random and output words,
    over 3.35 TB/s. `warm_ms` repeats one input set, its table left in
    the L2, which the step's three planes (~34 MB) can fit."""
    from euler_tpu_torch.ops import (
        paged_cdf_count, paged_cdf_count_ref, paged_gather, paged_gather_dequant,
        paged_gather_dequant_ref, paged_gather_ref,
    )

    hop_of = {}
    rows = []
    for name, args in calls:
        hop = hop_of[name] = hop_of.get(name, -1) + 1
        table = args[0]
        copies = min(16, max(2, math.ceil(2 * L2_BYTES / (table.numel() * 4))))
        tables = [table] + [table.clone() for _ in range(copies - 1)]
        if name == "paged_cdf_count":
            page, r, p = args[1], args[2], args[3]
            n = page.numel()
            sets = [(t, page.clone(), r.clone()) for t in tables]
            kern = lambda t, pg, rb: paged_cdf_count(t, pg, rb, p, "cuda")  # noqa: E731
            plain = lambda t, pg, rb: paged_cdf_count_ref(t, pg, rb, p)  # noqa: E731
            lib = None
            nbytes = _sectors(torch, page.long() * p, p) * SECTOR_BYTES + 3 * 4 * n
            ops_count = n * p
            shape = tuple(page.shape)
        else:
            fidx = args[1]
            n = fidx.numel()
            sets = [(t, fidx.clone()) for t in tables]
            if name == "paged_gather":
                kern = lambda t, f: paged_gather(t, f, "cuda")  # noqa: E731
                plain = paged_gather_ref
                lib = lambda t, f: t.view(-1)[f]  # noqa: E731
                words = fidx
            else:
                kern = lambda t, f: paged_gather_dequant(t, f, "cuda")  # noqa: E731
                plain = paged_gather_dequant_ref
                lib = None
                words = fidx >> 1
            nbytes = _sectors(torch, words) * SECTOR_BYTES + 2 * 4 * n
            ops_count = n
            shape = tuple(fidx.shape)
        iters = max(200, 2 * copies)
        tk = _time_ms(torch, kern, sets, iters)
        tp = _time_ms(torch, plain, sets, iters)
        tl = _time_ms(torch, lib, sets, iters) if lib is not None else None
        warm = _time_ms(torch, kern, sets[:1], iters)
        if tk["device_ms"] <= 0:
            raise AssertionError(f"the profiler saw no device time for {name}")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_count / F32_FLOPS * 1e3
        rows.append({"kernel": name, "hop": hop, "shape": shape, "draws": n,
                     "table_bytes": table.numel() * 4, "input_sets": copies,
                     "ms": tk["device_ms"], "plain_ms": tp["device_ms"],
                     "library_ms": tl["device_ms"] if tl else None,
                     "warm_ms": warm["device_ms"],
                     "loop_ms": {"kernel": tk["loop_ms"], "plain": tp["loop_ms"],
                                 "library": tl["loop_ms"] if tl else None},
                     "device_kernels": {"kernel": tk["device_kernels"],
                                        "plain": tp["device_kernels"]},
                     "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "iters": iters})
        del sets, tables
    torch.cuda.empty_cache()
    _emit({"phase": "paged_kernel_timing", "card": card, "shapes": rows})
    return rows


def _hop_bytes(torch, t, cur, draw, idx) -> tuple[int, int]:
    """(bytes, integer compares) one hop needs for these inputs. Bytes: the
    distinct 32-byte sectors of every table word it reads (the row
    headers, the page bounds of rows of two pages or more, the chosen
    pages' CDF words, the neighbour and weight words of the live draws),
    plus the row ids, the draws and the three outputs once each. Compares:
    a draw's P CDF words and its row's bounds. idx: the hop's slot output."""
    from euler_tpu_torch.ops import paged_page_search

    w, k = draw.shape
    c = cur.long()
    deg, ps = t.deg[c].long(), t.page_start[c].long()
    npages = t.page_start[c + 1].long() - ps
    nbytes = (_sectors(torch, c) + _sectors(torch, torch.cat([c, c + 1]))) * SECTOR_BYTES
    nbytes += 4 * w + 4 * w * k + (4 + 4 + (0 if t.unit_w else 2)) * w * k
    p = t.page_size
    compares = 0
    if not t.unit_w:
        multi = npages > 1
        compares = w * k * p + k * int(npages[multi].sum())
        if bool(multi.any()):
            lens = npages[multi]
            first = torch.repeat_interleave(ps[multi], lens)
            seg = torch.arange(int(lens.sum()), device=c.device) - torch.repeat_interleave(
                torch.cumsum(lens, 0) - lens, lens)
            nbytes += _sectors(torch, 2 * (first + seg), 2) * SECTOR_BYTES
        pg = paged_page_search(t.page_bound, ps.int(), npages.int(), draw, t.search_iters).long()
        pgc = torch.minimum(pg, (npages[:, None] - 1).clamp_min(0))
        page = (ps[:, None] + pgc).clamp_max(t.page_cap)
        nbytes += _sectors(torch, page * p, p) * SECTOR_BYTES
    fidx = (ps[:, None] * p + idx.long()).clamp_max(t.slot_cap)
    live = fidx[(deg > 0)[:, None].expand_as(fidx)]
    nbytes += _sectors(torch, live) * SECTOR_BYTES if live.numel() else 0
    if not t.unit_w and live.numel():
        nbytes += _sectors(torch, live >> 1 if t.w_packed else live) * SECTOR_BYTES
    return nbytes, compares


def time_hop_kernel(torch, hops, card: str) -> list:
    """paged_sample_hop at each hop of one train step, on the main path's
    own tables, rows and draws (`_paged_calls`), first held bitwise against
    its plain version there; then timed with the tables cycled through
    copies past the L2 (`ms`) and on one copy left in the L2 (`warm_ms`),
    beside its plain version (`plain_ms`), the composition of kernels 2-4
    it replaced in mode 'cuda' (`composition_ms`, with its device ops per
    call) and its bound: `_hop_bytes` over 3.35 TB/s, or its integer
    compares over 67 T/s, whichever is larger."""
    from euler_tpu_torch.ops import paged_sample_hop, paged_sample_hop_ref
    from euler_tpu_torch.ops.paged import _compose_hop

    fields = ("deg", "page_start", "pages2d", "page_bound", "page_q2d", "page_w2d")
    rows = []
    for hop, (t, cur, draw) in enumerate(hops):
        want = paged_sample_hop_ref(t, cur, draw)
        bad = _hop_mismatches(torch, paged_sample_hop(t, cur, draw, "cuda"), want)
        if bad:
            raise AssertionError(f"{HOP_KERNEL} differs from its plain version at hop {hop}: {bad}")
        table_bytes = sum(getattr(t, f).numel() * getattr(t, f).element_size()
                          for f in fields if getattr(t, f) is not None)
        copies = min(16, max(2, math.ceil(2 * L2_BYTES / table_bytes)))
        tables = [t] + [t._replace(**{f: getattr(t, f).clone() for f in fields
                                      if getattr(t, f) is not None})
                        for _ in range(copies - 1)]
        sets = [(ti, cur.clone(), draw.clone()) for ti in tables]
        kern = lambda t, c, d: paged_sample_hop(t, c, d, "cuda")  # noqa: E731
        comp = lambda t, c, d: _compose_hop(t, c, d, "cuda")  # noqa: E731
        iters = max(200, 2 * copies)
        # the plain hop and the superseded composition issue dozens of
        # small launches a call: fewer calls time them as well
        slow_iters = max(HOP_SLOW_ITERS, copies)
        tk = _time_ms(torch, kern, sets, iters)
        tp = _time_ms(torch, paged_sample_hop_ref, sets, slow_iters)
        tc = _time_ms(torch, comp, sets, slow_iters)
        warm = _time_ms(torch, kern, sets[:1], iters)
        if tk["device_ms"] <= 0:
            raise AssertionError(f"the profiler saw no device time for {HOP_KERNEL}")
        w, k = draw.shape
        nbytes, compares = _hop_bytes(torch, t, cur, draw, want[2])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = compares / F32_FLOPS * 1e3
        rows.append({"kernel": HOP_KERNEL, "hop": hop, "shape": [w, k], "draws": w * k,
                     "table_bytes": table_bytes, "input_sets": copies,
                     "ms": tk["device_ms"], "warm_ms": warm["device_ms"],
                     "plain_ms": tp["device_ms"], "composition_ms": tc["device_ms"],
                     "library_ms": None,
                     "device_ops_per_call": {"kernel": tk["device_ops_per_call"],
                                             "plain": tp["device_ops_per_call"],
                                             "composition": tc["device_ops_per_call"]},
                     "loop_ms": {"kernel": tk["loop_ms"], "plain": tp["loop_ms"],
                                 "composition": tc["loop_ms"]},
                     "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "iters": iters, "slow_iters": slow_iters})
        del sets, tables
    torch.cuda.empty_cache()
    _emit({"phase": "hop_kernel_timing", "card": card, "shapes": rows})
    return rows


def check_topk_kernel(torch, gen) -> dict:
    """Phase 3, retrieval: paged_topk_score bitwise against its plain
    version on the card, for sig12 and raw f32 operands, under both
    templates: mul/add in every case, FMA where `products_exact` accepts the
    operands. The guard must accept the sig12 sweep and reject raw f32 and
    sig12 operands scaled so that their products underflow or overflow."""
    from euler_tpu_torch.ops import (
        operand_range,
        paged_topk_score,
        paged_topk_score_ref,
        products_exact,
    )
    from euler_tpu_torch.ops.paged import as_lane_rows

    dev = torch.device("cuda")
    cases, failed, templates = 0, [], {}

    def sig12(t):
        return (t.view(torch.int32) & -4096).view(torch.float32)

    def guard(x, q):
        return products_exact(operand_range(q.cpu().numpy()), operand_range(x.cpu().numpy()))

    def one(label, want, exact, run):
        """`run(fma)` scores under one template; both when `exact`."""
        nonlocal cases
        ran = []
        for fma in (False, True) if exact else (False,):
            got = run(fma)
            torch.cuda.synchronize()
            cases += 1
            ran.append("fma" if fma else "mul_add")
            n, _ = _mismatch(torch, got, want)
            if n or got.shape != want.shape:
                failed.append({"case": label, "template": ran[-1], "mismatches": n})
        templates[label] = "+".join(ran)

    for dp in TOPK_SWEEP_DP:
        for nrows in TOPK_SWEEP_ROWS:
            for operands in ("sig12", "f32"):
                x = torch.randn(nrows * dp + 37, generator=gen, device=dev)  # a padded tail
                q = torch.randn(max(TOPK_SWEEP_B), dp, generator=gen, device=dev)
                if operands == "sig12":
                    x, q = sig12(x), sig12(q)
                exact = guard(x[: nrows * dp], q)
                if exact != (operands == "sig12"):
                    failed.append({"case": f"dp={dp} nrows={nrows} {operands}",
                                   "guard": exact})
                t2d = as_lane_rows(x)
                for b in TOPK_SWEEP_B:
                    one(f"dp={dp} nrows={nrows} B={b} {operands}",
                        paged_topk_score_ref(t2d, q[:b], nrows, dp), exact,
                        lambda fma: paged_topk_score(t2d, q[:b], nrows, dp, "cuda",
                                                     exact_products=fma))
    # sig12 operands whose products leave the normal range: the guard
    # rejects them, and the mul/add template stays bitwise; FMA's
    # disagreement there is counted, not required
    fma_differs = {}
    for what, scale in (("underflow", 2.0**-70), ("overflow", 2.0**64)):
        x = sig12(torch.randn(1001 * 128, generator=gen, device=dev)) * scale
        q = sig12(torch.randn(64, 128, generator=gen, device=dev)) * scale
        if guard(x, q):
            failed.append({"case": what, "guard": True})
        for b in (1, 16, 64):
            want = paged_topk_score_ref(x, q[:b], 1001, 128)
            one(f"dp=128 nrows=1001 B={b} sig12 {what}", want, False,
                lambda fma: paged_topk_score(x, q[:b], 1001, 128, "cuda", exact_products=fma))
            got = paged_topk_score(x, q[:b], 1001, 128, "cuda", exact_products=True)
            fma_differs[f"{what} B={b}"] = _mismatch(torch, got, want)[0]
    # a table that is not 16-byte aligned: the 4-byte load path at dp = 128
    x = sig12(torch.randn(1000 * 128 + 1, generator=gen, device=dev))[1:]
    q = sig12(torch.randn(5, 128, generator=gen, device=dev))
    one("dp=128 nrows=1000 B=5 unaligned", paged_topk_score_ref(x, q, 1000, 128), guard(x, q),
        lambda fma: paged_topk_score(x, q, 1000, 128, "cuda", exact_products=fma))
    # 64-bit offsets: nrows * dp and B * nrows pass 2^31; the plain version
    # scores the last rows only (rows are scored independently)
    nrows, dp, b, tail = 2**24 + 3, 128, 130, 4099
    x = sig12(torch.randn(nrows * dp, generator=gen, device=dev))
    q = sig12(torch.randn(b, dp, generator=gen, device=dev))
    one(f"dp={dp} nrows={nrows} B={b} (int64 offsets), last {tail} rows",
        paged_topk_score_ref(x[-tail * dp:], q, tail, dp), True,
        lambda fma: paged_topk_score(x, q, nrows, dp, "cuda",
                                     exact_products=fma)[:, -tail:].contiguous())
    del x, q
    torch.cuda.empty_cache()
    by_template = {}
    for ran in templates.values():
        for t in ran.split("+"):
            by_template[t] = by_template.get(t, 0) + 1
    res = {"phase": "kernel_check", "kernel": "paged_topk_score", "cases": cases,
           "check": "bitwise", "max_abs_err": 0.0 if not failed else None,
           "dp": list(TOPK_SWEEP_DP), "nrows": list(TOPK_SWEEP_ROWS),
           "B": list(TOPK_SWEEP_B), "cases_by_template": by_template,
           "fma_mismatches_where_rejected": fma_differs, "templates": templates,
           "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"paged_topk_score disagrees with its plain version: {failed}")
    return res


def _select_scores(torch, gen, nrows: int):
    """[SELECT_BP, nrows] scores that stress the selection: rows 0-3
    rounded to quarters (ties everywhere), row 4 +0.0 and -0.0 with a
    third of the rows -inf, row 5 a run of 90 equal maxima across each
    tile border, and the bucket's padding rows NaN (never read)."""
    s = torch.randn(SELECT_BP, nrows, generator=gen, device="cuda")
    s[:4] = (s[:4] * 4).round() / 4
    u = torch.rand(nrows, generator=gen, device="cuda")
    s[4] = torch.where(u < 0.33, 0.0, torch.where(u < 0.66, -0.0, float("-inf")))
    for t in SELECT_TILES:
        if nrows > t:
            s[5, max(0, t - 45):t + 45] = 100.0
    s[SELECT_B:] = float("nan")
    return s


def check_topk_select(torch, gen) -> dict:
    """Phase 3, retrieval: paged_topk_select bitwise against its plain
    version, and stage 1 plus stage 2 (`topk_keys`) bitwise against
    `canonical_topk` over the whole masked scores, for k in {1, 32, 100,
    T, T + 1, > nrows}, nrows in SELECT_ROWS (not multiples of T but
    one), masks that are absent, all false, leave 3 rows, or random, and
    SELECT_B real queries of a bucket of SELECT_BP."""
    from euler_tpu_torch.ops import paged_topk_select, paged_topk_select_ref, topk_keys
    from euler_tpu_torch.retrieval.topk import canonical_topk

    cases, failed = 0, []
    for nrows in SELECT_ROWS:
        s = _select_scores(torch, gen, nrows)
        few = torch.zeros(nrows, dtype=torch.bool, device="cuda")
        few[[0, nrows // 2, nrows - 1]] = True
        masks = {"none": None, "all_false": torch.zeros_like(few), "few": few,
                 "random": torch.rand(nrows, generator=gen, device="cuda") < 0.5}
        for tile in SELECT_TILES:
            for k in sorted({1, 32, 100, tile, tile + 1, nrows + 1}):
                keff = min(k, nrows)
                for mname, mask in masks.items():
                    label = f"nrows={nrows} T={tile} k={k} mask={mname}"
                    got = paged_topk_select(s, SELECT_B, k, mask, tile, "cuda")
                    want = paged_topk_select_ref(s, SELECT_B, k, mask, tile)
                    vals, idx = topk_keys(got.reshape(SELECT_B, -1), keff)
                    masked = s[:SELECT_B] if mask is None else torch.where(
                        mask[None, :], s[:SELECT_B], float("-inf"))
                    cvals, cidx = canonical_topk(masked, keff)
                    torch.cuda.synchronize()
                    cases += 1
                    n1 = int((got != want).sum()) if got.shape == want.shape else -1
                    n2 = int((idx != cidx).sum()) + _mismatch(torch, vals, cvals)[0]
                    if n1 or n2:
                        failed.append({"case": label, "stage1_mismatches": n1,
                                       "answer_mismatches": n2})
        del s, masks
    res = {"phase": "kernel_check", "kernel": "paged_topk_select", "cases": cases,
           "check": "bitwise", "max_abs_err": 0.0 if not failed else None,
           "nrows": list(SELECT_ROWS), "tiles": list(SELECT_TILES),
           "queries": f"{SELECT_B} of a bucket of {SELECT_BP}", "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"paged_topk_select disagrees with its plain version: {failed}")
    return res


def retrieval_data(seed: int) -> dict:
    """The retrieval cell's corpus and queries, from `seed`: RETR_ROWS
    unique random u64 ids, RETR_DIM-wide standard normal f32 vectors, a
    `cat` attribute in 0..3. RETR_HOT vectors are each copied to
    RETR_COPIES - 1 more random rows, and the first queries of the pool
    are those vectors, so the top k of those queries ends inside a group
    of equal scores: ties at the k-th place."""
    rng = np.random.default_rng(seed + 7)
    ids = rng.integers(0, 2**64 - 1, size=RETR_ROWS, dtype=np.uint64)
    if len(np.unique(ids)) != RETR_ROWS:
        raise AssertionError("the seeded ids are not unique")
    vectors = rng.standard_normal((RETR_ROWS, RETR_DIM), dtype=np.float32)
    cat = rng.integers(0, 4, RETR_ROWS).astype(np.int64)
    rows = rng.choice(RETR_ROWS, size=(RETR_HOT, RETR_COPIES), replace=False)
    vectors[rows[:, 1:]] = vectors[rows[:, :1]]
    pool = rng.standard_normal((RETR_BUCKETS[-1], RETR_DIM), dtype=np.float32)
    pool[:RETR_HOT] = vectors[rows[:, 0]]
    return {"ids": ids, "vectors": vectors, "cat": cat, "pool": pool}


def _oracle_job(job):
    """One worker's share of the oracle: `numpy_topk_oracle` over the whole
    corpus, which the worker makes again from the seed, for some queries."""
    from euler_tpu_torch.retrieval import numpy_topk_oracle

    seed, filtered, rows = job
    data = retrieval_data(seed)
    keep = np.isin(data["cat"], [0, 2]) if filtered else None
    out = numpy_topk_oracle(data["ids"], data["vectors"], data["pool"][rows], RETR_K,
                            metric="cosine", mask=keep)
    return {(filtered, row): [a[j] for a in out] for j, row in enumerate(rows)}


def _oracle_answers(seed: int, rows: list) -> dict:
    """{(filtered, query row): the oracle's (ids, scores, valid) rows}, the
    queries split over one spawned process per core: the oracle's
    left-to-right NumPy scoring of 1 M rows is seconds per query."""
    import multiprocessing

    workers = max(1, min(8, os.cpu_count() or 1))
    per = max(1, -(-2 * len(rows) // workers))
    jobs = [(seed, filtered, rows[i:i + per])
            for filtered in (0, 1) for i in range(0, len(rows), per)]
    with multiprocessing.get_context("spawn").Pool(min(workers, len(jobs))) as procs:
        parts = procs.map(_oracle_job, jobs, chunksize=1)
    return {key: val for part in parts for key, val in part.items()}


def _same_answer(a, b) -> bool:
    """Bitwise equality of two (ids, scores, valid) answers."""
    return all(x.shape == y.shape and x.dtype == y.dtype
               and np.array_equal(x.view(np.uint8), y.view(np.uint8)) for x, y in zip(a, b))


def retrieve(torch, tmp: str, seed: int) -> dict:
    """Phase 6: exact filtered top-K at full width, from a checkpoint."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.retrieval import EmbeddingCorpus, merge_topk
    from euler_tpu_torch.retrieval.server import _CorpusEngine
    from euler_tpu_torch.training.checkpoint import CheckpointStore

    t0 = time.perf_counter()
    data = retrieval_data(seed)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model_dir = os.path.join(tmp, "retrieval")
    CheckpointStore(model_dir).save_leaves(RETR_STEP, [data["vectors"]], [])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    corpus = EmbeddingCorpus.from_checkpoint(model_dir, data["ids"], attrs={"cat": data["cat"]},
                                             metric="cosine")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = _CorpusEngine(corpus).warm(RETR_K)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    filters = (None, json.dumps(RETR_FILTER))
    pool = data["pool"]

    def run(eng):
        return {(b, f): eng.retrieve(pool[:b], RETR_K, f) for b in RETR_BUCKETS for f in filters}

    # the main path: launch counts reset just before and read just after
    torch.cuda.reset_peak_memory_stats()
    templates_before = dict(engine.index.templates)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    answers = run(engine)
    main_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    templates = {k: v - templates_before[k] for k, v in engine.index.templates.items()}
    want = {"paged_topk_score": len(answers), "paged_topk_select": len(answers)}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"retrieve path launches {launches}, expected one paged_topk_score "
                             f"and one paged_topk_select launch for each of {len(answers)} "
                             "searches")
    n_filtered = int(corpus.condition_mask(RETR_FILTER).sum())
    for (b, f), (ids, scores, valid) in answers.items():
        if ids.shape != (b, RETR_K) or not valid.all() or not np.isfinite(scores).all():
            raise AssertionError(f"bucket {b} filter {f}: {ids.shape} answers, "
                                 f"{int(valid.sum())} valid")

    # ties at the k-th place: the hot queries' k-th score recurs past k
    ties = 0
    for f in filters:
        ids, scores, _ = answers[(RETR_BUCKETS[-1], f)]
        ties += int(sum(scores[i, -1] == scores[i, -2] for i in range(RETR_HOT)))
    if not ties:
        raise AssertionError("no hot query has a tie at the k-th place")

    # kernel mode ref on the card: the plain scorer, no kernel launch
    engine_ref = _CorpusEngine(corpus, impl="ref")
    ops.reset_launch_counts()
    answers_ref = run(engine_ref)
    if any(ops.launch_counts().values()):
        raise AssertionError(f"impl ref launched kernels: {ops.launch_counts()}")
    for key, ans in answers.items():
        if not _same_answer(ans, answers_ref[key]):
            raise AssertionError(f"bucket {key[0]} filter {key[1]}: auto differs from ref")
    del engine_ref

    # the independent NumPy oracle: every query of buckets up to ORACLE_BUCKET
    # and a subset of the largest bucket's, on the raw rows in input order
    t0 = time.perf_counter()
    picked = list(range(RETR_ORACLE_BUCKET)) + list(RETR_ORACLE_EXTRA)
    want = _oracle_answers(seed, picked)
    oracle_queries = 0
    for filtered, f in enumerate(filters):
        for b in RETR_BUCKETS:
            got = answers[(b, f)]
            for row in range(b):
                if row not in picked:
                    continue
                if not _same_answer([a[row] for a in got], want[(filtered, row)]):
                    raise AssertionError(f"bucket {b} filter {f} query {row}: differs "
                                         "from numpy_topk_oracle")
                oracle_queries += 1
    oracle_s = time.perf_counter() - t0

    # two row shards merged canonically == the single shard
    shards = [_CorpusEngine(corpus.shard(p, 2)) for p in range(2)]
    ops.reset_launch_counts()
    for key, ans in answers.items():
        b, f = key
        parts = [e.retrieve(pool[:b], RETR_K, f) for e in shards]
        if not _same_answer(merge_topk(parts, RETR_K), ans):
            raise AssertionError(f"bucket {b} filter {f}: 2-shard merge differs")
    fleet_launches = {k: v for k, v in ops.launch_counts().items() if v}
    del shards
    torch.cuda.empty_cache()

    res = {"phase": "retrieve", "rows": RETR_ROWS, "dim": RETR_DIM, "metric": "cosine",
           "k": RETR_K, "buckets": list(RETR_BUCKETS), "filter": RETR_FILTER,
           "filtered_rows": n_filtered, "version": corpus.version, "searches": len(answers),
           "launches": launches, "scorer_templates": templates, "ties_at_k": ties,
           "ref_on_card": "bitwise",
           "oracle": {"queries": oracle_queries, "check": "bitwise"},
           "fleet_2_shards": {"check": "bitwise", "launches": fleet_launches},
           "peak_device_bytes": peak_bytes, "data_s": data_s, "save_s": save_s,
           "build_s": build_s, "stage_s": stage_s, "main_run_s": main_s,
           "oracle_s": oracle_s}
    _emit(res)
    return {"engine": engine, "pool": pool, "launches": launches, "templates": templates,
            "result": res, "data": data, "model_dir": model_dir}


def time_retrieve(torch, engine, pool, card: str) -> dict:
    """Per bucket, filtered and unfiltered: the median search latency on
    the host clock (a search returns host numpy, so it ends
    synchronised), then the device time per search over RETR_PROFILED
    back-to-back searches, split into the scoring kernel, the selection
    kernel, the rest of the selection (stage 2: `torch.topk` over the
    candidates and the key decoding) and the copies, and the device idle
    share."""
    out = {}
    for b in RETR_BUCKETS:
        for f in (None, json.dumps(RETR_FILTER)):
            q = pool[:b]
            for _ in range(3):
                engine.retrieve(q, RETR_K, f)
            lat = []
            for _ in range(RETR_TIMED):
                t = time.perf_counter()
                engine.retrieve(q, RETR_K, f)
                lat.append((time.perf_counter() - t) * 1e3)
            def window(q=q, f=f):
                for _ in range(RETR_PROFILED):
                    engine.retrieve(q, RETR_K, f)
                torch.cuda.synchronize()

            dev, wall_ms = _profile_window(torch, window)
            split = {"kernel": 0.0, "select_kernel": 0.0, "select_rest": 0.0, "h2d": 0.0,
                     "d2h": 0.0}
            for name, us in dev.items():
                if "paged_topk_score_kernel" in name:
                    split["kernel"] += us
                elif "paged_topk_select_kernel" in name:
                    split["select_kernel"] += us
                elif "HtoD" in name:
                    split["h2d"] += us
                elif "DtoH" in name:
                    split["d2h"] += us
                else:
                    split["select_rest"] += us
            busy_ms = sum(dev.values()) / 1e3
            out[f"{b}{' filtered' if f else ''}"] = {
                "median_ms": statistics.median(lat), "min_ms": min(lat), "max_ms": max(lat),
                "reps": RETR_TIMED, "wall_ms_per_search": wall_ms / RETR_PROFILED,
                "device_ms_per_search": busy_ms / RETR_PROFILED,
                "device_ms_split": {k: v / 1e3 / RETR_PROFILED for k, v in split.items()},
                "device_idle_share": 1.0 - busy_ms / wall_ms,
            }
    res = {"phase": "retrieve_latency", "card": card, "k": RETR_K, "buckets": out}
    _emit(res)
    return res


def time_topk_kernel(torch, engine, pool, card: str) -> list:
    """paged_topk_score and paged_topk_select at each bucket of the
    retrieve path, on the staged 1 M-row table with the path's own
    prepared queries.

    The scorer: `ms` under the template the path runs (FMA where
    `products_exact` holds), `mul_add_ms` under the other, on the whole
    table (512 MB: each call streams it past the 50 MB L2); `warm_ms` on its
    first RETR_WARM_ROWS rows (32 MB), left in the L2 by the call before.
    Beside it the plain version, torch.matmul(q, x.T) with TF32 off (not
    bitwise: a yardstick) and the bound: the corpus, the queries and the
    scores each moved once over 3.35 TB/s, or 2 * B * nrows * dp operations
    over 67 T/s.

    The selection, on those scores (as on the path, they were just written,
    so at small buckets they sit in the L2), unfiltered and with the
    filter's mask: the kernel (`select_ms`; its keys held bitwise against
    the plain version's), its plain version, stage 2
    (`torch.topk` over the candidates and the decoding), and
    `canonical_topk` over the [B, 1 M] scores (after the `torch.where` mask
    when filtered), the one-pass selection the path ran before, and
    `torch.topk` over the same masked scores, the one PyTorch call that
    gives stage 1 + stage 2's answer (ties aside). Its bound:
    the scores (4 B a row a query) and the mask (1 B a row) read once, the
    candidates (8 B each) written once, over 3.35 TB/s."""
    from euler_tpu_torch.ops import (
        operand_range,
        paged_topk_score,
        paged_topk_score_ref,
        paged_topk_select,
        paged_topk_select_ref,
        products_exact,
        topk_keys,
    )
    from euler_tpu_torch.ops.topk_score import TILE
    from euler_tpu_torch.retrieval import normalize_rows, quantize_sig12
    from euler_tpu_torch.retrieval.topk import canonical_topk

    index = engine.index
    table, n, dp = index.table2d, index._n, index._dp
    x = table.view(-1)[: n * dp].view(n, dp)
    warm = table.view(-1)[: RETR_WARM_ROWS * dp]
    mask = torch.from_numpy(index.corpus.condition_mask(RETR_FILTER)).to(table.device)
    ntiles, kt = -(-n // TILE), min(RETR_K, TILE)
    rows = []
    for b in RETR_BUCKETS:
        qn = quantize_sig12(normalize_rows(pool[:b]))
        exact = products_exact(operand_range(qn), index._x_range)
        q = torch.from_numpy(qn).to(table.device)
        sets = [(table, q)]
        tk = _time_ms(torch, lambda t, qq: paged_topk_score(t, qq, n, dp, "cuda", exact), sets,
                      50)
        tm = _time_ms(torch, lambda t, qq: paged_topk_score(t, qq, n, dp, "cuda", not exact),
                      sets, 50)
        tw = _time_ms(torch, lambda t, qq: paged_topk_score(warm, qq, RETR_WARM_ROWS, dp,
                                                            "cuda", exact), sets, 200)
        tp = _time_ms(torch, lambda t, qq: paged_topk_score_ref(t, qq, n, dp), sets, 3)
        tl = _time_ms(torch, lambda t, qq: torch.matmul(qq, x.T), sets, 50)
        if tk["device_ms"] <= 0:
            raise AssertionError("the profiler saw no device time for paged_topk_score")
        nbytes = (n * dp + b * dp + b * n) * 4
        flops = 2 * b * n * dp
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        row = {"bucket": b, "nrows": n, "dp": dp,
               "template": "fma" if exact else "mul_add", "ms": tk["device_ms"],
               "mul_add_ms" if exact else "fma_ms": tm["device_ms"],
               "warm_ms": tw["device_ms"], "warm_rows": RETR_WARM_ROWS,
               "plain_ms": tp["device_ms"], "library_ms": tl["device_ms"],
               "loop_ms": {"kernel": tk["loop_ms"], "plain": tp["loop_ms"],
                           "library": tl["loop_ms"]},
               "device_kernels": {"kernel": tk["device_kernels"],
                                  "library": tl["device_kernels"]},
               "bytes": nbytes, "flops": flops, "bytes_ms": t_bytes, "ops_ms": t_ops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        scores = paged_topk_score(table, q, n, dp, "cuda", exact)
        select = {}
        for name, m in (("unfiltered", None), ("filtered", mask)):
            keys = paged_topk_select(scores, b, RETR_K, m, TILE, "cuda")
            # at this size each block walks a run of tiles (about 30 at
            # bucket 64), which the small cases of check_topk_select do not
            if not torch.equal(keys, paged_topk_select_ref(scores, b, RETR_K, m, TILE)):
                raise AssertionError(f"paged_topk_select disagrees with its plain version at "
                                     f"bucket {b}, {name}, {n} rows")
            ts = _time_ms(torch, lambda s, mm: paged_topk_select(s, b, RETR_K, mm, TILE, "cuda"),
                          [(scores, m)], 50)
            tsp = _time_ms(torch, lambda s, mm: paged_topk_select_ref(s, b, RETR_K, mm, TILE),
                           [(scores, m)], 5)
            t2 = _time_ms(torch, lambda kk: topk_keys(kk.reshape(b, -1), RETR_K), [(keys,)], 50)
            if m is None:
                tc = _time_ms(torch, lambda s: canonical_topk(s[:b], RETR_K), [(scores,)], 20)
                tt = _time_ms(torch, lambda s: torch.topk(s[:b], RETR_K, dim=1), [(scores,)], 20)
            else:
                tc = _time_ms(torch, lambda s, mm: canonical_topk(
                    torch.where(mm[None, :], s[:b], float("-inf")), RETR_K), [(scores, m)], 20)
                tt = _time_ms(torch, lambda s, mm: torch.topk(
                    torch.where(mm[None, :], s[:b], float("-inf")), RETR_K, dim=1),
                    [(scores, m)], 20)
            if ts["device_ms"] <= 0:
                raise AssertionError("the profiler saw no device time for paged_topk_select")
            sbytes = b * n * 4 + (n if m is not None else 0) + b * ntiles * kt * 8
            select[name] = {"stage1_bitwise": True,
                            "select_ms": ts["device_ms"], "plain_ms": tsp["device_ms"],
                            "stage2_ms": t2["device_ms"], "canonical_topk_ms": tc["device_ms"],
                            "torch_topk_ms": tt["device_ms"],
                            "bytes": sbytes, "bound_ms": sbytes / HBM_BYTES_PER_S * 1e3,
                            "candidates_per_query": ntiles * kt,
                            "loop_ms": {"select": ts["loop_ms"], "stage2": t2["loop_ms"],
                                        "canonical_topk": tc["loop_ms"],
                                        "torch_topk": tt["loop_ms"]},
                            "device_kernels": {"stage2": t2["device_kernels"],
                                               "canonical_topk": tc["device_kernels"]}}
            del keys
        row["select"] = select
        rows.append(row)
        del scores
    _emit({"phase": "topk_kernel_timing", "card": card, "tile": TILE, "k": RETR_K,
           "shapes": rows})
    return rows


def _expect_launches(launches: dict, want: dict, what: str) -> None:
    """Every kernel's launch count: `want` where given, 0 elsewhere."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what} launched {name} {n} times, expected "
                                 f"{want.get(name, 0)}: {launches}")


def _products_source(g, tr_ids):
    """The north-star batch stream as tests/test_quality.py:409-419 draws
    it: one default_rng(0) shared by SageDataFlow([10, 5]) and the choice
    of 128 train roots a step."""
    from euler_tpu_torch.dataflow import SageDataFlow

    rng = np.random.default_rng(0)
    flow = SageDataFlow(g, ["feature"], fanouts=NS_FANOUTS, label_feature="label", rng=rng)

    def batch_fn():
        return (flow.query(rng.choice(tr_ids, size=NS_BATCH, replace=True)),)

    return flow, batch_fn


def _host_window(torch, est, batch_fn, card: str, what: str) -> dict:
    """Median step (host clock, each step ends synchronised: train()
    brings its loss to the host) and, given `batch_fn`, the host sampling
    part (batch_fn timed alone), then the device time, H2D copies and
    idle share over NS_PROFILED back-to-back steps."""
    est.train(3, log=False, save=False)
    steps, query = [], []
    for _ in range(NS_TIMED):
        t = time.perf_counter()
        est.train(1, log=False, save=False)
        steps.append((time.perf_counter() - t) * 1e3)
    for _ in range(NS_TIMED if batch_fn is not None else 0):
        t = time.perf_counter()
        batch_fn()
        query.append((time.perf_counter() - t) * 1e3)

    def window():
        est.train(NS_PROFILED, log=False, save=False)
        torch.cuda.synchronize()

    counts = {}
    dev, wall_ms = _profile_window(torch, window, counts=counts)
    busy_ms = sum(dev.values()) / 1e3
    h2d = {k: v for k, v in dev.items() if k.startswith("Memcpy HtoD")}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    copies = sum(n for k, n in counts.items() if k.startswith(("Memcpy", "Memset")))
    return {"what": what, "card": card, "median_step_ms": statistics.median(steps),
            "min_step_ms": min(steps), "max_step_ms": max(steps),
            "median_query_ms": statistics.median(query) if query else None, "steps": NS_TIMED,
            "profiled_steps": NS_PROFILED, "wall_ms_per_step": wall_ms / NS_PROFILED,
            "device_ms_per_step": busy_ms / NS_PROFILED,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "h2d_ms_per_step": sum(h2d.values()) / 1e3 / NS_PROFILED,
            "h2d_kinds": sorted(h2d),
            "kernel_launches_per_step": (sum(counts.values()) - copies) / NS_PROFILED,
            "copies_per_step": copies / NS_PROFILED,
            "kernel1_us_per_step": _kernel1_us(dev, NS_PROFILED),
            "top_device_us_per_step": {k[:60]: v / NS_PROFILED for k, v in top}}


def _ns_estimator(tmp: str, seed: int, batch_fn, device: str, name: str):
    """The north-star Estimator: dims 128,128, adam lr 0.01."""
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised

    cfg = EstimatorConfig(model_dir=os.path.join(tmp, name), learning_rate=0.01,
                          log_steps=10**9, seed=seed)
    return Estimator(GraphSAGESupervised(NS_FEAT, NS_DIMS, NS_CLASSES), batch_fn, cfg,
                     device=device)


def train_host(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 7: the north-star quality config through the host lane."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.datasets import products_like_graph
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig, Prefetcher, stack_batches
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.params import init_like_flax

    t0 = time.perf_counter()
    g, types = products_like_graph()
    graph_s = time.perf_counter() - t0
    tr_ids = (np.nonzero(types == 0)[0] + 1).astype(np.uint64)
    te_ids = (np.nonzero(types == 2)[0][:NS_EVAL] + 1).astype(np.uint64)

    def estimator(batch_fn, device: str, name: str):
        return _ns_estimator(tmp, seed, batch_fn, device, name)

    # (a) the main path: 500 steps in kernel mode auto, the first draws
    # kept (the init draw, then REF_STEPS steps)
    flow, batch_fn = _products_source(g, tr_ids)
    kept = []

    def tap():
        out = batch_fn()
        if len(kept) <= REF_STEPS:
            kept.append(out)
        return out

    est = estimator(tap, "cuda", "ns")
    ops.reset_launch_counts()
    t = time.perf_counter()
    losses = est.train(NS_STEPS, log=False, save=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = ops.launch_counts()
    # kernel 1: layer 0 over hops 0 and 1, layer 1 over hop 0; its dx for
    # layer 1 only (layer 0's x are features, with no gradient)
    _expect_launches(launches, {"gather_weighted_sum": 3 * NS_STEPS,
                                "gather_weighted_sum_dx": NS_STEPS}, "the host train path")
    if not np.isfinite(losses).all() or not np.mean(losses[-50:]) < np.mean(losses[:50]):
        raise AssertionError(f"host-lane losses not finite and falling: {losses[:5]} ... "
                             f"{losses[-5:]}")

    # evaluate on the first 5 000 test nodes, 10 batches of 500 (the same
    # flow, as the JAX test queries them)
    evals = [(flow.query(te_ids[i : i + NS_EVAL_BATCH]),)
             for i in range(0, NS_EVAL, NS_EVAL_BATCH)]
    ops.reset_launch_counts()
    metrics = est.evaluate(evals)
    eval_launches = ops.launch_counts()
    _expect_launches(eval_launches, {"gather_weighted_sum": 3 * len(evals)}, "evaluate")
    lo, hi = NS_F1_BAND
    if not lo < metrics["f1"] < hi:
        raise AssertionError(f"north-star f1 {metrics['f1']:.4f} outside ({lo}, {hi})")

    # (b) mode ref on the card and (c) the port on the CPU, from the kept
    # host batches
    def replay():
        it = iter(kept)
        return lambda: next(it)

    ops.set_kernel_mode("ref")
    ops.reset_launch_counts()
    try:
        losses_ref = estimator(replay(), "cuda", "ref").train(REF_STEPS, log=False, save=False)
    finally:
        ops.set_kernel_mode("auto")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"mode ref launched kernels: {ops.launch_counts()}")
    err_ref = _assert_close(losses_ref, losses[:REF_STEPS], "host lane auto vs ref")
    losses_cpu = estimator(replay(), "cpu", "cpu").train(CPU_STEPS, log=False, save=False)
    err_cpu = _assert_close(losses_cpu, losses[:CPU_STEPS], "host lane card vs CPU")

    # (d) a Prefetcher with one worker stages the same batches in order:
    # the same losses, bitwise
    _, plain_fn = _products_source(g, tr_ids)
    plain = estimator(plain_fn, "cuda", "same_a").train(NS_SAME_STEPS, log=False, save=False)
    _, pre_fn = _products_source(g, tr_ids)
    pre = Prefetcher(pre_fn, depth=4, workers=1, device_put=True, device="cuda")
    try:
        prefetched = estimator(pre, "cuda", "same_b").train(NS_SAME_STEPS, log=False,
                                                             save=False)
    finally:
        pre.close()
    if prefetched != plain:
        raise AssertionError(f"prefetched losses differ: {prefetched} against {plain}")

    # (e) where a step's time goes, without and with a Prefetcher of 2
    # workers (and of 1, which shares the interpreter lock with one fewer)
    _, fn = _products_source(g, tr_ids)
    timing = _host_window(torch, estimator(fn, "cuda", "time"), fn, card, "unprefetched")
    timing_pre = {}
    for workers in (2, 1):
        _, fn = _products_source(g, tr_ids)
        pre = Prefetcher(fn, depth=4, workers=workers, device_put=True, device="cuda")
        try:
            # (the workers draw meanwhile: no separate query time)
            timing_pre[workers] = _host_window(
                torch, estimator(pre, "cuda", f"time_pre{workers}"), None, card,
                f"Prefetcher(workers={workers}, device_put=True)")
        finally:
            pre.close()

    # (f) steps_per_call = GROUP_K: two calls of replayed steps over
    # K-stacked host items, bitwise equal to K = 1 from the same init and
    # the same host batches; then calls of 16 steps at K = 1 and K = 16
    init = init_like_flax(GraphSAGESupervised(NS_FEAT, NS_DIMS, NS_CLASSES),
                          torch.Generator().manual_seed(seed))

    def grouped(k: int):
        _, fn = _products_source(g, tr_ids)
        cfg = EstimatorConfig(model_dir=os.path.join(tmp, f"k{k}"), learning_rate=0.01,
                              log_steps=10**9, seed=seed, steps_per_call=k)
        return Estimator(GraphSAGESupervised(NS_FEAT, NS_DIMS, NS_CLASSES),
                         fn if k == 1 else stack_batches(fn, k), cfg, init_params=init,
                         device="cuda")

    est_one, est_k = grouped(1), grouped(GROUP_K)
    one = est_one.train(2 * GROUP_K, log=False, save=False)
    ops.reset_launch_counts()
    got = est_k.train(2 * GROUP_K, log=False, save=False)
    launches_k = ops.launch_counts()
    per_step = {"gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
    _expect_launches(launches_k, {k: n * 2 * GROUP_K for k, n in per_step.items()},
                     f"the host lane at K = {GROUP_K}")
    replays_k = _replay_launches(est_k, launches_k,
                                 {k: n * est_k.captures for k, n in per_step.items()})
    if got != one:
        raise AssertionError(f"K = {GROUP_K} host-lane losses differ from K = 1: {got} "
                             f"against {one}")
    timing_grouped = {
        "k1": _call_window(torch, est_one, GROUP_K, GROUP_CALLS, card, "host lane, K = 1",
                           per_step),
        f"k{GROUP_K}": _call_window(torch, est_k, GROUP_K, GROUP_CALLS, card,
                                    f"host lane, K = {GROUP_K}", per_step)}

    res = {"phase": "train_host", "nodes": g.shards[0].num_nodes,
           "edges": int(g.shards[0].adj[0].indptr[-1]), "batch": NS_BATCH,
           "fanouts": NS_FANOUTS, "dims": NS_DIMS, "steps": NS_STEPS,
           "losses_head": losses[:10], "losses_tail": losses[-10:], "launches": launches,
           "eval": metrics, "eval_batches": len(evals), "eval_launches": eval_launches,
           "f1_band": NS_F1_BAND,
           "ref_on_card": {"losses": losses_ref, "max_rel_err": err_ref},
           "port_on_cpu": {"losses": losses_cpu, "max_rel_err": err_cpu},
           "prefetch_one_worker_bitwise": {"steps": NS_SAME_STEPS, "equal": True},
           "grouped": {"steps_per_call": GROUP_K, "steps": 2 * GROUP_K, "bitwise": True,
                       "launches": launches_k, "captures": est_k.captures, **replays_k},
           "graph_s": graph_s, "train_s": train_s, "rtol": TRAIN_TOL}
    _emit(res)
    _emit({"phase": "train_host_timing", "card": card, "unprefetched": timing,
           "prefetched": timing_pre[2], "prefetched_one_worker": timing_pre[1],
           "grouped": timing_grouped})
    return {"graph": g, "tr_ids": tr_ids, "te_ids": te_ids, "launches": launches,
            "grouped_launches": launches_k, "eval_launches": eval_launches, "result": res,
            "timing": {"unprefetched": timing, "prefetched": timing_pre[2]}}


def write_products(g, directory: str) -> None:
    from euler_tpu_torch.graph import write_arrays

    for p, shard in enumerate(g.shards):
        write_arrays(os.path.join(directory, f"part_{p}"), shard.arrays)
    g.meta.save(directory)


def _engine_stats(graph, steps: int) -> dict:
    """The native engine's calls and ms a step, by op, since its counters
    were reset (ops it did not run left out)."""
    return {op: {"calls_per_step": v["calls"] / steps, "ms_per_step": v["ms"] / steps}
            for op, v in graph.shards[0].op_stats().items() if v["calls"]}


def train_host_native(torch, data: str, host: dict, tmp: str, seed: int, card: str) -> dict:
    """Phase 7b: the north star again through the native engine
    (`Graph.load(data, native=True)`; SageDataFlow's fused fanout is one
    engine call a batch): 500 steps, 3 + 1 launches a step, evaluate with
    f1 in the band (the engine's draws differ from numpy's, so this shows
    the port still learns); then the median step and its sampling part
    without a Prefetcher and with Prefetcher(workers=2, device_put=True),
    beside the numpy lane's from phase 7."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.estimator import Prefetcher
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.graph.native import NativeGraphStore

    t0 = time.perf_counter()
    g = Graph.load(data, native=True)
    load_s = time.perf_counter() - t0
    if not isinstance(g.shards[0], NativeGraphStore):
        raise AssertionError(f"Graph.load(native=True) gave {type(g.shards[0]).__name__}")
    tr_ids, te_ids = host["tr_ids"], host["te_ids"]
    flow, batch_fn = _products_source(g, tr_ids)
    est = _ns_estimator(tmp, seed, batch_fn, "cuda", "ns_native")
    g.shards[0].reset_op_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    losses = est.train(NS_STEPS, log=False, save=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = ops.launch_counts()
    engine = _engine_stats(g, NS_STEPS)
    _expect_launches(launches, {"gather_weighted_sum": 3 * NS_STEPS,
                                "gather_weighted_sum_dx": NS_STEPS}, "the native host lane")
    if not np.isfinite(losses).all() or not np.mean(losses[-50:]) < np.mean(losses[:50]):
        raise AssertionError(f"native host-lane losses not finite and falling: {losses[:5]} ... "
                             f"{losses[-5:]}")
    evals = [(flow.query(te_ids[i : i + NS_EVAL_BATCH]),)
             for i in range(0, NS_EVAL, NS_EVAL_BATCH)]
    metrics = est.evaluate(evals)
    lo, hi = NS_F1_BAND
    if not lo < metrics["f1"] < hi:
        raise AssertionError(f"native north-star f1 {metrics['f1']:.4f} outside ({lo}, {hi})")
    _, fn = _products_source(g, tr_ids)
    timing = _host_window(torch, _ns_estimator(tmp, seed, fn, "cuda", "native_time"), fn, card,
                          "native, unprefetched")
    _, fn = _products_source(g, tr_ids)
    pre = Prefetcher(fn, depth=4, workers=2, device_put=True, device="cuda")
    try:
        timing_pre = _host_window(torch, _ns_estimator(tmp, seed, pre, "cuda", "native_pre2"),
                                  None, card, "native, Prefetcher(workers=2, device_put=True)")
    finally:
        pre.close()
    keys = ("median_step_ms", "median_query_ms", "device_ms_per_step", "h2d_ms_per_step",
            "device_idle_share", "kernel_launches_per_step")
    res = {"phase": "train_host_native", "card": card, "cpu_count": os.cpu_count(),
           "store": type(g.shards[0]).__name__, "load_s": load_s, "steps": NS_STEPS,
           "train_s": train_s, "losses_head": losses[:10], "losses_tail": losses[-10:],
           "launches": launches, "eval": metrics, "f1_band": NS_F1_BAND,
           "engine_per_step": engine,
           "timing": {"native": {"unprefetched": {k: timing[k] for k in keys},
                                 "prefetched_2": {k: timing_pre[k] for k in keys}},
                      "numpy": {name: {k: host["timing"][name][k] for k in keys}
                                for name in ("unprefetched", "prefetched")}}}
    _emit(res)
    return {"launches": launches, "result": res}


def _cli_args(data: str, model_dir: str, total: int, losses_out: str | None, *extra) -> list:
    args = ["--data", data, "--model-dir", model_dir, "--dims", ",".join(map(str, NS_DIMS)),
            "--label-dim", str(NS_CLASSES), "--features", "feature", "--label-feature", "label",
            "--batch-size", str(NS_BATCH), "--max-degree", str(CLI_MAX_DEGREE),
            "--checkpoint-every", str(CLI_CADENCE), "--total-steps", str(total), *extra]
    return args + (["--losses-out", losses_out] if losses_out else [])


def _trainer(args: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "euler_tpu_torch.tools.train", *args],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, want_rc: int, what: str) -> dict:
    """Wait (bounded) for a trainer; its final JSON line. A trainer left
    running is killed."""
    try:
        out, _ = proc.communicate(timeout=CLI_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != want_rc:
        raise AssertionError(f"{what}: exit {proc.returncode}, expected {want_rc}:\n"
                             f"{out[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _losses_by_step(path: str) -> dict:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            seg = json.loads(line)
            out.update(zip(seg["loss_steps"], seg["losses"]))
    return out


def _split_equals_straight(straight: str, split: str, rep_resumed: dict, what: str) -> dict:
    """A CLI run of CLI_STEPS against one of half that resumed in a fresh
    process: per-step losses and the final checkpoint bitwise; returns
    the losses by step."""
    from euler_tpu_torch.training import CheckpointStore

    want, got = _losses_by_step(straight + ".jsonl"), _losses_by_step(split + ".jsonl")
    if sorted(want) != list(range(1, CLI_STEPS + 1)) or got != want:
        raise AssertionError(f"{what}: split + resume losses differ from the straight run:\n"
                             f"{got}\n{want}")
    if not np.isfinite(list(want.values())).all():
        raise AssertionError(f"{what}: non-finite CLI losses {want}")
    a, b = CheckpointStore(straight).load(), CheckpointStore(split).load()
    if a["step"] != CLI_STEPS or b["step"] != CLI_STEPS or not all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(a["params"] + a["opt_state"], b["params"] + b["opt_state"],
                            strict=True)):
        raise AssertionError(f"{what}: the resumed run's final checkpoint differs from the "
                             f"straight run's")
    resumed = rep_resumed["resumed"]
    if resumed["step"] != CLI_STEPS // 2 or resumed["epoch_match"] is not True:
        raise AssertionError(f"{what}: bad resume report {resumed}")
    return want


def _split_runs(data: str, straight: str, split: str, *extra) -> tuple:
    """The straight run and the first half of the split run at once, then
    the resumed half: (the three reports, seconds of the pair, seconds of
    the resumed half)."""
    what = " ".join(extra + ("run",))
    t0 = time.perf_counter()
    procs = (_trainer(_cli_args(data, straight, CLI_STEPS, straight + ".jsonl", *extra)),
             _trainer(_cli_args(data, split, CLI_STEPS // 2, split + ".jsonl", *extra)))
    try:
        reps = [_finish(proc, 0, f"{half} of the {what}")
                for proc, half in zip(procs, ("straight", "first half"))]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    pair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = _finish(_trainer(_cli_args(data, split, CLI_STEPS, split + ".jsonl", "--resume",
                                         *extra)), 0, f"resumed half of the {what}")
    return (*reps, resumed, pair_s, time.perf_counter() - t0)


def train_cli(torch, data: str, tmp: str) -> dict:
    """Phase 8: the trainer CLI on the card over the graph dir `data`, as
    subprocesses: 40 steps straight against 20 then a fresh --resume
    process up to 40 (bitwise; the straight run and the first half at
    once, then the resumed half), and a SIGTERM run; the same split
    against straight again with --native; then the CLI's trainer in
    process, its launches counted."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.tools.train import build_parser, build_trainer
    from euler_tpu_torch.training import CheckpointStore

    straight, split, term = (os.path.join(tmp, n) for n in ("cli_a", "cli_b", "cli_c"))
    rep_a, rep_b1, rep_b2, pair_s, resume_s = _split_runs(data, straight, split)
    runs_s = pair_s + resume_s
    want = _split_equals_straight(straight, split, rep_b2, "the trainer CLI")

    # SIGTERM once the first checkpoint is committed: exit 3, a final
    # checkpoint at the preempted step
    proc = _trainer(_cli_args(data, term, 100_000, term + ".jsonl"))
    store = CheckpointStore(term)
    try:
        deadline = time.monotonic() + CLI_WAIT_S
        while time.monotonic() < deadline and not store.steps() and proc.poll() is None:
            time.sleep(0.05)
        if not store.steps():
            raise AssertionError("the SIGTERM run never committed a checkpoint")
        proc.send_signal(signal.SIGTERM)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    rep_c = _finish(proc, 3, "SIGTERM run")
    if not rep_c["preempted"] or store.latest_step() != rep_c["step"]:
        raise AssertionError(f"SIGTERM: report {rep_c}, latest checkpoint {store.latest_step()}")
    if sorted(_losses_by_step(term + ".jsonl")) != list(range(1, rep_c["step"] + 1)):
        raise AssertionError("SIGTERM run lost losses")

    # --native: the straight run and the first half at once, then the
    # resumed half
    n_straight, n_split = (os.path.join(tmp, n) for n in ("cli_na", "cli_nb"))
    rep_na, _, rep_nb2, n_pair_s, n_resume_s = _split_runs(data, n_straight, n_split, "--native")
    native_losses = _split_equals_straight(n_straight, n_split, rep_nb2, "the trainer CLI --native")
    native = {"split_resume_bitwise": True, "final_checkpoint_bitwise": True,
              "losses": [native_losses[s] for s in sorted(native_losses)],
              "straight_and_first_half_s": n_pair_s, "resumed_half_s": n_resume_s,
              "telemetry": rep_na["telemetry"]}

    # the same trainer in process: its launches a step
    args = build_parser().parse_args(_cli_args(data, os.path.join(tmp, "cli_n"), CLI_COUNTED,
                                               None, "--device", "cuda"))
    session, _, _, _ = build_trainer(args)
    ops.reset_launch_counts()
    session.run(CLI_COUNTED)
    launches = ops.launch_counts()
    _expect_launches(launches, {"gather_weighted_sum": 3 * CLI_COUNTED,
                                "gather_weighted_sum_dx": CLI_COUNTED}, "the trainer CLI")
    res = {"phase": "train_cli", "steps": CLI_STEPS, "cadence": CLI_CADENCE,
           "max_degree": CLI_MAX_DEGREE, "losses": [want[s] for s in sorted(want)],
           "split_resume_bitwise": True, "final_checkpoint_bitwise": True,
           "resumed": rep_b2["resumed"], "sigterm": {"step": rep_c["step"], "exit": 3,
                                                      "latest_checkpoint": store.latest_step()},
           "telemetry": rep_a["telemetry"], "first_half": rep_b1["step"],
           "runs_s": runs_s, "native": native, "launches_in_process": launches,
           "steps_in_process": CLI_COUNTED}
    _emit(res)
    return {"data": data, "model_dir": straight, "launches": launches, "result": res}


def infer_parity(torch, data: str, model_dir: str, ids) -> dict:
    """Phase 9: on the CLI's checkpoint, Estimator.infer in chunks of 128
    against InferenceRuntime.predict at bucket 128, both over
    FullNeighborDataFlow: the same shapes, so bitwise."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import FullNeighborDataFlow
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig, id_batches
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.params import from_checkpoint_leaves
    from euler_tpu_torch.serving import InferenceRuntime
    from euler_tpu_torch.training import CheckpointStore

    g = Graph.load(data, native=False)
    flow = FullNeighborDataFlow(g, ["feature"], num_hops=len(NS_DIMS), max_degree=CLI_MAX_DEGREE)
    ckpt = CheckpointStore(model_dir).load()
    est = Estimator(GraphSAGESupervised(NS_FEAT, NS_DIMS, NS_CLASSES), None,
                    EstimatorConfig(model_dir=os.path.join(model_dir, "infer")),
                    init_params=from_checkpoint_leaves(ckpt["params"]), device="cuda")
    chunks = math.ceil(len(ids) / INFER_BUCKET)
    ops.reset_launch_counts()
    out_ids, emb = est.infer(*id_batches(flow, ids, INFER_BUCKET))
    infer_launches = ops.launch_counts()
    rt = InferenceRuntime(GraphSAGESupervised(NS_FEAT, NS_DIMS, NS_CLASSES), flow,
                          cfg=model_dir, buckets=(INFER_BUCKET,), device="cuda")
    ops.reset_launch_counts()
    served = rt.predict(ids)
    predict_launches = ops.launch_counts()
    for what, n in (("infer", infer_launches), ("predict", predict_launches)):
        _expect_launches(n, {"gather_weighted_sum": 3 * chunks}, what)
    if not np.array_equal(out_ids, ids) or emb.shape != (len(ids), NS_DIMS[-1]) \
            or not np.isfinite(emb).all():
        raise AssertionError(f"bad infer output {emb.shape}")
    if not np.array_equal(emb, served):
        raise AssertionError(f"infer and predict differ: max abs "
                             f"{float(np.abs(emb - served).max())}")
    res = {"phase": "infer_parity", "ids": len(ids), "bucket": INFER_BUCKET, "chunks": chunks,
           "checkpoint_step": ckpt["step"], "bitwise": True, "shape": list(emb.shape),
           "launches": {"infer": infer_launches["gather_weighted_sum"],
                        "predict": predict_launches["gather_weighted_sum"]}}
    _emit(res)
    return res


def headline(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 10: bench.py's headline training leg on the port (the cell
    above HEAD_*), at K = 1 and K = 64, f32 and bf16 convs, in this order.
    Each run: 2K warm-up steps (fresh estimator, the same init and draws),
    then 30 calls of 64 steps with the launch counts reset just before: 3
    gather_weighted_sum and 1 gather_weighted_sum_dx a step, exactly; at K
    = 64 one capture, and the counts equal the captured launches times the
    replays. The K = 64 warm-up losses lie within TRAIN_TOL of K = 1's of
    the same dtype. Reported: graphsage_sampled_edges_per_sec_per_chip
    (bench.py:350-355's edges a step over the 30 calls' host-clock time),
    then `_call_window`'s median step, device time, idle share and
    kernels on the card a step."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import DeviceSageFlow
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised

    t0 = time.perf_counter()
    g = random_graph(num_nodes=HEAD_NODES, out_degree=HEAD_DEGREE, feat_dim=HEAD_FEAT,
                     seed=HEAD_SEED)
    flow = DeviceSageFlow(g, fanouts=HEAD_FANOUTS, batch_size=HEAD_BATCH, label_feature="label")
    if flow.layout != "dense":
        raise AssertionError(f"the headline flow staged {flow.layout!r}, expected dense")
    cache = DeviceFeatureCache(g, ["feat"])
    setup_s = time.perf_counter() - t0
    edges_per_step, width = 0, HEAD_BATCH
    for k in HEAD_FANOUTS:
        edges_per_step += width * k
        width *= k
    per_step = {"gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
    steps = HEAD_CALLS * HEAD_K
    runs, warm = [], {}
    for k, dtype in ((1, "f32"), (1, "bf16"), (HEAD_K, "f32"), (HEAD_K, "bf16")):
        kwargs = {"dtype": torch.bfloat16} if dtype == "bf16" else None
        cfg = EstimatorConfig(model_dir=os.path.join(tmp, f"head_{k}_{dtype}"),
                              learning_rate=0.01, log_steps=10**9, seed=seed, steps_per_call=k)
        est = Estimator(GraphSAGESupervised(HEAD_FEAT, HEAD_DIMS, 2, conv_kwargs=kwargs), flow,
                        cfg, feature_cache=cache, device="cuda")
        losses = est.train(HEAD_WARMUP, log=False, save=False)
        if not np.isfinite(losses).all():
            raise AssertionError(f"headline K = {k} {dtype}: losses not finite")
        run = {"steps_per_call": k, "convs": dtype, "warmup_steps": HEAD_WARMUP,
               "warmup_loss_first_last": [losses[0], losses[-1]]}
        if k == 1:
            warm[dtype] = losses
        else:
            run["warmup_vs_k1_max_rel_err"] = _assert_close(
                losses, warm[dtype], f"headline K = {k} vs K = 1, {dtype} convs")
            run["warmup_bitwise_k1"] = losses == warm[dtype]
        before = {key: g.replays for key, g in est._graphs.items()}
        ops.reset_launch_counts()
        calls = []
        for _ in range(HEAD_CALLS):
            t = time.perf_counter()
            est.train(HEAD_K, log=False, save=False)
            calls.append(time.perf_counter() - t)
        launches = ops.launch_counts()
        _expect_launches(launches, {name: n * steps for name, n in per_step.items()},
                         f"the headline leg at K = {k}, {dtype} convs")
        if k > 1:
            # every measured step is a replay: counts = captured x replays
            run.update(_replay_launches(est, launches, {}, before))
        # bf16 convs: layer 1's launch reads bf16 x
        window = _call_window(torch, est, HEAD_K, 1, card, f"headline K = {k}, {dtype} convs",
                              {**per_step, "gather_weighted_sum_bf16_x": int(dtype == "bf16")})
        run.update({"graphsage_sampled_edges_per_sec_per_chip": steps * edges_per_step / sum(calls),
                    "steps": steps, "seconds": sum(calls),
                    "median_step_ms": statistics.median(calls) * 1e3 / HEAD_K,
                    "launches": launches, "captures": est.captures,
                    **{key: window[key] for key in (
                        "device_ms_per_step", "device_idle_share", "wall_ms_per_step",
                        "kernel_launches_per_step", "copies_per_step",
                        "port_kernels_on_card_per_step", "top_device_us_per_step")}})
        runs.append(run)
        del est
    res = {"phase": "headline", "card": card, "nodes": HEAD_NODES, "out_degree": HEAD_DEGREE,
           "feat_dim": HEAD_FEAT, "batch": HEAD_BATCH, "fanouts": HEAD_FANOUTS,
           "dims": HEAD_DIMS, "layout": flow.layout, "edges_per_step": edges_per_step,
           "setup_s": setup_s, "rtol": TRAIN_TOL,
           "graphsage_sampled_edges_per_sec_per_chip": {
               f"k{r['steps_per_call']}_{r['convs']}":
                   r["graphsage_sampled_edges_per_sec_per_chip"] for r in runs},
           "runs": runs}
    _emit(res)
    return {"launches": {name: sum(r["launches"][name] for r in runs) for name in per_step},
            "result": res}


def _hh_batches(graph, flow):
    """bench.py's host-leg batch function (bench.py:1852-1864): 1 024
    roots a call from a fresh default_rng(SeedSequence([17, n])), n from
    a counter the Prefetcher's workers share."""
    seq = itertools.count()

    def batch_fn():
        rng = np.random.default_rng(np.random.SeedSequence([HH_ROOT_SEED, next(seq)]))
        return (flow.query(graph.sample_node(HEAD_BATCH, rng=rng)),)

    return batch_fn


def _hh_flow(graph, seed: int, lean: bool = True):
    from euler_tpu_torch.dataflow import SageDataFlow

    return SageDataFlow(graph, ["feat"], fanouts=HEAD_FANOUTS, label_feature="label",
                        rng=np.random.default_rng(seed), feature_mode="rows", lean=lean)


def _hh_estimator(torch, graph_cache, batch_fn, k: int, name: str, tmp: str, seed: int,
                  bf16: bool = True, device: str = "cuda", init=None, optimizer: str = "adam"):
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.models import GraphSAGESupervised

    cfg = EstimatorConfig(model_dir=os.path.join(tmp, name), learning_rate=0.01,
                          log_steps=10**9, seed=seed, steps_per_call=k, optimizer=optimizer)
    kwargs = {"dtype": torch.bfloat16} if bf16 else None
    return Estimator(GraphSAGESupervised(HEAD_FEAT, HEAD_DIMS, 2, conv_kwargs=kwargs), batch_fn,
                     cfg, feature_cache=graph_cache, init_params=init, device=device)


def host_headline(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 11: bench.py's host training leg on the port (the cell above
    HH_*): the headline's graph through `Graph.load(native=True)`, lean
    rows batches into DeviceFeatureCache, a 4-worker Prefetcher of
    K-stacked windows, bf16 convs, K = 16; then again with one worker.
    Each run: HH_WARMUP warm-up steps, then HH_CALLS calls of K steps with
    the counts reset just before (3 gather_weighted_sum and 1 dx a step,
    exactly) and graphsage_sampled_edges_per_sec_per_chip over their
    host-clock time; then one profiled call (`_call_window`: kernels on
    the card a step, 1 of kernel 1's on bf16 x, idle share, H2D), the
    engine's counters, and batch_fn and stacking alone."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.estimator import DeviceFeatureCache, Prefetcher, stack_batches
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.graph.native import NativeGraphStore

    t0 = time.perf_counter()
    data = os.path.join(tmp, "head_graph")
    write_products(random_graph(num_nodes=HEAD_NODES, out_degree=HEAD_DEGREE,
                                feat_dim=HEAD_FEAT, seed=HEAD_SEED), data)
    graph = Graph.load(data, native=True)
    if not isinstance(graph.shards[0], NativeGraphStore):
        raise AssertionError(f"Graph.load(native=True) gave {type(graph.shards[0]).__name__}")
    cache = DeviceFeatureCache(graph, ["feat"])
    setup_s = time.perf_counter() - t0
    edges_per_step, width = 0, HEAD_BATCH
    for k in HEAD_FANOUTS:
        edges_per_step += width * k
        width *= k
    per_step = {"gather_weighted_sum": 3, "gather_weighted_sum_dx": 1}
    steps = HH_CALLS * HH_K
    runs = []
    for workers in HH_WORKERS:
        flow = _hh_flow(graph, 0)
        pre = Prefetcher(stack_batches(_hh_batches(graph, flow), HH_K), depth=HH_DEPTH,
                         workers=workers, device_put=True)
        try:
            est = _hh_estimator(torch, cache, pre, HH_K, f"hh_{workers}", tmp, seed)
            losses = est.train(HH_WARMUP, log=False, save=False)
            if not np.isfinite(losses).all():
                raise AssertionError(f"host headline, {workers} workers: losses not finite")
            graph.shards[0].reset_op_stats()
            ops.reset_launch_counts()
            calls = []
            for _ in range(HH_CALLS):
                t = time.perf_counter()
                est.train(HH_K, log=False, save=False)
                calls.append(time.perf_counter() - t)
            launches = ops.launch_counts()
            engine = _engine_stats(graph, steps)
            _expect_launches(launches, {n: c * steps for n, c in per_step.items()},
                             f"the host headline, {workers} workers")
            window = _call_window(torch, est, HH_K, 1, card,
                                  f"host headline, {workers} workers",
                                  {**per_step, "gather_weighted_sum_bf16_x": 1})
        finally:
            pre.close()
        if flow._lean_off:
            raise AssertionError("the host headline's lean flow downgraded")
        runs.append({
            "workers": workers, "warmup_loss_first_last": [losses[0], losses[-1]],
            "graphsage_sampled_edges_per_sec_per_chip": steps * edges_per_step / sum(calls),
            "steps": steps, "seconds": sum(calls),
            "median_call_ms": statistics.median(calls) * 1e3,
            "median_step_ms": statistics.median(calls) * 1e3 / HH_K,
            "launches": launches, "captures": est.captures, "engine_per_step": engine,
            **{key: window[key] for key in (
                "device_ms_per_step", "device_idle_share", "wall_ms_per_step", "h2d_ms_per_step",
                "kernel_launches_per_step", "copies_per_step", "port_kernels_on_card_per_step",
                "top_device_us_per_step")}})
        del est
    # the host's parts alone: one batch_fn() (sampling, rows) and the
    # stacking of a window
    flow = _hh_flow(graph, 1)
    batch_fn = _hh_batches(graph, flow)
    query, window_batches = [], []
    for _ in range(HH_TIMED):
        t = time.perf_counter()
        window_batches.append(batch_fn())
        query.append((time.perf_counter() - t) * 1e3)
    stack = []
    for i in range(HH_TIMED - HH_K + 1):
        it = iter(window_batches[i : i + HH_K])
        t = time.perf_counter()
        stack_batches(lambda it=it: next(it), HH_K)()
        stack.append((time.perf_counter() - t) * 1e3)
    res = {"phase": "host_headline", "card": card, "cpu_count": os.cpu_count(),
           "store": type(graph.shards[0]).__name__, "nodes": HEAD_NODES,
           "out_degree": HEAD_DEGREE, "feat_dim": HEAD_FEAT, "batch": HEAD_BATCH,
           "fanouts": HEAD_FANOUTS, "dims": HEAD_DIMS, "steps_per_call": HH_K,
           "depth": HH_DEPTH, "convs": "bf16", "edges_per_step": edges_per_step,
           "setup_s": setup_s, "median_batch_fn_ms": statistics.median(query),
           "median_stack_ms_per_call": statistics.median(stack),
           "graphsage_sampled_edges_per_sec_per_chip": {
               f"workers_{r['workers']}": r["graphsage_sampled_edges_per_sec_per_chip"]
               for r in runs},
           "runs": runs}
    _emit(res)
    return {"graph": graph, "cache": cache,
            "launches": {name: sum(r["launches"][name] for r in runs) for name in per_step},
            "result": res}


def _same_tensors(torch, a: dict, b: dict, what: str) -> None:
    for key, x in a.items():
        y = b[key]
        if (x is None) != (y is None) or (x is not None and (
                x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y))):
            raise AssertionError(f"{what}: {key} differs")


def _hydrated(torch, batch, cache, device: str) -> dict:
    """A host batch moved to `device`, hydrated and its rows gathered:
    {leaf name: tensor}."""
    from euler_tpu_torch.dataflow import hydrate_blocks, to_device

    b = cache.hydrate(hydrate_blocks(to_device(batch, device)))
    out = {f"feats[{i}]": f for i, f in enumerate(b.feats)}
    out.update({f"masks[{i}]": m for i, m in enumerate(b.masks)})
    out.update(root_idx=b.root_idx, labels=b.labels)
    for i, blk in enumerate(b.blocks):
        for name in ("edge_src", "edge_dst", "edge_w", "mask"):
            out[f"blocks[{i}].{name}"] = getattr(blk, name)
    return out


def rows_lane(torch, graph, cache, tmp: str, seed: int) -> dict:
    """Phase 12: self-checks of the rows-mode lean lane on the card (no
    JAX there), on the host headline's native graph and cache: for one
    root set and seed, the lean batch moved and hydrated is bitwise its
    `upgrade_lean_host` moved and hydrated, and the non-lean rows batch
    moved and hydrated; every valid fused draw (src, dst) is an edge of
    the graph and every row resolves back to its id; two flows of one
    seed draw the same batches, and the port trains them (sgd) on the
    card and on the CPU to the same first 3 losses within 1e-4 relative; and
    LANE_STEPS lean steps at K = 16 (a Prefetcher of one worker staging
    the stacked windows) are bitwise the same steps at K = 1."""
    from euler_tpu_torch.dataflow import upgrade_lean_host
    from euler_tpu_torch.estimator import DeviceFeatureCache, Prefetcher, stack_batches
    from euler_tpu_torch.params import init_like_flax
    from euler_tpu_torch.models import GraphSAGESupervised

    roots = graph.sample_node(HEAD_BATCH, rng=np.random.default_rng(seed + 7))
    lean, full = _hh_flow(graph, seed + 8).query(roots), _hh_flow(graph, seed + 8, False).query(
        roots)
    if lean.masks is not None or full.masks is None:
        raise AssertionError("the lean flow shipped masks, or the full flow did not")
    got = _hydrated(torch, lean, cache, "cuda")
    _same_tensors(torch, got, _hydrated(torch, upgrade_lean_host(lean), cache, "cuda"),
                  "lean against its host upgrade")
    _same_tensors(torch, got, _hydrated(torch, full, cache, "cuda"), "lean against non-lean")

    shard = graph.shards[0]
    hop_ids, _, _, hop_mask, hop_rows = graph.fanout_with_rows(
        roots, None, HEAD_FANOUTS, rng=np.random.default_rng(seed + 9))
    indptr, dst = np.asarray(shard.adj[0].indptr), np.asarray(shard.adj[0].dst)
    edge_keys = np.sort((np.repeat(np.arange(shard.num_nodes, dtype=np.uint64), np.diff(indptr))
                         << np.uint64(32)) | dst)
    draws = 0
    for h, k in enumerate(HEAD_FANOUTS):
        m = hop_mask[h + 1]
        src_rows = np.repeat(hop_rows[h], k)[m]
        keys = (src_rows.astype(np.uint64) << np.uint64(32)) | hop_ids[h + 1][m]
        pos = np.minimum(np.searchsorted(edge_keys, keys), len(edge_keys) - 1)
        if (src_rows < 0).any() or not (edge_keys[pos] == keys).all():
            raise AssertionError(f"hop {h + 1}: a draw that is not an edge of the graph")
        draws += int(m.sum())
    for h, (ids, rows, m) in enumerate(zip(hop_ids, hop_rows, hop_mask)):
        if not (np.array_equal(graph.lookup_rows(ids[m]), rows[m])
                and np.array_equal(shard.node_ids[rows[m]], ids[m])):
            raise AssertionError(f"hop {h}: rows that do not resolve to their ids")

    # two flows of one seed: the same draws; trained on the card and on
    # the CPU (f32 convs) from one init, by sgd: adam's first steps take
    # this graph's loss to ~1e-6 by the third, where a relative tolerance
    # would compare rounding
    a_fn, b_fn = (_hh_batches(graph, _hh_flow(graph, seed + 10)) for _ in range(2))
    a_batches = [a_fn() for _ in range(REF_STEPS)]
    b_batches = [b_fn() for _ in range(REF_STEPS)]
    for i, ((a,), (b,)) in enumerate(zip(a_batches, b_batches)):
        _same_tensors(torch, _hydrated(torch, a, cache, "cuda"),
                      _hydrated(torch, b, cache, "cuda"), f"batch {i} of two flows")
    init = init_like_flax(GraphSAGESupervised(HEAD_FEAT, HEAD_DIMS, 2),
                          torch.Generator().manual_seed(seed))
    cpu_cache = DeviceFeatureCache(graph, ["feat"], device="cpu")
    on_card = _hh_estimator(torch, cache, iter(a_batches).__next__, 1, "lane_card", tmp, seed,
                            bf16=False, init=init, optimizer="sgd").train(
                                REF_STEPS, log=False, save=False)
    on_cpu = _hh_estimator(torch, cpu_cache, iter(b_batches).__next__, 1, "lane_cpu", tmp, seed,
                           bf16=False, device="cpu", init=init, optimizer="sgd").train(
                               REF_STEPS, log=False, save=False)
    err_cpu = _assert_close(on_cpu, on_card, "lean rows lane, card vs CPU")

    # LANE_STEPS steps at K = 16 through a one-worker Prefetcher against
    # K = 1, from the same lean batches
    kept = [b_fn() for _ in range(LANE_STEPS)]
    one = _hh_estimator(torch, cache, iter(kept).__next__, 1, "lane_k1", tmp, seed,
                        bf16=False, init=init).train(LANE_STEPS, log=False, save=False)
    # (the worker draws on after the kept batches: a source must not end)
    source = itertools.chain(kept, iter(b_fn, None)).__next__
    pre = Prefetcher(stack_batches(source, HH_K), depth=2, workers=1, device_put=True)
    try:
        est = _hh_estimator(torch, cache, pre, HH_K, "lane_k16", tmp, seed, bf16=False,
                            init=init)
        grouped = est.train(LANE_STEPS, log=False, save=False)
    finally:
        pre.close()
    if grouped != one:
        raise AssertionError(f"lean K = {HH_K} losses differ from K = 1: {grouped} against {one}")
    res = {"phase": "rows_lane", "cpu_count": os.cpu_count(), "roots": HEAD_BATCH,
           "lean_vs_upgrade_bitwise": True, "lean_vs_full_bitwise": True,
           "draws_checked": draws, "draws_are_edges": True, "rows_resolve": True,
           "two_flows_bitwise": True, "card_vs_cpu": {"losses_card": on_card,
                                                      "losses_cpu": on_cpu,
                                                      "max_rel_err": err_cpu},
           "grouped": {"steps_per_call": HH_K, "steps": LANE_STEPS, "bitwise_k1": True,
                       "captures": est.captures}}
    _emit(res)
    return res


def _percentiles(lat_ms) -> dict:
    lat = np.asarray(lat_ms)
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def _hammer(clients: list, n_reqs: int, rng_of, ids_of, check=None) -> tuple:
    """One closed-loop thread per entry of `clients` (entries may share a
    client), each sending n_reqs requests of `ids_of(rng_of(k))`:
    (requests/s, latencies ms). A worker's error surfaces here; `check`
    holds every answer."""
    from concurrent.futures import ThreadPoolExecutor

    def worker(k):
        rng = rng_of(k)
        lats = []
        for _ in range(n_reqs):
            ids = ids_of(rng)
            t0 = time.perf_counter()
            rows = clients[k].predict(ids)
            lats.append((time.perf_counter() - t0) * 1e3)
            if check is not None:
                check(ids, rows)
        return lats

    with ThreadPoolExecutor(max_workers=len(clients)) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(worker, k) for k in range(len(clients))]
        lats = [x for f in futs for x in f.result(timeout=SERVE_WAIT_S)]
        elapsed = time.perf_counter() - t0
    return len(lats) / elapsed, lats


def _device_share(torch, hammer) -> dict:
    """The card's part of one closed-loop window of requests (`hammer()`
    returns its latencies): the device time of every thread's kernels and
    copies (torch.profiler), a request and as a share of the window."""
    requests = []

    def body():
        requests.append(len(hammer()))
        torch.cuda.synchronize()

    dev, wall_ms = _profile_window(torch, body, windows=1)
    busy_ms = sum(dev.values()) / 1e3
    return {"requests": requests[-1], "wall_ms": wall_ms,
            "device_ms_per_request": busy_ms / requests[-1],
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_device_us": sorted(((k[:60], v) for k, v in dev.items()),
                                    key=lambda kv: -kv[1])[:6]}


def _quiesce(servers) -> None:
    """Wait until no request is queued or running on any server (a hedge's
    losing attempt runs on after its client moved on)."""
    deadline = time.monotonic() + SERVE_WAIT_S
    while any(s.server._inflight or s.batcher.stats()["inflight"] for s in servers):
        if time.monotonic() > deadline:
            raise AssertionError("servers still busy after the clients finished")
        time.sleep(0.01)


def _outcome(pool, fn, *args, expected=()):
    """fn(*args) on `pool`: its result, or the exception it raised when
    that is one of `expected`; any other exception is raised."""
    fut = pool.submit(fn, *args)
    exc = fut.exception(timeout=SERVE_WAIT_S)
    if exc is None:
        return fut.result()
    if isinstance(exc, expected):
        return exc
    raise exc


def _served_launches(runtimes, before: list, what: str) -> dict:
    """Kernel 1's launches since the counts' reset against 3 a device
    batch of `runtimes` since `before`; no dx."""
    from euler_tpu_torch import ops

    batches = sum(rt.device_batches - b for rt, b in zip(runtimes, before))
    launches = ops.launch_counts()
    _expect_launches(launches, {"gather_weighted_sum": 3 * batches}, what)
    return {"device_batches": batches, "gather_weighted_sum": launches["gather_weighted_sum"],
            "gather_weighted_sum_dx": launches["gather_weighted_sum_dx"]}


def _request_ids(rng) -> np.ndarray:
    return rng.integers(1, NUM_NODES + 1, size=TCP_IDS).astype(np.uint64)


def serve_tcp(torch, graph, tmp: str, card: str) -> dict:
    """Phase 13: bench.py's serving lane on the card — a 1-step
    checkpoint, one ModelServer (bucket 128, max_wait 2 ms) and 16
    clients of 50 requests over TCP, after one warm probe through the
    wire; kernel-1 launches 3 a device batch."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import SageDataFlow
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig, node_batches
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import InferenceRuntime, ModelServer, ServingClient

    ops.set_kernel_mode("auto")
    dims = [int(x) for x in DIMS.split(",")]
    flow = SageDataFlow(graph, ["feat"], fanouts=TCP_FANOUTS, label_feature="label",
                        rng=np.random.default_rng(TCP_FLOW_SEED))
    model = GraphSAGESupervised(FEAT_DIM, dims, LABEL_DIM)
    cfg = EstimatorConfig(model_dir=os.path.join(tmp, "serve_tcp"), log_steps=10**9)
    est = Estimator(model, node_batches(graph, flow, TCP_BUCKET,
                                        rng=np.random.default_rng(TCP_TRAIN_SEED)),
                    cfg, device="cuda")
    est.train(total_steps=1, log=False)  # a real (if brief) checkpoint
    rt = InferenceRuntime(model, flow, cfg, buckets=(TCP_BUCKET,), device="cuda")
    rt.warmup()
    server = ModelServer(rt, max_wait_us=TCP_WAIT_US).start()
    addr = (server.host, server.port)
    probe = ServingClient(addr)
    try:
        # the dispatcher thread's first request, then a warm one
        first = []
        for _ in range(2):
            t0 = time.perf_counter()
            probe.predict(np.arange(1, TCP_IDS + 1, dtype=np.uint64))
            first.append((time.perf_counter() - t0) * 1e3)
        before = [rt.device_batches]
        ops.reset_launch_counts()

        def check(ids, rows):
            if rows.shape != (len(ids), dims[-1]) or not np.isfinite(rows).all():
                raise AssertionError(f"bad served rows {rows.shape}")

        clients = [ServingClient(addr) for _ in range(TCP_CLIENTS)]
        try:
            rps, lat = _hammer(clients, TCP_REQS, lambda k: np.random.default_rng(100 + k),
                               _request_ids, check)
            device = _device_share(torch, lambda: _hammer(
                clients, PROFILED_REQS, lambda k: np.random.default_rng(150 + k),
                _request_ids, check)[1])
        finally:
            for c in clients:
                c.close()
        launches = _served_launches([rt], before, "serve_tcp")
        stats = probe.stats()
    finally:
        probe.close()
        server.stop()
    if stats["rejected_overload"] or stats["rejected_deadline"] or stats["errors"]:
        raise AssertionError(f"serve_tcp rejected or failed requests: {stats}")
    res = {"phase": "serve_tcp", "card": card, "cores": os.cpu_count(),
           "gnn_serving_requests_per_sec": rps, **_percentiles(lat),
           "batches_per_100_requests": 100.0 * stats["batches"] / max(stats["requests"], 1),
           "requests": len(lat), "clients": TCP_CLIENTS, "ids_per_request": TCP_IDS,
           "bucket": TCP_BUCKET, "max_wait_us": stats["max_wait_us"],
           "first_request_ms": first[0], "second_request_ms": first[1],
           "ewma_batch_ms": stats["ewma_batch_ms"], "device": device, **launches,
           "rejected_overload": stats["rejected_overload"],
           "rejected_deadline": stats["rejected_deadline"]}
    _emit(res)
    return {"result": res, "cfg": cfg, "model": model}


def serve_parity(torch, graph, tcp: dict, card: str) -> dict:
    """Phase 14: the same graph and checkpoint over FullNeighborDataFlow
    at bucket 128: 16 concurrent clients' rows bitwise the runtime's
    direct predict; a typed DeadlineExceededError over the wire; a typed
    OverloadError from a server with max_queue 1 under 8 clients, none
    hanging; an unknown op answered by an error frame."""
    import socket
    from concurrent.futures import ThreadPoolExecutor

    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import FullNeighborDataFlow
    from euler_tpu_torch.distributed import wire
    from euler_tpu_torch.serving import (
        DeadlineExceededError,
        InferenceRuntime,
        ModelServer,
        OverloadError,
        ServingClient,
    )

    def runtime():
        flow = FullNeighborDataFlow(graph, ["feat"], num_hops=2, max_degree=PARITY_MAX_DEGREE)
        rt = InferenceRuntime(tcp["model"], flow, tcp["cfg"], buckets=(TCP_BUCKET,),
                              device="cuda")
        rt.warmup()
        return rt

    ops.set_kernel_mode("auto")
    rt = runtime()
    server = ModelServer(rt, max_wait_us=TCP_WAIT_US).start()
    addr = (server.host, server.port)
    served = []
    probe = ServingClient(addr)
    try:
        probe.predict(np.arange(1, TCP_IDS + 1, dtype=np.uint64))  # warm the wire
        before = [rt.device_batches]
        ops.reset_launch_counts()
        clients = [ServingClient(addr) for _ in range(TCP_CLIENTS)]
        try:
            rps, lat = _hammer(clients, PARITY_REQS, lambda k: np.random.default_rng(200 + k),
                               _request_ids, lambda ids, rows: served.append((ids, rows)))
        finally:
            for c in clients:
                c.close()
        launches = _served_launches([rt], before, "serve_parity")
        stats = probe.stats()
        with ThreadPoolExecutor(max_workers=1) as pool:
            late = _outcome(pool, probe.predict, np.arange(1, 9, dtype=np.uint64), 0.001,
                            expected=(DeadlineExceededError,))
        if not isinstance(late, DeadlineExceededError):
            raise AssertionError("predict(deadline_ms=0.001) answered instead of raising")
        with socket.create_connection(addr, timeout=SERVE_WAIT_S) as sock:
            wire.send_frame(sock, wire.encode("no_such_verb", []))
            status, vals = wire.decode(wire.read_frame(sock))
            wire.send_frame(sock, wire.encode("ping", []))
            pong = wire.decode(wire.read_frame(sock))
        if status != "err" or "unknown op" not in vals[0] or pong != ("ok", [0]):
            raise AssertionError(f"unknown op answered {status} {vals}, then {pong}")
    finally:
        probe.close()
        server.stop()
    if stats["batches"] >= stats["requests"]:
        raise AssertionError(f"no coalescing: {stats}")
    with rt.lock:  # the server is down: this thread is the only caller
        mismatched = sum(not np.array_equal(rows, rt.predict(ids)) for ids, rows in served)
    if mismatched:
        raise AssertionError(f"{mismatched} of {len(served)} served requests differ "
                             f"from the runtime's direct predict")

    # admission control: max_queue 1, one request of a full bucket a batch
    busy_rt = runtime()
    busy = ModelServer(busy_rt, max_batch=TCP_BUCKET, max_wait_us=0, max_queue=1).start()
    busy_addr = (busy.host, busy.port)

    def flood(k):
        client = ServingClient(busy_addr)
        rng = np.random.default_rng(300 + k)
        out = {"ok": 0, "overload": 0}
        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                for _ in range(OVERLOAD_REQS):
                    ids = rng.integers(1, NUM_NODES + 1, size=TCP_BUCKET).astype(np.uint64)
                    got = _outcome(pool, client.predict, ids, expected=(OverloadError,))
                    out["overload" if isinstance(got, OverloadError) else "ok"] += 1
        finally:
            client.close()
        return out

    try:
        with ThreadPoolExecutor(max_workers=OVERLOAD_CLIENTS) as pool:
            outs = [f.result(timeout=SERVE_WAIT_S)
                    for f in [pool.submit(flood, k) for k in range(OVERLOAD_CLIENTS)]]
        counter = ServingClient(busy_addr)
        busy_stats = counter.stats()
        counter.close()
    finally:
        busy.stop()
    overloads = sum(o["overload"] for o in outs)
    if not overloads or not sum(o["ok"] for o in outs):
        raise AssertionError(f"max_queue 1 under {OVERLOAD_CLIENTS} clients: {outs}")
    if busy_stats["rejected_overload"] != overloads:
        raise AssertionError(f"{overloads} OverloadErrors, server counted {busy_stats}")
    res = {"phase": "serve_parity", "card": card, "flow": "FullNeighborDataFlow",
           "max_degree": PARITY_MAX_DEGREE, "bucket": TCP_BUCKET,
           "served_requests": len(served), "bitwise": True,
           "batches_per_100_requests": 100.0 * stats["batches"] / max(stats["requests"], 1),
           "requests_per_sec": rps, **_percentiles(lat), **launches,
           "deadline": type(late).__name__, "unknown_op": vals[0],
           "overload": {"clients": OVERLOAD_CLIENTS, "requests": OVERLOAD_CLIENTS * OVERLOAD_REQS,
                        "rejected": overloads,
                        "served": sum(o["ok"] for o in outs)}}
    _emit(res)
    return res


def _hedge_report(router, lat) -> dict:
    """A hedged run's p50/p99 and hedge counts, held to its budget: every
    hedge spends a token of a bucket of `cap` that each successful
    attempt refills by `refill`, so hedges <= cap + refill x attempts."""
    st = router.stats()
    budget = router._hedge_budget
    bound = budget.cap + budget.refill * st["rpc_count"]
    if st["hedges"] > bound:
        raise AssertionError(f"{st['hedges']} hedges past the budget's {bound}: {st}")
    return {**_percentiles(lat), "workers": len(router._ex._threads),
            "requests": st["requests"], "attempts": st["rpc_count"],
            "hedges_issued": st["hedges"], "hedges_won": st["hedges_won"],
            "hedges_denied": st["hedges_denied"], "hedge_budget_cap": budget.cap,
            "hedge_budget_bound": bound, "hedged_within_budget": True}


def serve_fleet(torch, tmp: str, card: str) -> dict:
    """Phase 15: bench.py's fleet lane on one card — 4 ModelServers over
    one graph, routed rows bitwise Estimator.infer under both policies,
    1 against 4 replicas (fleet_scaling_4x), the card's share of 4
    replicas' time, a seeded 0.25 s straggler on replica 3
    unhedged and hedged at 62.5 ms within the hedge budget (with the
    router's default attempt pool, then a wide one), and a reload of the
    same checkpoint with canary parity."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.dataflow import FullNeighborDataFlow
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.distributed import chaos
    from euler_tpu_torch.distributed.chaos import Fault, FaultPlan
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig, id_batches, node_batches
    from euler_tpu_torch.models import GraphSAGESupervised
    from euler_tpu_torch.serving import (
        InferenceRuntime,
        ModelServer,
        ServingClient,
        ServingRouter,
    )

    ops.set_kernel_mode("auto")
    graph = random_graph(num_nodes=FLEET_NODES, out_degree=FLEET_DEGREE,
                         feat_dim=FLEET_FEAT, seed=FLEET_SEED)

    def mkflow():
        # deterministic per root: the precondition of bit-parity
        return FullNeighborDataFlow(graph, ["feat"], num_hops=2,
                                    max_degree=FLEET_MAX_DEGREE, label_feature="label")

    flow = mkflow()
    model = GraphSAGESupervised(FLEET_FEAT, FLEET_DIMS, LABEL_DIM)
    cfg = EstimatorConfig(model_dir=os.path.join(tmp, "fleet"), log_steps=10**9)
    est = Estimator(model, node_batches(graph, flow, FLEET_BUCKET,
                                        rng=np.random.default_rng(FLEET_TRAIN_SEED)),
                    cfg, device="cuda")
    est.train(total_steps=1, log=False)
    all_ids = np.arange(1, FLEET_NODES + 1, dtype=np.uint64)
    _, direct = est.infer(*id_batches(flow, all_ids, FLEET_BUCKET))

    def check(ids, rows):
        if not np.array_equal(rows, direct[ids.astype(np.int64) - 1]):
            raise AssertionError("a routed row differs from Estimator.infer")

    runtimes, servers = [], []
    try:
        for i in range(FLEET_REPLICAS):
            rt = InferenceRuntime(model, mkflow(), cfg, buckets=(FLEET_BUCKET,), device="cuda")
            rt.warmup()
            runtimes.append(rt)
            servers.append(ModelServer(rt, max_wait_us=TCP_WAIT_US, shard=i).start())
        addrs = [(s.host, s.port) for s in servers]
        first = []  # each dispatcher thread's first request
        for addr in addrs:
            w = ServingClient(addr)
            t0 = time.perf_counter()
            w.predict(all_ids[:FLEET_IDS])
            first.append((time.perf_counter() - t0) * 1e3)
            w.close()
        probe_ids = all_ids[:64]
        parity = {}
        for policy in ("consistent_hash", "least_loaded"):
            client = ServingClient(addrs, routing=policy)
            try:
                parity[policy] = bool(np.array_equal(client.predict(probe_ids),
                                                     direct[:64]))
            finally:
                client.close()
        if not all(parity.values()):
            raise AssertionError(f"routed rows differ from Estimator.infer: {parity}")

        def hammer(router, n_reqs, seed0):
            client = ServingClient(addrs, routing=router)
            try:
                return _hammer(
                    [client] * FLEET_CLIENTS, n_reqs,
                    lambda k: np.random.default_rng(np.random.SeedSequence([17, seed0, k])),
                    lambda rng: rng.integers(1, FLEET_NODES + 1,
                                             size=FLEET_IDS).astype(np.uint64),
                    check)
            finally:
                client.close()

        before = [rt.device_batches for rt in runtimes]
        ops.reset_launch_counts()
        # 1 replica vs 4, hedging off: the ratio measures routing spread
        solo_rps, solo_lat = hammer(ServingRouter([addrs[0]], hedge=False), FLEET_REQS, 1)
        fleet_rps, fleet_lat = hammer(
            ServingRouter(addrs, policy="consistent_hash", hedge=False), FLEET_REQS, 2)
        # the card's share of the 4 replicas' time
        fleet_device = _device_share(torch, lambda: hammer(
            ServingRouter(addrs, policy="consistent_hash", hedge=False), PROFILED_REQS, 5)[1])
        # one seeded straggler: a chaos server delay on replica 3's predicts
        chaos.install(FaultPlan([Fault(site="server", kind="delay", op="predict",
                                       shard=FLEET_REPLICAS - 1,
                                       delay_s=STRAGGLER_S)], seed=23))
        try:
            _, unhedged_lat = hammer(
                ServingRouter(addrs, policy="consistent_hash", hedge=False), STRAGGLER_REQS, 3)
            # hedged as bench.py runs it (the router's default pool of 16
            # attempt threads), then with a pool that holds every stalled
            # attempt: a hedge's losing attempt keeps its thread for the stall
            hedged = {}
            for pool, workers in (("default", None), ("wide", ROUTER_WIDE_WORKERS)):
                router = ServingRouter(addrs, policy="consistent_hash", hedge=True,
                                       hedge_ms=HEDGE_MS, workers=workers)
                _, lat = hammer(router, STRAGGLER_REQS, 4)
                _quiesce(servers)
                hedged[pool] = _hedge_report(router, lat)
        finally:
            chaos.uninstall()
        launches = _served_launches(runtimes, before, "serve_fleet")
        # zero-downtime reload of the same checkpoint on one replica
        reload_client = ServingClient(addrs[0])
        reports = reload_client.reload(canary_ids=probe_ids[:FLEET_BUCKET])
        reload_client.close()
        if not all(r.get("canary_parity") is True for r in reports.values()):
            raise AssertionError(f"reload lost canary parity: {reports}")
    finally:
        for s in servers:
            s.stop()
    unhedged_p99 = float(np.percentile(unhedged_lat, 99))
    res = {"phase": "serve_fleet", "card": card, "cores": os.cpu_count(),
           "replicas": FLEET_REPLICAS, "routing": "consistent_hash",
           "gnn_fleet_requests_per_sec": fleet_rps, "solo_req_per_sec": solo_rps,
           "fleet_scaling_4x": fleet_rps / solo_rps,
           "fleet_device": fleet_device,
           "fleet_p50_ms": float(np.percentile(fleet_lat, 50)),
           "fleet_p99_ms": float(np.percentile(fleet_lat, 99)),
           "solo_p99_ms": float(np.percentile(solo_lat, 99)),
           "first_request_ms": first,
           "straggler_delay_ms": STRAGGLER_S * 1e3, "hedge_ms": HEDGE_MS,
           "unhedged_p99_ms": unhedged_p99,
           "hedged_p99_ms": hedged["default"]["p99_ms"],
           "hedge_p99_cut": unhedged_p99 / hedged["default"]["p99_ms"],
           "hedged": hedged, "reload_parity": True,
           "fleet_bit_parity": parity, "rows_checked": "every routed row vs Estimator.infer",
           **launches, "clients": FLEET_CLIENTS, "ids_per_request": FLEET_IDS,
           "bucket": FLEET_BUCKET}
    _emit(res)
    return res


def _kernel_searches(snapshot: dict, servers) -> int:
    """Kernel-path searches (one scorer and one select launch each) the
    engines of `servers` ran since `snapshot` ({id: (engine, searches)});
    an engine a reload published since then counts from its creation."""
    engines = dict(snapshot)
    for srv in servers:
        for eng in (srv._engine, srv._prev):
            if eng is not None and id(eng) not in engines:
                engines[id(eng)] = (eng, 0)
    return sum(sum(eng.index.templates.values()) - n for eng, n in engines.values())


def _engine_snapshot(servers) -> dict:
    return {id(eng): (eng, sum(eng.index.templates.values()))
            for srv in servers for eng in (srv._engine, srv._prev) if eng is not None}


def _expect_searches(snapshot: dict, servers, what: str) -> dict:
    """Each retrieval kernel launched exactly once per kernel-path shard
    search since `snapshot` (counts reset with it), nothing else."""
    from euler_tpu_torch import ops

    searches = _kernel_searches(snapshot, servers)
    if not searches:
        raise AssertionError(f"{what}: no shard search reached the kernels")
    _expect_launches(ops.launch_counts(), {"paged_topk_score": searches,
                                           "paged_topk_select": searches}, what)
    return {"shard_searches": searches, "paged_topk_score": searches,
            "paged_topk_select": searches, "launches_per_shard_search": 1}


def _retr_quiesce(servers, stopped=()) -> None:
    """Wait until no request is queued or running on a live server, and
    every worker of a stopped server has exited (a hedge's losing attempt
    runs on after its client moved on)."""
    deadline = time.monotonic() + SERVE_WAIT_S
    for srv in stopped:
        for t in srv.server._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
            if t.is_alive():
                raise AssertionError("a stopped retrieval server's thread still runs")
    live = [s for s in servers if s not in stopped]
    # quiet twice, 50 ms apart: a hedge sent just before its primary
    # answered may still be on its way to a server
    quiet = 0
    while quiet < 2:
        if time.monotonic() > deadline:
            raise AssertionError("retrieval servers still busy after the clients finished")
        quiet = 0 if any(s.server._inflight for s in live) else quiet + 1
        time.sleep(0.05)


def _lane_oracle_job(job):
    from euler_tpu_torch.retrieval import numpy_topk_oracle

    ids, vecs, q, k, mask = job
    return numpy_topk_oracle(ids, vecs, q, k, metric="cosine", mask=mask)


def _lane_oracle(ids, vecs, q, k: int, mask) -> dict:
    """{filtered: `numpy_topk_oracle`'s (ids, scores, valid) for every row
    of q}, unfiltered and under `mask`, the rows split over one spawned
    process per core."""
    import multiprocessing

    workers = max(1, min(8, os.cpu_count() or 1))
    per = -(-len(q) // workers)
    jobs = [(ids, vecs, q[i:i + per], k, m) for m in (None, mask)
            for i in range(0, len(q), per)]
    with multiprocessing.get_context("spawn").Pool(workers) as procs:
        parts = procs.map(_lane_oracle_job, jobs, chunksize=1)
    half = len(parts) // 2
    return {filtered: [np.concatenate([p[j] for p in chunk]) for j in range(3)]
            for filtered, chunk in ((False, parts[:half]), (True, parts[half:]))}


def retrieve_lane(torch, card: str) -> dict:
    """Phase 6b: bench.py's retrieval lane as written (bench.py:1151-1223)
    at its accelerator sizes on the card — two RetrievalServers over one
    20 000 x 64 cosine corpus, one RetrievalClient, 300 queries of 4 at k
    32 unfiltered and then filtered by cat in {0, 2}, each checked bitwise
    against `numpy_topk_oracle` outside the timed span; kernels 5 and 5b
    exactly 2 launches a query (one a shard); then the card's share of a
    profiled window of the lane's queries."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.retrieval import EmbeddingCorpus, numpy_topk_oracle
    from euler_tpu_torch.retrieval.client import RetrievalClient
    from euler_tpu_torch.retrieval.server import RetrievalServer

    n, dim, queries, k = LANE_ROWS, LANE_DIM, LANE_QUERIES, LANE_K
    rng = np.random.default_rng(LANE_SEED)
    ids = np.sort(rng.choice(max(10 * n, 1000), size=n, replace=False).astype(np.uint64))
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    attrs = {"cat": rng.integers(0, 4, size=n)}
    corpus = EmbeddingCorpus.build(ids, vecs, attrs=attrs, metric="cosine")
    dnf = [[("cat", "in", [0, 2])]]
    mask = np.isin(np.asarray(attrs["cat"]), [0, 2])
    servers, cli = [], None
    try:
        t0 = time.perf_counter()
        for part in range(2):
            servers.append(RetrievalServer(corpus=corpus, part=part, num_parts=2, warm_k=k,
                                           device="cuda").start())
        boot_s = time.perf_counter() - t0
        cli = RetrievalClient([[(s.host, s.port)] for s in servers])
        qs = rng.standard_normal((queries, LANE_BATCH, dim)).astype(np.float32)
        parity = {"unfiltered": True, "filtered": True}
        # the oracle outside the timed span, over one spawned process per
        # core (its rows are independent: the same answers as one call a
        # query)
        t0 = time.perf_counter()
        oracle = _lane_oracle(ids, vecs, qs.reshape(-1, dim), k, mask)
        oracle_s = time.perf_counter() - t0

        def measure(use_dnf):
            name = "filtered" if use_dnf else "unfiltered"
            lat = []
            cli.retrieve(qs[0], k, dnf=dnf if use_dnf else None)  # warm
            for j, q in enumerate(qs):
                t1 = time.perf_counter()
                got = cli.retrieve(q, k, dnf=dnf if use_dnf else None)
                lat.append((time.perf_counter() - t1) * 1e3)
                want = [a[j * LANE_BATCH:(j + 1) * LANE_BATCH] for a in oracle[use_dnf]]
                parity[name] = parity[name] and _same_answer(got, want)
            return queries / (sum(lat) / 1e3), lat

        snapshot = _engine_snapshot(servers)
        ops.reset_launch_counts()
        qps, lat = measure(False)
        fqps, flat = measure(True)
        launches = _expect_searches(snapshot, servers, "retrieve_lane")
        if launches["shard_searches"] != 2 * 2 * (queries + 1):
            raise AssertionError(f"retrieve_lane: {launches['shard_searches']} shard searches "
                                 f"for {2 * (queries + 1)} queries of 2 shards")
        if not all(parity.values()):
            raise AssertionError(f"retrieve_lane differs from numpy_topk_oracle: {parity}")
        rst = cli.router.stats()
        # one shard's engine in process: the search without the front end
        engine_ms = _engine_ms(servers[0]._engine, {LANE_BATCH: qs[0]}, k,
                               (None, json.dumps(dnf)))

        def window():
            for q in qs[:LANE_PROFILED]:
                cli.retrieve(q, k)
            torch.cuda.synchronize()

        dev, wall_ms = _profile_window(torch, window, windows=1)
        busy_ms = sum(dev.values()) / 1e3
    finally:
        if cli is not None:
            cli.close()
        for s in servers:
            s.stop()
    busy = rst["fanout_s"] + rst["merge_s"]
    res = {"phase": "retrieve_lane", "card": card, "rows": n, "dim": dim, "queries": queries,
           "batch": LANE_BATCH, "k": k, "shards": 2, "replicas": 1, "boot_s": boot_s,
           "retrieval_queries_per_sec": qps, "retrieval_p50_ms": _percentiles(lat)["p50_ms"],
           "retrieval_p99_ms": _percentiles(lat)["p99_ms"],
           "filtered_queries_per_sec": fqps, "filtered": _percentiles(flat),
           "retrieval_filtered_over_unfiltered": fqps / max(qps, 1e-9),
           "retrieval_merge_overhead_pct": 100.0 * rst["merge_s"] / max(busy, 1e-9),
           "retrieval_bit_parity": all(parity.values()), "router": rst, "oracle_s": oracle_s,
           "shard_engine_median_ms": engine_ms,
           "launches": launches, "kernel_launches_per_query": 2,
           "device": {"queries": LANE_PROFILED, "wall_ms": wall_ms,
                      "device_ms_per_query": busy_ms / LANE_PROFILED,
                      "device_idle_share": 1.0 - busy_ms / wall_ms}}
    _emit(res)
    return res


def _engine_ms(engine, queries: dict, k: int, filters, reps: int = 30) -> dict:
    """Median host-clock ms of one `_CorpusEngine.retrieve` in process (it
    returns host numpy, so it ends synchronised), per bucket and filter."""
    out = {}
    for b, q in queries.items():
        for f in filters:
            engine.retrieve(q, k, f)
            lat = []
            for _ in range(reps):
                t0 = time.perf_counter()
                engine.retrieve(q, k, f)
                lat.append((time.perf_counter() - t0) * 1e3)
            out[f"{b}{' filtered' if f else ''}"] = statistics.median(lat)
    return out


def _retr_hammer(n_threads: int, seed0: int, sets: list, ask, check, n_reqs: int | None = None,
                 stop=None, done=None) -> tuple:
    """One closed-loop thread per client slot, each asking `ask(q, f)` of
    query sets drawn from default_rng(SeedSequence([seed0, k])) with the
    filter f in {0, 1}, `n_reqs` times or until `stop` is set; `check`
    holds every answer, and `done` (a list) counts the answers as they
    come. Returns (queries/s, latencies ms); a thread's error surfaces."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    lock = threading.Lock()

    def worker(k):
        rng = np.random.default_rng(np.random.SeedSequence([seed0, k]))
        lats = []
        deadline = time.monotonic() + SERVE_WAIT_S
        while (len(lats) < n_reqs if n_reqs is not None else not stop.is_set()):
            if time.monotonic() > deadline:
                raise AssertionError("a retrieval client outran its wait")
            i, f = int(rng.integers(len(sets))), int(rng.integers(2))
            t0 = time.perf_counter()
            ans = ask(sets[i], f)
            lats.append((time.perf_counter() - t0) * 1e3)
            check(i, f, ans)
            if done is not None:
                with lock:
                    done.append(ans[3] if len(ans) > 3 else None)
        return lats

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        t0 = time.perf_counter()
        futs = [pool.submit(worker, k) for k in range(n_threads)]
        lats = [x for f in futs for x in f.result(timeout=SERVE_WAIT_S)]
        elapsed = time.perf_counter() - t0
    return len(lats) / elapsed, lats


def retrieve_fleet(torch, retrieved: dict, seed: int, card: str) -> dict:
    """Phase 6c: phase 6's retrieval cell served over TCP — 2 shards x 2
    replicas of RetrievalServer on the card, each loading the corpus
    through `EmbeddingCorpus.from_checkpoint` (one prebuilt corpus a
    checkpoint step), a RetrievalClient with hedging on, 8 client threads
    sending bucket-4 and bucket-16 queries, unfiltered and filtered: every
    answer bitwise the answer of one in-process `_CorpusEngine` over the
    same version (phase 6 holds that engine to numpy_topk_oracle and impl
    ref). A steady window, a profiled one, a rolling reload to a second
    checkpoint under load (every replica swapped, canary parity false,
    every answer of one version), one replica stopped mid-window
    (failover), and a tenant past its TenantQuota (a typed
    OverloadError); kernels 5 and 5b exactly one launch each a shard
    search in every window."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from euler_tpu_torch import ops
    from euler_tpu_torch.distributed.errors import OverloadError
    from euler_tpu_torch.retrieval import EmbeddingCorpus
    from euler_tpu_torch.retrieval.client import RetrievalClient
    from euler_tpu_torch.retrieval.server import RetrievalServer, _CorpusEngine
    from euler_tpu_torch.serving import TenantQuota
    from euler_tpu_torch.training.checkpoint import CheckpointStore

    data, model_dir = retrieved["data"], retrieved["model_dir"]
    step2 = RETR_STEP + 1
    t0 = time.perf_counter()
    fresh = np.random.default_rng(seed + RF_SEED).standard_normal((RETR_ROWS, RETR_DIM),
                                                                 dtype=np.float32)
    CheckpointStore(model_dir).save_leaves(step2, [fresh], [])
    del fresh
    save_s = time.perf_counter() - t0

    # phase 6's corpus is this loader's answer for its checkpoint step
    corpora, corpora_lock = {RETR_STEP: retrieved["engine"].corpus}, threading.Lock()

    def loader(source):
        step = (source or {}).get("step", RETR_STEP)
        with corpora_lock:
            if step not in corpora:
                corpora[step] = EmbeddingCorpus.from_checkpoint(
                    model_dir, data["ids"], attrs={"cat": data["cat"]}, metric="cosine",
                    step=step)
            return corpora[step]

    t0 = time.perf_counter()
    for step in (RETR_STEP, step2):
        loader({"step": step})
    corpus_s = time.perf_counter() - t0
    v1, v2 = corpora[RETR_STEP].version, corpora[step2].version
    if v1 != retrieved["result"]["version"] or v1 >= v2:
        raise AssertionError(f"versions {v1} / {v2} against phase 6's "
                             f"{retrieved['result']['version']}")
    refs = {v1: retrieved["engine"], v2: _CorpusEngine(corpora[step2]).warm(RETR_K)}
    qrng = np.random.default_rng(seed + RF_SEED + 1)
    sets = [qrng.standard_normal((b, RETR_DIM), dtype=np.float32)
            for b in RF_BUCKETS for _ in range(RF_SETS)]
    filters = (None, RETR_FILTER)
    want = {(v, i, f): eng.retrieve(q, RETR_K, json.dumps(filters[f]) if f else None)
            for v, eng in refs.items() for i, q in enumerate(sets) for f in (0, 1)}

    def checker(version):
        def check(i, f, ans):
            ver = ans[3] if len(ans) > 3 else version
            if ver not in refs or not _same_answer(ans[:3], want[(ver, i, f)]):
                raise AssertionError(f"retrieve_fleet: set {i} filter {f} version {ver} "
                                     "differs from the in-process engine")
        return check

    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    servers, stopped, cli = [], [], None
    try:
        t0 = time.perf_counter()
        boots = []
        shard_addrs = []
        for part in range(RF_SHARDS):
            reps = []
            for _ in range(RF_REPLICAS):
                t1 = time.perf_counter()
                srv = RetrievalServer(loader=loader, part=part, num_parts=RF_SHARDS,
                                      warm_k=RETR_K, device="cuda",
                                      tenant_quota=TenantQuota(qps=RF_TENANT_QPS, burst=1.0))
                servers.append(srv.start())
                boots.append(time.perf_counter() - t1)
                reps.append((srv.host, srv.port))
            shard_addrs.append(reps)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        boot_peak = torch.cuda.max_memory_allocated()
        cli = RetrievalClient(shard_addrs, hedge_ms=RF_HEDGE_MS)
        router = cli.router
        denied, denied_lock = [0], threading.Lock()
        spend = router._hedge_budget.try_spend

        def counted_spend():
            ok = spend()
            if not ok:
                with denied_lock:
                    denied[0] += 1
            return ok

        router._hedge_budget.try_spend = counted_spend

        def ask_client(q, f):
            return cli.retrieve(q, RETR_K, dnf=filters[f])

        def ask_router(q, f):
            return router.retrieve(q, RETR_K, dnf=filters[f])

        def window(name, fn, stopped=()):
            """Run `fn()` with the counts reset; the window's numbers."""
            before = (router.hedges, denied[0], router.version_rounds, router.queries)
            snapshot = _engine_snapshot(servers)
            ops.reset_launch_counts()
            qps, lat, extra = fn()
            _retr_quiesce(servers, stopped)
            out = {"queries_per_sec": qps, **_percentiles(lat), "queries": len(lat),
                   "hedges_issued": router.hedges - before[0],
                   "hedges_denied": denied[0] - before[1],
                   "version_rounds": router.version_rounds - before[2],
                   "router_queries": router.queries - before[3],
                   "launches": _expect_searches(snapshot, servers, f"retrieve_fleet {name}"),
                   **extra}
            return out

        results = {}
        # a steady window at version 1
        results["steady"] = window("steady", lambda: (*_retr_hammer(
            RF_CLIENTS, 1, sets, ask_client, checker(v1), n_reqs=RF_REQS), {}))
        # the card's share of a window
        results["device"] = _device_share(torch, lambda: _retr_hammer(
            RF_CLIENTS, 2, sets, ask_client, checker(v1), n_reqs=RF_PROFILED)[1])
        # one shard's engine in process: the search without the front end
        results["shard_engine_median_ms"] = _engine_ms(
            servers[0]._engine, {b: sets[i * RF_SETS] for i, b in enumerate(RF_BUCKETS)},
            RETR_K, (None, json.dumps(RETR_FILTER)))

        # a rolling reload to the second checkpoint under load
        def roll():
            stop, done = threading.Event(), []
            canary = sets[0]
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(_retr_hammer, RF_CLIENTS, 3, sets, ask_router, checker(None),
                                  stop=stop, done=done)
                deadline = time.monotonic() + SERVE_WAIT_S
                try:
                    while len(done) < RF_ROLL_ANSWERS and time.monotonic() < deadline:
                        time.sleep(0.005)
                    torch.cuda.reset_peak_memory_stats()
                    t1 = time.perf_counter()
                    reports = cli.reload_all(source={"step": step2}, canary_q=canary,
                                             canary_k=RETR_K)
                    roll_s = time.perf_counter() - t1
                    while (sum(v == v2 for v in done[:]) < RF_ROLL_ANSWERS
                           and time.monotonic() < deadline):
                        time.sleep(0.005)
                finally:
                    stop.set()
                qps, lat = fut.result(timeout=SERVE_WAIT_S)
            seen = {v: sum(x == v for x in done) for v in (v1, v2)}
            bad = {k: r for k, r in reports.items()
                   if r.get("swapped") is not True or r.get("canary_parity") is not False
                   or r.get("to_version") != v2}
            if bad or len(reports) != RF_SHARDS * RF_REPLICAS:
                raise AssertionError(f"retrieve_fleet roll: reports {reports}")
            if not all(seen.values()):
                raise AssertionError(f"retrieve_fleet roll: answers by version {seen}")
            return qps, lat, {"roll_s": roll_s, "answers_by_version": seen,
                              "reload_build_s": {k: r["build_s"] for k, r in reports.items()},
                              "peak_device_bytes": torch.cuda.max_memory_allocated(),
                              "reports": reports}

        results["roll"] = window("roll", roll)
        if any(s._engine.corpus.version != v2 for s in servers):
            raise AssertionError("retrieve_fleet: a replica does not serve the new version")

        # one replica stopped mid-window: transport failover, same bits
        victim = servers[1]

        def failover():
            done = []
            retries = sum(sh.retry_count for sh in cli.shards)
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(_retr_hammer, RF_CLIENTS, 4, sets, ask_client, checker(v2),
                                  n_reqs=RF_REQS, done=done)
                deadline = time.monotonic() + SERVE_WAIT_S
                while len(done) < RF_CLIENTS * RF_REQS // 2 and time.monotonic() < deadline:
                    time.sleep(0.005)
                at = len(done)
                victim.stop()
                stopped.append(victim)
                qps, lat = fut.result(timeout=SERVE_WAIT_S)
            failovers = sum(sh.retry_count for sh in cli.shards) - retries
            if not failovers:
                raise AssertionError("retrieve_fleet: stopping a replica caused no failover")
            return qps, lat, {"stopped": f"0@{victim.host}:{victim.port}",
                              "stopped_after_answers": at, "failovers": failovers}

        results["failover"] = window("failover", failover, stopped=(victim,))

        # a tenant past its quota: the typed OverloadError, over the wire
        q = sets[0]
        first = cli.retrieve(q, RETR_K, tenant="flood")
        with ThreadPoolExecutor(max_workers=1) as pool:
            exc = _outcome(pool, cli.retrieve, q, RETR_K, None, None, "flood",
                           expected=(OverloadError,))
        if not isinstance(exc, OverloadError) or "flood" not in str(exc):
            raise AssertionError(f"retrieve_fleet: a tenant past its quota got {exc!r}")
        calm = cli.retrieve(q, RETR_K, tenant="calm")
        if not (_same_answer(first, want[(v2, 0, 0)]) and _same_answer(calm, first)):
            raise AssertionError("retrieve_fleet: tenant answers differ")
        results["tenant"] = {"overload": type(exc).__name__, "message": str(exc)[:160]}
        results["router"] = router.stats()
    finally:
        if cli is not None:
            cli.close()
        for s in servers:
            if s not in stopped:
                s.stop()
    del refs[v2]
    torch.cuda.empty_cache()
    res = {"phase": "retrieve_fleet", "card": card, "cores": os.cpu_count(),
           "rows": RETR_ROWS, "dim": RETR_DIM, "k": RETR_K, "shards": RF_SHARDS,
           "replicas": RF_REPLICAS, "buckets": list(RF_BUCKETS), "filter": RETR_FILTER,
           "clients": RF_CLIENTS, "hedge_ms": RF_HEDGE_MS, "versions": [v1, v2],
           "check": "every answer bitwise the in-process engine of its version",
           "save_s": save_s, "corpus_s": corpus_s, "boot_s": boot_s, "server_boot_s": boots,
           "base_device_bytes": base_bytes, "boot_peak_device_bytes": boot_peak, **results}
    _emit(res)
    return res


def retrieve_selftest(card: str) -> dict:
    """Phase 6d: `python -m euler_tpu_torch.tools.retrieve --selftest` in a
    process of its own on the card: a 2-shard x 2-replica fleet over a real
    checkpoint, filtered and unfiltered answers bitwise the NumPy oracle,
    a hot swap to a second checkpoint; exit 0 and "selftest": "ok"."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "euler_tpu_torch.tools.retrieve", "--selftest"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=SELFTEST_WAIT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"retrieve selftest exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    summary = json.loads(proc.stdout)
    if summary.get("selftest") != "ok" or summary.get("device") != "cuda":
        raise AssertionError(f"retrieve selftest: {summary}")
    res = {"phase": "retrieve_selftest", "card": card, "seconds": seconds, **summary}
    _emit(res)
    return res


# ---- phases 16-20: the link-prediction and shallow-embedding families -----


def _same_nests(torch, got: list, want: list, what: str) -> int:
    """Bitwise equality of lists of batches (any nest of tuples, dicts and
    dataclasses of one structure; bf16 by its bits, on the host)."""
    from euler_tpu_torch.estimator.graph_step import tensor_leaves, tree_map

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches against {len(want)}")
    for step, (a, b) in enumerate(zip(got, want)):
        tree_map(lambda *v: None, a, b)  # raises where the structures differ
        ta, tb = tensor_leaves(a), tensor_leaves(b)
        if len(ta) != len(tb):
            raise AssertionError(f"{what}: step {step} has {len(ta)} tensors against {len(tb)}")
        for key, (x, y) in enumerate(zip(ta, tb)):
            x, y = x.cpu(), y.cpu()
            if x.dtype == torch.bfloat16:
                x, y = x.view(torch.int16), y.view(torch.int16)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"{what}: step {step} {key} differs")
    return len(got)


def _to_cpu(torch, x):
    from euler_tpu_torch.estimator.graph_step import tree_map

    return tree_map(lambda v: v.cpu() if isinstance(v, torch.Tensor) else v, x)


def _run_counted(torch, est, steps: int, mode: str = "auto") -> tuple:
    """`steps` optimizer steps in kernel mode `mode`: (losses, the launch
    counts reset just before and read just after, seconds)."""
    from euler_tpu_torch import ops

    ops.set_kernel_mode(mode)
    ops.reset_launch_counts()
    try:
        t = time.perf_counter()
        losses = est.train(steps, log=False, save=False)
        torch.cuda.synchronize()
        return losses, ops.launch_counts(), time.perf_counter() - t
    finally:
        ops.set_kernel_mode("auto")


def _card_vs_cpu(torch, make_est, card_flow, cpu_flow, steps: int, what: str) -> dict:
    """`steps` steps of two Estimators built alike (`make_est(flow,
    device)`: one seed, one init) on the card and on the CPU, the CPU
    flow handed the card's draws: bitwise equal batches, losses within
    TRAIN_TOL relative."""
    tap = _Tap(card_flow, steps)
    losses = make_est(card_flow, "cuda").train(steps, log=False, save=False)
    tap.close()
    draws = iter([_to_cpu(torch, d) for d in tap.draws])
    cpu_flow.draw_inputs = lambda gen: next(draws)
    tap_cpu = _Tap(cpu_flow, steps)
    try:
        losses_cpu = make_est(cpu_flow, "cpu").train(steps, log=False, save=False)
    finally:
        tap_cpu.close()  # drops the instance's draw_inputs: the flow's own again
    same = _same_nests(torch, tap_cpu.batches, tap.batches, f"{what}: card vs CPU")
    return {"batches_equal": same, "losses": losses, "losses_cpu": losses_cpu,
            "max_rel_err": _assert_close(losses_cpu, losses, f"{what}: card vs CPU")}


def _host_card_vs_cpu(torch, make_est, batches: list, what: str, want: dict | None) -> dict:
    """The same host batches through an Estimator on the card (launches
    counted: `want` a step) and one on the CPU: losses within TRAIN_TOL
    relative. The first batch is the init draw of each."""
    steps = len(batches) - 1
    it = iter(batches)
    est = make_est(lambda: next(it), "cuda")
    losses, launches, _ = _run_counted(torch, est, steps)
    if want is not None:
        _expect_launches(launches, {k: n * steps for k, n in want.items()}, what)
    it_cpu = iter(batches)
    losses_cpu = make_est(lambda: next(it_cpu), "cpu").train(steps, log=False, save=False)
    return {"steps": steps, "losses": losses, "losses_cpu": losses_cpu, "launches": launches,
            "max_rel_err": _assert_close(losses_cpu, losses, f"{what}: card vs CPU")}


def unsup_train(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 16: GraphSAGEUnsupervised on the paged device lane's graph
    (phase 5's: skewed_weighted_graph 200 000 nodes, bf16 weight plane),
    DeviceUnsupSageFlow(fanouts 10,10, batch 512, 5 negatives, paged, P =
    16), dims 128,128, adam lr 0.01: 20 steps in mode auto with exactly
    UNSUP_PER_STEP launches a step; the first 3 again in mode ref (bitwise
    batches, losses within 1e-4); the dense layout's triples from the same
    draws bitwise; 20 steps at K = 16 (replays, the same launches, losses
    within 1e-4 of K = 1's); a few host-lane steps (unsupervised_batches
    over SageDataFlow) on the card (9 + 3 launches a step) and the CPU;
    then calls of UNSUP_K steps timed at K = 1 and K = 16."""
    from euler_tpu_torch.dataflow import DeviceUnsupSageFlow, SageDataFlow
    from euler_tpu_torch.datasets import skewed_weighted_graph
    from euler_tpu_torch.estimator import (DeviceFeatureCache, Estimator, EstimatorConfig,
                                           unsupervised_batches)
    from euler_tpu_torch.models import GraphSAGEUnsupervised

    t0 = time.perf_counter()
    g = skewed_weighted_graph(TRAIN_NODES, TRAIN_GRAPH_SEED)
    prev_dtype = os.environ.get("EULER_TPU_PAGE_DTYPE")
    os.environ["EULER_TPU_PAGE_DTYPE"] = "bf16"
    try:
        def flow(layout: str, device: str = "cuda"):
            return DeviceUnsupSageFlow(g, fanouts=TRAIN_FANOUTS, batch_size=UNSUP_BATCH,
                                       num_negs=UNSUP_NEGS, layout=layout, page_size=PAGE_SIZE,
                                       device=device)

        paged = flow("paged")
        if not paged._page_w_packed:
            raise AssertionError("the unsupervised lane did not stage a packed weight plane")
        cache = DeviceFeatureCache(g, ["feat"], device="cuda")
    finally:
        if prev_dtype is None:
            os.environ.pop("EULER_TPU_PAGE_DTYPE", None)
        else:
            os.environ["EULER_TPU_PAGE_DTYPE"] = prev_dtype
    setup_s = time.perf_counter() - t0

    def estimator(f, name: str, k: int = 1, fc=cache, device: str = "cuda"):
        cfg = EstimatorConfig(model_dir=os.path.join(tmp, name), learning_rate=0.01,
                              optimizer="adam", log_steps=10**9, seed=seed, steps_per_call=k)
        return Estimator(GraphSAGEUnsupervised(TRAIN_FEAT, TRAIN_DIMS), f, cfg,
                         feature_cache=fc, device=device)

    # (a) the main path, mode auto
    est = estimator(paged, "unsup")
    tap = _Tap(paged, REF_STEPS)
    losses, launches, main_s = _run_counted(torch, est, UNSUP_STEPS)
    tap.close()
    _expect_launches(launches, {k: n * UNSUP_STEPS for k, n in UNSUP_PER_STEP.items()},
                     "the unsupervised device lane")
    if not np.isfinite(losses).all():
        raise AssertionError(f"unsupervised losses not finite: {losses}")
    # (b) mode ref on the card: the plain versions, the same batches
    tap_ref = _Tap(paged, REF_STEPS)
    losses_ref, launches_ref, _ = _run_counted(torch, estimator(paged, "unsup_ref"),
                                               REF_STEPS, "ref")
    tap_ref.close()
    if any(launches_ref.values()):
        raise AssertionError(f"mode ref launched kernels: {launches_ref}")
    same_ref = _same_nests(torch, tap_ref.batches, tap.batches, "unsup auto vs ref")
    err_ref = _assert_close(losses_ref, losses[:REF_STEPS], "unsup auto vs ref")
    # (c) the dense layout draws the same triples from the same numbers
    dense = flow("dense")
    same_dense = _same_nests(torch, [dense.make_batch(*d) for d in tap.draws], tap.batches,
                             "unsup dense vs paged")
    del dense
    # (d) K = 16: the captured step replayed
    est16 = estimator(paged, "unsup_k16", k=GROUP_K)
    losses16, launches16, _ = _run_counted(torch, est16, UNSUP_STEPS)
    _expect_launches(launches16, {k: n * UNSUP_STEPS for k, n in UNSUP_PER_STEP.items()},
                     f"the unsupervised device lane at K = {GROUP_K}")
    replays = _replay_launches(est16, launches16,
                               {k: n * est16.captures for k, n in UNSUP_PER_STEP.items()})
    err16 = _assert_close(losses16, losses, f"unsup K = {GROUP_K} vs K = 1")
    # (e) the host lane: (src, pos, negs) host batches on the card and the CPU
    host_flow = SageDataFlow(g, ["feat"], fanouts=TRAIN_FANOUTS, rng=np.random.default_rng(seed))
    src = unsupervised_batches(g, host_flow, UNSUP_BATCH, num_negs=UNSUP_NEGS,
                               rng=np.random.default_rng(seed + 1))
    host_batches = [src() for _ in range(UNSUP_HOST_STEPS + 1)]
    host = _host_card_vs_cpu(
        torch, lambda fn, device: estimator(fn, f"unsup_host_{device}", fc=None, device=device),
        host_batches, "the unsupervised host lane",
        {k: v for k, v in UNSUP_PER_STEP.items() if k != HOP_KERNEL})
    del host_batches
    # (f) timing: calls of UNSUP_K steps at K = 1 and K = 16
    per_step = UNSUP_PER_STEP
    k1 = _call_window(torch, est, UNSUP_K, UNSUP_CALLS, card, "unsup K = 1", per_step)
    k16 = _call_window(torch, est16, UNSUP_K, UNSUP_CALLS, card, f"unsup K = {GROUP_K}",
                       per_step)
    res = {"phase": "unsup_train", "card": card, "nodes": TRAIN_NODES,
           "batch": UNSUP_BATCH, "num_negs": UNSUP_NEGS, "fanouts": TRAIN_FANOUTS,
           "dims": TRAIN_DIMS, "layout": "paged", "page_size": PAGE_SIZE, "steps": UNSUP_STEPS,
           "losses": losses, "launches": launches, "launches_per_step": per_step,
           "ref_on_card": {"batches_equal": same_ref, "losses": losses_ref,
                           "max_rel_err": err_ref},
           "dense_vs_paged_batches_equal": same_dense,
           "k16": {"losses": losses16, "max_rel_err": err16, "launches": launches16,
                   "captures": est16.captures, **replays},
           "host_lane": host, "timing_k1": k1, f"timing_k{GROUP_K}": k16,
           "setup_s": setup_s, "main_run_s": main_s, "rtol": TRAIN_TOL}
    _emit(res)
    return {"launches": launches, "launches_k16": launches16,
            "launches_host": host["launches"], "result": res}


def skipgram_train(torch, graph, tmp: str, seed: int, card: str) -> dict:
    """Phase 17: DeepWalk, node2vec (p 0.5, q 2) and LINE at
    SkipGramModel's default dim 128 on phase 4's serving graph (200 000
    nodes, out-degree 10: the biased walk's max degree <= 64 holds), batch
    512, 5 negatives, adam lr 0.01: through DeviceWalkFlow / DeviceEdgeFlow
    (20 steps; the first 2 again on the CPU from the card's draws:
    bitwise batches, losses within 1e-4) and through deepwalk_batches /
    line_batches (the same host batches on the card and the CPU); no
    kernel of the port launches on these paths. Then the quality bands of
    tests/test_quality.py:467-507 on cora_like on the card: LINE 2 000
    steps MRR in (0.87, 0.97), DeepWalk 600 steps in (0.87, 0.995); and
    calls of SG_K steps timed for each device-flow cell."""
    from euler_tpu_torch.dataflow import DeviceEdgeFlow, DeviceWalkFlow
    from euler_tpu_torch.datasets import cora_like_json
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.examples.link_quality import skipgram_quality
    from euler_tpu_torch.graph import Graph
    from euler_tpu_torch.models import SkipGramModel, deepwalk_batches, line_batches

    max_id = int(graph.shards[0].node_ids.max())

    def make(name: str, shared: bool):
        def build(fn, device: str):
            cfg = EstimatorConfig(model_dir=os.path.join(tmp, f"{name}_{device}"),
                                  learning_rate=0.01, log_steps=10**9, seed=seed)
            return Estimator(SkipGramModel(max_id, SG_DIM, shared_context=shared), fn, cfg,
                             device=device)
        return build

    cells = {
        "deepwalk": (lambda d: DeviceWalkFlow(graph, SG_BATCH, SG_WALK, SG_WINDOW, SG_NEGS,
                                              device=d), False,
                     lambda r: deepwalk_batches(graph, SG_BATCH, SG_WALK, SG_WINDOW, SG_NEGS,
                                                rng=r)),
        "node2vec": (lambda d: DeviceWalkFlow(graph, SG_BATCH, SG_WALK, SG_WINDOW, SG_NEGS,
                                              p=N2V_P, q=N2V_Q, device=d), False,
                     lambda r: deepwalk_batches(graph, SG_BATCH, SG_WALK, SG_WINDOW, SG_NEGS,
                                                p=N2V_P, q=N2V_Q, rng=r)),
        "line": (lambda d: DeviceEdgeFlow(graph, SG_BATCH, SG_NEGS, device=d), True,
                 lambda r: line_batches(graph, SG_BATCH, SG_NEGS, rng=r)),
    }
    res = {"phase": "skipgram_train", "card": card, "nodes": NUM_NODES, "dim": SG_DIM,
           "batch": SG_BATCH, "num_negs": SG_NEGS, "walk_len": SG_WALK, "window": SG_WINDOW,
           "node2vec_pq": [N2V_P, N2V_Q]}
    for name, (make_flow, shared, host_src) in cells.items():
        t0 = time.perf_counter()
        flow = make_flow("cuda")
        if name == "node2vec" and not (flow.biased and flow.max_deg <= 64):
            raise AssertionError(f"node2vec flow biased={flow.biased} max_deg={flow.max_deg}")
        build = make(name, shared)
        est = build(flow, "cuda")
        losses, launches, run_s = _run_counted(torch, est, SG_STEPS)
        _expect_launches(launches, {}, f"the {name} device flow")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name} losses not finite: {losses}")
        cpu = _card_vs_cpu(torch, build, flow, make_flow("cpu"), SG_CPU_STEPS, name)
        src = host_src(np.random.default_rng(seed))
        host = _host_card_vs_cpu(torch, make(f"{name}_host", shared),
                                 [src() for _ in range(SG_CPU_STEPS + 1)], f"{name} host", {})
        timing = _call_window(torch, est, SG_K, SG_CALLS, card, f"{name} device flow", {})
        res[name] = {"losses": losses, "launches": {k: v for k, v in launches.items() if v},
                     "card_vs_cpu": cpu, "host": host, "timing": timing,
                     "pairs_per_step": (SG_BATCH * flow.pairs_per_walk
                                        if name != "line" else SG_BATCH),
                     "seconds": time.perf_counter() - t0}
        del est, flow
    # the quality bands on cora_like, the JAX tests' recipes
    t0 = time.perf_counter()
    cg = Graph.from_json(cora_like_json())
    quality = {name: skipgram_quality(name, "cuda", graph=cg) for name in ("line", "deepwalk")}
    for name, q in quality.items():
        if not q["in_band"]:
            raise AssertionError(f"{name} quality out of its band: {q}")
    res["quality"] = {**quality, "seconds": time.perf_counter() - t0}
    _emit(res)
    return res


def kg_graph(num_entities: int, num_relations: int, num_triples: int, seed: int):
    """A knowledge graph at a given shape, drawn from `seed`: entities
    1..num_entities (unit weights), triples with uniform heads, relations
    and tails, built straight into the port's columnar store (the arrays
    `build_from_json` would make for those edges, without the in-edge
    adjacency no flow of this phase reads)."""
    from euler_tpu_torch.graph import Graph, GraphStore
    from euler_tpu_torch.graph.builder import _csr_adjacency
    from euler_tpu_torch.graph.meta import GraphMeta

    rng = np.random.default_rng(seed)
    ids = np.arange(1, num_entities + 1, dtype=np.uint64)
    h = rng.integers(1, num_entities + 1, num_triples).astype(np.uint64)
    r = rng.integers(0, num_relations, num_triples).astype(np.int32)
    t = rng.integers(1, num_entities + 1, num_triples).astype(np.uint64)
    w = np.ones(num_triples, np.float32)
    arrays = {"node_ids": ids, "node_types": np.zeros(num_entities, np.int32),
              "node_weights": np.ones(num_entities, np.float32), "edge_src": h, "edge_dst": t,
              "edge_types": r, "edge_weights": w}
    arrays.update(_csr_adjacency(ids, h, t, r, w, np.arange(num_triples, dtype=np.int64),
                                 num_relations, "adj"))
    meta = GraphMeta(name="kg", num_partitions=1, num_node_types=1,
                     num_edge_types=num_relations)
    meta.node_weight_sums.append([float(num_entities)])
    ew = np.zeros(num_relations, np.float64)
    np.add.at(ew, r, 1.0)
    meta.edge_weight_sums.append(ew.tolist())
    return Graph(meta, [GraphStore(meta, arrays, 0)])


def kg_train(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 18: the TransX family at FB15k's shape (14 951 entities, 1 345
    relations, 483 142 triples drawn from a seed), dim 100, batch 512, 8
    negatives, adam lr 0.01: each of the six variants 20 steps on
    DeviceKGFlow (finite losses; the first 2 again on the CPU from the
    card's draws: bitwise batches, losses within 1e-4), TransE also
    through kg_batches (card and CPU); TransE timed in calls of SG_K
    steps; the trained TransE saved as a checkpoint for phase 19. Then
    the quality band of tests/test_quality.py:510-546 on fb15k_like on
    the card: the untrained control MeanRank > 600, then after 1 500 steps
    MeanRank in (30, 420) and Hit@10 in (0.32, 0.55)."""
    from euler_tpu_torch.dataflow import DeviceKGFlow
    from euler_tpu_torch.estimator import Estimator, EstimatorConfig
    from euler_tpu_torch.examples.link_quality import transe_quality
    from euler_tpu_torch.models import TransX, kg_batches
    from euler_tpu_torch.models.kg import VARIANTS

    t0 = time.perf_counter()
    g = kg_graph(KG_ENT, KG_REL, KG_TRIPLES, KG_SEED)
    flow, flow_cpu = (DeviceKGFlow(g, KG_BATCH, KG_NEGS, device=d) for d in ("cuda", "cpu"))
    setup_s = time.perf_counter() - t0

    def make(variant: str, name: str):
        def build(fn, device: str):
            cfg = EstimatorConfig(model_dir=os.path.join(tmp, f"{name}_{device}"),
                                  learning_rate=0.01, log_steps=10**9, seed=seed)
            return Estimator(TransX(KG_ENT, KG_REL, dim=KG_DIM, variant=variant), fn, cfg,
                             device=device)
        return build

    res = {"phase": "kg_train", "card": card, "entities": KG_ENT, "relations": KG_REL,
           "triples": KG_TRIPLES, "dim": KG_DIM, "batch": KG_BATCH, "num_negs": KG_NEGS,
           "setup_s": setup_s, "variants": {}}
    transe = None
    for variant in VARIANTS:
        t = time.perf_counter()
        est = make(variant, variant)(flow, "cuda")
        losses, launches, _ = _run_counted(torch, est, KG_STEPS)
        _expect_launches(launches, {}, f"{variant} on DeviceKGFlow")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{variant} losses not finite: {losses}")
        cpu = _card_vs_cpu(torch, make(variant, f"{variant}_cmp"), flow, flow_cpu,
                           KG_CPU_STEPS, variant)
        res["variants"][variant] = {"losses": losses, "card_vs_cpu": cpu,
                                    "seconds": time.perf_counter() - t}
        if variant == "transe":
            transe = est
        else:
            del est
    src = kg_batches(g, KG_BATCH, KG_NEGS, rng=np.random.default_rng(seed))
    res["transe_host"] = _host_card_vs_cpu(torch, make("transe", "transe_host"),
                                           [src() for _ in range(KG_CPU_STEPS + 1)],
                                           "transe host", {})
    res["transe_timing"] = _call_window(torch, transe, SG_K, SG_CALLS, card,
                                        "transe device flow", {})
    ckpt = transe.save()
    # the quality band on fb15k_like, the JAX test's recipe
    t = time.perf_counter()
    quality = transe_quality("cuda")
    if not quality["in_band"]:
        raise AssertionError(f"TransE quality out of its bands: {quality}")
    res["quality"] = {**quality, "seconds": time.perf_counter() - t}
    _emit(res)
    return {"result": res, "checkpoint": ckpt, "model_dir": transe.cfg.model_dir,
            "graph": g, "estimator": transe}


def kg_retrieve(torch, trained: dict, card: str) -> dict:
    """Phase 19: phase 18's TransE entity table from its committed
    checkpoint (`EmbeddingCorpus.from_checkpoint(leaf=)`, every table row
    an id, the padding rows masked out), served by TopKIndex on the card:
    KGR_QUERIES (h, r) queries normalize(E[h]) + R[r] at buckets 1, 4 and
    16, cosine, k KGR_K: answers bitwise numpy_topk_oracle's, one
    paged_topk_score and one paged_topk_select launch a search."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.params import checkpoint_order
    from euler_tpu_torch.retrieval import EmbeddingCorpus, TopKIndex
    from euler_tpu_torch.retrieval.topk import numpy_topk_oracle

    est = trained["estimator"]
    sd = est.model.state_dict()
    keys = checkpoint_order(sd)
    rows = sd["entity.table"].shape[0]
    ids = np.arange(rows, dtype=np.uint64)
    corpus = EmbeddingCorpus.from_checkpoint(trained["model_dir"], ids, metric="cosine",
                                             leaf=keys.index("entity.table"))
    want = EmbeddingCorpus.build(ids, sd["entity.table"].cpu().numpy(), metric="cosine")
    if corpus.step != est.step or not np.array_equal(corpus.vectors, want.vectors):
        raise AssertionError("the corpus is not the checkpoint's entity table")
    index = TopKIndex(corpus, device="cuda")
    mask = (ids >= 1) & (ids <= KG_ENT)
    e = trained["graph"].sample_edge(KGR_QUERIES, rng=np.random.default_rng(31))
    ent, rel = sd["entity.table"].cpu().numpy(), sd["relation.table"].cpu().numpy()
    head = ent[e[:, 0].astype(np.int64)]
    q = (head / np.maximum(np.linalg.norm(head, axis=1, keepdims=True), 1e-12)
         + rel[e[:, 2].astype(np.int64)]).astype(np.float32)
    index.warmup(KGR_K, buckets=KGR_BUCKETS)
    ops.reset_launch_counts()
    answers = [index.search(q[:b], KGR_K, mask) for b in KGR_BUCKETS]
    launches = ops.launch_counts()
    want = {"paged_topk_score": len(KGR_BUCKETS), "paged_topk_select": len(KGR_BUCKETS)}
    _expect_launches(launches, want, "the TransE table's searches")
    for b, got in zip(KGR_BUCKETS, answers):
        oracle = numpy_topk_oracle(ids, ent, q[:b], KGR_K, metric="cosine", mask=mask)
        if not _same_answer(got, oracle):
            raise AssertionError(f"TransE retrieval at bucket {b} differs from the oracle")
    res = {"phase": "kg_retrieve", "card": card, "rows": int(rows), "dim": KG_DIM,
           "checkpoint": os.path.basename(trained["checkpoint"]), "k": KGR_K,
           "buckets": list(KGR_BUCKETS), "launches": {k: v for k, v in launches.items() if v},
           "bitwise_vs_oracle": True, "templates": dict(index.templates)}
    _emit(res)
    return {"launches": launches, "result": res}


def run_model_cli(torch, tmp: str, card: str) -> dict:
    """Phase 20: `python -m euler_tpu_torch.examples.run_model` as
    processes, on the card, on --synthetic data (cora for
    graphsage_unsup / deepwalk / line / gcn / gat, fb15k for transe,
    converted once beforehand): train with and without --device-flow (12
    processes at once), then --mode evaluate (transe) and infer (deepwalk, line,
    graphsage_unsup) on the device-flow runs' dirs (4 at once): every one
    exits 0 with its result line."""
    from euler_tpu_torch.datasets import get_dataset

    env = dict(os.environ, EULER_TPU_DATA=os.path.join(tmp, "cli_data"))
    prev = os.environ.get("EULER_TPU_DATA")
    os.environ["EULER_TPU_DATA"] = env["EULER_TPU_DATA"]
    try:
        for name in ("cora", "fb15k"):
            get_dataset(name).load_graph(synthetic=True)
    finally:
        if prev is None:
            os.environ.pop("EULER_TPU_DATA", None)
        else:
            os.environ["EULER_TPU_DATA"] = prev

    def cmd(model, flow, mode):
        return [sys.executable, "-m", "euler_tpu_torch.examples.run_model", "--model", model,
                "--dataset", "fb15k" if model == "transe" else "cora", "--synthetic",
                "--mode", mode, "--total-steps", str(CLI_RM_STEPS),
                "--model-dir", os.path.join(tmp, f"cli_runs_{flow}")] + (
                    ["--device-flow"] if flow == "device" else [])

    def wave(jobs):
        procs = [(job, subprocess.Popen(cmd(*job), env=env, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)) for job in jobs]
        out = {}
        for job, p in procs:
            try:
                text, _ = p.communicate(timeout=CLI_WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                raise
            last = text.strip().splitlines()[-1] if text.strip() else ""
            if p.returncode != 0:
                raise AssertionError(f"run_model {' '.join(job)} exited {p.returncode}:\n{text}")
            out[" ".join(job)] = last[:200]
        return out

    t0 = time.perf_counter()
    flows = ("host", "device")
    trained = wave([(m, f, "train") for m in CLI_RM_MODELS for f in flows])
    if not all("trained" in v for v in trained.values()):
        raise AssertionError(f"run_model train runs: {trained}")
    later = wave([(m, "device", mode)
                  for m, mode in (("transe", "evaluate"), ("deepwalk", "infer"), ("line", "infer"),
                                  ("graphsage_unsup", "infer"))])
    res = {"phase": "run_model_cli", "card": card, "steps": CLI_RM_STEPS, "train": trained,
           "evaluate_infer": later, "seconds": time.perf_counter() - t0}
    _emit(res)
    return res


def conv_train(torch, tmp: str, seed: int, card: str) -> dict:
    """Phase 21: the conv zoo's first half on phase 5's paged device lane
    (skewed_weighted_graph 200 000 nodes, bf16 weight plane,
    DeviceSageFlow(fanouts 10,10, batch 1024, paged, P = 16)), each conv
    through SuperviseModel at dims 128,128, adam lr 0.01: 20 steps in mode
    auto with exactly CONV_PER_STEP launches a step (2 paged_sample_hop,
    and for GAT 3 of kernel 1 and 3 of its dx; none of kernels 2-4);
    the first 3 steps again in mode ref on the card (bitwise batches,
    losses within 1e-4 relative) and 2 on the CPU from the card's draws
    (bitwise batches, losses within 1e-4); for GCN and GAT 20 steps at
    K = 16 (replays, the same launches, losses within 1e-4 of K = 1's);
    calls of CONV_K steps timed at K = 1 (and K = 16)."""
    from euler_tpu_torch.dataflow import DeviceSageFlow
    from euler_tpu_torch.datasets import skewed_weighted_graph
    from euler_tpu_torch.estimator import DeviceFeatureCache, Estimator, EstimatorConfig
    from euler_tpu_torch.nn import SuperviseModel

    t0 = time.perf_counter()
    g = skewed_weighted_graph(TRAIN_NODES, TRAIN_GRAPH_SEED)
    prev_dtype = os.environ.get("EULER_TPU_PAGE_DTYPE")
    os.environ["EULER_TPU_PAGE_DTYPE"] = "bf16"
    try:
        def lane(device: str):
            return (DeviceSageFlow(g, fanouts=TRAIN_FANOUTS, batch_size=TRAIN_BATCH,
                                   label_feature="label", layout="paged", page_size=PAGE_SIZE,
                                   device=device),
                    DeviceFeatureCache(g, ["feat"], device=device))

        flow, cache = lane("cuda")
        flow_cpu, cache_cpu = lane("cpu")
    finally:
        if prev_dtype is None:
            os.environ.pop("EULER_TPU_PAGE_DTYPE", None)
        else:
            os.environ["EULER_TPU_PAGE_DTYPE"] = prev_dtype
    if not flow._page_w_packed:
        raise AssertionError("the conv lane did not stage a packed weight plane")
    setup_s = time.perf_counter() - t0

    def estimator(conv: str, f, fc, device: str, name: str, k: int = 1):
        cfg = EstimatorConfig(model_dir=os.path.join(tmp, f"conv_{name}"), learning_rate=0.01,
                              optimizer="adam", log_steps=10**9, seed=seed, steps_per_call=k)
        model = SuperviseModel(TRAIN_FEAT, conv, TRAIN_DIMS, 2, conv_kwargs=CONV_KWARGS.get(conv))
        return Estimator(model, f, cfg, feature_cache=fc, device=device)

    convs = {}
    for conv in CONV_NAMES:
        t = time.perf_counter()
        per_step = CONV_PER_STEP.get(conv, {HOP_KERNEL: 2})
        want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
        # (a) the main path, mode auto
        est = estimator(conv, flow, cache, "cuda", conv)
        tap = _Tap(flow, REF_STEPS)
        losses, launches, _ = _run_counted(torch, est, TRAIN_STEPS)
        tap.close()
        _expect_launches(launches, want, f"{conv} on the paged device lane")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{conv} losses not finite: {losses}")
        # (b) mode ref on the card: the plain versions, the same batches
        tap_ref = _Tap(flow, REF_STEPS)
        losses_ref, launches_ref, _ = _run_counted(
            torch, estimator(conv, flow, cache, "cuda", f"{conv}_ref"), REF_STEPS, "ref")
        tap_ref.close()
        if any(launches_ref.values()):
            raise AssertionError(f"{conv}: mode ref launched kernels: {launches_ref}")
        same_ref = _same_nests(torch, tap_ref.batches, tap.batches, f"{conv} auto vs ref")
        err_ref = _assert_close(losses_ref, losses[:REF_STEPS], f"{conv} auto vs ref")
        # (c) the port on the CPU, from the card's draws
        draws = iter([_to_cpu(torch, d) for d in tap.draws[:CPU_STEPS]])
        flow_cpu.draw_inputs = lambda gen: next(draws)
        tap_cpu = _Tap(flow_cpu, CPU_STEPS)
        try:
            losses_cpu = estimator(conv, flow_cpu, cache_cpu, "cpu", f"{conv}_cpu").train(
                CPU_STEPS, log=False, save=False)
        finally:
            tap_cpu.close()  # drops the instance's draw_inputs: the flow's own again
        same_cpu = _same_nests(torch, tap_cpu.batches, tap.batches[:CPU_STEPS],
                               f"{conv} card vs CPU")
        err_cpu = _assert_close(losses_cpu, losses[:CPU_STEPS], f"{conv} card vs CPU")
        row = {"losses": losses, "launches": launches, "launches_per_step": per_step,
               "ref_on_card": {"batches_equal": same_ref, "losses": losses_ref,
                               "max_rel_err": err_ref},
               "port_on_cpu": {"batches_equal": same_cpu, "losses": losses_cpu,
                               "max_rel_err": err_cpu},
               "params": sum(p.numel() for p in est.model.parameters()),
               "timing_k1": _call_window(torch, est, CONV_K, CONV_CALLS, card,
                                         f"{conv} K = 1", per_step)}
        # (d) K = 16: the captured step replayed
        if conv in CONV_GROUPED:
            est16 = estimator(conv, flow, cache, "cuda", f"{conv}_k16", k=GROUP_K)
            losses16, launches16, _ = _run_counted(torch, est16, TRAIN_STEPS)
            _expect_launches(launches16, want, f"{conv} on the paged device lane at K = {GROUP_K}")
            replays = _replay_launches(est16, launches16,
                                       {k: n * est16.captures for k, n in per_step.items()})
            row["k16"] = {"losses": losses16, "launches": launches16, "captures": est16.captures,
                          "max_rel_err": _assert_close(losses16, losses,
                                                       f"{conv} K = {GROUP_K} vs K = 1"),
                          **replays}
            row[f"timing_k{GROUP_K}"] = _call_window(torch, est16, CONV_K, CONV_CALLS, card,
                                                     f"{conv} K = {GROUP_K}", per_step)
            del est16
        row["seconds"] = time.perf_counter() - t
        convs[conv] = row
        del est
        torch.cuda.empty_cache()
    res = {"phase": "conv_train", "card": card, "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
           "fanouts": TRAIN_FANOUTS, "dims": TRAIN_DIMS, "layout": "paged",
           "page_size": PAGE_SIZE, "steps": TRAIN_STEPS, "conv_kwargs": CONV_KWARGS,
           "convs": convs, "setup_s": setup_s, "rtol": TRAIN_TOL}
    _emit(res)
    return {"launches": {c: r["launches"] for c, r in convs.items()},
            "launches_k16": {c: convs[c]["k16"]["launches"] for c in CONV_GROUPED},
            "result": res}


def conv_quality_bands(torch, card: str) -> dict:
    """Phase 22: the JAX package's full-graph quality recipes on the card
    (`examples/conv_quality.py`: FullGraphFlow(gcn_norm=True) on cora_like
    at its full size, 200 steps, the 140-label split; GAT also at the
    640-label pool, 300 steps), each model from the JAX test's init
    (`params.flax_init`): the F1 of seed 0, the JAX tests' seed, in its
    band. The whole-graph block has no
    grid, so no kernel of the port launches."""
    from euler_tpu_torch import ops
    from euler_tpu_torch.examples.conv_quality import RECIPES, conv_quality, cora_like

    t0 = time.perf_counter()
    data = cora_like()
    ops.reset_launch_counts()
    recipes = {}
    for name in RECIPES:
        t = time.perf_counter()
        recipes[name] = {**conv_quality(name, "cuda", data), "seconds": time.perf_counter() - t}
    launches = ops.launch_counts()
    res = {"phase": "conv_quality", "card": card, "recipes": recipes, "launches": launches,
           "seconds": time.perf_counter() - t0}
    _emit(res)
    out = {name: r["f1"] for name, r in recipes.items() if not r["in_band"]}
    if out:
        raise AssertionError(f"conv quality out of its band: {out}")
    _expect_launches(launches, {}, "the full-graph recipes")
    return res


def check_gat_dx(torch, gen) -> dict:
    """Kernel 1's dx at GAT's shapes (a step's three launches, F = 128)
    with GAT's weights and slots that repeat: within rtol = atol = 1e-5
    of the plain backward's f32 sum (the grid's own slots, which never
    repeat, are held bitwise in `time_dx`)."""
    from euler_tpu_torch.ops import gather_weighted_sum_dx, gather_weighted_sum_dx_ref

    dev = torch.device("cuda")
    max_err = 0.0
    for label, n, d, f in gws_shapes(TRAIN_BATCH, TRAIN_DIMS[0]):
        n_src = n * d
        slots = torch.randint(0, n_src // 4, (n, d), generator=gen, device=dev, dtype=torch.int32)
        w = _weights(torch, gen, n, d, True)
        g = torch.randn(n, f, generator=gen, device=dev)
        got = gather_weighted_sum_dx(w, g, slots, n_src, torch.float32, "cuda")
        want = gather_weighted_sum_dx_ref(w, g, slots, n_src, torch.float32)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"gather_weighted_sum_dx at GAT's {label} with repeated slots: "
                                 f"max abs err {err}")
    res = {"phase": "kernel_check", "kernel": "gather_weighted_sum_dx",
           "what": "GAT step shapes, repeated slots", "max_abs_err": max_err,
           "rtol": KERNEL_TOL, "atol": KERNEL_TOL}
    _emit(res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", default=None,
                    help="serve this checkpoint instead of seeded random weights")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from euler_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = _card_line()
    print(card, flush=True)
    _emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count()})

    # 2. build
    t0 = time.perf_counter()
    builds = _build.build_all()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": {k: {"seconds": v["seconds"], "built": v["built"]}
                       for k, v in builds.items()}})
    for name, info in builds.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[{name}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # 3. kernels against their plain versions
    check = check_kernel(torch, gen)
    dx_check = check_dx(torch, gen)
    paged_check = check_paged_kernels(torch, gen)
    topk_check = check_topk_kernel(torch, gen)
    select_check = check_topk_select(torch, gen)

    with tempfile.TemporaryDirectory(prefix="euler_smoke_") as tmp:
        # 4. the served path, and its timings
        t0 = time.perf_counter()
        write_graph(tmp)
        _emit({"phase": "graph", "nodes": NUM_NODES, "out_degree": OUT_DEGREE,
               "feat_dim": FEAT_DIM, "seconds": time.perf_counter() - t0})
        served = serve(torch, tmp, args.model_dir, args.seed)
        latency = time_predict(served["runtime"], served["req_rng"])
        _emit({"phase": "predict_latency", "card": card, "buckets": latency})
        profile_predict(torch, served["runtime"], served["req_rng"])
        del served["runtime"]

        # 5. the training path, and its timings
        trained = train(torch, tmp, args.seed)
        time_train_steps(torch, trained["estimator"], card)
        grouped = train_grouped(torch, trained, tmp, args.seed, card)
        paged_calls, hops = _paged_calls(trained["flow"], gen)
        paged_rows = time_paged_kernels(torch, paged_calls, card)
        hop_rows = time_hop_kernel(torch, hops, card)
        del paged_calls, hops
        del trained["estimator"], trained["flow"]
        torch.cuda.empty_cache()

        # 6. the retrieval path, and its timings
        retrieved = retrieve(torch, tmp, args.seed)
        time_retrieve(torch, retrieved["engine"], retrieved["pool"], card)
        topk_rows = time_topk_kernel(torch, retrieved["engine"], retrieved["pool"], card)
        # 6b-6d. the retrieval front end: bench.py's retrieval lane, phase
        # 6's cell served by a fleet over TCP, the CLI's selftest
        lane = retrieve_lane(torch, card)
        retr_fleet = retrieve_fleet(torch, retrieved, args.seed, card)
        retrieve_selftest(card)
        del retrieved["engine"], retrieved["data"]
        torch.cuda.empty_cache()

        # 7-9. the host-batch training lane (numpy, then the native
        # engine), the trainer CLI, infer parity
        host = train_host(torch, tmp, args.seed, card)
        products = os.path.join(tmp, "products")
        write_products(host["graph"], products)
        host_native = train_host_native(torch, products, host, tmp, args.seed, card)
        cli = train_cli(torch, products, tmp)
        parity = infer_parity(torch, cli["data"], cli["model_dir"], host["te_ids"][:INFER_IDS])
        del host["graph"]
        torch.cuda.empty_cache()

        # 10. the headline training leg, at K = 1 and K = 64, f32 and bf16
        head = headline(torch, tmp, args.seed, card)
        torch.cuda.empty_cache()

        # 11-12. bench.py's host training leg through the native engine and
        # the rows-mode lean lane, then the lane's self-checks
        host_head = host_headline(torch, tmp, args.seed, card)
        rows_lane(torch, host_head["graph"], host_head["cache"], tmp, args.seed)
        del host_head["graph"], host_head["cache"]
        torch.cuda.empty_cache()

        # 13-15. the serving front end over TCP: bench.py's serving lane on
        # phase 4's graph, its parity and admission checks, the fleet lane
        tcp = serve_tcp(torch, served["graph"], tmp, card)
        tcp_parity = serve_parity(torch, served["graph"], tcp, card)
        fleet = serve_fleet(torch, tmp, card)
        served_paths = {"serve_tcp": tcp["result"], "serve_parity": tcp_parity,
                        "serve_fleet": fleet}

        # 16-20. the link-prediction and shallow-embedding families: the
        # unsupervised GraphSAGE lane, the skip-gram family on phase 4's
        # graph, the TransX family, its table served, the run_model CLI
        unsup = unsup_train(torch, tmp, args.seed, card)
        torch.cuda.empty_cache()
        skipgram_train(torch, served.pop("graph"), tmp, args.seed, card)
        torch.cuda.empty_cache()
        kg = kg_train(torch, tmp, args.seed, card)
        kg_search = kg_retrieve(torch, kg, card)
        del kg
        torch.cuda.empty_cache()
        run_model_cli(torch, tmp, card)

        # 21-22. the conv zoo's first half: each conv on the paged device
        # lane, then the JAX quality tests' full-graph recipes on the card
        convs = conv_train(torch, tmp, args.seed, card)
        torch.cuda.empty_cache()
        conv_quality_bands(torch, card)
        torch.cuda.empty_cache()
    serve_rows = time_kernels(torch, gen, gws_shapes(128, FEAT_DIM), "bucket-128 predict")
    train_rows = time_kernels(torch, gen, gws_shapes(TRAIN_BATCH, TRAIN_FEAT), "train step")
    dx_rows = (time_dx(torch, gen, gws_shapes(128, FEAT_DIM), "bucket-128 predict")
               + time_dx(torch, gen, gws_shapes(TRAIN_BATCH, TRAIN_FEAT), "train step"))
    # the path's one dx a step: layer 1 over hop 0 of a train step
    dx_path = dx_rows[-1]
    host_rows = time_kernels(torch, gen, HOST_SHAPES, "host lane")
    host_dx_rows = time_dx(torch, gen, HOST_SHAPES[2:3], "host train step")
    # the headline step: layer 1 reads f32 x under f32 convs and bf16 x
    # under bf16 convs (layer 0 reads the f32 features either way), and
    # its dx is written in the convs' type
    head_shapes = gws_shapes(HEAD_BATCH, HEAD_FEAT)
    head_bf16 = ("layer1 hop0 bf16 x",) + head_shapes[2][1:]
    head_rows = time_kernels(torch, gen, head_shapes + (head_bf16,), "headline step",
                             bf16=(head_bf16[0],))
    head_dx_rows = (time_dx(torch, gen, head_shapes[2:], "headline step, f32 convs")
                    + time_dx(torch, gen, (head_bf16,), "headline step, bf16 convs",
                              torch.bfloat16))
    # the unsupervised step (phase 16): src and pos batches of UNSUP_BATCH
    # roots, the negs batch of UNSUP_BATCH * UNSUP_NEGS; dx on each layer 1
    unsup_shapes = (tuple(("src/pos " + s[0],) + s[1:] for s in gws_shapes(UNSUP_BATCH, TRAIN_FEAT))
                    + tuple(("negs " + s[0],) + s[1:]
                            for s in gws_shapes(UNSUP_BATCH * UNSUP_NEGS, TRAIN_FEAT)))
    unsup_rows = time_kernels(torch, gen, unsup_shapes, "unsup step")
    unsup_dx_rows = time_dx(torch, gen, unsup_shapes[2::3], "unsup step")
    # GAT's step (phase 21): every call gathers h_src = W·x (F = 128) with
    # attention weights, and each call's dx runs (h_src carries a gradient)
    gat_shapes = gws_shapes(TRAIN_BATCH, TRAIN_DIMS[0])
    gat_rows = time_kernels(torch, gen, gat_shapes, "gat step", attention=True)
    gat_dx_rows = time_dx(torch, gen, gat_shapes, "gat step", attention=True)
    gat_dx_check = check_gat_dx(torch, gen)

    def total(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)

    def bound_by(rows):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"

    def unsup_step(rows):
        """One unsupervised step's sum: twice the src/pos rows, once the negs'."""
        half = len(rows) // 2
        return {k: 2 * total(rows[:half], k) + total(rows[half:], k)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    # 6. the kernels line: per kernel, the sums over the launches of one
    # bucket-128 predict (gather_weighted_sum) or one train step (paged)
    train_launches = trained["launches"]
    host_launches = {
        "train_grouped": grouped["launches"]["gather_weighted_sum"],
        "train_host": host["launches"]["gather_weighted_sum"],
        "train_host_grouped": host["grouped_launches"]["gather_weighted_sum"],
        "evaluate": host["eval_launches"]["gather_weighted_sum"],
        "train_cli": cli["launches"]["gather_weighted_sum"],
        "infer": parity["launches"]["infer"], "predict": parity["launches"]["predict"],
        "headline": head["launches"]["gather_weighted_sum"],
        "train_host_native": host_native["launches"]["gather_weighted_sum"],
        "host_headline": host_head["launches"]["gather_weighted_sum"],
        **{path: r["gather_weighted_sum"] for path, r in served_paths.items()},
        **{path: unsup[key]["gather_weighted_sum"] for path, key in UNSUP_PATHS},
        **{f"conv_train_{c}": n["gather_weighted_sum"] for c, n in convs["launches"].items()},
        **{f"conv_train_{c}_k16": n["gather_weighted_sum"]
           for c, n in convs["launches_k16"].items()}}
    host_dx_launches = {"train_grouped": grouped["launches"]["gather_weighted_sum_dx"],
                        "train_host": host["launches"]["gather_weighted_sum_dx"],
                        "train_host_grouped": host["grouped_launches"]["gather_weighted_sum_dx"],
                        "train_cli": cli["launches"]["gather_weighted_sum_dx"],
                        "headline": head["launches"]["gather_weighted_sum_dx"],
                        "train_host_native": host_native["launches"]["gather_weighted_sum_dx"],
                        "host_headline": host_head["launches"]["gather_weighted_sum_dx"],
                        **{path: r["gather_weighted_sum_dx"] for path, r in served_paths.items()},
                        **{path: unsup[key]["gather_weighted_sum_dx"]
                           for path, key in UNSUP_PATHS},
                        **{f"conv_train_{c}": n["gather_weighted_sum_dx"]
                           for c, n in convs["launches"].items()},
                        **{f"conv_train_{c}_k16": n["gather_weighted_sum_dx"]
                           for c, n in convs["launches_k16"].items()}}
    shape_keys = ("shape", "N", "D", "F", "geometry", "ms", "warm_ms", "plain_ms",
                  "library_ms", "bound_ms")
    kernels = [{
        "name": "gather_weighted_sum",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/gather_weighted_sum.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:96",
        "launches": (served["launches"] + train_launches["gather_weighted_sum"]
                     + sum(host_launches.values())),
        "launches_by_path": {"serve": served["launches"],
                             "train": train_launches["gather_weighted_sum"], **host_launches},
        "max_abs_err": check["max_abs_err"],
        "ms": total(serve_rows, "ms"),
        "plain_ms": total(serve_rows, "plain_ms"),
        "bound_ms": total(serve_rows, "bound_ms"),
        "bound_by": bound_by(serve_rows),
        "library_ms": total(serve_rows, "library_ms"),
        "card": card,
        "shapes": [{k: r[k] for k in ("shape", "N", "D", "F", "geometry", "max_abs_err", "ms",
                                      "warm_ms", "plain_ms", "library_ms", "bound_ms")}
                   for r in serve_rows],
        "train_step": {k: total(train_rows, k) for k in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms")},
        "train_shapes": [{k: r[k] for k in ("shape", "N", "D", "F", "geometry", "max_abs_err",
                                            "ms", "warm_ms", "plain_ms", "library_ms",
                                            "bound_ms")}
                         for r in train_rows],
        "host_train_step": {k: total(host_rows[:3], k) for k in ("ms", "plain_ms",
                                                                 "library_ms", "bound_ms")},
        "host_shapes": [{k: r[k] for k in shape_keys + ("max_abs_err",)} for r in host_rows],
        "headline_step": {convs: {k: total(rows, k) for k in ("ms", "plain_ms", "library_ms",
                                                               "bound_ms")}
                          for convs, rows in (("f32", head_rows[:3]),
                                              ("bf16", head_rows[:2] + head_rows[3:]))},
        "headline_shapes": [{k: r[k] for k in shape_keys + ("x_dtype", "max_abs_err")}
                            for r in head_rows],
        "unsup_step": unsup_step(unsup_rows),
        "unsup_shapes": [{k: r[k] for k in shape_keys + ("max_abs_err",)} for r in unsup_rows],
        "gat_step": {k: total(gat_rows, k) for k in ("ms", "plain_ms", "library_ms",
                                                     "bound_ms")},
        "gat_shapes": [{k: r[k] for k in shape_keys + ("max_abs_err",)} for r in gat_rows],
    }, {
        "name": "gather_weighted_sum_dx",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/gather_weighted_sum.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:166-187",
        "replaces_what": "the custom VJP's dx of gather_weighted_sum: a scatter-add of w*g "
                         "in plain JAX, outside any Pallas kernel",
        "launches": (served["launches_dx"] + train_launches["gather_weighted_sum_dx"]
                     + sum(host_dx_launches.values())),
        "launches_by_path": {"serve": served["launches_dx"],
                             "train": train_launches["gather_weighted_sum_dx"],
                             **host_dx_launches},
        "max_abs_err": max(dx_check["max_abs_err"], gat_dx_check["max_abs_err"]),
        "check": "bitwise for unique slots, rtol = atol = 1e-5 for repeats",
        "ms": dx_path["ms"],
        "plain_ms": dx_path["plain_ms"],
        "bound_ms": dx_path["bound_ms"],
        "bound_by": dx_path["bound_by"],
        "library_ms": dx_path["library_ms"],
        "library": "embedding_bag backward with respect to the table",
        "card": card,
        "shapes": [{k: r[k] for k in shape_keys} for r in dx_rows],
        "host_shapes": [{k: r[k] for k in shape_keys} for r in host_dx_rows],
        "headline_shapes": [{k: r[k] for k in shape_keys + ("dx_dtype",)}
                            for r in head_dx_rows],
        "unsup_step": unsup_step(unsup_dx_rows),
        "unsup_shapes": [{k: r[k] for k in shape_keys} for r in unsup_dx_rows],
        "gat_step": {k: total(gat_dx_rows, k) for k in ("ms", "plain_ms", "library_ms",
                                                        "bound_ms")},
        "gat_shapes": [{k: r[k] for k in shape_keys} for r in gat_dx_rows],
    }]
    # the hop kernel: the sums over the two hops of one train step
    kernels.append({
        "name": HOP_KERNEL,
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/paged_sample_hop.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:356, :436, :247 and :478-503 "
                    "(paged_page_search), as euler_tpu/dataflow/device.py:922-975 "
                    "composes them",
        "launches": (train_launches[HOP_KERNEL] + grouped["launches"][HOP_KERNEL]
                     + unsup["launches"][HOP_KERNEL] + unsup["launches_k16"][HOP_KERNEL]
                     + sum(n[HOP_KERNEL] for n in convs["launches"].values())
                     + sum(n[HOP_KERNEL] for n in convs["launches_k16"].values())),
        "launches_by_path": {"train": train_launches[HOP_KERNEL],
                             "train_grouped": grouped["launches"][HOP_KERNEL],
                             "unsup_train": unsup["launches"][HOP_KERNEL],
                             "unsup_train_k16": unsup["launches_k16"][HOP_KERNEL],
                             **{f"conv_train_{c}": n[HOP_KERNEL]
                                for c, n in convs["launches"].items()},
                             **{f"conv_train_{c}_k16": n[HOP_KERNEL]
                                for c, n in convs["launches_k16"].items()}},
        "max_abs_err": paged_check["max_abs_err"],
        "check": "bitwise",
        "cases": paged_check["hop_cases"],
        "ms": total(hop_rows, "ms"),
        "warm_ms": total(hop_rows, "warm_ms"),
        "plain_ms": total(hop_rows, "plain_ms"),
        "composition_ms": total(hop_rows, "composition_ms"),
        "bound_ms": total(hop_rows, "bound_ms"),
        "bound_by": bound_by(hop_rows),
        "library_ms": None,
        "library": "none: no one PyTorch call draws a hop",
        "card": card,
        "shapes": [{k: r[k] for k in ("hop", "shape", "ms", "warm_ms", "plain_ms",
                                      "composition_ms", "device_ops_per_call", "bound_ms")}
                   for r in hop_rows],
    })
    # kernels 2-4: off the train path (the hop kernel does their work),
    # timed standalone at the inputs the hop's plain version gives them
    sources = {"paged_gather": ("paged_gather.cu", 247),
               "paged_gather_dequant": ("paged_gather.cu", 356),
               "paged_cdf_count": ("paged_cdf_count.cu", 436)}
    for name in PAGED_KERNELS:
        rows = [r for r in paged_rows if r["kernel"] == name]
        src, line = sources[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"euler_tpu_torch/ops/csrc/{src}",
            "replaces": f"euler_tpu/ops/pallas_kernels.py:{line}",
            "launches": (train_launches[name] + unsup["launches"][name]
                         + sum(n[name] for n in convs["launches"].values())),
            "launches_by_path": {"train": train_launches[name],
                                 "unsup_train": unsup["launches"][name],
                                 "conv_train": sum(n[name] for n in convs["launches"].values())},
            "max_abs_err": paged_check["max_abs_err"],
            "check": "bitwise",
            "ms": total(rows, "ms"),
            "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": bound_by(rows),
            "library_ms": total(rows, "library_ms"),
            "card": card,
            "shapes": [{k: r[k] for k in ("hop", "shape", "ms", "warm_ms", "plain_ms",
                                          "library_ms", "bound_ms")} for r in rows],
        })
    # paged_topk_score and paged_topk_select: the sums over one unfiltered
    # search of each bucket; launches on phase 6's path and the front end's
    retr_launches = {name: {"retrieve": retrieved["launches"][name],
                            "retrieve_lane": lane["launches"][name],
                            "kg_retrieve": kg_search["launches"][name],
                            **{f"retrieve_fleet_{w}": retr_fleet[w]["launches"][name]
                               for w in ("steady", "roll", "failover")}}
                     for name in ("paged_topk_score", "paged_topk_select")}
    t_bytes = sum(r["bytes_ms"] for r in topk_rows if r["bound_by"] == "bytes")
    t_ops = sum(r["ops_ms"] for r in topk_rows if r["bound_by"] == "operations")
    other = {"fma": "mul_add_ms", "mul_add": "fma_ms"}
    kernels.append({
        "name": "paged_topk_score",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/topk_score.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:534",
        "launches": sum(retr_launches["paged_topk_score"].values()),
        "launches_by_path": retr_launches["paged_topk_score"],
        "templates_on_path": retrieved["templates"],
        "max_abs_err": topk_check["max_abs_err"],
        "check": "bitwise",
        "ms": total(topk_rows, "ms"),
        "warm_ms": total(topk_rows, "warm_ms"),
        "plain_ms": total(topk_rows, "plain_ms"),
        "bound_ms": total(topk_rows, "bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total(topk_rows, "library_ms"),
        "card": card,
        "shapes": [{**{k: r[k] for k in ("bucket", "nrows", "dp", "template", "ms", "warm_ms",
                                         "plain_ms", "library_ms", "bound_ms", "bound_by")},
                    other[r["template"]]: r[other[r["template"]]]} for r in topk_rows],
    })
    sel = [r["select"]["unfiltered"] for r in topk_rows]
    kernels.append({
        "name": "paged_topk_select",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/topk_score.cu",
        "replaces": "euler_tpu/retrieval/topk.py:92",
        "replaces_what": "jax.lax.top_k over the masked scores, outside any Pallas kernel",
        "launches": sum(retr_launches["paged_topk_select"].values()),
        "launches_by_path": retr_launches["paged_topk_select"],
        "max_abs_err": select_check["max_abs_err"],
        "check": "bitwise",
        "ms": total(sel, "select_ms"),
        "plain_ms": total(sel, "plain_ms"),
        "bound_ms": total(sel, "bound_ms"),
        "bound_by": "bytes",
        "library_ms": total(sel, "canonical_topk_ms"),
        "torch_topk_ms": total(sel, "torch_topk_ms"),
        "stage2_ms": total(sel, "stage2_ms"),
        "card": card,
        "shapes": [{"bucket": r["bucket"], **{k: r["select"][f][k] for k in (
                        "select_ms", "plain_ms", "stage2_ms", "canonical_topk_ms",
                        "torch_topk_ms", "bound_ms")},
                    "filtered": f == "filtered"}
                   for r in topk_rows for f in ("unfiltered", "filtered")],
    })
    _emit({"kernels": kernels})
    # 7. the device
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
