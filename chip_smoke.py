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
     and last elements and odd and even bf16 halves;
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
     launch counts (reset just before) must grow by 6 paged launches, 3
     gather_weighted_sum launches and 1 gather_weighted_sum_dx launch (layer
     1's backward: layer 0's x are features, with no gradient) a step,
     with finite, falling losses;
     (b) the first 3 steps again in mode 'ref' on the card: bitwise equal
     batches, losses within 1e-4 relative; (c) 2 steps of the port on the
     CPU from the same draws: losses within 1e-4; (d) 3 steps with the f32
     weight plane: bitwise equal batches; (e) `save()`, and the port's
     InferenceRuntime serves that checkpoint. Then the median step time,
     the device idle share over 10 profiled steps, each paged kernel's
     time at the shapes of the two hops against its plain version,
     `flat[fidx]` (paged_gather) and its bound, and gather_weighted_sum's
     and its dx kernel's at the shapes of one step, checked as in 4;
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
     scores and its bound.
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
import json
import math
import os
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
TOPK_SWEEP_DP = (1, 8, 32, 64, 128, 256)
TOPK_SWEEP_ROWS = (1, 127, 1001, 100_003)
TOPK_SWEEP_B = (1, 2, 3, 8, 16, 20, 64, 65)  # every block shape of the scorer
PROFILE_WINDOWS = 3
SELECT_TILES = (1024, 8192)
SELECT_ROWS = (1, 1000, 10_007, 100_003)
SELECT_BP, SELECT_B = 16, 13


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _emit(obj) -> None:
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
    return {"runtime": rt, "launches": launches["gather_weighted_sum"],
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


def _device_times(prof) -> dict:
    """{kernel name: device µs} from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = float(us)
    return out


def _kernel1_us(dev: dict, per: int) -> dict:
    """Device µs of kernel 1's forward and dx launches in a profile
    window, per predict or step."""
    return {part: sum(v for k, v in dev.items() if f"::{name}<" in k) / per
            for part, name in (("forward", "gws_kernel"), ("dx", "gws_dx_kernel"))}


def _profile_window(torch, body, windows: int = PROFILE_WINDOWS) -> tuple[dict, float]:
    """({kernel name: device µs}, host-clock ms) of one run of `body`,
    which ends synchronised, under torch.profiler. The body runs once as
    the profiler's warm-up step, then `windows` times as recorded steps,
    and the recorded step with the most device time is kept: CUPTI now
    and then drops kernel records from a window (a drop only ever lowers
    the sum; the same work repeats within ~1 %). The
    profiler's step markers are spans, not device work, and are left out."""
    from torch.profiler import ProfilerActivity, profile, schedule

    runs = []
    for _ in range(windows):
        got = {}
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p, got=got: got.update(_device_times(p))) as prof:
            body()
            prof.step()
            t0 = time.perf_counter()
            body()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        runs.append(({k: v for k, v in got.items() if not k.startswith("ProfilerStep")}, wall_ms))
    return max(runs, key=lambda r: sum(r[0].values()))


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

    kernels, _ = _profile_window(torch, loop)
    return {"device_ms": sum(kernels.values()) / 1e3 / iters,
            "loop_ms": loop_ms, "device_kernels": sorted(k[:60] for k in kernels)}


def gws_shapes(b: int, f0: int) -> tuple:
    """The three gather_weighted_sum launches of one batch of b roots at
    fanouts 10,10: layer 0 on hops 0 and 1 (F = f0) and layer 1 on hop 0
    (F = 128), D = 10 slots in the grid layout (slot = row * D + j)."""
    return (("layer0 hop0", b, 10, f0), ("layer0 hop1", 10 * b, 10, f0),
            ("layer1 hop0", b, 10, 128))


def time_kernels(torch, gen, shapes, what: str) -> list:
    """gather_weighted_sum, its plain version and embedding_bag at
    `shapes` (gws_shapes), inputs cycled past the L2; `warm_ms` the kernel
    on one input set, left in the L2 by the call before, as the path's
    inputs are (the op before has just written them)."""
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
        set_bytes = n_src * f * 4 + n * d * 8 + n * f * 4
        copies = min(512, max(2, math.ceil(2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(copies):
            x = torch.randn(n_src, f, generator=gen, device=dev)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = torch.rand(n, d, generator=gen, device=dev)
            sets.append((x, slots, w, slots.long()))
        x, slots, w, _ = sets[0]
        out, ref = gather_weighted_sum(x, slots, w, "cuda"), gather_weighted_sum_ref(x, slots, w)
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"gather_weighted_sum disagrees with its plain version at "
                                 f"{what} {label}: max abs err {err}")
        iters = max(200, 2 * copies)
        kern = _time_ms(torch, lambda x, s, w, sl: gather_weighted_sum(x, s, w, "cuda"), sets, iters)
        warm = _time_ms(torch, lambda x, s, w, sl: gather_weighted_sum(x, s, w, "cuda"),
                        sets[:1], 200)
        plain = _time_ms(torch, lambda x, s, w, sl: gather_weighted_sum_ref(x, s, w), sets, iters)
        lib = _time_ms(
            torch,
            lambda x, s, w, sl: F.embedding_bag(sl, x, per_sample_weights=w, mode="sum"),
            sets, iters,
        )
        if kern["device_ms"] <= 0:
            raise AssertionError("the profiler saw no device time for the kernel")
        # each input read once (every table row is cited once in the grid
        # layout), the output written once
        nbytes = n_src * f * 4 + n * d * (4 + 4) + n * f * 4
        flops = 2 * n * d * f
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        rows.append({"shape": label, "N": n, "D": d, "F": f, "n_src": n_src,
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


def time_dx(torch, gen, shapes, what: str) -> list:
    """gather_weighted_sum's dx at `shapes` (gws_shapes), inputs cycled
    past the L2: the dx kernel with its memset, held bitwise against the
    plain backward (`gather_weighted_sum_dx_ref`) first, the plain backward and
    embedding_bag's backward with respect to the table (per-sample
    weights, mode sum; its forward runs outside the timed window);
    `warm_ms` the kernel on one input set, left in the L2. The bound: g,
    slots and w read once, dx written once."""
    import torch.nn.functional as F

    from euler_tpu_torch.ops import (
        gather_weighted_sum_dx,
        gather_weighted_sum_dx_ref,
        launch_geometry,
    )

    dev = torch.device("cuda")
    f32 = torch.float32
    rows = []
    for label, n, d, f in shapes:
        n_src = n * d
        set_bytes = n * f * 4 + n * d * 8 + 3 * n_src * f * 4
        copies = min(512, max(2, math.ceil(2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(copies):
            g = torch.randn(n, f, generator=gen, device=dev)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = torch.rand(n, d, generator=gen, device=dev)
            table = torch.randn(n_src, f, generator=gen, device=dev, requires_grad=True)
            out = F.embedding_bag(slots.long(), table, per_sample_weights=w, mode="sum")
            sets.append((g, slots, w, table, out))
        def run(g, s, w, t, o):
            return gather_weighted_sum_dx(w, g, s, n_src, f32, "cuda")

        # iota slots: no two adds land on one element, so the kernel is exact
        g, slots, w, _, _ = sets[0]
        if not torch.equal(_bits(torch, run(*sets[0])),
                           _bits(torch, gather_weighted_sum_dx_ref(w, g, slots, n_src, f32))):
            raise AssertionError(f"gather_weighted_sum_dx is not bitwise the plain backward "
                                 f"at {what} {label}")
        iters = max(200, 2 * copies)
        timed = {
            "plain": _time_ms(torch, lambda g, s, w, t, o: gather_weighted_sum_dx_ref(
                w, g, s, n_src, f32), sets, iters),
            "library": _time_ms(torch, lambda g, s, w, t, o: torch.autograd.grad(
                o, t, g, retain_graph=True), sets, iters),
            "kernel": _time_ms(torch, run, sets, iters),
            "warm": _time_ms(torch, run, sets[:1], 200),
        }
        if timed["kernel"]["device_ms"] <= 0:
            raise AssertionError("the profiler saw no device time for the dx kernel")
        nbytes = n * f * 4 + n * d * (4 + 4) + n_src * f * 4
        flops = 2 * n * d * f
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        rows.append({"shape": label, "N": n, "D": d, "F": f, "n_src": n_src,
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
    res = {"phase": "kernel_check", "kernel": list(PAGED_KERNELS), "cases": cases,
           "check": "bitwise", "max_abs_err": worst, "failed": failed}
    _emit(res)
    if failed:
        raise AssertionError(f"paged kernels disagree with their plain versions: {failed}")
    return res


class _Tap:
    """Keeps copies of what a flow's draw_inputs and fanout_batch return
    for their next `n` calls, by wrapping the instance's methods; they
    launch no kernel of their own."""

    def __init__(self, flow, n: int):
        self.flow, self.draws, self.batches = flow, [], []
        draw_inputs, fanout_batch = flow.draw_inputs, flow.fanout_batch

        def tap_draws(gen):
            out = draw_inputs(gen)
            if len(self.draws) < n:
                self.draws.append((out[0].clone(), tuple(d.clone() for d in out[1])))
            return out

        def tap_batch(roots, hop_draws):
            out = fanout_batch(roots, hop_draws)
            if len(self.batches) < n:
                self.batches.append(out)
            return out

        flow.draw_inputs, flow.fanout_batch = tap_draws, tap_batch

    def close(self):
        del self.flow.draw_inputs, self.flow.fanout_batch


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
    from euler_tpu_torch import ops
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

    def run(est, steps: int, mode: str):
        """`steps` optimizer steps in kernel mode `mode`, launch counts
        reset just before and read just after."""
        ops.set_kernel_mode(mode)
        ops.reset_launch_counts()
        try:
            t = time.perf_counter()
            losses = est.train(steps, log=False, save=False)
            torch.cuda.synchronize()
            return losses, ops.launch_counts(), time.perf_counter() - t
        finally:
            ops.set_kernel_mode("auto")

    try:
        # (a) the main path: bf16 weight plane, kernel mode auto
        flow, cache, stage_s = lane("bf16", "cuda")
        if not flow._page_w_packed:
            raise AssertionError("the bf16 run did not stage a packed weight plane")
        est = estimator(flow, cache, "cuda", "main")
        tap = _Tap(flow, REF_STEPS)
        losses, launches, main_s = run(est, TRAIN_STEPS, "auto")
        tap.close()
        # kernel 1: layer 0 over hops 0 and 1, layer 1 over hop 0; its dx
        # only for layer 1, whose x (layer 0's hop-1 output) carries a
        # gradient, where layer 0's x are features
        want = {"paged_gather": 2, "paged_gather_dequant": 2, "paged_cdf_count": 2,
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
        losses_ref, launches_ref, _ = run(est_ref, REF_STEPS, "ref")
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

        # (d) the f32 weight plane: paged_gather also reads the weights
        flow_f32, cache_f32, _ = lane("f32", "cuda")
        est_f32 = estimator(flow_f32, cache_f32, "cuda", "f32")
        tap_f32 = _Tap(flow_f32, F32_STEPS)
        losses_f32, launches_f32, _ = run(est_f32, F32_STEPS, "auto")
        tap_f32.close()
        if launches_f32["paged_gather"] != 4 * F32_STEPS or launches_f32["paged_gather_dequant"]:
            raise AssertionError(f"f32 plane launches: {launches_f32}")
        same_f32 = _assert_same_batches(torch, tap_f32.batches, tap.batches[:F32_STEPS],
                                        "bf16 vs f32 plane")
        del flow_f32, cache_f32, est_f32

        # (e) the checkpoint, served by the port
        path = est.save()
        host_flow = SageDataFlow(g, ["feat"], fanouts=TRAIN_FANOUTS,
                                 rng=np.random.default_rng(seed))
        rt = InferenceRuntime(GraphSAGESupervised(TRAIN_FEAT, TRAIN_DIMS, 2), host_flow,
                              model_dir=est.cfg.model_dir, device="cuda")
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

    dev, wall_ms = _profile_window(torch, window)
    busy_ms = sum(dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    res = {"phase": "train_timing", "card": card, "median_step_ms": statistics.median(times),
           "min_step_ms": min(times), "max_step_ms": max(times), "steps": TIMED_STEPS,
           "profiled_steps": PROFILED_STEPS, "wall_ms_per_step": wall_ms / PROFILED_STEPS,
           "device_ms_per_step": busy_ms / PROFILED_STEPS,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "kernel1_us_per_step": _kernel1_us(dev, PROFILED_STEPS),
           "top_device_us_per_step": {k[:60]: v / PROFILED_STEPS for k, v in top}}
    _emit(res)
    return res


def _paged_calls(flow, gen) -> list:
    """(kernel name, args) of each paged op one flow.sample makes, in order
    (per hop: count, neighbour gather, weight gather)."""
    import euler_tpu_torch.dataflow.device as device_mod

    calls = []
    saved = {name: getattr(device_mod, name) for name in PAGED_KERNELS}

    def wrap(name):
        def inner(*args, **kw):
            calls.append((name, args))
            return saved[name](*args, **kw)
        return inner

    try:
        for name in saved:
            setattr(device_mod, name, wrap(name))
        flow.sample(gen)
    finally:
        for name, fn in saved.items():
            setattr(device_mod, name, fn)
    return calls


def _sectors(torch, word_idx, words_per_item: int = 1) -> int:
    """Distinct 32-byte sectors that reading `words_per_item` consecutive
    4-byte words from each index touches."""
    per = SECTOR_BYTES // 4
    first = word_idx.long().reshape(-1) // per
    span = max(1, -(-words_per_item // per))
    return int(torch.unique(first[:, None] + torch.arange(span, device=first.device)).numel())


def time_paged_kernels(torch, flow, gen, card: str) -> list:
    """Each paged kernel at the two hops' shapes of one train step, with
    the main path's own inputs (captured from one sample), the tables
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

    calls = _paged_calls(flow, gen)
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
            "result": res}


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
        paged_rows = time_paged_kernels(torch, trained["flow"], gen, card)
        del trained["estimator"], trained["flow"]
        torch.cuda.empty_cache()

        # 6. the retrieval path, and its timings
        retrieved = retrieve(torch, tmp, args.seed)
        time_retrieve(torch, retrieved["engine"], retrieved["pool"], card)
        topk_rows = time_topk_kernel(torch, retrieved["engine"], retrieved["pool"], card)
        del retrieved["engine"]
        torch.cuda.empty_cache()
    serve_rows = time_kernels(torch, gen, gws_shapes(128, FEAT_DIM), "bucket-128 predict")
    train_rows = time_kernels(torch, gen, gws_shapes(TRAIN_BATCH, TRAIN_FEAT), "train step")
    dx_rows = (time_dx(torch, gen, gws_shapes(128, FEAT_DIM), "bucket-128 predict")
               + time_dx(torch, gen, gws_shapes(TRAIN_BATCH, TRAIN_FEAT), "train step"))
    # the path's one dx a step: layer 1 over hop 0 of a train step
    dx_path = dx_rows[-1]

    def total(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)

    def bound_by(rows):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"

    # 6. the kernels line: per kernel, the sums over the launches of one
    # bucket-128 predict (gather_weighted_sum) or one train step (paged)
    train_launches = trained["launches"]
    kernels = [{
        "name": "gather_weighted_sum",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/gather_weighted_sum.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:96",
        "launches": served["launches"] + train_launches["gather_weighted_sum"],
        "launches_by_path": {"serve": served["launches"],
                             "train": train_launches["gather_weighted_sum"]},
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
    }, {
        "name": "gather_weighted_sum_dx",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/gather_weighted_sum.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:166-187",
        "replaces_what": "the custom VJP's dx of gather_weighted_sum: a scatter-add of w*g "
                         "in plain JAX, outside any Pallas kernel",
        "launches": served["launches_dx"] + train_launches["gather_weighted_sum_dx"],
        "launches_by_path": {"serve": served["launches_dx"],
                             "train": train_launches["gather_weighted_sum_dx"]},
        "max_abs_err": dx_check["max_abs_err"],
        "check": "bitwise for unique slots, rtol = atol = 1e-5 for repeats",
        "ms": dx_path["ms"],
        "plain_ms": dx_path["plain_ms"],
        "bound_ms": dx_path["bound_ms"],
        "bound_by": dx_path["bound_by"],
        "library_ms": dx_path["library_ms"],
        "library": "embedding_bag backward with respect to the table",
        "card": card,
        "shapes": [{k: r[k] for k in ("shape", "N", "D", "F", "geometry", "ms", "warm_ms",
                                      "plain_ms", "library_ms", "bound_ms")} for r in dx_rows],
    }]
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
            "launches": train_launches[name],
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
    # search of each bucket
    t_bytes = sum(r["bytes_ms"] for r in topk_rows if r["bound_by"] == "bytes")
    t_ops = sum(r["ops_ms"] for r in topk_rows if r["bound_by"] == "operations")
    other = {"fma": "mul_add_ms", "mul_add": "fma_ms"}
    kernels.append({
        "name": "paged_topk_score",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/topk_score.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:534",
        "launches": retrieved["launches"]["paged_topk_score"],
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
        "launches": retrieved["launches"]["paged_topk_select"],
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
