#!/usr/bin/env python3
"""GPU smoke for euler_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one CUDA card (Hopper,
sm_90a) and nvcc:

    python3 chip_smoke.py [--model-dir CKPT] [--seed 0]

Phases, each of which raises (exit code != 0) when it fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build every CUDA kernel of the port from the sources in the checkout;
  3. hold each kernel against its plain PyTorch version on the card
     (rtol = atol = 1e-5);
  4. serve supervised GraphSAGE at full width — random_graph with 200 000
     nodes, out-degree 10, 64-wide f32 features; fanouts 10,10; dims
     128,128; buckets 8,32,128 — through `tools.serve.build_runtime` and
     `InferenceRuntime.warmup`/`predict`, weights from a seeded
     torch.Generator (or --model-dir). The launch counts, reset just
     before, show the path went through the kernels. The embeddings are
     compared (rtol = atol = 1e-4) with kernel mode 'ref' on the card and
     with the port on the CPU, from fresh flows with the same seeds;
  5. timings: median predict latency per bucket, and each kernel against
     its plain version and the one PyTorch call computing the same
     function, at the shapes one bucket-128 predict launches, beside the
     card's bound for that work.
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
SERVE_TOL = 1e-4


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_kernel(torch, gen) -> dict:
    """Phase 3: gather_weighted_sum kernel vs its plain version."""
    from euler_tpu_torch.ops import gather_weighted_sum, gather_weighted_sum_ref

    dev = torch.device("cuda")
    cases, failed, max_err = 0, [], 0.0

    def one(x, slots, w, label):
        nonlocal cases, max_err
        out = gather_weighted_sum(x, slots, w, "cuda")
        ref = gather_weighted_sum_ref(x, slots, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max()) if out.numel() else 0.0
        cases += 1
        max_err = max(max_err, err)
        if not torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            failed.append({"case": label, "max_abs_err": err})

    for dtype in (torch.float32, torch.bfloat16):
        # F=67 is not a multiple of 4: the scalar-load path
        for f in (64, 128, 200, 256, 512, 67):
            for n in (1, 127, 1280, 12800):
                for d in (10, 25):
                    n_src = max(4096, n)
                    x = torch.randn(n_src, f, generator=gen, device=dev).to(dtype)
                    slots = torch.randint(
                        0, n_src, (n, d), generator=gen, device=dev, dtype=torch.int32
                    )
                    w = torch.rand(n, d, generator=gen, device=dev)
                    one(x, slots, w, f"{dtype} N={n} D={d} F={f}")
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
    if launches["gather_weighted_sum"] != want:
        raise AssertionError(
            f"served path launched gather_weighted_sum {launches} times, "
            f"expected {want} ({main_batches} device batches)"
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
            "req_rng": req_rng}


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


def _time_ms(torch, fn, sets, iters: int) -> dict:
    """One function's time per call over `iters` back-to-back calls,
    cycling through input sets whose total exceeds the L2 cache, so each
    call finds its inputs in device memory as the served path does.
    `device_ms`: the device time of its kernels (torch.profiler, CUPTI);
    `loop_ms`: CUDA events around the whole loop, which includes the
    host's launch cost whenever the host cannot keep ahead."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    kernels = _device_times(prof)
    return {"device_ms": sum(kernels.values()) / 1e3 / iters,
            "loop_ms": loop_ms, "device_kernels": sorted(k[:60] for k in kernels)}


def time_kernels(torch, gen, b: int = 128) -> list:
    """The three launches of one bucket-b predict: layer 0 on hops 0 and
    1 (F = 64) and layer 1 on hop 0 (F = 128), D = 10 slots in the grid
    layout (slot = row * D + j), as the served path gives them."""
    import torch.nn.functional as F

    from euler_tpu_torch.ops import gather_weighted_sum, gather_weighted_sum_ref

    dev = torch.device("cuda")
    rows = []
    for label, n, d, f in (("layer0 hop0", b, 10, 64), ("layer0 hop1", 10 * b, 10, 64),
                           ("layer1 hop0", b, 10, 128)):
        n_src = n * d
        set_bytes = n_src * f * 4 + n * d * 8 + n * f * 4
        copies = min(512, max(2, math.ceil(2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(copies):
            x = torch.randn(n_src, f, generator=gen, device=dev)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = torch.rand(n, d, generator=gen, device=dev)
            sets.append((x, slots, w, slots.long()))
        iters = max(200, 2 * copies)
        kern = _time_ms(torch, lambda x, s, w, sl: gather_weighted_sum(x, s, w, "cuda"), sets, iters)
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
                     "ms": kern["device_ms"], "plain_ms": plain["device_ms"],
                     "library_ms": lib["device_ms"],
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
           "bucket": b, "shapes": rows})
    return rows


def profile_predict(torch, rt, req_rng, reps: int = 20) -> dict:
    """Device busy share of back-to-back bucket-128 predicts: the summed
    device time of every kernel and copy over the host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    b = rt.buckets[-1]
    ids = [req_rng.integers(1, NUM_NODES + 1, size=b).astype(np.uint64)
           for _ in range(reps)]
    rt.predict(ids[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in ids:
            rt.predict(r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = _device_times(prof)
    busy_ms = sum(dev.values()) / 1e3
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    top = [(k[:60], v) for k, v in top]
    res = {"phase": "predict_profile", "bucket": b, "reps": reps,
           "wall_ms_per_predict": wall_ms / reps,
           "device_ms_per_predict": busy_ms / reps,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "top_device_us_per_predict": {k: v / reps for k, v in top}}
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

    # 4. the served path
    with tempfile.TemporaryDirectory(prefix="euler_smoke_") as tmp:
        t0 = time.perf_counter()
        write_graph(tmp)
        _emit({"phase": "graph", "nodes": NUM_NODES, "out_degree": OUT_DEGREE,
               "feat_dim": FEAT_DIM, "seconds": time.perf_counter() - t0})
        served = serve(torch, tmp, args.model_dir, args.seed)

        # 5. timings
        latency = time_predict(served["runtime"], served["req_rng"])
        _emit({"phase": "predict_latency", "card": card, "buckets": latency})
        profile_predict(torch, served["runtime"], served["req_rng"])
    rows = time_kernels(torch, gen)

    def total(key):
        return sum(r[key] for r in rows)

    # 6. the kernels line
    _emit({"kernels": [{
        "name": "gather_weighted_sum",
        "route": "cuda",
        "source": "euler_tpu_torch/ops/csrc/gather_weighted_sum.cu",
        "replaces": "euler_tpu/ops/pallas_kernels.py:96",
        "launches": served["launches"],
        "max_abs_err": check["max_abs_err"],
        # per bucket-128 predict: the sum over its three launches
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
        "library_ms": total("library_ms"),
        "card": card,
        "shapes": [{k: r[k] for k in ("shape", "N", "D", "F", "ms", "plain_ms",
                                      "library_ms", "bound_ms")} for r in rows],
    }]})
    # 7. the device
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
