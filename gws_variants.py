"""Time gather_weighted_sum and its dx kernel against copies built with
another register floor or load batch.

The kernels (euler_tpu_torch/ops/csrc/gather_weighted_sum.cu) keep a
row's loads in flight in registers: `__launch_bounds__` asks for at least
kMinBlocksPerSm blocks of 128 threads an SM, which leaves ptxas a budget
of 65536 / (128 * kMinBlocksPerSm) registers a thread, and the forward
issues the x loads of up to kBatch slots at once. This script builds
copies of the library with other values of the two (floor `none`: no minimum, so ptxas aims at full occupancy) and times
each copy, and the library as built, at the shapes of chip_smoke.py's
gws_shapes (the three launches of a bucket-128 predict and of a train
step), each in a process of its own, in turns (built, copies, copies in
reverse, built). Per shape: the forward with inputs cycled past the L2,
the forward L2-warm, and the dx kernel with its memset (inputs cycled),
each copy held against the plain versions there (forward within rtol =
atol = 1e-5, dx bitwise: the slots are the grid path's iota). Needs one
CUDA card and nvcc:

    python3 gws_variants.py [--seed 0] [--variants none:16 6:16 8:12 6:8]

Prints the card's name and power limit, the registers ptxas gave each
copy's f32 forward, then one JSON line per timed process. Exits 1 without
a card, 2 if a copy disagrees with the plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

FLOOR_RE = r"constexpr int kMinBlocksPerSm = (\d+);"
BATCH_RE = r"constexpr int kBatch = (\d+);"
BOUNDS = re.escape("__launch_bounds__(kMaxWarpsPerBlock * 32, kMinBlocksPerSm)")


def build_variant(floor: str, batch: int) -> tuple[str, str]:
    """(library path, registers of the f32 forward) of a copy of
    gather_weighted_sum.cu with kMinBlocksPerSm = floor ('none': no
    minimum) and kBatch = batch."""
    from euler_tpu_torch.ops import _build

    subs = {BATCH_RE: f"constexpr int kBatch = {batch};"}
    if floor == "none":
        subs[BOUNDS] = "__launch_bounds__(kMaxWarpsPerBlock * 32)"
    else:
        subs[FLOOR_RE] = f"constexpr int kMinBlocksPerSm = {int(floor)};"
    lib, log = _build.build_variant("gather_weighted_sum", f"floor-{floor}-batch-{batch}", subs)
    return lib, _f32_registers(log)


def _f32_registers(log: str) -> str:
    """Registers ptxas gave gws_kernel<float, 4, 32>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "gws_kernelIfLi4ELi32E" in line:
            return next(x for x in lines[i:] if "registers" in x).split("Used ")[1].split()[0]
    return "?"


def time_library(path: str | None, label: str, seed: int) -> dict:
    """Times (and checks) the library at `path` (None: as built)."""
    import torch

    from euler_tpu_torch.ops import (
        _build,
        gather_weighted_sum,
        gather_weighted_sum_dx,
        gather_weighted_sum_dx_ref,
        gather_weighted_sum_ref,
    )

    if path is not None:
        _build.load = lambda name: ctypes.CDLL(path)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    shapes = cs.gws_shapes(128, cs.FEAT_DIM) + cs.gws_shapes(cs.TRAIN_BATCH, cs.TRAIN_FEAT)
    rows, bad = [], []
    for what, (shape, n, d, f) in zip(["predict"] * 3 + ["train"] * 3, shapes):
        n_src = n * d
        set_bytes = 2 * n_src * f * 4 + n * d * 8 + 2 * n * f * 4
        copies = min(512, max(2, -(-2 * cs.L2_BYTES // set_bytes)))
        sets = []
        for _ in range(copies):
            x = torch.randn(n_src, f, generator=gen, device=dev)
            slots = torch.arange(n_src, device=dev, dtype=torch.int32).reshape(n, d)
            w = torch.rand(n, d, generator=gen, device=dev)
            g = torch.randn(n, f, generator=gen, device=dev)
            sets.append((x, slots, w, g))
        x, slots, w, g = sets[0]
        if not torch.allclose(gather_weighted_sum(x, slots, w, "cuda"),
                              gather_weighted_sum_ref(x, slots, w),
                              rtol=cs.KERNEL_TOL, atol=cs.KERNEL_TOL):
            bad.append(f"forward {what} {shape}")
        if not torch.equal(gather_weighted_sum_dx(w, g, slots, n_src, torch.float32, "cuda"),
                           gather_weighted_sum_dx_ref(w, g, slots, n_src, torch.float32)):
            bad.append(f"dx {what} {shape}")

        def fwd(x, s, w, g):
            return gather_weighted_sum(x, s, w, "cuda")

        def dx(x, s, w, g, n_src=n_src):
            return gather_weighted_sum_dx(w, g, s, n_src, torch.float32, "cuda")

        iters = max(200, 2 * copies)
        rows.append({"what": what, "shape": shape, "N": n, "D": d, "F": f,
                     "ms": cs._time_ms(torch, fwd, sets, iters)["device_ms"],
                     "warm_ms": cs._time_ms(torch, fwd, sets[:1], 200)["device_ms"],
                     "dx_ms": cs._time_ms(torch, dx, sets, iters)["device_ms"]})
        del sets
    return {"label": label, "shapes": rows, "failed": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", nargs="*", default=["none:16", "6:16", "8:12", "6:8"],
                    help="floor:batch pairs (floor 'none' or blocks an SM)")
    ap.add_argument("--time", nargs=2, metavar=("LIBRARY", "LABEL"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gws_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.time:
        lib, label = args.time
        res = time_library(None if lib == "-" else lib, label, args.seed)
        print(json.dumps(res), flush=True)
        return 2 if res["failed"] else 0

    from euler_tpu_torch.ops import _build

    print(cs._card_line(), flush=True)
    built = _build.build_all(["gather_weighted_sum"])["gather_weighted_sum"]["log"]
    pairs = [(v.split(":")[0], int(v.split(":")[1])) for v in args.variants]
    with ThreadPoolExecutor(len(pairs) or 1) as pool:
        libs = list(pool.map(lambda p: build_variant(*p), pairs))
    labels = {"-": "built"}
    regs = {"built": _f32_registers(built)}
    for (floor, batch), (lib, r) in zip(pairs, libs):
        labels[lib] = f"floor {floor}, batch {batch}"
        regs[labels[lib]] = r
    print(json.dumps({"f32_forward_registers": regs}), flush=True)
    order = ["-", *(lib for lib, _ in libs)]
    rc = 0
    for lib in order + order[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--seed",
                               str(args.seed), "--time", lib, labels[lib]],
                              capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        print(lines[-1] if lines else proc.stdout + proc.stderr, flush=True)
        if proc.returncode:
            rc = 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
