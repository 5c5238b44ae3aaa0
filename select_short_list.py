"""Time paged_topk_select against copies with another short list on the
retrieval cell.

The select kernel (euler_tpu_torch/ops/csrc/topk_score.cu) drops the keys
under a floor, then ranks the survivors of a tile directly when at most
kShortList of them are left, and radix-selects them otherwise; the radix
path alone is exact for any k. This script builds copies of the library
with other values of kShortList (0: every tile radix-selected) and times
them and the kernel as built on the retrieval cell of chip_smoke.py (1 M x
128 cosine corpus from its seed, k 32, buckets 1/4/16/64, unfiltered and
with the `cat in {0, 2}` filter), holding each one's keys bitwise against
paged_topk_select_ref. It also counts, from the scores alone, how many
keys survive the floor in each tile, and so which path each tile takes.
Needs one CUDA card and nvcc:

    python3 select_short_list.py [--seed 0] [--variants 0 1024]

Prints the card's name and power limit, then one JSON line per bucket and
filter. Exits 1 without a card, 2 if a copy disagrees with the plain version.
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

SHORT_LIST_RE = re.compile(r"constexpr int kShortList = (\d+);")
WARPS, LANES, PER_LANE = 8, 32, 32  # the select block at tile 8192: 256 threads x 32 rows


def _source() -> str:
    from euler_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, _build.SOURCES["topk_score"])) as f:
        text = f.read()
    if len(SHORT_LIST_RE.findall(text)) != 1:
        raise RuntimeError("topk_score.cu no longer sets kShortList in one place")
    return text


def build_variant(short_list: int) -> ctypes.CDLL:
    """The library built from a copy of topk_score.cu with kShortList =
    short_list."""
    from euler_tpu_torch.ops import _build

    bdir = os.path.join(_build.BUILD_ROOT, f"topk_score-short-list-{short_list}")
    os.makedirs(bdir, exist_ok=True)
    copy = os.path.join(bdir, "topk_score.cu")
    with open(copy, "w") as f:
        f.write(SHORT_LIST_RE.sub(f"constexpr int kShortList = {short_list};", _source()))
    lib = os.path.join(bdir, "libtopk_score.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, copy], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(lib)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.euler_paged_topk_select_launch.argtypes = [ptr, i64, i32, ptr, ptr, i32, i32, ptr]
    dll.euler_paged_topk_select_launch.restype = i32
    return dll


def select_with(torch, dll, scores, b: int, k: int, mask, tile: int):
    """paged_topk_select through another build of its library."""
    nrows = scores.shape[1]
    kt = min(k, tile)
    out = torch.empty((b, -(-nrows // tile), kt), dtype=torch.int64, device=scores.device)
    rc = dll.euler_paged_topk_select_launch(
        scores.data_ptr(), nrows, b, None if mask is None else mask.data_ptr(), out.data_ptr(),
        kt, tile, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_topk_select copy failed to launch: {rc}")
    return out


def survivors(torch, scores, b: int, k: int, mask, tile: int):
    """Keys at or above the kernel's floor in each (query, tile), worked
    out as the kernel does: in each warp the ceil(k / 8)-th largest of the
    lanes' largest keys (a lane without keys counts 0), the least of those
    over the warps."""
    s = scores[:b]
    if mask is not None:
        s = torch.where(mask[None, :], s, float("-inf"))
    f = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(f >= 2**31, 0xFFFFFFFF - f, f | 2**31)
    n = s.shape[1]
    ntiles = -(-n // tile)
    keys = torch.zeros((b, ntiles * tile), dtype=torch.int64, device=s.device)
    keys[:, :n] = u
    keys = keys.view(b, ntiles, WARPS, LANES, PER_LANE)
    lane_top = keys.max(dim=4).values
    r = -(-min(k, tile) // WARPS)
    floor = lane_top.topk(r, dim=3).values[..., r - 1].min(dim=2).values
    real = (torch.arange(ntiles * tile, device=s.device) < n).view(1, ntiles, tile)
    return ((keys.view(b, ntiles, tile) >= floor[..., None]) & real).sum(dim=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", type=int, nargs="*", default=[0, 1024],
                    help="kShortList values to build copies with")
    args = ap.parse_args(argv)

    import torch

    from euler_tpu_torch.ops import (
        operand_range,
        paged_topk_score,
        paged_topk_select,
        paged_topk_select_ref,
        products_exact,
    )
    from euler_tpu_torch.ops.topk_score import TILE
    from euler_tpu_torch.retrieval import EmbeddingCorpus, TopKIndex, normalize_rows, quantize_sig12

    if not torch.cuda.is_available():
        print("select_short_list: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    print(cs._card_line(), flush=True)
    built_short_list = int(SHORT_LIST_RE.search(_source()).group(1))
    with ThreadPoolExecutor(max(1, len(args.variants))) as pool:  # one nvcc each, at once
        dlls = dict(zip(args.variants, pool.map(build_variant, args.variants)))
    data = cs.retrieval_data(args.seed)
    corpus = EmbeddingCorpus.build(data["ids"], data["vectors"], attrs={"cat": data["cat"]},
                                   metric="cosine")
    index = TopKIndex(corpus, device="cuda")
    table, n, dp = index.table2d, index._n, index._dp
    mask = torch.from_numpy(corpus.condition_mask(cs.RETR_FILTER)).to(table.device)
    k = cs.RETR_K
    failed = False
    for b in cs.RETR_BUCKETS:
        qn = quantize_sig12(normalize_rows(data["pool"][:b]))
        exact = products_exact(operand_range(qn), index._x_range)
        scores = paged_topk_score(table, torch.from_numpy(qn).to(table.device), n, dp, "cuda",
                                  exact)
        for name, m in (("unfiltered", None), ("filtered", mask)):
            fns = {"built": lambda s, mm, b=b: paged_topk_select(s, b, k, mm, TILE, "cuda")}
            for v, dll in dlls.items():
                fns[f"short_list_{v}"] = (
                    lambda s, mm, b=b, dll=dll: select_with(torch, dll, s, b, k, mm, TILE))
            want = paged_topk_select_ref(scores, b, k, m, TILE)
            same = {key: torch.equal(fn(scores, m), want) for key, fn in fns.items()}
            failed |= not all(same.values())
            live = survivors(torch, scores, b, k, m, TILE).flatten().double()
            # each in turn, then again in reverse: drift shows as a gap
            # between one copy's two times
            order = list(fns) + list(reversed(fns))
            times = {key: [] for key in fns}
            for key in order:
                t = cs._time_ms(torch, fns[key], [(scores, m)], 50)
                times[key].append((t["device_ms"], t["loop_ms"]))
            print(json.dumps({
                "bucket": b, "filter": name, "tile": TILE, "k": k,
                "built_short_list": built_short_list, "bitwise": same,
                "tiles": live.numel(),
                "tiles_at_most": {v: int((live <= v).sum())
                                  for v in sorted({built_short_list, *args.variants})},
                "survivors": {"median": float(live.median()), "max": float(live.max())},
                "device_ms": {key: [d for d, _ in v] for key, v in times.items()},
                "loop_ms": {key: [lp for _, lp in v] for key, v in times.items()},
            }), flush=True)
        del scores
    return 2 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
