"""Device-resident sampling: the adjacency (or the flat edge list) lives
on the card and every training step draws its batch there
(counterpart: euler_tpu/dataflow/device.py:84-154, 211-566, 742-975,
978-1338): the GraphSAGE fanout (`DeviceSageFlow`), its unsupervised
(src, pos, negs) triple (`DeviceUnsupSageFlow`), DeepWalk / node2vec
walks and skip-gram pairs (`DeviceWalkFlow`), LINE's edges
(`DeviceEdgeFlow`), the TransX family's corrupted triples
(`DeviceKGFlow`), graph classification's whole graphs
(`DeviceWholeGraphFlow`), RGCN's per-relation fanouts
(`DeviceRelationFlow`, dense layout), the LADIES layers of FastGCN /
AdaptiveGCN (`DeviceLayerwiseFlow`, dense layout), and the GAE / VGAE
and DGI batches (`DeviceGaeFlow`, `DeviceDgiFlow`).

Staging (once, on the host, numpy) is the JAX package's, step for step,
so both packages stage the same integers: the compacted neighbour rows
(row+1 encoding, 0 = padding), the degrees, and for weighted graphs the
per-row uint32-quantized CDF of the edge weights. Two layouts:

- `layout="dense"`: an [N+1, Dmax] table; `max_degree` guards its width;
- `layout="paged"`: fixed-size pages (`page_size` slots, dividing 128) in
  flat buffers viewed as [M, 128] lane rows, plus a per-node page table,
  so a hub spans ⌈deg/P⌉ pages. A hop of its draws is one call of
  `ops/paged.py` `paged_sample_hop`, one launch of the hand-written kernel
  `csrc/paged_sample_hop.cu` on the card: page-boundary search, in-page
  CDF count, neighbour and weight gathers (the weight plane f32, or packed
  two bf16 per word when EULER_TPU_PAGE_DTYPE=bf16). Its plain version,
  which the CPU runs, is the JAX package's composition of the page search
  and the plain versions of `paged_cdf_count`, `paged_gather` and
  `paged_gather_dequant`.
- `layout="auto"` picks dense while the max degree fits `max_degree` and
  paged past it.

Both layouts invert the same quantized CDF, so they draw the same
neighbours from the same random numbers.

Random numbers. The port draws with `torch.Generator` and cannot give
JAX's threefry bits. A draw is therefore split in two: every flow's
`draw_inputs` makes the node rows (roots, negatives) or edge picks and,
per neighbour draw, the u32 random bits (weighted graphs, held as int32
bit patterns) or f32 uniforms (unit weights, and the biased walk); the
flow's deterministic `make_batch` turns them into the batch. Fed the
numbers JAX derives from its key, `make_batch` gives JAX's batch bit for bit
(tests/test_torch_device_flow.py, tests/test_torch_unsup.py,
tests/test_torch_skipgram.py, tests/test_torch_kg.py).

`with_hop_ids=True` (DeviceSageFlow and its unsupervised and DGI
subclasses) adds each hop's int32 node ids to the batch, a gather of the
staged id plane on the device (pad rows map to -1), for the id
embedding of GraphSAGE's ShallowEncoder stage.

Not ported yet: `refresh_rows` (ROADMAP queue 1 item 8), `mesh` (item
6) and remote-shard staging (item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.dataflow.base import Block, MiniBatch
from euler_tpu_torch.device import resolve_device
from euler_tpu_torch.distributed.codec import page_dtype
from euler_tpu_torch.ops import (
    PAGE_LANES,
    HopTables,
    as_lane_rows,
    pack_bf16_words,
    paged_impl,
    paged_sample_hop,
)
from euler_tpu_torch.ops.paged import u32

_STAGE_CHUNK = 16384
# host-side staging temp budget: the chunked get_full_neighbor sweep
# allocates [chunk, cap] padded arrays — on power-law graphs cap is the
# hub degree, so the chunk length adapts to keep the temp bounded
_STAGE_TEMP_BYTES = 64 << 20
_U32_MAX = np.uint32(0xFFFFFFFF)


def _node_table(graph):
    """(ids u64, weights f64, types i32) for every node, shard-major —
    the row order of Graph.lookup_rows. Local shards only."""
    shards = graph.shards
    if not all(hasattr(s, "node_ids") and hasattr(s, "node_weights") for s in shards):
        raise ValueError("device flows of the port stage local shards only")
    return (
        np.concatenate([np.asarray(s.node_ids) for s in shards]),
        np.concatenate([np.asarray(s.node_weights, np.float64) for s in shards]),
        np.concatenate([np.asarray(s.node_types, np.int32) for s in shards]),
    )


def _quantize_rows(wblock: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-row uint32-quantized CDF over the compacted weight block —
    the ONE quantization both layouts stage, so their draws invert
    identical integers. Exact f64 cumsum per row; invalid slots and
    zero-total rows fill 0xFFFFFFFF (never drawn below r == MAX, which
    the callers' deg-1 clamp absorbs)."""
    cum = np.cumsum(np.where(valid, wblock, 0.0).astype(np.float64), axis=1)
    total = cum[:, -1:]
    safe = np.maximum(total, np.finfo(np.float64).tiny)
    q = np.floor(cum / safe * np.float64(2**32 - 1))
    q = q.astype(np.uint64).astype(np.uint32)
    return np.where(valid & (total > 0), q, _U32_MAX)


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized per-segment iota)."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    ends = np.cumsum(counts)
    return np.arange(total) - np.repeat(ends - counts, counts)


def _compact_block(graph, sub, edge_types, cap: int):
    """One staging sweep step: the neighbours of `sub` in row+1 space,
    valid entries compacted to the front, their f32 weights and edge
    types (-1 on padding), degrees (0 for zero-strength rows), the rows'
    f64 out-strengths and whether every weight is 1."""
    nbr, w, tt, mask, _ = graph.get_full_neighbor(sub, edge_types, max_degree=cap)
    unit = bool(np.all(w[mask] == 1.0))
    rows = graph.lookup_rows(nbr.ravel()).reshape(nbr.shape)
    # masked or unknown neighbours collapse to padding
    blk0 = np.where(mask & (rows >= 0), rows + 1, 0).astype(np.int32)
    order = np.argsort(blk0 == 0, axis=1, kind="stable")
    block = np.take_along_axis(blk0, order, axis=1)
    wblk = np.take_along_axis(np.where(blk0 > 0, w, 0.0).astype(np.float32), order, axis=1)
    tblk = np.take_along_axis(np.where(blk0 > 0, tt, -1).astype(np.int32), order, axis=1)
    d = (block > 0).sum(axis=1).astype(np.int32)
    # a positive-degree row whose weights are all zero is unsampleable
    strength = wblk.sum(axis=1, dtype=np.float64)
    d[strength <= 0.0] = 0
    return block, wblk, tblk, d, strength, unit


class DeviceGraphTables:
    """Device-resident graph tables and the draw primitives over them."""

    is_device_flow = True
    # the SAGE-family flows draw only through _draw_neighbors and may
    # stage paged; the walk flow's biased step reads the dense planes
    _PAGED_OK = True

    def __init__(
        self,
        graph,
        edge_types=None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        stage_types: bool = False,
        layout: str = "auto",
        page_size: int = 16,
        device=None,
    ):
        """roots_pool: node ids to draw roots from; root_node_type: draw
        roots of one node type (ignored with a pool); default every node.
        Root draws are proportional to node weights either way.
        max_degree guards the dense table's width: a graph past it raises
        under layout="dense" and stages paged under "auto". stage_types
        also stages the edge-type plane `ttab` (dense layout only, as in
        the JAX package). page_size must divide 128. The tables go to the
        CUDA card unless device="cpu"."""
        self.device = resolve_device(device)
        ids, wn, nt = _node_table(graph)
        self._stage_adjacency(graph, ids, edge_types, max_degree, layout, page_size,
                              stage_types)
        self._stage_nodes(graph, ids, wn, nt, roots_pool, root_node_type)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _put_u32(self, a: np.ndarray) -> torch.Tensor:
        """uint32 values as an int32 tensor of the same bits."""
        return self._put(np.ascontiguousarray(a, np.uint32).view(np.int32))

    def _quantize_cdf(self, weights, what: str) -> torch.Tensor:
        """f64 weights → uint32 CDF values (as int64 on the device);
        raises on an empty or zero-total distribution."""
        cum = np.cumsum(np.asarray(weights, dtype=np.float64))
        if cum.size == 0 or cum[-1] <= 0:
            raise ValueError(f"{what} weights sum to zero")
        q = np.floor(cum / cum[-1] * np.float64(2**32 - 1)).astype(np.uint32)
        return self._put(q.astype(np.int64))

    def _stage_degrees(self, graph, ids, edge_types) -> np.ndarray:
        degs = np.zeros(len(ids), np.int64)
        for lo in range(0, len(ids), _STAGE_CHUNK):
            sub = ids[lo : lo + _STAGE_CHUNK]
            degs[lo : lo + len(sub)] = graph.degree_sum(sub, edge_types)
        return degs

    def _stage_adjacency(self, graph, ids, edge_types, max_degree, layout, page_size,
                         stage_types: bool = False):
        if layout not in ("auto", "dense", "paged"):
            raise ValueError(f"unknown layout {layout!r}")
        degs = self._stage_degrees(graph, ids, edge_types)
        dmax = max(int(degs.max(initial=0)), 1)
        paged_ok = self._PAGED_OK and not stage_types
        if layout == "auto":
            layout = "paged" if (dmax > max_degree and paged_ok) else "dense"
        if layout == "paged" and not paged_ok:
            raise ValueError(
                f"{type(self).__name__} reads the dense adjacency planes "
                "directly (bias/type/layerwise math) — the paged layout "
                "serves the SAGE-family flows only"
            )
        if layout == "dense" and dmax > max_degree:
            raise ValueError(
                f"graph max degree {dmax} exceeds max_degree={max_degree}; "
                f"the dense staged adjacency would cost (N+1)*{dmax}*4 "
                "bytes — use the paged device lane instead "
                "(layout='paged', or layout='auto' which selects it), "
                "or raise the cap explicitly after the memory math"
            )
        self.layout = layout
        if layout == "paged":
            self._stage_paged(graph, ids, degs, edge_types, page_size)
            return
        n = len(ids)
        adj = np.zeros((n + 1, dmax), dtype=np.int32)
        deg = np.zeros(n + 1, dtype=np.int32)
        wtab = np.zeros((n + 1, dmax), dtype=np.float32)
        ttab = np.full((n + 1, dmax), -1, dtype=np.int32) if stage_types else None
        strength = np.zeros(n + 1, dtype=np.float64)
        unit_w = True
        for lo in range(0, n, _STAGE_CHUNK):
            sub = ids[lo : lo + _STAGE_CHUNK]
            block, wblk, tblk, d, st, unit = _compact_block(graph, sub, edge_types, dmax)
            unit_w = unit_w and unit
            sl = slice(1 + lo, 1 + lo + len(sub))
            adj[sl, : block.shape[1]] = block
            wtab[sl, : block.shape[1]] = wblk
            if ttab is not None:  # each slot's edge type (the relation flow's)
                ttab[sl, : block.shape[1]] = tblk
            deg[sl] = d
            strength[sl] = st
        # per-node out-strength: DeviceGaeFlow draws edge sources by it
        self._out_strength = strength
        self.ttab = self._put(ttab) if ttab is not None else None
        self.adj = self._put(adj)
        self.deg = self._put(deg)
        self.unit_w = unit_w
        self.wtab = None if unit_w else self._put(wtab)
        if unit_w:
            self.qtab = None
        else:
            valid = np.arange(dmax)[None, :] < deg[:, None]
            self.qtab = self._put_u32(_quantize_rows(wtab, valid))
        self.max_deg = dmax

    def _stage_paged(self, graph, ids, degs, edge_types, page_size: int):
        """Compacted neighbour entries (the dense compaction's order, so
        draws land on the same slots) packed into fixed-size pages in
        flat buffers, with the per-node page table `page_start`."""
        P = int(page_size)
        if P <= 0 or PAGE_LANES % P:
            raise ValueError(f"page_size must divide {PAGE_LANES}; got {P}")
        n = len(ids)
        deg = np.zeros(n + 1, dtype=np.int32)
        strength = np.zeros(n + 1, dtype=np.float64)
        unit_w = True
        vals_p, w_p, q_p = [], [], []
        lo = 0
        while lo < n:
            cap_hint = max(int(degs[lo : lo + _STAGE_CHUNK].max(initial=1)), 1)
            chunk = max(256, min(_STAGE_CHUNK, _STAGE_TEMP_BYTES // (cap_hint * 8)))
            sub = ids[lo : lo + chunk]
            cap = max(int(degs[lo : lo + len(sub)].max(initial=0)), 1)
            block, wblk, _, d, st, unit = _compact_block(graph, sub, edge_types, cap)
            unit_w = unit_w and unit
            deg[1 + lo : 1 + lo + len(sub)] = d
            strength[1 + lo : 1 + lo + len(sub)] = st
            valid = np.arange(block.shape[1])[None, :] < d[:, None]
            vals_p.append(block[valid])
            w_p.append(wblk[valid])
            q_p.append(_quantize_rows(wblk, valid)[valid])
            lo += len(sub)
        self._out_strength = strength
        self.ttab = None
        npages = -(-deg.astype(np.int64) // P)  # ceil(deg/P); 0 for deg 0
        ps = np.zeros(n + 2, dtype=np.int64)
        ps[1:] = np.cumsum(npages)
        total_pages = max(int(ps[-1]), 1)
        flat = np.zeros(total_pages * P, dtype=np.int32)
        flat_w = np.zeros(total_pages * P, dtype=np.float32)
        flat_q = np.full(total_pages * P, _U32_MAX, dtype=np.uint32)
        # entries of node r (row+1 space) land at ps[r]*P + [0, deg_r)
        dest = np.repeat(ps[:-1] * P, deg) + _segment_arange(deg)
        if len(dest):
            flat[dest] = np.concatenate(vals_p)
            flat_w[dest] = np.concatenate(w_p)
            flat_q[dest] = np.concatenate(q_p)
        self.pages2d = as_lane_rows(self._put(flat))
        self.page_start = self._put(ps.astype(np.int32))
        self.deg = self._put(deg)
        self.unit_w = unit_w
        # EULER_TPU_PAGE_DTYPE=bf16 packs the weight plane two bf16 per
        # word, dequantized in the gather; batches carry bf16 weights
        # anyway, so the packed and f32 planes give the same batches. P=1
        # stays unpacked, as in the JAX package.
        self._page_w_packed = not unit_w and page_dtype() == "bf16" and P % 2 == 0
        if unit_w:
            self.page_w2d = self.page_q2d = self.page_bound = None
        else:
            w_plane = torch.from_numpy(flat_w)
            if self._page_w_packed:
                w_plane = pack_bf16_words(w_plane)
            self.page_w2d = as_lane_rows(w_plane.to(self.device))
            self.page_q2d = as_lane_rows(self._put_u32(flat_q))
            # per-page boundary = the page's last valid CDF value (pads
            # are U32_MAX, so a plain per-page max is exact)
            self.page_bound = self._put(
                flat_q.reshape(total_pages, P).max(axis=1).astype(np.int64)
            )
        self.page_size = P
        # clamp caps for masked draws: a trailing degree-0 node's
        # page_start equals total_pages, and its gather index must stay
        # inside the buffers
        self._page_cap = total_pages - 1
        self._slot_cap = total_pages * P - 1
        self.max_pages = int(npages.max(initial=0))
        # binary-search depth over a node's page range
        self._search_iters = max(1, int(self.max_pages).bit_length() + 1)
        self.max_deg = max(int(deg.max(initial=0)), 1)
        self.adj = self.wtab = self.qtab = None

    def _stage_nodes(self, graph, ids, wn, nt, roots_pool, root_node_type: int):
        n = len(ids)
        wn = np.asarray(wn, dtype=np.float64)
        # the unrestricted node CDF: negatives draw from every node even
        # when roots are pool- or type-restricted (host
        # unsupervised_batches' neg_type=-1)
        self.global_cdf = (
            self._quantize_cdf(wn, "graph node")
            if wn.size and not np.all(wn == wn[0])
            else None
        )
        pool_rows = None
        if roots_pool is not None:
            pool_rows = graph.lookup_rows(np.asarray(roots_pool, dtype=np.uint64))
            if np.any(pool_rows < 0):
                raise ValueError("roots_pool contains unknown node ids")
            wn = wn[pool_rows]
        elif root_node_type >= 0:
            pool_rows = np.nonzero(np.asarray(nt) == root_node_type)[0].astype(np.int64)
            if not len(pool_rows):
                raise ValueError(f"no nodes of type {root_node_type} to sample roots from")
            wn = wn[pool_rows]
        self.node_cdf = (
            self._quantize_cdf(wn, "root node")
            if wn.size and not np.all(wn == wn[0])
            else None
        )
        # int32 view of the u64 id space; row 0 (padding) maps to -1
        node_id = np.full(n + 1, -1, dtype=np.int32)
        node_id[1:] = ids.astype(np.int64).astype(np.int32)
        self.node_id = self._put(node_id)
        self.roots = self._put(pool_rows.astype(np.int32) + 1) if pool_rows is not None else None
        self.num_nodes = n

    # -- draws -----------------------------------------------------------

    def _bits(self, generator, shape) -> torch.Tensor:
        """Uniform u32 random bits, as int32 bit patterns."""
        return torch.randint(
            -(2**31), 2**31, shape, dtype=torch.int32, generator=generator, device=self.device
        )

    def _draw_roots(self, generator, count: int) -> torch.Tensor:
        """[count] root rows (row+1 space), weight-proportional."""
        if self.node_cdf is not None:
            r = u32(self._bits(generator, (count,)))
            pick = torch.searchsorted(self.node_cdf, r, right=True)
            pick = pick.clamp_max(len(self.node_cdf) - 1).to(torch.int32)
            return self.roots[pick] if self.roots is not None else pick + 1
        if self.roots is not None:
            pick = torch.randint(
                0, len(self.roots), (count,), generator=generator, device=self.device
            )
            return self.roots[pick]
        return torch.randint(
            1, self.num_nodes + 1, (count,), dtype=torch.int32,
            generator=generator, device=self.device,
        )

    def _draw_global_nodes(self, generator, count: int) -> torch.Tensor:
        """[count] rows (row+1 space) over ALL nodes, weight-proportional
        (ignores roots_pool/root_node_type): the negative draw."""
        if self.global_cdf is not None:
            r = u32(self._bits(generator, (count,)))
            pick = torch.searchsorted(self.global_cdf, r, right=True)
            return pick.clamp_max(self.num_nodes - 1).to(torch.int32) + 1
        return torch.randint(
            1, self.num_nodes + 1, (count,), dtype=torch.int32,
            generator=generator, device=self.device,
        )

    def _stage_flat_edges(self, graph, edge_type: int = -1, stage_er: bool = False):
        """Stage the flat (src, [type,] dst) edge columns and a weight CDF —
        the layout for whole-edge draws on any degree distribution (one
        searchsorted a draw, no max_degree guard). Edges with an endpoint
        missing from the node table are dropped. Sets eh/et (int32 ids,
        the host's truncation), er when stage_er (KG relations),
        num_edges and edge_cdf (None when the weights are all equal)."""
        if not all(hasattr(s, "edge_src") for s in graph.shards):
            raise ValueError("flat edge staging needs local shards with edge columns")
        h = np.concatenate([np.asarray(s.edge_src) for s in graph.shards])
        t = np.concatenate([np.asarray(s.edge_dst) for s in graph.shards])
        r = np.concatenate([np.asarray(s.edge_types) for s in graph.shards])
        w = np.concatenate([np.asarray(s.edge_weights, np.float64) for s in graph.shards])
        rows_ht = graph.lookup_rows(np.concatenate([h, t]))
        keep = (rows_ht[: len(h)] >= 0) & (rows_ht[len(h):] >= 0)
        if edge_type >= 0:
            keep &= r == edge_type
        h, t, r, w = h[keep], t[keep], r[keep], w[keep]
        if len(h) == 0 or np.sum(w) <= 0:
            raise ValueError("graph has no sampleable edges")
        to32 = lambda x: x.astype(np.int64).astype(np.int32)  # noqa: E731
        self.eh = self._put(to32(h))
        self.et = self._put(to32(t))
        self.er = self._put(r.astype(np.int32)) if stage_er else None
        self.num_edges = len(h)
        self.edge_cdf = None if np.all(w == w[0]) else self._quantize_cdf(w, "edge")

    def _draw_edges(self, generator, count: int) -> torch.Tensor:
        """[count] indices into the staged flat edge list, ∝ weight."""
        if self.edge_cdf is not None:
            r = u32(self._bits(generator, (count,)))
            return torch.searchsorted(self.edge_cdf, r, right=True).clamp_max(self.num_edges - 1)
        return torch.randint(0, self.num_edges, (count,), generator=generator,
                             device=self.device)

    def _hop_draw(self, generator, width: int, k: int) -> torch.Tensor:
        if self.unit_w:
            return torch.rand((width, k), generator=generator, device=self.device)
        return self._bits(generator, (width, k))

    def _draw_neighbors(self, cur: torch.Tensor, draw: torch.Tensor):
        """[W] rows and their [W, k] draws → ([W·k] rows, [W·k] bf16
        weights or None, [W, k] slot idx). Unit-weight graphs scale the
        uniforms by the degree (an f32 product, truncated); weighted
        graphs invert the per-row quantized CDF with the bits. Padding
        rows (0) yield padding."""
        if self.layout == "paged":
            return self._draw_neighbors_paged(cur, draw)
        deg = self.deg[cur]
        if self.unit_w:
            idx = (draw * deg[:, None]).to(torch.int32)
        else:
            qrow = u32(self.qtab[cur])  # [W, D]
            idx = (qrow[:, None, :] <= u32(draw)[:, :, None]).sum(dim=-1, dtype=torch.int32)
        idx = torch.minimum(idx, (deg[:, None] - 1).clamp_min(0))
        nbr = torch.where(deg[:, None] > 0, self.adj[cur[:, None].long(), idx.long()], 0)
        ew = None
        if not self.unit_w:
            ew = self.wtab[cur].gather(1, idx.long()).reshape(-1).to(torch.bfloat16)
        return nbr.reshape(-1), ew, idx

    def hop_tables(self) -> HopTables:
        """The staged paged tables one draw reads (layout "paged")."""
        return HopTables(
            self.deg, self.page_start, self.pages2d, self.page_bound, self.page_q2d,
            self.page_w2d, self.page_size, self._search_iters, self._page_cap,
            self._slot_cap, self.unit_w, self._page_w_packed,
        )

    def _draw_neighbors_paged(self, cur: torch.Tensor, draw: torch.Tensor):
        """Paged twin of the dense draw: page-boundary search plus in-page
        count, then the neighbour and weight gathers through the page
        indirection — the same integers as the dense inversion. One
        `paged_sample_hop` call: its kernel under the kernel mode, its plain
        version (the JAX package's composition) on the CPU and in modes
        'off' and 'ref'."""
        return paged_sample_hop(self.hop_tables(), cur, draw, impl=paged_impl())

    def _draw_neighbors_typed(self, cur: torch.Tensor, u: torch.Tensor, rel: int):
        """[W] rows and [W, k] f32 uniforms -> the draws of relation `rel`
        (counterpart: device.py:832-867): ([W·k] rows, [W·k] f32 weights,
        [W·k] valid mask). The row's weights are masked to slots of type
        `rel` and the uniforms invert their f32 cumsum — the host
        sample_neighbor(cur, [rel], k) distribution. A type's support is
        not contiguous, so a draw the f32 rounding puts on a zero-weight
        slot is redirected to the row's last in-support slot. Needs
        stage_types=True."""
        nbr_rows = self.adj[cur]  # [W, D]
        w = self.wtab[cur] if self.wtab is not None else (nbr_rows > 0).float()
        w = w * (self.ttab[cur] == rel)
        cw = torch.cumsum(w, dim=1)
        total = cw[:, -1]
        u = u * total[:, None]
        idx = (cw[:, None, :] <= u[:, :, None]).sum(dim=-1).clamp_max(self.adj.shape[1] - 1)
        wpick = torch.gather(w, 1, idx)
        slots = torch.arange(w.shape[1], device=w.device)
        last = torch.argmax(torch.where(w > 0, slots, -1), dim=1)
        idx = torch.where(wpick > 0, idx, last[:, None])
        alive = total > 0
        nbr = torch.where(alive[:, None], torch.gather(nbr_rows, 1, idx), 0)
        ew = torch.where(alive[:, None], torch.gather(w, 1, idx), 0.0)
        return nbr.reshape(-1), ew.reshape(-1), (nbr > 0).reshape(-1)

    def _stage_edge_src_cdf(self) -> None:
        """The quantized CDF over the nodes' out-strengths: a source drawn
        from it, then a neighbour from its row, is an edge drawn in
        proportion to its weight (host sample_edge's distribution;
        counterpart: device.py:869-876)."""
        self.edge_src_cdf = self._quantize_cdf(self._out_strength[1:], "edge-source out-strength")

    def _draw_edge_sources(self, generator, count: int) -> torch.Tensor:
        """[count] edge-source rows (row+1 space), by out-strength."""
        r = u32(self._bits(generator, (count,)))
        pick = torch.searchsorted(self.edge_src_cdf, r, right=True)
        return pick.clamp_max(self.num_nodes - 1).to(torch.int32) + 1


class DeviceSageFlow(DeviceGraphTables):
    """Device-resident adjacency + fanout sampling → lean MiniBatch.

    Pass it to an `Estimator`: each step draws with `draw_inputs` from a
    per-step generator and builds the batch with `make_batch`. The lean
    batch carries int32 feature rows (hydrated by a DeviceFeatureCache),
    bf16 edge weights on weighted graphs, and no masks or edge ids
    (`hydrate_blocks` rebuilds them).
    """

    def __init__(
        self,
        graph,
        fanouts,
        batch_size: int,
        label_feature: str | None = None,
        edge_types=None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        mesh=None,
        with_hop_ids: bool = False,
        layout: str = "auto",
        page_size: int = 16,
        *,
        device=None,
    ):
        """The reference's parameters in its order; `mesh` is not ported
        yet. with_hop_ids=True adds every hop's int32 node ids to the
        batch (`hop_ids`, id -1 on pad rows), what an id-embedding model
        reads: a gather of the staged id plane on the device, where the
        host lean wire leaves them out. On the CUDA card unless
        device="cpu"."""
        _refuse_mesh(type(self).__name__, mesh)
        super().__init__(
            graph, edge_types, max_degree, roots_pool, root_node_type,
            layout=layout, page_size=page_size, device=device,
        )
        self.fanouts = [int(k) for k in fanouts]
        self.batch_size = int(batch_size)
        self.with_hop_ids = bool(with_hop_ids)
        if label_feature is not None:
            from euler_tpu_torch.estimator.feature_cache import DeviceFeatureCache

            self.label_table = DeviceFeatureCache(graph, [label_feature], device=self.device).table
        else:
            self.label_table = None

    def _hop_draws(self, generator, width: int) -> tuple:
        """The fanout's draws from `width` roots: per hop [W_h, k_h]."""
        draws = []
        for k in self.fanouts:
            draws.append(self._hop_draw(generator, width, k))
            width *= k
        return tuple(draws)

    def draw_inputs(self, generator: torch.Generator):
        """One batch's random numbers: ([B] root rows, per hop [W_h, k_h]
        int32 bits (weighted) or f32 uniforms (unit weights))."""
        return (self._draw_roots(generator, self.batch_size),
                self._hop_draws(generator, self.batch_size))

    def make_batch(self, roots: torch.Tensor, hop_draws) -> MiniBatch:
        """Deterministic multi-hop fanout from [B] root rows and the hops'
        draws → lean MiniBatch."""
        cur = roots
        feats = [cur]
        blocks = []
        width = roots.shape[0]
        for k, draw in zip(self.fanouts, hop_draws):
            nbr, ew, _ = self._draw_neighbors(cur, draw)
            blocks.append(
                Block(edge_src=None, edge_dst=None, edge_w=ew, mask=None,
                      n_src=width * k, n_dst=width, grid=k)
            )
            feats.append(nbr)
            cur = nbr
            width *= k
        labels = self.label_table[feats[0]] if self.label_table is not None else None
        return MiniBatch(
            feats=tuple(feats),
            masks=None,
            blocks=tuple(blocks),
            root_idx=self.node_id[feats[0]],
            labels=labels,
            # pad rows map to id -1; the encoder clips them to row 0, and
            # hydrate_blocks derives the hop masks from the rows, so a pad
            # slot's embedding never reaches the aggregation
            hop_ids=tuple(self.node_id[f] for f in feats) if self.with_hop_ids else None,
        )

    def sample(self, generator: torch.Generator) -> MiniBatch:
        return self.make_batch(*self.draw_inputs(generator))


def _refuse_mesh(name: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{name}(mesh=) is not ported yet (ROADMAP queue 1 item 6: parallelism)"
        )


class DeviceUnsupSageFlow(DeviceSageFlow):
    """On-device (src, pos, negs) fanout triples for GraphSAGEUnsupervised
    (counterpart: euler_tpu/dataflow/device.py:1079-1121).

    Host parity: `unsupervised_batches` — pos is a sampled 1-hop neighbour
    of src (src itself where it has none), negs are `batch_size *
    num_negs` globally drawn nodes; each of the three gets its own lean
    multi-hop fanout batch. `make_batch` returns the 3-tuple of
    MiniBatches the model's (src, pos, negs) signature consumes. Under
    layout "paged" a step runs `paged_sample_hop` once for the pos draw
    and once a hop of each of the three batches.
    """

    def __init__(
        self,
        graph,
        fanouts,
        batch_size: int,
        num_negs: int = 5,
        edge_types=None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        mesh=None,
        with_hop_ids: bool = False,
        layout: str = "auto",
        page_size: int = 16,
        *,
        device=None,
    ):
        super().__init__(
            graph, fanouts, batch_size, None, edge_types, max_degree,
            roots_pool, root_node_type, mesh, with_hop_ids=with_hop_ids,
            layout=layout, page_size=page_size, device=device,
        )
        self.num_negs = int(num_negs)

    def draw_inputs(self, generator: torch.Generator):
        """(src rows [B], the pos draw [B, 1], neg rows [B*N], then the
        hop draws of the src, pos and neg fanouts), in JAX's key order."""
        b = self.batch_size
        src = self._draw_roots(generator, b)
        pos_draw = self._hop_draw(generator, b, 1)
        negs = self._draw_global_nodes(generator, b * self.num_negs)
        return (src, pos_draw, negs, self._hop_draws(generator, b),
                self._hop_draws(generator, b), self._hop_draws(generator, b * self.num_negs))

    def make_batch(self, src, pos_draw, negs, src_hops, pos_hops, neg_hops) -> tuple:
        nbr, _, _ = self._draw_neighbors(src, pos_draw)
        pos = torch.where(nbr > 0, nbr, src)
        fanout = super().make_batch
        return fanout(src, src_hops), fanout(pos, pos_hops), fanout(negs, neg_hops)


class DeviceWalkFlow(DeviceGraphTables):
    """On-device random walks + skip-gram pairs for DeepWalk / node2vec
    (counterpart: euler_tpu/dataflow/device.py:1124-1255).

    The walk is a length-L chain of one-neighbour draws against the dense
    staged adjacency; the sliding-window pair extraction is a static
    column gather (`gen_pair`'s pairs), and the negatives ride the root
    node CDF. `make_batch` returns `SkipGramModel`'s dict batch (src/pos
    int32 ids, negs [P, num_negs], mask), dead-walk slots -1 and masked.

    node2vec bias (p/q != 1): each step weights the current node's row
    by 1/p back to the previous node, 1 for neighbours of the previous
    node and 1/q elsewhere, then inverts an f32 cumsum of the biased
    weights with a uniform. The membership test is a [W, D, D] compare,
    so the biased walk needs max degree <= 64 (checked here).
    """

    _PAGED_OK = False  # _walk_step reads the dense adj plane directly

    def __init__(
        self,
        graph,
        batch_size: int,
        walk_len: int = 5,
        window: int = 2,
        num_negs: int = 5,
        p: float = 1.0,
        q: float = 1.0,
        edge_types=None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        mesh=None,
        layout: str = "auto",
        *,
        device=None,
    ):
        _refuse_mesh(type(self).__name__, mesh)
        super().__init__(graph, edge_types, max_degree, roots_pool, root_node_type,
                         layout=layout, device=device)
        self.batch_size = int(batch_size)
        self.walk_len = int(walk_len)
        self.num_negs = int(num_negs)
        self.p, self.q = float(p), float(q)
        self.biased = not (p == 1.0 and q == 1.0)
        if self.biased and self.max_deg > 64:
            raise ValueError(
                f"node2vec bias needs a [W, D, D] membership test; max "
                f"degree {self.max_deg} > 64 makes that table too wide — "
                "use the host random_walk for this graph"
            )
        # static sliding-window columns (gen_pair's pairs): for each
        # offset, source columns [lo, hi) pair with context columns
        # [lo+off, hi+off); padded tail slots point at column 0, invalid
        length = self.walk_len + 1
        src_cols, ctx_cols, valid = [], [], []
        for off in range(-window, window + 1):
            if off == 0:
                continue
            lo, hi = max(0, -off), min(length, length - off)
            cols = np.arange(length)
            src_cols.append(np.where(cols < hi - lo, cols + lo, 0))
            ctx_cols.append(np.where(cols < hi - lo, cols + lo + off, 0))
            valid.append(cols < hi - lo)
        self._src_cols = self._put(np.concatenate(src_cols).astype(np.int64))
        self._ctx_cols = self._put(np.concatenate(ctx_cols).astype(np.int64))
        self._col_valid = self._put(np.concatenate(valid).astype(np.int32))
        self.pairs_per_walk = int(self._src_cols.shape[0])

    def draw_inputs(self, generator: torch.Generator):
        """(root rows [B], per step its draw [B, 1] — f32 uniforms for the
        biased walk, else the hop draw —, negative rows [B*P*N])."""
        b = self.batch_size
        roots = self._draw_roots(generator, b)
        steps = tuple(
            torch.rand((b, 1), generator=generator, device=self.device)
            if self.biased else self._hop_draw(generator, b, 1)
            for _ in range(self.walk_len)
        )
        negs = self._draw_roots(generator, b * self.pairs_per_walk * self.num_negs)
        return roots, steps, negs

    def _walk_step(self, cur, prev, u):
        """One biased transition: the weight row times the node2vec bias,
        inverted with the uniforms `u` [W, 1] through its f32 cumsum."""
        width = cur.shape[0]
        nbr_rows = self.adj[cur]  # [W, D]
        deg = self.deg[cur]
        w = (nbr_rows > 0).float() if self.unit_w else self.wtab[cur]
        prev_nbrs = self.adj[prev]  # [W, D]
        is_back = nbr_rows == prev[:, None]
        near = ((nbr_rows[:, :, None] == prev_nbrs[:, None, :])
                & (prev_nbrs[:, None, :] > 0)).any(dim=-1)
        one = torch.ones_like(w)
        bias = torch.where(is_back, one * (1.0 / self.p),
                           torch.where(near, one, one * (1.0 / self.q)))
        bias = torch.where((prev > 0)[:, None], bias, one)
        bw = w * bias * (nbr_rows > 0).float()
        cum = torch.cumsum(bw, dim=1)
        idx = (cum <= u * cum[:, -1:]).sum(dim=1)
        idx = torch.minimum(idx, (deg.long() - 1).clamp_min(0))
        alive = (deg > 0) & (cum[:, -1] > 0)
        picked = nbr_rows[torch.arange(width, device=cur.device), idx]
        return torch.where(alive, picked, torch.zeros_like(picked))

    def make_batch(self, roots, steps, negs) -> dict:
        cur = roots
        walk = [cur]
        prev = torch.zeros_like(cur)
        for draw in steps:
            if self.biased:
                nxt = self._walk_step(cur, prev, draw)
            else:
                nxt, _, _ = self._draw_neighbors(cur, draw)
            prev, cur = cur, nxt
            walk.append(cur)
        walks = torch.stack(walk, dim=1)  # [B, L+1] rows (0 = dead)
        src = walks[:, self._src_cols] * self._col_valid
        ctx = walks[:, self._ctx_cols] * self._col_valid
        mask = (src > 0) & (ctx > 0)
        return {
            "src": self.node_id[src.reshape(-1)],
            "pos": self.node_id[ctx.reshape(-1)],
            "negs": self.node_id[negs].reshape(-1, self.num_negs),
            "mask": mask.reshape(-1),
        }

    def sample(self, generator: torch.Generator) -> dict:
        return self.make_batch(*self.draw_inputs(generator))


class _FlatEdgeFlow(DeviceGraphTables):
    """Shared staging of the flows that draw whole edges from the flat
    list (LINE, KG): edge columns + weight CDF + node tables for the
    negatives (counterpart: euler_tpu/dataflow/device.py:1258-1268)."""

    def __init__(self, graph, batch_size: int, num_negs: int, edge_type: int = -1,
                 mesh=None, stage_er: bool = False, *, device=None):
        _refuse_mesh(type(self).__name__, mesh)
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.num_negs = int(num_negs)
        self._stage_flat_edges(graph, edge_type, stage_er=stage_er)
        ids, wn, nt = _node_table(graph)
        self._stage_nodes(graph, ids, wn, nt, None, -1)

    def sample(self, generator: torch.Generator) -> dict:
        return self.make_batch(*self.draw_inputs(generator))


class DeviceEdgeFlow(_FlatEdgeFlow):
    """On-device weighted edge draws for LINE (counterpart:
    euler_tpu/dataflow/device.py:1271-1301; host parity `line_batches`):
    each edge one searchsorted over the flat list's weight CDF, the
    negatives from the global node CDF. `make_batch` returns the
    SkipGramModel dict batch."""

    def __init__(self, graph, batch_size: int, num_negs: int = 5,
                 edge_type: int = -1, mesh=None, *, device=None):
        super().__init__(graph, batch_size, num_negs, edge_type, mesh, device=device)

    def draw_inputs(self, generator: torch.Generator):
        """(edge picks [B], negative rows [B*N])."""
        pick = self._draw_edges(generator, self.batch_size)
        return pick, self._draw_global_nodes(generator, self.batch_size * self.num_negs)

    def make_batch(self, pick, negs) -> dict:
        return {
            "src": self.eh[pick],
            "pos": self.et[pick],
            "negs": self.node_id[negs].reshape(-1, self.num_negs),
            "mask": torch.ones(self.batch_size, dtype=torch.bool, device=pick.device),
        }


class DeviceKGFlow(_FlatEdgeFlow):
    """On-device (h, r, t) triples and corrupted heads/tails for the
    TransX family (counterpart: euler_tpu/dataflow/device.py:1304-1338;
    host parity `kg_batches`): the flat edge list (int32 h, r, t, 12
    bytes an edge), one searchsorted a draw, the corruptions from the
    global node CDF. `make_batch` returns TransX's dict batch."""

    def __init__(self, graph, batch_size: int, num_negs: int = 8,
                 edge_type: int = -1, mesh=None, *, device=None):
        super().__init__(graph, batch_size, num_negs, edge_type, mesh, stage_er=True,
                         device=device)

    def draw_inputs(self, generator: torch.Generator):
        """(edge picks [B], corruption rows [2*B*N])."""
        pick = self._draw_edges(generator, self.batch_size)
        negs = self._draw_global_nodes(generator, self.batch_size * self.num_negs * 2)
        return pick, negs

    def make_batch(self, pick, negs) -> dict:
        negs = self.node_id[negs].reshape(2, self.batch_size, self.num_negs)
        return {
            "h": self.eh[pick],
            "r": self.er[pick],
            "t": self.et[pick],
            "neg_h": negs[0],
            "neg_t": negs[1],
        }


class DeviceWholeGraphFlow(DeviceGraphTables):
    """Graph-classification batches drawn on the device (counterpart:
    euler_tpu/dataflow/device.py:1612-1708; host parity
    `WholeGraphDataFlow` + `graph_label_batches`).

    A graph-classification dataset is small, so every labelled graph,
    padded to max_nodes × max_degree, is staged on the device once from
    one host query: per-graph features, node masks, edges (localised to
    the graph's own slots; a masked edge's src to slot 0), edge weights,
    labels and node ids, stacked along a leading graph axis.
    `draw_inputs` draws the [B] labels uniformly; `make_batch` gathers
    them and offsets each graph's edges to its place in the batch."""

    def __init__(
        self,
        graph,
        feature_names,
        batch_size: int,
        max_nodes: int = 32,
        max_degree: int = 8,
        edge_types=None,
        mesh=None,
        host_flow=None,
        *,
        device=None,
    ):
        """host_flow: a WholeGraphDataFlow to stage from (its max_nodes and
        max_degree then govern the padding); built here otherwise. On the
        CUDA card unless device="cpu"."""
        from euler_tpu_torch.dataflow.whole import WholeGraphDataFlow

        _refuse_mesh(type(self).__name__, mesh)
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        host = host_flow or WholeGraphDataFlow(
            graph, feature_names, max_nodes=max_nodes, max_degree=max_degree,
            edge_types=edge_types,
        )
        if host.num_labels == 0:
            raise ValueError("graph has no graph labels to sample")
        self.num_classes = host.num_classes
        ng, nmax = host.num_labels, host.max_nodes
        all_b = host.query(np.arange(ng))
        self.grid = int(all_b.block.grid)
        e = nmax * self.grid
        local = np.arange(ng, dtype=np.int32)[:, None] * nmax
        emask = np.asarray(all_b.block.mask).reshape(ng, e)
        self.gfeats = self._put(np.asarray(all_b.feats).reshape(ng, nmax, -1))
        self.gmask = self._put(np.asarray(all_b.node_mask).reshape(ng, nmax))
        # a masked edge's src is slot 0 of the host table; localised to 0
        # (not -i*nmax), the batch offset added back keeps it in range
        self.gesrc = self._put(np.where(
            emask, np.asarray(all_b.block.edge_src).reshape(ng, e) - local, 0).astype(np.int32))
        self.gedst = self._put(
            (np.asarray(all_b.block.edge_dst).reshape(ng, e) - local).astype(np.int32))
        self.gew = self._put(np.asarray(all_b.block.edge_w).reshape(ng, e))
        self.gemask = self._put(emask)
        self.glabels = self._put(np.asarray(all_b.labels))
        self.ghop = self._put(np.asarray(all_b.hop_ids).reshape(ng, nmax))
        self.nmax = nmax
        self.num_graphs = ng
        b = self.batch_size
        self._offsets = self._put((np.arange(b, dtype=np.int32) * nmax)[:, None])
        self._graph_ids = self._put(np.repeat(np.arange(b, dtype=np.int32), nmax))

    def draw_inputs(self, generator: torch.Generator):
        """([B] graph labels, int64), drawn uniformly."""
        return (torch.randint(0, self.num_graphs, (self.batch_size,), generator=generator,
                              device=self.device),)

    def make_batch(self, pick: torch.Tensor):
        """The GraphBatch of the drawn labels `pick`."""
        from euler_tpu_torch.dataflow.whole import GraphBatch

        b, nmax = self.batch_size, self.nmax
        block = Block(
            edge_src=(self.gesrc[pick] + self._offsets).reshape(-1),
            edge_dst=(self.gedst[pick] + self._offsets).reshape(-1),
            edge_w=self.gew[pick].reshape(-1),
            mask=self.gemask[pick].reshape(-1),
            n_src=b * nmax,
            n_dst=b * nmax,
            grid=self.grid,
        )
        return GraphBatch(
            feats=self.gfeats[pick].reshape(b * nmax, -1),
            node_mask=self.gmask[pick].reshape(-1),
            block=block,
            graph_ids=self._graph_ids,
            labels=self.glabels[pick],
            hop_ids=self.ghop[pick].reshape(-1),
            n_graphs=b,
        )

    def sample(self, generator: torch.Generator):
        return self.make_batch(*self.draw_inputs(generator))


def _feature_table(graph, names, device) -> torch.Tensor:
    from euler_tpu_torch.estimator.feature_cache import DeviceFeatureCache

    return DeviceFeatureCache(graph, list(names), device=device).table


class DeviceRelationFlow(DeviceGraphTables):
    """Per-relation fanouts for RGCN drawn on the device (counterpart:
    euler_tpu/dataflow/device.py:1341-1447; host parity
    `RelationDataFlow`).

    One staged table set with the type plane serves every relation: a
    hop's draw of relation r masks the row's weights to type r before the
    CDF inversion (`_draw_neighbors_typed`). `make_batch` returns the
    RelMiniBatch RGCNSupervised consumes, its features gathered in the
    flow from the feature table (RelMiniBatch has no rows-mode
    hydration). Dense layout only."""

    _PAGED_OK = False  # typed draws mask the dense type plane

    def __init__(
        self,
        graph,
        feature_names,
        num_relations: int,
        batch_size: int,
        fanout: int = 5,
        num_hops: int = 2,
        label_feature: str | None = None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        mesh=None,
        *,
        device=None,
    ):
        from euler_tpu_torch.dataflow.relation import relation_src_slots

        _refuse_mesh(type(self).__name__, mesh)
        super().__init__(graph, None, max_degree, roots_pool, root_node_type,
                         stage_types=True, device=device)
        self.num_relations = int(num_relations)
        self.batch_size = int(batch_size)
        self.fanout = int(fanout)
        self.num_hops = int(num_hops)
        self.feat_table = _feature_table(graph, feature_names, self.device)
        self.label_table = (_feature_table(graph, [label_feature], self.device)
                            if label_feature is not None else None)
        # each hop's constant edge columns, made once (a captured step
        # cannot copy from the host)
        k, nr = self.fanout, self.num_relations
        self._src_slots, self._dst_slots, n = [], [], self.batch_size
        for _ in range(self.num_hops):
            self._src_slots.append(tuple(self._put(relation_src_slots(n, nr, k, r))
                                         for r in range(nr)))
            self._dst_slots.append(self._put(np.repeat(np.arange(n, dtype=np.int32), k)))
            n *= nr * k

    def draw_inputs(self, generator: torch.Generator):
        """([B] root rows, per hop and relation in that order its [W_h, k]
        f32 uniforms), in JAX's key order."""
        roots = self._draw_roots(generator, self.batch_size)
        draws, width = [], self.batch_size
        for _ in range(self.num_hops):
            for _ in range(self.num_relations):
                draws.append(torch.rand((width, self.fanout), generator=generator,
                                        device=self.device))
            width *= self.num_relations * self.fanout
        return roots, tuple(draws)

    def make_batch(self, roots: torch.Tensor, draws):
        from euler_tpu_torch.dataflow.relation import RelMiniBatch

        k, nr = self.fanout, self.num_relations
        cur = roots
        hop_rows, hop_masks, rel_blocks = [cur], [cur > 0], []
        it = iter(draws)
        for hop in range(self.num_hops):
            n = cur.shape[0]
            nxt, blocks = [], []
            for r in range(nr):
                nbr, ew, valid = self._draw_neighbors_typed(cur, next(it), r)
                nxt.append(nbr.reshape(n, k))
                blocks.append(Block(edge_src=self._src_slots[hop][r],
                                    edge_dst=self._dst_slots[hop], edge_w=ew.float(),
                                    mask=valid, n_src=n * nr * k, n_dst=n))
            rel_blocks.append(tuple(blocks))
            # the next hop interleaves the relations: [n, nr, k] flattened,
            # the slots the edge_src columns address
            cur = torch.stack(nxt, dim=1).reshape(-1)
            hop_rows.append(cur)
            hop_masks.append(cur > 0)
        return RelMiniBatch(
            feats=tuple(self.feat_table[rw] for rw in hop_rows),
            masks=tuple(hop_masks),
            rel_blocks=tuple(rel_blocks),
            root_idx=self.node_id[hop_rows[0]],
            labels=self.label_table[hop_rows[0]] if self.label_table is not None else None,
            hop_ids=tuple(self.node_id[rw] for rw in hop_rows),
        )

    def sample(self, generator: torch.Generator):
        return self.make_batch(*self.draw_inputs(generator))


class DeviceLayerwiseFlow(DeviceGraphTables):
    """LADIES layer draws on the device (counterpart:
    euler_tpu/dataflow/device.py:1451-1551; host parity
    `LayerwiseDataFlow`): a layer's candidate weights scatter-add into an
    [N+1] vector, a Gumbel top-k takes `count` of them without
    replacement (log w + Gumbel noise, `layerwise_from_full`'s recipe),
    and the batch -> layer adjacency is the [W, D, count] membership
    product, row-normalised. The Gumbel noise ([N+1] a layer) is a
    `draw_inputs` output. `make_batch` returns the LayerwiseBatch
    LayerwiseGCN consumes, features gathered in the flow. Dense layout
    only."""

    _PAGED_OK = False  # the layer scatter reads the dense adj/w planes

    def __init__(
        self,
        graph,
        feature_names,
        batch_size: int,
        layer_sizes=(128, 128),
        label_feature: str | None = None,
        normalize: bool = True,
        edge_types=None,
        max_degree: int = 512,
        roots_pool: np.ndarray | None = None,
        root_node_type: int = -1,
        mesh=None,
        *,
        device=None,
    ):
        _refuse_mesh(type(self).__name__, mesh)
        super().__init__(graph, edge_types, max_degree, roots_pool, root_node_type,
                         device=device)
        self.batch_size = int(batch_size)
        self.layer_sizes = [int(c) for c in layer_sizes]
        self.normalize = bool(normalize)
        self.feat_table = _feature_table(graph, feature_names, self.device)
        self.label_table = (_feature_table(graph, [label_feature], self.device)
                            if label_feature is not None else None)

    def draw_inputs(self, generator: torch.Generator):
        """([B] root rows, per layer [N+1] f32 Gumbel noise, drawn as
        jax.random.gumbel: -log(-log(u)), u uniform on [tiny, 1))."""
        roots = self._draw_roots(generator, self.batch_size)
        tiny = torch.finfo(torch.float32).tiny
        noise = []
        for _ in self.layer_sizes:
            u = torch.rand(self.num_nodes + 1, generator=generator, device=self.device)
            noise.append(-torch.log(-torch.log(u.clamp_min(tiny))))
        return roots, tuple(noise)

    def _sample_layer(self, cur: torch.Tensor, gumbel: torch.Tensor, count: int):
        """[W] rows -> ([count] layer rows, f32[W, count] adjacency,
        bool[count] layer mask)."""
        nbr = self.adj[cur]  # [W, D]
        w = self.wtab[cur] if self.wtab is not None else (nbr > 0).float()
        wsum = torch.zeros(self.num_nodes + 1, device=w.device)
        wsum = wsum.index_add(0, nbr.reshape(-1).long(), w.reshape(-1))
        wsum[0] = 0.0
        score = torch.where(wsum > 0, torch.log(wsum) + gumbel,
                            torch.full_like(wsum, float("-inf")))
        top, layer = torch.topk(score, count)
        lmask = top > float("-inf")
        layer = torch.where(lmask, layer, 0).to(torch.int32)
        hit = (nbr[:, :, None] == layer[None, None, :]) & (layer[None, None, :] > 0)
        adj = torch.einsum("wd,wdc->wc", w, hit.to(w.dtype))
        if self.normalize:
            adj = adj / adj.sum(dim=1, keepdim=True).clamp_min(1e-9)
        return layer, adj, lmask

    def make_batch(self, roots: torch.Tensor, noise):
        from euler_tpu_torch.dataflow.layerwise import LayerwiseBatch

        cur = roots
        layer_rows, layer_masks, adjs = [cur], [cur > 0], []
        for count, g in zip(self.layer_sizes, noise):
            layer, adj, lmask = self._sample_layer(cur, g, count)
            adjs.append(adj)
            cur = layer
            layer_rows.append(cur)
            layer_masks.append(lmask)
        return LayerwiseBatch(
            feats=tuple(self.feat_table[rw] for rw in layer_rows),
            masks=tuple(layer_masks),
            adjs=tuple(adjs),
            root_idx=self.node_id[layer_rows[0]],
            labels=self.label_table[layer_rows[0]] if self.label_table is not None else None,
            hop_ids=tuple(self.node_id[rw] for rw in layer_rows),
        )

    def sample(self, generator: torch.Generator):
        return self.make_batch(*self.draw_inputs(generator))


class DeviceGaeFlow(DeviceSageFlow):
    """(src, dst, neg) fanout triples for GAE / VGAE drawn on the device
    (counterpart: euler_tpu/dataflow/device.py:1555-1580; host parity
    `gae_batches`): src by out-strength through the edge-source CDF, dst
    a neighbour drawn from src's row (so src -> dst is an edge drawn in
    proportion to its weight), neg a global node draw; each gets its own
    lean fanout batch. On the paged layout a step runs
    `paged_sample_hop` once for the dst draw and once a hop of each of
    the three batches."""

    def __init__(self, graph, fanouts, batch_size, edge_types=None, max_degree: int = 512,
                 mesh=None, layout: str = "auto", page_size: int = 16, *, device=None):
        super().__init__(graph, fanouts, batch_size, None, edge_types, max_degree, mesh=mesh,
                         layout=layout, page_size=page_size, device=device)
        self._stage_edge_src_cdf()

    def draw_inputs(self, generator: torch.Generator):
        """(src rows [B], the dst draw [B, 1], neg rows [B], then the hop
        draws of the src, dst and neg fanouts), in JAX's key order."""
        b = self.batch_size
        src = self._draw_edge_sources(generator, b)
        dst_draw = self._hop_draw(generator, b, 1)
        neg = self._draw_global_nodes(generator, b)
        return (src, dst_draw, neg, self._hop_draws(generator, b), self._hop_draws(generator, b),
                self._hop_draws(generator, b))

    def make_batch(self, src, dst_draw, neg, src_hops, dst_hops, neg_hops) -> tuple:
        dst, _, _ = self._draw_neighbors(src, dst_draw)
        fanout = super().make_batch
        return fanout(src, src_hops), fanout(dst, dst_hops), fanout(neg, neg_hops)


class DeviceDgiFlow(DeviceSageFlow):
    """(real, corrupted) batches for DGI drawn on the device (counterpart:
    euler_tpu/dataflow/device.py:1583-1609; host parity `dgi_batches`):
    the corruption permutes each hop's feature rows across the batch —
    on a lean batch a row permutation is DGI's feature shuffle, since
    hydration gathers the permuted rows. The permutations (one a hop)
    are `draw_inputs` outputs. Under with_hop_ids the id plane rides the
    same permutation as the rows: ids, rows and the masks hydration
    derives from the rows move together, so no pad slot lands under a
    valid mask position in the corrupted view."""

    def draw_inputs(self, generator: torch.Generator):
        """([B] root rows, the hop draws, one permutation of each hop's
        rows)."""
        roots, hops = super().draw_inputs(generator)
        widths = [self.batch_size]
        for k in self.fanouts:
            widths.append(widths[-1] * k)
        perms = tuple(torch.randperm(w, generator=generator, device=self.device)
                      for w in widths)
        return roots, hops, perms

    def make_batch(self, roots, hop_draws, perms) -> tuple:
        mb = super().make_batch(roots, hop_draws)
        perm_feats = tuple(f[p] for f, p in zip(mb.feats, perms))
        perm_ids = (None if mb.hop_ids is None
                    else tuple(h[p] for h, p in zip(mb.hop_ids, perms)))
        return mb, dataclasses.replace(mb, feats=perm_feats, hop_ids=perm_ids)
