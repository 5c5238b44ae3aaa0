"""euler_tpu_torch `paged_sample_hop` (plain version, on the CPU) against the
JAX package's paged draw (`DeviceGraphTables._draw_neighbors_paged`, its
paged ops in their `impl="xla"` forms), bitwise, on tables both packages
stage from one graph: page sizes 1, 8, 16 and 128; packed bf16 and f32
weight planes and unit weights; hubs of 32 and 33 pages at P = 8 (the
kernel's 32-lane chunk boundary) and up to 270 pages at P = 1; degree-0
rows, a zero-weight row and a trailing degree-0 node; draws r = 0, r =
0xFFFFFFFF and r at, below and above a page bound.

The CUDA kernel itself runs only on a card; `chip_smoke.py` holds it
bitwise against the same plain version there. Here the kernel's
arithmetic (count the bounds <= r instead of the fixed-iteration search)
is replayed in numpy and held to the plain version on the same tables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.ops as jax_ops
from euler_tpu.dataflow.device import DeviceGraphTables as JaxTables
from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import DeviceSageFlow
from euler_tpu_torch.dataflow.device import DeviceGraphTables
from euler_tpu_torch.datasets import graph_with_degrees

torch.set_num_threads(1)

U32_MAX = 0xFFFFFFFF
# hubs of 270, 257 and 256 edges (34 / 33 / 32 pages at P = 8), a 40-edge
# row, a zero-weight row (position 4), ring-sized rows with degree-0 rows
# among them, and two trailing degree-0 nodes
DEGREES = [270, 257, 256, 40, 6] + [(i * 7) % 13 for i in range(40)] + [0, 0]
ZERO_WEIGHT_ROWS = (4,)
K = 12
PLANES = ["f32", "bf16", "unit"]


def _tables(plane, page_size, monkeypatch):
    """The port's staged tables of the hub graph, and a JAX
    DeviceGraphTables holding the same arrays (as JAX stages them: u32
    bounds, CDF and packed words), so both draws read one set of tables.
    tests/test_torch_device_flow.py holds the two packages' staging equal."""
    monkeypatch.setenv("EULER_TPU_PAGE_DTYPE", "f32" if plane == "unit" else plane)
    pg = graph_with_degrees(DEGREES, seed=5, unit_weights=plane == "unit",
                            zero_weight_rows=() if plane == "unit" else ZERO_WEIGHT_ROWS)
    pt = DeviceGraphTables(pg, layout="paged", page_size=page_size, device="cpu")
    assert pt.unit_w == (plane == "unit")
    assert pt._page_w_packed == (plane == "bf16" and page_size % 2 == 0)
    jt = object.__new__(JaxTables)
    for name in ("page_size", "unit_w", "_page_w_packed", "_search_iters", "_page_cap",
                 "_slot_cap"):
        setattr(jt, name, getattr(pt, name))
    for name in ("deg", "page_start", "pages2d", "page_bound", "page_q2d", "page_w2d"):
        x = getattr(pt, name)
        if x is not None:
            x = x.numpy()
            if name in ("page_bound", "page_q2d") or name == "page_w2d" and pt._page_w_packed:
                x = x.astype(np.uint32) if x.dtype == np.int64 else x.view(np.uint32)
            x = jnp.asarray(x)
        setattr(jt, name, x)
    return jt, pt


def _draws(pt, seed):
    """Rows: every row (padding row 0 and the trailing degree-0 nodes
    included) and each hub 4 times more; K draws each, with 0, U32_MAX and
    the hubs' page bounds (and one below and above) planted."""
    rng = np.random.default_rng(seed)
    n = pt.deg.shape[0]
    cur = np.concatenate([np.arange(n), np.repeat([1, 2, 3], 4)]).astype(np.int32)
    if pt.unit_w:
        u = rng.random((len(cur), K), dtype=np.float32)
        u[0, 0], u[1, :3] = 0.0, [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
        deg = pt.deg.numpy()[cur]
        # u at the slot boundaries j / deg of each row
        u[:, 3] = np.float32(3) / np.maximum(deg, 1).astype(np.float32)
        return torch.from_numpy(cur), torch.from_numpy(u)
    r = rng.integers(0, 2**32, (len(cur), K), dtype=np.uint64)
    r[0, 0], r[1, 0], r[1, 1] = 0, U32_MAX, 0
    bound = pt.page_bound.numpy()
    ps = pt.page_start.numpy()
    for i in range(n, len(cur)):  # the repeated hub rows
        pages = bound[ps[cur[i]] : ps[cur[i] + 1]]
        picks = rng.choice(len(pages), K // 3)
        r[i, : K // 3] = pages[picks]
        r[i, K // 3 : 2 * (K // 3)] = np.maximum(pages[picks].astype(np.int64) - 1, 0)
        r[i, 2 * (K // 3) :] = np.minimum(pages[picks].astype(np.int64) + 1, U32_MAX)
    bits = r.astype(np.uint32)
    return torch.from_numpy(cur), torch.from_numpy(bits.view(np.int32))


def _jax_hop(jt, cur, draw, monkeypatch):
    """JAX's `_draw_neighbors_paged`, its random numbers replaced by
    `draw`, under pallas mode 'off' (the paged ops' 'xla' forms)."""
    d = draw.numpy()
    if jt.unit_w:
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(d))
    else:
        monkeypatch.setattr(jax.random, "bits",
                            lambda key, shape, dtype: jnp.asarray(d.view(np.uint32)))
    prev = jax_ops.pallas_mode()
    jax_ops.set_pallas("off")
    try:
        assert jt._kimpl == "xla"
        hop = jax.jit(lambda c: jt._draw_neighbors_paged(c, jax.random.PRNGKey(0), d.shape[1]))
        nbr, ew, idx = hop(jnp.asarray(cur.numpy()))
    finally:
        jax_ops.set_pallas(prev)
    ew = None if ew is None else np.asarray(ew).view(np.uint16)
    return np.asarray(nbr), ew, np.asarray(idx)


def _kernel_arith(t, cur, draw):
    """The kernel's arithmetic in numpy: pages skipped = the count of the
    row's bounds <= r (no bound read for rows of one page or none), then
    the composition's clamps; int32 outputs, ew as bf16 bits."""
    cur = cur.numpy().astype(np.int64)
    deg = t.deg.numpy().astype(np.int64)[cur]
    ps = t.page_start.numpy().astype(np.int64)[cur]
    npages = t.page_start.numpy().astype(np.int64)[cur + 1] - ps
    P = t.page_size
    if t.unit_w:
        u = draw.numpy()
        idx = (u * deg[:, None].astype(np.float32)).astype(np.int32).astype(np.int64)
    else:
        r = draw.numpy().view(np.uint32).astype(np.int64)
        bound = t.page_bound.numpy()
        pg = np.zeros(r.shape, np.int64)
        for i in range(len(cur)):
            if npages[i] > 1:
                b = bound[ps[i] : ps[i] + npages[i]]
                pg[i] = (b[None, :] <= r[i][:, None]).sum(axis=1)
        pgc = np.minimum(pg, np.maximum(npages[:, None] - 1, 0))
        page = np.minimum(ps[:, None] + pgc, t.page_cap)
        q = t.page_q2d.numpy().reshape(-1).view(np.uint32).astype(np.int64)
        lanes = page[..., None] * P + np.arange(P)
        idx = pgc * P + (q[lanes] <= r[..., None]).sum(axis=-1)
    idx = np.minimum(idx, np.maximum(deg[:, None] - 1, 0))
    fidx = np.minimum(ps[:, None] * P + idx, t.slot_cap)
    live = deg[:, None] > 0
    nbr = np.where(live, t.pages2d.numpy().reshape(-1)[fidx], 0).reshape(-1)
    ew = None
    if not t.unit_w:
        words = t.page_w2d.numpy().reshape(-1).view(np.uint32)
        if t.w_packed:
            bits = np.where(fidx & 1, words[fidx >> 1] >> 16, words[fidx >> 1] & 0xFFFF)
        else:
            bits = torch.from_numpy(words[fidx].view(np.float32)).to(torch.bfloat16)
            bits = bits.view(torch.int16).numpy().view(np.uint16)
        ew = np.where(live, bits, 0).astype(np.uint16).reshape(-1)
    return nbr.astype(np.int32), ew, idx.astype(np.int32)


def _same(got, want):
    nbr, ew, idx = got
    assert nbr.dtype == torch.int32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(nbr.numpy(), want[0])
    np.testing.assert_array_equal(idx.numpy(), want[2])
    assert (ew is None) == (want[1] is None)
    if ew is not None:
        assert ew.dtype == torch.bfloat16 and ew.shape == nbr.shape
        np.testing.assert_array_equal(ew.view(torch.int16).numpy().view(np.uint16), want[1])


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("page_size", [1, 8, 16, 128])
def test_plain_hop_matches_jax(page_size, plane, monkeypatch):
    jt, pt = _tables(plane, page_size, monkeypatch)
    t = pt.hop_tables()
    if page_size == 8 and plane != "unit":
        npages = np.diff(pt.page_start.numpy())
        assert {34, 33, 32} <= set(npages[1:4].tolist())
    cur, draw = _draws(pt, seed=page_size)
    got = ops.paged_sample_hop_ref(t, cur, draw)
    _same(got, _jax_hop(jt, cur, draw, monkeypatch))
    # the kernel's arithmetic on the same tables
    _same(got, _kernel_arith(t, cur, draw))
    # auto on CPU tensors runs the plain version
    _same(ops.paged_sample_hop(t, cur, draw), _kernel_arith(t, cur, draw))


def test_device_flow_modes_give_jax_batches(monkeypatch):
    """DeviceSageFlow on the hub graph, bf16 plane, P = 8, fanouts 12, 3:
    kernel modes 'off', 'ref' and 'auto' on the CPU give the batch that
    JAX's paged draw gives hop by hop from the same rows and draws, bit for
    bit, without a kernel launch."""
    jt, _ = _tables("bf16", 8, monkeypatch)
    pg = graph_with_degrees(DEGREES, seed=5, zero_weight_rows=ZERO_WEIGHT_ROWS)
    pf = DeviceSageFlow(pg, fanouts=[K, 3], batch_size=16, layout="paged", page_size=8,
                        device="cpu")
    assert pf._page_w_packed
    roots, draws = pf.draw_inputs(torch.Generator().manual_seed(2))
    want, cur = [], roots
    for draw in draws:
        nbr, ew, _ = _jax_hop(jt, cur, draw, monkeypatch)
        want.append((nbr, ew))
        cur = torch.from_numpy(nbr.copy())
    before = ops.launch_counts()
    try:
        for mode in ("off", "ref", "auto"):
            ops.set_kernel_mode(mode)
            got = pf.make_batch(roots, draws)
            assert torch.equal(got.feats[0], roots)
            for (nbr, ew), feat, blk in zip(want, got.feats[1:], got.blocks):
                np.testing.assert_array_equal(feat.numpy(), nbr)
                np.testing.assert_array_equal(
                    blk.edge_w.view(torch.int16).numpy().view(np.uint16), ew)
    finally:
        ops.set_kernel_mode("auto")
    assert ops.launch_counts() == before


def test_cuda_impl_raises_on_cpu_tensors(monkeypatch):
    """No silent fallback: impl 'cuda', or kernel mode 'cuda' in the flow,
    on CPU tensors raises before any launch."""
    monkeypatch.setenv("EULER_TPU_PAGE_DTYPE", "bf16")
    pg = graph_with_degrees(DEGREES, seed=5, zero_weight_rows=ZERO_WEIGHT_ROWS)
    pf = DeviceSageFlow(pg, fanouts=[3], batch_size=4, layout="paged", page_size=8,
                        device="cpu")
    cur = torch.tensor([1, 2, 0, 7], dtype=torch.int32)
    draw = torch.zeros((4, 3), dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.paged_sample_hop(pf.hop_tables(), cur, draw, "cuda")
    ops.set_kernel_mode("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensors"):
            pf.make_batch(cur, (draw,))
    finally:
        ops.set_kernel_mode("auto")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_sample_hop(pf.hop_tables(), cur, draw, "pallas")
    assert ops.launch_counts() == before
    assert "paged_sample_hop" in before
