"""euler_tpu_torch's two-stage selection (`paged_topk_select` in its plain
version, then `topk_keys`) and the FMA template's guard, on the CPU:

  * stage 1 plus stage 2 is bitwise equal to `canonical_topk` over the
    whole masked scores and to JAX's `lax.top_k` over
    `jnp.where(mask, paged_topk_score(..., "xla"), -inf)`, for k in
    {1, 32, 100, T, T + 1, > nrows}, nrows not a multiple of T, masks that
    are all false, leave fewer than k rows or are random, a bucket's
    padding query, 85 tied scores across a tile border, and +-0.0;
  * `products_exact` accepts sig12 normals and rejects underflow,
    overflow, raw f32, inf and NaN operands, and what it accepts has
    products that are exact in f32;
  * `TopKIndex.search` routed through the two stages (the card's path,
    with the plain versions underneath) is bitwise equal to the JAX
    `TopKIndex.search`, under either scorer template.

The CUDA kernels run only on a card; `chip_smoke.py` holds them bitwise
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import pallas_kernels as jpk
from euler_tpu.retrieval import corpus as jcorpus
from euler_tpu.retrieval import topk as jtopk
from euler_tpu_torch import ops
from euler_tpu_torch.retrieval import corpus as tcorpus
from euler_tpu_torch.retrieval import topk as ttopk

torch.set_num_threads(1)

T = 1024  # the smallest tile the kernel is built for
NROWS, DP, B, BP = 1500, 16, 3, 4  # two tiles, the second of 476 rows
KS = (1, 32, 100, T, T + 1, NROWS + 1)
TIE0, TIES = T - 40, 85  # rows TIE0 .. TIE0 + 84 hold one vector


def _sig12(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)


def _scored():
    """JAX's xla scores of BP sig12 queries (the last one a bucket's
    padding) against a sig12 corpus whose rows TIE0.. are one vector, the
    first query's: its top scores tie across the tile border."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((NROWS, DP)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[TIE0:TIE0 + TIES] = x[TIE0]
    q = rng.standard_normal((BP, DP)).astype(np.float32)
    q[0] = x[TIE0]
    x, q = _sig12(x), _sig12(q)
    flat = np.pad(x.reshape(-1), (0, (-x.size) % jpk.PAGE_LANES))
    return np.array(jpk.paged_topk_score(jnp.asarray(flat.reshape(-1, jpk.PAGE_LANES)),
                                          jnp.asarray(q), NROWS, DP, "xla"))


def _masks():
    rng = np.random.default_rng(12)
    few = np.zeros(NROWS, bool)
    few[[3, 1023, 1024, 1499]] = True
    return {"none": None, "all_false": np.zeros(NROWS, bool), "few": few,
            "random": rng.random(NROWS) < 0.5}


def _two_stage(s: np.ndarray, k: int, mask):
    keys = ops.paged_topk_select(torch.from_numpy(s), B, k,
                                 None if mask is None else torch.from_numpy(mask), tile=T)
    assert keys.dtype == torch.int64 and keys.shape == (B, -(-NROWS // T), min(k, T))
    return ops.topk_keys(keys.reshape(B, -1), min(k, NROWS))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("mask_name", ["none", "all_false", "few", "random"])
def test_two_stage_equals_canonical_and_lax_top_k(mask_name):
    s = _scored()
    s[B:] = np.nan  # the padding query is never read
    mask = _masks()[mask_name]
    masked = s[:B] if mask is None else np.where(mask[None, :], s[:B], np.float32(-np.inf))
    for k in KS:
        keff = min(k, NROWS)
        vals, idx = _two_stage(s, k, mask)
        cv, ci = ttopk.canonical_topk(torch.from_numpy(np.ascontiguousarray(masked)), keff)
        wv, wi = jax.lax.top_k(jnp.asarray(masked), keff)
        np.testing.assert_array_equal(idx.numpy(), ci.numpy(), err_msg=f"k={k}")
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi), err_msg=f"k={k}")
        np.testing.assert_array_equal(_bits(vals.numpy()), _bits(cv.numpy()))
        np.testing.assert_array_equal(_bits(vals.numpy()), _bits(np.asarray(wv)))
    if mask_name == "none":  # the first query's top 85 tie, across the border
        top = idx.numpy()[0, :TIES]
        assert sorted(top.tolist()) == list(range(TIE0, TIE0 + TIES))
        assert (vals.numpy()[0, :TIES] == vals.numpy()[0, 0]).all()


def test_two_stage_signed_zeros_ties_and_inf():
    """Synthetic scores: runs of equal values, +0.0 beside -0.0, -inf and
    a run of 90 equal maxima across the tile border."""
    rng = np.random.default_rng(13)
    s = (rng.integers(-3, 4, (BP, NROWS)) / 2).astype(np.float32)
    zero = s == 0
    s[zero & (rng.random(s.shape) < 0.5)] = -0.0
    s[1, ::7] = -np.inf
    s[2, T - 45:T + 45] = 9.0
    assert np.signbit(s[s == 0]).any() and (~np.signbit(s[s == 0])).any()
    for k in KS:
        keff = min(k, NROWS)
        vals, idx = _two_stage(s, k, None)
        wv, wi = jax.lax.top_k(jnp.asarray(s[:B]), keff)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi), err_msg=f"k={k}")
        np.testing.assert_array_equal(_bits(vals.numpy()), _bits(np.asarray(wv)))


def test_select_ref_tiles_and_padding():
    """Stage 1 alone: each tile's own canonical top, the short last tile
    padded with KEY_PAD."""
    s = torch.from_numpy(_scored())
    keys = ops.paged_topk_select_ref(s, B, 600, tile=T)
    assert keys.shape == (B, 2, 600)
    for t in range(2):
        part = s[:B, t * T:(t + 1) * T]
        n = min(600, part.shape[1])
        want = torch.topk(ops.order_keys(part), n, dim=1).values
        want = want - t * T  # order_keys numbers the tile's columns from 0
        assert torch.equal(keys[:, t, :n], want)
    assert (keys[:, 1, NROWS - T:] == ops.topk_score.KEY_PAD).all()


def test_select_refuses_bad_calls():
    s = torch.from_numpy(_scored())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.paged_topk_select(s, B, 5, tile=T, impl="cuda")
    with pytest.raises(ValueError, match="tile must be one of"):
        ops.paged_topk_select(s, B, 5, tile=1000)
    with pytest.raises(ValueError, match="1 <= b"):
        ops.paged_topk_select(s, BP + 1, 5)
    with pytest.raises(ValueError, match="k must be positive"):
        ops.paged_topk_select(s, B, 0)
    with pytest.raises(ValueError, match="mask must be bool"):
        ops.paged_topk_select(s, B, 5, torch.ones(NROWS, dtype=torch.uint8))
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.paged_topk_select(s, B, 5, impl="pallas")
    before = ops.launch_counts()
    assert torch.equal(ops.paged_topk_select(s, B, 5, tile=T, impl="auto"),
                       ops.paged_topk_select_ref(s, B, 5, tile=T))
    assert ops.launch_counts() == before


def _guard_operands(case: str):
    rng = np.random.default_rng(14)
    q = _sig12(rng.standard_normal((4, 32)).astype(np.float32))
    x = _sig12(rng.standard_normal((50, 32)).astype(np.float32))
    x[3] = 0.0
    if case == "underflow":
        q, x = q * np.float32(2.0**-70), x * np.float32(2.0**-70)
    elif case == "overflow":
        q, x = q * np.float32(2.0**64), x * np.float32(2.0**64)
    elif case == "raw_f32":
        q = rng.standard_normal((4, 32)).astype(np.float32)
    elif case == "inf":
        x[7, 2] = np.inf
    elif case == "nan":
        q[1, 5] = np.nan
    elif case == "subnormal_x":  # sig12 subnormals whose products stay normal
        x = _sig12(x * np.float32(2.0**-130))
        q = q * np.float32(2.0**20)
    return q, x


@pytest.mark.parametrize("case,accept", [
    ("sig12", True), ("subnormal_x", True), ("underflow", False), ("overflow", False),
    ("raw_f32", False), ("inf", False), ("nan", False),
])
def test_products_exact_guard(case, accept):
    q, x = _guard_operands(case)
    assert ops.products_exact(ops.operand_range(q), ops.operand_range(x)) is accept
    prod = q.astype(np.float64)[:, None, :] * x.astype(np.float64)[None, :, :]
    with np.errstate(over="ignore", invalid="ignore"):
        exact = prod.astype(np.float32).astype(np.float64) == prod
    if accept:  # the guard's claim: every product is exact in f32
        assert exact.all()
    elif case in ("underflow", "overflow", "raw_f32"):  # and a reject is needed
        assert not exact.all()


def test_operand_range():
    assert ops.operand_range(np.zeros((3, 4), np.float32)) == (np.inf, 0.0)
    assert ops.operand_range(np.array([1.5, -0.25, 0.0, -0.0], np.float32)) == (0.25, 1.5)
    assert ops.operand_range(np.array([1.0001], np.float32)) is None
    assert not ops.products_exact(None, (1.0, 1.0))


@pytest.mark.parametrize("metric,scale,template", [
    ("cosine", 1.0, "fma"), ("dot", 1.0, "fma"), ("dot", 2.0**-120, "mul_add"),
])
def test_search_through_both_stages_matches_jax(monkeypatch, metric, scale, template):
    """The card's branch of TopKIndex.search on CPU tensors (the kernels'
    plain versions underneath), both scorer templates, against
    `numpy_topk_oracle` and, where no product underflows (XLA on the CPU
    may flush subnormals), the JAX `TopKIndex`."""
    rng = np.random.default_rng(15)
    n, d = 600, 20
    ids = rng.choice(2**40, size=n, replace=False).astype(np.uint64)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[rng.choice(n, 15, replace=False)] = vecs[0]
    cat = rng.integers(0, 4, n)
    q = np.concatenate([vecs[:1], rng.standard_normal((2, d)).astype(np.float32)]) * scale
    j = jcorpus.EmbeddingCorpus.build(ids, vecs, {"cat": cat}, metric=metric)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, {"cat": cat}, metric=metric)
    jidx = jtopk.TopKIndex(j, impl="xla", buckets=(1, 4))
    tidx = ttopk.TopKIndex(t, buckets=(1, 4), device="cpu")
    monkeypatch.setattr(ttopk, "_resolve", lambda impl, tensor: "cuda")
    mask = t.condition_mask([[("cat", "in", [0, 2])]])
    order = np.argsort(ids)
    for k, m in ((10, None), (10, mask), (700, mask)):
        got = tidx.search(q, k, m)
        keep = None if m is None else m[np.argsort(order)]  # the oracle's input order
        wants = [ttopk.numpy_topk_oracle(ids, vecs, q, k, metric, keep)]
        if template == "fma":
            wants.append(jidx.search(q, k, m))
        for want in wants:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert tidx.templates[template] == 3 and sum(tidx.templates.values()) == 3
