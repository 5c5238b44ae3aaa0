"""The retrieval slice of euler_tpu_torch against the JAX package, on the
CPU: the attribute indexes and DNF masks, the corpus (bitwise: ids,
vectors, version, lane rows, shards, lookups), `TopKIndex.search`
(bitwise against JAX's `TopKIndex` and `numpy_topk_oracle`, ties at the
k-th place included), `merge_topk`, checkpoints in both directions, and
`tools.knn` within a stated tolerance.

Small corpora only (<= 600 rows); the JAX indexes use buckets (1, 4) so
that they compile few programs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.graph import index as jindex
from euler_tpu.retrieval import corpus as jcorpus
from euler_tpu.retrieval import topk as jtopk
from euler_tpu.tools import knn as jknn
from euler_tpu.training.checkpoint import CheckpointStore as JaxCheckpointStore
from euler_tpu_torch.graph import index as tindex
from euler_tpu_torch.retrieval import corpus as tcorpus
from euler_tpu_torch.retrieval import topk as ttopk
from euler_tpu_torch.retrieval.server import _CorpusEngine
from euler_tpu_torch.tools import knn as tknn
from euler_tpu_torch.training.checkpoint import CheckpointStore

torch.set_num_threads(1)

FILTER = [[("cat", "in", [0, 2])]]


def _data(seed=0, n=600, d=20, hot=2, copies=15):
    """Unique random u64 ids, normal vectors with `hot` vectors copied to
    `copies` rows each (so equal scores straddle the k-th place), and
    attribute columns of each index kind."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(2**40, size=n, replace=False).astype(np.uint64) * np.uint64(7919)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    rows = rng.choice(n, size=(hot, copies), replace=False)
    vecs[rows[:, 1:]] = vecs[rows[:, :1]]
    attrs = {
        "cat": rng.integers(0, 4, n),
        "score": rng.standard_normal(n),
        "tag": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
    }
    q = np.concatenate([vecs[rows[:, 0]], rng.standard_normal((3, d)).astype(np.float32)])
    return ids, vecs, attrs, q


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))


# -- indexes and masks ------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "float", "u64", "str"])
def test_indexes_match_jax(kind):
    rng = np.random.default_rng(5)
    n = 40
    col = {
        "int": rng.integers(-3, 4, n),
        "float": np.round(rng.standard_normal(n), 1),
        "u64": rng.integers(0, 6, n).astype(np.uint64),
        "str": np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, n)],
    }[kind]
    rows = np.arange(n, dtype=np.int64)
    if kind == "str":
        pairs = [(jindex.HashIndex.build(rows, col, n), tindex.HashIndex.build(rows, col, n))]
        probes = [("eq", "x"), ("ne", "y"), ("in", ["x", "z"]), ("not_in", ["z"]), ("haskey", None)]
    else:
        pairs = [(jindex.RangeIndex.build(col), tindex.RangeIndex.build(col))]
        v = col[3].item()
        probes = [(op, v) for op in ("eq", "ne", "lt", "le", "gt", "ge")]
        probes += [("in", [col[0].item(), col[5].item()]), ("not_in", [v]), ("haskey", None),
                   ("lt", -1), ("ge", 0.5)]
    for j, t in pairs:
        for op, value in probes:
            np.testing.assert_array_equal(t.search(op, value), j.search(op, value),
                                          err_msg=f"{kind} {op} {value}")
    assert tindex.OPS == jindex.OPS
    for v in (b"k", "k", 3.0, 2.5, np.int64(4)):
        assert tindex._key(v) == jindex._key(v)


@pytest.mark.parametrize("dnf", [
    [],
    FILTER,
    [[("cat", "not_in", [1])]],
    [[("score", "ge", -0.5), ("score", "lt", 0.75)]],
    [[("cat", "eq", 1)], [("score", "gt", 1.0)]],
    [[("tag", "eq", "b"), ("cat", "ne", 3)], [("tag", "in", ["c"])]],
    [[("id", "le", 2**39 * 7919)]],
    [[("cat", "eq", 9)]],
])
def test_condition_mask_matches_jax(dnf):
    ids, vecs, attrs, _ = _data()
    j = jcorpus.EmbeddingCorpus.build(ids, vecs, attrs)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, attrs)
    np.testing.assert_array_equal(t.condition_mask(dnf), j.condition_mask(dnf))
    with pytest.raises(ValueError, match="no attribute column"):
        t.condition_mask([[("nope", "eq", 1)]])


# -- the corpus -------------------------------------------------------------


def test_pad_dim_normalize_quantize_match_jax():
    for d in list(range(1, 300)):
        assert tcorpus.pad_dim(d) == jcorpus.pad_dim(d)
    with pytest.raises(ValueError):
        tcorpus.pad_dim(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 7)).astype(np.float32) * 1e3
    x[3] = 0.0  # a zero row passes through
    x[4, 2], x[5, 1], x[6, 0] = np.inf, np.nan, -0.0
    for fn in ("normalize_rows", "quantize_sig12"):
        want = getattr(jcorpus, fn)(x)
        got = getattr(tcorpus, fn)(x)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("metric,d", [("dot", 5), ("cosine", 20), ("cosine", 130)])
def test_corpus_build_matches_jax(metric, d):
    ids, _, attrs, _ = _data()
    vecs = np.random.default_rng(d).standard_normal((len(ids), d)).astype(np.float32)
    j = jcorpus.EmbeddingCorpus.build(ids, vecs, attrs, metric=metric, step=7)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, attrs, metric=metric, step=7)
    assert (t.version, t.step, t.dim, t.dim_padded, t.metric) == (
        j.version, j.step, j.dim, j.dim_padded, j.metric)
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_array_equal(t.vectors.view(np.uint32), j.vectors.view(np.uint32))
    np.testing.assert_array_equal(t.lane_rows().view(np.uint32), j.lane_rows().view(np.uint32))
    for name in attrs:
        np.testing.assert_array_equal(t.attrs[name], j.attrs[name])
    assert t.stats() == j.stats()
    probe = np.concatenate([ids[:5], np.array([1, 2**63], dtype=np.uint64)])
    np.testing.assert_array_equal(t.lookup(probe), j.lookup(probe))
    for part in range(3):
        ts, js = t.shard(part, 3), j.shard(part, 3)
        assert ts.version == js.version
        np.testing.assert_array_equal(ts.ids, js.ids)
        np.testing.assert_array_equal(ts.vectors, js.vectors)
        np.testing.assert_array_equal(ts.attrs["cat"], js.attrs["cat"])
    with pytest.raises(ValueError, match="unique"):
        tcorpus.EmbeddingCorpus.build(np.zeros(2, np.uint64), vecs[:2])


def test_from_checkpoint_crosses_both_ways(tmp_path):
    """JAX's CheckpointStore writes, the port reads; the port's
    save_leaves writes, JAX reads: the same corpus either way."""
    ids, vecs, attrs, _ = _data()
    other = np.ones((3, 4), np.float32)
    JaxCheckpointStore(str(tmp_path / "jax")).save_leaves(5, [other, vecs], [], {})
    CheckpointStore(str(tmp_path / "port")).save_leaves(5, [other, vecs], [])
    for src in ("jax", "port"):
        path = str(tmp_path / src)
        t = tcorpus.EmbeddingCorpus.from_checkpoint(path, ids, attrs=attrs, metric="cosine")
        j = jcorpus.EmbeddingCorpus.from_checkpoint(path, ids, attrs=attrs, metric="cosine")
        assert (t.version, t.step) == (j.version, j.step) == (j.version, 5)
        np.testing.assert_array_equal(t.ids, j.ids)
        np.testing.assert_array_equal(t.vectors.view(np.uint32), j.vectors.view(np.uint32))
    CheckpointStore(str(tmp_path / "port")).save_leaves(6, [vecs, vecs + 1], [])
    with pytest.raises(ValueError, match="pass leaf="):
        tcorpus.EmbeddingCorpus.from_checkpoint(str(tmp_path / "port"), ids)
    c = tcorpus.EmbeddingCorpus.from_checkpoint(str(tmp_path / "port"), ids, leaf=1)
    np.testing.assert_array_equal(c.vectors[:, : c.dim],
                                  tcorpus.quantize_sig12((vecs + 1)[np.argsort(ids)]))


# -- search -----------------------------------------------------------------


def test_canonical_topk_equals_lax_top_k():
    """Heavy ties, negatives, zeros and -inf: (score desc, index asc), the
    k-th place included."""
    rng = np.random.default_rng(2)
    s = rng.integers(-3, 4, (5, 200)).astype(np.float32) / 2
    s[1, ::3] = -np.inf
    s[2] = -np.inf
    s[3, :7] = 1e30
    k = 17
    wv, wi = jax.lax.top_k(jnp.asarray(s), k)
    gv, gi = ttopk.canonical_topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("metric", ["dot", "cosine"])
def test_search_matches_jax_and_oracle(metric):
    ids, vecs, attrs, q = _data()
    j = jcorpus.EmbeddingCorpus.build(ids, vecs, attrs, metric=metric)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, attrs, metric=metric)
    jidx = jtopk.TopKIndex(j, impl="xla", buckets=(1, 4))
    tidx = ttopk.TopKIndex(t, buckets=(1, 4), device="cpu")
    keep = np.isin(attrs["cat"], [0, 2])  # masks in input order (the oracle's)
    few = np.isin(np.arange(len(ids)), [3, 50, 51, 400, 599])
    order = np.argsort(ids)  # the corpus's row order
    cases = [
        (q[:4], 10, None),  # hot queries: 15 equal scores across k = 10
        (q[:4], 10, keep),
        (q[:3], 8, few),  # k > the 5 candidates
        (np.concatenate([q, q[:4]]), 10, None),  # B = 9 > the top bucket
    ]
    for qq, k, mask in cases:
        got = tidx.search(qq, k, None if mask is None else mask[order])
        _same(got, jidx.search(qq, k, None if mask is None else mask[order]))
        _same(got, ttopk.numpy_topk_oracle(ids, vecs, qq, k, metric, mask))
    np.testing.assert_array_equal(t.condition_mask(FILTER), keep[order])
    assert (got[1][:2, 0] == got[1][:2, 9]).all()  # the hot queries tie at the k-th place
    ids_k, scores_k, valid_k = tidx.search(q[:3], 8, few[order])
    assert valid_k.sum(axis=1).tolist() == [5, 5, 5]
    assert (ids_k[~valid_k] == tcorpus.INVALID_ID).all() and np.isneginf(scores_k[~valid_k]).all()
    assert (scores_k[0, :-1] >= scores_k[0, 1:]).all()
    with pytest.raises(ValueError, match="mask must be"):
        tidx.search(q, 4, keep[:10])


def test_oracle_copy_and_buckets_match_jax():
    ids, vecs, _, q = _data(seed=4, n=200)
    keep = np.arange(200) % 3 > 0
    for metric in ("dot", "cosine"):
        _same(ttopk.numpy_topk_oracle(ids, vecs, q, 12, metric, keep),
              jtopk.numpy_topk_oracle(ids, vecs, q, 12, metric, keep))
    assert ttopk.BUCKETS == jtopk.BUCKETS
    for b in (0, 1, 2, 4, 5, 16, 17, 64, 65, 200):
        assert ttopk.bucket_for(b) == jtopk.bucket_for(b)


@pytest.mark.parametrize("parts", [2, 3])
def test_merge_topk_over_shards_equals_single_shard(parts):
    ids, vecs, attrs, q = _data(seed=parts)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, attrs, metric="cosine")
    for dnf in (None, FILTER):
        whole = ttopk.TopKIndex(t, device="cpu").search(
            q, 10, None if dnf is None else t.condition_mask(dnf))
        answers = []
        for p in range(parts):
            shard = t.shard(p, parts)
            answers.append(ttopk.TopKIndex(shard, device="cpu").search(
                q, 10, None if dnf is None else shard.condition_mask(dnf)))
        _same(ttopk.merge_topk(answers, 10), whole)
        _same(jtopk.merge_topk(answers, 10), whole)
    with pytest.raises(ValueError):
        ttopk.merge_topk([], 3)


def test_engine_masks_warmup_and_device():
    ids, vecs, attrs, q = _data(seed=6, n=300)
    t = tcorpus.EmbeddingCorpus.build(ids, vecs, attrs)
    eng = _CorpusEngine(t, device="cpu")
    eng.MASK_CACHE = 2
    assert eng.index.warmup(5) == len(eng.index.buckets)
    assert eng.warm(5) is eng and eng.index.warmup(5) == 0
    dnfs = [json.dumps(FILTER), json.dumps([[["cat", "eq", 3]]]), json.dumps([[["tag", "eq", "a"]]])]
    for dnf in dnfs:
        _same(eng.retrieve(q, 6, dnf), eng.index.search(q, 6, t.condition_mask(json.loads(dnf))))
    assert list(eng._masks) == dnfs[1:]
    _same(eng.retrieve(q, 6, None), eng.index.search(q, 6))
    empty = tcorpus.EmbeddingCorpus.build(np.zeros(0, np.uint64), np.zeros((0, 4), np.float32))
    ids_e, _, valid_e = ttopk.TopKIndex(empty, device="cpu").search(q[:, :4], 3)
    assert not valid_e.any() and (ids_e == tcorpus.INVALID_ID).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttopk.TopKIndex(t)


# -- tools.knn --------------------------------------------------------------


@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
def test_knn_search_matches_jax(metric):
    """Matmul sums in another order than XLA's: scores within 1e-5
    relative (f32), the same neighbours on data without near ties."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    qs = rng.standard_normal((7, 16)).astype(np.float32)
    wi, ws = jknn.knn_search(emb, qs, k=5, metric=metric, chunk=4)
    gi, gs = tknn.knn_search(emb, qs, k=5, metric=metric, chunk=4, device="cpu")
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-5)


def test_knn_load_inferred_and_main(tmp_path, capsys):
    rng = np.random.default_rng(9)
    for w in (0, 1):
        np.save(tmp_path / f"embedding_{w}.npy", rng.standard_normal((20, 8)).astype(np.float32))
        np.save(tmp_path / f"ids_{w}.npy", np.arange(20 * w, 20 * w + 20, dtype=np.int64))
    ids, embs = tknn.load_inferred(str(tmp_path))
    jids, jembs = jknn.load_inferred(str(tmp_path))
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(embs, jembs)
    assert tknn.main(["--model-dir", str(tmp_path), "--k", "3", "--query-ids", "5", "33",
                      "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    idx, _ = tknn.knn_search(embs, embs[[5, 33]], 3, device="cpu")
    assert [[int(p.split("(")[0]) for p in line.split(": ")[1].split(", ")] for line in lines] == [
        [int(ids[r]) for r in row] for row in idx]
    with pytest.raises(FileNotFoundError):
        tknn.load_inferred(str(tmp_path / "none"))
