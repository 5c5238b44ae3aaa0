"""euler_tpu_torch paged ops (plain versions, on the CPU) against the JAX
package's `impl="xla"` forms and, at micro size, its Pallas kernels in
interpret mode: bitwise, for every op.

The CUDA kernels themselves run only on a card; `chip_smoke.py` holds
them bitwise against the same plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import pallas_kernels as jpk
from euler_tpu_torch import ops
from euler_tpu_torch.ops import paged

torch.set_num_threads(1)

# the JAX side as one jitted program a call (op by op, each op would
# compile on its own); integer work, so the same bits either way
_jit_gather = jax.jit(lambda flat, fidx, impl: jpk.paged_gather(jpk._as_lane_rows(flat), fidx, impl),
                      static_argnums=2)


def _i32(a) -> torch.Tensor:
    """A uint32 or int32 array as an int32 tensor of the same bits."""
    return torch.from_numpy(np.array(a).view(np.int32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _cdf_inputs(rng, P, deg, draws):
    """Quantized-CDF pages for nodes of degree `deg`, padding lanes
    0xFFFFFFFF (as tests/test_pallas.py builds them), and u32 draws that
    include 0 and 0xFFFFFFFF."""
    npages = -(-deg // P)
    ps = np.concatenate([[0], np.cumsum(npages)]).astype(np.int64)
    total = max(int(ps[-1]), 1)
    flat_q = np.full(total * P, 0xFFFFFFFF, np.uint32)
    for n in range(len(deg)):
        if deg[n]:
            cum = np.cumsum(rng.random(deg[n]))
            flat_q[ps[n] * P : ps[n] * P + deg[n]] = np.floor(
                cum / cum[-1] * (2**32 - 1)
            ).astype(np.uint64).astype(np.uint32)
    bound = flat_q.reshape(total, P).max(axis=1)
    r = rng.integers(0, 2**32, (len(deg), draws), dtype=np.uint64).astype(np.uint32)
    r[0, 0], r[-1, -1] = 0, 0xFFFFFFFF
    return flat_q, bound, ps, npages, r


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_paged_gather_matches_jax(dtype):
    rng = np.random.default_rng(0)
    flat = (rng.integers(-1000, 1000, 700) if dtype == np.int32
            else rng.normal(size=700)).astype(dtype)
    fidx = rng.integers(0, 700, (37, 10)).astype(np.int32)
    fidx[0, :2] = [0, 699]  # first and last element
    want = np.asarray(_jit_gather(jnp.asarray(flat), jnp.asarray(fidx), "xla"))
    t2d = paged.as_lane_rows(torch.from_numpy(flat))
    np.testing.assert_array_equal(t2d.numpy(), np.asarray(jpk._as_lane_rows(jnp.asarray(flat))))
    got = ops.paged_gather(t2d, torch.from_numpy(fidx)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_paged_gather_matches_jax_interpret():
    # Pallas interpret mode emulates every row DMA, so the sizes stay tiny
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 1000, 300).astype(np.int32)
    fidx = rng.integers(0, 300, (8, 1)).astype(np.int32)
    want = np.asarray(_jit_gather(jnp.asarray(flat), jnp.asarray(fidx), "interpret"))
    got = ops.paged_gather(paged.as_lane_rows(torch.from_numpy(flat)), torch.from_numpy(fidx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_gather_clamps_like_xla():
    flat = np.arange(256, dtype=np.int32)
    fidx = np.array([[255, 256, 10**6]], np.int32)
    want = np.asarray(_jit_gather(jnp.asarray(flat), jnp.asarray(fidx), "xla"))
    got = ops.paged_gather_ref(paged.as_lane_rows(torch.from_numpy(flat)), torch.from_numpy(fidx))
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16_values(rng, n):
    """f32 values whose bf16 rounding is exercised: random, exact ties
    (low 16 bits 0x8000, odd and even kept halves), ±0, ±inf, subnormals
    and the largest finite values."""
    u = rng.normal(size=n).astype(np.float32).view(np.uint32)
    u[: n // 4] = (u[: n // 4] & 0xFFFF0000) | 0x8000
    edge = np.array([0x3F808000, 0x3F818000, 0x7F7FFFFF, 0x00008000], np.uint32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40], np.float32)
    return np.concatenate([u.view(np.float32), edge.view(np.float32), special])


def test_pack_bf16_words_matches_jax():
    rng = np.random.default_rng(2)
    for n in (1, 7, 300):
        x = _bf16_values(rng, n)
        want = np.asarray(jax.jit(jpk.pack_bf16_words)(jnp.asarray(x)))
        got = paged.pack_bf16_words(torch.from_numpy(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("impl", ["xla", "interpret"])
def test_paged_gather_dequant_matches_jax(impl):
    rng = np.random.default_rng(3)
    # interpret mode emulates one row DMA per draw: one draw a row
    n, shape = (600, (41, 10)) if impl == "xla" else (256, (8, 1))
    x = _bf16_values(rng, n)
    words = jax.jit(lambda a: jpk._as_lane_rows(jpk.pack_bf16_words(a)))(jnp.asarray(x))
    fidx = rng.integers(0, len(x), shape).astype(np.int32)
    fidx.reshape(-1)[:3] = [0, 1, len(x) - 1]  # even, odd, last logical element
    want = np.asarray(jax.jit(jpk.paged_gather_dequant, static_argnums=2)(
        words, jnp.asarray(fidx), impl))
    got = ops.paged_gather_dequant(_i32(words), torch.from_numpy(fidx)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("P", [8, 16])
def test_paged_cdf_count_and_page_search_match_jax(P):
    rng = np.random.default_rng(4)
    deg = np.array([5, 21, 0, 8, 40, 1, 16])
    flat_q, bound, ps, npages, r = _cdf_inputs(rng, P, deg, 6)
    iters = int(npages.max()).bit_length() + 1
    pstart, npg = ps[:-1].astype(np.int32), npages.astype(np.int32)
    want_pg = np.asarray(jax.jit(jpk.paged_page_search, static_argnums=4)(
        jnp.asarray(bound), jnp.asarray(pstart), jnp.asarray(npg), jnp.asarray(r), iters
    ))
    got_pg = ops.paged_page_search(
        torch.from_numpy(bound.astype(np.int64)), torch.from_numpy(pstart),
        torch.from_numpy(npg), _i32(r), iters,
    )
    np.testing.assert_array_equal(got_pg.numpy(), want_pg)
    page = (pstart[:, None] + np.minimum(want_pg, np.maximum(npg[:, None] - 1, 0))).astype(np.int32)
    page = np.minimum(page, len(bound) - 1)
    q2d = jpk._as_lane_rows(jnp.asarray(flat_q))
    want = np.asarray(jax.jit(jpk.paged_cdf_count, static_argnums=(3, 4))(
        q2d, jnp.asarray(page), jnp.asarray(r), P, "xla"))
    got = ops.paged_cdf_count(_i32(q2d), torch.from_numpy(page), _i32(r), P)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # r == 0xFFFFFFFF counts the padding lanes too
    assert got.numpy()[-1, -1] == P


def test_paged_cdf_count_matches_jax_interpret():
    rng = np.random.default_rng(5)
    P = 8
    flat_q, _, ps, npages, r = _cdf_inputs(rng, P, np.array([5, 12, 3]), 1)
    page = np.minimum(ps[:-1, None] + rng.integers(0, 2, (3, 1)), len(flat_q) // P - 1).astype(np.int32)
    q2d = jpk._as_lane_rows(jnp.asarray(flat_q))
    want = np.asarray(jax.jit(jpk.paged_cdf_count, static_argnums=(3, 4))(
        q2d, jnp.asarray(page), jnp.asarray(r), P, "interpret"))
    got = ops.paged_cdf_count(_i32(q2d), torch.from_numpy(page), _i32(r), P)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_impl_raises_on_cpu_tensors():
    t2d = paged.as_lane_rows(torch.arange(256, dtype=torch.int32))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    before = ops.launch_counts()
    calls = [
        lambda: ops.paged_gather(t2d, idx, "cuda"),
        lambda: ops.paged_gather_dequant(t2d, idx, "cuda"),
        lambda: ops.paged_cdf_count(t2d, idx, idx, 8, "cuda"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="impl"):
        ops.paged_gather(t2d, idx, "pallas")
    with pytest.raises(ValueError, match="page_size"):
        ops.paged_cdf_count(t2d, idx, idx, 3)


def test_paged_impl_follows_kernel_mode():
    try:
        for mode, want in (("off", "ref"), ("ref", "ref"), ("cuda", "cuda"), ("auto", "auto")):
            ops.set_kernel_mode(mode)
            assert ops.paged_impl() == want
    finally:
        ops.set_kernel_mode("auto")
