"""euler_tpu_torch `paged_topk_score` (its plain version, on the CPU)
against the JAX package's `impl="xla"` form and, at one tiny shape, its
Pallas kernel in interpret mode: bitwise, on the 12-bit-significand
operands retrieval feeds it.

The CUDA kernel runs only on a card; `chip_smoke.py` holds it bitwise
against the same plain version there, for raw f32 operands too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import pallas_kernels as jpk
from euler_tpu.retrieval.corpus import pad_dim as jax_pad_dim
from euler_tpu_torch import ops
from euler_tpu_torch.ops import topk_score

torch.set_num_threads(1)


def _sig12(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)


def _inputs(rng, nrows, dp, b, tail=5):
    """sig12 corpus rows packed in lane rows, with a non-zero tail after
    nrows * dp that the scorer must not read."""
    x = _sig12(rng.standard_normal((nrows, dp)).astype(np.float32))
    q = _sig12(rng.standard_normal((b, dp)).astype(np.float32))
    flat = np.concatenate([x.reshape(-1), rng.standard_normal(tail).astype(np.float32)])
    flat = np.pad(flat, (0, (-flat.size) % jpk.PAGE_LANES), constant_values=7.0)
    return flat.reshape(-1, jpk.PAGE_LANES), x, q


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


# every width pad_dim yields up to two lane rows
@pytest.mark.parametrize("dp", sorted({jax_pad_dim(d) for d in range(1, 257)}))
def test_ref_matches_jax_xla_bitwise(dp):
    rng = np.random.default_rng(dp)
    nrows, b = 37, 3
    t2d, x, q = _inputs(rng, nrows, dp, b)
    want = np.asarray(jpk.paged_topk_score(jnp.asarray(t2d), jnp.asarray(q), nrows, dp, "xla"))
    got = ops.paged_topk_score(torch.from_numpy(t2d), torch.from_numpy(q), nrows, dp)
    assert got.dtype == torch.float32 and got.shape == (b, nrows)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_ref_matches_jax_interpret_bitwise():
    rng = np.random.default_rng(1)
    nrows, dp, b = 21, 32, 2
    t2d, _, q = _inputs(rng, nrows, dp, b)
    want = np.asarray(
        jpk.paged_topk_score(jnp.asarray(t2d), jnp.asarray(q), nrows, dp, "interpret")
    )
    got = topk_score.paged_topk_score_ref(torch.from_numpy(t2d), torch.from_numpy(q), nrows, dp)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("dp", [3, 8, 128])
def test_ref_is_the_left_to_right_loop_for_any_f32(dp):
    """Raw f32 operands (not sig12): the plain version is one multiply and
    one add per d, as a NumPy loop is, so the two agree bitwise."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((50, dp)).astype(np.float32)
    q = rng.standard_normal((4, dp)).astype(np.float32)
    acc = np.zeros((4, 50), np.float32)
    for d in range(dp):
        acc = acc + q[:, d][:, None] * x[:, d][None, :]
    got = ops.paged_topk_score(torch.from_numpy(x.reshape(-1)), torch.from_numpy(q), 50, dp)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(acc))


def test_auto_runs_the_plain_version_on_cpu_and_cuda_refuses():
    rng = np.random.default_rng(3)
    t2d, _, q = _inputs(rng, 9, 16, 2)
    t2d, q = torch.from_numpy(t2d), torch.from_numpy(q)
    before = ops.launch_counts()
    auto = ops.paged_topk_score(t2d, q, 9, 16, "auto")
    ref = ops.paged_topk_score(t2d, q, 9, 16, "ref")
    assert torch.equal(auto, ref)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.paged_topk_score(t2d, q, 9, 16, "cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.paged_topk_score(t2d, q, 9, 16, "pallas")
    with pytest.raises(ValueError, match="queries must be"):
        ops.paged_topk_score(t2d, q[:, :8], 9, 16)
    with pytest.raises(ValueError, match="elements"):
        ops.paged_topk_score(t2d, q, 10**6, 16)
    assert ops.paged_topk_score(t2d, q, 0, 16).shape == (2, 0)
