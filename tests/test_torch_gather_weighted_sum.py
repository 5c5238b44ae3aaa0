"""euler_tpu_torch gather_weighted_sum (plain version, on the CPU) against
the JAX package's gather_weighted_sum, XLA and Pallas-interpret forms.

The CUDA kernel itself runs only on a card; `chip_smoke.py` holds it
against the same plain version there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas_kernels import gather_weighted_sum as jax_gws
from euler_tpu_torch import ops
from euler_tpu_torch.ops import gather_weighted_sum, gather_weighted_sum_ref

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(f, n_dst, d, n_src, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    slots = rng.integers(0, n_src, size=(n_dst, d)).astype(np.int32)
    w = rng.random((n_dst, d)).astype(np.float32)
    return x, slots, w


def _torch(x, slots, w):
    tx = (
        torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        if x.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(x)
    )
    return tx, torch.from_numpy(slots), torch.from_numpy(w)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [64, 128, 200])
def test_ref_matches_jax_xla(f, dtype):
    # n_dst = 13 is not a multiple of the TPU kernel's 8-row tile
    x, slots, w = _inputs(f, 13, 5, 40, dtype)
    want = np.asarray(jax_gws(jnp.asarray(x), jnp.asarray(slots), jnp.asarray(w), "xla"))
    got = gather_weighted_sum(*_torch(x, slots, w)).numpy()
    assert got.dtype == np.float32 and got.shape == (13, f)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("f,dtype", [(64, "f32"), (128, "bf16"), (200, "f32")])
def test_ref_matches_jax_interpret(f, dtype):
    # Pallas interpret mode emulates every row DMA, so the sizes stay tiny
    x, slots, w = _inputs(f, 5, 3, 11, dtype, seed=1)
    want = np.asarray(
        jax_gws(jnp.asarray(x), jnp.asarray(slots), jnp.asarray(w), "interpret")
    )
    got = gather_weighted_sum_ref(*_torch(x, slots, w)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cuda_impl_raises_on_cpu_tensors():
    x, slots, w = _torch(*_inputs(64, 4, 3, 9, "f32"))
    before = ops.launch_counts()["gather_weighted_sum"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_weighted_sum(x, slots, w, "cuda")
    assert ops.launch_counts()["gather_weighted_sum"] == before


def test_auto_and_ref_use_the_plain_version_on_cpu():
    x, slots, w = _torch(*_inputs(64, 4, 3, 9, "f32"))
    before = ops.launch_counts()["gather_weighted_sum"]
    want = torch.einsum("nd,ndf->nf", w, x[slots.long()])
    for impl in ("auto", "ref"):
        torch.testing.assert_close(gather_weighted_sum(x, slots, w, impl), want)
    assert ops.launch_counts()["gather_weighted_sum"] == before
    with pytest.raises(ValueError, match="impl"):
        gather_weighted_sum(x, slots, w, "pallas")


def test_kernel_mode_switch():
    assert ops.kernel_mode() == "auto"
    try:
        for mode in ops.KERNEL_MODES:
            ops.set_kernel_mode(mode)
            assert ops.kernel_mode() == mode
        with pytest.raises(ValueError):
            ops.set_kernel_mode("interpret")
    finally:
        ops.set_kernel_mode("auto")
