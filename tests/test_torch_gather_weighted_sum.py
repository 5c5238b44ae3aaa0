"""euler_tpu_torch gather_weighted_sum (plain version, on the CPU) against
the JAX package's gather_weighted_sum, XLA and Pallas-interpret forms,
and its plain backward against the JAX custom VJP.

The CUDA kernels themselves (forward and dx) run only on a card;
`chip_smoke.py` holds them against the same plain versions there.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas_kernels import gather_weighted_sum as jax_gws
from euler_tpu_torch import ops
from euler_tpu_torch.ops import (
    gather_weighted_sum,
    gather_weighted_sum_dx,
    gather_weighted_sum_dx_ref,
    gather_weighted_sum_ref,
)
from euler_tpu_torch.ops.gather_weighted_sum import _vec

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


def _jax_vjp(x, slots, w, g):
    """(dx, dw) of the JAX package's custom VJP (impl 'xla') for cotangent g."""
    _, vjp = jax.vjp(lambda xx, ww: jax_gws(xx, jnp.asarray(slots), ww, "xla"),
                     jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(dx.astype(jnp.float32)), np.asarray(dw)


def _iota(n_dst, d):
    return np.arange(n_dst * d, dtype=np.int32).reshape(n_dst, d)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("f", [16, 67, 128])
def test_dx_ref_matches_jax_vjp_with_repeated_slots(f, dtype):
    # 13 rows of 5 slots over 40 source rows: slots repeat
    x, slots, w = _inputs(f, 13, 5, 40, dtype, seed=2)
    assert len(np.unique(slots)) < slots.size
    g = np.random.default_rng(3).normal(size=(13, f)).astype(np.float32)
    want, _ = _jax_vjp(x, slots, w, g)
    tx, ts, tw = _torch(x, slots, w)
    got = gather_weighted_sum_dx_ref(tw, torch.from_numpy(g), ts, 40, tx.dtype)
    assert got.dtype == tx.dtype and got.shape == (40, f)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dx_ref_on_iota_slots_is_w_times_g_bitwise(dtype):
    # the grid path's layout: every source row cited once, so dx is 0 + w·g
    f, n_dst, d = 16, 7, 10
    x, _, w = _inputs(f, n_dst, d, n_dst * d, dtype, seed=4)
    slots = _iota(n_dst, d)
    g = np.random.default_rng(5).normal(size=(n_dst, f)).astype(np.float32)
    tx, ts, tw = _torch(x, slots, w)
    got = gather_weighted_sum_dx_ref(tw, torch.from_numpy(g), ts, n_dst * d, tx.dtype)
    prod = (tw[:, :, None] * torch.from_numpy(g)[:, None, :]).reshape(-1, f).to(tx.dtype)
    assert torch.equal(got, prod)
    want, _ = _jax_vjp(x, slots, w, g)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_backward_on_cpu_runs_the_plain_dx(impl):
    x, slots, w = _inputs(64, 13, 5, 40, "f32", seed=6)
    g = np.random.default_rng(7).normal(size=(13, 64)).astype(np.float32)
    tx, ts, tw = _torch(x, slots, w)
    tx.requires_grad_()
    tw.requires_grad_()
    before = ops.launch_counts()
    dx, dw = torch.autograd.grad(gather_weighted_sum(tx, ts, tw, impl), (tx, tw),
                                 torch.from_numpy(g))
    assert ops.launch_counts() == before
    assert torch.equal(dx, gather_weighted_sum_dx_ref(tw.detach(), torch.from_numpy(g), ts,
                                                      40, torch.float32))
    want_dx, want_dw = _jax_vjp(x, slots, w, g)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=TOL, atol=TOL)


def test_dx_cuda_impl_raises_on_cpu_tensors():
    x, slots, w = _torch(*_inputs(64, 4, 3, 9, "f32"))
    g = torch.zeros(4, 64)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        gather_weighted_sum_dx(w, g, slots, 9, torch.float32, "cuda")
    with pytest.raises(ValueError, match="impl"):
        gather_weighted_sum_dx(w, g, slots, 9, torch.float32, "pallas")
    assert ops.launch_counts() == before
    for impl in ("auto", "ref"):
        torch.testing.assert_close(gather_weighted_sum_dx(w, g, slots, 9, torch.float32, impl),
                                   torch.zeros(9, 64), rtol=0, atol=0)


def test_load_width():
    # 16-byte loads where the row width and the buffer allow, 8-byte bf16
    # loads, else scalar ones
    assert _vec(torch.zeros(5, 16)) == 4
    assert _vec(torch.zeros(5, 67)) == 1
    assert _vec(torch.zeros(5, 16, dtype=torch.bfloat16)) == 8
    assert _vec(torch.zeros(5, 12, dtype=torch.bfloat16)) == 4
    assert _vec(torch.zeros(5, 6, dtype=torch.bfloat16)) == 1
    shifted = torch.zeros(5 * 16 + 1)[1:].view(5, 16)  # 4 bytes past 16-byte alignment
    assert _vec(shifted) == 1


def test_build_variant_edits_a_copy_of_the_source(tmp_path, monkeypatch):
    # the tuning scripts' copies of a library: every match replaced in a
    # copy, the checked-in source untouched; a stand-in nvcc copies the
    # source to its output and fails on a marker
    from euler_tpu_torch.ops import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\n[ "$1" = --version ] && exit 0\n'
                    'for a; do [ "$p" = -o ] && o=$a; p=$a; done\n'
                    'grep -q BROKEN "$p" && exit 3\ncp "$p" "$o"; echo ptxas log\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    before = _build.source("gather_weighted_sum")
    bounds = r"__launch_bounds__\(kMaxWarpsPerBlock \* 32, kMinBlocksPerSm\)"
    lib, log = _build.build_variant(
        "gather_weighted_sum", "t", {r"constexpr int kBatch = \d+;": "constexpr int kBatch = 8;",
                                     bounds: "__launch_bounds__(kMaxWarpsPerBlock * 32)"})
    text = open(lib).read()
    assert log == "ptxas log\n" and lib == str(tmp_path / "build" / "gather_weighted_sum-t" /
                                              "libgather_weighted_sum.so")
    assert "constexpr int kBatch = 8;" in text and "kMinBlocksPerSm)" not in text
    assert text.count("__launch_bounds__(kMaxWarpsPerBlock * 32)") == before.count("kMinBlocksPerSm)")
    assert _build.source("gather_weighted_sum") == before
    with pytest.raises(RuntimeError, match="matches nothing"):
        _build.build_variant("gather_weighted_sum", "t", {"no such constant": ""})
    with pytest.raises(RuntimeError, match="nvcc exit 3"):
        _build.build_variant("gather_weighted_sum", "t", {r"constexpr int kBatch": "BROKEN"})
