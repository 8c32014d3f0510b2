"""The tap-fold epilogue (``ops/msmv_epilogue.py``) against the JAX package on
the CPU: the port's plain version against the Pallas kernel in interpret
mode under ``jax.jit`` (``k = 600``, three levels, fp32 and bf16 windows),
and against the sampling op on windows gathered from y-fold tables.

Tolerance against JAX: under ``jax.jit`` XLA's CPU compiler contracts the
fold's multiply-adds into fused multiply-adds: each window's x taps become
``fma(g0, wxa, g1 * wxb)``, the first two levels ``fma(t0, wy0, t1 * wy1)``
and each later level ``fma(t, wy, acc)``. The written order, kept by the
port and (with ``--fmad=false``) by its kernel, rounds every product; so
fp32 agrees to a few fp32 ulps (1e-6 of the output scale), and a bf16 output
to one bf16 ulp. Where nothing is left to contract (one level, one x tap per
window) the two agree bit for bit.
Inputs are made from a seed with numpy and fed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.ops.msmv_epilogue_pallas import tap_fold_epilogue as j_fold

from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.ops.msmv_epilogue import (tap_fold_epilogue,
                                                   tap_fold_epilogue_plain)

torch.set_num_threads(1)

K, L, C = 600, 3, 16


def _both(gs, ws, win, out):
    want = jax.jit(lambda g, w: j_fold(g, w, C, out, k_blk=128,
                                       interpret=True))(
        [jnp.asarray(g, win) for g in gs], [jnp.asarray(w) for w in ws])
    got = tap_fold_epilogue(
        [torch.from_numpy(g).to(getattr(torch, win)) for g in gs],
        [torch.from_numpy(w) for w in ws], C, getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == (K, C)
    return got.float().numpy(), np.asarray(want).astype(np.float32)


@pytest.mark.parametrize("win", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_tap_fold_matches_pallas_kernel(win, out):
    rng = np.random.RandomState(len(win) + 3 * len(out))
    gs = [rng.randn(K, 2, 2 * C).astype(np.float32) for _ in range(L)]
    ws = [rng.rand(K, 4).astype(np.float32) for _ in range(L)]
    got, want = _both(gs, ws, win, out)
    scale = float(np.abs(want).max())
    if out == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
    # one level with one x tap per window leaves nothing to contract: bit
    # for bit
    ws[0][:, 1] = 0.0
    got, want = _both(gs[:1], ws[:1], win, out)
    np.testing.assert_array_equal(got, want)


def test_tap_fold_equals_sampling_on_gathered_windows():
    """Windows gathered from y-fold tables at the sampling op's points,
    with ``_separable_slot_weights``, fold to the sampling op's output
    (fp32 tables; the op rounds nothing there)."""
    rng = np.random.RandomState(5)
    n, q, s, p = 6, 9, 2, 3
    levels = [(8, 12), (4, 6), (2, 3)]
    feats = [torch.from_numpy(rng.randn(s, n, h, w, C).astype(np.float32))
             for h, w in levels]
    packed = tms.pack_mlvl_feats(feats)
    loc = torch.from_numpy(np.stack([
        rng.uniform(-0.15, 1.15, (q, s, p)), rng.uniform(-0.15, 1.15, (q, s, p)),
        rng.randint(0, n, (q, s, p)) / (n - 1)], -1).astype(np.float32))
    sw = torch.from_numpy(rng.rand(q, s, p, len(levels)).astype(np.float32))
    k = q * s * p
    x, y = loc[..., 0].reshape(k), loc[..., 1].reshape(k)
    view = tms._view_index(loc[..., 2].reshape(k), n)
    slices = torch.arange(s).repeat_interleave(p).repeat(q)
    gathered, weights = [], []
    for lvl, (h, w) in enumerate(levels):
        sx, ry, (wxa, wxb), (wya, wyb) = tms._separable_slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        lw = sw[..., lvl].reshape(k)
        flat = packed.tables[lvl].reshape(-1, 2 * C)
        col = packed.row_index(slices, view, ry, h) * (w + 1) + sx
        gathered.append(torch.stack([flat[col], flat[col + 1]], 1))
        weights.append(torch.stack([wxa, wxb, wya * lw, wyb * lw], 1))
    got = tap_fold_epilogue(gathered, weights, C, torch.float32)
    want = tms.msmv_sampling(packed, loc, sw).reshape(k, C)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_tap_fold_wrapper_never_falls_back():
    g = [torch.empty((4, 2, 2 * C), device="meta")]
    w = [torch.empty((4, 4), device="meta")]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tap_fold_epilogue(g, w, C, torch.float32)
    assert tap_fold_epilogue.launches == 0
    with pytest.raises(ValueError, match="one weight array per level"):
        tap_fold_epilogue_plain([torch.zeros((4, 2, 2 * C))], [], C,
                                torch.float32)
