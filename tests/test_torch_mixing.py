"""The mixing core (``ops/mixing.py``) against the JAX package on the CPU: the
port's plain versions against ``_mixing_core_xla`` and both Pallas kernels
in interpret mode (``bq = 21`` takes their padding path), at the configs'
point counts P = 32 (r50), P = 60 (vov99) and P = 120 (EVA02: 8 points x
15 frames), and the gradient of
``mixing_core`` against ``jax.grad``. Inputs are made from a seed with numpy
and fed to both packages.

Tolerances: fp32 within 1e-5 of the output scale (fp32 sums in another
order). bf16: within two bf16 ulps of each value plus 2^-8 of the output
scale — the products are fp32 in both packages, but a sum order that moves
an fp32 value across a bf16 rounding boundary flips the rounding of h1
(which feeds the second product) or of the output by one ulp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.ops import mixing_pallas as jmix

from sparsebev_tpu_torch.ops.mixing import (mixing_core, mixing_core_batched,
                                            mixing_core_plain)

torch.set_num_threads(1)

G, C, O = 4, 16, 32


def _inputs(rng, bq, p):
    x = rng.randn(bq, G, p, C).astype(np.float32)
    m = (rng.randn(bq, G, C, C) / np.sqrt(C)).astype(np.float32)
    s = (rng.randn(bq, G, O, p) / np.sqrt(p)).astype(np.float32)
    return x, m, s


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * 2 ** -8,
                                   atol=2 ** -8 * scale)


@pytest.mark.parametrize("p", [32, 60, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stats", ["twopass", "onepass"])
def test_mixing_plain_matches_jax(p, dtype, stats):
    rng = np.random.RandomState(p + len(dtype) + len(stats))
    arrays = _inputs(rng, 21, p)
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    if stats == "twopass":
        # at P = 120 a block of 4 queries (16 items, BQ padded to 24):
        # interpret mode unrolls the kernel's loops over a block's items
        blk = dict(bq_blk=4) if p > 64 else {}
        wants = [jmix.mixing_core_tpu(*jx, interpret=True, **blk),
                 jax.jit(jmix._mixing_core_xla)(*jx)]
        got = mixing_core(*tx)
    else:
        wants = [jmix.mixing_core_tpu_batched(*jx, interpret=True)]
        got = mixing_core_batched(*tx)
    assert got.dtype == getattr(torch, dtype) and got.shape == (21, G, O, C)
    assert torch.equal(got, mixing_core_plain(*tx, stats=stats))
    for want in wants:
        _close(got, want, dtype)


def test_mixing_two_statistics_agree():
    """The one-pass clamped variance equals the two-pass one to fp32
    rounding on well-scaled inputs."""
    rng = np.random.RandomState(3)
    tx = [torch.from_numpy(a) for a in _inputs(rng, 5, 32)]
    a = mixing_core_plain(*tx, stats="twopass")
    b = mixing_core_plain(*tx, stats="onepass")
    torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="unknown LN statistics"):
        mixing_core_plain(*tx, stats="welford")


def test_mixing_grad_matches_jax():
    """``mixing_core``'s backward (autograd of the plain two-pass version)
    against ``jax.grad`` of the JAX ``mixing_core`` (its custom VJP through
    ``_mixing_core_xla``), fp32, within 1e-5 of each gradient's scale."""
    rng = np.random.RandomState(4)
    arrays = _inputs(rng, 6, 32)
    cot = rng.randn(6, G, O, C).astype(np.float32)
    jg = jax.grad(lambda x, m, s: jnp.sum(jmix.mixing_core(x, m, s) * cot),
                  argnums=(0, 1, 2))(*[jnp.asarray(a) for a in arrays])
    tx = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = mixing_core(*tx)
    out.backward(torch.from_numpy(cot))
    for t, want in zip(tx, jg):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_mixing_wrappers_never_fall_back():
    x = torch.empty((3, G, 32, C), device="meta")
    m = torch.empty((3, G, C, C), device="meta")
    s = torch.empty((3, G, O, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mixing_core_batched(x, m, s)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mixing_core(x, m, s)
    assert mixing_core.launches == 0 and mixing_core_batched.launches == 0
