"""The port's EVA02 backbone (``sparsebev_tpu_torch/models/eva02.py``) and
its attention op (``ops/eva_attention.py``, the plain version on the CPU)
against the JAX package's ``sparsebev_tpu/models/eva02.py``, unit by unit,
on seeded inputs.

The small EVA02: embed 64, 4 heads of 16, depth 3 (block 0 windowed over a
3x5 token grid padded to 4x6 by 2x2 windows, block 1 global, block 2 global
with the residual block), ``real_img_size`` 48x80, pretrain grid 2x2 (plus
the cls token) resized to 3x5, the pyramid at all four scales with the top
block, 32 channels. The JAX parameters get seeded noise and cross into the
port through ``state_dict_from_jax``. fp32 outputs agree within 1e-5 of
each output's scale (the two frameworks sum products and reductions in
other orders). Under a bf16 compute dtype both trunks run in fp32 after the
patch embed (flax promotes a bf16 input against fp32 parameters); the
pyramid's bf16 convolutions round where JAX rounds, so it agrees within
2^-8 of its scale (one bf16 ulp)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.models import eva02 as jeva
from sparsebev_tpu.train import optim as joptim
from sparsebev_tpu.utils.checkpoint_io import port_torch_params

from sparsebev_tpu_torch.models import eva02 as teva
from sparsebev_tpu_torch.models import layers as tlayers
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.ops import eva_attention as tatt
from sparsebev_tpu_torch.train import optim as toptim
from sparsebev_tpu_torch.utils.checkpoint_io import load_pretrained
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)

IMG_HW = (48, 80)
KW = dict(img_size=64, real_img_size=IMG_HW, patch_size=16, embed_dim=64,
          depth=3, num_heads=4, window_size=2, window_block_indexes=(0,),
          residual_block_indexes=(2,), fpn_out_channels=32,
          fpn_scale_factors=(4.0, 2.0, 1.0, 0.5), fpn_top_block=True,
          pretrain_img_size=32)
FP32_TOL = 1e-5         # of each output's max abs
BF16_TOL = 2.0 ** -8


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _noise(tree, rng):
    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x)
        if name == "kernel":
            return (rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]))
                    ).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return (x + 0.1 * rng.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _image(rng, b=2):
    return rng.randn(b, *IMG_HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The JAX EVA02's noised params and the port module carrying them."""
    rng = np.random.RandomState(0)
    x = _image(rng)
    jm = jeva.EVA02(**KW)
    params = _noise(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                    rng)
    tm = teva.EVA02(**KW)
    sd = state_dict_from_jax({"backbone": params}, {})
    prefix = "img_backbone."
    tm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                       strict=True)
    return params, tm.eval()


# -------------------------------------------------------------- helpers --

@pytest.mark.parametrize("args", [
    (16, 16, 8, None), (16, 16, 4, (6, 10)), (16, 16, 2, None),
    (16, 16, 4, (3, 5)), (64, 16, 16, None), (64, 16, 96, (40, 100))])
def test_rope_tables_bit_equal(args):
    hd, pt, ft, real = args
    for got, want in zip(teva.build_rope_tables(hd, pt, ft,
                                                real_img_size=real),
                         jeva.build_rope_tables(hd, pt, ft,
                                                real_img_size=real)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(14, 40), (14, 100), (2, 3), (96, 40),
                                     (5, 5)])
def test_bicubic_matrix_and_resize_bit_equal(src, dst):
    assert np.array_equal(teva._bicubic_matrix(src, dst),
                          jeva._bicubic_matrix(src, dst))
    x = np.random.RandomState(src).randn(src, 7, 3).astype(np.float32)
    assert np.array_equal(teva._bicubic_resize(x, (dst, 4)),
                          jeva._bicubic_resize(x, (dst, 4)))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(table_dtype):
    rng = np.random.RandomState(1)
    cos, sin = jeva.build_rope_tables(16, 16, 4)
    t = rng.randn(3, 16, 4, 16).astype(np.float32)
    jdt = getattr(jnp, table_dtype)
    tdt = getattr(torch, table_dtype)
    want = jeva.apply_rope(jnp.asarray(t), jnp.asarray(cos).astype(jdt),
                           jnp.asarray(sin).astype(jdt))
    got = teva.apply_rope(torch.from_numpy(t),
                          torch.from_numpy(cos).to(tdt),
                          torch.from_numpy(sin).to(tdt))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        teva._rotate_half(torch.tensor([[1.0, 2.0, 3.0, 4.0]])).numpy(),
        [[-2.0, 1.0, -4.0, 3.0]])


@pytest.mark.parametrize("hw,ws", [((10, 14), 4), ((8, 8), 4), ((3, 5), 2),
                                   ((40, 100), 16)])
def test_window_partition_matches_jax(hw, ws):
    rng = np.random.RandomState(2)
    x = rng.randn(2, *hw, 8).astype(np.float32)
    jw, jpad = jeva.window_partition(jnp.asarray(x), ws)
    tw, tpad = teva.window_partition(torch.from_numpy(x), ws)
    assert tuple(tpad) == tuple(jpad)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = teva.window_unpartition(tw, ws, tpad, hw)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jeva.window_unpartition(jw, ws, jpad, hw)))
    if hw == (40, 100):
        assert tw.shape[0] == 2 * 21       # 48x112: 3 x 7 windows a view


# ------------------------------------------------------------ attention --

def _qkv(rng, b, n, h, hd, scale=1.0):
    return [(rng.randn(b, n, h, hd) * scale).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("shape", [(3, 16, 4, 16), (2, 37, 2, 64),
                                   (1, 256, 2, 64)])
def test_attention_plain_matches_jax(shape):
    q, k, v = _qkv(np.random.RandomState(3), *shape, scale=2.0)
    want = jax.nn.dot_product_attention(*map(jnp.asarray, (q, k, v)))
    got = tatt.eva_attention(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), want, FP32_TOL, "attention")


@pytest.mark.parametrize("n", [700, 2100])
def test_attention_plain_matches_jax_chunked(n):
    """Above 512 tokens against ``_chunked_attention``; at 2100 the port's
    plain version takes its query chunks too (above 2048)."""
    q, k, v = _qkv(np.random.RandomState(4), 1, n, 2, 16)
    want = jeva._chunked_attention(*map(jnp.asarray, (q, k, v)))
    got = tatt.eva_attention_plain(*map(torch.from_numpy, (q, k, v)))
    _close(got.numpy(), want, FP32_TOL, "chunked attention")
    if n > tatt.CHUNK_ABOVE:
        one = tatt._attention_core(*map(torch.from_numpy, (q, k, v)))
        _close(got.numpy(), one.numpy(), FP32_TOL, "chunks vs one call")


def test_attention_plain_bf16_matches_jax():
    q, k, v = _qkv(np.random.RandomState(5), 2, 24, 2, 16)
    want = jax.nn.dot_product_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    got = tatt.eva_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           2.0 ** -7, "bf16 attention")


def test_attention_cuda_branch_refuses_other_devices():
    q = torch.zeros(1, 4, 16, 64)
    with pytest.raises(ValueError, match="no kernel for device"):
        tatt._eva_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="shape"):
        tatt.eva_attention_plain(q, q[:, :2], q)


@pytest.mark.parametrize("n,chunked", [(256, False), (600, True),
                                       (2100, True)])
def test_attention_backward_plain_matches_jax_vjp(n, chunked):
    """dq, dk, dv of the plain backward, from the plain forward's output and
    log-sum-exp, against ``jax.vjp`` of ``jax.nn.dot_product_attention``
    (N = 256, a window's tokens) and of ``_chunked_attention`` (N = 600:
    two query chunks in JAX; 2100: the port's plain versions chunk too),
    fp32, within FP32_TOL of each gradient's scale."""
    rng = np.random.RandomState(n)
    q, k, v = _qkv(rng, 1, n, 2, 64, scale=2.0)
    g = rng.randn(*q.shape).astype(np.float32)
    fn = jeva._chunked_attention if chunked else jax.nn.dot_product_attention
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out = tatt.eva_attention_plain(tq, tk, tv)
    lse = tatt.eva_attention_lse_plain(tq, tk)
    assert lse.shape == (1, 2, n) and lse.dtype == torch.float32
    got = tatt.eva_attention_backward_plain(tq, tk, tv, out, lse, tg)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b, FP32_TOL, f"{name} N={n}")


def test_attention_function_on_cpu_equals_autograd_of_plain():
    """``EvaAttentionFunction`` (the kernels' autograd route) on CPU
    tensors: its forward is the plain forward, bit for bit, and its
    backward (the explicit formula from the log-sum-exp) agrees with
    autograd of the plain forward within FP32_TOL of each gradient's
    scale; ``eva_attention`` on the CPU stays the plain forward."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(rng, 2, 37, 2, 64, scale=2.0))
    g = torch.from_numpy(rng.randn(2, 37, 2, 64).astype(np.float32))
    out = tatt.EvaAttentionFunction.apply(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = tatt.eva_attention(q, k, v)
    assert torch.equal(out, ref)
    assert type(ref.grad_fn).__name__ != "EvaAttentionFunctionBackward"
    want = torch.autograd.grad(ref, (q, k, v), g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), b.numpy(), FP32_TOL, name)


def test_attention_backward_cuda_branch_refuses_other_devices():
    q = torch.zeros(1, 4, 16, 64)
    lse = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="no kernel for device"):
        tatt._eva_attention_backward_cuda(q, q, q, q, lse, q)


# -------------------------------------------------------------- modules --

def _tokens(rng, b, h, w, c=64):
    return rng.randn(b, h, w, c).astype(np.float32)


def _tables(kind):
    if kind == "win":
        return jeva.build_rope_tables(16, 16, 2)
    return jeva.build_rope_tables(16, 16, 4, real_img_size=(3, 5))


def test_swiglu_matches_jax(pair):
    params, tm = pair
    x = _tokens(np.random.RandomState(6), 2, 3, 5)
    p = params["vit"]["block1"]["mlp"]
    want = jeva.SwiGLU(int(64 * 4 * 2 / 3), 64).apply({"params": p},
                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tm.net.blocks[1].mlp(torch.from_numpy(x))
    assert tm.net.blocks[1].mlp.w1.out_features == 170
    _close(got.numpy(), want, FP32_TOL, "SwiGLU")


@pytest.mark.parametrize("kind", ["win", "glb"])
def test_eva_attention_matches_jax(pair, kind):
    params, tm = pair
    rng = np.random.RandomState(7)
    blk = 0 if kind == "win" else 1
    x = _tokens(rng, 4 if kind == "win" else 2, *((2, 2) if kind == "win"
                                                   else (3, 5)))
    cos, sin = _tables(kind)
    want = jeva.EvaAttention(64, 4).apply(
        {"params": params["vit"][f"block{blk}"]["attn"]}, jnp.asarray(x),
        jnp.asarray(cos), jnp.asarray(sin))
    with torch.no_grad():
        got = tm.net.blocks[blk].attn(torch.from_numpy(x),
                                      torch.from_numpy(cos),
                                      torch.from_numpy(sin))
    _close(got.numpy(), want, FP32_TOL, "EvaAttention")


@pytest.mark.parametrize("blk", [0, 1, 2])
def test_eva_block_matches_jax(pair, blk):
    """Block 0 windowed (a padded grid), 1 global, 2 global with the
    residual block."""
    params, tm = pair
    x = _tokens(np.random.RandomState(8), 2, 3, 5)
    cos, sin = _tables("win" if blk == 0 else "glb")
    jb = jeva.EvaBlock(64, 4, 4 * 2 / 3, window_size=2 if blk == 0 else 0,
                       use_residual_block=blk == 2)
    want = jb.apply({"params": params["vit"][f"block{blk}"]},
                    jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    with torch.no_grad():
        got = tm.net.blocks[blk](torch.from_numpy(x), torch.from_numpy(cos),
                                 torch.from_numpy(sin))
    _close(got.numpy(), want, FP32_TOL, f"EvaBlock {blk}")


def test_res_bottleneck_block_matches_jax(pair):
    params, tm = pair
    x = _tokens(np.random.RandomState(9), 2, 3, 5)
    p = params["vit"]["block2"]["residual"]
    want = jeva.ResBottleneckBlock(64).apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.net.blocks[2].residual(torch.from_numpy(x))
    _close(got.numpy(), want, FP32_TOL, "ResBottleneckBlock")
    # the reference zero-initialises its last norm: the block starts as the
    # identity
    fresh = teva.ResBottleneckBlock(8)
    y = torch.randn(1, 2, 2, 8)
    assert torch.equal(fresh(y), y)


def _jax_vit(dtype=None):
    keys = ("img_size", "real_img_size", "patch_size", "embed_dim", "depth",
            "num_heads", "window_size", "window_block_indexes",
            "residual_block_indexes", "pretrain_img_size")
    return jeva.ViT(dtype=dtype, **{k: KW[k] for k in keys})


def test_vit_matches_jax(pair):
    params, tm = pair
    x = _image(np.random.RandomState(10))
    want = _jax_vit().apply({"params": params["vit"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.net(torch.from_numpy(x))
    _close(got.numpy(), want, FP32_TOL, "ViT")
    # the pretrain grid (2x2) resized to the 3x5 tokens, torch-bicubic
    jpos = _jax_vit().apply({"params": params["vit"]}, 3, 5,
                            method=jeva.ViT._abs_pos)
    with torch.no_grad():
        _close(tm.net._abs_pos(3, 5).numpy(), jpos, FP32_TOL, "abs pos")


# ------------------------------------------------ drop path and the remat --

def _vit_kw():
    keys = ("img_size", "real_img_size", "patch_size", "embed_dim", "depth",
            "num_heads", "window_size", "window_block_indexes",
            "residual_block_indexes", "pretrain_img_size")
    return {k: KW[k] for k in keys}


def test_drop_path_rates_by_block_match_jax(pair):
    """Each block's two sites take JAX's ``np.linspace(0, rate, depth)``
    entry (block 0: 0)."""
    params, _ = pair
    bound = jeva.ViT(drop_path_rate=0.3, **_vit_kw()).bind(
        {"params": params["vit"]})
    want = [blk.drop_path_rate for blk in bound.blocks]
    vit = teva.ViT(drop_path_rate=0.3, **_vit_kw())
    for blk, rate in zip(vit.blocks, want):
        assert blk.drop_path_attn.rate == blk.drop_path_mlp.rate == rate
    assert want[0] == 0.0 and want[-1] == 0.3


def test_drop_path_one_mask_per_image_and_identity_when_deterministic():
    """One Bernoulli draw an image: each image is 0 or ``x / keep`` (JAX's
    ``x * mask / keep``) whole; the identity, with no draw, when
    deterministic or at rate 0."""
    x = torch.randn(64, 3, 5, 8, generator=torch.Generator().manual_seed(0))
    dp = tlayers.DropPath(0.25)
    dp.generator = torch.Generator().manual_seed(1)
    before = dp.generator.get_state()
    assert dp(x) is x and dp(x, deterministic=True) is x
    assert torch.equal(dp.generator.get_state(), before)
    y = dp(x, deterministic=False)
    kept = (y != 0).flatten(1).any(1)
    assert 0 < int(kept.sum()) < 64
    mask = kept.float().reshape(64, 1, 1, 1)
    assert torch.equal(y, x * mask / 0.75)
    zero_rate = tlayers.DropPath(0.0)
    zero_rate.generator = dp.generator
    state = dp.generator.get_state()
    assert zero_rate(x, deterministic=False) is x
    assert torch.equal(dp.generator.get_state(), state)
    # the injected masks replace the draw
    dp.draws = lambda blk, site, n: torch.arange(n) % 2 == 0
    y = dp(x, deterministic=False)
    assert torch.equal(y[1::2], torch.zeros_like(y[1::2]))
    assert torch.equal(y[0::2], x[0::2] / 0.75)


def test_block_remat_replays_drop_path_masks(pair):
    """The trunk with the block remat (``use_act_checkpoint``) and without,
    same weights, same generator seed, drop path on: the outputs, the
    input's and every parameter's gradient are bit-equal (the recompute
    replays each block's masks from the generator's state at its first
    run), the generator ends in the same state, and the masks did drop."""
    params, _ = pair
    sd = state_dict_from_jax({"backbone": params}, {})
    prefix = "img_backbone.net."
    weights = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
    x = torch.from_numpy(_image(np.random.RandomState(12)))
    g = torch.randn(2, 3, 5, 64, generator=torch.Generator().manual_seed(2))
    runs = []
    for remat in (True, False):
        vit = teva.ViT(drop_path_rate=0.9, use_act_checkpoint=remat,
                       **_vit_kw())
        vit.load_state_dict(weights, strict=True)
        gen = torch.Generator().manual_seed(5)
        tlayers.set_dropout_generator(vit, gen)
        xi = x.clone().requires_grad_()
        out = vit(xi, deterministic=False)
        out.backward(g)
        runs.append((out.detach(), xi.grad,
                     {k: p.grad for k, p in vit.named_parameters()},
                     gen.get_state()))
    (o1, x1, p1, s1), (o2, x2, p2, s2) = runs
    assert torch.equal(o1, o2) and torch.equal(x1, x2)
    assert torch.equal(s1, s2)
    for k in p2:
        assert torch.equal(p1[k], p2[k]), k
    with torch.no_grad():
        det = vit(x, deterministic=True)
    assert not torch.equal(det, o2)


def test_simple_feature_pyramid_matches_jax(pair):
    params, tm = pair
    feat = _tokens(np.random.RandomState(11), 2, 3, 5)
    want = jeva.SimpleFeaturePyramid(32, (4.0, 2.0, 1.0, 0.5), True).apply(
        {"params": params["sfp"]}, jnp.asarray(feat))
    with torch.no_grad():
        got = teva.SimpleFeaturePyramid.forward(tm, torch.from_numpy(feat))
    assert [tuple(g.shape) for g in got] == [
        (2, 12, 20, 32), (2, 6, 10, 32), (2, 3, 5, 32), (2, 1, 2, 32),
        (2, 1, 1, 32)]
    assert tm.stage_names == ["simfp_2", "simfp_3", "simfp_4", "simfp_5"]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, FP32_TOL, f"pyramid level {i}")


def test_eva02_matches_jax(pair):
    params, tm = pair
    x = _image(np.random.RandomState(12))
    want = jeva.EVA02(**KW).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32
        _close(g.permute(0, 2, 3, 1).numpy(), w, FP32_TOL, f"level {i}")


def test_bf16_dtype_flow_matches_jax(pair):
    """Under a bf16 compute dtype: the patch embed and the position add in
    bf16, every block output fp32 on both sides (block 0 multiplies by
    bf16-rounded RoPE tables), the pyramid fp32 within one bf16 ulp."""
    params, _ = pair
    x = _image(np.random.RandomState(13))
    jm = jeva.EVA02(dtype=jnp.bfloat16, **KW)
    want, inter = jm.apply({"params": params},
                           jnp.asarray(x).astype(jnp.bfloat16),
                           capture_intermediates=True)
    vit = inter["intermediates"]["vit"]
    jdt = {name: vit[name]["__call__"][0].dtype
           for name in ("patch_embed", "block0", "block1", "block2")}
    assert jdt == {"patch_embed": jnp.bfloat16, "block0": jnp.float32,
                   "block1": jnp.float32, "block2": jnp.float32}

    tm = teva.EVA02(dtype=torch.bfloat16, **KW)
    sd = state_dict_from_jax({"backbone": params}, {})
    tm.load_state_dict({k[len("img_backbone."):]: v for k, v in sd.items()})
    seen = {}
    hooks = [tm.net.patch_embed.register_forward_hook(
        lambda m, a, out: seen.__setitem__("patch_embed", out))]
    for i, blk in enumerate(tm.net.blocks):
        hooks.append(blk.register_forward_hook(
            lambda m, a, out, i=i: seen.__setitem__(f"block{i}", out)))
        hooks.append(blk.register_forward_pre_hook(
            lambda m, a, i=i: seen.__setitem__(f"cos{i}", a[1])))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    assert seen["patch_embed"].dtype == torch.bfloat16
    assert [seen[f"block{i}"].dtype for i in range(3)] == [torch.float32] * 3
    assert seen["cos0"].dtype == torch.bfloat16
    assert seen["cos1"].dtype == seen["cos2"].dtype == torch.float32
    for name in ("patch_embed", "block0", "block2"):
        _close(seen[name].float().numpy(),
               np.asarray(vit[name]["__call__"][0].astype(jnp.float32)),
               BF16_TOL, f"bf16 {name}")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g.permute(0, 2, 3, 1).numpy(), w, BF16_TOL,
               f"bf16 level {i}")


# ------------------------------------------------- weights and detector --

def _detector_cfg(compute_dtype="float32", residual=(2,)):
    bb = dict(KW, type="EVA02", residual_block_indexes=residual)
    return {"model": dict(
        type="SparseBEV", compute_dtype=compute_dtype,
        img_backbone=bb, img_neck=None,
        pts_bbox_head=dict(type="SparseBEVHead", num_classes=10,
                           in_channels=32, num_query=16, num_frames=2,
                           num_points=2, num_layers=2, num_levels=5,
                           code_size=10,
                           pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]))}


def test_load_pretrained_matches_port_torch_params():
    """A synthetic checkpoint with the reference's detectron2 keys
    (``backbone.net.*``, ``backbone.simfp_*``, and a key the model lacks)
    loads into the port as JAX's ``port_torch_params(backbone_type=
    "EVA02")`` ports it."""
    model = build_detector(_detector_cfg(residual=()), device="cpu")
    gen = torch.Generator().manual_seed(0)
    ckpt = {"backbone." + k[len("img_backbone."):]:
            torch.randn(v.shape, generator=gen)
            for k, v in model.state_dict().items()
            if k.startswith("img_backbone.")}
    ckpt["backbone.net.blocks.0.attn.rope.freqs_cos"] = torch.zeros(4, 16)
    out = load_pretrained(model, ckpt)
    assert out["unexpected"] == ["img_backbone.net.blocks.0.attn.rope"
                                 ".freqs_cos"]
    assert not [k for k in out["missing"] if k.startswith("img_backbone.")]
    ported = port_torch_params({k: v.numpy() for k, v in ckpt.items()},
                               backbone_type="EVA02")
    want = state_dict_from_jax({"backbone": ported["params"]["backbone"]},
                               {})
    own = model.state_dict()
    assert len(want) == len(ckpt) - 1
    for k, v in want.items():
        assert torch.equal(own[k], v), k


def test_train_true_runs_and_draws_drop_path():
    """``train=True`` on an EVA02 detector runs (on the CPU, through the
    plain versions): with ``stop_prev_grad=1`` the gradient pass (6 images)
    draws each drop-path site of blocks 1.. first, the detached pass (6
    more) after it, block 0 (rate 0) never; the outputs are finite and the
    gradient reaches block 0, frozen or not."""
    cfg = _detector_cfg(residual=())
    cfg["model"]["img_backbone"].update(drop_path_rate=0.3,
                                         use_act_checkpoint=True)
    cfg["model"]["stop_prev_grad"] = 1
    model = build_detector(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(3)
    calls = []

    def draws(blk, site, n):
        calls.append((blk, site, n))
        return torch.rand(n, generator=gen) < 0.7

    tlayers.set_drop_path_draws(model, draws)
    img = torch.rand(1, 12, *IMG_HW, 3, generator=gen) * 255
    l2i = torch.eye(4).expand(1, 12, 4, 4)
    td = torch.tensor([[0.0, 0.5]])
    preds = model(img, l2i, td, train=True)
    sites = [(blk, s) for blk in (1, 2) for s in (0, 1)]
    assert calls == [(b, s, 6) for b, s in sites] * 2
    out = preds["all_bbox_preds"]
    assert bool(torch.isfinite(out).all())
    out.sum().backward()
    grad = model.img_backbone.net.blocks[0].attn.q_proj.weight.grad
    assert grad is not None and float(grad.abs().max()) > 0
    # the recompute of the checkpointed blocks drew their masks again
    assert len(calls) == 8 + 4


def test_bf16_detector_casts_the_pyramid():
    """The EVA02 pyramid is fp32; the detector casts every level to the
    compute dtype, as the JAX detector does."""
    model = build_detector(_detector_cfg("bfloat16"), device="cpu", seed=0)
    assert model.img_backbone.dtype == torch.bfloat16
    with torch.no_grad():
        feats = model.extract_img_feat(
            torch.randn(2, *IMG_HW, 3, generator=torch.Generator()
                        .manual_seed(0)))
    assert [f.dtype for f in feats] == [torch.bfloat16] * 5
    assert all(f.is_contiguous() for f in feats)


@pytest.mark.parametrize("frozen_blocks", [-1, 0, 2, 3])
def test_frozen_parameters_match_jax(pair, frozen_blocks):
    """The parameters the port's optimizer gives lr 0 for an EVA02 backbone
    with ``frozen_blocks`` are those JAX's multiplier tree sets to 0, carried
    to the port's keys by ``state_dict_from_jax`` (the patch embed, the
    position embedding and blocks 0..k-1; nothing at -1)."""
    params, _ = pair
    cfg = dict(type="EVA02", frozen_blocks=frozen_blocks)
    mults = joptim.build_lr_mult_tree(
        {"backbone": params},
        frozen_patterns=joptim.backbone_frozen_patterns(cfg,
                                                        prefix="backbone"))
    leaves = jax.tree_util.tree_map(
        lambda m, x: np.full(np.shape(x), m, np.float32), mults,
        {"backbone": params})
    want = {k for k, v in state_dict_from_jax(leaves, {}).items()
            if not bool(v.any())}

    holder = torch.nn.Module()
    holder.img_backbone = teva.EVA02(**KW)
    optimizer, _ = toptim.build_optimizer(
        holder, frozen_patterns=toptim.backbone_frozen_patterns(cfg))
    names = {id(p): n for n, p in holder.named_parameters()}
    got = {names[id(p)] for group in optimizer.param_groups
           if group["lr_mult"] == 0.0 for p in group["params"]}
    assert got == want
    blocks = {int(k.split(".")[3]) for k in got if ".blocks." in k}
    assert blocks == set(range(max(frozen_blocks, 0)))
    assert ("img_backbone.net.pos_embed" in got) == (frozen_blocks >= 0)
