"""Chunk-split streaming rings (``table_split``) in the port against the
JAX package on the CPU: the ring itself (``ring_init`` / ``ring_update`` /
``ring_copy_slot``: every chunk equal to JAX's), the sampling forward over a
split ring (``_yfold_forward``'s chunk partition) over a full slot
permutation, in fp32 (against JAX op by op: exact) and bf16 (against jitted
JAX: bit for bit), with e4m3 levels, and bit for bit against the unsplit
ring; ``ring_table_splits``; the options' ``ValueError``s; and the
``StreamingDetector``'s slot lists and outputs against JAX's over a stream
with repeated keyframes, evictions and a second sequence, split and
unsplit."""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsebev_tpu.inference import StreamingDetector as JaxStreaming
from sparsebev_tpu.inference import ring_table_splits as jax_ring_splits
from sparsebev_tpu.models.detector import SparseBEV as JaxSparseBEV

from sparsebev_tpu_torch.inference import StreamingDetector, ring_table_splits
from sparsebev_tpu_torch.models.detector import build_detector
from sparsebev_tpu_torch.models.head import SparseBEVHead, check_table_options
from sparsebev_tpu_torch.ops import msmv_sampling as tms
from sparsebev_tpu_torch.utils.convert import state_dict_from_jax

from test_torch_streaming import MODEL as R50_MODEL
from test_torch_streaming import make_cameras, noise_tree

jms = importlib.import_module("sparsebev_tpu.ops.msmv_sampling")

torch.set_num_threads(1)

N, C, G = 6, 16, 2
E4M3 = torch.float8_e4m3fn
LEVELS = [(6, 10), (3, 5)]


def _frame_j(feats, i, dtype):
    return jms.pack_mlvl_feats_grouped(
        [jnp.asarray(f[:, i * N:(i + 1) * N], dtype) for f in feats], N, G)


def _frame_t(feats, i, dtype):
    return tms.pack_mlvl_feats_grouped(
        [torch.from_numpy(f[:, i * N:(i + 1) * N]).to(getattr(torch, dtype))
         for f in feats], N, G)


def _np_bits(a):
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return a.view(np.uint8)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _t_bits(t):
    if t.dtype == E4M3:
        return t.view(torch.uint8).numpy()
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).numpy()


def _chunks(level):
    return level if isinstance(level, tuple) else (level,)


CASES = {
    "split_2_1": dict(slots=4, split=(2, 1), fp8=(False, False)),
    "split_4_2": dict(slots=4, split=(4, 2), fp8=(False, False)),
    # e4m3 levels sit beside bf16 ones (the sampling kernel's rule)
    "split_2_2_e4m3_l0": dict(slots=4, split=(2, 2), fp8=(True, False)),
    "split_1_4_e4m3_l1": dict(slots=4, split=(1, 4), fp8=(False, True)),
}
PAIRS = [(case, dtype) for case in sorted(CASES)
         for dtype in ("float32", "bfloat16")
         if dtype == "bfloat16" or not any(CASES[case]["fp8"])]


def _split_rings(case, dtype, rng, feats=None):
    spec = CASES[case]
    t = spec["slots"]
    if feats is None:
        feats = [(rng.randn(1, t * N, h, w, C) * 4).astype(np.float32)
                 for h, w in LEVELS]
    jdt = tuple(jnp.float8_e4m3fn if f else jnp.dtype(dtype)
                for f in spec["fp8"])
    tdt = tuple(E4M3 if f else getattr(torch, dtype) for f in spec["fp8"])
    jf0, tf0 = _frame_j(feats, 0, dtype), _frame_t(feats, 0, dtype)
    jring = jms.ring_init(jf0, t, jdt, spec["split"])
    tring = tms.ring_init(tf0, t, tdt, spec["split"])
    plain = tms.ring_init(tf0, t, tdt)
    # frames land out of order, then slot 3 is overwritten by slot 1's
    for slot, i in zip((2, 0, 3, 1), range(t)):
        jring = jms.ring_update(jring, _frame_j(feats, i, dtype),
                                jnp.int32(slot))
        tms.ring_update(tring, _frame_t(feats, i, dtype), slot)
        tms.ring_update(plain, _frame_t(feats, i, dtype), slot)
    jring = jms.ring_copy_slot(jring, jf0, jnp.int32(1), jnp.int32(3))
    tms.ring_copy_slot(tring, tf0.meta(), 1, 3)
    tms.ring_copy_slot(plain, tf0.meta(), 1, 3)
    return jring, tring, plain, jf0, tf0


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_split_ring_writes_match_jax(case, dtype):
    """Every chunk of every level bit for bit against JAX's, after
    out-of-order writes and a slot copy; the split level is separate
    tensors of ``slots / split`` slots each, and the unsplit ring's rows
    are the chunks' rows in order."""
    jring, tring, plain, _, _ = _split_rings(case, dtype,
                                             np.random.RandomState(0))
    for lvl, sp in enumerate(CASES[case]["split"]):
        jc, tc = _chunks(jring[lvl]), _chunks(tring[lvl])
        assert len(tc) == len(jc) == sp
        assert len({c.data_ptr() for c in tc}) == sp
        for a, b in zip(tc, jc):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_array_equal(_t_bits(a), _np_bits(b))
        np.testing.assert_array_equal(_t_bits(torch.cat(tc)),
                                      _t_bits(plain[lvl]))


@pytest.mark.parametrize("case,dtype", PAIRS)
def test_split_sampling_matches_jax(case, dtype):
    """The plain forward over a split ring viewed through a full slot
    permutation: against JAX's chunk-partitioned ``_yfold_forward``, bit
    for bit (fp32 tables: op by op, where XLA contracts nothing; bf16 and
    e4m3 tables: jitted, as the JAX package runs; with an e4m3 level 0 the
    output is fp32 and jitted XLA contracts its fold into FMAs, so that
    case runs on inputs where every product and sum is exact, as
    ``test_torch_fp8_ring.py``'s dyadic inputs), and against the unsplit
    ring, bit for bit."""
    rng = np.random.RandomState(1)
    slots_of_t = [3, 1, 0, 2]
    q, s, p = 7, len(slots_of_t) * G, 3
    feats = None
    if CASES[case]["fp8"][0]:
        # W - 1, H - 1 powers of two, features k / 2, points on a 1/64
        # grid, level weights on a 1/4 grid
        levels = [(5, 9), (3, 5)]
        feats = [(rng.randint(-8, 9, (1, 4 * N, h, w, C)) / 2).astype(
            np.float32) for h, w in levels]
        loc = np.stack([rng.randint(-8, 73, (q, s, p)) / 64,
                        rng.randint(-8, 73, (q, s, p)) / 64,
                        rng.randint(0, N, (q, s, p)) / (N - 1)], -1)
        sw = rng.randint(0, 5, (q, s, p, len(levels))) / 4
    else:
        loc = np.stack([rng.uniform(-0.15, 1.15, (q, s, p)),
                        rng.uniform(-0.15, 1.15, (q, s, p)),
                        rng.randint(0, N, (q, s, p)) / (N - 1)], -1)
        sw = rng.rand(q, s, p, len(LEVELS))
    loc, sw = loc.astype(np.float32), sw.astype(np.float32)
    jring, tring, plain, jf0, tf0 = _split_rings(case, dtype, rng, feats)
    jview = jms.ring_packed(jring, jnp.asarray(slots_of_t, jnp.int32),
                            len(slots_of_t), jf0)
    assert jview.split == CASES[case]["split"]

    def run(view):
        return jms.msmv_sampling(view, jnp.asarray(loc), jnp.asarray(sw),
                                 qmajor=True)

    jitted = dtype == "bfloat16" or any(CASES[case]["fp8"])
    want = np.asarray(jax.jit(run)(jview) if jitted else run(jview))
    tview = tms.ring_packed(tring, torch.tensor(slots_of_t), len(slots_of_t),
                            tf0.meta())
    assert tview.split == CASES[case]["split"]
    got = tms.msmv_sampling(tview, torch.from_numpy(loc),
                            torch.from_numpy(sw))
    unsplit = tms.msmv_sampling(
        tms.ring_packed(plain, torch.tensor(slots_of_t), len(slots_of_t),
                        tf0.meta()), torch.from_numpy(loc),
        torch.from_numpy(sw))
    assert torch.count_nonzero(got) > got.numel() // 2
    np.testing.assert_array_equal(_t_bits(got), _t_bits(unsplit))
    # exact values (a zero's sign aside: an fp32 output's folds may give
    # -0 on one side where a contracted FMA gives +0 on the other)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(_t_bits(got), _np_bits(want))


@pytest.mark.parametrize("spec,frames", [
    (2, 8), ((1, 2, 4, 1), 8), ((3, 1, 1, 1), 6), (1, 5)])
def test_ring_table_splits_match_jax(spec, frames):
    head = SparseBEVHead(num_classes=10, in_channels=32, num_query=4,
                         num_frames=frames, num_points=2, num_layers=1,
                         num_levels=4, pc_range=[-51.2, -51.2, -5.0, 51.2,
                                                 51.2, 3.0], num_groups=2,
                         mixer_out_points=8, table_split=spec)
    fp = type("Meta", (), {"level_shapes": [(8, 8)] * 4})()
    got = ring_table_splits(type("M", (), {"pts_bbox_head": head})(), fp,
                            frames)
    want = jax_ring_splits(type("M", (), {
        "pts_bbox_head": {"table_split": spec}})(), fp, frames)
    assert got == want


@pytest.mark.parametrize("kwargs,match", [
    # a split that does not divide the frame window
    (dict(table_split=3, num_frames=8), "must divide num_frames"),
    (dict(table_split=(1, 1, 4, 1), num_frames=6), "must divide num_frames"),
    # a split on a pair-mode (not y-fold) level
    (dict(table_split=(2, 1, 1, 1), table_yfold=(False, True, True, True),
          num_frames=8), "requires a yfold level"),
    # a split and a group split on the same level
    (dict(table_split=(1, 2, 1, 1), table_gsplit=(False, True, False, False),
          num_frames=8), "mutually exclusive"),
])
def test_split_options_raise_jax_value_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        check_table_options(4, **kwargs)


@pytest.mark.parametrize("split,yfold,match", [
    (3, True, "must divide num_slots"),
    (2, False, "requires a yfold level"),
])
def test_ring_init_refuses_what_jax_refuses(split, yfold, match):
    rng = np.random.RandomState(2)
    feats = [(rng.randn(1, N, h, w, C)).astype(np.float32) for h, w in LEVELS]
    for pkg, fr in ((jms, jms.pack_mlvl_feats_grouped(
            [jnp.asarray(f) for f in feats], N, G, yfold=(yfold, True))),
            (tms, tms.pack_mlvl_feats_grouped(
                [torch.from_numpy(f) for f in feats], N, G,
                yfold=(yfold, True)))):
        with pytest.raises(ValueError, match=match):
            pkg.ring_init(fr, 4, split=(split, 1)) if pkg is jms else \
                pkg.ring_init(fr, 4, splits=(split, 1))


# -------------------------------------------------- the streaming detector --

T, Q = 4, 16
H, W = 32, 64


def _model_cfg(split):
    cfg = copy.deepcopy(R50_MODEL)
    head = cfg["pts_bbox_head"]
    head.update(num_frames=T, num_query=Q, table_gsplit=False,
                table_gsplit_pack=False, table_split=split)
    head["bbox_coder"]["max_num"] = Q * 10
    return cfg


def _jax_model(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.pop("type")
    cfg.pop("compute_dtype")
    cfg["pts_bbox_head"].pop("bbox_coder")
    return JaxSparseBEV(compute_dtype=jnp.float32, **cfg)


def _sequence_stream(rng):
    """8 samples over two sequences: each starts with its keyframe in every
    window position (the loader's padding), then one new frame a sample; the
    second sequence evicts the first's frames from a ring of T slots."""
    frames = rng.randint(0, 256, (8, 1, N, H, W, 3)).astype(np.uint8)
    l2i = np.tile(make_cameras(rng, H, W)[None], (1, T, 1, 1)).reshape(
        1, T * N, 4, 4)
    td = np.asarray([[0.0, 0.5, 1.0, 1.5]], np.float32)
    samples = []
    for i in range(8):
        seq, start = (0, 0) if i < 5 else (1, 5)
        ids = [max(i - k, start) for k in range(T)]
        names = [f"/data/seq{seq}/f{j}_cam{v}.jpg" for j in ids
                 for v in range(N)]
        samples.append((frames[i], l2i, td, names))
    return samples


class _RecordingJaxStreaming(JaxStreaming):
    """JAX's detector, recording the slot list each sample's head reads."""

    def _build_head(self):
        head = super()._build_head()
        self.slot_lists = []

        def run(v, ring, slots, *rest):
            self.slot_lists.append([int(s) for s in np.asarray(slots)])
            return head(v, ring, slots, *rest)
        return run


@pytest.fixture(scope="module")
def streams():
    rng = np.random.RandomState(0)
    samples = _sequence_stream(rng)
    plain_cfg = _model_cfg(1)
    jmodel = _jax_model(plain_cfg)
    img0 = jnp.asarray(np.concatenate([samples[0][0]] * T, axis=1))
    variables = jax.jit(lambda r, *a: jmodel.init(r, *a, train=False))(
        {"params": jax.random.PRNGKey(0), "aug": jax.random.PRNGKey(1)},
        img0, jnp.asarray(samples[0][1]), jnp.asarray(samples[0][2]))
    variables = {"params": noise_tree(variables["params"], rng),
                 "batch_stats": noise_tree(variables["batch_stats"], rng)}
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    out = {}
    for mode, split in (("unsplit", 1), ("split", (2, 4, 1, 2))):
        cfg = _model_cfg(split)
        jdet = _RecordingJaxStreaming(_jax_model(cfg), variables,
                                      num_frames=T, cache_size=T)
        tmodel = build_detector({"model": cfg}, device="cpu")
        tmodel.load_state_dict(sd, strict=True)
        tdet = StreamingDetector(tmodel, num_frames=T, cache_size=T,
                                 device="cpu")
        runs = []
        for s in samples:
            jp = jax.device_get(jdet.infer(*s))
            tp = {k: v.numpy() for k, v in tdet.infer(*s).items()}
            runs.append((jp, tp, list(tdet.last_slots),
                         dict(tdet.slot_of_key), dict(jdet.slot_of_key)))
        out[mode] = dict(runs=runs, jdet=jdet, tdet=tdet)
    return out


@pytest.mark.parametrize("mode", ["unsplit", "split"])
def test_streaming_slot_lists_match_jax(streams, mode):
    run = streams[mode]
    assert [r[2] for r in run["runs"]] == run["jdet"].slot_lists
    for _, _, _, t_cache, j_cache in run["runs"]:
        assert list(t_cache.items()) == list(j_cache.items())
    if mode == "split":
        # a bijection onto the T slots every sample: the keyframe repeats
        # were copied into free slots, then into evicted ones
        assert all(sorted(s) == list(range(T)) for s in
                   run["jdet"].slot_lists)
        assert run["jdet"].slot_lists[0] == [0, 1, 2, 3]
        assert type(run["tdet"].ring[0]) is tuple
        assert [len(c) if isinstance(c, tuple) else 1
                for c in run["tdet"].ring] == [2, 4, 1, 2]
    else:
        assert run["jdet"].slot_lists[0] == [0, 0, 0, 0]


@pytest.mark.parametrize("mode", ["unsplit", "split"])
def test_streaming_outputs_match_jax(streams, mode):
    for jp, tp, *_ in streams[mode]["runs"]:
        for key in ("all_cls_scores", "all_bbox_preds"):
            np.testing.assert_allclose(tp[key][-1], jp[key][-1], rtol=0,
                                       atol=2e-3, err_msg=key)


def test_split_stream_equals_unsplit_stream(streams):
    """Over the same frames the split ring's outputs are the unsplit ring's,
    bit for bit, whatever slots each run used."""
    for (_, a, *_), (_, b, *_) in zip(streams["split"]["runs"],
                                      streams["unsplit"]["runs"]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
