"""The ``eva02`` configuration's files at a small EVA02 on the CPU (one
period of the published pattern: blocks 0 and 1 windowed in 4x4-token
windows, block 2 global; width 64, 4 heads; 64x160 images, 16 queries, two
frames, P = 8): the reference backbone against the port, the
``stream_ring`` driver end to end through ``run_cell``, its control and
planted faults failing the comparison, the attention kernel's counter at
the published shapes, and the two span readers."""

import types

import numpy as np
import pytest
import torch

from harness import common, flops, trace, traffic
from harness.stream_ring import ring_gaps
from harness.weights import build_on_device, leaf_specs
from tiny import ROOT, tiny_config, tiny_traffic

import reference.models.eva02  # noqa: F401  (registers the backbone)

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def eva02_config():
    cfg = tiny_config("eva02")
    cfg["model"]["img_backbone"].update(
        embed_dim=64, depth=3, num_heads=4, window_size=4,
        window_block_indexes=[0, 1],
        real_img_size=list(cfg["ida_aug_conf"]["final_dim"]))
    return cfg


def run_eva02(seconds=0.3, control=None, seed=2**31 + 11):
    import run as bench_run
    man = common.manifest(ROOT)
    w = common.workload(man, "eva02.stream")
    limits = common.load_json(common.limits_path("eva02.stream"))
    return bench_run.run_cell(w, eva02_config(), tiny_traffic(w["traffic"]),
                              limits, man, seed, seconds, False, control,
                              device=torch.device("cpu"))


def _models(seed=7):
    import reference.models.detector as rdet
    from sparsebev_tpu_torch.models.detector import SparseBEV, _model_kwargs
    cfg = eva02_config()
    cpu = torch.device("cpu")
    port = build_on_device(torch, lambda: SparseBEV(**_model_kwargs(cfg)),
                           seed, cpu)
    ref = build_on_device(torch, lambda: rdet.build_detector(cfg), seed, cpu)
    return cfg, port, ref


def test_reference_has_the_ports_keys_and_values():
    _, port, ref = _models()
    assert leaf_specs(port) == leaf_specs(ref)
    ps, rs = port.state_dict(), ref.state_dict()
    assert all(torch.equal(ps[k], rs[k]) for k in ps)


def test_reference_frame_pass_and_head_match_the_port():
    """The reference's packed frame tables and its head over a ring of two
    frames equal the port's plain path bit for bit."""
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_init as p_init
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_packed as p_view
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_update as p_upd
    from reference.ops.msmv_sampling import ring_init, ring_packed, ring_update
    cfg, port, ref = _models()
    params = dict(pool_frames=2, pixels="float32", frame_interval_s=0.1,
                  speed_mps=[5.0, 6.0], yaw_rate_rps=[0.0, 0.1],
                  yaw_period_s=8.0)
    stream = traffic.Stream(torch, torch.device("cpu"), cfg, params, 3, 4)
    t = cfg["model"]["pts_bbox_head"]["num_frames"]
    h, w = stream.image_hw
    _, l2i, td, _ = stream.sample(t)
    outs = []
    for model, init, upd, view in ((port, p_init, p_upd, p_view),
                                   (ref, ring_init, ring_update,
                                    ring_packed)):
        head = model.pts_bbox_head
        with torch.inference_mode():
            ring = meta = None
            for k, j in enumerate(traffic.window_frames(t, t)):
                fp = model.forward_frame_packed(
                    torch.from_numpy(stream.pixels(j)))
                if ring is None:
                    meta = fp.meta(gsplit=head.table_gsplit)
                    ring = init(fp, t)
                upd(ring, fp, k)
            preds = model.forward_head(
                view(ring, torch.arange(t), t, meta), torch.from_numpy(l2i),
                torch.from_numpy(td), h, w)
        outs.append((ring, preds))
    (pr, pp), (rr, rp) = outs
    assert all(torch.equal(a, b) for a, b in zip(pr, rr))
    for k in pp:
        np.testing.assert_array_equal(pp[k].numpy(), rp[k].numpy())


def test_stream_ring_cell_on_cpu():
    """The result object has the contract's keys, the frame-pass and head
    numbers are compared, and the port meets the reference (on the CPU the
    port's attention is its plain version: every gap reads 0)."""
    res = run_eva02()
    assert set(res) == KEYS and list(res)[-1] == "compared"
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"stream_ms", "stream_p95_ms", "setup_s"}
    limits = common.load_json(common.limits_path("eva02.stream"))
    assert set(res["compared"]) == set(limits)
    assert {"score_gap", "box_gap", "label_mismatch"} <= set(limits)
    assert any(k.startswith("ring_") for k in limits)
    assert all(c["value"] == 0.0 for c in res["compared"].values())


def _failed(res):
    return [k for k, c in res["compared"].items() if c["value"] > c["limit"]]


def test_attn_bf16_control_fails():
    res = run_eva02(control="attn_bf16", seconds=0.2)
    assert res["correct"] is False and "trunk_gap" in _failed(res)


def test_unknown_control_is_refused():
    with pytest.raises(ValueError):
        run_eva02(control="fp8l0", seconds=0.2)


def test_attention_output_scaled_fails(monkeypatch):
    import sparsebev_tpu_torch.models.eva02 as eva
    orig = eva.eva_attention
    monkeypatch.setattr(eva, "eva_attention",
                        lambda q, k, v, **kw: orig(q, k, v, **kw) * 1.01)
    res = run_eva02(seconds=0.2)
    assert res["correct"] is False
    assert {"trunk_gap", "ring_rms_gap"} <= set(_failed(res))


def test_global_block_run_windowed_fails(monkeypatch):
    import sparsebev_tpu_torch.models.eva02 as eva
    orig = eva.ViT.__init__

    def init(self, *a, **kw):
        kw["window_block_indexes"] = tuple(kw["window_block_indexes"]) + (2,)
        orig(self, *a, **kw)

    monkeypatch.setattr(eva.ViT, "__init__", init)
    res = run_eva02(seconds=0.2)
    assert res["correct"] is False
    assert {"trunk_gap", "ring_rms_gap"} <= set(_failed(res))


def test_altered_score_fails_the_head_check(monkeypatch):
    from sparsebev_tpu_torch.bbox import nms_free_coder
    orig = nms_free_coder.NMSFreeCoder.decode

    def altered(self, preds):
        out = orig(self, preds)
        out["scores"] = out["scores"].clone()
        out["scores"][:, 0] += 0.01
        return out

    monkeypatch.setattr(nms_free_coder.NMSFreeCoder, "decode", altered)
    res = run_eva02(seconds=0.2)
    assert res["correct"] is False and "score_gap" in _failed(res)


def test_ring_gaps_by_hand():
    ref = torch.tensor([[4.0, -2.0], [1.0, 0.5]], dtype=torch.bfloat16)
    prog = ref.clone()
    prog[0, 0] = 4.03125        # one ulp at 4
    prog[1, 1] = 0.5078125      # two ulps at 0.5; the second level equal
    got = ring_gaps([prog, ref], [ref, ref])
    assert got["ring_gap"] == pytest.approx(0.03125 / 4)
    rms_ref = float(ref.float().square().mean().sqrt())
    rms_d = float(np.sqrt((0.03125 ** 2 + 0.0078125 ** 2) / 4))
    assert got["ring_rms_gap"] == pytest.approx(rms_d / rms_ref)


@pytest.mark.parametrize("b, n, flops_g, mbytes", [
    (6, 4000, 393.216, 393.216),            # a global call
    (126, 256, 33.822867456, 528.482304)])  # a windowed call
def test_attention_counter_at_the_published_shapes(b, n, flops_g, mbytes):
    mod = trace.kernel_counters()["eva_attention"]
    q = torch.empty((b, n, 16, 64), device="meta")
    f, nbytes = mod.count(mod.record((q, q, q), (q, None)))
    assert f == pytest.approx(flops_g * 1e9) and f == 4 * b * 16 * n * n * 64
    assert nbytes == pytest.approx(mbytes * 1e6)
    lse = torch.empty((b, 16, n), device="meta")
    _, with_lse = mod.count(mod.record((q, q, q), (q, lse)))
    assert with_lse == nbytes + 4 * b * 16 * n
    assert mod.HOOK == ("sparsebev_tpu_torch.ops.eva_attention",
                        "_eva_attention_cuda")
    assert mod.RATE == "tf32_flops_per_s"


@pytest.mark.parametrize("metric, span", [
    ("window_blocks_ms.stream.eva02", "eva02.window_block"),
    ("global_blocks_ms.stream.eva02", "eva02.global_block")])
def test_span_readers(metric, span):
    table = {"stream.infer": {"count": 4, "device_ms": 2000.0},
             span: {"count": 64, "device_ms": 1200.0}}
    read = common.reader(metric).read
    assert read(types.SimpleNamespace(layer={"program_spans": table})) \
        == 300.0
    # a port without the span, or a run without the tracer: nothing
    del table[span]
    assert read(types.SimpleNamespace(layer={"program_spans": table})) \
        is None
    assert read(types.SimpleNamespace(layer={})) is None


def test_sample_flops_count_the_trunk():
    """The reference's FLOPs a sample (``harness/flops.py``, on ``meta``)
    at the published size: the trunk's products, reckoned by hand (patch
    embed, 24 blocks' projections and SwiGLU, 8 global and 16 windowed
    attention calls), are most of it; the pyramid and the head add the
    rest."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = common.load_json(f"{ROOT}/benchmark/configs/eva02.json")
    total = flops.stream_sample_flops(torch, cfg)
    # the windowed blocks project their padded tokens (126 x 256)
    n, n_win, c = 6 * 40 * 100, 126 * 256, 1024
    hidden = int(1024 * 4 * 2 / 3)
    trunk = (2 * n * c * 3 * 16 * 16 + 24 * 6 * n * c * hidden
             + 8 * 8 * n * c * c + 16 * 8 * n_win * c * c
             + 8 * 4 * 6 * 16 * 4000 ** 2 * 64
             + 16 * 4 * 126 * 16 * 256 ** 2 * 64)
    net = flops._meta_model(torch, cfg, train=False).img_backbone.net
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(torch.empty((6, 640, 1600, 3), device="meta"), torch.bfloat16)
    # the position embedding's bicubic resize adds a few products
    assert counter.get_total_flops() == pytest.approx(trunk, rel=1e-3)
    assert 18e12 < trunk < total < 1.2 * trunk
