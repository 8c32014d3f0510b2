"""The frozen reference against the port on the CPU at a small size: the
same keys for the seeded weights, the same packed frame tables, and the
same head predictions over a ring of two frames."""

import numpy as np
import pytest
import torch

from harness import traffic
from harness.weights import build_on_device, leaf_specs
from tiny import tiny_config


def _models(name, seed=7):
    import reference.models.detector as rdet
    from sparsebev_tpu_torch.models.detector import SparseBEV, _model_kwargs
    cfg = tiny_config(name)
    cpu = torch.device("cpu")
    port = build_on_device(torch, lambda: SparseBEV(**_model_kwargs(cfg)),
                           seed, cpu)
    ref = build_on_device(torch, lambda: rdet.build_detector(cfg), seed, cpu)
    return cfg, port, ref


@pytest.mark.parametrize("name", ["vov99", "r101"])
def test_same_state_dict_keys_and_values(name):
    _, port, ref = _models(name)
    assert leaf_specs(port) == leaf_specs(ref)
    ps, rs = port.state_dict(), ref.state_dict()
    assert all(torch.equal(ps[k], rs[k]) for k in ps)


@pytest.mark.parametrize("name", ["vov99", "r101"])
def test_frame_pass_and_head_match_the_port(name):
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_init as p_init
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_packed as p_view
    from sparsebev_tpu_torch.ops.msmv_sampling import ring_update as p_upd
    from reference.ops.msmv_sampling import ring_init, ring_packed, ring_update
    cfg, port, ref = _models(name)
    params = dict(pool_frames=2, pixels="float32", frame_interval_s=0.1,
                  speed_mps=[5.0, 6.0], yaw_rate_rps=[0.0, 0.1],
                  yaw_period_s=8.0)
    stream = traffic.Stream(torch, torch.device("cpu"), cfg, params, 3, 4)
    t = cfg["model"]["pts_bbox_head"]["num_frames"]
    i = t
    h, w = stream.image_hw
    img, l2i, td, _ = stream.sample(i)
    outs = []
    for model, init, upd, view in ((port, p_init, p_upd, p_view),
                                   (ref, ring_init, ring_update,
                                    ring_packed)):
        head = model.pts_bbox_head
        with torch.inference_mode():
            ring = meta = None
            tables = []
            for k, j in enumerate(traffic.window_frames(i, t)):
                fp = model.forward_frame_packed(
                    torch.from_numpy(stream.pixels(j)))
                tables.append([x.clone() for x in fp.tables])
                if ring is None:
                    meta = fp.meta(gsplit=head.table_gsplit)
                    ring = init(fp, t)
                upd(ring, fp, k)
            preds = model.forward_head(
                view(ring, torch.arange(t), t, meta), torch.from_numpy(l2i),
                torch.from_numpy(td), h, w)
        outs.append((tables, preds))
    (pt, pp), (rt, rp) = outs
    for a, b in zip(pt, rt):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k in pp:
        np.testing.assert_array_equal(pp[k].numpy(), rp[k].numpy())
