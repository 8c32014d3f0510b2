"""Model FLOPs a sample or a step, counted once a run by
``torch.utils.flop_counter.FlopCounterMode`` over the reference on the
``meta`` device (matrix products and convolutions, forward and, for a
step, backward; no recomputation: checkpointing is off in the counted
copy). Nothing is computed and no memory is taken."""

from __future__ import annotations

import copy


def _meta_model(torch, cfg: dict, train: bool):
    import reference.models.detector as rdet
    cfg = copy.deepcopy(cfg)
    if train:
        cfg["model"]["img_backbone"]["with_cp"] = False
    with torch.device("meta"):
        model = rdet.build_detector(cfg)
    model.pts_bbox_head.transformer.decoder.with_cp = False
    return model


def stream_sample_flops(torch, cfg: dict) -> float:
    """One streaming sample: a frame pass of six views and the head over a
    ring of T frames."""
    from torch.utils.flop_counter import FlopCounterMode
    from reference.ops.msmv_sampling import ring_init, ring_packed
    model = _meta_model(torch, cfg, train=False)
    head = model.pts_bbox_head
    t = head.num_frames
    h, w = cfg["ida_aug_conf"]["final_dim"]
    meta = torch.device("meta")
    counter = FlopCounterMode(display=False)
    model.requires_grad_(False)
    with torch.no_grad(), counter:
        fp = model.forward_frame_packed(
            torch.empty((1, 6, h, w, 3), device=meta))
        ring = ring_init(fp, t)
        packed = ring_packed(ring, torch.arange(t, device=meta), t,
                             fp.meta(gsplit=head.table_gsplit))
        model.forward_head(packed, torch.empty((1, t * 6, 4, 4), device=meta),
                           torch.empty((1, t), device=meta), h, w)
    return float(counter.get_total_flops())


def train_step_flops(torch, cfg: dict, batch: int) -> float:
    """One training step: the forward with denoising queries (the config's
    groups times ``max_gt``) and the backward of every output."""
    from torch.utils.flop_counter import FlopCounterMode
    model = _meta_model(torch, cfg, train=True)
    head_cfg = cfg["model"]["pts_bbox_head"]
    t = head_cfg["num_frames"]
    q = head_cfg["num_query"]
    dn = head_cfg.get("query_denoising_groups", 10) * cfg["max_gt"]
    h, w = cfg["ida_aug_conf"]["final_dim"]
    meta = torch.device("meta")
    dn_inputs = {
        "dn_query_bbox": torch.empty((batch, dn, 10), device=meta),
        "dn_labels": torch.empty((batch, dn), dtype=torch.long, device=meta),
        "dn_mask": torch.empty((batch, dn), dtype=torch.bool, device=meta),
        "attn_mask": torch.empty((dn + q, dn + q), dtype=torch.bool,
                                 device=meta)}
    counter = FlopCounterMode(display=False)
    with counter:
        preds = model(torch.empty((batch, t * 6, h, w, 3), device=meta),
                      torch.empty((batch, t * 6, 4, 4), device=meta),
                      torch.empty((batch, t), device=meta),
                      dn_inputs=dn_inputs, train=True)
        total = sum(v.float().sum() for v in preds.values())
        total.backward()
    return float(counter.get_total_flops())
