"""Shared arithmetic of the sampling counters: which table pieces (C
channels of one y-fold half-row, or of one pair row, at one column) the
points of a call touch with a nonzero weight. A kernel reads each such
piece at least once; the roofline counts it once, whatever the kernel
reads again."""

from __future__ import annotations

import types


def geometry(packed):
    """What the counts need of a call's ``PackedFeatures``, without its
    tables (a record must not keep a step's tables alive)."""
    return types.SimpleNamespace(
        level_shapes=packed.level_shapes, yfold=packed.yfold,
        channels=packed.channels, num_views=packed.num_views,
        num_groups=packed.num_groups, slice_map=packed.slice_map,
        items=[_item(t) for t in packed.tables])


def row_index(geo, slice_idx, view, row_y, height):
    """Flat table row of (slice, view, y-row): rows are (b, t, n, h, g)."""
    g = geo.num_groups
    if g == 1:
        return (slice_idx * geo.num_views + view) * height + row_y
    return ((slice_idx // g * geo.num_views + view) * height + row_y) * g \
        + slice_idx % g


def _geometry():
    # the benchmark's frozen copy of the port's window geometry
    from reference.ops.msmv_sampling import _separable_slot_weights, view_index
    return _separable_slot_weights, view_index


def _item(table) -> int:
    return (table[0] if isinstance(table, tuple) else table).element_size()


def touched(torch, geo, loc, sw):
    """Per level ``(touched pieces, bytes of one piece)``; ``geo`` from
    :func:`geometry`."""
    slot_weights, view_index = _geometry()
    q, s, p, _ = loc.shape
    k = q * s * p
    c = geo.channels
    x = loc[..., 0].reshape(k)
    y = loc[..., 1].reshape(k)
    view = view_index(loc[..., 2].reshape(k), geo.num_views)
    slices = geo.slice_map.to(torch.int64)
    batch_row = slices.repeat_interleave(p).repeat(q)
    lw = sw.reshape(k, -1)
    out = []
    for lvl, (h, w) in enumerate(geo.level_shapes):
        sx, ry, (wxa, wxb), (wya, wyb) = slot_weights(
            x * (w - 1), y * (h - 1), h, w)
        col = row_index(geo, batch_row, view, ry, h) * (w + 1) + sx
        if geo.yfold[lvl]:             # key: half-row of one column
            rows = [(col * 2, wya), (col * 2 + 1, wyb)]
            step = 2
        else:                          # key: pair row of one column
            col1 = row_index(geo, batch_row, view,
                             torch.clamp(ry + 1, max=h - 1), h) * (w + 1) + sx
            rows = [(col, wya), (col1, wyb)]
            step = 1
        keys = []
        for slot, wx in ((0, wxa), (1, wxb)):
            for base, wy in rows:
                live = (wx != 0) & (wy * lw[:, lvl] != 0)
                keys.append((base + slot * step)[live])
        pieces = torch.unique(torch.cat(keys)).numel()
        out.append((pieces, c * geo.items[lvl]))
    return out


def io_bytes(geo, loc, sw) -> int:
    """The points' operands: locations and weights in fp32, the slice map
    as the kernel reads it (int32)."""
    return (loc.numel() + sw.numel()) * 4 + geo.slice_map.numel() * 4
