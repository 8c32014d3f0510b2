"""Seeded weights, made on the device in a few large calls.

Both sides get the same values: :func:`seeded_state` fills a state dict
from ``(seed, names and shapes)`` alone, so the port's model and the
reference's, which share their key names, receive the same numbers. The
draw follows the port's ``random_init_`` rules (variance-preserving conv /
linear weights, frozen-BN statistics near the identity, LN and BN scales
near 1, small biases, the reference query-box grid), but from one normal
and one uniform draw over all leaves on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("init_query_bbox.weight"):
        return "query_bbox"
    if leaf == "running_mean":
        return "normal:0.1"
    if leaf == "running_var":
        return "uniform:0.8:1.2"
    if len(shape) >= 2:
        fan_in = 1 if "label_enc" in name else math.prod(shape[1:])
        return f"normal:{1.0 / math.sqrt(fan_in)!r}"
    if leaf == "weight":
        return "uniform:0.8:1.2"
    return "normal:0.1"


def leaf_specs(module) -> List[Tuple[str, tuple]]:
    """(name, shape) of every entry of ``module``'s state dict, sorted by
    name (so the draw does not depend on the order modules are built in)."""
    return sorted((k, tuple(v.shape)) for k, v in module.state_dict().items())


def seeded_state(torch, specs, seed: int, device) -> Dict[str, "object"]:
    """fp32 tensors on ``device`` for ``specs`` from ``seed``."""
    total = sum(math.prod(s) for _, s in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        kind = _kind(name, shape).split(":")
        if kind[0] == "uniform":
            lo, hi = float(kind[1]), float(kind[2])
            t = uniform[off:off + n] * (hi - lo) + lo
        elif kind[0] == "normal":
            t = normal[off:off + n] * float(kind[1])
        else:
            t = _query_bbox(torch, normal[off:off + n], shape)
        out[name] = t.reshape(shape)
        off += n
    return out


def _query_bbox(torch, draw, shape):
    """The head's query-box init: N(0, 1) with xy on a centred sqrt(Q) x
    sqrt(Q) grid in (0, 1), z 0, log-h 1.5, velocity 0."""
    q = shape[0]
    gs = math.isqrt(q)
    if gs * gs != q:
        raise ValueError("num_query must be a square")
    w = draw.reshape(shape).clone()
    xs = (torch.arange(gs, dtype=torch.float32, device=draw.device)
          + 0.5) / gs
    xx, yy = torch.meshgrid(xs, xs, indexing="ij")
    w[:, 0:2] = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    w[:, 2:3] = 0.0
    w[:, 5:6] = 1.5
    w[:, 8:10] = 0.0
    return w


def build_on_device(torch, make, seed: int, device):
    """``make()`` built without memory on the meta device, then given
    storage on ``device`` and the seeded values (every state-dict entry is
    overwritten)."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    state = seeded_state(torch, leaf_specs(model), seed, device)
    model.load_state_dict(state, strict=True)
    _check_initialized(model, state)
    return model.eval()


def _check_initialized(model, state):
    """Every parameter and buffer must come from the state dict: a
    non-persistent buffer would keep ``to_empty``'s garbage."""
    names = set(state)
    for name, _ in list(model.named_parameters()) + list(
            model.named_buffers()):
        if name not in names:
            raise RuntimeError(f"{name} is not in the state dict: it would "
                               "keep uninitialized memory")
