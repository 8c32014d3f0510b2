"""The roofline counters against values reckoned by hand on known shapes,
and the FLOP count of a known convolution."""

import pytest
import torch

from harness import trace
from reference.ops.msmv_sampling import PackedFeatures

COUNTERS = trace.kernel_counters()


def _one_point(yfold, x, y):
    """One level of H=4, W=5, C=8 bf16 channels, one view, one group, one
    slice, one point at pixel (x * 4, y * 3) with weight 1."""
    h, w, c = 4, 5, 8
    table = torch.zeros((h, w + 1, (2 if yfold else 1) * c),
                        dtype=torch.bfloat16)
    packed = PackedFeatures([table], 1, 1, [(h, w)], c, yfold=yfold,
                            slice_map=torch.zeros(1, dtype=torch.long))
    loc = torch.tensor([[[[x, y, 0.0]]]])
    sw = torch.ones((1, 1, 1, 1))
    return packed, loc, sw, torch.zeros((1, 1, 1, c), dtype=torch.bfloat16)


@pytest.mark.parametrize("yfold, x, pieces", [
    # pixel (1.2, 1.5): two columns x two rows -> four pieces
    (True, 0.3, 4), (False, 0.3, 4),
    # pixel (0.0, 1.5): the second column's weight is 0 -> two pieces
    (False, 0.0, 2)])
def test_sampling_forward_by_hand(yfold, x, pieces):
    packed, loc, sw, out = _one_point(yfold, x, 0.5)
    mod = COUNTERS["msmv_sample"]
    flops, nbytes = mod.count(mod.record((packed, loc, sw), out))
    assert flops == 12 * 1 * 1 * 8
    # pieces of 8 bf16 channels; loc 3 + sw 1 + slice map 1 words; output
    assert nbytes == pieces * 16 + 5 * 4 + 16


def test_sampling_backward_by_hand():
    packed, loc, sw, gout = _one_point(True, 0.3, 0.5)
    mod = COUNTERS["msmv_sample_bwd"]
    d = (torch.zeros_like(loc), torch.zeros_like(sw))
    flops, nbytes = mod.count(mod.record((packed, loc, sw, gout, [None]), d))
    assert flops == 16 * 8
    # 4 pieces read, their gradient read and written; g; operands; d_loc, d_sw
    assert nbytes == 4 * 16 * 3 + 16 + 5 * 4 + 4 * 4


@pytest.mark.parametrize("name, src, out", [
    ("msmv_pack", (2, 3, 4, 8), (2, 3, 2, 5, 8)),
    ("msmv_pack_pair", (2, 3, 4, 8), (2, 3, 2, 5, 4)),
    ("msmv_pack_bwd", (2, 3, 2, 5, 8), (2, 3, 4, 8)),
    ("msmv_pack_pair_bwd", (2, 3, 2, 5, 4), (2, 3, 4, 8))])
def test_pack_counters_by_hand(name, src, out):
    mod = COUNTERS[name]
    a = torch.zeros(src, dtype=torch.bfloat16)
    b = torch.zeros(out, dtype=torch.bfloat16)
    n_src = 1
    for d in src:
        n_src *= d
    n_out = 1
    for d in out:
        n_out *= d
    assert mod.count(mod.record((a, 2), b)) == (0, 2 * (n_src + n_out))


def test_every_counter_names_its_hook_and_kernel():
    assert set(COUNTERS) == {"msmv_sample", "msmv_sample_bwd", "msmv_pack",
                             "msmv_pack_pair", "msmv_pack_bwd",
                             "msmv_pack_pair_bwd"}
    import importlib
    for mod in COUNTERS.values():
        owner = importlib.import_module(mod.HOOK[0])
        assert callable(getattr(owner, mod.HOOK[1]))
        assert mod.KERNEL.endswith("<")


def test_flop_counter_on_a_known_conv():
    from torch.utils.flop_counter import FlopCounterMode
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False, device="meta")
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        conv(torch.empty((2, 3, 16, 16), device="meta"))
    # 2 images x 8 outputs x 16 x 16 positions x 27 products, 2 FLOPs each
    assert counter.get_total_flops() == 2 * 8 * 16 * 16 * 27 * 2
