"""The traffic generator: seeded, and geometry under which the sampling
points land in the images and the frames move."""

import numpy as np
import torch

from harness import traffic
from tiny import tiny_config, tiny_traffic


def _stream(seed):
    cfg = tiny_config("vov99", frames=4)
    return traffic.Stream(torch, torch.device("cpu"), cfg,
                          tiny_traffic("stream"), seed, 12)


def test_same_seed_same_inputs_other_seed_other_inputs():
    a, b, c = _stream(2**31 + 3), _stream(2**31 + 3), _stream(2**31 + 4)
    for i in (0, 5, 11):
        for x, y in zip(a.sample(i)[:3], b.sample(i)[:3]):
            np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.sample(5)[1], c.sample(5)[1])
    assert not np.array_equal(a.pixels(0), c.pixels(0))


def test_points_land_in_the_images_and_history_moves():
    s = _stream(2**31 + 7)
    h, w = s.image_hw
    l2i, td = s.sample(9)[1:3]
    xs = np.linspace(-40, 40, 21)
    pts = np.stack(np.meshgrid(xs, xs, [-1.0], indexing="ij"), -1)
    pts = np.concatenate([pts.reshape(-1, 3), np.ones((21 * 21, 1))], -1)
    cam = np.einsum("vij,pj->vpi", l2i[0, :6], pts)
    z = cam[..., 2]
    u = cam[..., 0] / np.maximum(z, 1e-5)
    v = cam[..., 1] / np.maximum(z, 1e-5)
    seen = ((z > 1e-5) & (u > 0) & (u < w) & (v > 0) & (v < h)).any(0)
    assert seen.mean() > 0.5
    assert td[0, 0] == 0 and np.all(np.diff(td[0]) > 0)
    assert not np.allclose(l2i[0, :6], l2i[0, 6:12])
