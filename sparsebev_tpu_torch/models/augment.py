"""On-device data augmentation (counterpart of
``sparsebev_tpu/models/augment.py``): GridMask and the photometric
distortion, on tensors.

Each augmentation is a pure function of the images and of its random
*draws*, a dict of tensors (or Python numbers). ``draw_*`` makes the draws
from an explicit ``torch.Generator``; a caller may pass its own instead (the
tests inject the JAX package's draws, since the two random streams cannot
agree). Random values flow through arithmetic, never through shapes or
through the host: nothing here synchronizes the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _rand(shape, generator, device, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=generator, device=device) \
        * (hi - lo) + lo


def draw_grid_mask(generator: Optional[torch.Generator], height: int,
                   device) -> Dict[str, torch.Tensor]:
    """The draws of :func:`grid_mask`: ``u`` ~ U[0, 1) (applied when below
    ``prob``), the grid period ``d`` ~ U{2..H-1} and the two band offsets
    ``st_h``, ``st_w`` ~ U{0..d-1}."""
    u = _rand((), generator, device)
    d = torch.randint(2, height, (), generator=generator, device=device)
    st = (_rand((2,), generator, device) * d).long().clamp(max=d - 1)
    return dict(u=u, d=d, st_h=st[0], st_w=st[1])


def grid_mask(imgs: torch.Tensor, draws: Dict[str, torch.Tensor],
              ratio: float = 0.5, prob: float = 0.7) -> torch.Tensor:
    """Random grid occlusion. imgs: ``[N, H, W, C]`` (any leading batch
    folded in).

    Keeps pixels inside the union of row / column bands of width
    ``l ~ d * ratio`` spaced ``d`` apart and zeroes the rest; applied when
    ``draws["u"] < prob`` (one draw for the whole call)."""
    n, h, w, c = imgs.shape
    dev = imgs.device
    as_t = lambda v, dt: torch.as_tensor(v, device=dev).to(dt)  # noqa: E731
    d = as_t(draws["d"], torch.int64)
    st_h = as_t(draws["st_h"], torch.int64)
    st_w = as_t(draws["st_w"], torch.int64)
    apply = as_t(draws["u"], torch.float32) < prob
    band = (d.float() * ratio + 0.5).long()
    band = torch.minimum(torch.clamp(band, min=1), d - 1)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    off_h = (int(1.5 * h) - h) // 2
    off_w = (int(1.5 * w) - w) // 2
    row_band = ((ys + off_h - st_h) % d) < band
    col_band = ((xs + off_w - st_w) % d) < band
    keep = (row_band | col_band).to(imgs.dtype)                # [H, W]
    return torch.where(apply, imgs * keep[None, :, :, None], imgs)


def rgb_to_hsv(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``[..., H, W, 3]`` RGB in [0, 255] -> HSV with H in [0, 360), S in
    [0, 1], V in [0, 255]."""
    img = image / 255.0
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    max_rgb = img.max(dim=-1).values
    argmax_rgb = img.argmax(dim=-1)
    min_rgb = img.min(dim=-1).values
    deltac = max_rgb - min_rgb
    v = max_rgb
    s = deltac / (max_rgb + eps)
    deltac_safe = torch.where(deltac == 0, torch.ones_like(deltac), deltac)
    rc = max_rgb - r
    gc = max_rgb - g
    bc = max_rgb - b
    h1 = (bc - gc) / deltac_safe
    h2 = ((rc - bc) + 2.0 * deltac_safe) / deltac_safe
    h3 = ((gc - rc) + 4.0 * deltac_safe) / deltac_safe
    h = torch.where(argmax_rgb == 0, h1,
                    torch.where(argmax_rgb == 1, h2, h3))
    h = (h / 6.0) % 1.0 * 360.0
    return torch.stack([h, s, v * 255.0], dim=-1)


def hsv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv`."""
    h = image[..., 0] / 360.0
    s = image[..., 1]
    v = image[..., 2] / 255.0
    hi = torch.floor(h * 6) % 6
    f = (h * 6) % 6 - hi
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    hi = hi.long()

    def select(choices):
        out = torch.zeros_like(v)
        for i, cval in reversed(list(enumerate(choices))):
            out = torch.where(hi == i, cval, out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1) * 255.0


def draw_photometric(generator: Optional[torch.Generator], n: int, device,
                     brightness_delta: float = 32.0,
                     contrast_range: Tuple[float, float] = (0.5, 1.5),
                     saturation_range: Tuple[float, float] = (0.5, 1.5),
                     hue_delta: float = 18.0) -> Dict[str, torch.Tensor]:
    """The per-image draws of :func:`photometric_distortion`, each ``[n]``:
    six coin flips (``contrast_mode``, ``do_brightness``, ``do_contrast``,
    ``do_saturation``, ``do_hue``, ``do_swap``), four magnitudes (``delta``,
    ``alpha``, ``saturation``, ``hue``) and the channel permutation
    ``perm_idx`` in 0..5."""
    def coin():
        return _rand((n,), generator, device) < 0.5

    return dict(
        contrast_mode=coin(),
        delta=_rand((n,), generator, device, -brightness_delta,
                    brightness_delta),
        do_brightness=coin(),
        alpha=_rand((n,), generator, device, *contrast_range),
        do_contrast=coin(),
        saturation=_rand((n,), generator, device, *saturation_range),
        do_saturation=coin(),
        hue=_rand((n,), generator, device, -hue_delta, hue_delta),
        do_hue=coin(),
        perm_idx=torch.randint(0, 6, (n,), generator=generator,
                               device=device),
        do_swap=coin())


def photometric_distortion(imgs: torch.Tensor,
                           draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-image random brightness / contrast / saturation / hue / channel
    swap. imgs: ``[N, H, W, 3]`` **BGR** float in [0, 255] (the loader's raw
    layout); converts to RGB inside, as the reference does."""
    dev = imgs.device

    def per_image(name, dtype):
        return torch.as_tensor(draws[name], device=dev).to(dtype)

    def col(name, dtype=torch.float32):
        return per_image(name, dtype)[:, None, None, None]

    imgs = imgs.flip(-1)  # BGR -> RGB
    contrast_mode = col("contrast_mode", torch.bool)
    imgs = torch.where(col("do_brightness", torch.bool),
                       imgs + col("delta"), imgs)
    alpha = col("alpha")
    do_c = col("do_contrast", torch.bool)
    imgs = torch.where(~contrast_mode & do_c, imgs * alpha, imgs)

    hsv = rgb_to_hsv(imgs)
    plane = lambda name, dt=torch.float32: col(name, dt)[..., 0]  # noqa: E731
    s_new = torch.where(plane("do_saturation", torch.bool),
                        hsv[..., 1] * plane("saturation"), hsv[..., 1])
    h_new = torch.where(plane("do_hue", torch.bool),
                        hsv[..., 0] + plane("hue"), hsv[..., 0])
    h_new = torch.where(h_new > 360, h_new - 360, h_new)
    h_new = torch.where(h_new < 0, h_new + 360, h_new)
    imgs = hsv_to_rgb(torch.stack([h_new, s_new, hsv[..., 2]], dim=-1))

    imgs = torch.where(contrast_mode & do_c, imgs * alpha, imgs)
    perms = torch.tensor(_PERMS, device=dev)
    perm = torch.where(per_image("do_swap", torch.bool)[:, None],
                       perms[per_image("perm_idx", torch.int64)],
                       perms[0][None])
    imgs = torch.gather(
        imgs, -1, perm[:, None, None, :].expand(*imgs.shape[:-1], 3))
    return imgs.flip(-1)  # RGB -> BGR
