"""The packs: one pyramid level -> grouped y-fold or pair-mode tables.

Counterpart of ``sparsebev_tpu/ops/msmv_pack_pallas.py::pack_level`` and
``pack_level_pair``, and of their adjoints ``_pack_level_bwd`` (:125) and
``_pack_pair_bwd`` (:214). Two CUDA sources, each with a forward and a
backward kernel:

- ``csrc/msmv_pack.cu`` replaces the Pallas kernel ``pack_level_tpu`` (:63,
  body ``_pack_kernel`` :32); :func:`pack_level_plain` is the plain PyTorch
  version of ``_pack_level_xla`` (:101).
- ``csrc/msmv_pack_pair.cu`` replaces ``pack_level_pair_tpu`` (:154, body
  ``_pack_pair_kernel`` :142); :func:`pack_level_pair_plain` is the plain
  version of ``_pack_pair_xla`` (:192).
- the backward entries of the same two sources replace the XLA chains of
  the JAX adjoints; :func:`pack_level_bwd_plain` and
  :func:`pack_level_pair_bwd_plain` are their plain versions (the slicing
  formulas of the adjoints).

Both packs are ``torch.autograd.Function``s: the gradient of a table goes
back to the pyramid through the adjoint kernel (CUDA) or its plain version
(CPU), as the JAX ``custom_vjp`` does.

One table gradient a step (:class:`TableGrad`). The decoder's layers all
sample the same packed tables, so autograd would make one table-sized
gradient per layer and add them up, each add reading two tables and writing
one. Instead a pack given a :class:`TableGrad` (``pack_mlvl_feats_grouped``
gives one to every level it packs in a graph) shares it with the sampling
op through ``PackedFeatures.table_grads``: the first sampling backward of a
backward pass allocates the buffer, zeroed, in the table dtype; every
sampling backward of that pass adds its table gradient into it (the
kernel's vector reductions, or the plain gradient with one add in the table
dtype) and hands autograd no gradient for the table; the pack's backward,
which autograd runs only after all consumers of the table, takes the
buffer, adds any gradient that other consumers gave the table, runs the
adjoint and releases it. In
bf16 this is the sum JAX takes of the per-layer cotangents, each added in
bf16; on the card the layers' reductions interleave, so only the order of
the adds differs. The buffer is tagged with the backward pass that made it:
a pass that stopped before the pack (``torch.autograd.grad`` for the points
alone) leaves a stale buffer that the next pass does not read.

Remat. A non-reentrant ``torch.utils.checkpoint`` (the backbone's
``with_cp``) runs the original sampling node's backward in the outer pass:
nothing changes. A reentrant one recomputes the forward inside the outer
pass and runs its backward in a nested pass; a sampling call whose forward
ran inside a backward pass therefore hands its table gradient to autograd
(``_MsmvSampling``), and a pack backward in a nested pass adds that to its
input's gradient and leaves the outer pass's buffer for the outer pass's
pack backward. Both are summed into the pyramid's gradient, as autograd
sums them without the buffer (``tests/test_torch_train_ops.py`` checks
both kinds of checkpoint).

Layout: ``feat [M, H, W, C] -> [M, H, G, W+1, 2Cg]``. Row h of group g holds
``feat[h, :, g] ‖ feat[h+1, :, g]`` on the channel axis (row H-1's second
half is zeros) plus a zero guard column at x = W, so one (2 columns x 2Cg)
window carries all four bilinear taps of a point.

Pair layout: ``feat [M, H, W, C] -> [M, H, G, W+1, Cg]``, the (W <-> G)
permute plus the zero guard column, with no y-interleave (a point reads two
rows instead): 1x feature memory, for the big configs' level 0.

Bound (flagship r50, one new frame, 4 levels, bf16): 45.9 MB read + 92.7 MB
written, about 41 us at 3.35 TB/s. The kernel reads each input element once
and writes each output element once with 16-byte vector accesses. The
pair pack at vov99 level 0 (6 x 160 x 400 x 256, bf16) reads 196.6 MB and
writes 197.1 MB: about 118 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build


def pack_level_plain(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain PyTorch y-fold pack (the formulation of ``_pack_level_xla``)."""
    m, h, w, c = feat.shape
    g = num_groups
    cg = c // g
    f = feat.reshape(m, h, w, g, cg)
    fy = torch.cat([f[:, 1:], torch.zeros_like(f[:, :1])], dim=1)
    t2 = torch.stack([f, fy], dim=-2)                  # [M,H,W,G,2,Cg]
    t2 = t2.permute(0, 1, 3, 2, 4, 5)                  # [M,H,G,W,2,Cg]
    t2 = F.pad(t2, (0, 0, 0, 0, 0, 1))                 # zero guard column
    return t2.reshape(m, h, g, w + 1, 2 * cg)


def pack_level_bwd_plain(dt: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain PyTorch adjoint of the y-fold pack (``_pack_level_bwd``):
    ``dfeat[m,h,w,(g,cg)] = dT[m,h,g,w,cg] + dT[m,h-1,g,w,Cg+cg]`` (zero for
    h = 0), the guard column dropped. ``dT [M, H, G, W+1, 2Cg]`` ->
    ``[M, H, W, C]``; the one add is taken in dT's dtype, as JAX takes it."""
    m, h, g, w1, c2 = dt.shape
    if g != num_groups:
        raise ValueError(f"pack_level_bwd: {g} groups in the table gradient, "
                         f"{num_groups} expected")
    w, cg = w1 - 1, c2 // 2
    dt = dt[:, :, :, :w]
    d0 = dt[..., :cg]
    d1 = dt[..., cg:]
    d1 = torch.cat([torch.zeros_like(d1[:, :1]), d1[:, :h - 1]], dim=1)
    return (d0 + d1).permute(0, 1, 3, 2, 4).reshape(m, h, w, g * cg)


class TableGrad:
    """The gradient of one packed table, summed over the sampling calls of
    one backward pass (see the module docstring)."""

    def __init__(self):
        self._buf = None
        self._task = None

    def accumulator(self, table: torch.Tensor) -> torch.Tensor:
        """The buffer the sampling backward adds ``table``'s gradient to:
        zeros of the table's shape and dtype at the first call of a backward
        pass, the same buffer at every later call of that pass."""
        task = torch._C._current_graph_task_id()
        if self._buf is None or self._task != task:
            self._buf = torch.zeros(table.shape, dtype=table.dtype,
                                    device=table.device)
            self._task = task
        return self._buf

    def take(self, dt, shape):
        """The summed gradient as ``shape``, with ``dt`` (autograd's own
        gradient of the table, or None) added; None when neither exists.
        Releases a buffer of this backward pass; one of another pass is
        left alone (see the module docstring)."""
        if self._buf is None \
                or self._task != torch._C._current_graph_task_id():
            return dt
        buf = self._buf.view(shape)
        self._buf = self._task = None
        return buf if dt is None else buf.add_(dt)


def _table_gradient(ctx, dt):
    """A pack backward's table gradient: ``dt`` plus what its
    :class:`TableGrad` holds, or None."""
    if ctx.table_grad is None:
        return dt
    return ctx.table_grad.take(dt, ctx.out_shape)


class _PackLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, num_groups, table_grad):
        ctx.num_groups = num_groups
        ctx.table_grad = table_grad
        ctx.set_materialize_grads(False)
        if feat.device.type == "cpu":
            out = pack_level_plain(feat, num_groups)
        else:
            out = _pack_level_cuda(feat, num_groups)
        ctx.out_shape = out.shape
        return out

    @staticmethod
    def backward(ctx, dt):
        dt = _table_gradient(ctx, dt)
        if dt is None:
            return None, None, None
        return pack_level_bwd(dt, ctx.num_groups), None, None


def pack_level(feat: torch.Tensor, num_groups: int,
               table_grad: TableGrad = None) -> torch.Tensor:
    """``[M, H, W, C] -> [M, H, G, W+1, 2Cg]``, differentiable. A CPU tensor
    takes the plain versions; a CUDA tensor launches the kernels (or
    raises). ``table_grad``: where the sampling backward sums the table's
    gradient (module docstring)."""
    return _PackLevel.apply(feat, num_groups, table_grad)


pack_level.launches = 0  # forward launches (counted in _pack_level_cuda)


def pack_level_bwd(dt: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The y-fold pack's adjoint on its own (what ``pack_level``'s backward
    runs): CPU -> plain version, CUDA -> kernel (or raises)."""
    if dt.device.type == "cpu":
        return pack_level_bwd_plain(dt, num_groups)
    return _pack_level_bwd_cuda(dt, num_groups)


pack_level_bwd.launches = 0  # counted in _pack_level_bwd_cuda


def pack_level_pair_plain(feat: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Plain PyTorch pair-mode pack (the formulation of ``_pack_pair_xla``)."""
    m, h, w, c = feat.shape
    g = num_groups
    f = feat.reshape(m, h, w, g, c // g).permute(0, 1, 3, 2, 4)
    return F.pad(f, (0, 0, 0, 1))                      # zero guard column


def pack_level_pair_bwd_plain(dt: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    """Plain PyTorch adjoint of the pair pack (``_pack_pair_bwd``): the guard
    column dropped and ``(G, W)`` permuted back; each feature element has one
    table copy. ``dT [M, H, G, W+1, Cg]`` -> ``[M, H, W, C]``."""
    m, h, g, w1, cg = dt.shape
    if g != num_groups:
        raise ValueError(f"pack_level_pair_bwd: {g} groups in the table "
                         f"gradient, {num_groups} expected")
    return dt[:, :, :, :w1 - 1].permute(0, 1, 3, 2, 4).reshape(
        m, h, w1 - 1, g * cg)


class _PackLevelPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, num_groups, table_grad):
        ctx.num_groups = num_groups
        ctx.table_grad = table_grad
        ctx.set_materialize_grads(False)
        if feat.device.type == "cpu":
            out = pack_level_pair_plain(feat, num_groups)
        else:
            out = _pack_level_pair_cuda(feat, num_groups)
        ctx.out_shape = out.shape
        return out

    @staticmethod
    def backward(ctx, dt):
        dt = _table_gradient(ctx, dt)
        if dt is None:
            return None, None, None
        return pack_level_pair_bwd(dt, ctx.num_groups), None, None


def pack_level_pair(feat: torch.Tensor, num_groups: int,
                    table_grad: TableGrad = None) -> torch.Tensor:
    """``[M, H, W, C] -> [M, H, G, W+1, Cg]``, differentiable. A CPU tensor
    takes the plain versions; a CUDA tensor launches the kernels (or
    raises). ``table_grad`` as for :func:`pack_level`."""
    return _PackLevelPair.apply(feat, num_groups, table_grad)


pack_level_pair.launches = 0  # forward launches (_pack_level_pair_cuda)


def pack_level_pair_bwd(dt: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The pair pack's adjoint on its own: CPU -> plain version, CUDA ->
    kernel (or raises)."""
    if dt.device.type == "cpu":
        return pack_level_pair_bwd_plain(dt, num_groups)
    return _pack_level_pair_bwd_cuda(dt, num_groups)


pack_level_pair_bwd.launches = 0  # counted in _pack_level_pair_bwd_cuda

_BOUND = set()


def _lib(name: str):
    lib = build.load(name)
    if name not in _BOUND:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for entry, extra in (("_level", []), ("_level_bwd", [ci])):
            fn = getattr(lib, name + entry)
            fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, *extra, vp]
            fn.restype = ci
        _BOUND.add(name)
    return lib


def _vector_bytes(name: str, half_row: int, *tensors) -> int:
    vec = next((v for v in (16, 8, 4, 2)
                if half_row % v == 0
                and all(t.data_ptr() % v == 0 for t in tensors)), None)
    if vec is None:
        raise ValueError(f"{name}: a {half_row}-byte half-row has no "
                         "2/4/8/16-byte vector width")
    return vec


def _call(name: str, entry: str, src: torch.Tensor, dst: torch.Tensor,
          m: int, h: int, w: int, g: int, half_row: int) -> None:
    """Launch ``csrc/<name>.cu``'s ``<name><entry>`` on the current stream."""
    vec = _vector_bytes(name, half_row, src, dst)
    # the adjoints also take the element type (the y-fold one adds)
    extra = [int(src.dtype == torch.bfloat16)] if entry == "_level_bwd" else []
    lib = _lib(name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = getattr(lib, name + entry)(
            src.data_ptr(), dst.data_ptr(), m, h, w, g, half_row, vec,
            *extra, stream)
    build.check(lib, name, rc)


def _launch(name: str, feat: torch.Tensor, num_groups: int,
            row_groups: int) -> torch.Tensor:
    """Check ``feat``, allocate ``[M, H, G, W+1, row_groups*Cg]`` and launch
    ``csrc/<name>.cu``'s ``<name>_level`` on the current stream."""
    if not feat.is_cuda:
        raise ValueError(f"{name}: no kernel for device {feat.device}")
    if feat.dim() != 4:
        raise ValueError(f"{name}: feat must be [M, H, W, C], got "
                         f"{tuple(feat.shape)}")
    if not feat.is_contiguous():
        raise ValueError(f"{name}: feat must be contiguous")
    m, h, w, c = feat.shape
    g = num_groups
    if c % g:
        raise ValueError(f"{name}: C={c} is not divisible by G={g}")
    cg = c // g
    out = torch.empty((m, h, g, w + 1, row_groups * cg), dtype=feat.dtype,
                      device=feat.device)
    _call(name, "_level", feat, out, m, h, w, g, cg * feat.element_size())
    return out


def _launch_bwd(name: str, dt: torch.Tensor, num_groups: int,
                row_groups: int) -> torch.Tensor:
    """Check the table gradient ``[M, H, G, W+1, row_groups*Cg]``, allocate
    ``[M, H, W, C]`` and launch ``<name>_level_bwd`` on the current stream."""
    if not dt.is_cuda:
        raise ValueError(f"{name}: no kernel for device {dt.device}")
    if dt.dim() != 5 or dt.shape[2] != num_groups \
            or dt.shape[4] % row_groups or dt.shape[3] < 2:
        raise ValueError(f"{name}: the table gradient must be [M, H, "
                         f"{num_groups}, W+1, {row_groups}*Cg], got "
                         f"{tuple(dt.shape)}")
    if row_groups == 2 and dt.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the adjoint adds in bf16 or fp32, not "
                         f"{dt.dtype}")
    dt = dt.contiguous()
    m, h, g, w1, row = dt.shape
    cg = row // row_groups
    out = torch.empty((m, h, w1 - 1, g * cg), dtype=dt.dtype,
                      device=dt.device)
    _call(name, "_level_bwd", dt, out, m, h, w1 - 1, g,
          cg * dt.element_size())
    return out


def _pack_level_cuda(feat: torch.Tensor, num_groups: int) -> torch.Tensor:
    out = _launch("msmv_pack", feat, num_groups, 2)
    pack_level.launches += 1
    return out


def _pack_level_pair_cuda(feat: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    out = _launch("msmv_pack_pair", feat, num_groups, 1)
    pack_level_pair.launches += 1
    return out


def _pack_level_bwd_cuda(dt: torch.Tensor, num_groups: int) -> torch.Tensor:
    out = _launch_bwd("msmv_pack", dt, num_groups, 2)
    pack_level_bwd.launches += 1
    return out


def _pack_level_pair_bwd_cuda(dt: torch.Tensor,
                              num_groups: int) -> torch.Tensor:
    out = _launch_bwd("msmv_pack_pair", dt, num_groups, 1)
    pack_level_pair_bwd.launches += 1
    return out
