"""Carry the JAX package's weights into the port.

The port's modules use the reference state-dict key names (``img_backbone.*``,
``img_neck.*``, ``pts_bbox_head.*``), so :func:`state_dict_from_jax` is the
inverse of the JAX package's torch-checkpoint porting
(``utils/checkpoint_io.py::_port_resnet``, ``_port_vovnet``, ``_port_fpn``,
``_port_sparsebev_head``): Linear kernels ``[in, out]`` are transposed, conv
kernels go from HWIO to OIHW, ``in_proj_weight`` is transposed, and the BN
``scale/bias`` params and ``mean/var`` statistics become
``weight/bias/running_mean/running_var``. :func:`jax_trees_from_state_dict`
goes back: parameters or gradients under the port's names into the JAX tree
layout.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

_HEAD = "pts_bbox_head."
_LAYER = _HEAD + "transformer.decoder.decoder_layer."


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _conv(sd, dst, kernel, bias=None):
    sd[f"{dst}.weight"] = _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))
    if bias is not None:
        sd[f"{dst}.bias"] = _t(bias)


def _bn(sd, dst, p, s):
    sd[f"{dst}.weight"] = _t(p["scale"])
    sd[f"{dst}.bias"] = _t(p["bias"])
    sd[f"{dst}.running_mean"] = _t(s["mean"])
    sd[f"{dst}.running_var"] = _t(s["var"])


def _linear(sd, dst, p):
    lin = p["linear"]
    sd[f"{dst}.weight"] = _t(np.transpose(np.asarray(lin["kernel"])))
    if "bias" in lin:
        sd[f"{dst}.bias"] = _t(lin["bias"])


def _ln(sd, dst, p):
    sd[f"{dst}.weight"] = _t(p["scale"])
    sd[f"{dst}.bias"] = _t(p["bias"])


def _resnet(sd, params, stats, prefix="img_backbone."):
    _conv(sd, f"{prefix}conv1", params["conv1"]["kernel"])
    _bn(sd, f"{prefix}bn1", params["bn1"], stats["bn1"])
    block_re = re.compile(r"^layer(\d+)_(\d+)$")
    for name in params:
        m = block_re.match(name)
        if not m:
            continue
        dst = f"{prefix}layer{m.group(1)}.{m.group(2)}"
        p, s = params[name], stats[name]
        for j in (1, 2, 3):
            _conv(sd, f"{dst}.conv{j}", p[f"conv{j}"]["kernel"])
            _bn(sd, f"{dst}.bn{j}", p[f"bn{j}"], s[f"bn{j}"])
        if "downsample_conv" in p:
            _conv(sd, f"{dst}.downsample.0", p["downsample_conv"]["kernel"])
            _bn(sd, f"{dst}.downsample.1", p["downsample_bn"],
                s["downsample_bn"])


def _vovnet(sd, params, stats, prefix="img_backbone."):
    """JAX ``stem{k}`` / ``stage{n}_block{b}`` -> the reference's
    ``stem.stem_{k}/...`` / ``stage{n}.OSA{n}_{b+1}....`` keys."""
    def convbn(dst, p, s):
        _conv(sd, f"{dst}/conv", p["conv"]["kernel"])
        _bn(sd, f"{dst}/norm", p["norm"], s["norm"])

    for k in (1, 2, 3):
        convbn(f"{prefix}stem.stem_{k}", params[f"stem{k}"],
               stats[f"stem{k}"])
    block_re = re.compile(r"^stage(\d+)_block(\d+)$")
    for name in params:
        m = block_re.match(name)
        if not m:
            continue
        n, b = m.group(1), int(m.group(2)) + 1
        tag = f"OSA{n}_{b}"
        dst = f"{prefix}stage{n}.{tag}"
        p, s = params[name], stats[name]
        i = 0
        while f"layer{i}" in p:
            convbn(f"{dst}.layers.{i}.{tag}_{i}", p[f"layer{i}"],
                   s[f"layer{i}"])
            i += 1
        convbn(f"{dst}.concat.{tag}_concat", p["concat"], s["concat"])
        if "ese" in p:
            _conv(sd, f"{dst}.ese.fc", p["ese"]["fc"]["kernel"],
                  p["ese"]["fc"]["bias"])


def _fpn(sd, params, prefix="img_neck."):
    i = 0
    while f"lateral_conv{i}" in params:
        for src, dst in ((f"lateral_conv{i}", f"lateral_convs.{i}"),
                         (f"fpn_conv{i}", f"fpn_convs.{i}")):
            _conv(sd, f"{prefix}{dst}.conv", params[src]["kernel"],
                  params[src].get("bias"))
        i += 1


def _head(sd, params):
    sd[f"{_HEAD}init_query_bbox.weight"] = _t(params["init_query_bbox"])
    sd[f"{_HEAD}label_enc.weight"] = _t(params["label_enc"]["embedding"])
    lay = params["transformer"]["decoder_layer"]
    _linear(sd, f"{_LAYER}position_encoder.0", lay["pos_fc1"])
    _ln(sd, f"{_LAYER}position_encoder.1", lay["pos_ln1"])
    _linear(sd, f"{_LAYER}position_encoder.3", lay["pos_fc2"])
    _ln(sd, f"{_LAYER}position_encoder.4", lay["pos_ln2"])
    sa = lay["self_attn"]
    _linear(sd, f"{_LAYER}self_attn.gen_tau", sa["gen_tau"])
    att = sa["attention"]
    attn = f"{_LAYER}self_attn.attention.attn"
    sd[f"{attn}.in_proj_weight"] = _t(
        np.transpose(np.asarray(att["in_proj_weight"])))
    sd[f"{attn}.in_proj_bias"] = _t(att["in_proj_bias"])
    _linear(sd, f"{attn}.out_proj", att["out_proj"])
    for name in ("sampling_offset", "scale_weights"):
        _linear(sd, f"{_LAYER}sampling.{name}", lay["sampling"][name])
    for name in ("parameter_generator", "out_proj"):
        _linear(sd, f"{_LAYER}mixing.{name}", lay["mixing"][name])
    _linear(sd, f"{_LAYER}ffn.layers.0.0", lay["ffn"]["fc1"])
    _linear(sd, f"{_LAYER}ffn.layers.1", lay["ffn"]["fc2"])
    for i in (1, 2, 3):
        _ln(sd, f"{_LAYER}norm{i}", lay[f"norm{i}"])
    n_cls = sum(1 for k in lay if re.fullmatch(r"cls_fc\d+", k))
    for i in range(n_cls):
        _linear(sd, f"{_LAYER}cls_branch.{3 * i}", lay[f"cls_fc{i}"])
        _ln(sd, f"{_LAYER}cls_branch.{3 * i + 1}", lay[f"cls_ln{i}"])
    _linear(sd, f"{_LAYER}cls_branch.{3 * n_cls}", lay["cls_out"])
    n_reg = sum(1 for k in lay if re.fullmatch(r"reg_fc\d+", k))
    for i in range(n_reg):
        _linear(sd, f"{_LAYER}reg_branch.{2 * i}", lay[f"reg_fc{i}"])
    _linear(sd, f"{_LAYER}reg_branch.{2 * n_reg}", lay["reg_out"])


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Dict[str, Any]) -> "OrderedDict":
    """The port's ``state_dict`` from the JAX detector's ``{params,
    batch_stats}`` trees (leaves as numpy arrays): subtrees ``backbone``
    (ResNet, or VoVNet when it holds ``stem1``), ``neck`` (FPN) and
    ``head`` (SparseBEVHead)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if "backbone" in params:
        bb = _vovnet if "stem1" in params["backbone"] else _resnet
        bb(sd, params["backbone"], batch_stats["backbone"])
    if "neck" in params:
        _fpn(sd, params["neck"])
    if "head" in params:
        _head(sd, params["head"])
    return sd


_LEAF_STRIDE = 1 << 40      # index trees: value = leaf number * stride + element


def _index_tree(tree, leaves):
    """A copy of the nested dict ``tree`` whose leaves are int64 arrays that
    number their own elements (``leaf * _LEAF_STRIDE + flat index``);
    ``leaves`` collects each leaf's (path, shape)."""
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = _index_tree(val, leaves)
            continue
        shape = tuple(np.shape(val))
        base = len(leaves) * _LEAF_STRIDE
        out[key] = (np.arange(int(np.prod(shape)), dtype=np.int64)
                    .reshape(shape) + base)
        leaves.append(shape)
    return out


def _fill_tree(tree, leaves_flat, counter):
    out = {}
    for key, val in tree.items():
        if hasattr(val, "items"):
            out[key] = _fill_tree(val, leaves_flat, counter)
        else:
            out[key] = leaves_flat[counter[0]]
            counter[0] += 1
    return out


def jax_trees_from_state_dict(tensors: Dict[str, torch.Tensor],
                              params: Dict[str, Any],
                              batch_stats: Dict[str, Any]):
    """The inverse of :func:`state_dict_from_jax`, for any tensors under the
    port's parameter / buffer names: parameters, or their gradients (to hold
    ``param.grad`` against a JAX gradient tree leaf by leaf). ``params`` and
    ``batch_stats`` give the layout (only their structure and shapes are
    read). Returns ``(params_tree, batch_stats_tree)`` of fp32 numpy arrays;
    a leaf whose tensor is missing from ``tensors`` (buffers, when only
    gradients are given) comes back as ``None``.

    The name and layout map is not written twice: the forward conversion
    runs on index arrays, which tells for every element of every port tensor
    which element of which JAX leaf it is."""
    leaves = []
    p_idx = _index_tree(params, leaves)
    n_params = len(leaves)
    s_idx = _index_tree(batch_stats, leaves)
    index_sd = state_dict_from_jax(p_idx, s_idx)
    flat = [None] * len(leaves)
    for name, idx in index_sd.items():
        if name not in tensors or tensors[name] is None:
            continue
        idx = idx.numpy().reshape(-1)
        leaf = int(idx[0] // _LEAF_STRIDE)
        if flat[leaf] is None:
            flat[leaf] = np.zeros(int(np.prod(leaves[leaf])), np.float32)
        flat[leaf][idx % _LEAF_STRIDE] = \
            tensors[name].detach().float().cpu().numpy().reshape(-1)
    flat = [None if a is None else a.reshape(shape)
            for a, shape in zip(flat, leaves)]
    counter = [0]
    p_tree = _fill_tree(params, flat, counter)
    assert counter[0] == n_params
    return p_tree, _fill_tree(batch_stats, flat, counter)
