"""Weights into the port's AttrRCNNModule state_dict.

  * `from_maskrcnn_state_dict(sd)`: a VinVL / maskrcnn_benchmark AttrRCNN
    checkpoint (vinvl_vg_x152c4.pth's state dict), read as
    nl_vsgg_tpu/detector/convert.py::convert_state_dict reads it. Convs and
    linears keep torch's OIHW / (out, in) layouts and grouped conv2 kernels
    their (C, C/32, 3, 3) shape; FrozenBatchNorm2d folds into
    (scale, bias) with the reference's eps=0 form
    scale = weight / sqrt(running_var). The attribute head
    (roi_heads.attribute.*) is not used by any path and is skipped.
  * `to_maskrcnn_state_dict(sd)`: the inverse, a port state_dict in the
    checkpoint's layout (FrozenBatchNorm2d with running stats 0 and 1);
  * `from_jax_variables(variables)`: the JAX package's {'params': ...}
    tree (numpy leaves): HWIO -> OIHW, Dense (in, out) -> (out, in), and the
    EFF_GROUPS block-diagonal conv2 kernels unpacked back to
    (C, C/32, 3, 3); a kernel already in that compact layout (an .npz
    written before the JAX package packed its groups) passes as it is;
  * `to_jax_variables(sd)`: the inverse, the JAX tree with its conv2
    kernels packed per stage (`NPZ_EFF_GROUPS`), the only place the port
    packs: the .npz files carry the JAX package's layout;
  * `save_npz` / `load_npz` / `load_checkpoint`: the JAX package's .npz
    checkpoint (nl_vsgg_tpu/detector/convert.py:104-161), flat '/'-joined
    keys, the same arrays, so either package reads the other's file;
    `load_checkpoint(path)` reads an .npz or a VinVL .pth into the port's
    state_dict.

Name mapping (port <- checkpoint):

  backbone.stem_conv1 / stem_bn1            <- backbone.body.stem.conv1 / bn1
  backbone.layer{k}.block{i}.conv{j}, bn{j} <- backbone.body.layer{k}.{i}.conv{j}, bn{j}
  ... .downsample_conv / downsample_bn      <- ... .downsample.0 / .downsample.1
  rpn_head.{conv,cls_logits,bbox_pred}      <- rpn.head.*
  box_head.head.layer4.block{i}.*           <- roi_heads.box.feature_extractor.head.layer4.{i}.*
  box_head.predictor.{cls_score,bbox_pred}  <- roi_heads.box.predictor.*
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .resnet import R152_BLOCKS

GROUPS = 32


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _t(a) -> torch.Tensor:
    return torch.tensor(_np(a))  # a copy: numpy / flax leaves may be read-only


def _fold_bn(out: dict, dst: str, sd: Mapping, src: str) -> None:
    w, b = _np(sd[src + ".weight"]), _np(sd[src + ".bias"])
    mean, var = _np(sd[src + ".running_mean"]), _np(sd[src + ".running_var"])
    scale = w / np.sqrt(var)
    out[dst + ".scale"] = _t(scale)
    out[dst + ".bias"] = _t(b - mean * scale)


def _copy(out: dict, dst: str, sd: Mapping, src: str, bias: bool = False) -> None:
    out[dst + ".weight"] = _t(sd[src + ".weight"])
    if bias:
        out[dst + ".bias"] = _t(sd[src + ".bias"])


def _stage(out: dict, dst: str, sd: Mapping, src: str, n_blocks: int) -> None:
    for i in range(n_blocks):
        d, s = f"{dst}.block{i}", f"{src}.{i}"
        for j in (1, 2, 3):
            _copy(out, f"{d}.conv{j}", sd, f"{s}.conv{j}")
            _fold_bn(out, f"{d}.bn{j}", sd, f"{s}.bn{j}")
        if s + ".downsample.0.weight" in sd:
            _copy(out, f"{d}.downsample_conv", sd, f"{s}.downsample.0")
            _fold_bn(out, f"{d}.downsample_bn", sd, f"{s}.downsample.1")


def from_maskrcnn_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """VinVL checkpoint state dict (numpy or torch values) -> port state_dict."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    _copy(out, "backbone.stem_conv1", sd, "backbone.body.stem.conv1")
    _fold_bn(out, "backbone.stem_bn1", sd, "backbone.body.stem.bn1")
    for k in (1, 2, 3):
        _stage(out, f"backbone.layer{k}", sd, f"backbone.body.layer{k}", R152_BLOCKS[k - 1])
    for name in ("conv", "cls_logits", "bbox_pred"):
        _copy(out, f"rpn_head.{name}", sd, f"rpn.head.{name}", bias=True)
    _stage(out, "box_head.head.layer4", sd, "roi_heads.box.feature_extractor.head.layer4",
           R152_BLOCKS[3])
    for name in ("cls_score", "bbox_pred"):
        _copy(out, f"box_head.predictor.{name}", sd, f"roi_heads.box.predictor.{name}",
              bias=True)
    return out


def to_maskrcnn_state_dict(sd: Mapping) -> dict[str, torch.Tensor]:
    """The inverse of `from_maskrcnn_state_dict`: a port state_dict in the
    VinVL checkpoint's layout (float32, on the host). Each folded
    (scale, bias) becomes a FrozenBatchNorm2d of weight = scale, bias,
    running_mean 0 and running_var 1, which folds back to the same pair."""
    out: dict[str, torch.Tensor] = {}

    def put(dst: str, src: str, bias: bool = False) -> None:
        out[dst + ".weight"] = sd[src + ".weight"].detach().float().cpu()
        if bias:
            out[dst + ".bias"] = sd[src + ".bias"].detach().float().cpu()

    def bn(dst: str, src: str) -> None:
        scale = sd[src + ".scale"].detach().float().cpu()
        out.update({dst + ".weight": scale, dst + ".bias": sd[src + ".bias"].detach().float().cpu(),
                    dst + ".running_mean": torch.zeros_like(scale),
                    dst + ".running_var": torch.ones_like(scale)})

    def stage(dst: str, src: str, n_blocks: int) -> None:
        for i in range(n_blocks):
            d, s = f"{dst}.{i}", f"{src}.block{i}"
            for j in (1, 2, 3):
                put(f"{d}.conv{j}", f"{s}.conv{j}")
                bn(f"{d}.bn{j}", f"{s}.bn{j}")
            if s + ".downsample_conv.weight" in sd:
                put(f"{d}.downsample.0", f"{s}.downsample_conv")
                bn(f"{d}.downsample.1", f"{s}.downsample_bn")

    put("backbone.body.stem.conv1", "backbone.stem_conv1")
    bn("backbone.body.stem.bn1", "backbone.stem_bn1")
    for k in (1, 2, 3):
        stage(f"backbone.body.layer{k}", f"backbone.layer{k}", R152_BLOCKS[k - 1])
    for name in ("conv", "cls_logits", "bbox_pred"):
        put(f"rpn.head.{name}", f"rpn_head.{name}", bias=True)
    stage("roi_heads.box.feature_extractor.head.layer4", "box_head.head.layer4", R152_BLOCKS[3])
    for name in ("cls_score", "bbox_pred"):
        put(f"roi_heads.box.predictor.{name}", f"box_head.predictor.{name}", bias=True)
    return out


def unpack_grouped_kernel(w: np.ndarray, groups: int = GROUPS) -> np.ndarray:
    """The inverse of nl_vsgg_tpu/detector/resnet.py::pack_grouped_kernel:
    a block-diagonal HWIO kernel (3, 3, pack * C/groups, C) -> the grouped
    (3, 3, C/groups, C). Output group g's input rows sit at block g % pack."""
    kh, kw, cin, c = w.shape
    cg = c // groups
    if cin == cg:
        return w
    pack = cin // cg
    out = np.empty((kh, kw, cg, c), w.dtype)
    for g in range(groups):
        sub = g % pack
        out[..., g * cg:(g + 1) * cg] = w[:, :, sub * cg:(sub + 1) * cg, g * cg:(g + 1) * cg]
    return out


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def from_jax_variables(variables: Mapping, groups: int = GROUPS) -> dict[str, torch.Tensor]:
    """JAX AttrRCNNModule variables ({'params': ...}, numpy leaves; or those
    of a Stage / Bottleneck of `groups` groups) -> port state_dict."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables["params"]):
        a = _np(leaf)
        module, name = path.rsplit(".", 1)
        if name == "kernel":
            if a.ndim == 4:
                if module.endswith("conv2"):
                    a = unpack_grouped_kernel(a, groups)
                a = a.transpose(3, 2, 0, 1)
            else:
                a = a.T
            name = "weight"
        out[f"{module}.{name}"] = _t(np.ascontiguousarray(a))
    return out


# the JAX package's per-stage block-diagonal packing of the conv2 kernels
# (nl_vsgg_tpu/detector/resnet.py EFF_GROUPS): only the .npz files carry it
NPZ_EFF_GROUPS = {"layer1": 1, "layer2": 4, "layer3": 8, "layer4": 32}


def pack_grouped_kernel(w: np.ndarray, groups: int, eff_groups: int) -> np.ndarray:
    """A grouped HWIO kernel (kh, kw, C/groups, C) -> the block-diagonal
    (kh, kw, C/eff_groups, C) of the same convolution at eff_groups groups
    (nl_vsgg_tpu/detector/resnet.py::pack_grouped_kernel); the inverse of
    `unpack_grouped_kernel`."""
    if eff_groups == groups:
        return w
    if groups % eff_groups:
        raise ValueError(f"{groups} groups do not pack into {eff_groups}")
    kh, kw, cg, c = w.shape
    cg_out = c // groups
    pack = groups // eff_groups
    out = np.zeros((kh, kw, cg * pack, c), w.dtype)
    for g in range(groups):
        sub = g % pack
        out[:, :, sub * cg:(sub + 1) * cg, g * cg_out:(g + 1) * cg_out] = \
            w[:, :, :, g * cg_out:(g + 1) * cg_out]
    return out


def to_jax_variables(sd: Mapping[str, torch.Tensor], groups: int = GROUPS) -> dict:
    """Port state_dict -> the JAX AttrRCNNModule's {'params': ...} tree of
    float32 numpy arrays: OIHW -> HWIO (conv2 kernels packed per stage,
    NPZ_EFF_GROUPS), (out, in) -> Dense (in, out), FrozenBN (scale, bias)
    as they are."""
    params: dict = {}
    for key, t in sd.items():
        module, name = key.rsplit(".", 1)
        a = _np(t)
        if name == "weight":
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
                if module.endswith("conv2"):
                    stage = next(p for p in module.split(".") if p.startswith("layer"))
                    a = pack_grouped_kernel(a, groups, NPZ_EFF_GROUPS[stage])
            else:
                a = a.T
            name = "kernel"
        node = params
        for part in module.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": params}


def save_npz(sd: Mapping[str, torch.Tensor], dst: str) -> int:
    """Write a port state_dict as the JAX package's .npz checkpoint: the
    `to_jax_variables` tree flattened to '/'-joined keys (params/backbone/
    stem_conv1/kernel, ...), compressed. Returns the array count."""
    flat = {key.replace(".", "/"): leaf for key, leaf in _flatten(to_jax_variables(sd))}
    np.savez_compressed(dst, **dict(sorted(flat.items())))
    return len(flat)


def load_npz(path: str) -> dict:
    """The nested variables dict of an .npz written by `save_npz` or by the
    JAX package's tools/convert_vinvl.py."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The port's detector state_dict from an .npz (either package's,
    conv2 kernels packed or compact) or from a VinVL / maskrcnn .pth (its
    'model' or 'state_dict' entry, or the dict itself)."""
    if path.endswith(".npz"):
        return from_jax_variables(load_npz(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return from_maskrcnn_state_dict(ckpt.get("model", ckpt.get("state_dict", ckpt)))
