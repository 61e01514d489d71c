"""JAX (flax) STTran and DSG-DETR params -> the port's state_dict.

The inverses of nl_vsgg_tpu/models/convert_ref.py::convert_sttran and
::convert_dsg_detr (DSG-DETR's sgcls tracklet head included), written
against plain nested dicts of numpy arrays (no JAX import): this is how
weights trained by the JAX package cross to the port. The port's names and
layouts are the torch reference's, so the same state_dict loads a
reference-trained checkpoint too. Conversions:

  * Dense kernel (in, out) -> Linear weight (out, in)
  * NHWC conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  * the channel-axis `union_func1` Dense -> a (256, C, 1, 1) conv weight
  * `vr_fc`'s input flatten order (7, 7, C) -> (C, 7, 7)
  * split q/k/v projections -> MultiheadAttention's packed in_proj
  * BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: flax leaves are read-only


def _lin(sd: dict, p: str, d: Mapping) -> None:
    sd[p + ".weight"] = _t(np.asarray(d["kernel"]).T)
    sd[p + ".bias"] = _t(d["bias"])


def _ln(sd: dict, p: str, d: Mapping) -> None:
    sd[p + ".weight"] = _t(d["scale"])
    sd[p + ".bias"] = _t(d["bias"])


def _bn(sd: dict, p: str, d: Mapping, stats: Mapping) -> None:
    _ln(sd, p, d)
    sd[p + ".running_mean"] = _t(stats["mean"])
    sd[p + ".running_var"] = _t(stats["var"])
    sd[p + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(sd: dict, p: str, d: Mapping) -> None:
    sd[p + ".weight"] = _t(np.asarray(d["kernel"]).transpose(3, 2, 0, 1))
    sd[p + ".bias"] = _t(d["bias"])


def _mha(sd: dict, p: str, d: Mapping) -> None:
    proj = [d[n] for n in ("q_proj", "k_proj", "v_proj")]
    sd[p + ".in_proj_weight"] = _t(np.concatenate([np.asarray(x["kernel"]).T for x in proj]))
    sd[p + ".in_proj_bias"] = _t(np.concatenate([np.asarray(x["bias"]) for x in proj]))
    _lin(sd, p + ".out_proj", d["out_proj"])


def _encoder_layer(sd: dict, p: str, lay: Mapping) -> None:
    _mha(sd, p + ".self_attn", lay["self_attn"])
    for n in ("linear1", "linear2"):
        _lin(sd, f"{p}.{n}", lay[n])
    for n in ("norm1", "norm2"):
        _ln(sd, f"{p}.{n}", lay[n])


def _common_head(sd: dict, params: Mapping, batch_stats: Mapping) -> None:
    """What STTran and DSG-DETR share: the weak-supervision object
    classifier (when the tree has one), the fusion layers and the heads."""
    oc = params.get("object_classifier")
    if oc is not None and "enc_0" not in oc:
        ocs = batch_stats["object_classifier"]
        p = "object_classifier"
        sd[p + ".obj_embed.weight"] = _t(oc["obj_embed"])
        _bn(sd, p + ".pos_embed.0", oc["pos_bn"], ocs["pos_bn"])
        _lin(sd, p + ".pos_embed.1", oc["pos_fc"])
        _lin(sd, p + ".decoder_lin.0", oc["decoder_fc1"])
        _bn(sd, p + ".decoder_lin.1", oc["decoder_bn"], ocs["decoder_bn"])
        _lin(sd, p + ".decoder_lin.3", oc["decoder_fc2"])
    uf = params["union_func1"]
    sd["union_func1.weight"] = _t(np.asarray(uf["kernel"]).T[:, :, None, None])
    sd["union_func1.bias"] = _t(uf["bias"])
    sc, scs = params["spatial_conv"], batch_stats["spatial_conv"]
    _conv(sd, "conv.0", sc["conv1"])
    _bn(sd, "conv.2", sc["bn1"], scs["bn1"])
    _conv(sd, "conv.4", sc["conv2"])
    _bn(sd, "conv.6", sc["bn2"], scs["bn2"])
    _lin(sd, "subj_fc", params["subj_fc"])
    _lin(sd, "obj_fc", params["obj_fc"])
    w = np.asarray(params["vr_fc"]["kernel"]).T  # (512, 7*7*256), input (h, w, c)
    out = w.shape[0]
    sd["vr_fc.weight"] = _t(w.reshape(out, 7, 7, 256).transpose(0, 3, 1, 2).reshape(out, -1))
    sd["vr_fc.bias"] = _t(params["vr_fc"]["bias"])
    sd["obj_embed.weight"] = _t(params["obj_embed"])
    sd["obj_embed2.weight"] = _t(params["obj_embed2"])
    for n in ("a_rel_compress", "s_rel_compress", "c_rel_compress"):
        _lin(sd, n, params[n])


def sttran_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """flax STTran `params` / `batch_stats` trees -> port state_dict."""
    sd: dict[str, torch.Tensor] = {}
    _common_head(sd, params, batch_stats)
    tr = params["glocal_transformer"]
    g = "glocal_transformer"
    sd[g + ".position_embedding.weight"] = _t(tr["position_embedding"])
    i = 0
    while f"enc_{i}" in tr:
        _encoder_layer(sd, f"{g}.local_attention.layers.{i}", tr[f"enc_{i}"])
        i += 1
    i = 0
    while f"dec_{i}" in tr:
        p, lay = f"{g}.global_attention.layers.{i}", tr[f"dec_{i}"]
        _mha(sd, p + ".multihead2", lay["multihead2"])
        for n in ("linear1", "linear2"):
            _lin(sd, f"{p}.{n}", lay[n])
        _ln(sd, p + ".norm3", lay["norm3"])
        i += 1
    return sd


def dsg_detr_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """flax DSGDETR `params` / `batch_stats` trees -> port state_dict: the
    reference's keys for the shared head and `local_transformer.layers.{i}`
    / `global_transformer.layers.{i}`; the sgcls tracklet head (which has no
    reference layout) under the JAX module's names, `object_classifier.`
    `obj_embed`, `pos_bn`, `pos_fc`, `enc_{i}`, `decoder_fc1`, `decoder_bn`,
    `decoder_fc2`."""
    sd: dict[str, torch.Tensor] = {}
    _common_head(sd, params, batch_stats)
    oc = params.get("object_classifier")
    if oc is not None and "enc_0" in oc:
        ocs, p = batch_stats["object_classifier"], "object_classifier"
        sd[p + ".obj_embed"] = _t(oc["obj_embed"])
        _bn(sd, p + ".pos_bn", oc["pos_bn"], ocs["pos_bn"])
        _lin(sd, p + ".pos_fc", oc["pos_fc"])
        i = 0
        while f"enc_{i}" in oc:
            _encoder_layer(sd, f"{p}.enc_{i}", oc[f"enc_{i}"])
            i += 1
        _lin(sd, p + ".decoder_fc1", oc["decoder_fc1"])
        _bn(sd, p + ".decoder_bn", oc["decoder_bn"], ocs["decoder_bn"])
        _lin(sd, p + ".decoder_fc2", oc["decoder_fc2"])
    for stack, name in (("local", "local_transformer"), ("global", "global_transformer")):
        i = 0
        while f"{stack}_{i}" in params:
            _encoder_layer(sd, f"{name}.layers.{i}", params[f"{stack}_{i}"])
            i += 1
    return sd
