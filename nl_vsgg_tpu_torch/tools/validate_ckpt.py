"""Per-stage activation validation of checkpoint conversions (port of
tools/validate_ckpt.py).

    python -m nl_vsgg_tpu_torch.tools.validate_ckpt vinvl path/to/vinvl_vg_x152c4.pth
    python -m nl_vsgg_tpu_torch.tools.validate_ckpt clip  path/to/LLM_cp.pt
        [--atol A] [--device cpu]

It prints the max-abs activation difference per stage between

  * a minimal functional-torch evaluation of the checkpoint's own tensors
    (ground truth: exactly the stored weights, torch conv/linear semantics,
    FrozenBatchNorm applied as stored, LoRA applied at run time),
  * the port's modules on the converted weights (folded FrozenBN, the
    grouped-conv and attention kernels on a GPU, merged LoRA),

both on `--device` (default: the GPU, which raises without one).

vinvl stages: stem -> C2 -> C3 -> C4 (backbone), RPN head, C5 box head,
predictor. Attribute-head keys (`roi_heads.attribute.*`) and
`rpn.anchor_generator.*` buffers are not converted or validated: no
NL-VSGG path consumes them (boxes and `box_features` only, ref
NL-VSGG/data_preprocess/extract_bbox_features_ag.py:110-119; anchors are
recomputed closed-form) — they are reported as a skip count. clip: the two
towers' embeddings (`pipelines.clip.validate_checkpoint`).

Exits non-zero if any stage diff exceeds --atol RELATIVE to the stage's
activation scale — the check is `max|dx| <= atol * max(1, |ref|max)`, so a
C4 map peaking at 50 passes up to 5e-2 absolute at the default 1e-3.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..detector.attr_rcnn import AttrRCNNModule
from ..detector.convert import from_maskrcnn_state_dict
from ..device import resolve_device
from ..pipelines import clip

ATTR_SKIP_PREFIXES = ("roi_heads.attribute.", "rpn.anchor_generator.")


# ---------------------------------------------------------------- torch side
def _t_conv(x, sd, key, stride=1, padding=0, groups=1):
    return F.conv2d(x, sd[key + ".weight"], sd.get(key + ".bias"), stride=stride,
                    padding=padding, groups=groups)


def _t_frozen_bn(x, sd, key):
    w, b = sd[key + ".weight"], sd[key + ".bias"]
    mean, var = sd[key + ".running_mean"], sd[key + ".running_var"]
    scale = w / var.sqrt()
    shift = b - mean * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _t_bottleneck(x, sd, p, stride, groups=32):
    h = F.relu(_t_frozen_bn(_t_conv(x, sd, p + ".conv1"), sd, p + ".bn1"))
    h = F.relu(_t_frozen_bn(
        _t_conv(h, sd, p + ".conv2", stride=stride, padding=1, groups=groups),
        sd, p + ".bn2"))
    h = _t_frozen_bn(_t_conv(h, sd, p + ".conv3"), sd, p + ".bn3")
    if p + ".downsample.0.weight" in sd:
        idn = _t_frozen_bn(_t_conv(x, sd, p + ".downsample.0", stride=stride),
                           sd, p + ".downsample.1")
    else:
        idn = x
    return F.relu(h + idn)


def _t_stage(x, sd, prefix, n_blocks, first_stride):
    for i in range(n_blocks):
        x = _t_bottleneck(x, sd, f"{prefix}.{i}", first_stride if i == 0 else 1)
    return x


@torch.inference_mode()
def torch_stages(sd, image, crop, pooled) -> dict[str, np.ndarray]:
    """Ground-truth per-stage activations (NCHW) from the raw checkpoint
    tensors on their device."""
    out = {}
    h = _t_frozen_bn(_t_conv(image, sd, "backbone.body.stem.conv1", stride=2, padding=3),
                     sd, "backbone.body.stem.bn1")
    out["stem"] = h
    h = F.max_pool2d(F.relu(h), 3, stride=2, padding=1)
    h = _t_stage(h, sd, "backbone.body.layer1", 3, 1)
    out["C2"] = h
    h = _t_stage(h, sd, "backbone.body.layer2", 8, 2)
    out["C3"] = h
    h = _t_stage(h, sd, "backbone.body.layer3", 36, 2)
    out["C4"] = h
    t = F.relu(_t_conv(h, sd, "rpn.head.conv", padding=1))
    out["rpn_logits"] = _t_conv(t, sd, "rpn.head.cls_logits")
    out["rpn_deltas"] = _t_conv(t, sd, "rpn.head.bbox_pred")
    out["C5"] = _t_stage(crop, sd, "roi_heads.box.feature_extractor.head.layer4", 3, 2)
    out["cls_score"] = F.linear(pooled, sd["roi_heads.box.predictor.cls_score.weight"],
                                sd["roi_heads.box.predictor.cls_score.bias"])
    out["bbox_pred"] = F.linear(pooled, sd["roi_heads.box.predictor.bbox_pred.weight"],
                                sd["roi_heads.box.predictor.bbox_pred.bias"])
    return {k: v.float().cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------- port side
@torch.inference_mode()
def port_stages(state_dict, image, crop, pooled) -> dict[str, np.ndarray]:
    """The same cut points through the port's detector modules on the
    converted weights (NCHW in channels_last memory, as the detector runs
    them), on the inputs' device."""
    with torch.device("meta"):
        m = AttrRCNNModule()
    m.to_empty(device=image.device).load_state_dict(dict(state_dict))
    m.eval().to(memory_format=torch.channels_last)
    bb, out = m.backbone, {}
    x = image.contiguous(memory_format=torch.channels_last)
    out["stem"] = h = bb.stem_bn1(bb.stem_conv1(x))
    h = F.max_pool2d(F.relu(h), 3, 2, 1)
    out["C2"] = h = bb.layer1(h)
    out["C3"] = h = bb.layer2(h)
    out["C4"] = h = bb.layer3(h)
    t = F.relu(m.rpn_head.conv(h))
    out["rpn_logits"] = m.rpn_head.cls_logits(t)
    out["rpn_deltas"] = m.rpn_head.bbox_pred(t)
    out["C5"] = m.box_head.head(crop.contiguous(memory_format=torch.channels_last))
    # the predictor mean-pools (N, 7, 7, 2048): feed the pooled vector
    # broadcast so both sides see identical linear inputs
    n, c = pooled.shape
    out["cls_score"], out["bbox_pred"] = m.box_head.predictor(
        pooled[:, None, None, :].expand(n, 7, 7, c))
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def validate_vinvl(sd, atol=1e-3, image_hw=(96, 128), seed=0, log=print,
                   device=None) -> dict[str, float]:
    """sd: raw torch state dict (tensors or arrays). Returns {stage:
    max_abs_diff, '_ok': 0/1}."""
    dev = resolve_device(device)
    sd = {k.removeprefix("module."): torch.as_tensor(np.asarray(v)).float()
          for k, v in sd.items()}
    skipped = [k for k in sd if k.startswith(ATTR_SKIP_PREFIXES)]
    port_sd = from_maskrcnn_state_dict({k: v for k, v in sd.items() if k not in set(skipped)})

    rng = np.random.default_rng(seed)
    image = torch.as_tensor(rng.standard_normal((1, 3, *image_hw)).astype(np.float32), device=dev)
    crop = torch.as_tensor(rng.standard_normal((2, 1024, 14, 14)).astype(np.float32), device=dev)
    pooled = torch.as_tensor(rng.standard_normal((2, 2048)).astype(np.float32), device=dev)

    ref = torch_stages({k: v.to(dev) for k, v in sd.items()}, image, crop, pooled)
    got = port_stages(port_sd, image, crop, pooled)
    diffs = {}
    ok = True
    for stage in ref:
        d = float(np.abs(ref[stage] - got[stage]).max())
        scale = float(np.abs(ref[stage]).max()) or 1.0
        diffs[stage] = d
        status = "ok" if d <= atol * max(1.0, scale) else "FAIL"
        ok &= status == "ok"
        log(f"  {stage:<10} max|Δ| = {d:.3e}  (|ref|max {scale:.2e})  {status}")
    log(f"  skipped {len(skipped)} attribute/anchor keys (unused by NL-VSGG)")
    diffs["_ok"] = float(ok)
    return diffs


def main(argv=None) -> int:
    """The exit code: 0 when every stage passed, 1 otherwise."""
    p = argparse.ArgumentParser(description="checkpoint conversion validation")
    p.add_argument("kind", choices=["vinvl", "clip"])
    p.add_argument("ckpt", help=".pth/.pt checkpoint path")
    p.add_argument("--atol", type=float, default=1e-3,
                   help="per-stage threshold, RELATIVE to the stage's max |ref| activation (>=1)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU, which raises without one)")
    args = p.parse_args(argv)
    if args.kind == "vinvl":
        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
        diffs = validate_vinvl(sd, atol=args.atol, device=args.device)
    else:
        diffs = clip.validate_checkpoint(args.ckpt, atol=args.atol, device=args.device)
    return 0 if diffs.pop("_ok", 0.0) else 1


if __name__ == "__main__":
    sys.exit(main())
