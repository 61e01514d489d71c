"""Convert a reference-trained relation-model checkpoint into a port
checkpoint (port of tools/convert_relation_ckpt.py):

    python -m nl_vsgg_tpu_torch.tools.convert_relation_ckpt --ckpt sttran.tar \
        --out ckpt_dir [--cfg cfg.yml] [--family sttran|dsg_detr] [--device cpu]
    python -m nl_vsgg_tpu_torch.tools.test_sttran --model_path ckpt_dir

The reference saves `{'state_dict': ...}` torch checkpoints; a bare state
dict is read too. The port's modules take the reference's key names and
layouts, so the weights load as they are: the model family (STTran or
DSG-DETR), the encoder / decoder depths and the feature width are read
from the keys and shapes, the model is built, and its own keys load
strictly. Keys the model does not have at all are reported (the
reference's loaders use strict=False); a missing key, a key of one of the
model's modules that the model lacks, or a shape that differs raises,
naming them. The result is a step-0 port checkpoint (a fresh optimizer)
whose configs.json describes the detected architecture, read by
tools/test_sttran, tools/test_dsg_detr and tools/predict.
"""

from __future__ import annotations

import argparse
import re

import torch

from ..data import schema
from ..device import resolve_device
from ..train.state import create_train_state
from ..utils.checkpoint import load_model_state, save_checkpoint
from ..utils.config import load_config
from ..utils.logging import setup_logger
from . import train_dsg_detr, train_sttran

_DEPTH_KEYS = {"sttran": (r"glocal_transformer\.local_attention\.layers\.(\d+)\.",
                          r"glocal_transformer\.global_attention\.layers\.(\d+)\."),
               "dsg_detr": (r"local_transformer\.layers\.(\d+)\.",
                            r"global_transformer\.layers\.(\d+)\.")}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state_dict or {{'state_dict': ...}} checkpoint")
    return {k.removeprefix("module."): v for k, v in obj.items()}


def detect(sd: dict, family: str | None = None) -> tuple[str, int, int, int]:
    """(family, encoder depth, decoder depth, feat_dim) from the keys."""
    if family is None:
        if any(k.startswith("glocal_transformer.") for k in sd):
            family = "sttran"
        elif any(k.startswith(("local_transformer.", "global_transformer.")) for k in sd):
            family = "dsg_detr"
        else:
            raise ValueError("neither an STTran (glocal_transformer.*) nor a DSG-DETR "
                             "(local_transformer.* / global_transformer.*) state dict")
    if "subj_fc.weight" not in sd:
        raise ValueError("subj_fc.weight is missing: the feature width cannot be read")

    def depth(pattern):
        return len({m.group(1) for k in sd for m in [re.match(pattern, k)] if m})

    enc, dec = (depth(p) for p in _DEPTH_KEYS[family])
    return family, enc, dec, int(sd["subj_fc.weight"].shape[1])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference relation checkpoint -> port checkpoint")
    p.add_argument("--ckpt", required=True, help="reference torch checkpoint")
    p.add_argument("--out", required=True, help="output port checkpoint directory")
    p.add_argument("--cfg", dest="cfg_file", default=None,
                   help="config yaml or json (mode, data paths; the architecture comes from "
                        "the checkpoint)")
    p.add_argument("--family", choices=["sttran", "dsg_detr"], default=None,
                   help="override the detected model family")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Returns the written checkpoint's path."""
    args = parse_args(argv)
    logger = setup_logger()
    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    sd = load_state_dict(args.ckpt)
    family, enc, dec, feat_dim = detect(sd, args.family)
    if (enc, dec, feat_dim) != (cfg.enc_layer, cfg.dec_layer, cfg.feat_dim):
        logger.info(f"architecture from the checkpoint: enc={enc} dec={dec} feat_dim={feat_dim} "
                    f"(the config said {cfg.enc_layer}/{cfg.dec_layer}/{cfg.feat_dim}; the "
                    f"checkpoint wins)")
    cfg = cfg.replace(enc_layer=enc, dec_layer=dec, feat_dim=feat_dim)
    builder = train_sttran if family == "sttran" else train_dsg_detr
    model = builder.build_model(cfg, schema.load_taxonomy(), device)
    unused = load_model_state(model, sd)
    path = save_checkpoint(args.out, 0, create_train_state(model, cfg.lr, cfg.weight_decay,
                                                           cfg.grad_clip_norm),
                           config_json=cfg.to_json())
    logger.info(f"converted {family} checkpoint (enc={enc} dec={dec} feat_dim={feat_dim}) "
                f"-> {path}")
    if unused:
        logger.info(f"{len(unused)} unconsumed checkpoint keys (the reference's own loaders "
                    f"use strict=False): {unused[:8]}{' ...' if len(unused) > 8 else ''}")
    return path


if __name__ == "__main__":
    main()
