"""Train DSG-DETR on Action Genome with weak supervision (port of
tools/train_DSG_DETR.py):

    python -m nl_vsgg_tpu_torch.tools.train_dsg_detr --cfg configs/nl_vsgg_config.yml \
        [--nepoch N] [--bce_loss] [--max_videos N] [--device cpu]

The loop is `tools.train_sttran.run_training` with the DSG-DETR builder:
cfg.enc_layer local and cfg.dec_layer global encoder layers, 1 and 3 in
the shipped config, the depths the JAX tool builds. In the
shipped sgdet path the reference calls its tracker after the model has
consumed the entry, so tracklets never reach training; the model derives
its temporal groups from the object classes.
"""

from __future__ import annotations

import torch

from ..models.dsg_detr import DSGDETR
from .train_sttran import compute_dtype, config_from_args, glove_tables, parse_args, run_training


def build_model(cfg, tax, device=None) -> DSGDETR:
    """DSG-DETR for `cfg` on `device` (None: the card), weights drawn from a
    generator seeded cfg.seed, class embeddings from GloVe."""
    g36, g37 = glove_tables(cfg, tax)
    return DSGDETR(mode=cfg.mode, obj_classes=tuple(tax.object_classes),
                   enc_layer_num=cfg.enc_layer, dec_layer_num=cfg.dec_layer,
                   feat_dim=cfg.feat_dim, glove_obj36=g36, glove_obj37=g37,
                   dtype=compute_dtype(cfg), device=device,
                   generator=torch.Generator().manual_seed(cfg.seed))


def main(argv=None):
    args = parse_args(argv)
    return run_training(config_from_args(args), args, build_model)


if __name__ == "__main__":
    main()
