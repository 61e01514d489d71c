"""Evaluate a trained DSG-DETR checkpoint on the Action Genome test split
(port of tools/test_DSG_DETR.py):

    python -m nl_vsgg_tpu_torch.tools.test_dsg_detr --model_path out/ckpt \
        [--cfg cfg.yml] [--max_videos N] [--device_eval] [--device cpu]

sgdet and predcls run tools/test_sttran's loop with the DSG-DETR builder.
sgcls runs its two-stage reassignment flow with the reference's tracker
(lib/track.py:154-243): the host tracker clusters each GT-box Entry's boxes
into tracklets, and the cluster ids drive the tracklet attention through
DSGDETR(group_id=...) in both stages.
"""

from __future__ import annotations

import numpy as np

from ..models.track import sgcls_group_ids as track_group_ids
from ..utils.logging import setup_logger
from . import test_sttran as base_test
from .train_dsg_detr import build_model


def sgcls_group_ids(entry, ds, idx) -> np.ndarray:
    """Per-box tracklet ids of one GT-box Entry. The image size is what the
    reference passes: img_info[:2] / scale, or the video size reversed."""
    info = ds.img_info[idx]
    if info is not None:
        h, w, s = float(info[0]), float(info[1]), float(info[2])
        im_size = (h / s, w / s)
    else:
        vs = ds.video_size[idx]  # (w, h)
        im_size = (float(vs[1]), float(vs[0]))
    return track_group_ids(entry, im_size)


def main(argv=None, read_frames=None):
    args = base_test.parse_args(argv)
    cfg = base_test.config_for(args)
    if cfg.mode == "sgcls":
        return base_test.evaluate_sgcls(cfg, args, setup_logger(), build_model_fn=build_model,
                                        group_id_fn=sgcls_group_ids, read_frames=read_frames)
    return base_test.main(argv, build_model_fn=build_model, read_frames=read_frames)


if __name__ == "__main__":
    main()
