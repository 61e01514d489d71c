"""The VinVL AttrRCNN detector (ResNeXt-152-C4 + RPN + C5 box head), port of
nl_vsgg_tpu/detector/. Entry point: `attr_rcnn.AttrRCNNTorch`."""
