"""Relation models (STTran, DSG-DETR), their training losses, the DSG-DETR
tracker and matcher, and the JAX -> port weight converter."""
