"""Relation models (STTran) and the JAX -> port weight converter."""
