"""Relation models (STTran), their training losses and the JAX -> port
weight converter."""
