"""Geometry ops and the masked-attention kernel's wrapper."""
