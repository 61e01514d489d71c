"""Measurement tools of the port: per-call timing and the probe entry points."""
