"""Parity-check matrix models (host-side NumPy)."""
