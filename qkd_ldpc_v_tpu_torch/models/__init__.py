"""Parity-check matrix models, readers, edge layout and code generators
(host-side NumPy)."""
