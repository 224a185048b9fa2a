"""Bilinear upscale: plain version (ref.py), wrapper and specs (ops.py)."""
