"""Hopper tiled matmul: plain version (ref.py), wrapper and spec (ops.py)."""
