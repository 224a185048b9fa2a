"""Mamba-2 SSD: plain versions (ref.py), wrapper and spec (ops.py)."""
