"""Hopper attention kernels: plain versions (ref.py, decode.py), wrappers
(flash_attention.py, decode.py) and specs (ops.py)."""
