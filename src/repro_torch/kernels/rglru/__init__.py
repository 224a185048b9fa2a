"""RG-LRU scan: plain versions (ref.py), wrapper and spec (ops.py)."""
