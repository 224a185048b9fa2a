"""The checkpoint manager (``checkpoint/manager.py``)."""
