"""AdamW and its learning-rate schedule (``optim/adamw.py``,
``optim/schedule.py``)."""
