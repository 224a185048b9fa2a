"""The train step (``train/step.py``) and the fault-tolerant training loop
(``train/trainer.py``)."""
