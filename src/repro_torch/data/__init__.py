"""The synthetic LM data pipeline (``data/pipeline.py``)."""
