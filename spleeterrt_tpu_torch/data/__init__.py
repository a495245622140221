"""The training data pipeline (data/dataset.py)."""
