"""The port's models: segmentation (models/segment.py)."""
