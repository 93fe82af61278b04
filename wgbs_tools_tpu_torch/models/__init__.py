"""The port's models: segmentation (models/segment.py; exact mode on a torch
device in models/segment_exact_device.py), find_markers (models/markers.py)
and test_bimodal (models/bimodal.py)."""
