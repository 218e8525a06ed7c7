"""Evaluation: the pose metrics and the dataset-level harness."""
