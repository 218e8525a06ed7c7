"""Inference step (``make_forward``)."""
