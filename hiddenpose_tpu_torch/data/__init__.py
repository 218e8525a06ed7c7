"""Synthetic captures for smoke runs and tests."""
