"""Synthetic training data (twin of ``repro.data``)."""
