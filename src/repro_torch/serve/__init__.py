"""Serving runtime of the port (twin of ``repro.serve``)."""
