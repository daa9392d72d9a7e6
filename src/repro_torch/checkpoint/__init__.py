"""Atomic step-numbered snapshots (twin of ``repro.checkpoint``)."""
