"""The one-device trainer (twin of ``repro.train``)."""
