"""Model stand-ins of the port (twin of ``repro.models``)."""
