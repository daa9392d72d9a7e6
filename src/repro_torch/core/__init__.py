"""Framework-free pieces of the reference, copied and trimmed to what the
fleet path uses."""
