"""Fleet simulation path on PyTorch tensors (twin of ``repro.sim``)."""
