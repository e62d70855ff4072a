"""Dense LM in PyTorch (port of ``repro.models``)."""
