"""Command-line drivers of the port (``python -m …_torch.examples.<name>``)."""
