"""Command-line entry points of the port (``python -m vit_search_torch.cli.train``)."""
