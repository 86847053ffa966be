"""Tools of the port: the attention lab (``python -m vit_search_torch.tools.attn_lab``)."""
