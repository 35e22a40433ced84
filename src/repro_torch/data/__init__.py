"""Data sources of the port (``synthetic``: the LM token stream)."""
