"""Entry points of the port (``serve_cnn``: CNN serving with the
resilience queue)."""
