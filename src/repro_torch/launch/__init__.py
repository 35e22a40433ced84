"""Entry points of the port (``serve``: the uncompiled LM decode driver;
``serve_cnn``: CNN serving with the resilience queue)."""
