"""Entry points of the port (``serve``: the uncompiled LM decode driver;
``serve_cnn``: CNN serving with the resilience queue; ``serve_lm``: LM
serving behind it; ``train``: the LM training loop, on one device or a
mesh; ``mesh``: the device meshes)."""
