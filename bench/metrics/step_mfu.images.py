"""The whole step's share of the int8 peak: the model's int8 operations
per image (2 x the MACs of every conv and linear, from the shapes) times
the images completed, over the traced window, against 1,979 TOP/s."""

from bench.work import models, peaks


def read(t):
    if not t.info.get("images"):
        return None
    ops = models.vgg_ops(t.config) * t.info["images"]
    return 100.0 * ops / peaks.INT8_OPS_PER_S / t.window_s
