"""Share of the traced window in which no operation ran on the device
(1 - the union of the device events' intervals over the window)."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s)
