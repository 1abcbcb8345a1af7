"""The share of the traced window in which no kernel, copy or set ran on
the device, in percent."""

NAME = "device_idle_pct"
UNIT = "%"
LAYER = "device"
MOVES = "cell_rate"


def read(w):
    if w.busy_s is None or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.busy_s / w.window_s)
