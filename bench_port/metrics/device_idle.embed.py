"""device_idle.embed: the share of the traced window in which no kernel
and no copy ran on the device."""


def read(rec, run):
    if rec is None or rec.busy_s <= 0 or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
