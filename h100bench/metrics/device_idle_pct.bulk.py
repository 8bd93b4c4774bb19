"""device_idle_pct.bulk (%, device trace): the share of the profiled
stretch of the window (the same number of steps in every run) in which
no kernel, copy or memset ran on the device.  Moves images_per_s."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
