"""Share of the traced window in which no operation ran on the device: the
union of the device operations' intervals against the window, from the
first traced solve's start to the last one's end."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops or not tr.window_seconds():
        return None
    return 100.0 * (1.0 - tr.busy_seconds() / tr.window_seconds())
