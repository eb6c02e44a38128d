"""Time to tolerance: every completed solve's wall time (host clock from
the call to its synchronised return), summed, over their count."""


def read(run):
    times = [s.seconds for s in run.solves]
    return 1e3 * sum(times) / len(times) if times else None
