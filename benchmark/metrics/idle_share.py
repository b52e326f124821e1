"""idle_share: the share of the profiled unit's span in which no operation
ran on the device, in percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"]) if t else None
