"""gram_roofline: the sum of K1's least times (``flops.gram_bound_s``) over
its launches in the profiled unit, over the device time of its kernels
there, in percent; nothing where K1 did not run."""


def read(run):
    t = run.trace
    if not t or t["gram_us"] <= 0:
        return None
    return 100.0 * t["gram_bound_s"] / (t["gram_us"] / 1e6)
