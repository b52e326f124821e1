"""kernels_per_iter: device kernels (copies and fills not counted) per
iteration of the profiled unit, its target capture included."""


def read(run):
    t = run.trace
    return t["kernels"] / t["iters"] if t else None
