"""optimizer_ms: device milliseconds an iteration under the range the
benchmark puts around the optimiser's ``update`` in the profiled unit."""


def read(run):
    t = run.trace
    return t["optimizer_us"] / 1e3 / t["iters"] if t and t["optimizer_us"] > 0 else None
