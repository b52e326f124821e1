"""mpix_it_per_s: megapixels times iterations completed over all the
window's time (each call's target capture and copies inside it)."""


def read(run):
    return sum(u["mp_iters"] for u in run.units) / run.window_s
