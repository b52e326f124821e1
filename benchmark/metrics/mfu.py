"""mfu: the model's operations in the window's iterations
(``flops.iteration_flops``: the convolutions' forward and input gradient
up to the deepest loss layer, and the style Grams) over the window's
time, against the float32 peak, in percent."""

from benchmark import flops


def read(run):
    return 100.0 * sum(u["flops"] for u in run.units) / (run.window_s * flops.PEAK_FP32)
