"""conv_ms: device milliseconds an iteration under ``aten::convolution``
and ``aten::convolution_backward`` (cuDNN's forward and input gradient)
in the profiled unit, its target capture included."""


def read(run):
    t = run.trace
    return t["conv_us"] / 1e3 / t["iters"] if t and t["conv_us"] > 0 else None
