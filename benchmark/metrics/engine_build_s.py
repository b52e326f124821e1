"""engine_build_s: seconds in the program's ``engine.build`` spans (each
scale's ``build_engine``: the weights loaded and uploaded, the engine made)
of the profiled unit, read from the newest root of
``maua_style_tpu_torch.trace``; nothing where the program keeps no spans."""


def read(run):
    try:
        from maua_style_tpu_torch import trace
    except ImportError:
        return None
    roots = trace.roots()
    if not roots or not roots[-1].spans("engine.build"):
        return None
    return trace.total_ns(roots[-1], "engine.build") / 1e9
