"""style_key_s: seconds in the program's ``engine.style_key`` spans (the
style-target cache key: each style array's bytes hashed) of the profiled
unit, read from the newest root of ``maua_style_tpu_torch.trace``; nothing
where the program keeps no spans."""


def read(run):
    try:
        from maua_style_tpu_torch import trace
    except ImportError:
        return None
    roots = trace.roots()
    if not roots or not roots[-1].spans("engine.style_key"):
        return None
    return trace.total_ns(roots[-1], "engine.style_key") / 1e9
