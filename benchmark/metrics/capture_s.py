"""capture_s: seconds in the program's ``engine.capture`` spans (content
and style targets: the upload, the style cache key, the extraction) of the
profiled unit, read from the newest root of ``maua_style_tpu_torch.trace``;
nothing where the program keeps no spans."""


def read(run):
    try:
        from maua_style_tpu_torch import trace
    except ImportError:
        return None
    roots = trace.roots()
    if not roots or not roots[-1].spans("engine.capture"):
        return None
    return trace.total_ns(roots[-1], "engine.capture") / 1e9
