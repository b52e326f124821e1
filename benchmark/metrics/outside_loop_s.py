"""outside_loop_s: seconds of the profiled unit's root span (the program's
``pipeline.img_img`` of a CLI image, its ``engine.optimize`` of a call)
outside its ``engine.chunk`` spans, the engine's iterations and the copy
of each chunk's log that waits for them: target capture, host copies,
engine builds, resizes, colour matching, loads and saves.  Read from the
newest root of ``maua_style_tpu_torch.trace`` (the unit run under the
profiler); nothing where the program keeps no spans."""


def read(run):
    try:
        from maua_style_tpu_torch import trace
    except ImportError:
        return None
    roots = trace.roots()
    if not roots:
        return None
    root = roots[-1]
    start, end = root.records[0][1:3]
    return (end - start - trace.total_ns(root, "engine.chunk")) / 1e9
