"""weight_upload_mb: MiB of feature-net weights the program moved to the
engine's device in the profiled unit (its counter
``weights.upload_bytes``), read from the newest root of
``maua_style_tpu_torch.trace``; nothing where the program keeps no
counter."""


def read(run):
    try:
        from maua_style_tpu_torch import trace
    except ImportError:
        return None
    roots = trace.roots()
    if not roots or "weights.upload_bytes" not in roots[-1].counters:
        return None
    return roots[-1].counters["weights.upload_bytes"] / 2**20
