"""syncs_per_image: synchronising calls an image, as
``torch.cuda.set_sync_debug_mode("warn")`` flags them, averaged over the
window's images."""


def read(run):
    if run.trace is None or not run.syncs:
        return None
    return sum(run.syncs) / sum(u["images"] for u in run.units)
