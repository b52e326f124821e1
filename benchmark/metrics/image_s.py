"""image_s: wall seconds per finished image, all the window's time over
all the images it finished (the window holds whole images only)."""


def read(run):
    images = sum(u["images"] for u in run.units)
    return run.window_s / images if images else None
