"""between_scales_s: host seconds from one scale's last step to the next
scale's first, summed over an image, averaged over the window's images
(the method of ``chip_smoke.run_main_path``)."""


def read(run):
    gaps = run.between_scales_s
    return sum(gaps) / len(gaps) if gaps else None
