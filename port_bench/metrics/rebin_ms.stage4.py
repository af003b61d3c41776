"""rebin_ms.stage4: ms an iteration of binning over the whole timed window
of a --trace 1 run: the device time between CUDA events recorded at the
start and the end of every Stage4Runner._rebin call (build_flat_bins, the
transpose plan), summed and divided by the window's iterations."""


def read(rec):
    w = rec.get("window")
    if not w or not w["steps"] or not w.get("rebin_device_s"):
        return None
    return w["rebin_device_s"] / w["steps"] * 1e3
