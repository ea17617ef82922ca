"""kernels_roofline (%): the least time to read the traced reports'
words once (2 bytes a word at the card's published HBM rate) over the
summed device time of every kernel in the traced window, whatever its
name."""
from cardbench.yardstick import clip, roofline_share, span


def read(view):
    peak = view.peak("hbm_bytes_per_s")
    kernels = view.device(("kernel",))
    if peak is None or not kernels or view.words <= 0:
        return None
    seconds = sum(b - a for e in kernels for a, b in clip([span(e)], view.lo, view.hi)) * 1e-6
    return roofline_share(2.0 * view.words, seconds, peak)
