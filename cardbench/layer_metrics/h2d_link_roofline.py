"""h2d_link_roofline (%): the least time to move the traced reports'
words over the host-to-card link (2 bytes a word at ``LINK_BYTES_PER_S``)
over the traced window. Every word of a report held on the host has to
cross the link, so a reading above 100% means a report skipped it.
Nothing where the window holds no host-to-device copy."""
from cardbench.yardstick import roofline_share

#: PCIe Gen5 x16 in one direction: 32 GT/s x 16 lanes, 128b/130b
#: encoding, 8 bits a byte (~63.0 GB/s). The H100's host link; the
#: 48-52 GB/s that h2d_gbps reads on it (PERF.md) rule out Gen4's ~31.5
LINK_BYTES_PER_S = 32e9 * 16 * 128 / 130 / 8


def read(view):
    copies = [e for e in view.device(("gpu_memcpy",)) if "HtoD" in e.get("name", "")]
    if not copies or view.words <= 0 or view.window_s <= 0:
        return None
    return roofline_share(2.0 * view.words, view.window_s, LINK_BYTES_PER_S)
