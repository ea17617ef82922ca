"""h2d_gbps (GB/s): the bytes of the traced window's host-to-device
memcpy events over the union of their durations."""
from cardbench.yardstick import union_length, span


def read(view):
    copies = [e for e in view.device(("gpu_memcpy",)) if "HtoD" in e.get("name", "")]
    nbytes = sum(float(e.get("args", {}).get("bytes", 0)) for e in copies)
    if not copies or nbytes <= 0:
        return None
    busy = union_length([span(e) for e in copies], float("-inf"), float("inf")) * 1e-6
    return nbytes / busy / 1e9
