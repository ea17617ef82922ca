"""block_call_p50_us (us): the median of the benchmark's own host-clock
span around each block call of the traced reports."""
from cardbench.yardstick import percentile


def read(view):
    calls = view.spans.get("block_call")
    if not calls:
        return None
    return percentile(calls, 0.5) * 1e6
