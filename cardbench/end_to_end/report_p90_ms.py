"""report_p90_ms (ms): the 90th percentile of the time to report over
every report in the window (host clock; a failed report counts with its
time)."""
from cardbench.yardstick import percentile


def read(view):
    return percentile(view.latencies, 0.9) * 1e3
