"""shard_fanout_us_p50 (us): how long the host takes to set every card
counting. For each report of the traced window (the benchmark's
``cardbench.report`` span), the first start of a count kernel (a kernel
whose name holds ``stream_sums``) on each card, by the kernel event's
``args.device``; the latest of those first starts less the earliest.
The median over the reports that set two or more cards counting."""
import bisect

from cardbench.yardstick import REPORT_SPAN, percentile, span

COUNT_KERNEL = "stream_sums"


def read(view):
    reports = [span(e) for e in view.events
               if e.get("name") == REPORT_SPAN and e.get("cat") != "gpu_user_annotation"
               and view.lo <= span(e)[0] and span(e)[1] <= view.hi]
    kernels = sorted((span(e)[0], e.get("args", {}).get("device"))
                     for e in view.device(("kernel",)) if COUNT_KERNEL in e.get("name", ""))
    starts = [t for t, _ in kernels]
    spreads = []
    for a, b in reports:
        first = {}
        for t, dev in kernels[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
            if dev is not None:
                first.setdefault(dev, t)
        if len(first) >= 2:
            spreads.append(max(first.values()) - min(first.values()))
    return percentile(spreads, 0.5) if spreads else None
