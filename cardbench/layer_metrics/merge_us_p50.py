"""merge_us_p50 (us): the median duration of the program's
``lfs.shard.merge`` spans in the traced window: the host side of
``flagstat_sharded``'s merge, each other card's raw sums copied onto the
first card and added there (enqueued; the wait for them is the
report's read-back). The spans are record functions of the program, in
the trace."""
from cardbench.yardstick import percentile, span


def read(view):
    took = [span(e)[1] - span(e)[0] for e in view.events
            if e.get("name") == "lfs.shard.merge" and e.get("cat") != "gpu_user_annotation"
            and view.lo <= span(e)[0] and span(e)[1] <= view.hi]
    return percentile(took, 0.5) if took else None
