"""dispatch_self_us_p50 (us): the median, over the program's
``lfs.flagstats_u16`` spans in the traced window, of a span's duration
less the union of the ``lfs.*`` spans inside it on its thread (staging,
launch, assembly, read-back): the dispatch layer's own host time a
call. The spans are record functions of the program, in the trace."""
from cardbench.yardstick import percentile, span, union_length


def read(view):
    lfs = sorted((span(e)[0], -span(e)[1], e["name"], e.get("tid")) for e in view.events
                 if e.get("name", "").startswith("lfs.")
                 and view.lo <= span(e)[0] and span(e)[1] <= view.hi)
    own = []
    for i, (a, neg_b, name, tid) in enumerate(lfs):
        if name != "lfs.flagstats_u16":
            continue
        b, inside, j = -neg_b, [], i + 1
        while j < len(lfs) and lfs[j][0] < b:
            if lfs[j][3] == tid and -lfs[j][1] <= b:
                inside.append((lfs[j][0], -lfs[j][1]))
            j += 1
        own.append(b - a - union_length(inside, a, b))
    return percentile(own, 0.5) if own else None
