"""host_copy_gbps (GB/s): the bytes of the program's
``lfs.stage.copy_in`` spans in the traced window (a piece of a host
column copied into a pinned slot on the host) over the union of their
durations. The spans' ``bytes`` come from the program's span buffer
(``bench.profiling.spans``), put on the trace's clock by its
``to_trace_us``; nothing without the spans in the trace."""
from cardbench.yardstick import union_length


def read(view):
    if not any(e.get("name") == "lfs.stage.copy_in" for e in view.events):
        return None
    try:
        from libflagstats_tpu_torch.bench import profiling

        mapped = profiling.to_trace_us(profiling.spans(), view.events)
    except (ImportError, AttributeError):
        return None
    copies = [e for e in mapped if e["name"] == "lfs.stage.copy_in"
              and view.lo <= e["ts"] and e["ts"] + e["dur"] <= view.hi]
    nbytes = sum(e["args"].get("bytes", 0) for e in copies)
    busy = union_length([(e["ts"], e["ts"] + e["dur"]) for e in copies], view.lo, view.hi)
    if nbytes <= 0 or busy <= 0:
        return None
    return nbytes / (busy * 1e-6) / 1e9
