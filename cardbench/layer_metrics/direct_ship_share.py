"""direct_ship_share (%): the bytes of the program's ``lfs.stage.ship``
spans in the traced window whose ``source`` is ``"caller"`` (a piece
shipped to the card straight from the caller's page-locked memory) over
the bytes of all of them. A span without ``source`` counts as
``"slot"``. The spans' args come from the program's span buffer
(``bench.profiling.spans``), put on the trace's clock by its
``to_trace_us``; nothing without the spans in the trace."""


def read(view):
    if not any(e.get("name") == "lfs.stage.ship" for e in view.events):
        return None
    try:
        from libflagstats_tpu_torch.bench import profiling

        mapped = profiling.to_trace_us(profiling.spans(), view.events)
    except (ImportError, AttributeError):
        return None
    ships = [e for e in mapped if e["name"] == "lfs.stage.ship"
             and view.lo <= e["ts"] and e["ts"] + e["dur"] <= view.hi]
    total = sum(e["args"].get("bytes", 0) for e in ships)
    if total <= 0:
        return None
    caller = sum(e["args"].get("bytes", 0) for e in ships
                 if e["args"].get("source", "slot") == "caller")
    return 100.0 * caller / total
