"""ring_wait_share (%): the program's ``lfs.stage.acquire`` spans (the
calling thread's wait for a free ring slot, whose last copy has to end)
summed over its ``lfs.flagstat_stream`` spans summed, in the traced
window."""
from cardbench.yardstick import span


def read(view):
    def total(name):
        return sum(span(e)[1] - span(e)[0] for e in view.events if e.get("name") == name
                   and view.lo <= span(e)[0] and span(e)[1] <= view.hi)

    calls, waits = total("lfs.flagstat_stream"), total("lfs.stage.acquire")
    if calls <= 0 or waits <= 0:
        return None
    return 100.0 * waits / calls
