"""launch_us_p50 (us): the median duration of the program's
``lfs.launch`` spans in the traced window: the host side of one kernel
wrapper call (checks, the output's torch.zeros, the ctypes launch), not
the kernel's run on the card."""
from cardbench.yardstick import percentile, span


def read(view):
    took = [span(e)[1] - span(e)[0] for e in view.events if e.get("name") == "lfs.launch"
            and view.lo <= span(e)[0] and span(e)[1] <= view.hi]
    return percentile(took, 0.5) if took else None
