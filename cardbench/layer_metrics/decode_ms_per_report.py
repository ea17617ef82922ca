"""decode_ms_per_report (ms): the stream's ``decode`` section (the
walls of its decode calls, summed though up to four overlap) per traced
report, from the timer the benchmark passes as ``timer=``."""


def read(view):
    if "decode" not in view.sections or view.reports <= 0:
        return None
    return view.sections["decode"] / view.reports * 1e3
