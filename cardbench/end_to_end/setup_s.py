"""setup_s (s): from the start of the harness to the start of the
window: imports, the column (and its file), the program's builds on a
checkout's first run, and the warm-up reports (host clock)."""


def read(view):
    return view.setup_s
