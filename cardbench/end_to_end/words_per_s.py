"""words_per_s (words/s): all words of the reports completed in the
window over the window, from the start of its first report to the end
of its last (host clock)."""


def read(view):
    return view.completed * view.words_per_report / view.seconds
