"""device_idle_share (%): the share of the traced window in which no
kernel, memcpy or memset runs on the card (the union of their
intervals, from the torch.profiler trace)."""


def read(view):
    if not view.device() or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)
