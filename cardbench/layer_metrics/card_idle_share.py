"""card_idle_share (%): the mean over the cards of each card's own idle
share of the traced window: the window less the union of that card's
kernel, memcpy and memset intervals, a card told by the device event's
``args.device``. ``device_idle_share`` is one union over every card, so
it cannot show one card waiting on the others; this can. The cards are
those with a device event in the window."""
from cardbench.yardstick import span, union_length


def read(view):
    if view.window_s <= 0:
        return None
    by_card = {}
    for e in view.device():
        card = e.get("args", {}).get("device")
        if card is not None:
            by_card.setdefault(card, []).append(span(e))
    if not by_card:
        return None
    shares = [100.0 * (1.0 - union_length(iv, view.lo, view.hi) * 1e-6 / view.window_s)
              for iv in by_card.values()]
    return sum(shares) / len(shares)
