"""The card's idle ms a training step while the host ran the optimizer's
update (the program's `train/update` scope: the global-norm clip, weight
decay and momentum, parameter by parameter). Each idle piece of the traced
window goes to the innermost host span open over it
(`Trace.idle_us_by_span`); this sums the scope's pieces over the window's
steps. None where the program has no such scope."""

SPAN = "train/update"


def read(view):
    tr = view.trace
    if not view.units or all(n != SPAN for n, _, _ in tr.spans):
        return None
    return tr.idle_us_by_span().get(SPAN, 0.0) / 1e3 / view.units
