"""The card's idle ms a training step while the host computed the
training targets (the program's `train/targets` scopes: the anchor field
and its copy to the card, the sampling draws and their copies, the RPN,
RoI, keypoint and mask targets). Each idle piece of the traced window goes
to the innermost host span open over it (`Trace.idle_us_by_span`); this
sums the scope's pieces over the window's steps. None where the program
has no such scope."""

SPAN = "train/targets"


def read(view):
    tr = view.trace
    if not view.units or all(n != SPAN for n, _, _ in tr.spans):
        return None
    return tr.idle_us_by_span().get(SPAN, 0.0) / 1e3 / view.units
