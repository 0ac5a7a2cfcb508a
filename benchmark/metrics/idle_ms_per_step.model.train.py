"""The card's idle ms a training step while the host ran the model's
forward stages: each idle piece of the traced window goes to the innermost
host span open over it (`Trace.idle_us_by_span`); this reads the program's
`train/forward` scope's own pieces and those of every `model/*` scope
inside it (the backbone, FPN, RPN, NMS, RoIAlign and heads), over the
window's steps. None where the program has no `train/forward` scope."""


def read(view):
    tr = view.trace
    if not view.units or all(n != "train/forward" for n, _, _ in tr.spans):
        return None
    us = sum(v for k, v in tr.idle_us_by_span().items()
             if k == "train/forward" or k.startswith("model/"))
    return us / 1e3 / view.units
