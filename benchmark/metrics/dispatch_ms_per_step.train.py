"""Host milliseconds inside a training step's call (forward, targets,
losses, backward and update launched eagerly; the call returns before the
card finishes, unless the launch queue is full): the mean of the
harness's `step` spans in the untraced window."""


def read(view):
    spans = view.spans.get("step")
    return 1e3 * sum(spans) / len(spans) if spans else None
