"""Host milliseconds inside a detect call (the input copy into the graph's
buffers and the replay, not the read-back): the mean of the harness's
`dispatch` spans in the untraced window."""


def read(view):
    spans = view.spans.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
