"""conv1's share of its roofline: the least time its work takes on the
card (`roofline.conv1_work`: the clip and kernel read once, the output
written once, bf16 tensor-core FLOPs) over the device time of the
`conv1_tc_kernel` launches, per call."""


def read(view):
    us = view.trace.kernel_us(r"conv1_tc_kernel")
    calls = view.units / view.facts["units_per_call"]
    if not us or not calls:
        return None
    return 100.0 * view.facts["conv1_bound_ms_per_call"] / (us / 1e3 / calls)
