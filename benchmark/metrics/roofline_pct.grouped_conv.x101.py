"""The grouped 3x3 convs' share of their roofline: the least time of the
body's grouped convs with their epilogues in one call
(`roofline_grouped.grouped_conv_work`: the input read once, the weights and
affines read once, the output written once, bf16 tensor-core FLOPs) over
the device time of the `grouped_conv3x3_kernel` launches, per call. None
where no such kernel ran."""


def read(view):
    us = view.trace.kernel_us(r"grouped_conv3x3_kernel")
    calls = view.units / view.facts["units_per_call"]
    if not us or not calls:
        return None
    return (100.0 * view.facts["grouped_conv_bound_ms_per_call"]
            / (us / 1e3 / calls))
