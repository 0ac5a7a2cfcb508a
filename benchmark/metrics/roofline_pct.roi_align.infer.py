"""RoIAlign forward's share of its roofline, box and keypoint stages
together: the least time of their work (`roofline.roi_align_work`: the
distinct map cells the rois' corners touch read once, the output written
once) over the device time of the `roi_align_fwd_kernel` launches, per
call."""


def read(view):
    us = view.trace.kernel_us(r"roi_align_fwd_kernel")
    calls = view.units / view.facts["units_per_call"]
    if not us or not calls:
        return None
    return (100.0 * view.facts["roi_align_bound_ms_per_call"]
            / (us / 1e3 / calls))
