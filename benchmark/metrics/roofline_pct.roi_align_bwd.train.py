"""RoIAlign backward's share of its roofline: the least time of the work
of the step's backward calls (`roofline.roi_align_backward_work`: the
gradient read once, the level maps written once, the pairs' keys and
footprints) over the device time of `roi_align_bwd_prep_kernel` and
`roi_align_bwd_kernel`, per step."""


def read(view):
    us = view.trace.kernel_us(
        r"roi_align_bwd_prep_kernel|roi_align_bwd_kernel")
    if not us or not view.units:
        return None
    return (100.0 * view.facts["roi_align_bwd_bound_ms_per_step"]
            / (us / 1e3 / view.units))
