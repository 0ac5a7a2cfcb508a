"""The training step's share of the card's bf16 dense peak: the benchmark's
FLOP count of a step (`flops.py`: forward and backward; the update counts 0)
times the steps the untraced window completed, over that window's
length on the host clock, over 989 TFLOP/s."""


def read(view):
    if not view.rate_units or not view.rate_s:
        return None
    flops = view.facts["flops_per_unit"] * view.rate_units
    return 100.0 * flops / view.rate_s / view.peak_flops
