"""How far one ulp of conv1's rounding moves a training step's gradients.

    python3 -m detectandtrack_tpu_torch.tools.parity_ties [runs]

Runs `chip_smoke.py`'s golden R-18 T=2 f32 train step (its TRAIN_OPTS and
seeded batch) on the CPU, once as it is and then `runs` times (default 6)
with conv1's output multiplied by 1 + 2^-23·N(0, 1), about one ulp of f32,
each time from another noise seed; with torch's own convs and with
oneDNN's. For each noisy step it prints the largest gradient difference
from the clean step, relative to that gradient's largest entry (the
measure `chip_smoke.py`'s [train-parity] holds card against CPU to 1e-3),
and the ReLUs whose decision (x > 0) the noise flipped, with the largest
such |x| over its tensor's max |x|. A gradient far off from noise of this
size, with a flip at a few 1e-8 of its tensor, says the step's gradients
jump at a ReLU input within rounding of zero: why [train-parity] gives
the CPU step the card's ReLU decisions.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _step(cfg, batch):
    """→ (gradients, every F.relu input in call order)."""
    import torch.nn.functional as F
    from ..engine.train import create_train_state, make_train_step
    from ..models.detector import build_model
    relu, inputs = F.relu, []

    def recording_relu(x, inplace=False):
        inputs.append(x.detach().clone())
        return relu(x, inplace)

    model = build_model(cfg, device="cpu", seed=0, train=True)
    state = create_train_state(cfg, model)
    F.relu = recording_relu
    try:
        state, _ = make_train_step(model, cfg)(state, dict(batch))
    finally:
        F.relu = relu
    return {k: p.grad.clone() for k, p in state.params.items()
            if p.grad is not None}, inputs


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[0]) if argv else 6
    sys.path.insert(0, REPO)
    import chip_smoke
    from ..core.config import load_cfg
    from ..kernels import conv1 as k_conv1

    cfg = load_cfg(opts=chip_smoke.TRAIN_OPTS)
    batch = chip_smoke._train_batch(torch, cfg, 2, 64, 96, 10, 3, seed=8)
    floor = chip_smoke.GRAD_FLOOR / chip_smoke.GRAD_REL_TOL
    plain = k_conv1.conv1
    rows = []
    try:
        for libs in (False, True):
            torch.backends.mkldnn.enabled = libs
            clean, clean_x = _step(cfg, batch)
            for seed in range(runs):
                gen = torch.Generator().manual_seed(seed)

                def noisy(x, k7, t, dtype, gen=gen):
                    y = plain(x, k7, t, dtype)
                    return y * (1 + 2.0 ** -23 * torch.randn(
                        y.shape, generator=gen))

                k_conv1.conv1 = noisy
                try:
                    grads, xs = _step(cfg, batch)
                finally:
                    k_conv1.conv1 = plain
                rel, name = max(
                    ((grads[k] - g).abs().max().item()
                     / max(g.abs().max().item(), floor), k)
                    for k, g in clean.items())
                flips, tie = 0, 0.0
                for a, b in zip(clean_x, xs):
                    differ = (a > 0) != (b > 0)
                    if bool(differ.any()):
                        flips += int(differ.sum())
                        tie = max(tie, (a[differ].abs().max()
                                        / a.abs().max()).item())
                row = {"convs": "oneDNN" if libs else "torch's own",
                       "seed": seed, "worst_rel": rel, "gradient": name,
                       "relu_flips": flips, "largest_flip": tie}
                print(f"[parity_ties] {row['convs']} convs, noise seed "
                      f"{seed}: worst {name} at {rel:.4g} of its max; "
                      f"{flips} ReLU decisions flipped, the largest input "
                      f"at {tie:.3g} of its tensor's max", flush=True)
                rows.append(row)
    finally:
        torch.backends.mkldnn.enabled = True
    return rows


if __name__ == "__main__":
    main()
