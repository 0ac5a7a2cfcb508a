"""Everything a run feeds the system, made from `--seed`: the weights, the
clips, the proposal tubes, the ground truth and the sampling draws.

Weights and clips are made on the device with a `torch.Generator`, in one
large call each; tubes and ground truth are small and made in NumPy. Each
kind of input takes its own stream, `derive(seed, tag)`, so a cell that
adds an input leaves the others as they were.
"""

from __future__ import annotations

import zlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .reference.model import param_spec

NUM_KEYPOINTS = 15


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream `tags` of `seed` (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [zlib.crc32(str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)


def generator(seed: int, device, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The detector's parameters (float32) from the seed: one gaussian draw
    of the size of all the gaussian leaves, cut and scaled per leaf."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(shape)) for _, shape, kind, _ in spec
                if kind == "normal")
    flat = torch.randn(total, generator=generator(seed, device, "weights"),
                       device=device)
    out, at = {}, 0
    for name, shape, kind, value in spec:
        n = int(np.prod(shape))
        if kind == "normal":
            out[name] = flat[at:at + n].view(shape).mul_(value)
            at += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


def make_clips(seed: int, tag, shape: Sequence[int], device,
               valid_hw: Tuple[int, int] = None) -> torch.Tensor:
    """Standard-normal clips (B, T, H, W, 3) float32, the pixels after the
    mean subtraction; with `valid_hw` only the top-left (h, w) holds an
    image and the rest is the loader's zero padding."""
    x = torch.randn(tuple(shape), generator=generator(seed, device, "clips",
                                                      tag), device=device)
    if valid_hw is not None:
        h, w = valid_hw
        x[:, :, h:] = 0.0
        x[:, :, :, w:] = 0.0
    return x


# Person boxes at the 800-px scale over the FPN levels: (sqrt-area band,
# share), the bands of assign_fpn_levels with canonical (224, level 4).
LEVEL_BANDS = [((32.0, 112.0), 0.35), ((112.0, 224.0), 0.35),
               ((224.0, 448.0), 0.20), ((448.0, 720.0), 0.10)]


def make_realistic_tubes(batch: int, k: int, t: int, im_h: int, im_w: int,
                         seed: int = 0) -> np.ndarray:
    """Person-shaped tubes (B, K, 4T) over the FPN levels in LEVEL_BANDS'
    shares, tall (w/h 0.33-0.8), drifting 3 px a frame."""
    rng = np.random.default_rng(seed)
    counts = [int(round(f * k)) for _, f in LEVEL_BANDS]
    counts[0] += k - sum(counts)
    sa = np.concatenate([rng.uniform(lo, hi, size=(batch, c))
                         for ((lo, hi), _), c in zip(LEVEL_BANDS, counts)
                         if c > 0], axis=1)
    aspect = rng.uniform(0.33, 0.8, size=sa.shape)
    h, w = sa / np.sqrt(aspect), sa * np.sqrt(aspect)
    cx = rng.uniform(0.0, im_w, size=sa.shape)
    cy = rng.uniform(0.0, im_h, size=sa.shape)
    drift = rng.normal(scale=3.0, size=(batch, k, t, 2))
    boxes = np.stack([
        cx[..., None] + drift[..., 0] - w[..., None] / 2,
        cy[..., None] + drift[..., 1] - h[..., None] / 2,
        cx[..., None] + drift[..., 0] + w[..., None] / 2,
        cy[..., None] + drift[..., 1] + h[..., None] / 2], axis=-1)
    boxes[..., 0::2] = boxes[..., 0::2].clip(0, im_w - 1)
    boxes[..., 1::2] = boxes[..., 1::2].clip(0, im_h - 1)
    return boxes.reshape(batch, k, 4 * t).astype(np.float32)


def make_ground_truth(seed: int, tag, batch: int, max_gt: int, t: int,
                      image_hw: Tuple[int, int], n_range: Tuple[int, int]
                      ) -> Dict[str, np.ndarray]:
    """Person tubes as ground truth: gt_boxes (B, G, 4T) with the first n
    rows valid (n uniform in n_range, inclusive), gt_keypoints (B, G, T,
    15, 3) uniform inside each box with visibility in {0, 1, 2}, gt_valid
    (B, G)."""
    s = derive(seed, "gt", tag)
    rng = np.random.default_rng(s)
    h, w = image_hw
    tubes = make_realistic_tubes(batch, max_gt, t, h, w, seed=s)
    box = tubes.reshape(batch, max_gt, t, 1, 4)
    u = rng.uniform(size=(batch, max_gt, t, NUM_KEYPOINTS, 2))
    kps = np.stack([box[..., 0] + u[..., 0] * (box[..., 2] - box[..., 0]),
                    box[..., 1] + u[..., 1] * (box[..., 3] - box[..., 1]),
                    rng.integers(0, 3, size=(batch, max_gt, t,
                                             NUM_KEYPOINTS))], axis=-1)
    n = rng.integers(n_range[0], n_range[1] + 1, size=batch)
    valid = np.arange(max_gt)[None, :] < n[:, None]
    return {"gt_boxes": tubes, "gt_keypoints": kps.astype(np.float32),
            "gt_valid": valid}


def make_draws(seed: int, step: int):
    """The uniforms the samplers rank by, for one training step:
    draws(stage, b, n) → (u_fg, u_bg), each (b, n) float32 on the CPU,
    from a generator of (seed, step, stage)."""
    def draws(stage: str, b: int, n: int):
        u = torch.rand((2, b, n), generator=torch.Generator().manual_seed(
            derive(seed, "draws", step, stage)))
        return u[0], u[1]
    return draws
