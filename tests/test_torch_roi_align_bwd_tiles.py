"""The index half of the port's tile-owned RoIAlign backward, on the CPU.

The CUDA kernel visits, for each 8x8 tile of one (slab, level) map, the
pairs of that key's segment (`backward_segments`) whose footprint
(`backward_footprint`) meets the tile, and adds their separable weights'
products there. Held here: the footprint contains every nonzero tap of
`_taps` (special rois: degenerate, sub-pixel, off the map, NaN, 6:1,
image-sized) with at most the stated slack; the segments put every pair in
its key's segment in index order; and a plain emulation of the kernel's
tile walk on the CPU-visible prep (`backward_prep` on CPU tensors) equals
`roi_align_backward_reference` (f32 sums in another order: 1e-5, absolute
and relative; the clamped edge cells sum up to ~12)."""

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.kernels import roi_align as ra

SHAPES = [(3, 40, 48, 4), (3, 20, 24, 4), (3, 10, 12, 4)]
STRIDES = [4, 8, 16]
TILE = 8


def _rois(rng, n_random=12):
    """Every special kind, then random boxes (image coordinates, a 192x160
    image at stride 4)."""
    nan = float("nan")
    special = np.array([
        [50, 50, 50, 50],                   # degenerate
        [100.2, 60.1, 100.7, 60.6],         # sub-pixel
        [-300, -200, -20, -10],             # wholly off the map
        [300, 250, 700, 600],               # partly off the map
        [10, 100, 370, 160],                # 6:1
        [120, 5, 180, 155],                 # 1:6
        [-500, -500, 2000, 2000],           # larger than the image
        [0, 0, 191, 159],                   # image-sized
        [nan, 10, 40, 50],                  # NaN corners
        [10, 10, nan, 50],
        [nan, nan, nan, nan],
        [188, 156, 191, 159],               # samples clamp to the last cell
    ], np.float32)
    rand = rng.uniform(-20, 190, (n_random, 4)).astype(np.float32)
    rand[:, 2:] = rand[:, :2] + rng.uniform(0.3, 120, (n_random, 2))
    return torch.from_numpy(np.concatenate([special, rand]))


def _case(seed, with_levels):
    rng = np.random.default_rng(seed)
    rois = _rois(rng)
    n = rois.shape[0]
    # Out-of-range slabs and levels clamp, as in the kernels.
    slabs = torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32))
    levels = (torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32))
              if with_levels else None)
    return rois, slabs, levels


def _tap_cells(rois, slabs, levels, p):
    """(level, slab, y, x) of every nonzero tap of each pair, from `_taps`'
    flat row indices."""
    n = rois.shape[0]
    lvl = ra._level_index(levels, n, "cpu")
    taps = ra._taps(SHAPES, STRIDES, rois, slabs, lvl, p, 2)
    sizes = [sh[0] * sh[1] * sh[2] for sh in SHAPES]
    offs = np.cumsum([0] + sizes)
    cells = [[] for _ in range(n)]
    for idx, w in taps:
        idx, w = idx.reshape(n, -1).numpy(), w.reshape(n, -1).numpy()
        for i in range(n):
            for row in idx[i][w[i] != 0]:
                level = int(np.searchsorted(offs, row, side="right")) - 1
                _, h, wd, _ = SHAPES[level]
                rest = row - offs[level]
                cells[i].append((level, rest // (h * wd),
                                 (rest % (h * wd)) // wd, rest % wd))
    return cells


@pytest.mark.parametrize("with_levels", [True, False])
@pytest.mark.parametrize("p", [7, 14])
def test_footprint_contains_every_tap(p, with_levels):
    rois, slabs, levels = _case(p + with_levels, with_levels)
    fp = ra.backward_footprint(SHAPES, STRIDES, rois, levels, p, 2).numpy()
    keys = ra.backward_keys(3, len(SHAPES), slabs, levels).numpy()
    assert fp.dtype == np.int32 and fp.shape == (rois.shape[0], 4)
    for i, cells in enumerate(_tap_cells(rois, slabs, levels, p)):
        y0, y1, x0, x1 = fp[i]
        if not cells:
            assert (y0, y1, x0, x1) == (0, 0, 0, 0), i
            continue
        ys = [c[2] for c in cells]
        xs = [c[3] for c in cells]
        assert {(c[1], c[0]) for c in cells} == {divmod(keys[i], 3)}, i
        _, h, w, _ = SHAPES[cells[0][0]]
        # Every tap inside; widened by one cell below, by one or two above
        # (a valid sample's zero-weight upper corner counts), clamped.
        assert y0 == max(min(ys) - 1, 0) and x0 == max(min(xs) - 1, 0), i
        assert min(max(ys) + 2, h) <= y1 <= min(max(ys) + 3, h), i
        assert min(max(xs) + 2, w) <= x1 <= min(max(xs) + 3, w), i
    assert np.isnan(rois.numpy()).any(axis=1).sum() == 3
    assert not fp[8:11].any()                   # the NaN rois


@pytest.mark.parametrize("n,with_levels", [(40, True), (40, False), (0, True)])
def test_segments_put_each_pair_in_its_key_in_index_order(n, with_levels):
    rng = np.random.default_rng(n + with_levels)
    slabs = torch.from_numpy(rng.integers(-2, 6, n).astype(np.int32))
    levels = (torch.from_numpy(rng.integers(-1, 5, n).astype(np.int32))
              if with_levels else None)
    n_slabs, n_levels = 4, 3
    keys = ra.backward_keys(n_slabs, n_levels, slabs, levels)
    lvl = (levels.numpy().clip(0, n_levels - 1) if with_levels
           else np.zeros(n, np.int64))
    np.testing.assert_array_equal(
        keys.numpy(), slabs.numpy().clip(0, n_slabs - 1) * n_levels + lvl)
    order, seg = ra.backward_segments(keys, n_slabs * n_levels)
    assert order.dtype == torch.int64 and seg.dtype == torch.int32
    assert seg.shape == (n_slabs * n_levels + 1,) and int(seg[-1]) == n
    assert int(seg[0]) == 0 and bool((seg[1:] >= seg[:-1]).all())
    for k in range(n_slabs * n_levels):
        got = order[seg[k]:seg[k + 1]].numpy()
        np.testing.assert_array_equal(got, np.flatnonzero(keys.numpy() == k))


def _axis_weights(start, end, p, s, size):
    """One pair's separable weights along one axis: (size, P), the sum of
    wlo / whi over the valid samples landing on each cell, times 1/s."""
    iy = (torch.arange(p, dtype=torch.float32)[:, None]
          + (torch.arange(s, dtype=torch.float32)[None, :] + 0.5) / s
          ).reshape(-1)
    c = start + iy * ((end - start).clamp(min=1.0) / p)
    valid = (c >= -1.0) & (c <= size)
    cc = torch.minimum(c.nan_to_num(0.0).clamp(min=0.0),
                       torch.tensor(size - 1.0))
    lo = torch.floor(cc).long()
    hi = torch.minimum(lo + 1, torch.tensor(size - 1))
    whi = (cc - torch.floor(cc)) * valid
    wlo = (1.0 - (cc - torch.floor(cc))) * valid
    w = torch.zeros((size, p * s))
    cols = torch.arange(p * s)
    w.index_put_((lo, cols), wlo, accumulate=True)
    w.index_put_((hi, cols), whi, accumulate=True)
    return w.reshape(size, p, s).sum(-1) / s


def _tiled_backward(rois, slabs, levels, grad, p, s=2):
    """The kernel's walk in plain torch: every tile of every (slab, level)
    visits its key's segment in order and takes the pairs whose footprint
    meets it; each adds Wy[rows] @ (grad · Wx[cols]) into its cells."""
    keys, fp = ra.backward_prep(SHAPES, STRIDES, rois, slabs, levels, p, s)
    n_lvl = len(SHAPES)
    order, seg = ra.backward_segments(keys, SHAPES[0][0] * n_lvl)
    outs = [torch.full(sh, float("nan")) for sh in SHAPES]
    lvl_of = ra._level_index(levels, rois.shape[0], "cpu").clamp(0, n_lvl - 1)
    visits = 0
    for lvl, (n_slabs, h, w, _) in enumerate(SHAPES):
        scale = 1.0 / STRIDES[lvl]
        for slab in range(n_slabs):
            key = slab * n_lvl + lvl
            pairs = order[seg[key]:seg[key + 1]].tolist()
            for ty in range(0, h, TILE):
                for tx in range(0, w, TILE):
                    acc = torch.zeros((min(TILE, h - ty), min(TILE, w - tx),
                                       grad.shape[-1]))
                    for i in pairs:
                        y0, y1, x0, x1 = fp[i].tolist()
                        if not (y0 < ty + TILE and y1 > ty
                                and x0 < tx + TILE and x1 > tx):
                            continue
                        assert int(lvl_of[i]) == lvl
                        visits += 1
                        r = rois[i] * scale
                        wy = _axis_weights(r[1], r[3], p, s, h)[ty:ty + TILE]
                        wx = _axis_weights(r[0], r[2], p, s, w)[tx:tx + TILE]
                        rows = torch.einsum("xq,pqc->pxc", wx, grad[i])
                        acc += torch.einsum("yp,pxc->yxc", wy, rows)
                    outs[lvl][slab, ty:ty + TILE, tx:tx + TILE] = acc
    return outs, visits


@pytest.mark.parametrize("with_levels", [True, False])
@pytest.mark.parametrize("p", [7, 14])
def test_tile_walk_on_cpu_prep_matches_reference(p, with_levels):
    rois, slabs, levels = _case(20 + p + with_levels, with_levels)
    rng = np.random.default_rng(p)
    grad = torch.from_numpy(rng.normal(
        size=(rois.shape[0], p, p, 4)).astype(np.float32))
    got, visits = _tiled_backward(rois, slabs, levels, grad, p)
    want = ra.roi_align_backward_reference(SHAPES, torch.float32, STRIDES,
                                           rois, slabs, levels, grad, p, 2)
    assert visits > 0
    for g, r in zip(got, want):
        assert not g.isnan().any()          # every cell written once
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert any(float(r.abs().sum()) > 0 for r in want)
    # The wrapper on CPU tensors is the plain version.
    for g, r in zip(ra.roi_align_backward(SHAPES, torch.float32, STRIDES,
                                          rois, slabs, levels, grad, p, 2),
                    want):
        assert torch.equal(g, r)
