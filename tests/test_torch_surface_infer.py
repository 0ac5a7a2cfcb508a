"""The port's inference entry points of the model surface against the JAX
engine's on the CPU, with bridged seeded weights: the KPS_AUG pair
(`make_kps_aug_fns`: per-scale heatmaps with the mirrored pass, averaged
over scales and decoded once) on the center-frame T=3 model, and
`make_detect_fn` with masks into the host hand-off.

Tolerances: heatmaps 1e-4 of their largest entry, keypoints 1e-2, mask
probabilities 1e-4; the host hand-off exact on the same outputs."""

import jax.numpy as jnp
import numpy as np
import torch

from detectandtrack_tpu.engine import inference as jinf
from detectandtrack_tpu_torch.engine import inference as tinf
from test_torch_configs import small_opts
from test_torch_slice import _np, _pair

SCALES = ((64, 96), (96, 128))


def test_kps_aug_fns_match_jax():
    name = "3d_R18_T3_center_kps"
    rng = np.random.default_rng(21)
    t, d = 3, 12
    clips = [rng.normal(size=(1, t, h, w, 3)).astype(np.float32)
             for h, w in SCALES]
    cfg, jm, params, tm = _pair(f"configs/video/{name}.yaml",
                                small_opts(name), clips[0].shape, seed=22)
    assert not cfg.VIDEO.PREDICT_ALL_FRAMES
    x1 = rng.uniform(0, 60, (1, d, t, 2))
    wh = rng.uniform(12, 36, (1, d, t, 2))
    boxes = np.concatenate([x1, x1 + wh], -1).reshape(1, d, 4 * t).astype(
        np.float32)
    scaled = [boxes * np.float32(h / SCALES[0][0]) for h, _ in SCALES]

    j_hm, j_dec = jinf.make_kps_aug_fns(jm, flip=True)
    t_hm, t_dec = tinf.make_kps_aug_fns(tm, flip=True)
    j_hms = [j_hm(params, jnp.asarray(c), jnp.asarray(b))
             for c, b in zip(clips, scaled)]
    t_hms = [t_hm(torch.from_numpy(c), torch.from_numpy(b))
             for c, b in zip(clips, scaled)]
    m_kp = min(cfg.KRCNN.MAX_ROIS_PER_IM or d, d)
    for jh, th in zip(j_hms, t_hms):
        assert tuple(th.shape) == jh.shape == (1, m_kp, 1, 28, 28, 15)
        np.testing.assert_allclose(
            th.numpy(), np.asarray(jh),
            atol=1e-4 * max(1.0, float(np.abs(np.asarray(jh)).max())))
    # Both decode the same stacked heatmaps: with random weights the
    # heatmaps are nearly flat, and a 1e-6 difference can move an argmax.
    stacked = np.stack([np.asarray(h) for h in j_hms])
    want = np.asarray(j_dec(params, jnp.asarray(stacked),
                            jnp.asarray(boxes)))
    got = t_dec(torch.from_numpy(stacked), torch.from_numpy(boxes)).numpy()
    assert got.shape == want.shape == (1, d, t, 15, 4)
    np.testing.assert_array_equal(got[:, :, 0], got[:, :, 2])
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_detect_fn_masks_into_frames_match_jax():
    """make_detect_fn of the mask model: the person channel's sigmoid on
    the device, then clip_slice / detections_to_frames carry it per frame
    as the JAX engine does."""
    name = "2d_R50_FPN_mask_kps"
    clip = np.random.default_rng(23).normal(size=(2, 1, 64, 96, 3)).astype(
        np.float32)
    cfg, jm, params, tm = _pair(f"configs/video/{name}.yaml",
                                small_opts(name), clip.shape, seed=24)
    want = jinf.make_detect_fn(jm)(params, jnp.asarray(clip))
    got = tinf.make_detect_fn(tm)(torch.from_numpy(clip))
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(_np(got["valid"]), valid)
    assert got["masks"].shape == want["masks"].shape == (2, 12, 1, 28, 28)
    np.testing.assert_allclose(_np(got["masks"])[valid],
                               np.asarray(want["masks"])[valid], atol=1e-4)
    det_np = {k: _np(v) for k, v in got.items()}
    for i in range(2):
        frames = tinf.detections_to_frames(tinf.clip_slice(got, i), 1, 0.5)
        ref = jinf.detections_to_frames(jinf.clip_slice(det_np, i), 1, 0.5)
        assert len(frames) == len(ref) == 1
        assert set(frames[0]) == set(ref[0]) and "masks" in frames[0]
        for k in ref[0]:
            np.testing.assert_array_equal(frames[0][k], ref[0][k], err_msg=k)
