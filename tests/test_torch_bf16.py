"""bf16 — the dtype every shipped config runs in — held against the JAX
package on the CPU: the small R-18 T=2 model (test_torch_slice's golden
model) in `MODEL.COMPUTE_DTYPE bfloat16` in both packages, on bridged
seeded weights, one clip.

Tolerances are counted in bf16 ulps at the largest |value| of the JAX
output (an ulp of x is 2^(floor(log2 |x|) - 7)):

- every module output both packages expose under one name (the backbone's
  convs, affines and blocks, FPN, RPN head, box head, keypoint head; 86
  of them): at most 4 ulps, and at most 1 ulp on average. Measured: at
  most 2.8 ulps (the box head's f32 class logits, fed by the bf16 fc7),
  2 ulps in the backbone and FPN, mean at most 0.9 ulp (0.0000 at conv1,
  growing to 0.2 through the backbone). A cast placed differently from
  JAX's (a bf16 op where JAX runs f32, or the reverse) changes the
  rounding of a whole tensor and shows as a mean error of many ulps from
  that module on; rounding-order noise between two libraries stays
  within an ulp or two;
- the pyramid, boxes and keypoint heatmaps end to end: 4 ulps (measured:
  pyramid 1.5, heatmaps 1.9, boxes 0.3); the valid masks equal;
- scores: a two-class softmax moves by at most 1/4 of the change of the
  logits' difference, so 0.25 · 2 · (4 ulps of the largest class logit)
  (measured 0.0081 against 0.0156).

Decoded keypoints are not held: random-weight heatmaps are nearly flat,
and a 1-ulp heatmap difference moves an argmax (measured up to 6.9 px).
`pytest -s` prints the measured figures.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import GOLDEN_OPTS, _np, _pair

BF16_OPTS = [("bfloat16" if x == "float32" else x) for x in GOLDEN_OPTS]
MODULE_ULPS, MODULE_MEAN_ULPS, OUTPUT_ULPS = 4.0, 1.0, 4.0


def _ulp(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _flax_calls(tree, path=()):
    """capture_intermediates tree → {'a/b': first call's output}."""
    out = {}
    for key, value in tree.items():
        if key == "__call__":
            out["/".join(path)] = value[0]
        elif isinstance(value, dict):
            out.update(_flax_calls(value, path + (key,)))
    return out


@pytest.fixture(scope="module")
def runs():
    clip = np.random.default_rng(42).normal(size=(1, 2, 64, 96, 3)).astype(
        np.float32)
    cfg, jm, params, tm = _pair(None, BF16_OPTS, clip.shape)
    assert cfg.MODEL.COMPUTE_DTYPE == "bfloat16"
    apply = jax.jit(functools.partial(jm.apply, capture_intermediates=True,
                                      mutable=["intermediates"]))
    jout, inter = apply(params, jnp.asarray(clip))
    jcalls = _flax_calls(inter["intermediates"])
    tcalls = {}

    def record(key):
        def hook(module, args, out):       # returns None: output unchanged
            tcalls.setdefault(key, out)
        return hook

    hooks = [m.register_forward_hook(record(name.replace(".", "/")))
             for name, m in tm.named_modules() if name]
    try:
        with torch.no_grad():
            tout = tm(torch.from_numpy(clip))
    finally:
        for h in hooks:
            h.remove()
    return jout, tout, jcalls, tcalls


def test_bf16_module_outputs_match_jax(runs):
    _, _, jcalls, tcalls = runs
    compared = {}
    for name, want in jcalls.items():
        got = tcalls.get(name)
        if isinstance(want, tuple):
            want, got = want[0], got[0] if got is not None else None
        if not hasattr(want, "shape") or not torch.is_tensor(got):
            continue
        if tuple(got.shape) != tuple(want.shape):  # torch's NCHW deconv
            got = got.movedim(1, -1)
        assert tuple(got.shape) == tuple(want.shape), name
        assert got.dtype == getattr(torch, str(want.dtype)), name
        ref = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - ref)
        ulp = _ulp(ref)
        compared[name] = (err.max() / ulp, err.mean() / ulp)
    assert len(compared) >= 80
    assert {n.split("/")[0] for n in compared} >= {
        "backbone", "fpn", "rpn_head", "box_head", "kps_head"}
    worst = max(compared, key=lambda n: compared[n][0])
    print(f"bf16 module outputs: {len(compared)}, worst {worst} "
          f"{compared[worst][0]:.2f} ulps, largest mean "
          f"{max(e[1] for e in compared.values()):.3f} ulps")
    bad = {n: e for n, e in compared.items()
           if not (e[0] <= MODULE_ULPS and e[1] <= MODULE_MEAN_ULPS)}
    assert not bad, bad


def test_bf16_detections_match_jax(runs):
    jout, tout, jcalls, _ = runs
    valid = np.asarray(jout["valid"])
    np.testing.assert_array_equal(_np(tout["valid"]), valid)
    assert valid.any()
    for key in ("boxes", "heatmaps"):
        ref = np.asarray(jout[key], np.float32)
        tol = OUTPUT_ULPS * _ulp(ref)
        got = _np(tout[key])
        if key == "boxes":
            got, ref = got[valid], ref[valid]
        print(f"bf16 {key}: {np.abs(got - ref).max() / _ulp(ref):.2f} ulps")
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=key)
    logits = np.asarray(jcalls["box_head/cls_score"], np.float32)
    score_tol = 0.25 * 2 * OUTPUT_ULPS * _ulp(logits)
    scores = (_np(tout["scores"])[valid], np.asarray(jout["scores"])[valid])
    print(f"bf16 scores: {np.abs(scores[0] - scores[1]).max():.4f} "
          f"(tol {score_tol:.4f})")
    np.testing.assert_allclose(*scores, rtol=0, atol=score_tol)


def test_bf16_pyramid_matches_jax(runs):
    _, _, jcalls, tcalls = runs
    for level in ("p2", "p3", "p4", "p5"):
        ref = np.asarray(jcalls[f"fpn/posthoc_{level}"], np.float32)
        got = tcalls[f"fpn/posthoc_{level}"]
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - ref).max()
        print(f"bf16 {level}: {err / _ulp(ref):.2f} ulps")
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=OUTPUT_ULPS * _ulp(ref),
                                   err_msg=level)
