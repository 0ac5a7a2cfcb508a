"""The port's diagnostic kernel D (kernels/diag_roialign.py) against the JAX
tool's Pallas `mini_kernel` (tools/diag_roialign.py), on the CPU.

One module fixture runs `mini_kernel` in Pallas interpret mode, inside the
same `PrefetchScalarGridSpec` as the tool's `run_variant`, for the four
variants at p=7 and `full` at p=14, on maps of (1, 64, 128, 256) per level
and 4 pairs made from a numpy seed: one roi's x1 >= 72 (its column offset
clips to 64) and levels -1 and 5 (outside [0, 3], clamped). The port's
`diag_pool` on CPU tensors (its plain version) must match: full and
noswitch within 2^-6 of max|JAX| (the repo's bf16 tolerance), nodot and
nodma exactly. JAX's nodma pools an uninitialised VMEM scratch; the test
runs it with zeroed scratch, which the port defines as its resident patch.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from detectandtrack_tpu_torch.kernels import diag_roialign as dr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 128)
C = 256
X1 = [3.3, 75.2, 40.7, 63.6]            # 75.2: ox = 72 clips to 64
LEVELS = [-1, 5, 2, 1]                   # -1 and 5 clamp to 0 and 3
CASES = [("full", 7), ("noswitch", 7), ("nodot", 7), ("nodma", 7),
         ("full", 14)]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_diag_roialign", os.path.join(REPO, "tools", "diag_roialign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs():
    """Maps as bf16 values (rounded once, by torch), rois (4n,), levels."""
    rng = np.random.default_rng(7)
    maps = [torch.from_numpy(rng.normal(size=(1,) + HW + (C,)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4)]
    rois = rng.uniform(0, 64, size=(len(X1), 4)).astype(np.float32)
    rois[:, 0] = X1
    return (maps, torch.from_numpy(rois.reshape(-1)),
            torch.tensor(LEVELS, dtype=torch.int32))


def _run_jax(tool, variant, p, maps, rois, levels):
    n, n_lvl = levels.shape[0], len(maps)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(n,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_lvl,
        out_specs=pl.BlockSpec((1, p, p, C), lambda i, *_: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((tool.PATCH, tool.PATCH, C), jnp.bfloat16),
                        pltpu.VMEM((tool.PATCH, tool.PATCH, C), jnp.bfloat16),
                        pltpu.SemaphoreType.DMA((2,))])
    kern = functools.partial(tool.mini_kernel, p=p, n=n, n_lvl=n_lvl,
                             variant=variant)
    call = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n, p, p, C), jnp.bfloat16),
        grid_spec=grid_spec,
        interpret=pltpu.InterpretParams(uninitialized_memory="zero"))
    feats = [jnp.asarray(m.float().numpy(), jnp.bfloat16) for m in maps]
    out = call(jnp.asarray(rois.numpy()), jnp.asarray(levels.numpy()), *feats)
    return np.asarray(out.astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_outputs():
    tool = _jax_tool()
    maps, rois, levels = _inputs()
    return {(v, p): _run_jax(tool, v, p, maps, rois, levels)
            for v, p in CASES}


@pytest.mark.parametrize("variant,p", CASES)
def test_diag_pool_matches_jax_mini_kernel(jax_outputs, variant, p):
    maps, rois, levels = _inputs()
    got = dr.diag_pool(maps, rois, levels, p, variant)
    ref = jax_outputs[(variant, p)]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    err = np.abs(got.float().numpy() - ref).max()
    if variant in ("nodot", "nodma"):
        assert err == 0.0, err
    else:
        assert err <= 2.0 ** -6 * np.abs(ref).max(), err
    if variant != "nodma":
        assert np.abs(ref).max() > 0      # the case pools real values


def test_patch_origin_clips_offsets_and_clamps_levels():
    _, rois, levels = _inputs()
    lvl, ox = dr.patch_origin(rois, levels, 4, "full")
    assert lvl.tolist() == [0, 3, 2, 1]
    assert ox.tolist() == [0, 64, 40, 56]
    lvl0, _ = dr.patch_origin(rois, levels, 4, "noswitch")
    assert lvl0.tolist() == [0, 0, 0, 0]
    odd = torch.tensor([-9.5, 0, 0, 0, float("nan"), 0, 0, 0, 1e20, 0, 0, 0])
    _, ox = dr.patch_origin(odd, torch.zeros(3, dtype=torch.int32), 4, "full")
    assert ox.tolist() == [0, 0, 64]
    # Levels 0..3 each at one offset: 4 patches of 64x64 cells; noswitch
    # puts them all on level 0, where the four column ranges overlap.
    assert dr.patch_cells(rois, levels, 4, "full") == 4 * 64 * 64
    assert dr.patch_cells(rois, levels, 4, "noswitch") == 64 * 128


def test_plain_version_chunks_like_single_pairs():
    """More pairs than one chunk of the plain version: each pair's output
    equals the pair pooled alone."""
    rng = np.random.default_rng(3)
    maps = [torch.from_numpy(rng.normal(size=(1, 64, 128, 32)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    n = dr._REF_CHUNK + 5
    rois = torch.from_numpy(rng.uniform(-8, 80, size=(4 * n,)).astype(
        np.float32))
    levels = torch.from_numpy(rng.integers(-1, 3, size=(n,)).astype(
        np.int32))
    for variant in ("full", "nodot"):
        out = dr.diag_pool(maps, rois, levels, 3, variant)
        for i in (0, dr._REF_CHUNK - 1, dr._REF_CHUNK, n - 1):
            one = dr.diag_pool(maps, rois[4 * i:4 * i + 4], levels[i:i + 1],
                               3, variant)
            assert torch.equal(out[i:i + 1], one), (variant, i)


def test_diag_pool_raises_off_cpu_and_cuda():
    """The wrapper takes the plain version only for CPU tensors: a tensor
    on another device (here `meta`) raises, it does not fall back."""
    maps = [torch.empty((1, 64, 128, 32), dtype=torch.bfloat16,
                        device="meta") for _ in range(4)]
    rois = torch.empty((8,), device="meta")
    levels = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        dr.diag_pool(maps, rois, levels, 7, "full")


@pytest.mark.parametrize("bad", ["variant", "small_map", "p", "dtype"])
def test_diag_pool_rejects_what_it_cannot_take(bad):
    maps, rois, levels = _inputs()
    kw = {"variant": "full", "p": 7}
    if bad == "variant":
        kw["variant"] = "dense"
    elif bad == "small_map":
        maps = [m[:, :, :100] for m in maps]
    elif bad == "p":
        kw["p"] = dr.MAX_P + 1
    else:
        maps = [m.float() for m in maps]
    with pytest.raises(ValueError):
        dr.diag_pool(maps, rois, levels, **kw)
