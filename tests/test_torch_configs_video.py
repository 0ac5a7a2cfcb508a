"""The 3D configurations of configs/video/ in the port against the JAX
model; see tests/test_torch_configs.py for the method and tolerances."""

import pytest

from test_torch_configs import CONFIGS, _frames, check_config


@pytest.mark.parametrize("name", [n for n in CONFIGS if _frames(n) > 1])
def test_video_config_matches_jax(name):
    check_config(name)
