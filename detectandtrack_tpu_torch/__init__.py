"""detectandtrack_tpu_torch — the PyTorch/CUDA port of detectandtrack_tpu.

The JAX package (`detectandtrack_tpu`) is the reference; this package runs
the same 3D Mask R-CNN detect → track inference path in PyTorch, with the
two Pallas TPU kernels of that path rewritten as CUDA C++ kernels for
Hopper (`csrc/`, built with nvcc on first use and bound with ctypes).

Public functions keep the JAX package's layouts: clips (B, T, H, W, 3),
pyramid maps channels-last (B, T, H, W, C), pooled RoI features
(S, K, P, P, C) and padded detections (B, D, ...). The port keeps its own
copies of the JAX package's framework-free modules (`core/config.py`,
`ops/anchors.py`, `tracking/`, the Hungarian solver `csrc/hungarian.cpp`):
nothing here imports jax, flax or the JAX package. Its entry points run on
the CUDA card unless given a CPU device (`build_model(cfg, device="cpu")`).
"""

__version__ = "0.1.0"
