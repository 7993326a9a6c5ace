"""flightjax_torch — the flightjax flight-dynamics engine in PyTorch, with the
hot per-aircraft clusters of the fleet step as hand-written CUDA kernels.

The JAX package `flightjax` is the reference: every module here names the
`flightjax` module it ports, keeps its state layout (nested dicts of
batch-leading tensors) and its association order, so the two agree to
rounding in float64 on the CPU.

Conventions that differ from the JAX package:
- the fleet (batch) dimension is written out: every per-aircraft scalar is
  a `[B]` tensor, every 3-vector `[B, 3]`, where JAX used `vmap`;
- every constructor takes an explicit `device` and `dtype`; nothing relies
  on `torch.get_default_dtype()`;
- a CUDA kernel wrapper (`parallel/kernels.py`) launches its kernel for a
  CUDA tensor and runs its plain PyTorch version for a CPU tensor.

This package never imports `jax`.
"""

__version__ = "0.1.0"
