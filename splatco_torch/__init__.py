"""splatco_torch — the PyTorch/CUDA port of splatco_tpu for NVIDIA Hopper.

The layout mirrors `splatco_tpu/`: each module here has its counterpart
under the same relative path there, and the JAX package is the reference
the port is tested against.  This package imports `torch` and never
`jax`, nor anything of `splatco_tpu`.

Entry points that create tensors (`init_model`, `params_from_numpy`,
`make_camera`, `load_trained`, ...) take a `device` argument and run on
`cuda` unless the caller passes `device="cpu"`; on a machine without a
card they raise rather than fall back.  Functions that take tensors run
where their inputs lie.  A kernel wrapper launches its CUDA kernel for
CUDA tensors and uses the kernel's plain PyTorch version only for CPU
tensors.  Everything is float32, as in the JAX package.
"""
