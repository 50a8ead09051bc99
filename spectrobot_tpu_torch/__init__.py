"""PyTorch + CUDA port of spectrobot_tpu (one NVIDIA H100).

The JAX package :mod:`spectrobot_tpu` stays the reference; this package
imports ``torch`` and never ``jax``.  It reuses the reference's jax-free host
modules (``constants``, ``config``, ``data.hitran``, ``data.synth``,
``data.tips``, ``data.molparams``) and ports the device code, with the
opacity line sum in a hand-written CUDA kernel
(:mod:`spectrobot_tpu_torch.ops.cuda_opacity`).
"""

__version__ = "0.1.0"
