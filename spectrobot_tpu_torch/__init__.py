"""PyTorch + CUDA port of spectrobot_tpu (one NVIDIA H100).

The JAX package :mod:`spectrobot_tpu` stays the reference; this package
imports ``torch`` and never ``jax``, and nothing of the JAX package.  It
keeps its own copies of the reference's jax-free host modules
(``constants``, ``config``, ``data.hitran``, ``data.hitran_native``,
``data.synth``, ``data.tips``, ``data.molparams``, ``retrieval.obs``,
``utils.checkpoint``, ``utils.runlog``, ``utils.plots``: the originals with
only their imports changed) and ports the device code, with the opacity
line sum, its forward-mode basis contraction and its reverse-mode transpose
in hand-written CUDA kernels (:mod:`spectrobot_tpu_torch.ops.cuda_opacity`,
:mod:`~spectrobot_tpu_torch.ops.cuda_basis`,
:mod:`~spectrobot_tpu_torch.ops.cuda_transpose`).
"""

__version__ = "0.1.0"
