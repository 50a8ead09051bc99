"""The benchmark of ``spectrobot_tpu_torch`` (the PyTorch and CUDA port):
cells of a configuration and a traffic mix named in ``BENCHMARK.json``,
the plain reference that decides each run's ``correct``, and the
yardstick of roofline bounds and trace arithmetic.  It imports nothing of
JAX or of the JAX package ``spectrobot_tpu``."""
