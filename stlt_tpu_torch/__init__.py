"""stlt_tpu_torch: the PyTorch/CUDA port of stlt_tpu for NVIDIA Hopper.

A package beside ``stlt_tpu`` (the JAX reference, which it never imports).
It serves, evaluates and trains the six factory models (``predict``,
``inference``, ``train``) through hand-written CUDA kernels (``ops/``,
sources in ``csrc/``), and serves STLT frame-sharded over several processes
(``parallel/``, ``ops/ring.py``).
"""
