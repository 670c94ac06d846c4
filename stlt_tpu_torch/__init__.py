"""stlt_tpu_torch: the PyTorch/CUDA port of stlt_tpu for NVIDIA Hopper.

A package beside ``stlt_tpu`` (the JAX reference, which it never imports).
This slice serves the STLT eval path (``python -m stlt_tpu_torch.predict``)
through hand-written CUDA kernels for the two fused encoder ops
(``ops/fused_encoder.py``, sources in ``csrc/``).
"""
