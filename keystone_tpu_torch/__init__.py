"""keystone_tpu_torch — the PyTorch/CUDA port of the keystone_tpu package.

The JAX package ``keystone_tpu`` is the reference and is left as it is;
this package mirrors its layout module for module
(``keystone_tpu_torch/ops/fisher.py`` ↔ ``keystone_tpu/ops/fisher.py``).
It imports ``torch``, never JAX and nothing of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The TPU's Pallas kernels are hand-written CUDA C++ kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use (``kernels/build.py``),
never at import.
"""

__all__ = ["convert", "kernels", "models", "ops", "pipelines", "utils", "workflow"]
