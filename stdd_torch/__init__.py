"""stdd_torch — the PyTorch/CUDA port of stdd_tpu's live scoring path.

The JAX package ``stdd_tpu`` is the reference; this package keeps its module
names and layout so each counterpart is easy to find, and imports neither
JAX nor anything of ``stdd_tpu``. Hand-written CUDA kernels live under
``csrc/`` and are built with ``nvcc`` at first use (``utils/cuda_build.py``);
every kernel has a plain PyTorch twin in the same module, which is what a
CPU tensor runs through. Entry points default to ``device="cuda"``.
"""
