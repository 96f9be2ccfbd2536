"""PyTorch/CUDA port of the Sprout serving path (counterpart of ``repro``).

The package imports ``torch``, numpy and the standard library only. It
never imports ``jax`` or any module of ``repro``: framework-free modules
are copied here under their original names, so ``repro_torch/X.py`` is the
counterpart of ``repro/X.py``. Every entry point takes ``device=`` and
defaults to ``"cuda"``; a CUDA tensor always goes to the hand-written
kernel (``kernels/csrc``), and only a tensor the caller put on the CPU
takes the plain PyTorch version.
"""
