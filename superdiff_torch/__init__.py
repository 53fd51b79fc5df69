"""superdiff_torch — the PyTorch/CUDA port of superdiff_tpu for NVIDIA Hopper.

Same layout and function names as the JAX package (``diffusion/``,
``models/``, ``ops/``, ``data/``, ``training/``, ``utils/``, ``compat/``,
``cli/``, ``config.py``, ``checkpoint.py``, ``inference.py``); PyTorch idiom
inside (``nn.Module``s, explicit
``device=`` arguments that default to ``"cuda"``, explicit
``torch.Generator``s). Public tensors keep the JAX layout: images NHWC
``(B, H, W, C)``, attention ``(B, S, H, D)``, integer labels.

The package imports torch, numpy and the standard library only — never
jax, flax or superdiff_tpu — so it runs on a machine that has none of
them. Hand-written CUDA kernels live in ``csrc/`` and are compiled with
``nvcc`` at first use (``ops/flash_attention.py``).
"""

__version__ = "0.1.0"
