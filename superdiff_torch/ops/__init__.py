"""Ops: the hand-written CUDA flash-attention forward and backward
(``ops/flash_attention.py``) and the dispatching ``multihead_attention``;
the fused GroupNorm+FiLM+SiLU kernel (``ops/fused_norm.py``) and its plain
chain (``ops/packed_norm.py``); the kernels' build (``ops/_build.py``)."""

from superdiff_torch.ops.attention import multihead_attention  # noqa: F401
