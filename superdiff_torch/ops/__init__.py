"""Attention ops: the hand-written CUDA flash-attention forward
(``ops/flash_attention.py``) and the dispatching ``multihead_attention``."""

from superdiff_torch.ops.attention import multihead_attention  # noqa: F401
