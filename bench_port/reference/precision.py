"""The arithmetic precision of the reference's products.

The reference computes every convolution, dense layer and attention product
in IEEE float32 (``"f32"``: TF32 off in cuDNN and cuBLAS). The controls put
the reference in the program's place one precision lower than the
configuration states: ``"tf32"`` (TF32 on) for a float32 configuration, and
``"fp8"`` for a bfloat16 one, where both operands of each product the
program runs in bfloat16 are rounded to float8 e4m3 with one scale per
tensor (the largest magnitude maps to 448) and the product is taken in
float32. Products the program runs in float32 stay float32 in every mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def products(tf32: bool, search: bool):
    """TF32 on or off in cuDNN and cuBLAS for the duration, and cuDNN's
    algorithm search on or off (any algorithm it picks computes in the
    precision set here). The search pays off over the many calls of a
    sampling reference; over three training steps it costs more than the
    steps (31 s against 2 s, on the H100)."""
    b = torch.backends
    prev = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = tf32
    b.cudnn.benchmark = search
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.benchmark) = prev


def stored(P, rule):
    """The weights as a configuration's sampling policy stores them:
    ``rule = {"dtype": "bfloat16", "keep_float32": [tokens]}`` rounds every
    leaf to ``dtype`` (and back to float32) unless a dot-separated part of
    its name contains one of the tokens. ``rule`` None keeps them all."""
    if not rule:
        return dict(P)
    dt = getattr(torch, rule["dtype"])
    keep = rule["keep_float32"]
    return {k: (v if any(tok in part for part in k.split(".")
                         for tok in keep)
                else v.to(dt).float())
            for k, v in P.items()}


class _RoundFp8(torch.autograd.Function):
    """Round to scaled float8 e4m3 and back; the gradient passes straight
    through."""

    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """``mode`` for the products a configuration runs in its compute dtype
    (``low=True``); float32 for the others. ``search``: cuDNN's algorithm
    search (:func:`products`)."""

    def __init__(self, mode: str = "f32", search: bool = True):
        if mode not in MODES:
            raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
        self.mode, self.search = mode, search

    def _q(self, t: torch.Tensor, low: bool) -> torch.Tensor:
        t = t.float()
        if low and self.mode == "fp8" and t.device.type != "meta":
            return _RoundFp8.apply(t)
        return t

    def conv(self, x_nhwc, w, b, stride=1, pad=(1, 1, 1, 1), low=True):
        """NHWC convolution with explicit (left, right, top, bottom)
        padding; both operands channels-last, cuDNN's fast layout."""
        cl = torch.channels_last
        xc = self._q(x_nhwc, low).permute(0, 3, 1, 2)
        padding = 0
        if pad[0] == pad[1] == pad[2] == pad[3]:
            padding = pad[0]
        else:
            xc = F.pad(xc, pad)
        y = F.conv2d(xc.contiguous(memory_format=cl),
                     self._q(w, low).contiguous(memory_format=cl), b.float(),
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def linear(self, x, w, b, low=True):
        return F.linear(self._q(x, low), self._q(w, low), b.float())

    def einsum(self, eq, a, b, low=True):
        return torch.einsum(eq, self._q(a, low), self._q(b, low))

    def context(self):
        """TF32 on for ``"tf32"``, off otherwise."""
        return products(tf32=self.mode == "tf32", search=self.search)
