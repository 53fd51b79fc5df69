"""RefUNet — the reference's tiny time-conditioned CNN, as an ``nn.Module``.

Port of ``superdiff_tpu/models/unet_ref.py``. Despite its name the
reference "UNet" has no residual skips, no down/upsampling, no skip concats,
no attention and no class conditioning: five ``[GroupNorm(min(4, ch)) ->
SiLU -> Conv3x3] x 2`` blocks at full resolution, 1 -> 64 -> 128 -> 128 ->
64 -> 1 channels, each followed by an additive time bias ``Dense(t_emb)``
(no SiLU before it, unlike the CondUNet's ``emb_proj(SiLU(emb))``). It runs
in float32, convolutions included: its 3x3 convolutions run cuDNN in IEEE
float32 with TF32 off, in the forward and the backward, whatever PyTorch's
process-wide ``cudnn.allow_tf32`` says (:class:`Fp32Conv3x3`). Its dense
layers are a few ``(B, 256)`` products under PyTorch's float32 matmul
setting, IEEE unless a caller changes it.

Each block's two GroupNorm -> SiLU prologues are one
:class:`~superdiff_torch.models.layers.GroupNormSiLU`: on the card, kernel
B4. The JAX graph writes ``nn.GroupNorm`` + ``nn.silu`` there; the function
is the same, and the parameters (``weight`` / ``bias`` <-> Flax ``scale`` /
``bias``) bridge as any GroupNorm's. Submodule names
are the Flax ones (``time_mlp.dense_{0,1}``, ``down_0 ... up_1``, each with
``norm_0, conv_0, norm_1, conv_1, time_emb``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from superdiff_torch.models.layers import (
    GroupNormSiLU, TimeEmbeddingMLP, init_flax_defaults, linear)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Fp32Conv3x3(torch.autograd.Function):
    """3x3 stride-1 convolution with padding 1 (Flax SAME) on an NCHW view,
    whose forward and backward both run with cuDNN's TF32 off: the conv
    precision is the model's, not the process default's."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with _no_tf32():
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _no_tf32():
            return torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0],
                1, list(ctx.needs_input_grad))


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``m`` on NHWC float32 ``x`` through :class:`Fp32Conv3x3`; the NCHW
    view is channels-last, so PyTorch copies nothing on the way in or out
    (cuDNN's IEEE float32 engine transposes to NCHW inside the call)."""
    w = m.weight.float()
    if x.is_cuda and not w.is_contiguous(memory_format=torch.channels_last):
        w = w.contiguous(memory_format=torch.channels_last)
    y = Fp32Conv3x3.apply(x.float().permute(0, 3, 1, 2), w, m.bias.float())
    return y.permute(0, 2, 3, 1)


class RefResidualBlock(nn.Module):
    """``[GN(min(4, ch)) -> SiLU -> Conv3x3] x 2``, then ``h + Dense(t_emb)``
    (an additive bias, not FiLM, and no residual skip)."""

    def __init__(self, in_channels: int, out_channels: int,
                 time_emb_dim: int, device=None):
        super().__init__()
        self.norm_0 = GroupNormSiLU(min(4, in_channels), in_channels,
                                    device=device)
        self.conv_0 = nn.Conv2d(in_channels, out_channels, 3, device=device)
        self.norm_1 = GroupNormSiLU(min(4, out_channels), out_channels,
                                    device=device)
        self.conv_1 = nn.Conv2d(out_channels, out_channels, 3, device=device)
        self.time_emb = nn.Linear(time_emb_dim, out_channels, device=device)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv_0, self.norm_0(x))
        h = _conv(self.conv_1, self.norm_1(h))
        return h + linear(self.time_emb, t_emb,
                          torch.float32)[:, None, None, :]


class RefUNet(nn.Module):
    """The reference's model graph. ``parameterization`` says what the
    output means (eps / v / x0, read by the eps adapters and the training
    targets); it does not change the graph."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 time_emb_dim: int = 256, base_channels: int = 64,
                 parameterization: str = "eps", device="cuda"):
        super().__init__()
        if parameterization not in ("eps", "v", "x0"):
            raise ValueError("parameterization must be eps/v/x0, got "
                             f"{parameterization!r}")
        self.parameterization = parameterization
        bc, kw = base_channels, dict(time_emb_dim=time_emb_dim,
                                     device=device)
        self.time_mlp = TimeEmbeddingMLP(time_emb_dim, device=device)
        self.down_0 = RefResidualBlock(in_channels, bc, **kw)
        self.down_1 = RefResidualBlock(bc, bc * 2, **kw)
        self.mid = RefResidualBlock(bc * 2, bc * 2, **kw)
        self.up_0 = RefResidualBlock(bc * 2, bc, **kw)
        self.up_1 = RefResidualBlock(bc, out_channels, **kw)

    def init_parameters(self, seed: int = 0) -> "RefUNet":
        """Initialise for training with the Flax modules' default
        distributions (:func:`init_flax_defaults`; no zero-initialised
        kernel)."""
        return init_flax_defaults(self, seed)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``x (B, H, W, in_channels)``, ``t (B,)`` -> ``(B, H, W,
        out_channels)`` float32."""
        t_emb = self.time_mlp(t)
        h = x.float()
        for block in (self.down_0, self.down_1, self.mid, self.up_0,
                      self.up_1):
            h = block(h, t_emb)
        return h
