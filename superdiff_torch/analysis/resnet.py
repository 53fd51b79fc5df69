"""ResNet-18 feature extractor from torchvision-format checkpoints.

Port of ``superdiff_tpu/analysis/resnet.py``: a locally saved torchvision
``resnet18`` ``state_dict`` (``torch.save`` file or an ``.npz`` with the
same keys) runs as plain functional PyTorch on the device. Inference only:
parameters are a plain dict of tensors in torch's OIHW layout, BatchNorm in
inference form from the running statistics (``(x - mean) * (rsqrt(var +
eps) * scale) + bias``), the RGB ``conv1`` summed over its input channels
for grayscale (the same as feeding the gray image three times), and the
features the 512-d global average pool before ``fc``. Images are NHWC, as
everywhere in the port; the convolutions run NCHW through cuDNN.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# torchvision resnet18 topology: (name, blocks, channels, first stride)
_LAYERS = (("layer1", 2, 64, 1), ("layer2", 2, 128, 2),
           ("layer3", 2, 256, 2), ("layer4", 2, 512, 2))


def _reader(state_dict, arch: str):
    def arr(key, expect_ndim=None) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(f"checkpoint missing {key!r} — not a "
                           f"torchvision {arch} state_dict?")
        v = state_dict[key]
        v = (v.detach().cpu().float() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v, dtype=np.float32)))
        if expect_ndim is not None and v.ndim != expect_ndim:
            raise ValueError(f"{key}: expected {expect_ndim}D, "
                             f"got shape {tuple(v.shape)}")
        return v.contiguous()

    def bn(prefix):
        return {"scale": arr(f"{prefix}.weight", 1),
                "bias": arr(f"{prefix}.bias", 1),
                "mean": arr(f"{prefix}.running_mean", 1),
                "var": arr(f"{prefix}.running_var", 1)}

    return arr, bn


def convert_torch_resnet18(state_dict, grayscale: bool = True) -> Dict:
    """torchvision ``state_dict`` (tensors or numpy) -> the parameter dict
    :func:`resnet18_features` takes (CPU float32 tensors; move them with
    ``FeatureExtractor`` or by hand). Every expected key and rank is
    checked, so a wrong checkpoint fails loudly."""
    arr, bn = _reader(state_dict, "resnet18")
    w1 = arr("conv1.weight", 4)                     # (64, C_in, 7, 7)
    if grayscale and w1.shape[1] == 3:
        w1 = w1.sum(dim=1, keepdim=True)
    params: Dict = {"conv1": w1, "bn1": bn("bn1")}
    for name, blocks, _, _ in _LAYERS:
        layer = []
        for b in range(blocks):
            p = f"{name}.{b}"
            blk = {"conv1": arr(f"{p}.conv1.weight", 4),
                   "bn1": bn(f"{p}.bn1"),
                   "conv2": arr(f"{p}.conv2.weight", 4),
                   "bn2": bn(f"{p}.bn2")}
            if f"{p}.downsample.0.weight" in state_dict:
                blk["down_conv"] = arr(f"{p}.downsample.0.weight", 4)
                blk["down_bn"] = bn(f"{p}.downsample.1")
            layer.append(blk)
        params[name] = layer
    if "fc.weight" in state_dict:
        params["fc"] = {"weight": arr("fc.weight", 2),
                        "bias": arr("fc.bias", 1)}
    return params


def load_torch_resnet18(path: str, grayscale: bool = True) -> Dict:
    """Load and convert a locally saved torchvision resnet18 state dict
    (``.npz`` with the same key names, or a ``torch.save`` file)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return convert_torch_resnet18(dict(data), grayscale)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_torch_resnet18(sd, grayscale)


def bn_inference(x: torch.Tensor, p: Dict, eps: float = 1e-5):
    """BatchNorm from running statistics on an NCHW tensor."""
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return ((x - p["mean"][:, None, None]) * inv[:, None, None]
            + p["bias"][:, None, None])


def _basic_block(x, blk, stride):
    h = F.relu(bn_inference(F.conv2d(x, blk["conv1"], stride=stride,
                                     padding=1), blk["bn1"]))
    h = bn_inference(F.conv2d(h, blk["conv2"], padding=1), blk["bn2"])
    if "down_conv" in blk:
        x = bn_inference(F.conv2d(x, blk["down_conv"], stride=stride),
                         blk["down_bn"])
    return F.relu(h + x)


def resnet18_feature_map(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 1) -> (B, h, w, 512)``: the layer4 output before the
    pool."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(bn_inference(F.conv2d(h, params["conv1"], stride=2,
                                     padding=3), params["bn1"]))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for name, _, _, stride in _LAYERS:
        for b, blk in enumerate(params[name]):
            h = _basic_block(h, blk, stride if b == 0 else 1)
    return h.permute(0, 2, 3, 1)


def resnet18_features(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 1) -> (B, 512)`` pooled features (pre-fc): 7x7/2 stem,
    3x3/2 max pool, four 2-block stages, global average pool."""
    return resnet18_feature_map(params, x).mean(dim=(1, 2))


def resnet18_logits(params: Dict, feature_map: torch.Tensor) -> torch.Tensor:
    """The classifier head on a layer4 feature map ``(B, h, w, 512)``: the
    global average pool, then ``fc``. Needs a checkpoint converted with its
    ``fc`` (``convert_torch_resnet18`` keeps it when present)."""
    if "fc" not in params:
        raise KeyError("checkpoint was converted without its fc head — "
                       "Grad-CAM needs the classifier logits")
    pooled = feature_map.mean(dim=(1, 2))
    return pooled @ params["fc"]["weight"].T + params["fc"]["bias"]
