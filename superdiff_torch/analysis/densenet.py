"""DenseNet-121 feature extractor from torchvision-format checkpoints.

Port of ``superdiff_tpu/analysis/densenet.py``: a locally saved
torchvision or torchxrayvision DenseNet-121 ``state_dict`` (``features.*``
keys) runs as plain functional PyTorch on the device; a grayscale
``conv0`` is taken as it is, an RGB one is summed over its input channels.
Features are the global average pool of ``relu(norm5)``, 1024-d. Same
stance as ``analysis/resnet.py``: inference-only parameter dict (OIHW),
BatchNorm from running statistics, NHWC images.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from superdiff_torch.analysis.resnet import _reader, bn_inference

# DenseNet121: growth 32, stem 64, dense blocks of (6, 12, 24, 16) layers
_BLOCK_CONFIG = (6, 12, 24, 16)


def convert_torch_densenet121(state_dict, grayscale: bool = True) -> Dict:
    """torchvision/xrv DenseNet121 ``state_dict`` -> the parameter dict
    :func:`densenet121_features` takes (CPU float32 tensors); every
    expected key and rank is checked."""
    arr, bn = _reader(state_dict, "densenet121")
    w0 = arr("features.conv0.weight", 4)             # (64, C_in, 7, 7)
    if grayscale and w0.shape[1] == 3:
        w0 = w0.sum(dim=1, keepdim=True)
    params: Dict = {"conv0": w0, "norm0": bn("features.norm0")}
    for i, n_layers in enumerate(_BLOCK_CONFIG, start=1):
        block = []
        for j in range(1, n_layers + 1):
            p = f"features.denseblock{i}.denselayer{j}"
            block.append({"norm1": bn(f"{p}.norm1"),
                          "conv1": arr(f"{p}.conv1.weight", 4),
                          "norm2": bn(f"{p}.norm2"),
                          "conv2": arr(f"{p}.conv2.weight", 4)})
        params[f"block{i}"] = block
        if i < len(_BLOCK_CONFIG):
            t = f"features.transition{i}"
            params[f"transition{i}"] = {"norm": bn(f"{t}.norm"),
                                        "conv": arr(f"{t}.conv.weight", 4)}
    params["norm5"] = bn("features.norm5")
    if "classifier.weight" in state_dict:
        params["classifier"] = {"weight": arr("classifier.weight", 2),
                                "bias": arr("classifier.bias", 1)}
    return params


def load_torch_densenet121(path: str, grayscale: bool = True) -> Dict:
    """Load and convert a locally saved DenseNet121 state dict (``.npz``
    with the same key names, or a ``torch.save`` file)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return convert_torch_densenet121(dict(data), grayscale)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_torch_densenet121(sd, grayscale)


def densenet121_feature_map(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 1) -> (B, h, w, 1024)``: ``relu(norm5)`` before the
    pool."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(bn_inference(F.conv2d(h, params["conv0"], stride=2,
                                     padding=3), params["norm0"]))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    for i in range(1, len(_BLOCK_CONFIG) + 1):
        for p in params[f"block{i}"]:
            y = F.conv2d(F.relu(bn_inference(h, p["norm1"])), p["conv1"])
            y = F.conv2d(F.relu(bn_inference(y, p["norm2"])), p["conv2"],
                         padding=1)
            h = torch.cat([h, y], dim=1)
        if i < len(_BLOCK_CONFIG):
            t = params[f"transition{i}"]
            h = F.conv2d(F.relu(bn_inference(h, t["norm"])), t["conv"])
            h = F.avg_pool2d(h, 2, stride=2)
    h = F.relu(bn_inference(h, params["norm5"]))
    return h.permute(0, 2, 3, 1)


def densenet121_features(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 1) -> (B, 1024)`` pooled features: 7x7/2 stem + BN/ReLU +
    3x3/2 max pool, four dense blocks with 2x2 average-pool transitions,
    ``relu(norm5)``, global average pool."""
    return densenet121_feature_map(params, x).mean(dim=(1, 2))


def densenet121_logits(params: Dict, feature_map: torch.Tensor
                       ) -> torch.Tensor:
    """The classifier head on a ``relu(norm5)`` feature map ``(B, h, w,
    1024)``: the global average pool, then ``classifier``. Needs a
    checkpoint converted with its ``classifier`` head."""
    if "classifier" not in params:
        raise KeyError("checkpoint was converted without its classifier "
                       "head — Grad-CAM needs the logits")
    pooled = feature_map.mean(dim=(1, 2))
    return (pooled @ params["classifier"]["weight"].T
            + params["classifier"]["bias"])
