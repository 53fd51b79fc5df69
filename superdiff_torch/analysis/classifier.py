"""Train the SmallCNN classifier (the ``classifier`` feature extractor).

Port of ``superdiff_tpu/analysis/classifier.py``: softmax cross-entropy,
Adam under optax's rules (``training/state.py::Optimizer``: bias-corrected
moments, eps outside the square root), batches re-iterated until
``num_steps`` steps are done.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from superdiff_torch.analysis.features import SmallCNN
from superdiff_torch.training.state import make_optimizer


def _tensor(a, device, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


def train_classifier(batches: Iterable, num_classes: int = 2,
                     num_steps: int = 200, learning_rate: float = 1e-3,
                     seed: int = 0,
                     device="cuda") -> Tuple[SmallCNN, dict]:
    """Train a ``SmallCNN`` (Flax-default initial weights from ``seed``)
    on ``{"image", "label"}`` batches. Returns ``(model, metrics)`` with
    ``final_loss`` and ``final_acc`` (the mean of the last 10 steps'
    accuracies); the model carries its weights, so there is no separate
    parameter tree as in the JAX package."""
    batches = list(batches)
    if not batches:
        raise ValueError("no batches")
    device = torch.device(device)
    model = SmallCNN(num_classes=num_classes, device="cpu")
    model = model.init_parameters(seed).to(device).train()
    params = list(model.parameters())
    tx = make_optimizer(learning_rate=learning_rate)
    opt_state = tx.init(params)
    losses, accs = [], []
    i = 0
    while i < num_steps:
        for batch in batches:
            if i >= num_steps:
                break
            x = _tensor(batch["image"], device, torch.float32)
            y = _tensor(batch["label"], device, torch.long)
            logits = model(x)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, params)
            tx.update(params, list(grads), opt_state)
            losses.append(loss.detach())
            accs.append((logits.argmax(-1) == y).float().mean())
            i += 1
    model.eval()
    return model, {"final_loss": float(losses[-1]),
                   "final_acc": float(torch.stack(accs[-10:]).mean())}
