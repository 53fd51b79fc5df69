"""Pipeline parallelism: the CondUNet split in two stages, with
microbatches in flight on both.

Port of ``superdiff_tpu/parallel/pp.py``. Stage 0 (embeddings, stem, down
path) and stage 1 (middle, up path, head) are copies of the model that hold
only their own parameters, each on its device; the batch goes through in
microbatches. CUDA launches are asynchronous, so the host enqueues stage 0
of microbatch ``i + 1`` on its device while stage 1 of microbatch ``i`` is
still running on the other: the stream order is the schedule, as JAX's
async dispatch is there. The payload ``(h, skips, emb)`` moves with
non-blocking copies. Inference only, as in the JAX package.

The stage subsets are name subsets of one full checkpoint
(``CondUNet.forward(stage=...)`` reads only its own top-level modules), so
any run splits without a pipeline checkpoint format.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_DOWN_PREFIXES = ("time_mlp", "class_emb", "stem", "down_")
_UP_PREFIXES = ("mid_", "up_", "out_")


def split_params(state_dict: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split one full CondUNet state dict into the (stage 0, stage 1)
    subsets by top-level module name. The subsets partition it
    (validated)."""
    out = [{k: v for k, v in state_dict.items() if k.startswith(prefixes)}
           for prefixes in (_DOWN_PREFIXES, _UP_PREFIXES)]
    if len(out[0]) + len(out[1]) != len(state_dict):
        missing = sorted({k.split(".")[0] for k in state_dict
                          if not k.startswith(_DOWN_PREFIXES
                                              + _UP_PREFIXES)})
        raise ValueError(f"stage split lost modules: {missing}")
    return out[0], out[1]


def _stage(model, subset, prefixes, device):
    """A copy of ``model`` on ``device`` holding only the top-level modules
    named by ``prefixes``, loaded from ``subset``."""
    keep = copy.deepcopy(model)
    for name in [n for n, _ in keep.named_children()
                 if not n.startswith(prefixes)]:
        delattr(keep, name)
    keep = keep.to(device)
    keep.load_state_dict(subset, strict=True)
    return keep.eval()


def make_pp_denoiser(model, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                     devices: Optional[Sequence] = None,
                     num_microbatches: int = 2) -> Callable:
    """Build ``fn(x, t, y=None) -> eps`` running the two-stage pipeline.

    ``state_dict`` defaults to ``model``'s own; ``devices`` are the two
    devices of the stages (default ``cuda:0``, ``cuda:1``; the same device
    twice runs both stages on one card). The batch must divide by
    ``num_microbatches``. The output lies on the second device."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else ("cuda:0", "cuda:1"))]
    if len(devs) != 2:
        raise ValueError(f"need exactly 2 devices, got {len(devs)}")
    p0, p1 = split_params(state_dict if state_dict is not None
                          else model.state_dict())
    stage0 = _stage(model, p0, _DOWN_PREFIXES, devs[0])
    stage1 = _stage(model, p1, _UP_PREFIXES, devs[1])
    conditional = getattr(model, "num_classes", 0) > 0

    @torch.no_grad()
    def fn(x, t, y=None):
        B = x.shape[0]
        m = num_microbatches
        if B % m:
            raise ValueError(f"batch {B} not divisible by "
                             f"{m} microbatches")
        if conditional and y is None:
            raise ValueError(
                "conditional model requires labels y; pass "
                f"y=full(null_label={model.null_label}) for "
                "unconditional use")
        mb = B // m
        x0, t0 = x.to(devs[0]), t.to(devs[0])
        y0 = y.to(devs[0]) if conditional else None
        outs = []
        for i in range(m):
            sl = slice(i * mb, (i + 1) * mb)
            h, skips, emb = stage0(x0[sl], t0[sl],
                                   y0[sl] if conditional else None,
                                   stage="down")
            state = tuple(a.to(devs[1], non_blocking=True)
                          for a in (h, emb))
            skips = tuple(s.to(devs[1], non_blocking=True) for s in skips)
            # the host loops on to enqueue stage 0 of the next microbatch
            outs.append(stage1(None, None, stage="up",
                               pp_state=(state[0], skips, state[1])))
        return torch.cat(outs)

    return fn
