"""The numbers that decide ``correct``: each reading of the program against
the reference, and each against its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

import torch


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's ``|a - ref| / |ref|`` (L2 over each row); NaN when
    either side is not finite, or there is no row."""
    a, ref = a.double(), ref.double()
    if not (torch.isfinite(a).all() and torch.isfinite(ref).all()):
        return math.nan
    num = (a - ref).flatten(1).norm(dim=1)
    den = ref.flatten(1).norm(dim=1).clamp(min=1e-30)
    return float((num / den).max()) if num.numel() else math.nan


def rel_gap(a: Iterable[float], ref: Iterable[float]) -> float:
    """The worst ``|a_i - ref_i| / |ref_i|``."""
    gaps = [abs(x - r) / max(abs(r), 1e-30) for x, r in zip(a, ref)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.nan


def scaled_gap(a: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst element's ``|a_i - ref_i|`` over the larger of ``|ref_i|``
    and the median ``|ref|`` (a sum that nearly cancels makes an element's
    own relative error swing); NaN when not finite, or empty."""
    a, ref = a.double().flatten(), ref.double().flatten()
    if not ref.numel() or not (torch.isfinite(a).all()
                               and torch.isfinite(ref).all()):
        return math.nan
    floor = ref.abs().median().clamp(min=1e-30)
    return float(((a - ref).abs() / torch.maximum(ref.abs(), floor)).max())


def leaf_gap(a: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms, ``| |a_i| - |ref_i| |`` over the larger
    of ``|ref_i|`` and the median leaf's ``|ref|`` (some leaves' are all but
    zero), over the leaves in ``keep`` (all by default)."""
    names = list(ref) if keep is None else keep
    rn = {k: float(ref[k].double().norm()) for k in names}
    an = {k: float(a[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    gaps = [abs(an[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.nan


def moved(grad_ref: Dict[str, torch.Tensor],
          share: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Per leaf, the mask of elements whose reference gradient is at least
    ``share`` of the median leaf's root-mean-square gradient: the others
    (a key's bias under softmax, a slice of the fused ``qkv`` bias here)
    are nought to rounding and move under Adam by round-off alone. Leaves
    with no such element are left out."""
    rms = {k: float(v.double().norm()) / max(v.numel(), 1) ** 0.5
           for k, v in grad_ref.items()}
    floor = share * statistics.median(rms.values())
    masks = {k: v.abs() >= floor for k, v in grad_ref.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, lines)``: each reading beside its limit. A reading the
    limits do not name, a limit with no reading, or a NaN fails; a limit of
    None records its reading uncompared (a number with no upper reading)."""
    lines, ok = [], True
    for name in sorted(set(readings) | set(limits)):
        value, limit = readings.get(name, math.nan), limits.get(name)
        good = (name in limits and name in readings and limit is None) or (
            limit is not None and value <= limit)
        ok &= good
        lines.append({"name": name, "value": value, "limit": limit,
                      "ok": bool(good)})
    return ok, lines
