"""Kernel B1's (``csrc/flash_attn_fwd.cu``) share of its roofline over the
traced sampling window of a text-conditioned model, in percent: the least
time of the attention launches the window ran (per launch the larger of
its FLOPs over the configuration's peak and its bytes over the memory
bandwidth, ``common/attn_counts.py``, from the plain reference's attention
shapes) over B1's device time in the trace.

The launches of one denoiser call are the program's own counters of its
captured step (``ops/flash_attention.py``'s ``captured_by_shape``, whose
key holds ``Skv`` where a launch's keys are not its queries: a
cross-attention launch), checked against the reference's shapes by
``(Sq, Skv)``; the window's launches are the calls times that. Where the
counters are missing or disagree with the reference, where the trace holds
no B1 kernel, or its count is more than 5 % off the expected one, nothing
is read; where the profiler lost a few events, the time is scaled by the
launches expected over those seen."""

from collections import Counter

from bench_port.common.attn_counts import b1_bound_s
from bench_port.common.counts import peaks

KERNELS = ("flash_fwd_kernel",)


def read(cell, out):
    w = out.get("window")
    st = out.get("static") or {}
    launches, captured = st.get("b1_launches"), st.get("b1_captured")
    if w is None or "calls" not in w.counts or not launches or not captured:
        return None
    got = Counter()
    for key, n in captured.items():
        got[(key[0], key[3] if len(key) > 3 else key[0])] += n
    if got != Counter((Sq, Skv) for _, Sq, Skv, _, _ in launches):
        return None
    import torch

    expected = len(launches) * w.counts["calls"]
    seconds, seen = w.kernel_s(KERNELS)
    if not seen or abs(seen - expected) > 0.05 * expected:
        return None
    pk = peaks(torch.cuda.get_device_name())
    bound = b1_bound_s(launches, st["b1_elt_bytes"], pk[cell.config["peak"]],
                       pk["hbm_bytes_per_s"]) * w.counts["calls"]
    return 100.0 * bound / (seconds * expected / seen)
