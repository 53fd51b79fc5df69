"""Context parallelism: ring attention with the sequence sharded over a mesh
axis.

Port of ``superdiff_tpu/parallel/cp.py`` (arXiv:2310.01889) on
point-to-point messages (``batch_isend_irecv``). Each rank keeps its query
shard and the key/value shards travel the ring: hop ``j`` of rank ``i``
sees the shard of rank ``i + j``; the next shard's transfer is in flight
while the hop computes, and the ring pays ``n - 1`` rotations.

- Forward: each hop is one kernel B1 call (queries against the visiting
  key/value shard), which gives the hop's output and row logsumexp; the
  hops merge by their lse, the online-softmax algebra of JAX's
  ``_accumulate`` (in float32).
- Backward (:class:`_Ring`): the ring again, with the merged lse and
  ``delta = rowsum(dO * O)`` of the whole row: each hop is one call of the
  B2/B3 pair (``ops/flash_attention.py::flash_backward_hop``), the query
  gradient stays, and the key/value gradients travel with their shard and
  reach their owner after one more rotation.

On the CPU the hops take the kernels' plain versions. No ``S x S`` score
matrix exists anywhere: a hop holds at most one ``S/n x S/n`` block
(inside the kernels, not even that).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from superdiff_torch.ops.flash_attention import (
    _bwd_delta, _flash_forward, flash_backward_hop)
from superdiff_torch.parallel.mesh import DATA_AXIS, Mesh


def merge(out, lse, out_j, lse_j):
    """Fold one hop's ``(out_j (B,S,H,D), lse_j (B*H,S))`` into the running
    float32 ``(out, lse)`` (None before the first hop)."""
    if out is None:
        return out_j.float(), lse_j
    B, S, H, _ = out.shape
    new = torch.logaddexp(lse, lse_j)

    def w(a):
        return torch.exp(a - new).view(B, H, S).transpose(1, 2)[..., None]

    return out * w(lse) + out_j.float() * w(lse_j), new


def shard_sequence(x: torch.Tensor, mesh: Mesh,
                   axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's shard of a ``(B, S, ...)`` tensor, ``S`` split over
    ``mesh[axis]`` (the resident layout of a long-context caller)."""
    n = mesh.shape[axis]
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by "
                         f"{axis}={n}")
    per = x.shape[1] // n
    return x.narrow(1, mesh.rank(axis) * per, per).contiguous()


class _Peers:
    """The ring over one process group: receive from the next rank, send
    to the previous one."""

    def __init__(self, group):
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        if self.n > 1:
            ranks = dist.get_process_group_ranks(group)
            i = dist.get_group_rank(group, dist.get_rank())
            self.prev, self.next = ranks[(i - 1) % self.n], ranks[(i + 1) % self.n]

    def rotate(self, tensors: List[torch.Tensor]):
        """Start sending ``tensors`` to the previous rank and receiving the
        next rank's; returns a function that waits and returns what came."""
        recv = [torch.empty_like(t) for t in tensors]
        ops = ([dist.P2POp(dist.isend, t.contiguous(), self.prev, self.group)
                for t in tensors]
               + [dist.P2POp(dist.irecv, r, self.next, self.group)
                  for r in recv])
        works = dist.batch_isend_irecv(ops)

        def wait():
            for w in works:
                w.wait()
            return recv

        return wait


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, peers: _Peers):
        out = lse = None
        kv = [k, v]
        for j in range(peers.n):
            wait = peers.rotate(kv) if j < peers.n - 1 else None
            out, lse = merge(out, lse, *_flash_forward(q, *kv))
            if wait is not None:
                kv = wait()
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.peers = peers
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        peers = ctx.peers
        g = g.contiguous()
        delta = _bwd_delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        travel = [k, v, torch.zeros(k.shape, dtype=torch.float32,
                                    device=k.device),
                  torch.zeros(v.shape, dtype=torch.float32,
                              device=v.device)]
        for j in range(peers.n):
            dq_j, dk_j, dv_j = flash_backward_hop(q, travel[0], travel[1],
                                                  g, lse, delta)
            dq += dq_j.float()
            travel[2] += dk_j.float()
            travel[3] += dv_j.float()
            if peers.n > 1:
                # the last rotation carries the gradients home alone
                moving = travel if j < peers.n - 1 else travel[2:]
                got = peers.rotate(moving)()
                travel[len(travel) - len(got):] = got
        return (dq.to(q.dtype), travel[2].to(k.dtype), travel[3].to(v.dtype),
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Multi-head attention with the sequence sharded over ``mesh[axis]``.

    ``q, k, v``: this rank's ``(B, S/n, H, D)`` shards (from
    :func:`shard_sequence`, whose ``S`` must divide by the axis size);
    returns this rank's shard of the output. Non-causal (the UNet's
    self-attention), differentiable."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v shards must share one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _Ring.apply(q, k, v, _Peers(mesh.group(axis)))
