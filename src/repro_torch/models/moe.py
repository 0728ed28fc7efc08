"""Mixture-of-experts layer (the reference's ``repro/models/moe.py``):
top-k routing with sort-based capacity dispatch.

Tokens are routed in float32; each (token, expert) assignment gets its
rank within its expert from a stable sort of the flat expert ids and a
binary search, and lands in a dense (E, C, D) dispatch buffer (C the
capacity); assignments past the capacity are dropped.  The expert FFN is
one batched product per projection over all E experts (``torch.bmm``; the
reference's einsums, outside any Pallas kernel), and the combine gathers
each assignment's output back, weighted by its router probability.

Held exactly as the reference holds them:

* **Top-k order.** The first k of a stable descending sort of the
  probabilities, so equal probabilities (an all-zero row gives E of
  them) pick the lower expert first, as ``jax.lax.top_k`` does;
  ``torch.topk`` breaks ties in another, unspecified order.
* **Capacity.** Computed on the host from the shapes, with the
  reference's float arithmetic, per block: the tokens are cut into
  ``shardctx.batch_block_count`` blocks (1 outside a mesh, the number of
  data-parallel shards on one), each sorted, ranked and capped on its
  own, as the reference's block-local dispatch does.  On a mesh the
  routing, dispatch and combine run on each rank's blocks
  (``shardctx.local``) and the expert FFN on experts sharded over
  ``model``.
* **Combine order.** Each token's k contributions are summed in a fixed
  order (back to (T, K, D), then a sum over K), never with
  ``index_add_``/``scatter_add_``, whose CUDA atomics add in no fixed
  order and would make two runs differ.

One rounding differs in low-precision models: the gate and up products
round to the model dtype before the SiLU and their product, as the
port's dense ``layers.MLP`` rounds them (float32 accumulation, one
rounding per product); the reference keeps them in float32 and rounds
their product once.  In float32 the two are the same arithmetic.

No function here reads a device value on the host: the layer runs
without a host sync.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import shardctx


class MoE(nn.Module):
    """``router`` (d_model, E) in float32 whatever the model dtype;
    ``gate`` and ``up`` (E, d_model, d_ff) and ``down`` (E, d_ff,
    d_model) in the model dtype: the reference's (E, d_in, d_out)
    layout."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, *, dtype,
                 device):
        super().__init__()

        def param(*shape, dtype=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))
        self.router = param(d_model, num_experts, dtype=torch.float32)
        self.gate = param(num_experts, d_model, d_ff)
        self.up = param(num_experts, d_model, d_ff)
        self.down = param(num_experts, d_ff, d_model)


def capacity(tokens: int, experts_per_token: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``tokens · k · capacity_factor / E`` rounded up,
    at least 8, then up to a multiple of 8 (the reference's arithmetic,
    Python floats included)."""
    cap = int(max(8, (-(-tokens * experts_per_token * capacity_factor
                        // num_experts))))
    return -(-cap // 8) * 8


def _slots(flat_e: torch.Tensor, *, cap: int, num_experts: int
           ) -> torch.Tensor:
    """Each block's dispatch rows: ``flat_e`` (nb, n) expert ids of a
    block's assignments in order → (nb, n) rows ``expert·cap + rank``,
    ``E·cap`` past the expert's capacity (the rank from a stable sort
    and a binary search, within the block)."""
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    rank = (torch.arange(flat_e.shape[1], device=flat_e.device)
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    dest = torch.where(rank < cap, sorted_e * cap + rank, num_experts * cap)
    # back to assignment order: slot[order[i]] = dest[i]
    return torch.empty_like(dest).scatter_(1, order, dest)


def route(router: torch.Tensor, xt: torch.Tensor, *, num_experts: int,
          experts_per_token: int, capacity_factor: float, blocks: int = 1):
    """Routing of the flat tokens ``xt`` (T, D), in ``blocks`` equal
    blocks of consecutive tokens with a capacity each (one block per
    data-parallel shard on a mesh, ``shardctx.batch_block_count``).

    Returns (probs (T, E) float32, weights (T, K) float32 summing to 1 per
    token, experts (T, K) int64, slot (T·K,) int64, cap): ``slot[t·K + j]``
    is the row of its block's flattened (E·cap, D) dispatch buffer that
    token t's j-th assignment fills, or ``E·cap`` when it overflowed its
    expert's capacity and is dropped.
    """
    e, k = num_experts, experts_per_token
    t = xt.shape[0]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    cap = capacity(t // blocks, k, e, capacity_factor)
    slot = shardctx.local(
        functools.partial(_slots, cap=cap, num_experts=e),
        (top_e.reshape(blocks, (t // blocks) * k),), (("batch", None),),
        (0,))
    return probs, top_p, top_e, slot.reshape(t * k), cap


def _dispatch(xb: torch.Tensor, slot: torch.Tensor, *, k: int, rows: int
              ) -> torch.Tensor:
    """(nb, T_b, D) tokens and their (nb, T_b·K) slots → (nb, rows, D)
    dispatch buffers; row ``rows`` of each block collects the dropped
    assignments and is cut off."""
    nb, tb, d = xb.shape
    src = xb[:, :, None].expand(nb, tb, k, d).reshape(nb * tb * k, d)
    at = slot + torch.arange(nb, device=xb.device)[:, None] * (rows + 1)
    disp = xb.new_zeros((nb * (rows + 1), d)).index_copy_(0, at.reshape(-1),
                                                          src)
    return disp.view(nb, rows + 1, d)[:, :rows]


def _combine(out: torch.Tensor, slot: torch.Tensor, w: torch.Tensor, *,
             k: int) -> torch.Tensor:
    """(nb, rows, D) expert outputs → (nb, T_b, D): each assignment's
    output × its weight × kept, summed over its token's K in order."""
    nb, rows, d = out.shape
    kept = (slot < rows).to(out.dtype)[..., None]
    blk = torch.arange(nb, device=out.device)[:, None]
    contrib = (out[blk, torch.clamp_max(slot, rows - 1)]
               * w.to(out.dtype)[..., None] * kept)
    return contrib.view(nb, -1, k, d).sum(dim=2)


def moe_apply(moe: MoE, x: torch.Tensor, *, num_experts: int,
              experts_per_token: int, capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D) in x's dtype, the Switch-style
    load-balance loss, a float32 scalar)."""
    b, s, d = x.shape
    e, k = num_experts, experts_per_token
    t = b * s
    nb = shardctx.batch_block_count(t)
    xt = shardctx.constrain(x.reshape(t, d), ("batch", None))
    probs, top_p, top_e, slot, cap = route(
        moe.router, xt, num_experts=e, experts_per_token=k,
        capacity_factor=capacity_factor, blocks=nb)

    # load-balance loss: E · Σ mean prob · top-1 share
    top1 = (top_e[:, :1] == torch.arange(e, device=x.device)).float()
    aux = e * torch.sum(probs.mean(dim=0) * top1.mean(dim=0))

    # dispatch within each block, then all-to-all to the experts
    blocked = (("batch", None, None), ("batch", None))
    slot = slot.reshape(nb, -1)
    disp = shardctx.local(
        functools.partial(_dispatch, k=k, rows=e * cap),
        (xt.reshape(nb, t // nb, d), slot), blocked, (0,))
    disp = shardctx.constrain(disp.reshape(nb, e, cap, d),
                              ("batch", None, None, None))
    disp_e = shardctx.constrain(
        disp.transpose(0, 1).reshape(e, nb * cap, d),
        ("experts", "batch", None))

    # expert FFN (swiglu), one batched product per projection
    h = F.silu(torch.bmm(disp_e, moe.gate)) * torch.bmm(disp_e, moe.up)
    out = shardctx.constrain(torch.bmm(h, moe.down),
                             ("experts", "batch", None))
    out = shardctx.constrain(out.reshape(e, nb, cap, d).transpose(0, 1),
                             ("batch", None, None, None))

    # combine within each block
    y = shardctx.local(
        functools.partial(_combine, k=k),
        (out.reshape(nb, e * cap, d), slot, top_p.reshape(nb, -1)),
        blocked[:1] + blocked[1:] * 2, (0,))
    y = shardctx.constrain(y.reshape(t, d), ("batch", None))
    return y.reshape(b, s, d), aux


def moe_param_count(d_model: int, d_ff: int, num_experts: int) -> int:
    return num_experts * 3 * d_model * d_ff + d_model * num_experts


def moe_active_param_count(d_model: int, d_ff: int,
                           experts_per_token: int) -> int:
    return experts_per_token * 3 * d_model * d_ff


__all__ = ["MoE", "capacity", "moe_active_param_count", "moe_apply",
           "moe_param_count", "route"]
