"""Row gathers whose backward adds in a fixed order.

``rows(src, ids)`` is ``torch.index_select(src, 0, ids)``. Its backward is
the sum of each row's cotangents. On the CPU that is ``index_add``, which
adds in order. On a GPU ``index_add`` adds with atomics, in an order that
changes from run to run, so two runs of a gradient step differ in their
last bits. There the backward sorts the ids (a stable sort) and sums each
row's run of cotangents with ``torch.segment_reduce``, one segment per row
and column, which reduces each segment in a fixed order: the same bits on
every run, without ``torch.use_deterministic_algorithms`` (which also sends
every indexed store of the replay through a sort).
"""

from __future__ import annotations

import torch


def rows(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``src[ids]`` along dim 0 -> (len(ids), *src.shape[1:]). ``ids`` int64."""
    if src.is_cuda and src.requires_grad and torch.is_grad_enabled():
        return _Rows.apply(src, ids)
    return torch.index_select(src, 0, ids)


def segment_sum(g: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of ``g`` (R, ...) summed by ``ids`` (R,) into (n, ...), in
    an order fixed by the ids alone (rows of one id in their order in
    ``g``, each column's run reduced by one ``segment_reduce``)."""
    out = g.new_zeros((n,) + tuple(g.shape[1:]))
    if ids.numel() == 0:
        return out
    order = torch.argsort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(ids[order], return_counts=True)
    cols = g.index_select(0, order).reshape(ids.shape[0], -1).t().contiguous()  # (K, R)
    k = cols.shape[0]
    sums = torch.segment_reduce(cols.reshape(-1), "sum", lengths=counts.repeat(k),
                                unsafe=True)
    out[uniq] = sums.reshape(k, -1).t().reshape((uniq.shape[0],) + tuple(g.shape[1:]))
    return out


class _Rows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, ids):
        ctx.save_for_backward(ids)
        ctx.n = src.shape[0]
        return torch.index_select(src, 0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum(g, ids, ctx.n), None
