"""Windowed multi-head attention with a relative-position bias, whose fp32
forward and backward repeat bit for bit on the card: the attention core of
the Video Swin Transformer's blocks (`models/swin3d.py`).

For each window of N tokens and each head,

    out = softmax(q k^T / sqrt(d) + B[index] + M) v

where q, k, v come from one qkv projection (B_, N, 3C) with C = heads x d,
B is the head's learned bias table (R rows), `index` (N x N) picks each
pair's row, and M (nW, N, N), when given, is the constant mask (0 or -100)
of the shifted windows, the windows of one clip being the last nW of the
B_ (window index fastest, clip slowest).

`window_attention` computes it on any device with matrix products (cuBLAS
on the card), the bias and mask added to the scores, a softmax and a
product, and an explicit backward (`_WindowAttention`):

    dP = dO v^T;  dv = P^T dO;  dS = P * (dP - rowsum(dP * P));
    dq = dS k / sqrt(d);  dk = dS^T q / sqrt(d);
    dB[r] = sum over the windows, and over the pairs (i, j) with index r,
            of dS[i, j]

The table's gradient is the part that autograd's `B[index]` would compute
by an accumulating scatter (float atomics on CUDA, whose order, and so
whose bits, change from call to call). Here it is a reduction in a fixed
order: dS summed over the windows, then, for each table row, a sum over
the positions that read it, gathered through `rows` (R, M), each row's
positions padded with a position that reads zero. Every other step is a
cuBLAS product or a PyTorch element-wise or reduction kernel, which repeat
on one card, so the route needs no global determinism switch.

`plain_window_attention` is the plain version, through autograd: the
oracle of the route's forward and backward.

Each call runs in the device span `swin.attention` (forward), as does its
backward, and counts `swin.attention.launches` (`utils/profiling`).
"""

from __future__ import annotations

import torch

from echoflow_torch.utils.profiling import count, span


def _split_heads(qkv: torch.Tensor, heads: int):
    """(B_, N, 3C) -> q, k, v, each (B_, heads, N, d), contiguous."""
    b, n, c3 = qkv.shape
    parts = qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4).contiguous()
    return parts[0], parts[1], parts[2]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B_, heads, N, d) -> (B_, N, heads x d)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _scores(q, k, bias, mask):
    """q k^T + bias (+ mask), (B_, heads, N, N); q already scaled."""
    s = torch.matmul(q, k.transpose(-2, -1))
    if mask is None:
        return s.add_(bias)
    b, h, n, _ = s.shape
    nw = mask.shape[0]
    view = s.view(b // nw, nw, h, n, n)
    view.add_(bias).add_(mask.unsqueeze(1))
    return s


def gathered_bias(table: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """The (heads, N, N) bias of the table (R, heads) at the pairs' rows
    `index` (N x N,)."""
    return table.index_select(0, index).view(n, n, -1).permute(2, 0, 1)


def table_grad(dbias: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The bias table's gradient (R, heads) from the bias's (heads, N x N):
    for each row, the sum of the positions in its line of `rows` (R, M),
    N x N reading zero, in that fixed order."""
    padded = torch.cat([dbias, dbias.new_zeros((dbias.shape[0], 1))], dim=1)
    return padded[:, rows].sum(-1).t()


class _WindowAttention(torch.autograd.Function):
    """The route (module docstring): products, softmax and an explicit
    backward with the table's gradient reduced in a fixed order."""

    @staticmethod
    def forward(ctx, qkv, table, heads, index, rows, mask, scale):
        with span("swin.attention", device=qkv.device):
            q, k, v = _split_heads(qkv, heads)
            q = q * scale
            n = q.shape[2]
            p = torch.softmax(_scores(q, k, gathered_bias(table, index, n), mask), dim=-1)
            out = _merge_heads(torch.matmul(p, v))
        ctx.save_for_backward(q, k, v, p, rows)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, p, rows = ctx.saved_tensors
        with span("swin.attention", device=dout.device):
            b, h, n, d = q.shape
            do = dout.reshape(b, n, h, d).transpose(1, 2).contiguous()
            grads = q.new_empty((3, b, h, n, d))
            dp = torch.matmul(do, v.transpose(-2, -1))
            torch.matmul(p.transpose(-2, -1), do, out=grads[2])
            ds = torch._softmax_backward_data(dp, p, -1, p.dtype)
            del dp
            torch.matmul(ds, k, out=grads[0])
            grads[0].mul_(ctx.scale)
            torch.matmul(ds.transpose(-2, -1), q, out=grads[1])
            dtable = table_grad(ds.view(b, h, n * n).sum(0), rows)
            dqkv = grads.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * d)
        return dqkv, dtable, None, None, None, None, None


def window_attention(qkv, table, heads: int, index, rows, mask=None):
    """Attention in each window (module docstring): qkv (B_, N, 3C), the
    bias table (R, heads), `index` (N x N,) its row of each pair, `rows`
    (R, M) the positions of each row for the table's gradient, `mask`
    (nW, N, N) or None; returns (B_, N, C). Counts
    `swin.attention.launches`."""
    d = qkv.shape[-1] // (3 * heads)
    count("swin.attention.launches")
    return _WindowAttention.apply(qkv, table, heads, index, rows, mask, d ** -0.5)


def plain_window_attention(qkv, bias, heads: int, mask=None):
    """The plain version through autograd: the bias (heads, N, N) already
    gathered; returns (B_, N, C)."""
    q, k, v = _split_heads(qkv, heads)
    q = q * q.shape[-1] ** -0.5
    s = torch.matmul(q, k.transpose(-2, -1)) + bias
    if mask is not None:
        b, h, n, _ = s.shape
        s = (s.view(b // mask.shape[0], mask.shape[0], h, n, n) + mask.unsqueeze(1)).view(s.shape)
    return _merge_heads(torch.matmul(torch.softmax(s, dim=-1), v))
