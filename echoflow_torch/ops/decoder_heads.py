"""The MotionNet decoder tail: a hand-written CUDA kernel and its plain
PyTorch version (port of `echoflow/ops/pallas/decoder_kernel.py`).

For each (clip, frame), the decoder tail computes

    seg, motion = heads(relu(comb2(relu(sum_r upsample_hw(proj_r) + b1))))

from native-resolution 64-channel tap projections (same-resolution taps
already summed, time axis already at full length). `decoder_heads` has the
signature of `fused_decoder_heads`:

  - for CPU tensors it computes `reference_decoder_heads`, the plain
    version (the math of `xla_reference_decoder_heads`: separable matrix
    upsample, then matrix products), which is also the kernel's oracle;
  - for CUDA tensors it checks device, dtype, shape and contiguity and
    launches the kernel of `csrc/decoder_heads.cu`, or raises.

`decoder_heads.launches` counts kernel launches. The kernel takes fp32 in
and out: the upsample runs on CUDA cores, comb2 on the tensor cores as
3xTF32 (y and W2 each split into TF32 hi + lo, three products), which
keeps fp32 accuracy. The Pallas kernel's bf16 operand rounding was a TPU
MXU choice and is not carried over. The host side here cuts each output
row into tiles (`tile_plan`) and gives the kernel, per tile column, which
source columns a tile touches and where each pixel's two columns sit in
its column buffer (`x_plan`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from echoflow_torch.ops.resize import _linear_resize_matrix_np, trilinear_resize
from echoflow_torch.utils.device import upload

KERNEL_CHANNELS = 64   # the kernel is compiled for 64 -> 64 channels
MAX_SOURCES = 4


def reference_decoder_heads(projs, b1, w2, b2, ws, bs, wm=None, bm=None,
                            out_hw=None, align_corners=True, with_motion=True):
    """Plain PyTorch statement of the decoder tail.

    projs: list of (B, T, Hr, Wr, C) projections; weights b1 (C,),
    w2 (C, C2), b2 (C2,), ws (C2, 2), bs (2,), wm (C2, 4), bm (4,).
    Returns (seg (B, T, H, W, 2), motion (B, T, H, W, 4) or None)."""
    h_out, w_out = out_hw
    t = projs[0].shape[1]
    acc = None
    for p in projs:
        up = trilinear_resize(p, (t, h_out, w_out), align_corners=align_corners,
                              axes=(1, 2, 3))
        acc = up if acc is None else acc + up
    y = torch.relu(acc + b1)
    y2 = torch.relu(y @ w2 + b2)
    seg = y2 @ ws + bs
    if not (with_motion and wm is not None):
        return seg, None
    return seg, torch.tanh(y2 @ wm + bm)


def _axis_table(src_len: int, dst_len: int, align_corners: bool):
    """Per output index: the (lo, hi) source indices and their weights,
    read off the same float32 resize matrix the plain version multiplies
    with (so the weights are bitwise equal). A row with one nonzero (an
    exact source position, or an identity resize) gets hi = lo, w_hi = 0."""
    mat = _linear_resize_matrix_np(src_len, dst_len, bool(align_corners))
    nz = mat != 0
    lo = nz.argmax(axis=1)
    hi = src_len - 1 - nz[:, ::-1].argmax(axis=1)
    rows = np.arange(dst_len)
    w_lo = mat[rows, lo]
    w_hi = np.where(hi != lo, mat[rows, hi], np.float32(0.0)).astype(np.float32)
    return np.stack([lo, hi], axis=1).astype(np.int32), np.stack([w_lo, w_hi], axis=1)


KERNEL_TILE = 64   # output pixels of a tile, at most (wgmma's M)


def tile_plan(x_idx, w_out: int, max_cols: int):
    """(tile_w, cols): the kernel's tile width (output pixels of one row,
    at most 64, tiles of a row as even as possible) and, per source, the
    most source columns a tile touches, given each source's (W, 2) column
    table. The width halves until the tile's columns fit the kernel's
    column buffer of `max_cols` columns (the library's
    `echoflow_decoder_heads_column_budget`; by width 1 a tile touches at
    most 2 columns a source)."""
    tile_w = -(-w_out // -(-w_out // KERNEL_TILE))
    while True:
        starts = np.arange(0, w_out, tile_w)
        ends = np.minimum(starts + tile_w, w_out) - 1
        cols = [int((idx[ends, 1] - idx[starts, 0]).max()) + 1 for idx in x_idx]
        if sum(cols) <= max_cols or tile_w == 1:
            return tile_w, cols
        tile_w = (tile_w + 1) // 2


def x_plan(xs, w_out: int, tile_w: int, cols):
    """The kernel's x plan, (tiles of a row, S, 65, 4) int32: per tile
    column and source, a head (first source column, columns touched, their
    first place in the column buffer), then per pixel the places of its lo
    and hi columns in the column buffer and the float32 bits of their
    weights (from `_axis_table`, bitwise the plain version's); zeros past
    the tile's pixels."""
    n_seg = -(-w_out // tile_w)
    cols_at = np.cumsum([0] + list(cols[:-1]))
    plan = np.zeros((n_seg, len(xs), KERNEL_TILE + 1, 4), np.int32)
    for s in range(n_seg):
        x0, x_end = s * tile_w, min((s + 1) * tile_w, w_out)
        for r, (idx, wts) in enumerate(xs):
            first = idx[x0, 0]
            plan[s, r, 0, :3] = first, idx[x_end - 1, 1] - first + 1, cols_at[r]
            plan[s, r, 1:1 + x_end - x0, :2] = cols_at[r] + idx[x0:x_end] - first
            plan[s, r, 1:1 + x_end - x0, 2:] = wts[x0:x_end].view(np.int32)
    return plan


@functools.lru_cache(maxsize=64)
def _tables(sizes, out_hw, align_corners, device):
    """The kernel's device tables for sources `sizes`: y_tab (S, H, 4)
    int32, per output row the source rows (lo, hi) and the float32 bits of
    their weights from `_axis_table`; `x_plan`; the tile width; and the
    column buffer's size in columns."""
    h_out, w_out = out_hw
    ys = [_axis_table(hr, h_out, align_corners) for hr, _ in sizes]
    xs = [_axis_table(wr, w_out, align_corners) for _, wr in sizes]
    tile_w, cols = tile_plan([idx for idx, _ in xs], w_out, _column_budget())
    y_tab = np.stack([np.concatenate([idx, wts.view(np.int32)], axis=1) for idx, wts in ys])
    return (upload(torch.from_numpy(np.ascontiguousarray(y_tab)), device),
            upload(torch.from_numpy(x_plan(xs, w_out, tile_w, cols)), device), tile_w, sum(cols))


def _library():
    from echoflow_torch.ops import _build

    return _build.load("decoder_heads")


@functools.lru_cache(maxsize=1)
def _column_budget() -> int:
    return int(_library().echoflow_decoder_heads_column_budget())


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    fn = _library().echoflow_decoder_heads
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 4 + [i32] * 11 + [ptr] * 2 + [ptr] * 7 + [ptr] * 2
                   + [i32] * 5 + [ptr])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(projs, weights, out_hw, with_motion):
    dev = projs[0].device
    if not 1 <= len(projs) <= MAX_SOURCES:
        raise ValueError(f"decoder_heads kernel takes 1..{MAX_SOURCES} sources, got {len(projs)}")
    bsz, t = projs[0].shape[:2]
    for p in projs:
        if p.device != dev or p.dtype != torch.float32 or p.dim() != 5:
            raise ValueError("projections must be float32 (B, T, Hr, Wr, C) tensors on one device")
        if tuple(p.shape[:2]) != (bsz, t) or p.shape[-1] != KERNEL_CHANNELS:
            raise ValueError(f"projection shape {tuple(p.shape)}: want ({bsz}, {t}, Hr, Wr, "
                             f"{KERNEL_CHANNELS})")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError("projections must be contiguous and 16-byte aligned")
    c, c2 = KERNEL_CHANNELS, KERNEL_CHANNELS
    shapes = dict(b1=(c,), w2=(c, c2), b2=(c2,), ws=(c2, 2), bs=(2,))
    if with_motion:
        shapes.update(wm=(c2, 4), bm=(4,))
    for name, shape in shapes.items():
        w = weights[name]
        if w.device != dev or w.dtype != torch.float32 or tuple(w.shape) != shape \
                or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 {shape} "
                             f"tensor on {dev}")
    if out_hw[0] < 1 or out_hw[1] < 1:
        raise ValueError(f"bad out_hw {out_hw}")


def decoder_heads(projs, b1, w2, b2, ws, bs, wm=None, bm=None, out_hw=None,
                  align_corners=True, with_motion=True):
    """Decoder tail: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Same arguments and results as
    `reference_decoder_heads` (and `echoflow`'s `fused_decoder_heads`)."""
    with_motion = bool(with_motion and wm is not None)
    if projs[0].device.type == "cpu":
        return reference_decoder_heads(projs, b1, w2, b2, ws, bs, wm, bm,
                                       out_hw=out_hw, align_corners=align_corners,
                                       with_motion=with_motion)
    if projs[0].device.type != "cuda":
        raise ValueError(f"decoder_heads runs on cpu or cuda, got {projs[0].device}")
    weights = dict(b1=b1, w2=w2, b2=b2, ws=ws, bs=bs, wm=wm, bm=bm)
    _check_cuda_args(projs, weights, out_hw, with_motion)
    h_out, w_out = (int(v) for v in out_hw)
    bsz, t = (int(v) for v in projs[0].shape[:2])
    dev = projs[0].device
    sizes = tuple((int(p.shape[2]), int(p.shape[3])) for p in projs)
    y_tab, plan, tile_w, n_cols = _tables(sizes, (h_out, w_out), bool(align_corners), dev)
    seg = torch.empty((bsz, t, h_out, w_out, 2), device=dev, dtype=torch.float32)
    mot = (torch.empty((bsz, t, h_out, w_out, 4), device=dev, dtype=torch.float32)
           if with_motion else None)
    ptrs = [p.data_ptr() for p in projs] + [None] * (MAX_SOURCES - len(projs))
    dims = [d for hw in sizes for d in hw] + [0] * (2 * (MAX_SOURCES - len(projs)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            *ptrs, *dims, len(projs), n_cols, tile_w, y_tab.data_ptr(), plan.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wm.data_ptr() if with_motion else None, bm.data_ptr() if with_motion else None,
            seg.data_ptr(), mot.data_ptr() if with_motion else None,
            bsz, t, h_out, w_out, int(with_motion), stream)
    if err != 0:
        raise RuntimeError(f"decoder_heads kernel launch failed: CUDA error {err}")
    decoder_heads.launches += 1
    return seg, mot


decoder_heads.launches = 0
