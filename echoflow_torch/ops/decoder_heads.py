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

`decoder_heads.launches` counts kernel launches. The kernel runs in fp32
on CUDA cores; the Pallas kernel's bf16 operand rounding was a TPU MXU
choice and is not carried over.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from echoflow_torch.ops.resize import _linear_resize_matrix_np, trilinear_resize

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


@functools.lru_cache(maxsize=64)
def _tables(sizes, out_hw, align_corners, device):
    """Device tables (y_idx (S, H, 2) int32, y_w (S, H, 2) f32, x_idx
    (S, W, 2) int32, x_w (S, W, 2) f32) for sources `sizes`."""
    h_out, w_out = out_hw
    ys = [_axis_table(hr, h_out, align_corners) for hr, _ in sizes]
    xs = [_axis_table(wr, w_out, align_corners) for _, wr in sizes]
    return tuple(torch.from_numpy(np.ascontiguousarray(np.stack(a))).to(device)
                 for a in ([i for i, _ in ys], [w for _, w in ys],
                           [i for i, _ in xs], [w for _, w in xs]))


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    from echoflow_torch.ops import _build

    fn = _build.load("decoder_heads").echoflow_decoder_heads
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 4 + [i32] * 9 + [ptr] * 4 + [ptr] * 7 + [ptr] * 2
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
                or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}")
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
    y_idx, y_w, x_idx, x_w = _tables(sizes, (h_out, w_out), bool(align_corners), dev)
    seg = torch.empty((bsz, t, h_out, w_out, 2), device=dev, dtype=torch.float32)
    mot = (torch.empty((bsz, t, h_out, w_out, 4), device=dev, dtype=torch.float32)
           if with_motion else None)
    ptrs = [p.data_ptr() for p in projs] + [None] * (MAX_SOURCES - len(projs))
    dims = [d for hw in sizes for d in hw] + [0] * (2 * (MAX_SOURCES - len(projs)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn()(
            *ptrs, *dims, len(projs),
            y_idx.data_ptr(), y_w.data_ptr(), x_idx.data_ptr(), x_w.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ws.data_ptr(), bs.data_ptr(),
            wm.data_ptr() if with_motion else None, bm.data_ptr() if with_motion else None,
            seg.data_ptr(), mot.data_ptr() if with_motion else None,
            bsz, t, h_out, w_out, int(with_motion), stream)
    if err != 0:
        raise RuntimeError(f"decoder_heads kernel launch failed: CUDA error {err}")
    decoder_heads.launches += 1
    return seg, mot


decoder_heads.launches = 0
