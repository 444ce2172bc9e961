"""The bilinear border warp at pixel coordinates: three hand-written CUDA
kernels, their plain PyTorch versions, and the autograd function that
binds them (port of `echoflow/ops/pallas/warp_kernel.py`).

    out = warp_coords(image, px, py)

samples image (N, C, H, W) float32 at unclamped pixel coordinates px, py
(N, H, W) with `grid_sample` semantics (align_corners=False, border
clamp). `WarpCoords` is the counterpart of the `jax.custom_vjp` of
`warp_pallas_coords`:

  - forward: `warp_forward` (K2);
  - backward: `warp_image_grad` (K3) only when the image needs a gradient
    (the training loss's video warp has none, as in echoflow, where XLA
    removed that kernel as dead code), and `warp_coord_grad` (K4) for the
    coordinates.

`warp_coords_pair(image_a, image_b, px, py)` (`WarpCoordsPair`) warps two
images at the same coordinates with one K2 launch (`warp_forward_pair`),
as the fused training loss does with its label and video stacks; its
backward runs K3 and K4 per image and sums the coordinate gradients.

Each wrapper computes its plain version (`reference_warp_*`) for CPU
tensors; for CUDA tensors it checks device, dtype, shape and contiguity and
launches its kernel of `csrc/warp.cu`, or raises. `.launches` on each
wrapper counts its kernel launches.

K3 adds every pixel's terms into a zeroed channels-last scratch with
16-byte atomics (a warp joins the terms its neighbouring lanes add to one
element), then a second kernel writes d_img from it (`csrc/warp.cu`;
`tests/test_torch_warp.py` states the same recipe in torch).

The coordinate gradient follows the Pallas kernel: it is zeroed where the
raw coordinate lies outside [0, size-1], and at exactly size-1 it is the
derivative of the one-hot weights (-v, the x0+1 column lies outside the
image). echoflow's gather autodiff gives 0 at size-1 (its x1 corner is
clamped onto x0); the two agree everywhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# float32 unit roundoff: the tolerance of K3 (atomics) is stated in it.
_U32 = 2.0 ** -24


def _corners(px, py, h, w):
    """Clamped top-left corner (long) and fractions of pixel coordinates."""
    x = px.clamp(0.0, w - 1.0)
    y = py.clamp(0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0.long(), y0.long(), x - x0, y - y0


def reference_warp_forward(image, px, py):
    """Plain forward: four gathers and a blend, in the order of echoflow's
    `warp_bilinear_border` (top = v00 + (v01 - v00) * fx, ...)."""
    n, c, h, w = image.shape
    x0, y0, fx, fy = _corners(px, py, h, w)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    flat = image.reshape(n, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, h * w).expand(n, c, h * w)
        return torch.gather(flat, 2, idx).reshape(n, c, h, w)

    fx, fy = fx[:, None], fy[:, None]
    top = gather(y0, x0) + (gather(y0, x1) - gather(y0, x0)) * fx
    bot = gather(y1, x0) + (gather(y1, x1) - gather(y1, x0)) * fx
    return top + (bot - top) * fy


def _corner_terms(px, py, h, w):
    """[(flat index (N, H*W), valid (N, H, W), wy, wx)] of the four corners
    with the Pallas kernel's weights; a corner outside the image is invalid."""
    x0, y0, fx, fy = _corners(px, py, h, w)
    out = []
    for yy, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
        for xx, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
            valid = (yy < h) & (xx < w)
            idx = torch.clamp(yy, max=h - 1) * w + torch.clamp(xx, max=w - 1)
            out.append((idx, valid, wy, wx))
    return out


def reference_warp_image_grad(g, px, py):
    """Plain d_img: `index_add_` of the four weighted g, wy * (wx * g)."""
    n, c, h, w = g.shape
    d = torch.zeros(n * c * h * w, device=g.device, dtype=g.dtype)
    base = (torch.arange(n * c, device=g.device) * (h * w)).reshape(n, c, 1, 1)
    for idx, valid, wy, wx in _corner_terms(px, py, h, w):
        term = wy[:, None] * (wx[:, None] * g)
        term = torch.where(valid[:, None], term, torch.zeros_like(term))
        d.index_add_(0, (base + idx.reshape(n, 1, h, w)).reshape(-1), term.reshape(-1))
    return d.reshape(n, c, h, w)


def reference_warp_coord_grad(image, g, px, py):
    """Plain d_px, d_py: the derivatives of the weights, summed over the
    channels in channel order, zeroed where the raw coordinate lies outside
    [0, size-1]."""
    n, c, h, w = image.shape
    x0, y0, fx, fy = _corners(px, py, h, w)
    hx, hy = x0 + 1 < w, y0 + 1 < h
    flat = image.reshape(n, c, h * w)
    o00 = y0 * w + x0

    def corner(offset, valid):
        idx = torch.clamp(o00 + offset, max=h * w - 1).reshape(n, 1, h * w).expand(n, c, h * w)
        v = torch.gather(flat, 2, idx).reshape(n, c, h, w)
        return torch.where(valid[:, None], v, torch.zeros_like(v))

    v00 = corner(0, torch.ones_like(hx))
    v01, v10, v11 = corner(1, hx), corner(w, hy), corner(w + 1, hx & hy)
    wx0, wy0 = (1.0 - fx)[:, None], (1.0 - fy)[:, None]
    ddx = wy0 * (v01 - v00) + fy[:, None] * (v11 - v10)
    ddy = wx0 * (v10 - v00) + fx[:, None] * (v11 - v01)
    dpx = torch.zeros_like(px)
    dpy = torch.zeros_like(py)
    for ch in range(c):
        dpx = dpx + g[:, ch] * ddx[:, ch]
        dpy = dpy + g[:, ch] * ddy[:, ch]
    zero = torch.zeros_like(dpx)
    dpx = torch.where((px >= 0.0) & (px <= w - 1.0), dpx, zero)
    dpy = torch.where((py >= 0.0) & (py <= h - 1.0), dpy, zero)
    return dpx, dpy


def image_grad_tolerance(g, px, py):
    """Per-element bound on |K3 - reference_warp_image_grad|: each side
    sums its k contributions to an element in some order, within
    (k-1) u sum|term| of the exact sum (u = 2^-24), so the two differ by
    at most (k-1) 2^-23 sum|term|. Also bounds two K3 runs against each
    other (atomics add in an order that changes from run to run)."""
    n, c, h, w = g.shape
    abs_sum = reference_warp_image_grad(g.abs(), px, py)
    hits = torch.zeros(n * c * h * w, device=g.device, dtype=g.dtype)
    base = (torch.arange(n * c, device=g.device) * (h * w)).reshape(n, c, 1, 1)
    ones = torch.ones((n, c, h, w), device=g.device, dtype=g.dtype)
    for idx, valid, _, _ in _corner_terms(px, py, h, w):
        hits.index_add_(0, (base + idx.reshape(n, 1, h, w)).reshape(-1),
                        (ones * valid[:, None]).reshape(-1))
    k = hits.reshape(n, c, h, w)
    return torch.clamp(k - 1.0, min=0.0) * (2 * _U32) * abs_sum


@functools.lru_cache(maxsize=1)
def _lib():
    from echoflow_torch.ops import _build

    lib = _build.load("warp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.echoflow_warp_forward.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.echoflow_warp_forward2.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.echoflow_warp_image_grad.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.echoflow_warp_image_grad_scratch.argtypes = [i32] * 4
    lib.echoflow_warp_image_grad_scratch.restype = ctypes.c_longlong
    lib.echoflow_warp_coord_grad.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    for fn in (lib.echoflow_warp_forward, lib.echoflow_warp_forward2,
               lib.echoflow_warp_image_grad, lib.echoflow_warp_coord_grad):
        fn.restype = ctypes.c_int
    return lib


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"the warp runs on cpu or cuda, got {t.device}")
    return False


def _check_cuda(name, nchw, coords, *others):
    """(n, c, h, w) after checking the kernel's contract, or raise."""
    dev = nchw.device
    if nchw.dim() != 4:
        raise ValueError(f"{name}: want an (N, C, H, W) tensor, got {tuple(nchw.shape)}")
    n, c, h, w = nchw.shape
    for t in (nchw, *coords, *others):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous float32 on one device")
    for t in coords:
        if tuple(t.shape) != (n, h, w):
            raise ValueError(f"{name}: coordinates {tuple(t.shape)}, want {(n, h, w)}")
    for t in others:
        if tuple(t.shape) != (n, c, h, w):
            raise ValueError(f"{name}: {tuple(t.shape)}, want {(n, c, h, w)}")
    return int(n), int(c), int(h), int(w)


def _launch(fn, name, *args):
    dev = args[0].device if isinstance(args[0], torch.Tensor) else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def warp_forward(image, px, py):
    """K2: image (N, C, H, W) sampled at px, py (N, H, W) -> (N, C, H, W)."""
    if _is_cpu(image):
        return reference_warp_forward(image, px, py)
    n, c, h, w = _check_cuda("warp_forward", image, (px, py))
    out = torch.empty_like(image)
    _launch(_lib().echoflow_warp_forward, "warp_forward", image, px, py, out, n, c, h, w)
    warp_forward.launches += 1
    return out


def warp_forward_pair(image_a, image_b, px, py):
    """K2 for two images (N, Ca, H, W) and (N, Cb, H, W) sampled at the same
    px, py (N, H, W): one launch (counted once in `warp_forward.launches`).
    Returns (out_a, out_b), each bitwise `reference_warp_forward` of its
    image."""
    if _is_cpu(image_a):
        return reference_warp_forward(image_a, px, py), reference_warp_forward(image_b, px, py)
    # Both images against the same coordinates: one device, N, H and W.
    n, ca, h, w = _check_cuda("warp_forward_pair", image_a, (px, py))
    _, cb, _, _ = _check_cuda("warp_forward_pair", image_b, (px, py))
    out_a, out_b = torch.empty_like(image_a), torch.empty_like(image_b)
    _launch(_lib().echoflow_warp_forward2, "warp_forward_pair", image_a, image_b, px, py,
            out_a, out_b, n, ca, cb, h, w)
    warp_forward.launches += 1
    return out_a, out_b


def warp_image_grad(g, px, py):
    """K3: d_img (N, C, H, W) of the warp for the output gradient g."""
    if _is_cpu(g):
        return reference_warp_image_grad(g, px, py)
    n, c, h, w = _check_cuda("warp_image_grad", g, (px, py))
    lib = _lib()
    d_img = torch.empty_like(g)   # the kernel writes every element
    scratch = torch.zeros(lib.echoflow_warp_image_grad_scratch(n, c, h, w), device=g.device)
    _launch(lib.echoflow_warp_image_grad, "warp_image_grad", g, px, py, d_img, scratch,
            n, c, h, w)
    warp_image_grad.launches += 1
    return d_img


def warp_coord_grad(image, g, px, py):
    """K4: (d_px, d_py), each (N, H, W), of the warp for the output gradient g."""
    if _is_cpu(image):
        return reference_warp_coord_grad(image, g, px, py)
    n, c, h, w = _check_cuda("warp_coord_grad", image, (px, py), g)
    d_px = torch.empty_like(px)
    d_py = torch.empty_like(py)
    _launch(_lib().echoflow_warp_coord_grad, "warp_coord_grad", image, g, px, py,
            d_px, d_py, n, c, h, w)
    warp_coord_grad.launches += 1
    return d_px, d_py


warp_forward.launches = 0
warp_image_grad.launches = 0
warp_coord_grad.launches = 0


class WarpCoords(torch.autograd.Function):
    """Differentiable warp at pixel coordinates: K2 forward; K3 and K4 in
    the backward, each only for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, image, px, py):
        image, px, py = image.contiguous(), px.contiguous(), py.contiguous()
        ctx.save_for_backward(image, px, py)
        return warp_forward(image, px, py)

    @staticmethod
    def backward(ctx, g):
        image, px, py = ctx.saved_tensors
        g = g.contiguous()
        d_img = warp_image_grad(g, px, py) if ctx.needs_input_grad[0] else None
        d_px = d_py = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_px, d_py = warp_coord_grad(image, g, px, py)
        return d_img, d_px, d_py


def warp_coords(image, px, py):
    """Bilinear border warp of image (N, C, H, W) at unclamped pixel
    coordinates px, py (N, H, W); differentiable in all three."""
    return WarpCoords.apply(image, px, py)


class WarpCoordsPair(torch.autograd.Function):
    """Two images warped at the same coordinates: one K2 launch forward; in
    the backward K3 for each image that needs a gradient and K4 for each
    image, their coordinate gradients summed (what autograd accumulates for
    two `warp_coords` calls on the same px, py)."""

    @staticmethod
    def forward(ctx, image_a, image_b, px, py):
        image_a, image_b = image_a.contiguous(), image_b.contiguous()
        px, py = px.contiguous(), py.contiguous()
        ctx.save_for_backward(image_a, image_b, px, py)
        return warp_forward_pair(image_a, image_b, px, py)

    @staticmethod
    def backward(ctx, g_a, g_b):
        image_a, image_b, px, py = ctx.saved_tensors
        g_a, g_b = g_a.contiguous(), g_b.contiguous()
        need = ctx.needs_input_grad
        d_a = warp_image_grad(g_a, px, py) if need[0] else None
        d_b = warp_image_grad(g_b, px, py) if need[1] else None
        d_px = d_py = None
        if need[2] or need[3]:
            dpx_a, dpy_a = warp_coord_grad(image_a, g_a, px, py)
            dpx_b, dpy_b = warp_coord_grad(image_b, g_b, px, py)
            d_px, d_py = dpx_a + dpx_b, dpy_a + dpy_b
        return d_a, d_b, d_px, d_py


def warp_coords_pair(image_a, image_b, px, py):
    """`(warp_coords(image_a, px, py), warp_coords(image_b, px, py))` with
    one forward launch; differentiable in all four."""
    return WarpCoordsPair.apply(image_a, image_b, px, py)
