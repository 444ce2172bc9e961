"""Convolutions whose gradients repeat bit for bit on the card.

echoflow's convolutions are XLA convs, and a training run of echoflow
from one state and one seed gives the same bits every time. cuDNN's
default fp32 backward engines do not everywhere: at 19 of the fp32
CLAS-FV step's 40 convolutions the default input-gradient engine, and at
3 the weight-gradient engine, gave other bits from call to call on the
same inputs (`profile_torch.py --convs`; engines that split a reduction
over thread blocks and add the parts with float atomics). cuDNN's
deterministic engines (`torch.backends.cudnn.deterministic`) cost phase
12's graphed fp32 step +6%, nearly all of it the input gradient of the
three stride-2 (1,3,3) convs (16.3 ms a step against 1.75).

`convolution` is the port's one convolution. Where a gradient is wanted
on a CUDA tensor in fp32 or float64 it runs `_RepeatableConv`: the
forward is cuDNN's as before (its forward engines repeat; a transposed
conv's forward, an input-gradient engine, runs under the deterministic
ones, `conv_forward`), and the
backward computes each gradient by a route fixed by the convolution's
geometry class (`ROUTES`), never by timing at run time (an autotuner
would let the choice, and so the bits, vary between processes):

- "cudnn": cuDNN's default engine, where it repeats already.
- "subpixel": an input gradient as forward convolutions of the output
  gradient, one for each phase of the stride (`input_grad_subpixel`).
- "cudnn_deterministic": cuDNN's deterministic engine for this one
  gradient (`cudnn_grads`).
- "gemm": a weight gradient as cuBLAS GEMMs (`weight_grad_gemm`). A
  pointwise conv's reads `x` and `dy` where they lie, a batched GEMM a
  sample over chunks of its positions (`pointwise_weight_grad`); any other
  takes one GEMM a kernel tap over copies of the tap's strided input
  window. cuBLAS picks its kernel from the shapes and adds split parts in
  a fixed order, so its results repeat on one architecture. The pointwise
  classes take it: cuDNN's default gave the heads' dW (C_out 2 and 4 over
  the decoder's full-resolution output) to a grouped direct kernel that
  spreads the work over the C_out x C_in outputs alone, 25 ms each.

Of grouped convolutions (`groups`) the depthwise ones alone are taken (one
input and one output channel a group, as ir-CSN's 3x3x3 convs), a class of
their own ("dw" in `geometry_class`) on cuDNN's routes; the forward and
each backward route of one run in the span `conv.depthwise`
(`utils/profiling.span`).

The bias gradient is a sum over fixed dimensions. Everything else (the
CPU, bf16, inference under `no_grad`) calls the plain functional conv.
Every route is made of allocations from the caching allocator and
launches, with no read on the host, so it runs under the graphed steps
(`train/graph.py`) and under `torch.utils.checkpoint`.
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F

from echoflow_torch.utils.profiling import span

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _pad_arg(before, after):
    """F.pad's argument (last dimension first) from per-dimension pads;
    a negative pad crops."""
    return [p for b, a in zip(reversed(before), reversed(after)) for p in (b, a)]


def _windows(x, ksize, stride, padding, out_size):
    """For each kernel tap (in the weight's order), the (N, C, *out_size)
    strided view of the zero-padded `x` that the tap multiplies."""
    if any(padding):
        x = F.pad(x, _pad_arg(padding, padding))
    for tap in itertools.product(*(range(k) for k in ksize)):
        yield x[(slice(None), slice(None)) + tuple(
            slice(t, t + s * (o - 1) + 1, s) for t, s, o in zip(tap, stride, out_size))]


# A pointwise weight gradient splits each sample's positions into at most
# this many equal chunks, one GEMM each (`pointwise_weight_grad`). The fp32
# step's three (comb2 and the heads, 4 x 401,408 positions) on an NVIDIA
# H100 80GB HBM3: 2.39 ms with 32 chunks, 1.53 with 64, 1.25 with 128;
# 1.09 with 256, where cuBLAS splits each GEMM again over a 32 MiB
# workspace (48 MiB allocated, against 8 for 128).
POINTWISE_CHUNKS = 128


def pointwise_weight_grad(x, dy):
    """The weight gradient (C_out, C_in) of a pointwise conv (kernel all
    ones, stride one, no padding), dW = sum over n, p of dy[n, :, p] x[n, :, p]^T,
    read where `x` and `dy` lie (NCDHW or channels-last: a view (C, P) of
    a sample with a unit stride on one side). A GEMM with so long a
    reduction and so few outputs leaves the card nearly empty, so each
    sample's P positions split into S = gcd(P, POINTWISE_CHUNKS) chunks: a
    batched GEMM a sample, (S, C_out, P/S) x (S, P/S, C_in), over strided
    views, then one sum of the N x S partial results in a fixed order.
    Allocates the partial results, N S C_out C_in elements."""
    n, p = x.shape[0], math.prod(x.shape[2:])
    s = math.gcd(p, POINTWISE_CHUNKS)
    parts = dy.new_empty((n, s, dy.shape[1], x.shape[1]))
    for i in range(n):
        # (C, P) -> (S, C, P/S): chunk j holds positions j P/S to (j+1) P/S - 1.
        g = dy[i].flatten(1).unflatten(1, (s, p // s)).transpose(0, 1)
        u = x[i].flatten(1).unflatten(1, (s, p // s)).transpose(0, 1)
        torch.bmm(g, u.transpose(1, 2), out=parts[i])
    return parts.sum((0, 1))


def weight_grad_gemm(x, dy, ksize, stride, padding):
    """The weight gradient of `conv(x, w, stride, padding)` (no dilation,
    one group) for the output gradient `dy`. A pointwise conv takes
    `pointwise_weight_grad`, which copies neither operand; any other, for
    each kernel tap one GEMM (C_out, N·P) x (N·P, C_in), P the output's
    positions, over a copy of the tap's window of `x` laid out (C_in, N·P)
    and one of `dy` laid out (C_out, N·P). Returns (C_out, C_in, *ksize)."""
    co, ci = dy.shape[1], x.shape[1]
    if all(k == 1 for k in ksize) and all(s == 1 for s in stride) and not any(padding):
        return pointwise_weight_grad(x, dy).view(co, ci, *ksize)
    g = dy.transpose(0, 1).reshape(co, -1)
    taps = dy.new_empty((math.prod(ksize), co, ci))
    for i, win in enumerate(_windows(x, ksize, stride, padding, dy.shape[2:])):
        torch.mm(g, win.transpose(0, 1).reshape(ci, -1).t(), out=taps[i])
    return taps.permute(1, 2, 0).reshape(co, ci, *ksize)


def _phase_kernel(weight, phase, stride, padding):
    """The taps of `weight` (C_out, C_in, *k) that feed the input positions
    s q + r (r = `phase`) in every dimension, as a forward kernel
    (C_in, C_out, *k') over the output gradient, with the offsets (lo, hi)
    of the first and last output each position reads; None where a
    dimension has no such tap. Position s q + r takes the taps a with
    r + p - a divisible by s, from output q + (r + p - a) / s."""
    kern, los, his = weight.transpose(0, 1), [], []
    for d, (r, s, p, k) in enumerate(zip(phase, stride, padding, weight.shape[2:])):
        taps = [a for a in range(k) if (r + p - a) % s == 0][::-1]
        if not taps:
            return None
        # Kernel entry m reads output q + lo + m, that is tap r + p - s (lo + m):
        # the taps from the largest down, every s-th entry of the flipped kernel.
        los.append((r + p - taps[0]) // s)
        his.append((r + p - taps[-1]) // s)
        index = [slice(None)] * kern.dim()
        index[d + 2] = slice(k - 1 - taps[0], k - taps[-1], s)
        kern = kern.flip(d + 2)[tuple(index)]
    return kern, los, his


def input_grad_subpixel(dy, weight, stride, padding, in_size):
    """The input gradient of `conv(x, weight, stride, padding)` (no
    dilation, one group), x of spatial size `in_size`, as forward
    convolutions of the output gradient `dy` (cuDNN's forward engines,
    which repeat): for each phase r of the stride (r in [0, s) in every
    dimension) the input positions s q + r take a correlation of `dy` with
    the taps that reach them. With stride 1 this is one forward conv with
    the kernel flipped and its channels swapped."""
    nd = len(stride)
    phases = list(itertools.product(*(range(s) for s in stride)))
    dx = None if len(phases) == 1 else dy.new_zeros((dy.shape[0], weight.shape[1], *in_size))
    for phase in phases:
        got = _phase_kernel(weight, phase, stride, padding)
        counts = [-(-(size - r) // s) for size, r, s in zip(in_size, phase, stride)]
        if got is None or min(counts) <= 0:
            continue
        kern, los, his = got
        before = [-lo for lo in los]
        after = [c + hi - o for c, hi, o in zip(counts, his, dy.shape[2:])]
        if before == after and min(before) >= 0:
            z = _CONV[nd](dy, kern.contiguous(), padding=before)
        else:
            z = _CONV[nd](F.pad(dy, _pad_arg(before, after)), kern.contiguous())
        if dx is None:
            return z
        dx[(slice(None), slice(None)) + tuple(
            slice(r, None, s) for r, s in zip(phase, stride))] = z
    return dx


@contextlib.contextmanager
def deterministic_cudnn():
    """`torch.backends.cudnn.deterministic` inside the block. The flag is
    process-wide: it is set and restored around one conv, on the thread
    that launches it (autograd's device thread for a backward, the
    trainer's for a forward); meanwhile no other thread of a training
    process launches a cuDNN conv (the trainers run their steps on one
    thread, and the engine's dispatch thread serves inference, which does
    not run beside a train step)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def cudnn_grads(x, weight, dy, stride, padding, transposed, mask, deterministic, groups=1):
    """`aten.convolution_backward` for the gradients in `mask` (input,
    weight, bias), with cuDNN's deterministic engines if `deterministic`
    (`deterministic_cudnn`). A depthwise 3-D conv runs aten's own
    `conv_depthwise3d` backward kernels there, whichever flag is set."""
    nd = len(stride)
    args = (dy, x, weight, None, list(stride), list(padding), [1] * nd, transposed,
            [0] * nd, groups, list(mask))
    with deterministic_cudnn() if deterministic else contextlib.nullcontext():
        return torch.ops.aten.convolution_backward(*args)


def conv_forward(x, weight, bias, stride, padding, transposed, groups=1):
    """The functional conv. A transposed one on the card runs under cuDNN's
    deterministic engines: its forward is cuDNN's input-gradient engine,
    whose default gave other bits from call to call at the CAMUS SegNet's
    decoder (tests/test_torch_cuda.py)."""
    if not transposed:
        return _CONV[len(stride)](x, weight, bias, stride=stride, padding=padding,
                                  groups=groups)
    with deterministic_cudnn() if x.is_cuda else contextlib.nullcontext():
        return _CONV_T[len(stride)](x, weight, bias, stride=stride, padding=padding)


def is_depthwise(weight_shape, groups, transposed=False) -> bool:
    """Whether a conv is depthwise: one input and one output channel a
    group."""
    return not transposed and groups > 1 and weight_shape[1] == 1 and weight_shape[0] == groups


def geometry_class(weight_shape, stride, transposed, groups=1):
    """The class of a convolution that picks its routes: its kernel's
    shape pattern and its stride, e.g. "(1,3,3)/(1,2,2)", with "T" before
    a transposed one and "dw" before a depthwise one."""
    k = ",".join(str(s) for s in weight_shape[2:])
    kind = "T" if transposed else "dw" if is_depthwise(weight_shape, groups) else ""
    return f"{kind}({k})/({','.join(str(s) for s in stride)})"


# The routes of each geometry class: (input gradient, weight gradient).
# From `profile_torch.py --convs` on an NVIDIA H100 80GB HBM3 at 700 W:
# milliseconds summed over the class's calls in one fp32 step (CLAS-FV at
# 4 x 3 x 32 x 112 x 112; CAMUS at 4 x 1 x 64 x 64, its calls in a run of
# three steps; ir-CSN-152's step with `--conv-models csn`), cuDNN's default / its deterministic engine / the candidate
# route ("subpixel" for dx, "gemm" for dW), "*" where the default engine
# gave other bits in three calls on the same inputs. A class whose default
# repeats keeps it; the others take their cheapest route that repeats.
ROUTES = {
    # CLAS-FV's R(2+1)D-18 and decoder.
    # The stem's dx is not in the step (the video needs no gradient); its
    # default engine gave other bits in two calls (tests/test_torch_cuda.py).
    "(1,7,7)/(1,2,2)": ("cudnn_deterministic", "cudnn"),   # dW 12.46 / 12.61 / 10.44
    "(3,1,1)/(1,1,1)": ("subpixel", "cudnn"),           # dx 9.55* / 8.31 / 7.95; dW 19.51
    "(1,3,3)/(1,1,1)": ("subpixel", "cudnn_deterministic"),   # dx 17.70* / 18.50 / 14.29;
    #                                                   dW 28.43* / 27.59 / 29.71
    "(1,3,3)/(1,2,2)": ("subpixel", "cudnn"),           # dx 1.84* / 16.67 / 3.86; dW 2.51
    "(3,1,1)/(2,1,1)": ("cudnn", "cudnn"),              # dx 0.88; dW 2.18
    "(1,1,1)/(2,2,2)": ("cudnn", "gemm"),               # dx 0.32; dW 2.17 / 2.19 / 0.40
    "(1,1,1)/(1,1,1)": ("cudnn", "gemm"),               # dx 1.64; dW 54.32 / 53.78 / 1.27
    #                                                   (the heads 25.59 and 25.65 each)
    # ir-CSN-152 under CLAS-FV (4 x 3 x 32 x 112 x 112; its 104 + 3
    # pointwise convs are in the two classes above: dW 91.83* / 83.72 /
    # 27.36 and 0.73 / 0.74 / 0.43, dx 11.13 and 0.56). The depthwise
    # classes run aten's conv_depthwise3d kernels under either flag.
    "(3,7,7)/(1,2,2)": ("cudnn_deterministic", "cudnn"),   # dx not in the step;
    #                                                   dW 11.35 / 11.44 / 24.81
    # Their candidates, a grouped sub-pixel dx and a batched-GEMM dW, read
    # 7.26 and 61.72 ms, 6.27 and 4.52 ms, and are not kept.
    "dw(3,3,3)/(1,1,1)": ("cudnn", "cudnn"),            # dx 2.38 / 2.49; dW 4.85 / 5.60
    "dw(3,3,3)/(2,2,2)": ("cudnn", "cudnn"),            # dx 0.95 / 0.65; dW 0.31 / 0.33
    # The CAMUS trainer's SegNet and shape autoencoder.
    "(3,3)/(1,1)": ("cudnn_deterministic", "cudnn"),    # dx not in the step, as the
    #                                                   stem's; dW 0.23
    "(3,3)/(2,2)": ("cudnn_deterministic", "cudnn_deterministic"),  # dx 0.86* / 0.95 /
    #                                                   7.60; dW 0.82* / 0.96 / 8.73
    "T(3,3)/(2,2)": ("cudnn", "cudnn_deterministic"),   # dx 0.31; dW 0.37* / 0.91 / 3.33
    "(1,1)/(1,1)": ("cudnn", "cudnn_deterministic"),    # dx 0.15; dW 0.19* / 0.28 / 0.34
}
# A class not measured takes cuDNN's deterministic engine for both.
DEFAULT_ROUTE = ("cudnn_deterministic", "cudnn_deterministic")


def _input_grad(route, x, weight, dy, stride, padding, transposed, groups=1):
    if route == "subpixel":
        return input_grad_subpixel(dy, weight, stride, padding, x.shape[2:])
    return cudnn_grads(x, weight, dy, stride, padding, transposed, (True, False, False),
                       route == "cudnn_deterministic", groups)[0]


def _weight_grad(route, x, weight, dy, stride, padding, transposed, groups=1):
    if route == "gemm":
        # The weight gradient of conv_transpose(x, w) is that of conv(dy, w)
        # for the output gradient x.
        u, v = (dy, x) if transposed else (x, dy)
        return weight_grad_gemm(u, v, weight.shape[2:], stride, padding)
    return cudnn_grads(x, weight, dy, stride, padding, transposed, (False, True, False),
                       route == "cudnn_deterministic", groups)[1]


@contextlib.contextmanager
def _depthwise_span(x, depthwise):
    """The span `conv.depthwise` around one call of a depthwise conv;
    nothing around any other conv."""
    if not depthwise:
        yield
        return
    with span("conv.depthwise", device=x.device):
        yield


class _RepeatableConv(torch.autograd.Function):
    """A convolution with cuDNN's forward and a backward of fixed routes
    (`ROUTES`); see the module docstring."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, transposed, groups=1):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, transposed, groups)
        return conv_forward(x, weight, bias, stride, padding, transposed, groups)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding, transposed, groups = ctx.conf
        dgrad, wgrad = ROUTES.get(geometry_class(weight.shape, stride, transposed, groups),
                                  DEFAULT_ROUTE)
        depthwise = is_depthwise(weight.shape, groups, transposed)
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            with _depthwise_span(dy, depthwise):
                dx = _input_grad(dgrad, x, weight, dy, stride, padding, transposed, groups)
        if ctx.needs_input_grad[1]:
            with _depthwise_span(dy, depthwise):
                dw = _weight_grad(wgrad, x, weight, dy, stride, padding, transposed, groups)
        if ctx.needs_input_grad[2]:
            db = dy.sum([0] + list(range(2, dy.dim())))
        return dx, dw, db, None, None, None, None


def repeatable(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether `convolution` takes the repeatable backward: a gradient
    wanted (of the weight, or of the input only, as through the CAMUS
    trainer's frozen shape autoencoder), on a CUDA tensor, in fp32 or
    float64."""
    return (torch.is_grad_enabled() and (weight.requires_grad or x.requires_grad)
            and x.is_cuda and x.dtype in (torch.float32, torch.float64))


def convolution(x, weight, bias=None, stride=1, padding=0, transposed=False, groups=1):
    """`F.conv{1,2,3}d(x, weight, bias, stride, padding, groups=groups)` (or
    `F.conv_transpose{1,2,3}d` when `transposed`; no dilation, no output
    padding; one group, or one a channel of a depthwise conv) whose
    backward repeats bit for bit on the card (`_RepeatableConv`); elsewhere
    the functional conv itself (`conv_forward`)."""
    nd = x.dim() - 2
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * nd if isinstance(padding, int) else tuple(padding)
    depthwise = is_depthwise(weight.shape, groups, transposed)
    if groups != 1 and not depthwise:
        raise ValueError("convolution: groups must be 1, or the channels of a depthwise conv")
    with _depthwise_span(x, depthwise):
        if repeatable(x, weight):
            return _RepeatableConv.apply(x, weight, bias, stride, padding, transposed, groups)
        return conv_forward(x, weight, bias, stride, padding, transposed, groups)
