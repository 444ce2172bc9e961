"""The repeatable convolution backward (echoflow_torch.ops.conv) on the CPU
against autograd through the plain functional conv.

On the CPU `convolution` calls the plain conv, so these tests call the
route's functions directly: `_RepeatableConv` with the routes `ROUTES`
takes for each geometry class of the CLAS-FV model and the CAMUS nets,
and each candidate route (`input_grad_subpixel`, `weight_grad_gemm`).
On the card the routes are held against cuDNN's default at the fp32 train
steps' full shapes, and two default fp32 runs bitwise
(tests/test_torch_cuda.py)."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from echoflow_torch.ops import conv as C

# (class, input shape, weight shape, stride, padding, transposed): every
# geometry class of the fp32 train steps at a small size, odd sizes where a
# stride meets them. The SAME 2-D convs see inputs the module has padded.
GEOMETRIES = [
    ("(1,7,7)/(1,2,2)", (2, 3, 3, 15, 14), (5, 3, 1, 7, 7), (1, 2, 2), (0, 3, 3), False),
    ("(3,1,1)/(1,1,1)", (2, 6, 5, 7, 6), (4, 6, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ("(1,3,3)/(1,1,1)", (2, 4, 3, 9, 8), (6, 4, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ("(1,3,3)/(1,2,2)", (2, 4, 3, 9, 8), (6, 4, 1, 3, 3), (1, 2, 2), (0, 1, 1), False),
    ("(3,1,1)/(2,1,1)", (2, 6, 5, 7, 6), (4, 6, 3, 1, 1), (2, 1, 1), (1, 0, 0), False),
    ("(1,1,1)/(2,2,2)", (2, 4, 5, 7, 6), (6, 4, 1, 1, 1), (2, 2, 2), (0, 0, 0), False),
    ("(1,1,1)/(1,1,1)", (2, 4, 5, 7, 6), (3, 4, 1, 1, 1), (1, 1, 1), (0, 0, 0), False),
    ("(3,3)/(1,1)", (2, 1, 12, 11), (5, 1, 3, 3), (1, 1), (0, 0), False),
    ("(3,3)/(2,2)", (2, 4, 13, 12), (6, 4, 3, 3), (2, 2), (0, 0), False),
    ("T(3,3)/(2,2)", (2, 6, 5, 4), (6, 4, 3, 3), (2, 2), (0, 0), True),
    ("(1,1)/(1,1)", (2, 6, 8, 7), (3, 6, 1, 1), (1, 1), (0, 0), False),
    # ir-CSN-152's stem (its depthwise classes are in GROUPED).
    ("(3,7,7)/(1,2,2)", (2, 3, 5, 15, 14), (5, 3, 3, 7, 7), (1, 2, 2), (1, 3, 3), False),
]
IDS = [g[0] for g in GEOMETRIES]
# (class, input shape, weight shape, stride, padding, groups): ir-CSN-152's
# depthwise 3x3x3 convs, at odd sizes where the stride meets them.
GROUPED = [
    ("dw(3,3,3)/(1,1,1)", (2, 6, 5, 7, 6), (6, 1, 3, 3, 3), (1, 1, 1), (1, 1, 1), 6),
    ("dw(3,3,3)/(2,2,2)", (2, 6, 5, 7, 6), (6, 1, 3, 3, 3), (2, 2, 2), (1, 1, 1), 6),
]
GROUPED_IDS = [g[0] for g in GROUPED]
# fp32 on both sides, summed in another order (the routes' GEMMs and
# forward convs against the CPU's backward kernels): relative L2 at these
# sizes 1e-7 to 4e-7; 2e-7 to 8e-7 at the full shapes on an H100
# (`profile_torch.py --convs`).
FP32_REL = 1e-5
FP64_REL = 1e-12


def _inputs(xs, ws, stride, padding, transposed, dtype, seed=0, groups=1):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(*xs), dtype=dtype, requires_grad=True)
    w = torch.tensor(rng.randn(*ws) * 0.3, dtype=dtype, requires_grad=True)
    b = torch.tensor(rng.randn(ws[1] if transposed else ws[0]), dtype=dtype,
                     requires_grad=True)
    fn = (C._CONV_T if transposed else C._CONV)[len(stride)]
    y = fn(x, w, b, stride=stride, padding=padding, **({"groups": groups} if groups > 1 else {}))
    dy = torch.tensor(rng.randn(*y.shape), dtype=dtype)
    want = torch.autograd.grad(y, (x, w, b), dy)
    return x, w, b, y, dy, want


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=IDS)
def test_routes_match_autograd_of_the_plain_conv(geometry, dtype):
    """`_RepeatableConv` with its class's routes (`ROUTES`), and each
    candidate route, against autograd through `F.conv*`: dx, dW and db in
    float64 within 1e-12, fp32 within FP32_REL, relative L2; the forward
    is the plain conv's, bit for bit."""
    cls, xs, ws, stride, padding, transposed = geometry
    assert C.geometry_class(ws, stride, transposed) == cls and cls in C.ROUTES
    x, w, b, y, dy, want = _inputs(xs, ws, stride, padding, transposed, dtype)
    xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    yr = C._RepeatableConv.apply(xr, wr, br, stride, padding, transposed)
    assert torch.equal(yr, y)
    got = torch.autograd.grad(yr, (xr, wr, br), dy)
    tol = FP64_REL if dtype == torch.float64 else FP32_REL
    for name, g, r in zip(("dx", "dW", "db"), got, want):
        assert g.shape == r.shape and g.dtype == dtype
        assert _rel(g, r) <= tol, (name, _rel(g, r))
    with torch.no_grad():
        x, w = x.detach(), w.detach()
        if not transposed:
            dx = C.input_grad_subpixel(dy, w, stride, padding, xs[2:])
            assert _rel(dx, want[0]) <= tol
        dw = C._weight_grad("gemm", x, w, dy, stride, padding, transposed)
        assert _rel(dw, want[1]) <= tol


@pytest.mark.parametrize("geometry", [g for g in GEOMETRIES if not g[-1]],
                         ids=[g[0] for g in GEOMETRIES if not g[-1]])
def test_subpixel_input_grad_at_odd_and_even_sizes(geometry):
    """The sub-pixel input gradient covers every input position once,
    where the stride does not divide the input (the last phase shorter)
    and where it does, and with no output gradient reaching some inputs
    (a stride-2 1x1x1 conv: zeros there), in float64 within 1e-12."""
    cls, xs, ws, stride, padding, _ = geometry
    for grow in (0, 1):
        shape = xs[:2] + tuple(s + grow * (st > 1) for s, st in zip(xs[2:], stride))
        x, w, _, _, dy, want = _inputs(shape, ws, stride, padding, False, torch.float64,
                                       seed=grow + 1)
        with torch.no_grad():
            dx = C.input_grad_subpixel(dy, w.detach(), stride, padding, shape[2:])
        assert dx.shape == x.shape
        assert _rel(dx, want[0]) <= FP64_REL, (cls, shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("geometry", GROUPED, ids=GROUPED_IDS)
def test_grouped_routes_match_autograd_of_the_plain_conv(geometry, dtype):
    """A depthwise conv through `_RepeatableConv` with its class's routes,
    and through each of cuDNN's engines for dx and dW, against autograd
    through `F.conv3d(..., groups=)`: float64 within 1e-12, fp32 within
    FP32_REL; the forward the plain conv's, bit for bit."""
    cls, xs, ws, stride, padding, groups = geometry
    assert C.geometry_class(ws, stride, False, groups) == cls and cls in C.ROUTES
    assert C.is_depthwise(ws, groups)
    x, w, b, y, dy, want = _inputs(xs, ws, stride, padding, False, dtype, groups=groups)
    xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    yr = C._RepeatableConv.apply(xr, wr, br, stride, padding, False, groups)
    assert torch.equal(yr, y)
    got = torch.autograd.grad(yr, (xr, wr, br), dy)
    tol = FP64_REL if dtype == torch.float64 else FP32_REL
    for name, g, r in zip(("dx", "dW", "db"), got, want):
        assert g.shape == r.shape and _rel(g, r) <= tol, (name, _rel(g, r))
    with torch.no_grad():
        x, w = x.detach(), w.detach()
        for route in ("cudnn", "cudnn_deterministic"):
            dx = C._input_grad(route, x, w, dy, stride, padding, False, groups)
            assert _rel(dx, want[0]) <= tol, route
        for route in ("cudnn", "cudnn_deterministic"):
            dw = C._weight_grad(route, x, w, dy, stride, padding, False, groups)
            assert dw.shape == ws and _rel(dw, want[1]) <= tol, route


def test_depthwise_convs_run_in_their_span_and_are_counted():
    """A depthwise conv's forward and each of its backward routes open the
    span `conv.depthwise` (its `record_function` range on the CPU), once a
    call; any other conv opens none."""
    from torch.profiler import profile

    x = torch.randn(2, 4, 3, 6, 6, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 1, 3, 3, 3, dtype=torch.float64, requires_grad=True)
    with profile() as prof:
        C.convolution(x, w, None, 2, 1, groups=4).sum().backward()
        C.convolution(x, torch.randn(5, 4, 1, 1, 1, dtype=torch.float64), None, 1, 0).sum()
    ranges = [e.name for e in prof.events() if e.name == "echoflow_torch.conv.depthwise"]
    assert len(ranges) == 1
    # The backward's routes, as `_RepeatableConv` runs them on the card.
    xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
    with profile() as prof:
        C._RepeatableConv.apply(xr, wr, None, (2, 2, 2), (1, 1, 1), False, 4).sum().backward()
    ranges = [e.name for e in prof.events() if e.name == "echoflow_torch.conv.depthwise"]
    assert len(ranges) == 2


@pytest.mark.parametrize("weight, groups", [((6, 2, 3, 3, 3), 3), ((6, 1, 3, 3, 3), 3)],
                         ids=["two-channels-a-group", "six-outputs-of-three-groups"])
def test_convolution_takes_no_grouped_conv_but_a_depthwise_one(weight, groups):
    """A grouped conv that is not depthwise (one input and one output
    channel a group) is refused before it runs: no route repeats it."""
    x = torch.randn(2, 6 if weight[1] == 2 else 3, 3, 6, 6)
    with pytest.raises(ValueError, match="depthwise"):
        C.convolution(x, torch.randn(weight), None, 1, 1, groups=groups)


def test_routes_cover_every_train_geometry():
    """Every convolution of the CLAS-FV model's (over R(2+1)D-18 and over
    ir-CSN-152) and the CAMUS nets' training forwards, recorded as it
    runs, has its class in `ROUTES` (none falls to `DEFAULT_ROUTE`), and
    its class is one of GEOMETRIES' or GROUPED's."""
    import train_camus_torch
    from echoflow_torch.models.csn import CSNMotionSegNet
    from echoflow_torch.models.r2plus1d import create_model
    from echoflow_torch.train.generic import ShapeAutoencoder

    seen = set()
    plain = C.convolution

    def recording(x, weight, bias=None, stride=1, padding=0, transposed=False, groups=1):
        nd = x.dim() - 2
        seen.add(C.geometry_class(weight.shape, (stride,) * nd if isinstance(stride, int)
                                  else tuple(stride), transposed, groups))
        return plain(x, weight, bias, stride, padding, transposed, groups)

    C.convolution = recording
    try:
        create_model(seed=0).train()(torch.zeros(2, 3, 4, 16, 16))
        CSNMotionSegNet(stages=((1, 4, 1), (1, 8, 2), (1, 8, 2), (1, 8, 2))).train()(
            torch.zeros(2, 3, 8, 32, 32))
        train_camus_torch.SegNet()(torch.zeros(1, 1, 16, 16))
        ShapeAutoencoder(image_size=(16, 16))(torch.zeros(1, 4, 16, 16))
    finally:
        C.convolution = plain
    assert seen and seen <= set(C.ROUTES)
    assert seen == set(IDS) | set(GROUPED_IDS[:2])


def test_plain_conv_off_the_route(monkeypatch):
    """The CPU, bf16 and inference under `no_grad` call the plain conv:
    `convolution` on CPU tensors never runs `_RepeatableConv` and equals
    `F.conv3d` bit for bit; `repeatable` holds only for a CUDA fp32 or
    float64 input with a gradient wanted (stand-ins for CUDA tensors:
    this host has no card)."""
    def refuse(*args):
        raise AssertionError("_RepeatableConv on the CPU")

    monkeypatch.setattr(C._RepeatableConv, "apply", refuse)
    x = torch.randn(2, 4, 3, 9, 8, requires_grad=True)
    w = torch.randn(6, 4, 1, 3, 3, requires_grad=True)
    y = C.convolution(x, w, None, (1, 2, 2), (0, 1, 1))
    assert torch.equal(y, F.conv3d(x, w, None, (1, 2, 2), (0, 1, 1)))
    y.sum().backward()
    with torch.no_grad():
        C.convolution(x.bfloat16(), w.bfloat16(), None, 1, (0, 1, 1))

    def card(dtype, grad):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype, requires_grad=grad)

    assert C.repeatable(card(torch.float32, False), card(torch.float32, True))
    assert C.repeatable(card(torch.float64, True), card(torch.float64, False))
    assert not C.repeatable(card(torch.bfloat16, False), card(torch.bfloat16, True))
    assert not C.repeatable(card(torch.float32, False), card(torch.float32, False))
    with torch.no_grad():
        assert not C.repeatable(card(torch.float32, False), card(torch.float32, True))
    assert not C.repeatable(x, w)


def test_model_layers_call_the_repeatable_convolution(monkeypatch):
    """`Conv3d`, `SameConv2d` and `SameConvTranspose2d` go through
    `ops/conv.convolution` (which picks the route), with the arguments the
    plain layers would pass."""
    from echoflow_torch.models.flax_layers import SameConv2d, SameConvTranspose2d
    from echoflow_torch.models.r2plus1d import Conv3d

    calls = []
    plain = C.convolution

    def recording(x, weight, bias=None, stride=1, padding=0, transposed=False, groups=1):
        calls.append((tuple(weight.shape), tuple(stride) if not isinstance(stride, int)
                      else stride, padding, transposed))
        return plain(x, weight, bias, stride, padding, transposed, groups)

    monkeypatch.setattr(C, "convolution", recording)
    conv = Conv3d(4, 6, (1, 3, 3), (1, 2, 2), (0, 1, 1), bias=False)
    x = torch.randn(1, 4, 2, 9, 9)
    assert torch.equal(conv(x), F.conv3d(x, conv.weight, None, (1, 2, 2), (0, 1, 1)))
    same = SameConv2d(4, 6, 3, 2)
    same_t = SameConvTranspose2d(6, 4, 3, 2)
    z = torch.randn(1, 4, 8, 8)
    assert same(z).shape == (1, 6, 4, 4) and same_t(same(z)).shape == (1, 4, 8, 8)
    assert calls == [((6, 4, 1, 3, 3), (1, 2, 2), (0, 1, 1), False),
                     ((6, 4, 3, 3), (2, 2), 0, False), ((6, 4, 3, 3), (2, 2), 0, False),
                     ((6, 4, 3, 3), (2, 2), 0, True)]


# (N, C_in, C_out, spatial size, channels-last-3d input): the pointwise
# class's shapes at a small size, the heads' C_out 2 and 4 and comb2's 64;
# 4 x 8 x 8 = 256 positions split into 128 chunks of two, 3 x 5 x 7 = 105
# into one chunk.
POINTWISE = [
    (1, 64, 2, (3, 5, 7), False),
    (3, 64, 4, (3, 5, 7), False),
    (3, 64, 64, (4, 8, 8), False),
    (1, 64, 64, (2, 4, 6), False),
    (3, 64, 2, (4, 8, 8), True),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", POINTWISE,
                         ids=[f"n{n}-co{co}" + ("-cl" if cl else "") for n, _, co, _, cl in POINTWISE])
def test_pointwise_weight_grad_matches_autograd(case, dtype, monkeypatch):
    """`weight_grad_gemm` of a pointwise conv (kernel all ones, stride one,
    no padding), which runs `pointwise_weight_grad`, against autograd of
    the plain conv: float64 within 1e-12, fp32 within FP32_REL, relative
    L2. Every GEMM reads views of `x` and `dy` themselves, no copy: their
    operands share the tensors' storage."""
    n, ci, co, size, channels_last = case
    rng = np.random.RandomState(n + co)
    x = torch.tensor(rng.randn(n, ci, *size), dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last_3d)
    w = torch.tensor(rng.randn(co, ci, 1, 1, 1) * 0.3, dtype=dtype, requires_grad=True)
    y = F.conv3d(x, w)
    dy = torch.tensor(rng.randn(*y.shape), dtype=dtype)
    want = torch.autograd.grad(y, w, dy)[0]
    bmm, operands = torch.bmm, []

    def recording(a, b, **kwargs):
        operands.append((a.untyped_storage().data_ptr(), b.untyped_storage().data_ptr()))
        return bmm(a, b, **kwargs)

    monkeypatch.setattr(torch, "bmm", recording)
    got = C.weight_grad_gemm(x, dy, (1, 1, 1), (1, 1, 1), (0, 0, 0))
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    assert _rel(got, want) <= (FP64_REL if dtype == torch.float64 else FP32_REL)
    storage = (dy.untyped_storage().data_ptr(), x.untyped_storage().data_ptr())
    assert operands == [storage] * n


@pytest.mark.parametrize("cls, routes", [("(1,1,1)/(1,1,1)", ("cudnn", "gemm")),
                                         ("(1,1,1)/(2,2,2)", ("cudnn", "gemm")),
                                         ("(1,1)/(1,1)", ("cudnn", "cudnn_deterministic"))])
def test_pointwise_classes_routes(cls, routes):
    """The CLAS-FV step's pointwise classes (the decoder's comb2 and heads;
    the downsampling shortcuts) take the "gemm" weight gradient, off
    cuDNN's default, and keep cuDNN's default input gradient; the CAMUS
    trainer's 2-D pointwise class keeps cuDNN's deterministic engine."""
    assert C.ROUTES[cls] == routes
