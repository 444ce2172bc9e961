"""CUDA kernels of echoflow_torch against their plain versions, and the
train step on the card against the CPU port.

Needs an NVIDIA GPU and nvcc; skips elsewhere. This file imports neither
jax nor echoflow, so on a machine without them it runs with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from echoflow_torch.ops.decoder_heads import decoder_heads, reference_decoder_heads
from echoflow_torch.utils.profiling import counters

SHAPES = dict(b1=(64,), w2=(64, 64), b2=(64,), ws=(64, 2), bs=(2,), wm=(64, 4), bm=(4,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _launched(kernel: str) -> int:
    """The launches of a kernel wrapper counted so far (`<kernel>.launches`)."""
    return counters().get(f"{kernel}.launches", 0)


def _k1_inputs(sizes, bt=(2, 32), scale=1.0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    projs = [torch.randn(*bt, s, s, 64, device="cuda", generator=g) * (0.2 * scale)
             for s in sizes]
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in SHAPES.items()}
    return projs, w


def _check_k1(projs, w, out_hw, with_motion=True, align_corners=True):
    before = _launched("decoder_heads")
    seg, mot = decoder_heads(projs, **w, out_hw=out_hw, with_motion=with_motion,
                             align_corners=align_corners)
    torch.cuda.synchronize()
    assert _launched("decoder_heads") == before + 1
    rseg, rmot = reference_decoder_heads(projs, **w, out_hw=out_hw, with_motion=with_motion,
                                         align_corners=align_corners)
    # fp32 on both sides (comb2 as 3xTF32 on the tensor cores); the
    # summation order and the dropped lo*lo term of comb2 differ.
    torch.testing.assert_close(seg, rseg, rtol=1e-4, atol=1e-4)
    if with_motion:
        torch.testing.assert_close(mot, rmot, rtol=1e-4, atol=1e-4)
    else:
        assert mot is None


@pytest.mark.cuda
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("with_motion", [True, False])
@pytest.mark.parametrize("sizes", [(56, 28, 14, 7), (56, 7), (28,), (56, 28, 14, 7, 4)])
def test_decoder_heads_kernel_matches_plain(cuda, sizes, with_motion, align_corners):
    """The main path's source sizes with 2 clips (30 in the engine), and
    fewer sources, and ir-CSN-152's five, with and without the motion
    head, both corner modes."""
    projs, w = _k1_inputs(sizes)
    _check_k1(projs, w, (112, 112), with_motion, align_corners)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_tile", "one_frame", "inputs_x30", "three_tiles_a_row"])
def test_decoder_heads_kernel_edge_cases(cuda, case):
    """A 40x36 output fills 36 of a tile's 64 rows (1,440 pixels, not a
    multiple of 64); B*T = 1 gives one frame; inputs x30 put |y| in
    the tens, where the TF32 hi/lo split of y must still carry fp32; a
    150-wide output has 3 tiles a row, so a warpgroup's tile column changes
    every round."""
    if case == "ragged_tile":
        projs, w = _k1_inputs((20, 10, 5, 3), bt=(2, 3), seed=1)
        _check_k1(projs, w, (40, 36), align_corners=False)
        _check_k1(projs, w, (40, 36), with_motion=False)
    elif case == "one_frame":
        projs, w = _k1_inputs((56, 28, 14, 7), bt=(1, 1), seed=2)
        _check_k1(projs, w, (112, 112))
    elif case == "three_tiles_a_row":
        projs, w = _k1_inputs((28, 14, 7), bt=(1, 4), seed=4)
        _check_k1(projs, w, (24, 150))
    else:
        projs, w = _k1_inputs((56, 28, 14, 7), scale=30.0, seed=3)
        assert float(reference_decoder_heads(projs, **w, out_hw=(112, 112))[0].abs().max()) > 10
        _check_k1(projs, w, (112, 112))


@pytest.mark.cuda
def test_decoder_heads_rejects_what_the_kernel_cannot_take(cuda):
    p = [torch.zeros(1, 2, 8, 8, 32, device="cuda")]   # 32 channels: not compiled
    w = {k: torch.zeros(*s, device="cuda") for k, s in SHAPES.items()}
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))
    p = [torch.zeros(1, 2, 8, 8, 64, device="cuda").transpose(2, 3)]   # not contiguous
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))
    p = [torch.zeros(1, 2, 8, 8, 64, device="cuda", dtype=torch.bfloat16)]
    with pytest.raises(ValueError):
        decoder_heads(p, **w, out_hw=(16, 16))


@pytest.mark.cuda
def test_decoder_heads_rejects_a_fifth_source(cuda):
    """The kernel takes at most five sources (ir-CSN-152's five tap
    resolutions; R(2+1)D-18 merges its taps to four): a sixth, past the
    fifth that it now takes, is refused before any launch."""
    p = [torch.zeros(1, 2, s, s, 64, device="cuda") for s in (56, 28, 14, 7, 4, 2)]
    w = {k: torch.zeros(*s, device="cuda") for k, s in SHAPES.items()}
    before = _launched("decoder_heads")
    with pytest.raises(ValueError, match="1..5 sources"):
        decoder_heads(p, **w, out_hw=(112, 112))
    assert _launched("decoder_heads") == before


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 50.0
    video = make_beating_video(num_frames=45, height=32, width=32, period=20.0,
                               seed=1).video.astype(np.uint8)
    gpu = VideoSegmenter(state, dtype=torch.float32, bucket=32, forward_chunk=4)
    cpu = VideoSegmenter(state, device="cpu", bucket=32, forward_chunk=4)
    before = _launched("decoder_heads")
    for method in ("majority", "simple", "softmax"):
        a = gpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        b = cpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        # argmax near-ties between two fp32 backends may flip a pixel.
        assert (a != b).mean() <= 1e-3
    assert _launched("decoder_heads") > before


# Odd and training shapes. C = 1-4 reach the compiled channel counts of K3
# and K4, and 5, 7, 60 their generic chunks (C not a multiple of 4 pads
# K3's channels-last accumulator); W = 17, 9, 1, 30, 6 are not multiples of
# 4, and 15 x 17, 1 x 9, 33 x 30 pixels not a multiple of a warp.
WARP_SHAPES = [(3, 5, 15, 17), (2, 1, 1, 9), (1, 2, 31, 1), (2, 7, 33, 30), (3, 1, 12, 6),
               (2, 2, 20, 28), (2, 7, 112, 112), (1, 60, 6, 1000), (8, 4, 112, 112),
               (8, 3, 112, 112), (124, 3, 112, 112)]


def _warp_inputs(shape, seed=0, motion="far"):
    """Image, output gradient and coordinates on the card. "far": offsets
    reach far past the border; "near": about 0.3 px from the identity, so
    every element of d_img takes its terms from neighbouring pixels and
    neighbouring lanes often hold the same corners; "shift": a uniform
    0.3 px shift, so nearly every lane's x0 + 1 corners are the next lane's
    x0 corners (the shuffle paths of K2, K3 and K4). Some coordinates sit
    exactly on the last row and column."""
    n, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.rand(shape, device="cuda", generator=g)
    grad = torch.randn(shape, device="cuda", generator=g)
    if motion == "far":
        px = (torch.rand((n, h, w), device="cuda", generator=g) * 1.4 - 0.2) * w - 0.5
        py = (torch.rand((n, h, w), device="cuda", generator=g) * 1.4 - 0.2) * h - 0.5
    else:
        noise = 0.3 * torch.randn((2, n, h, w), device="cuda", generator=g) \
            if motion == "near" else torch.full((2, n, h, w), 0.3, device="cuda")
        px = torch.arange(w, device="cuda", dtype=torch.float32) + noise[0]
        py = torch.arange(h, device="cuda", dtype=torch.float32)[:, None] + noise[1]
    px[:, ::3, ::4] = w - 1.0
    py[:, ::4, ::3] = h - 1.0
    return image, grad, px.contiguous(), py.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("motion", ["far", "near", "shift"])
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_kernels_match_plain(cuda, shape, motion):
    """K2 and K4 repeat the plain versions' elementwise arithmetic in the
    same order, so they are bitwise equal. K3 sums each element's terms in
    a fixed order (each corner's sources apart): it stays within the
    per-element bound of `image_grad_tolerance` of the plain version, and
    gives the same bits again."""
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs(shape, motion=motion)
    before = (_launched("warp_forward"), _launched("warp_image_grad"),
              _launched("warp_coord_grad"))
    out = wk.warp_forward(image, px, py)
    d_img = wk.warp_image_grad(grad, px, py)
    d_img2 = wk.warp_image_grad(grad, px, py)
    d_px, d_py = wk.warp_coord_grad(image, grad, px, py)
    torch.cuda.synchronize()
    assert (_launched("warp_forward"), _launched("warp_image_grad"),
            _launched("warp_coord_grad")) == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert torch.equal(out, wk.reference_warp_forward(image, px, py))
    r_px, r_py = wk.reference_warp_coord_grad(image, grad, px, py)
    assert torch.equal(d_px, r_px) and torch.equal(d_py, r_py)
    tol = wk.image_grad_tolerance(grad, px, py)
    assert bool(((d_img - wk.reference_warp_image_grad(grad, px, py)).abs() <= tol).all())
    assert torch.equal(d_img.view(torch.int32), d_img2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("motion", ["far", "near"])
@pytest.mark.parametrize("shape", [(8, 4, 112, 112), (124, 3, 112, 112)],
                         ids=["label_warp", "ota"])
def test_image_grad_kernel_gives_the_same_bits_every_launch(cuda, shape, motion):
    """K3 at the fused step's label-warp shape and the OTA batch's, under
    rough and smooth motion: 10 launches on the same inputs give the same
    bits, within `image_grad_tolerance` of the plain version."""
    from echoflow_torch.ops import warp_kernel as wk

    _, grad, px, py = _warp_inputs(shape, motion=motion)
    runs = [wk.warp_image_grad(grad, px, py) for _ in range(10)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r.view(torch.int32), runs[0].view(torch.int32))
    tol = wk.image_grad_tolerance(grad, px, py)
    assert bool(((runs[0] - wk.reference_warp_image_grad(grad, px, py)).abs() <= tol).all())


@pytest.mark.cuda
def test_warp_autograd_launches_each_kernel_only_when_needed(cuda):
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs((2, 3, 16, 16))
    px.requires_grad_()
    py.requires_grad_()
    before = _launched("warp_image_grad"), _launched("warp_coord_grad")
    (wk.warp_coords(image, px, py) * grad).sum().backward()   # image needs no grad
    assert (_launched("warp_image_grad"), _launched("warp_coord_grad")) == \
        (before[0], before[1] + 1)
    image.requires_grad_()
    (wk.warp_coords(image, px, py) * grad).sum().backward()
    assert (_launched("warp_image_grad"), _launched("warp_coord_grad")) == \
        (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_warp_kernels_reject_what_they_cannot_take(cuda):
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs((2, 3, 8, 8))
    with pytest.raises(ValueError):
        wk.warp_forward(image.double(), px.double(), py.double())
    with pytest.raises(ValueError):
        wk.warp_forward(image, px.transpose(1, 2), py)   # not contiguous
    with pytest.raises(ValueError):
        wk.warp_coord_grad(image, grad[:, :2].contiguous(), px, py)


# Channel pairs of the pair launch: the chain step's (label 4, video 3),
# single channels, and the generic chunks on either side.
CHANNEL_PAIRS = [(4, 3), (1, 1), (3, 60), (7, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("motion", ["far", "near", "shift"])
@pytest.mark.parametrize("channels", CHANNEL_PAIRS)
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_forward_pair_matches_plain(cuda, shape, channels, motion):
    """One launch (one count) warps both images, each bitwise the plain
    version of its own."""
    from echoflow_torch.ops import warp_kernel as wk

    n, _, h, w = shape
    image_a, _, px, py = _warp_inputs((n, channels[0], h, w), motion=motion)
    image_b = torch.rand((n, channels[1], h, w), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(5))
    before = _launched("warp_forward")
    out_a, out_b = wk.warp_forward_pair(image_a, image_b, px, py)
    torch.cuda.synchronize()
    assert _launched("warp_forward") == before + 1
    assert torch.equal(out_a, wk.reference_warp_forward(image_a, px, py))
    assert torch.equal(out_b, wk.reference_warp_forward(image_b, px, py))


@pytest.mark.cuda
def test_warp_forward_pair_rejects_what_it_cannot_take(cuda):
    from echoflow_torch.ops import warp_kernel as wk

    image, _, px, py = _warp_inputs((2, 4, 8, 8))
    video = torch.rand(2, 3, 8, 8, device="cuda")
    before = _launched("warp_forward")
    for bad in (torch.rand(3, 3, 8, 8, device="cuda"),    # N
                torch.rand(2, 3, 9, 8, device="cuda"),    # H
                torch.rand(2, 3, 8, 7, device="cuda"),    # W
                video.double(),                           # dtype
                torch.rand(2, 3, 8, 8, device="cuda").transpose(2, 3)):   # not contiguous
        with pytest.raises(ValueError):
            wk.warp_forward_pair(image, bad, px, py)
        with pytest.raises(ValueError):
            wk.warp_forward_pair(bad, image, px, py)
    with pytest.raises(ValueError):
        wk.warp_forward_pair(image, video, px[:1], py[:1])
    with pytest.raises(ValueError):
        wk.warp_forward_pair(image, video.cpu(), px, py)
    assert _launched("warp_forward") == before


@pytest.mark.cuda
def test_warp_coords_pair_autograd_launches_and_gradients(cuda):
    """The fused loss's shape of use: a label stack that needs a gradient,
    a video stack that does not. Forward K2 once; backward K3 once (label
    only) and K4 twice. The coordinate gradients are bitwise what two
    `warp_coords` calls give; the label's d_img within K3's bound."""
    from echoflow_torch.ops import warp_kernel as wk

    label, grad, px, py = _warp_inputs((4, 4, 20, 28), motion="near")
    video = torch.rand(4, 3, 20, 28, device="cuda")
    g_b = torch.randn(4, 3, 20, 28, device="cuda")
    runs = []
    for pair in (True, False):
        lab = label.clone().requires_grad_()
        x, y = px.clone().requires_grad_(), py.clone().requires_grad_()
        before = (_launched("warp_forward"), _launched("warp_image_grad"),
                  _launched("warp_coord_grad"))
        if pair:
            out_a, out_b = wk.warp_coords_pair(lab, video, x, y)
        else:
            out_a, out_b = wk.warp_coords(lab, x, y), wk.warp_coords(video, x, y)
        ((out_a * grad).sum() + (out_b * g_b).sum()).backward()
        torch.cuda.synchronize()
        counts = tuple(b - a for a, b in zip(before, (
            _launched("warp_forward"), _launched("warp_image_grad"), _launched("warp_coord_grad"))))
        runs.append((counts, out_a.detach(), out_b.detach(), lab.grad, x.grad, y.grad))
    (c_pair, *got), (c_two, *want) = runs
    assert c_pair == (1, 1, 2) and c_two == (2, 1, 2)
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i], want[i])
    tol = wk.image_grad_tolerance(grad, px, py)
    assert bool(((got[2] - wk.reference_warp_image_grad(grad, px, py)).abs() <= tol).all())


@pytest.mark.cuda
def test_fused_loss_makes_no_host_sync(cuda):
    """`clasfv_total_loss_fused`, forward and backward, at the full-width
    step's shape (batch 4 x 3 x 32 x 112 x 112) with
    `torch.cuda.set_sync_debug_mode("error")`: no call in it waits for the
    device. The first call makes the cached base grids; the checked call
    is the second, as every step after a run's first."""
    from echoflow_torch.train.losses import clasfv_total_loss_fused

    n, c, t, h, w = 4, 3, 32, 112, 112
    g = torch.Generator(device="cuda").manual_seed(0)
    video = torch.rand((n, c, t, h, w), device="cuda", generator=g)
    labels = (torch.rand((2, n, h, w), device="cuda", generator=g) > 0.5).long()
    ed_idx = torch.tensor([0, 3, 10, 20], device="cuda")
    es_idx = torch.tensor([t - 1, 12, 4, 21], device="cuda")

    def step():
        seg = (2.0 * torch.randn((n, 2, t, h, w), device="cuda", generator=g)).requires_grad_()
        motion = torch.tanh(0.05 * torch.randn((n, 4, t, h, w), device="cuda",
                                               generator=g)).requires_grad_()
        total, _ = clasfv_total_loss_fused(video, seg, motion, labels[0], labels[1],
                                           ed_idx, es_idx)
        total.backward()
        return total.detach(), seg.grad, motion.grad

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(x).all()) for x in out)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu_port(cuda):
    """One fused step at (2, 3, 8, 32, 32) on synthetic echo clips from the
    same seeded state, the limits of `chip_smoke.py` phase 6: loss within
    1e-5 relative, all gradients within 5e-3 and each leaf's within 1e-2 in
    relative L2 (leaves that are 0 in exact arithmetic, below 1e-4 of the
    largest, stay there). fp32 rounding on both sides, cuDNN's and the
    CPU's conv algorithms and K3's order of sums differ; dropping K3 from the
    label warps moves the worst leaf by 0.61. The inputs are echo-like on
    purpose: on a uniform-noise video a one-ulp shift of a coordinate
    across an integer changes the warp's slope by O(1), and the CPU port's
    own float32 step is 9.5e-3 from its float64 step (1.2e-3 here)."""
    from echoflow_torch.train.loop import TrainConfig, create_train_state, make_train_step
    from echoflow_torch.ops import warp_kernel as wk
    from train_clasfv_torch import synthetic_batches

    n, t, h = 2, 8, 32
    host = next(synthetic_batches(n, t, h, 1, seed=11))
    batch = {k: torch.as_tensor(v) for k, v in host.items()}
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = TrainConfig(clip_length=t, image_size=(h, h), batch_size=n)
        state = create_train_state(3, cfg, device=dev)
        before = _launched("warp_forward")
        state, m = make_train_step()(state, {k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":   # one pair launch per chain step
            assert _launched("warp_forward") == before + (t - 1)
        out[dev] = (float(m["loss"]), {k: p.grad.detach().double().cpu()
                                       for k, p in state.model.named_parameters()})
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    flat = lambda grads: torch.cat([grads[k].reshape(-1) for k in gh])
    assert float((flat(gc) - flat(gh)).norm() / flat(gh).norm()) <= 5e-3
    top = max(float(g.norm()) for g in gh.values())
    for k, g in gh.items():
        if float(g.norm()) > 1e-4 * top:
            assert float((gc[k] - g).norm() / g.norm()) <= 1e-2, k
        else:
            assert float(gc[k].norm()) <= 1e-4 * top, k


@pytest.mark.cuda
def test_bf16_train_step_on_the_card_is_as_close_to_float64_as_the_cpu_port(cuda):
    """The bf16 fused step (`TrainConfig.compute_dtype`) at (2, 3, 8, 32, 32)
    on the card and on the CPU from the same seeded state with damped
    residual branches (`chip_smoke.damped_residuals`, so that bf16 is well
    conditioned) and batch, each measured from the CPU port's float64
    step: `chip_smoke.py` phase 11c's bars (the card's gradients and each
    leaf at most 2x as far as the CPU's, the gradients at most 0.5 and the
    loss 1e-2 from float64, the stem's statistics within 5e-4 of the
    CPU's); it raises if one fails."""
    from chip_smoke import BF16_GRAD_ABS, phase_bf16_vs_float64

    out = phase_bf16_vs_float64()
    assert out["card"]["grad_rel"] <= BF16_GRAD_ABS


def _no_sync(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any call in it
    that waits for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_folded_forward_chunk_makes_no_host_sync(cuda):
    """One forward chunk of the folded model with K1 (2 clips x 32 x 112 x
    112, with and without the motion head): after a first chunk, which
    builds the cached resize matrices and K1's tables, nothing in a chunk
    waits for the device."""
    from echoflow_torch.models.fast_forward import folded_forward
    from echoflow_torch.models.fold_bn import fold_state_dict
    from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet, create_model

    model = R2Plus1DMotionSegNet(folded=True)
    model.load_state_dict(fold_state_dict(create_model(seed=2).state_dict()))
    model = model.eval().requires_grad_(False).cuda()
    video = torch.rand((2, 3, 32, 112, 112), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    for with_motion in (True, False):
        with torch.no_grad():
            folded_forward(model, video, with_motion=with_motion)
            seg, mot = _no_sync(lambda: folded_forward(model, video, with_motion=with_motion))
        assert seg.shape == (2, 2, 32, 112, 112) and bool(torch.isfinite(seg).all())
        assert (mot is not None) == with_motion


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,remat", [(torch.float32, False),
                                                 (torch.bfloat16, False),
                                                 (torch.float32, True),
                                                 (torch.bfloat16, True)],
                         ids=["fp32", "bf16", "fp32-remat", "bf16-remat"])
def test_train_step_makes_no_host_sync(cuda, compute_dtype, remat):
    """A whole fused train step (forward, loss, backward, Adam) at batch 2 x
    3 x 32 x 112 x 112, after a first step: no call waits for the device,
    in bf16 and with remat too."""
    from echoflow_torch.train.loop import (TrainConfig, create_train_state, make_train_step,
                                           prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig(batch_size=2, compute_dtype=compute_dtype)
    state = create_train_state(0, cfg, device="cuda")
    batches = list(prefetch_to_device(synthetic_batches(2, 32, 112, 2, seed=0), "cuda"))
    step = make_train_step(fused_ota=True, remat=remat)
    state, _ = step(state, batches[0])
    state, metrics = _no_sync(lambda: step(state, batches[1]))
    assert np.isfinite(float(metrics["loss"])) and state.step == 2


@pytest.mark.cuda
def test_engine_dispatch_makes_no_host_sync(cuda):
    """`segment_video_async` of a video whose length the engine has seen
    enqueues everything without waiting, through the eager body and as a
    replay of the engine's graph (after its warm-up and capture); the
    fetch waits by design."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter, _unpackbits
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    video = make_beating_video(num_frames=48, seed=1).video.astype(np.uint8)
    eager = VideoSegmenter(state, dtype=torch.float32, forward_chunk=8)
    eager._run = eager._run.__wrapped__
    graphed = VideoSegmenter(state, dtype=torch.float32, forward_chunk=8)
    want = eager.segment_video(video, num_clips=2, step=1)
    assert np.array_equal(graphed.segment_video(video, num_clips=2, step=1), want)
    assert np.array_equal(graphed.segment_video(video, num_clips=2, step=1), want)
    for engine in (eager, graphed):
        pending, (length, width) = _no_sync(lambda: engine.segment_video_async(
            video, num_clips=2, step=1))
        np.testing.assert_array_equal(_unpackbits(pending.numpy(), width)[:length], want)
    assert sum(e.replays for e in graphed._run.graphs.values()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, "auto"], ids=["fp32", "bf16"])
def test_graphed_engine_is_bitwise_the_eager_engine(cuda, dtype):
    """The engine's graphs against its eager body on full-width seeded
    weights: 176- and 100-frame 112x112 videos through `segment_videos`
    with 3 in flight, so the 176-frame key captures while the first
    videos' masks are fetched on other threads; every mask bitwise the
    eager engine's, in order; one graph a key; K1 launched once a video by
    its counter."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 50.0
    videos = [make_beating_video(num_frames=n, period=40.0, seed=i).video.astype(np.uint8)
              for i, n in enumerate((100, 176, 100, 176, 176, 100))]
    eager = VideoSegmenter(state, dtype=dtype)
    eager._run = eager._run.__wrapped__
    want = list(eager.segment_videos(videos, num_clips=5, step=1))
    engine = VideoSegmenter(state, dtype=dtype)
    before = _launched("decoder_heads")
    got = list(engine.segment_videos(videos, num_clips=5, step=1, queue_depth=3))
    assert _launched("decoder_heads") - before == len(videos)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert len(engine._run.graphs) == 2
    assert sorted(e.replays for e in engine._run.graphs.values()) == [2, 2]


@pytest.mark.cuda
def test_graphed_clip_forward_is_bitwise_the_eager_one(cuda):
    """`ClipForward` through its graphs (5 clips in chunks of 2: a graph of
    2 clips and one of 1) against its eager forward, three calls: the
    same bits every time; K1 once a chunk by its counter."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.clips import ClipForward
    from echoflow_torch.ops.normalize import zeroone_normalizer

    state = _clip_state()
    video = zeroone_normalizer(make_beating_video(num_frames=40, seed=3).video.copy())
    clips = np.stack([video[:, s:s + 32] for s in range(5)])
    eager = ClipForward(state, forward_chunk=2)
    eager._forward = eager._forward.__wrapped__
    want = eager(clips)
    fwd = ClipForward(state, forward_chunk=2)
    before = _launched("decoder_heads")
    for _ in range(3):
        for a, b in zip(fwd(clips), want):
            assert np.array_equal(a, b)
    assert _launched("decoder_heads") - before == 9
    assert len(fwd._forward.graphs) == 2


def _clip_state():
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=4).state_dict()
    state["motion_head.weight"] = state["motion_head.weight"] * 100.0   # motions of ~0.3
    return state


@pytest.mark.cuda
def test_clip_forward_on_the_card_matches_its_plain_path(cuda):
    """`ClipForward` (folded, K1 with the motion head) against the module's
    forward on the card, 5 clips in chunks of 2: K1 launches
    ceil(5 / 2) = 3 times; probabilities and motion within 1e-4 (fp32 on
    both sides, folding and 3xTF32 change the rounding); and against the
    CPU port on the same clips."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.clips import ClipForward
    from echoflow_torch.ops.normalize import zeroone_normalizer

    state = _clip_state()
    video = zeroone_normalizer(make_beating_video(num_frames=40, seed=3).video.copy())
    clips = np.stack([video[:, s:s + 32] for s in range(5)])
    fwd = ClipForward(state, forward_chunk=2)
    before = _launched("decoder_heads")
    probs, motion = fwd(clips)
    assert _launched("decoder_heads") == before + 3
    assert float(np.abs(motion).max()) > 0.1
    for other in (ClipForward(state, forward_chunk=2, fold_bn=False),
                  ClipForward(state, device="cpu", forward_chunk=2)):
        r_probs, r_motion = other(clips)
        np.testing.assert_allclose(probs, r_probs, rtol=0, atol=1e-4)
        np.testing.assert_allclose(motion, r_motion, rtol=0, atol=1e-4)
    empty = fwd(clips[:0])
    assert [e.shape for e in empty] == [(0, 2, 32, 112, 112), (0, 4, 32, 112, 112)]


@pytest.mark.cuda
def test_bilinear_rollout_on_the_card_is_bitwise_plain(cuda, monkeypatch):
    """A bilinear `deform_forback` (2 x 31 launches of K2) and
    `deform_images_forback` (1 + 31) at 4 clips x 32 frames x 112 x 112,
    eager (`__wrapped__`: the graphed rollouts are
    `test_graphed_rollouts_are_bitwise_the_eager_ones`), each bitwise the
    same call with the warp's plain forward."""
    import torch.nn.functional as F

    from echoflow_torch.infer import propagate
    from echoflow_torch.ops import warp_kernel as wk

    deform_forback = propagate.deform_forback.__wrapped__
    deform_images_forback = propagate.deform_images_forback.__wrapped__

    n, t, h, w = 4, 32, 112, 112
    g = torch.Generator(device="cuda").manual_seed(6)
    motion = F.interpolate(0.05 * torch.randn((n * t, 4, 7, 7), device="cuda", generator=g),
                           size=(h, w), mode="bilinear", align_corners=False)
    motion = motion.reshape(n, t, 4, h, w).permute(0, 2, 1, 3, 4).contiguous()
    labels = (torch.rand((2, n, h, w), device="cuda", generator=g) > 0.5).float()
    ed, es = (torch.stack([1 - m, m], dim=1) for m in labels)
    images = torch.rand((n, 3, t, h, w), device="cuda", generator=g)
    calls = ((lambda: deform_forback(ed, es, motion, mode="bilinear"), 2 * (t - 1)),
             (lambda: deform_images_forback(images, motion), 1 + (t - 1)))
    for fn, launches in calls:
        before = _launched("warp_forward")
        got = fn()
        torch.cuda.synchronize()
        assert _launched("warp_forward") == before + launches
        with monkeypatch.context() as m:
            m.setattr(wk, "warp_forward", wk.reference_warp_forward)
            want = fn()
        for a, b in zip(got, want):
            assert a.shape == (t - 1, n, b.shape[2], h, w)
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_engine_dispatch_makes_no_host_sync(cuda):
    """`VideoSegmenter(devices=["cuda:0", "cuda:0"])`: two replicas on one
    card, each chunk split in two shards, each forwarded with K1. A video
    whose length the engine has seen is dispatched without waiting; its
    masks equal the unsharded engine's but for argmax near-ties of two
    batch sizes (1e-4 of the pixels), and K1 launches once a shard."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter, _unpackbits
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    sharded = VideoSegmenter(state, devices=["cuda:0", "cuda:0"], dtype=torch.float32,
                             forward_chunk=4)
    single = VideoSegmenter(state, dtype=torch.float32, forward_chunk=8)
    assert len(sharded._replicas) == 1
    video = make_beating_video(num_frames=80, seed=1).video.astype(np.uint8)
    want = single.segment_video(video, num_clips=3, step=1)
    sharded.segment_video(video, num_clips=3, step=1)
    before = _launched("decoder_heads")
    pending, (length, width) = _no_sync(lambda: sharded.segment_video_async(
        video, num_clips=3, step=1))
    got = _unpackbits(pending.numpy(), width)[:length]
    assert _launched("decoder_heads") - before == 2   # one chunk of 6 clips, two shards
    assert float((got != want).mean()) <= 1e-4


@pytest.mark.cuda
def test_one_rank_dp_step_makes_no_host_sync(cuda, tmp_path):
    """A data-parallel fused step (the gradient all-reduce, global
    BatchNorm, the coupled smoothness, the metrics' all-reduce) in a
    one-rank NCCL group: its loss equals the plain step's, and no call in
    its third step waits for the device."""
    import torch.distributed as dist

    from echoflow_torch.train.loop import (TrainConfig, create_train_state, data_parallel,
                                           make_train_step, prefetch_to_device)
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig(batch_size=2)
    batches = list(prefetch_to_device(synthetic_batches(2, 32, 112, 2, seed=0), "cuda"))
    step = make_train_step(fused_ota=True)
    _, plain = step(create_train_state(0, cfg, device="cuda"), batches[0])
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        state = data_parallel(create_train_state(0, cfg, device="cuda"))
        state, first = step(state, batches[0])
        state, _ = step(state, batches[1])
        state, metrics = _no_sync(lambda: step(state, batches[0]))
        assert np.isfinite(float(metrics["loss"])) and state.step == 3
        assert abs(float(first["loss"]) - float(plain["loss"])) <= 1e-5 * abs(float(plain["loss"]))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_camus_losses_on_the_card_match_the_plain_warp(cuda, monkeypatch):
    """`ota_loss` and `sgs_ots_loss` (2 x 1 x 10 x 64 x 64, 4 classes, a
    smooth motion of a few pixels) through K2-K4 against the same calls on
    the plain warp: values within 1e-5, the motion's gradient within 5e-3
    relative L2 (K3 sums in another order than the plain `index_add_`)."""
    import torch.nn.functional as F

    from echoflow_torch.ops import warp_kernel as wk
    from echoflow_torch.train.camus_losses import ota_loss, sgs_ots_loss

    n, t, h, w = 2, 10, 64, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    video = torch.rand((n, 1, t, h, w), device="cuda", generator=g)
    motion = F.interpolate(0.06 * torch.randn((n * t, 4, 5, 5), device="cuda", generator=g),
                           size=(h, w), mode="bilinear", align_corners=False)
    motion = motion.reshape(n, t, 4, h, w).transpose(1, 2).contiguous()
    softmax = torch.softmax(torch.randn((n, 4, t, h, w), device="cuda", generator=g), dim=1)
    lab = torch.randint(0, 4, (2, n, h, w), device="cuda", generator=g)

    def run(fn):
        m = motion.clone().requires_grad_()
        value = fn(m)
        value.backward()
        return float(value), m.grad

    for fn in (lambda m: ota_loss(video, m), lambda m: sum(sgs_ots_loss(lab[0], lab[1], m,
                                                                        softmax))):
        value, grad = run(fn)
        with monkeypatch.context() as mp:
            for name in ("warp_forward", "warp_image_grad", "warp_coord_grad"):
                mp.setattr(wk, name, getattr(wk, "reference_" + name))
            ref, ref_grad = run(fn)
        assert abs(value - ref) <= 1e-5 * abs(ref)
        assert float((grad - ref_grad).norm() / ref_grad.norm()) <= 5e-3


# ------------------------------------------------------------------ graphed steps
# `train/graph.graphed` at (2, 3, 8, 32, 32): a fused step launches K2, K3
# and K4 7, 6 and 14 times (T - 1, T - 2, 2 (T - 1)).

def _graph_setup(n_batches, batch_size=2, lr_drop_step=2, remat=False):
    from echoflow_torch.train.loop import TrainConfig, make_train_step, prefetch_to_device
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig(clip_length=8, image_size=(32, 32), batch_size=batch_size,
                      lr_drop_step=lr_drop_step)
    batches = list(prefetch_to_device(synthetic_batches(batch_size, 8, 32, n_batches, seed=0),
                                      "cuda"))
    return cfg, batches, lambda: make_train_step(fused_ota=True, remat=remat)


def _launches():
    return np.array([_launched("warp_forward"), _launched("warp_image_grad"),
                     _launched("warp_coord_grad")])


def _run_steps(cfg, batches, factory, graph):
    """Steps from the seed-0 state over `batches`, eager or graphed: the
    state, the step, and per step (loss, LR applied, launches)."""
    from echoflow_torch.train.graph import graphed
    from echoflow_torch.train.loop import create_train_state

    state = create_train_state(0, cfg, device="cuda")
    step = graphed(factory(), state) if graph else factory()
    out = []
    for batch in batches:
        before = _launches()
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(state.optimizer.param_groups[0]["lr"]),
                    tuple(_launches() - before)))
    return state, step, out


def _flat_state(state):
    """(parameters, running statistics) of the state's model, each one
    float64 vector."""
    model = state.model
    return (torch.cat([p.detach().reshape(-1).double() for p in model.parameters()]),
            torch.cat([v.reshape(-1).double() for k, v in model.state_dict().items()
                       if "running" in k]))


def _same_state_step(cfg, state, step, factory, batch):
    """The graphed `step` and the eager step on an eager twin of `state`
    (`chip_smoke.eager_twin`), from the same state and batch: phase 6's
    measures (`chip_smoke._compare_steps`) of the two."""
    from chip_smoke import _host_grads, _compare_steps, eager_twin

    twin = eager_twin(state, cfg)
    twin, m_twin = factory()(twin, batch)
    state, m = step(state, batch)
    return _compare_steps(float(m["loss"]), _host_grads(state.model), float(m_twin["loss"]),
                          _host_grads(twin.model))


def _phase6_bars(c):
    return c["loss_rel"] <= 1e-5 and c["grad_rel"] <= 5e-3 and c["leaf_rel"] <= 1e-2


@pytest.mark.cuda
def test_eager_train_runs_repeat_bitwise(cuda):
    """Two eager fp32 runs of 3 fused steps from the seed-0 state on the
    same batches, with the trainer's defaults: the same losses, parameters
    and running statistics, bit for bit, as echoflow's training repeats.
    K3 sums in a fixed order, and each convolution's backward takes a
    route that repeats (`ops/conv.ROUTES`)."""
    cfg, batches, factory = _graph_setup(3)
    runs = [_run_steps(cfg, batches, factory, graph=False) for _ in range(2)]
    (state_a, _, steps_a), (state_b, _, steps_b) = runs
    assert steps_a == steps_b
    for a, b in zip(_flat_state(state_a), _flat_state(state_b)):
        assert torch.equal(a, b)


# Every distinct convolution of the fp32 train steps at the shape the step
# runs it (`profile_torch.py --convs`): CLAS-FV at 4 x 3 x 32 x 112 x 112,
# then the CAMUS trainer's SegNet and shape autoencoder at 4 x 64 x 64.
# (input shape, weight shape, stride, padding, transposed)
TRAIN_CONVS = [
    ((4, 3, 32, 112, 112), (45, 3, 1, 7, 7), (1, 2, 2), (0, 3, 3), False),
    ((4, 45, 32, 56, 56), (64, 45, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 64, 32, 56, 56), (144, 64, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 144, 32, 56, 56), (64, 144, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 64, 32, 56, 56), (128, 64, 1, 1, 1), (2, 2, 2), (0, 0, 0), False),
    ((4, 64, 32, 56, 56), (230, 64, 1, 3, 3), (1, 2, 2), (0, 1, 1), False),
    ((4, 230, 32, 28, 28), (128, 230, 3, 1, 1), (2, 1, 1), (1, 0, 0), False),
    ((4, 128, 16, 28, 28), (230, 128, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 230, 16, 28, 28), (128, 230, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 128, 16, 28, 28), (288, 128, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 288, 16, 28, 28), (128, 288, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 128, 16, 28, 28), (256, 128, 1, 1, 1), (2, 2, 2), (0, 0, 0), False),
    ((4, 128, 16, 28, 28), (460, 128, 1, 3, 3), (1, 2, 2), (0, 1, 1), False),
    ((4, 460, 16, 14, 14), (256, 460, 3, 1, 1), (2, 1, 1), (1, 0, 0), False),
    ((4, 256, 8, 14, 14), (460, 256, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 460, 8, 14, 14), (256, 460, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 256, 8, 14, 14), (576, 256, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 576, 8, 14, 14), (256, 576, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 256, 8, 14, 14), (512, 256, 1, 1, 1), (2, 2, 2), (0, 0, 0), False),
    ((4, 256, 8, 14, 14), (921, 256, 1, 3, 3), (1, 2, 2), (0, 1, 1), False),
    ((4, 921, 8, 7, 7), (512, 921, 3, 1, 1), (2, 1, 1), (1, 0, 0), False),
    ((4, 512, 4, 7, 7), (921, 512, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 921, 4, 7, 7), (512, 921, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 512, 4, 7, 7), (1152, 512, 1, 3, 3), (1, 1, 1), (0, 1, 1), False),
    ((4, 1152, 4, 7, 7), (512, 1152, 3, 1, 1), (1, 1, 1), (1, 0, 0), False),
    ((4, 64, 32, 112, 112), (64, 64, 1, 1, 1), (1, 1, 1), (0, 0, 0), False),
    ((4, 64, 32, 112, 112), (2, 64, 1, 1, 1), (1, 1, 1), (0, 0, 0), False),
    ((4, 64, 32, 112, 112), (4, 64, 1, 1, 1), (1, 1, 1), (0, 0, 0), False),
    ((4, 1, 66, 66), (16, 1, 3, 3), (1, 1), (0, 0), False),
    ((4, 16, 65, 65), (32, 16, 3, 3), (2, 2), (0, 0), False),
    ((4, 32, 33, 33), (64, 32, 3, 3), (2, 2), (0, 0), False),
    ((4, 64, 16, 16), (64, 32, 3, 3), (2, 2), (0, 0), True),
    ((4, 64, 32, 32), (64, 16, 3, 3), (2, 2), (0, 0), True),
    ((4, 32, 64, 64), (4, 32, 1, 1), (1, 1), (0, 0), False),
    ((4, 4, 65, 65), (8, 4, 3, 3), (2, 2), (0, 0), False),
    ((4, 8, 33, 33), (16, 8, 3, 3), (2, 2), (0, 0), False),
    ((4, 16, 17, 17), (16, 16, 3, 3), (2, 2), (0, 0), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", TRAIN_CONVS,
                         ids=["x".join(map(str, g[0])) + "-w" + "x".join(map(str, g[1]))
                              + "-s" + "".join(map(str, g[2])) + ("-T" if g[4] else "")
                              for g in TRAIN_CONVS])
def test_repeatable_conv_matches_cudnn_default(cuda, geometry):
    """`ops/conv.convolution` (its class's routes, `ROUTES`) against
    autograd through the plain functional conv on cuDNN's default engines,
    fp32 with TF32 off as the trainer runs: the forward, dx, dW and db
    within the CPU test's fp32 bar (relative L2; 2e-7 to 8e-7 read on an
    H100), the forward bit for bit the plain one's where it is not
    transposed (a transposed conv's forward runs on cuDNN's deterministic
    engines), and each the same bits in two calls."""
    from echoflow_torch.ops import conv as C

    torch.backends.cudnn.allow_tf32 = False
    xs, ws, stride, padding, transposed = geometry
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(xs, device="cuda", generator=g).requires_grad_()
    w = (torch.randn(ws, device="cuda", generator=g) * 0.05).requires_grad_()
    b = torch.randn(ws[1] if transposed else ws[0], device="cuda", generator=g).requires_grad_()
    y = (C._CONV_T if transposed else C._CONV)[len(stride)](x, w, b, stride=stride,
                                                            padding=padding)
    dy = torch.randn(y.shape, device="cuda", generator=g)
    want = (y.detach(), *torch.autograd.grad(y, (x, w, b), dy))
    runs = []
    for _ in range(2):
        yr = C.convolution(x, w, b, stride, padding, transposed)
        runs.append((yr.detach(), *torch.autograd.grad(yr, (x, w, b), dy)))
    if not transposed:
        assert torch.equal(runs[0][0], y)
    for name, got, ref, again in zip(("y", "dx", "dW", "db"), runs[0], want, runs[1]):
        rel = float((got.double() - ref.double()).norm() / ref.double().norm())
        assert rel <= 1e-5, (name, rel)
        assert torch.equal(got, again), name


@pytest.mark.cuda
def test_pointwise_weight_grad_copies_no_operand(cuda):
    """The weight gradient of comb2 (64 -> 64, pointwise, over the decoder's
    4 x 64 x 32 x 112 x 112 output) on its class's route: after one call
    (which may make cuBLAS's workspace), a call raises the peak of
    allocated device memory by less than 64 MiB. A copy of either operand
    would take 392 MiB; the route holds 8 MiB of partial results."""
    from echoflow_torch.ops import conv as C

    xs, ws = (4, 64, 32, 112, 112), (64, 64, 1, 1, 1)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(xs, device="cuda", generator=g)
    w = torch.randn(ws, device="cuda", generator=g)
    dy = torch.randn(xs, device="cuda", generator=g)
    route = C.ROUTES[C.geometry_class(ws, (1, 1, 1), False)][1]
    assert route == "gemm"
    C._weight_grad(route, x, w, dy, (1, 1, 1), (0, 0, 0), False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dw = C._weight_grad(route, x, w, dy, (1, 1, 1), (0, 0, 0), False)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert dw.shape == ws
    assert grown < 64 * 2**20, grown / 2**20


def _replay_kernel_names(batches):
    """The kernel names of one profiled replay of the graphed fp32 step at
    full width (after its warm-up, and its capture with the first replay)."""
    from echoflow_torch.train.graph import graphed
    from echoflow_torch.train.loop import TrainConfig, create_train_state, make_train_step

    state = create_train_state(0, TrainConfig(), device="cuda")
    step = graphed(make_train_step(fused_ota=True), state)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    prof, _, _ = _traced(lambda: step(state, batches[2]))
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_graphed_fp32_step_takes_the_pointwise_weight_grads_off_cudnn(cuda, monkeypatch):
    """A profiled replay of the graphed fp32 step at full width (batch
    4 x 3 x 32 x 112 x 112), against one with the pointwise class's weight
    gradient on cuDNN's default: cuDNN's grouped direct weight-gradient
    kernel runs 3 times there (the stem and the two heads) and once here
    (the stem, class (1,7,7)/(1,2,2), which keeps cuDNN's default), and the
    replay runs 12 cuBLAS GEMMs more: one batched GEMM a sample for each of
    comb2 and the two heads."""
    import gc
    import re

    from echoflow_torch.ops import conv as C
    from echoflow_torch.train.loop import TrainConfig, prefetch_to_device
    from train_clasfv_torch import synthetic_batches

    cfg = TrainConfig()
    batches = list(prefetch_to_device(
        synthetic_batches(cfg.batch_size, cfg.clip_length, cfg.image_size[0], 3, seed=0),
        "cuda"))
    cublas = re.compile(r"(?i)(gemm|nvjet)")

    def counts(names):
        return (sum("wgrad2d_grouped_direct" in n for n in names),
                sum(bool(cublas.search(n)) and "implicit" not in n for n in names))

    routed = counts(_replay_kernel_names(batches))
    gc.collect()
    torch.cuda.empty_cache()
    monkeypatch.setitem(C.ROUTES, "(1,1,1)/(1,1,1)", ("cudnn", "cudnn"))
    default = counts(_replay_kernel_names(batches))
    assert default[0] == 3 and routed[0] == 1, (routed, default)
    assert routed[1] - default[1] == 3 * cfg.batch_size, (routed, default)


@pytest.mark.cuda
@pytest.mark.parametrize("acnn", [False, True], ids=["plain", "acnn"])
def test_camus_fp32_runs_repeat_bitwise(cuda, acnn):
    """Two default runs of the CAMUS trainer on the card (fp32, its step's
    graphs; 8 phantoms, two steps of 4), with and without the shape
    prior, whose frozen autoencoder passes the gradient to the SegNet: the
    same losses and the same model bits."""
    import train_camus_torch

    argv = ["--synthetic", "--epochs", "1", "--samples", "8", "--device", "cuda"]
    runs = [train_camus_torch.main(argv + (["--acnn"] if acnn else [])) for _ in range(2)]
    (model_a, _, losses_a), (model_b, _, losses_b) = runs
    assert losses_a == losses_b
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.cuda
def test_graphed_steps_follow_the_eager_steps(cuda):
    """Four steps from one state, five times eagerly and once graphed (the
    warm-up, the capture and its replay, two replays), the LR dropping at
    update 2, between replays: the warm-up's loss within 1e-5 of the eager
    one's; a replay within phase 6's bars of the eager step from the same
    state and batch; the LR each update applied is the schedule's; K2/K3/K4
    7/6/14 a step; after 4 steps the parameters' moves on average at most
    2x as far from the eager runs' as the eager runs are from each other,
    or 1e-6 of the move where those agree bitwise (as they do with every
    sum in a fixed order); the running statistics likewise, and
    `num_batches_tracked` equal. Five eager runs, because at this size the
    distance between two runs is a noisy measure of their spread. On an
    H100 a single pair read 1.28e-3 for the running statistics where the
    graphed run read 3.26e-3 from one eager run. Averaged over three eager
    runs, five repeats read graphed/eager 0.56-1.79; over five, eight
    repeats read 0.68-1.05."""
    cfg, batches, factory = _graph_setup(4)
    runs = [_run_steps(cfg, batches, factory, graph) for graph in (False,) * 5 + (True,)]
    schedule = [float(torch.tensor(x, dtype=torch.float32)) for x in (1e-4, 1e-4, 1e-5, 1e-5)]
    for _, _, steps in runs:
        assert [lr for _, lr, _ in steps] == schedule
        assert all(c == (7, 6, 14) for _, _, c in steps)
    assert abs(runs[5][2][0][0] - runs[0][2][0][0]) <= 1e-5 * abs(runs[0][2][0][0])
    origin = _flat_state(_run_steps(cfg, [], factory, False)[0])
    ends = [_flat_state(s) for s, _, _ in runs]
    for i, name in enumerate(("parameters", "running statistics")):
        *eager, graphed_ = (end[i] - origin[i] for end in ends)
        scale = eager[0].norm()

        def dist(a, b):
            return float((a - b).norm() / scale)
        spread = np.mean([dist(a, b) for j, a in enumerate(eager) for b in eager[j + 1:]])
        apart = np.mean([dist(graphed_, e) for e in eager])
        print(f"{name}: graphed {apart:.3e} from the eager runs, eager runs {spread:.3e} apart")
        assert apart <= max(2 * spread, 1e-6), (name, apart, spread)
    tracked = [{int(v) for k, v in s.model.state_dict().items() if "num_batches" in k}
               for s, _, _ in runs]
    assert tracked[0] == tracked[5] == {4}
    state, step, _ = runs[5]
    assert _phase6_bars(_same_state_step(cfg, state, step, factory, batches[0]))


@pytest.mark.cuda
def test_graphed_step_captures_again_for_a_new_batch_shape(cuda):
    """A batch of another size is a new signature: its own warm-up and
    capture, launches 7/6/14 a step; the first graph keeps replaying. A
    replay of each graph within phase 6's bars of the eager step from the
    same state and batch."""
    cfg, big, factory = _graph_setup(3, batch_size=2)
    _, small, _ = _graph_setup(3, batch_size=1)
    state, step, got = _run_steps(cfg, big + small + big[:1], factory, True)
    assert len(step.graphs) == 2 and state.step == 7
    assert all(c == (7, 6, 14) for _, _, c in got)
    for batch in (small[0], big[1]):
        assert _phase6_bars(_same_state_step(cfg, state, step, factory, batch))


@pytest.mark.cuda
def test_graphed_metrics_are_not_aliased_between_calls(cuda):
    """A call's metrics are its own: the next replay overwrites only the
    graph's static outputs. The graphed eval step agrees with the eager
    one within 1e-5."""
    from echoflow_torch.train.graph import graphed
    from echoflow_torch.train.loop import make_eval_step

    cfg, batches, factory = _graph_setup(4)
    state, step, _ = _run_steps(cfg, batches[:2], factory, True)
    _, m3 = step(state, batches[2])
    first = {k: float(v) for k, v in m3.items()}
    _, m4 = step(state, batches[3])
    assert {k: float(v) for k, v in m3.items()} == first
    assert first["loss"] != float(m4["loss"])
    eval_step = make_eval_step()
    want = {k: float(v) for k, v in eval_step(state, batches[0]).items()}
    g_eval = graphed(eval_step, state)
    assert g_eval.memory is step.memory
    for _ in range(3):
        got = {k: float(v) for k, v in g_eval(state, batches[0]).items()}
        assert all(abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-30) for k in want)


@pytest.mark.cuda
def test_graphed_step_refuses_after_a_restore(cuda, tmp_path):
    """`restore_train_state` gives Adam new state tensors: the graph
    captured before it raises instead of updating the old ones; a new
    wrapper trains on."""
    from echoflow_torch.train import checkpoint as ck
    from echoflow_torch.train.graph import graphed

    cfg, batches, factory = _graph_setup(4)
    state, step, _ = _run_steps(cfg, batches[:3], factory, True)
    ck.save_checkpoint(str(tmp_path / "ck.pth"), state)
    state, _ = ck.restore_train_state(str(tmp_path / "ck.pth"), state)
    with pytest.raises(RuntimeError, match="replaced"):
        step(state, batches[3])
    assert state.step == 3
    state, m = graphed(factory(), state)(state, batches[3])
    assert np.isfinite(float(m["loss"])) and state.step == 4


@pytest.mark.cuda
def test_graphed_remat_step_moves_the_running_statistics_once(cuda):
    """Remat's recompute runs under `frozen_running_stats`, a Python flag
    read while the backward is captured: after 3 replays
    `num_batches_tracked` is 4 (4 updates), and a replay moves the running
    statistics as the eager remat step does from the same state and batch
    (within 1e-6 of the move; a second move would double it)."""
    from chip_smoke import eager_twin

    cfg, batches, factory = _graph_setup(4, remat=True)
    state, step, _ = _run_steps(cfg, batches, factory, True)
    assert {int(v) for k, v in state.model.state_dict().items() if "num_batches" in k} == {4}
    twin = eager_twin(state, cfg)
    before = _flat_state(state)[1]
    twin, _ = factory()(twin, batches[0])
    state, _ = step(state, batches[0])
    move, want = _flat_state(state)[1] - before, _flat_state(twin)[1] - before
    assert float((move - want).norm()) <= 1e-6 * float(want.norm())
    assert {int(v) for k, v in state.model.state_dict().items() if "num_batches" in k} == {5}


@pytest.mark.cuda
def test_graphed_replay_makes_no_host_sync(cuda):
    """A replay (the batch copied into the graph's inputs, the LR written,
    the graph launched, the metrics copied) waits for nothing."""
    cfg, batches, factory = _graph_setup(3)
    state, step, _ = _run_steps(cfg, batches[:2], factory, True)
    state, metrics = _no_sync(lambda: step(state, batches[2]))
    assert np.isfinite(float(metrics["loss"])) and state.step == 3


@pytest.mark.cuda
def test_graphed_refuses_a_float_lr(cuda):
    """A float LR would be frozen into the graph at its capture value."""
    from echoflow_torch.train.graph import graphed
    from echoflow_torch.train.loop import TrainConfig, create_train_state, make_train_step

    state = create_train_state(0, TrainConfig(), device="cuda")
    state.optimizer.param_groups[0]["lr"] = 1e-4
    with pytest.raises(ValueError, match="LR"):
        graphed(make_train_step(), state)


# ------------------------------------------------------------------ graphed DP steps, rollouts, CAMUS

@pytest.mark.cuda
def test_graphed_data_parallel_steps_follow_the_eager_ones(cuda, tmp_path):
    """A data-parallel state in a one-rank NCCL group: `compiled_steps`
    graphs both steps; four train calls (the warm-up, the capture and its
    replay, two replays) launch K2/K3/K4 7/6/14 each and apply the
    schedule's LR; a replay is within phase 6's bars of the eager
    data-parallel step on a twin from the same state and batch and waits
    for nothing; the graphed eval step is within 1e-5 of the eager one."""
    import torch.distributed as dist

    from chip_smoke import _compare_steps, _host_grads, dp_eager_twin
    from echoflow_torch.parallel.mesh import init_distributed
    from echoflow_torch.train.graph import GraphedStep
    from echoflow_torch.train.loop import (compiled_steps, create_train_state, data_parallel,
                                           make_eval_step)

    cfg, batches, factory = _graph_setup(5)
    init_distributed(f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        state = data_parallel(create_train_state(0, cfg, device="cuda"))
        step, eval_step = compiled_steps(state)
        assert isinstance(step, GraphedStep) and isinstance(eval_step, GraphedStep)
        schedule = [float(torch.tensor(x, dtype=torch.float32)) for x in (1e-4, 1e-4, 1e-5, 1e-5)]
        for batch, lr in zip(batches[:4], schedule):
            before = _launches()
            state, m = step(state, batch)
            assert tuple(_launches() - before) == (7, 6, 14) and np.isfinite(float(m["loss"]))
            assert float(state.optimizer.param_groups[0]["lr"]) == lr
        twin, m_twin = factory()(dp_eager_twin(state, cfg), batches[4])
        want = (float(m_twin["loss"]), _host_grads(twin.model))
        del twin
        state, m = _no_sync(lambda: step(state, batches[4]))
        assert _phase6_bars(_compare_steps(float(m["loss"]), _host_grads(state.model), *want))
        assert state.step == 5 and len(step.graphs) == 1
        ref = {k: float(v) for k, v in make_eval_step()(state, batches[0]).items()}
        for _ in range(3):
            got = {k: float(v) for k, v in eval_step(state, batches[0]).items()}
            assert all(abs(got[k] - ref[k]) <= 1e-5 * max(abs(ref[k]), 1e-30) for k in ref)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_graphed_rollouts_are_bitwise_the_eager_ones(cuda):
    """Each rollout of `infer/propagate.py` on the card, 4 clips x 32 frames
    x 112 x 112, three calls (the warm-up, the capture and its replay, a
    replay): every result bitwise the eager rollout's, K2 advanced by the
    rollout's launches at every call, one graph a signature (each wrapper
    cleared first, so the graphs counted are those of these calls), and a
    result that a later replay leaves alone."""
    import torch.nn.functional as F

    from echoflow_torch.infer import propagate
    from echoflow_torch.ops import warp_kernel as wk

    n, t, h, w = 4, 32, 112, 112
    g = torch.Generator(device="cuda").manual_seed(7)
    motion = F.interpolate(0.05 * torch.randn((n * t, 4, 7, 7), device="cuda", generator=g),
                           size=(h, w), mode="bilinear", align_corners=False)
    motion = motion.reshape(n, t, 4, h, w).permute(0, 2, 1, 3, 4).contiguous()
    labels = (torch.rand((2, n, h, w), device="cuda", generator=g) > 0.5).float()
    ed, es = (torch.stack([1 - m, m], dim=1) for m in labels)
    images = torch.rand((n, 3, t, h, w), device="cuda", generator=g)

    def call(i, scale):
        m = motion * scale
        return ((propagate.deform_forback, (ed, es, m), {"mode": "bilinear"}, 2 * (t - 1)),
                (propagate.deform_forback, (ed, es, m), {}, 0),
                (propagate.deform_images_forback, (images, m), {}, 1 + (t - 1)),
                (propagate.apply_sequence_deformation, (ed, m, 3, 20), {}, 17))[i]

    def tensors(out):
        return [out] if torch.is_tensor(out) else list(out)

    wrappers = (propagate.deform_forback, propagate.deform_images_forback,
                propagate.apply_sequence_deformation)
    for fn in wrappers:
        fn.clear()
    for i in range(4):
        results = []
        for scale in (1.0, 1.0, 0.5):
            fn, args, kw, launches = call(i, scale)
            before = _launched("warp_forward")
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            assert _launched("warp_forward") == before + launches
            results.append((got, fn.__wrapped__(*args, **kw)))
        for got, want in results:   # each still its own after the later replays
            assert all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(want)))
    assert [len(fn.graphs) for fn in wrappers] == [2, 1, 1]
    for fn in wrappers:
        fn.clear()


@pytest.mark.cuda
def test_graphed_camus_trainer_follows_the_eager_one(cuda, monkeypatch):
    """`train_camus_torch.main --synthetic --epochs 2` on the card through
    its graphs (the step's "fold" and "fold + update" graphs, made once a
    run, and the validation forward's) against the same run with the
    wrappers swapped for the functions they wrap: losses within 1e-3
    relative (phase 10's bar)."""
    import train_camus_torch
    from echoflow_torch.train import generic

    argv = ["--synthetic", "--epochs", "2", "--device", "cuda"]
    real = generic.GraphedFunction
    made = []

    def recording(fn, **kw):
        made.append(real(fn, **kw))
        return made[-1]

    monkeypatch.setattr(generic, "GraphedFunction", recording)
    _, _, losses = train_camus_torch.main(argv)
    monkeypatch.setattr(generic, "GraphedFunction", lambda fn, **kw: fn)
    _, _, eager = train_camus_torch.main(argv)
    assert max(abs(a - b) / abs(b) for a, b in zip(losses, eager)) <= 1e-3
    step, validation = made
    assert len(step.graphs) == 2 and len(validation.graphs) == 1


# ---------------------------------------------------------------------- spans

def _traced(fn, sessions=6):
    """(profiler, the program's spans, fn()) of a torch.profiler session
    (host and card) that recorded a device event; a session that recorded
    none (the card's sandbox does that at times) is run again, as
    portbench/trace.py does."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from echoflow_torch.utils.profiling import spans

    for attempt in range(sessions):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
            return prof, spans(), out
    raise RuntimeError(f"torch.profiler recorded no device event in {sessions} sessions")


def _trace_start_ns(prof) -> int:
    result = prof.profiler.kineto_results
    if hasattr(result, "trace_start_ns"):
        return int(result.trace_start_ns())
    return int(result.trace_start_us()) * 1000


def _stamp_records_ns(prof) -> list:
    """Start times (ns since the epoch) of the profiled stamp kernels."""
    start = _trace_start_ns(prof)
    return sorted(start + e.time_range.start * 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name.startswith("span_stamp_kernel"))


def _graphed_work():
    """A function graph with a device span inside, warmed up and captured."""
    from echoflow_torch.utils.graphs import GraphedFunction
    from echoflow_torch.utils.profiling import span

    def work(x):
        with span("t.work", device=x.device):
            return torch.tanh(x @ x) * 2.0

    g = GraphedFunction(work)
    x = torch.randn(512, 512, device="cuda")
    g(x)
    g(x)
    torch.cuda.synchronize()
    return g, x


@pytest.mark.cuda
def test_span_stamps_give_each_replay_its_own_slots_and_id(cuda):
    """The engine's graph at queue depth 3, traced: 6 replays give 6 x 14
    stamps (a video of one forward chunk: shift, backbone, projections,
    decoder_tail, reinterp, reinterp, fusion), each replay in ring slots
    of its own under its video's number, its spans in the order the graph
    runs them and apart from the other replays'; no stamp dropped; the
    masks are the untraced replays'."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=1).state_dict()
    videos = [make_beating_video(num_frames=100, period=40.0, seed=i).video.astype(np.uint8)
              for i in range(6)]
    engine = VideoSegmenter(state, dtype=torch.float32)
    want = list(engine.segment_videos(videos, num_clips=5, step=1))    # warm-up, capture
    first = next(engine._seqs)
    prof, snap, got = _traced(lambda: list(engine.segment_videos(videos, num_clips=5, step=1,
                                                                   queue_depth=3)))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    ids = sorted({s["id"] for s in snap["device"]})
    assert len(ids) == 6 and ids[0] > first and snap["dropped"] == 0
    assert len(snap["device"]) == 6 * 7 and len(_stamp_records_ns(prof)) == 6 * 14
    order = ["shift", "backbone", "projections", "decoder_tail", "reinterp", "reinterp", "fusion"]
    bounds = []
    for i in ids:
        mine = sorted((s for s in snap["device"] if s["id"] == i), key=lambda s: s["start_ns"])
        assert [s["name"] for s in mine] == order
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(mine, mine[1:]))
        bounds.append((mine[0]["start_ns"], mine[-1]["end_ns"]))
    assert all(a[1] <= b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.cuda
def test_span_times_agree_with_the_profilers_clock(cuda):
    """Device spans (the ring's times on the host clock) against their
    stamp kernels' records in the profiler's trace, and host spans
    against their `record_function` ranges: each within 20 us. Each
    replay's device span carries the id of the span it was called in.
    The session's first call is left out of the host comparison: the
    first range of a name in a session pays the profiler's own set-up
    between its timestamp and the block (up to 21.5 us seen)."""
    from echoflow_torch.utils.profiling import span

    g, x = _graphed_work()

    def calls():
        for i in range(6):
            with span("t.call", id=i):
                g(x)

    prof, snap, _ = _traced(calls)
    device = sorted(t for s in snap["device"] for t in (s["start_ns"], s["end_ns"]))
    records = _stamp_records_ns(prof)
    assert len(device) == len(records) == 12
    gaps = [round((a - b) / 1e3, 2) for a, b in zip(device, records)]
    print(f"device stamps less their kernel records, us: {gaps}")
    assert max(abs(g) for g in gaps) <= 20.0
    assert sorted(s["id"] for s in snap["device"]) == [0, 1, 2, 3, 4, 5]
    start = _trace_start_ns(prof)
    for name in ("t.call", "graph.feed", "graph.replay", "graph.outputs"):
        ranges = sorted((start + e.time_range.start * 1e3, start + e.time_range.end * 1e3)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.name == "echoflow_torch." + name)
        hosts = sorted((r["start_ns"], r["end_ns"]) for r in snap["host"] if r["name"] == name)
        assert len(ranges) == len(hosts) == 6, name
        gaps = [(round((a0 - b0) / 1e3, 2), round((a1 - b1) / 1e3, 2))
                for (a0, a1), (b0, b1) in zip(hosts, ranges)]
        print(f"{name}: host spans less their ranges (start, end), us: {gaps}")
        assert max(abs(g) for pair in gaps[1:] for g in pair) <= 20.0, (name, gaps)


@pytest.mark.cuda
def test_span_flag_off_writes_nothing(cuda):
    """After a traced session, replays and eager device spans outside any
    session take no ring slot: the flag is off on the card (the stamps
    still run, captured in the graph)."""
    from echoflow_torch.utils import profiling

    g, x = _graphed_work()
    _traced(lambda: g(x))
    for _ in range(3):
        out = g(x)
        with profiling.span("t.eager", device=x.device):
            torch.tanh(x)
    torch.cuda.synchronize()
    ring = profiling._TRACER.rings[x.device.index]
    assert ring.state.tolist() == [0, 2]
    torch.testing.assert_close(out, torch.tanh(x @ x) * 2.0)


# ir-CSN-152's new geometry classes at the fp32 CSN step's shapes (batch 4 x
# 3 x 32 x 112 x 112): the stem, and a depthwise 3x3x3 conv of each stage,
# stride 1 and the stage's first (stride 2). (input, weight, stride, groups)
CSN_CONVS = [
    ((4, 3, 32, 112, 112), (64, 3, 3, 7, 7), (1, 2, 2), 1),
    ((4, 64, 32, 28, 28), (64, 1, 3, 3, 3), (1, 1, 1), 64),
    ((4, 128, 32, 28, 28), (128, 1, 3, 3, 3), (2, 2, 2), 128),
    ((4, 128, 16, 14, 14), (128, 1, 3, 3, 3), (1, 1, 1), 128),
    ((4, 256, 16, 14, 14), (256, 1, 3, 3, 3), (2, 2, 2), 256),
    ((4, 256, 8, 7, 7), (256, 1, 3, 3, 3), (1, 1, 1), 256),
    ((4, 512, 8, 7, 7), (512, 1, 3, 3, 3), (2, 2, 2), 512),
    ((4, 512, 4, 4, 4), (512, 1, 3, 3, 3), (1, 1, 1), 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", CSN_CONVS,
                         ids=["x".join(map(str, g[0])) + "-w" + "x".join(map(str, g[1]))
                              + "-s" + "".join(map(str, g[2])) for g in CSN_CONVS])
def test_csn_conv_classes_repeat_bitwise(cuda, geometry):
    """Each of ir-CSN-152's new classes through `ops/conv.convolution` (its
    `ROUTES`), fp32 with TF32 off: dx (the stem's is not wanted, as in the
    step) and dW the same bits in three calls, and within the CPU test's
    fp32 bar of autograd through the plain conv."""
    from echoflow_torch.ops import conv as C

    torch.backends.cudnn.allow_tf32 = False
    xs, ws, stride, groups = geometry
    padding = (1, 3, 3) if ws[2:] == (3, 7, 7) else (1, 1, 1)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(xs, device="cuda", generator=g).requires_grad_(groups > 1)
    w = (torch.randn(ws, device="cuda", generator=g) * 0.05).requires_grad_()
    y = torch.nn.functional.conv3d(x, w, None, stride, padding, 1, groups)
    dy = torch.randn(y.shape, device="cuda", generator=g)
    wanted = (x, w) if groups > 1 else (w,)
    want = torch.autograd.grad(y, wanted, dy)
    runs = []
    for _ in range(3):
        yr = C.convolution(x, w, None, stride, padding, groups=groups)
        assert torch.equal(yr, y)
        runs.append(torch.autograd.grad(yr, wanted, dy))
    for i, ref in enumerate(want):
        rel = float((runs[0][i].double() - ref.double()).norm() / ref.double().norm())
        assert rel <= 1e-5, (i, rel)
        assert all(torch.equal(r[i], runs[0][i]) for r in runs[1:]), i


@pytest.mark.cuda
def test_csn_stem_pool_backward_repeats_bitwise(cuda):
    """The stem's max pool ((1,3,3)/(1,2,2), overlapping windows) on the
    stem's output at the step's shape: `ops/pool.max_pool3d`'s backward the
    same bits in three calls, equal to torch's within fp32 rounding (its
    atomic adds of up to four outputs into one input)."""
    from echoflow_torch.ops.pool import max_pool3d

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.relu(torch.randn((4, 64, 32, 56, 56), device="cuda", generator=g)).requires_grad_()
    y = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    want = torch.nn.functional.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    assert torch.equal(y, want)
    dy = torch.randn(y.shape, device="cuda", generator=g)
    grads = [torch.autograd.grad(max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1)), x, dy)[0]
             for _ in range(3)]
    assert all(torch.equal(a, grads[0]) for a in grads[1:])
    torch.testing.assert_close(grads[0], torch.autograd.grad(want, x, dy)[0], rtol=1e-6,
                               atol=1e-6)


CSN_CHILD = """
import hashlib, sys
import torch
from echoflow_torch.train.loop import TrainConfig, compiled_steps, create_train_state, prefetch_to_device
from train_clasfv_torch import synthetic_batches
state = create_train_state(0, TrainConfig(backbone="ir_csn_152"), device="cuda")
step = compiled_steps(state)[0]
for batch in prefetch_to_device(synthetic_batches(4, 32, 112, 3, seed=0), "cuda"):
    state, _ = step(state, batch)
h = hashlib.sha256()
for v in state.model.state_dict().values():
    h.update(v.detach().cpu().contiguous().numpy().tobytes())
print(h.hexdigest())
"""


@pytest.mark.cuda
def test_csn_graphed_steps_repeat_bitwise_in_a_fresh_process(cuda):
    """Three graphed fp32 steps of CLAS-FV over ir-CSN-152 at full width
    (`create_train_state(backbone="ir_csn_152")`, `compiled_steps`, batch
    4 x 3 x 32 x 112 x 112) in two fresh processes: the same SHA-256 of
    the model's parameters and buffers."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shas = [subprocess.run([sys.executable, "-c", CSN_CHILD], cwd=root, capture_output=True,
                           text=True, timeout=900) for _ in range(2)]
    for out in shas:
        assert out.returncode == 0, out.stderr[-3000:]
    assert shas[0].stdout.split()[-1] == shas[1].stdout.split()[-1]


@pytest.mark.cuda
def test_csn_folded_engine_segments_as_the_unfolded_model(cuda):
    """`VideoSegmenter` over an ir-CSN-152 state dict on the card in fp32: the
    folded graphed engine (`fold_bn=True`, K1) gives the masks of the
    unfolded network's forward (`fold_bn=False, decoder="model"`) on a
    synthetic echo, both classes present, but for pixels whose two logits
    lie within fp32 rounding (at most 1e-4 of them)."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    state = create_model(seed=4, backbone="ir_csn_152").state_dict()
    state["segmentation_head.weight"] = state["segmentation_head.weight"] * 300.0
    video = make_beating_video(num_frames=64, period=30.0, seed=1).video.astype(np.uint8)
    masks = [VideoSegmenter(state, device="cuda", dtype=torch.float32, fold_bn=fold,
                            decoder="kernel" if fold else "model")
             .segment_video(video, num_clips=1) for fold in (True, False)]
    assert masks[0].shape == (64, 112, 112) and 0 < masks[0].mean() < 1
    assert np.mean(masks[0] != masks[1]) <= 1e-4


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
def test_bf16_engine_backbone_runs_on_bf16_tensor_cores(cuda):
    """The bf16 engine's folded backbone (`VideoSegmenter(dtype=bfloat16)`,
    `fold_bn.fit_tensor_cores`: 7 pairs padded and counted, 17 temporal
    convs as 2D) on one engine chunk (30 x 3 x 32 x 112 x 112, seeded
    weights). Its five taps are as close to the fp32 folded backbone's
    (TF32 off) as the unfitted bf16 backbone's are, within 1.25x by
    relative L2, and within 2x that distance of the unfitted bf16 taps:
    two bf16 paths that round in another order each lie about that far
    from fp32, so about sqrt(2) times it from each other. A profiled
    forward launches a bf16 tensor-core conv, no kernel of cuDNN's fp32
    fallback (`f32f32` in its name) and no `convertTensor` cast; the
    unfitted backbone's forward launches both (a conv of 144 channels,
    already a multiple of 8, at 32 x 56 x 56: the widths alone do not
    cause it). The fitted backbone's weights and five taps are
    channels-last-3d, and its forward on its input as the engine lays it
    out (`fast_forward.backbone_input`) launches no NCHW<->NHWC transpose
    of cuDNN (`nchwToNhwc`, `nhwcToNchw`); the unfitted one transposes
    around every conv. `ClipForward` in bf16 is fitted the same way."""
    from echoflow_torch.infer.clips import ClipForward
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.fast_forward import backbone_input
    from echoflow_torch.models.fold_bn import fold_state_dict
    from echoflow_torch.models.r2plus1d import (R2Plus1DMotionSegNet, TemporalConv3d,
                                                create_model)
    from echoflow_torch.utils.profiling import counters

    def channels_last(backbone):
        return all(m.weight.is_contiguous(memory_format=torch.channels_last_3d)
                   for m in backbone.modules() if isinstance(m, torch.nn.Conv3d))

    torch.backends.cudnn.allow_tf32 = False
    state = create_model(seed=3).state_dict()
    before = counters().get("engine.padded_widths", 0)
    fitted = VideoSegmenter(state, dtype=torch.bfloat16)._model.backbone
    assert counters().get("engine.padded_widths", 0) - before == 7
    assert sum(isinstance(m, TemporalConv3d) for m in fitted.modules()) == 17
    assert channels_last(fitted)
    clips = ClipForward(state, dtype=torch.bfloat16)
    assert counters().get("engine.padded_widths", 0) - before == 14
    assert sum(isinstance(m, TemporalConv3d) for m in clips._model.modules()) == 17
    assert channels_last(clips._model.backbone)
    folded = R2Plus1DMotionSegNet(folded=True)
    folded.load_state_dict(fold_state_dict(state))
    unfitted = folded.backbone.eval().requires_grad_(False).cuda()
    video = torch.rand((30, 3, 32, 112, 112), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        want = [t.float() for t in unfitted(video)]      # fp32
        unfitted.to(torch.bfloat16)
        plain = [t.float() for t in unfitted(video.bfloat16())]
        taps = fitted(backbone_input(fitted, video))
        assert all(t.is_contiguous(memory_format=torch.channels_last_3d) for t in taps)
        got = [t.float() for t in taps]
        del taps
    for i, (g, p, w) in enumerate(zip(got, plain, want)):
        e_plain, e_fit, apart = _rel_l2(p, w), _rel_l2(g, w), _rel_l2(g, p)
        print(f"tap {i}: plain bf16 {e_plain:.3e}, fitted {e_fit:.3e} from fp32; "
              f"{apart:.3e} apart")
        assert 0 < e_plain < 0.05 and e_fit <= 1.25 * e_plain and apart <= 2 * e_plain, i

    def kernels(backbone):
        x = backbone_input(backbone, video)
        with torch.no_grad():
            backbone(x)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as p:
                backbone(x)
                torch.cuda.synchronize()
        return {e.name for e in p.events() if e.device_type != torch.autograd.DeviceType.CPU}

    def transposes(names):
        return [k for k in names if "nchwToNhwc" in k or "nhwcToNchw" in k]

    names = kernels(fitted)
    assert any("bf16bf16" in k for k in names), sorted(names)
    assert not [k for k in names if "f32f32" in k or "convertTensor" in k]
    assert not transposes(names), sorted(names)
    names = kernels(unfitted)
    assert any("f32f32" in k for k in names) and any("convertTensor" in k for k in names)
    assert transposes(names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,channels_last", [(torch.bfloat16, True), (torch.float32, False)],
                         ids=["bf16", "fp32"])
def test_channels_last_counter_grows_once_a_bf16_forward_chunk(cuda, dtype, channels_last):
    """`backbone.channels_last` (`fast_forward.folded_forward`) over a
    graphed `VideoSegmenter` on two 176-frame videos, 5 shifts: in bf16 it
    grows by the forward chunks, which K1's launches count (one a chunk),
    captured counts replayed with their graph; in fp32, whose backbone
    stays NCDHW, by 0."""
    from echoflow_torch.data.synthetic import make_beating_video
    from echoflow_torch.infer.pipeline import VideoSegmenter
    from echoflow_torch.models.r2plus1d import create_model

    engine = VideoSegmenter(create_model(seed=1).state_dict(), dtype=dtype)
    videos = [make_beating_video(num_frames=176, period=40.0, seed=i).video.astype(np.uint8)
              for i in range(2)]
    before, k1 = counters().get("backbone.channels_last", 0), _launched("decoder_heads")
    for _ in range(2):   # the capture, then a replay
        list(engine.segment_videos(videos, num_clips=5, step=1))
    chunks = _launched("decoder_heads") - k1
    assert chunks >= 4
    assert counters().get("backbone.channels_last", 0) - before == (chunks if channels_last
                                                                    else 0)
