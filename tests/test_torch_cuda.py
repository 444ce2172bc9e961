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

SHAPES = dict(b1=(64,), w2=(64, 64), b2=(64,), ws=(64, 2), bs=(2,), wm=(64, 4), bm=(4,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _k1_inputs(sizes, bt=(2, 32), scale=1.0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    projs = [torch.randn(*bt, s, s, 64, device="cuda", generator=g) * (0.2 * scale)
             for s in sizes]
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in SHAPES.items()}
    return projs, w


def _check_k1(projs, w, out_hw, with_motion=True, align_corners=True):
    before = decoder_heads.launches
    seg, mot = decoder_heads(projs, **w, out_hw=out_hw, with_motion=with_motion,
                             align_corners=align_corners)
    torch.cuda.synchronize()
    assert decoder_heads.launches == before + 1
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
@pytest.mark.parametrize("sizes", [(56, 28, 14, 7), (56, 7), (28,)])
def test_decoder_heads_kernel_matches_plain(cuda, sizes, with_motion, align_corners):
    """The main path's source sizes with 2 clips (30 in the engine), and
    fewer sources, with and without the motion head, both corner modes."""
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
    p = [torch.zeros(1, 2, s, s, 64, device="cuda") for s in (56, 28, 14, 7, 4)]
    w = {k: torch.zeros(*s, device="cuda") for k, s in SHAPES.items()}
    before = decoder_heads.launches
    with pytest.raises(ValueError, match="1..4 sources"):
        decoder_heads(p, **w, out_hw=(112, 112))
    assert decoder_heads.launches == before


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
    before = decoder_heads.launches
    for method in ("majority", "simple", "softmax"):
        a = gpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        b = cpu.segment_video(video, num_clips=2, step=1, fuse_method=method)
        # argmax near-ties between two fp32 backends may flip a pixel.
        assert (a != b).mean() <= 1e-3
    assert decoder_heads.launches > before


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
    same order, so they are bitwise equal. K3 adds with fp32 atomics, in
    an order that changes from run to run: it stays within the per-element
    bound of `image_grad_tolerance`, of the plain version and of itself."""
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs(shape, motion=motion)
    before = (wk.warp_forward.launches, wk.warp_image_grad.launches,
              wk.warp_coord_grad.launches)
    out = wk.warp_forward(image, px, py)
    d_img = wk.warp_image_grad(grad, px, py)
    d_img2 = wk.warp_image_grad(grad, px, py)
    d_px, d_py = wk.warp_coord_grad(image, grad, px, py)
    torch.cuda.synchronize()
    assert (wk.warp_forward.launches, wk.warp_image_grad.launches,
            wk.warp_coord_grad.launches) == (before[0] + 1, before[1] + 2, before[2] + 1)
    assert torch.equal(out, wk.reference_warp_forward(image, px, py))
    r_px, r_py = wk.reference_warp_coord_grad(image, grad, px, py)
    assert torch.equal(d_px, r_px) and torch.equal(d_py, r_py)
    tol = wk.image_grad_tolerance(grad, px, py)
    assert bool(((d_img - wk.reference_warp_image_grad(grad, px, py)).abs() <= tol).all())
    assert bool(((d_img - d_img2).abs() <= tol).all())


@pytest.mark.cuda
def test_warp_autograd_launches_each_kernel_only_when_needed(cuda):
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs((2, 3, 16, 16))
    px.requires_grad_()
    py.requires_grad_()
    before = wk.warp_image_grad.launches, wk.warp_coord_grad.launches
    (wk.warp_coords(image, px, py) * grad).sum().backward()   # image needs no grad
    assert (wk.warp_image_grad.launches, wk.warp_coord_grad.launches) == \
        (before[0], before[1] + 1)
    image.requires_grad_()
    (wk.warp_coords(image, px, py) * grad).sum().backward()
    assert (wk.warp_image_grad.launches, wk.warp_coord_grad.launches) == \
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
    before = wk.warp_forward.launches
    out_a, out_b = wk.warp_forward_pair(image_a, image_b, px, py)
    torch.cuda.synchronize()
    assert wk.warp_forward.launches == before + 1
    assert torch.equal(out_a, wk.reference_warp_forward(image_a, px, py))
    assert torch.equal(out_b, wk.reference_warp_forward(image_b, px, py))


@pytest.mark.cuda
def test_warp_forward_pair_rejects_what_it_cannot_take(cuda):
    from echoflow_torch.ops import warp_kernel as wk

    image, _, px, py = _warp_inputs((2, 4, 8, 8))
    video = torch.rand(2, 3, 8, 8, device="cuda")
    before = wk.warp_forward.launches
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
    assert wk.warp_forward.launches == before


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
        before = (wk.warp_forward.launches, wk.warp_image_grad.launches,
                  wk.warp_coord_grad.launches)
        if pair:
            out_a, out_b = wk.warp_coords_pair(lab, video, x, y)
        else:
            out_a, out_b = wk.warp_coords(lab, x, y), wk.warp_coords(video, x, y)
        ((out_a * grad).sum() + (out_b * g_b).sum()).backward()
        torch.cuda.synchronize()
        counts = tuple(b - a for a, b in zip(before, (
            wk.warp_forward.launches, wk.warp_image_grad.launches, wk.warp_coord_grad.launches)))
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
    CPU's conv algorithms and K3's atomics differ; dropping K3 from the
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
        before = wk.warp_forward.launches
        state, m = make_train_step()(state, {k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":   # one pair launch per chain step
            assert wk.warp_forward.launches == before + (t - 1)
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
