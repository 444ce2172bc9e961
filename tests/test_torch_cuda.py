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


@pytest.mark.cuda
@pytest.mark.parametrize("with_motion", [True, False])
@pytest.mark.parametrize("sizes", [(56, 28, 14, 7), (56, 7), (28,)])
def test_decoder_heads_kernel_matches_plain(cuda, sizes, with_motion):
    """The main path's source sizes with 2 clips (30 in the engine), and
    fewer sources, with and without the motion head."""
    g = torch.Generator(device="cuda").manual_seed(0)
    projs = [torch.randn(2, 32, s, s, 64, device="cuda", generator=g) * 0.2 for s in sizes]
    w = {k: torch.randn(*s, device="cuda", generator=g) * 0.3 for k, s in SHAPES.items()}
    before = decoder_heads.launches
    seg, mot = decoder_heads(projs, **w, out_hw=(112, 112), with_motion=with_motion)
    torch.cuda.synchronize()
    assert decoder_heads.launches == before + 1
    rseg, rmot = reference_decoder_heads(projs, **w, out_hw=(112, 112),
                                         with_motion=with_motion)
    # fp32 on both sides; only the summation order differs.
    torch.testing.assert_close(seg, rseg, rtol=1e-4, atol=1e-4)
    if with_motion:
        torch.testing.assert_close(mot, rmot, rtol=1e-4, atol=1e-4)
    else:
        assert mot is None


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


WARP_SHAPES = [(3, 5, 15, 17), (2, 1, 1, 9), (1, 2, 31, 1), (8, 4, 112, 112),
               (8, 3, 112, 112), (124, 3, 112, 112)]


def _warp_inputs(shape, seed=0):
    """Image, output gradient and coordinates on the card; offsets reach
    far past the border, and some coordinates sit exactly on the last
    row and column."""
    n, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.rand(shape, device="cuda", generator=g)
    grad = torch.randn(shape, device="cuda", generator=g)
    px = (torch.rand((n, h, w), device="cuda", generator=g) * 1.4 - 0.2) * w - 0.5
    py = (torch.rand((n, h, w), device="cuda", generator=g) * 1.4 - 0.2) * h - 0.5
    px[:, ::3, ::4] = w - 1.0
    py[:, ::4, ::3] = h - 1.0
    return image, grad, px, py


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_warp_kernels_match_plain(cuda, shape):
    """K2 and K4 repeat the plain versions' elementwise arithmetic in the
    same order, so they are bitwise equal. K3 adds with fp32 atomics, in
    an order that changes from run to run: it stays within the per-element
    bound of `image_grad_tolerance`, of the plain version and of itself."""
    from echoflow_torch.ops import warp_kernel as wk

    image, grad, px, py = _warp_inputs(shape)
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
        if dev == "cuda":
            assert wk.warp_forward.launches == before + 2 * (t - 1)
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
