"""The port's bilinear warp (echoflow_torch.ops.warp, ops.warp_kernel) on
the CPU against three oracles: echoflow's gather formulation, echoflow's
Pallas VJP in interpret mode (the kernels K2-K4 that ran on the TPU), and
torch's own `F.grid_sample` autograd. On the CPU the wrappers compute the
plain versions, so these tests hold the kernels' oracles; the kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from echoflow.ops import warp as jwarp
from echoflow.ops.pallas import warp_kernel as jkernel
from echoflow_torch.ops import warp as twarp
from echoflow_torch.ops import warp_kernel as tkernel


@pytest.fixture
def gather_backend():
    jwarp.set_warp_backend("gather")
    yield
    jwarp.set_warp_backend("auto")


@pytest.fixture
def interpret():
    jkernel.set_interpret_mode(True)
    yield
    jkernel.set_interpret_mode(False)


def _inputs(shape, scale, seed=0):
    n, c, h, w = shape
    rng = np.random.RandomState(seed)
    image = rng.rand(n, c, h, w).astype(np.float32)
    offsets = (scale * rng.randn(n, 2, h, w)).astype(np.float32)
    return image, offsets


def _coords(offsets):
    return twarp.offset_coords(torch.from_numpy(offsets))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape,scale", [((2, 3, 15, 17), 0.3), ((2, 4, 16, 16), 0.1),
                                         ((1, 2, 7, 5), 3.0)])
def test_forward_equals_echoflow_gather(gather_backend, shape, scale, mode):
    """Bit for bit: the same coordinates (float64 linspace cast to float32)
    and the same blend order. Scale 3.0 pushes most samples far past the
    border."""
    image, offsets = _inputs(shape, scale)
    want = np.asarray(jwarp.warp_image_with_offsets(jnp.asarray(image), jnp.asarray(offsets),
                                                    mode=mode))
    got = twarp.warp_image_with_offsets(torch.from_numpy(image), torch.from_numpy(offsets),
                                        mode=mode).numpy()
    np.testing.assert_array_equal(got, want)
    gx, gy = twarp.offset_grids(torch.from_numpy(offsets))
    fn = {"bilinear": "warp_bilinear_border", "nearest": "warp_nearest_border"}[mode]
    np.testing.assert_array_equal(
        getattr(twarp, fn)(torch.from_numpy(image), gx, gy).numpy(),
        np.asarray(getattr(jwarp, fn)(jnp.asarray(image), jnp.asarray(gx.numpy()),
                                      jnp.asarray(gy.numpy()))))


def test_coordinates_are_echoflows():
    """px, py equal echoflow's pixel coordinates exactly: `floor` picks the
    corners, so one ulp would move a sample to another corner."""
    _, offsets = _inputs((2, 1, 15, 17), 0.4)
    h, w = offsets.shape[-2:]
    bx = jnp.asarray(np.linspace(-1.0, 1.0, w), jnp.float32)
    by = jnp.asarray(np.linspace(-1.0, 1.0, h), jnp.float32)
    gx = bx[None, None, :] + jnp.asarray(offsets)[:, 0]
    gy = by[None, :, None] + jnp.asarray(offsets)[:, 1]
    px, py = _coords(offsets)
    np.testing.assert_array_equal(px.numpy(), np.asarray(((gx + 1.0) * w - 1.0) * 0.5))
    np.testing.assert_array_equal(py.numpy(), np.asarray(((gy + 1.0) * h - 1.0) * 0.5))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 4, 8, 24)])
def test_plain_vjp_matches_pallas_interpret(interpret, shape):
    """The plain d_img, d_px, d_py against echoflow's Pallas VJP (K3, K4)
    run in interpret mode (H a multiple of 8, as the Pallas kernel needs).
    d_img: the same products wy (wx g), summed in another order, so each
    element is held to `image_grad_tolerance`. d_px, d_py: the Pallas
    kernel interpolates rows first, the plain version columns first; a few
    float32 roundings of O(1) terms per channel, atol 1e-5."""
    image, offsets = _inputs(shape, 0.3)
    px, py = _coords(offsets)
    g = np.random.RandomState(1).randn(*shape).astype(np.float32)
    out, vjp = jax.vjp(jkernel.warp_pallas_coords, jnp.asarray(image),
                       jnp.asarray(px.numpy()), jnp.asarray(py.numpy()))
    d_img, d_px, d_py = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    ti, tg = torch.from_numpy(image), torch.from_numpy(g)

    np.testing.assert_allclose(tkernel.reference_warp_forward(ti, px, py).numpy(),
                               np.asarray(out), rtol=0, atol=1e-6)
    tol = tkernel.image_grad_tolerance(tg, px, py).numpy()
    err = np.abs(tkernel.reference_warp_image_grad(tg, px, py).numpy() - d_img)
    assert (err <= tol).all(), float(err.max())
    r_px, r_py = tkernel.reference_warp_coord_grad(ti, tg, px, py)
    np.testing.assert_allclose(r_px.numpy(), d_px, rtol=0, atol=1e-5)
    np.testing.assert_allclose(r_py.numpy(), d_py, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 15, 17), (2, 2, 16, 16)])
def test_gradients_match_grid_sample_autograd(shape):
    """Third oracle: torch's `F.grid_sample` (the reference's own op) and
    its autograd, on the CPU. Its grid gradient is W/2 (H/2) times d_px
    (d_py). Both sides round differently (grid_sample recomputes the
    coordinates and blends with other operand order): atol 1e-5."""
    image, offsets = _inputs(shape, 0.4)
    g = torch.from_numpy(np.random.RandomState(2).randn(*shape).astype(np.float32))
    n, c, h, w = shape

    ti = torch.from_numpy(image).requires_grad_()
    to = torch.from_numpy(offsets).requires_grad_()
    (twarp.warp_image_with_offsets(ti, to) * g).sum().backward()

    ri = torch.from_numpy(image).requires_grad_()
    gx, gy = twarp.offset_grids(torch.from_numpy(offsets))
    grid = torch.stack([gx, gy], dim=-1).requires_grad_()
    out = F.grid_sample(ri, grid, mode="bilinear", padding_mode="border", align_corners=False)
    (out * g).sum().backward()

    np.testing.assert_allclose(twarp.warp_image_with_offsets(ti, to).detach().numpy(),
                               out.detach().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), ri.grad.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to.grad[:, 0].numpy(), grid.grad[..., 0].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to.grad[:, 1].numpy(), grid.grad[..., 1].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_coordinate_gradient_at_and_beyond_the_border(gather_backend):
    """Outside [0, size-1] the coordinate gradient is exactly 0. At exactly
    size-1 it is the one-hot weights' derivative, -v at that column (the
    x0+1 column lies outside the image and reads 0), as the Pallas kernel
    and `grid_sample` compute it; echoflow's gather autodiff gives 0 there
    because its x1 corner is clamped onto x0. The port matches the Pallas
    kernel, which is what ran on the TPU."""
    h, w = 4, 5
    image = torch.arange(h * w, dtype=torch.float32).reshape(1, 1, h, w) + 1.0
    px = torch.tensor([[[w - 1.0, -0.5, w - 0.5, 1.25, 2.0]] * h])
    py = torch.tensor([[[1.0, 1.0, 1.0, h - 1.0, h + 3.0]] * h])
    g = torch.ones(1, 1, h, w)
    d_px, d_py = tkernel.reference_warp_coord_grad(image, g, px, py)
    # column 0: x = W-1 exactly, y = 1: -v(1, W-1)
    assert torch.equal(d_px[0, :, 0], torch.full((h,), -float(image[0, 0, 1, w - 1])))
    assert torch.equal(d_px[0, :, 1], torch.zeros(h))     # x below 0
    assert torch.equal(d_px[0, :, 2], torch.zeros(h))     # x above W-1
    assert torch.equal(d_py[0, :, 3], torch.full((h,), -float(image[0, 0, h - 1, 1])
                                                 * 0.75 - float(image[0, 0, h - 1, 2]) * 0.25))
    assert torch.equal(d_py[0, :, 4], torch.zeros(h))     # y above H-1

    # The gather formulation's autodiff (echoflow's gather backend) gives 0
    # at x = W-1; everywhere else the two agree.
    gxj = (2.0 * jnp.asarray(px.numpy()) + 1.0) / w - 1.0
    gyj = (2.0 * jnp.asarray(py.numpy()) + 1.0) / h - 1.0
    d_gx = jax.grad(lambda a: jnp.sum(jwarp.warp_bilinear_border(
        jnp.asarray(image.numpy()), a, gyj)))(gxj)
    gather_px = np.asarray(d_gx) * 2.0 / w
    assert (gather_px[0, :, 0] == 0).all()
    np.testing.assert_allclose(gather_px[0, :, 1:], d_px[0, :, 1:].numpy(), atol=1e-5)


def test_cpu_warp_coords_asks_no_image_gradient_it_does_not_need(monkeypatch):
    """Without `requires_grad` on the image, the backward computes no
    d_img (on the card: launches no K3), as the fused loss's video warp
    needs; with it, d_img equals the plain version."""
    image, offsets = _inputs((2, 3, 8, 8), 0.3)
    px, py = (t.requires_grad_() for t in _coords(offsets))
    ti = torch.from_numpy(image)
    calls = []
    real = tkernel.warp_image_grad
    monkeypatch.setattr(tkernel, "warp_image_grad",
                        lambda *a: calls.append(1) or real(*a))
    tkernel.warp_coords(ti, px, py).sum().backward()
    assert calls == [] and ti.grad is None and px.grad is not None

    ti.requires_grad_()
    tkernel.warp_coords(ti, px.detach(), py.detach()).sum().backward()
    assert calls == [1]
    want = tkernel.reference_warp_image_grad(torch.ones_like(ti), px.detach(), py.detach())
    assert torch.equal(ti.grad, want)


# Odd W, and H*W not a multiple of a warp; channel pairs as the training
# chain step's (label 4, video 3), single channels, and a generic count.
PAIR_SHAPES = [(2, 15, 17), (3, 7, 5), (1, 9, 13)]
CHANNEL_PAIRS = [(4, 3), (1, 1), (2, 7)]


def _pair_inputs(nhw, channels, scale=0.3, seed=0):
    n, h, w = nhw
    ca, cb = channels
    rng = np.random.RandomState(seed)
    a = rng.rand(n, ca, h, w).astype(np.float32)
    b = rng.rand(n, cb, h, w).astype(np.float32)
    offsets = (scale * rng.randn(n, 2, h, w)).astype(np.float32)
    return a, b, offsets


@pytest.mark.parametrize("channels", CHANNEL_PAIRS)
@pytest.mark.parametrize("nhw", PAIR_SHAPES)
def test_warp_coords_pair_equals_two_warp_coords(nhw, channels):
    """Forward, d_img of both images, d_px and d_py bitwise those of two
    `warp_coords` calls on the same coordinates (autograd adds the two
    calls' coordinate gradients; the pair adds K4's two results)."""
    a, b, offsets = _pair_inputs(nhw, channels)
    rng = np.random.RandomState(1)
    g_a = torch.from_numpy(rng.randn(*a.shape).astype(np.float32))
    g_b = torch.from_numpy(rng.randn(*b.shape).astype(np.float32))
    got = []
    for pair in (True, False):
        ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
        px, py = (t.detach().requires_grad_() for t in _coords(offsets))
        if pair:
            out_a, out_b = tkernel.warp_coords_pair(ta, tb, px, py)
        else:
            out_a, out_b = tkernel.warp_coords(ta, px, py), tkernel.warp_coords(tb, px, py)
        ((out_a * g_a).sum() + (out_b * g_b).sum()).backward()
        got.append([out_a.detach(), out_b.detach(), ta.grad, tb.grad, px.grad, py.grad])
    for x, y in zip(*got):
        assert torch.equal(x, y)


@pytest.mark.parametrize("channels", CHANNEL_PAIRS)
@pytest.mark.parametrize("nhw,scale", [((2, 15, 17), 0.3), ((3, 7, 5), 3.0)])
def test_warp_forward_pair_equals_echoflow_gather(gather_backend, nhw, scale, channels):
    """Each output of the pair warp bit for bit echoflow's gather warp of
    its image (the oracle of `test_forward_equals_echoflow_gather`)."""
    a, b, offsets = _pair_inputs(nhw, channels, scale)
    px, py = _coords(offsets)
    outs = tkernel.warp_forward_pair(torch.from_numpy(a), torch.from_numpy(b), px, py)
    for image, out in zip((a, b), outs):
        want = jwarp.warp_image_with_offsets(jnp.asarray(image), jnp.asarray(offsets))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_warp_coords_pair_asks_no_image_gradient_for_the_video(monkeypatch):
    """The fused loss's video stack needs no gradient: the pair's backward
    computes d_img (on the card: launches K3) for the label stack only,
    and d_px, d_py from both images."""
    a, b, offsets = _pair_inputs((2, 8, 8), (4, 3))
    px, py = (t.requires_grad_() for t in _coords(offsets))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b)
    calls, coord_calls = [], []
    real, real_coord = tkernel.warp_image_grad, tkernel.warp_coord_grad
    monkeypatch.setattr(tkernel, "warp_image_grad", lambda *x: calls.append(1) or real(*x))
    monkeypatch.setattr(tkernel, "warp_coord_grad",
                        lambda *x: coord_calls.append(1) or real_coord(*x))
    out_a, out_b = tkernel.warp_coords_pair(ta, tb, px, py)
    (out_a.sum() + out_b.sum()).backward()
    assert calls == [1] and coord_calls == [1, 1]
    assert tb.grad is None and px.grad is not None
    want = tkernel.reference_warp_image_grad(torch.ones_like(ta), px.detach(), py.detach())
    assert torch.equal(ta.grad, want)


def test_offset_grids_come_from_a_cache():
    """The base grids are float64 `np.linspace` cast to the offsets' dtype,
    bitwise, made once per (H, W, device, dtype): the same tensors come
    back for the same key, and a new size, dtype or device gets its own."""
    _, offsets = _inputs((2, 1, 15, 17), 0.4)
    t = torch.from_numpy(offsets)
    gx, gy = twarp.offset_grids(t)
    bx = torch.from_numpy(np.linspace(-1.0, 1.0, 17)).to(torch.float32)
    by = torch.from_numpy(np.linspace(-1.0, 1.0, 15)).to(torch.float32)
    assert torch.equal(gx, bx[None, None, :] + t[:, 0])
    assert torch.equal(gy, by[None, :, None] + t[:, 1])

    cpu = torch.device("cpu")
    first = twarp._base_grids(15, 17, cpu, torch.float32)
    assert all(x is y for x, y in zip(first, twarp._base_grids(15, 17, cpu, torch.float32)))
    for key in ((17, 15, cpu, torch.float32), (15, 17, cpu, torch.float64),
                (15, 17, torch.device("meta"), torch.float32)):
        other = twarp._base_grids(*key)
        assert all(x is not y for x, y in zip(first, other))
        assert other[0].shape == (1, 1, key[1]) and other[1].shape == (1, key[0], 1)
        assert other[0].dtype == key[3] and other[0].device == key[2]
    np.testing.assert_array_equal(twarp._base_grids(15, 17, cpu, torch.float64)[0][0, 0].numpy(),
                                  np.linspace(-1.0, 1.0, 17))


def test_unknown_mode_and_device_raise():
    image, offsets = _inputs((1, 1, 4, 4), 0.1)
    with pytest.raises(ValueError):
        twarp.warp_image_with_offsets(torch.from_numpy(image), torch.from_numpy(offsets),
                                      mode="bicubic")
    with pytest.raises(ValueError):
        tkernel.warp_forward(torch.zeros(1, 1, 2, 2, device="meta"),
                             torch.zeros(1, 2, 2, device="meta"),
                             torch.zeros(1, 2, 2, device="meta"))
    with pytest.raises(ValueError):
        tkernel.warp_forward_pair(torch.zeros(1, 1, 2, 2, device="meta"),
                                  torch.zeros(1, 3, 2, 2, device="meta"),
                                  torch.zeros(1, 2, 2, device="meta"),
                                  torch.zeros(1, 2, 2, device="meta"))



def _k3_recipe(g, px, py):
    """K3 (`csrc/warp.cu`) in torch. Pass 1: lanes of 32 hold consecutive
    pixels (flat N*H*W order); each pixel's terms wy (wx g), one vector a
    corner over all channels, are added to a channels-last accumulator,
    except that where a pixel's right corner (x0 + 1) is the next lane's
    left corner, that lane adds the two terms as one (top and bottom row
    alike). Pass 2: the accumulator, transposed, is d_img. Returns d_img,
    the number of terms that reached each element and the atomics per
    pixel."""
    n, c, h, w = g.shape
    x0, y0, fx, fy = (t.reshape(-1) for t in tkernel._corners(px, py, h, w))
    fx, fy = fx.float(), fy.float()
    pixels = n * h * w
    idx = torch.arange(pixels)
    lane = idx % 32
    hx, hy = x0 + 1 < w, y0 + 1 < h
    gp = g.permute(0, 2, 3, 1).reshape(pixels, c)          # g of each pixel, channels last
    gx0, gx1 = (1.0 - fx)[:, None] * gp, fx[:, None] * gp
    kt = idx // (h * w) * (h * w) + y0 * w + x0
    kb = torch.where(hy, kt + w, torch.full_like(kt, -1))
    acc = torch.zeros(pixels, c)
    hits = torch.zeros(pixels, c)
    atomics = 0
    for key, wy in ((kt, 1.0 - fy), (kb, fy)):
        left, right = wy[:, None] * gx0, wy[:, None] * gx1
        key_r = torch.where((key >= 0) & hx, key + 1, torch.full_like(key, -1))
        prev_r = torch.cat([torch.full((1,), -1), key_r[:-1]])
        nxt = torch.cat([key[1:], torch.full((1,), -1)])
        take = (lane > 0) & (key >= 0) & (prev_r == key)
        give = (lane < 31) & (key_r >= 0) & (nxt == key_r)
        prev_right = torch.cat([torch.zeros(1, c), right[:-1]])
        left = torch.where(take[:, None], left + prev_right, left)
        on_l, on_r = key >= 0, (key_r >= 0) & ~give
        for on, k, v, terms in ((on_l, key, left, 1.0 + take.float()),
                                (on_r, key_r, right, torch.ones(pixels))):
            acc.index_add_(0, k[on], v[on])
            hits.index_add_(0, k[on], terms[on][:, None].expand(-1, c).contiguous())
            atomics += int(on.sum())
    d = acc.reshape(n, h, w, c).permute(0, 3, 1, 2)
    return d, hits.reshape(n, h, w, c).permute(0, 3, 1, 2), atomics / pixels


def _k3_case(case):
    rng = np.random.RandomState(7)
    shape = {"near_identity": (2, 3, 24, 20), "smooth_shift": (2, 4, 16, 40),
             "rough": (1, 4, 112, 112), "far_past_border": (2, 2, 70, 9),
             "pixels_not_a_multiple_of_32": (2, 5, 30, 13), "one_row": (3, 3, 1, 17)}[case]
    n, c, h, w = shape
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    if case in ("near_identity", "smooth_shift"):
        noise = 0.3 * rng.randn(2, n, h, w) if case == "near_identity" \
            else np.full((2, n, h, w), 0.3)
        px = torch.arange(w, dtype=torch.float32) + torch.from_numpy(noise[0].astype(np.float32))
        py = torch.arange(h, dtype=torch.float32)[:, None] + torch.from_numpy(
            noise[1].astype(np.float32))
    else:
        # chip_smoke.py phase 5's rough field, tanh(0.15 randn) (~8 px at
        # 112 wide); 3 randn for motion far past the border.
        offsets = np.tanh(0.15 * rng.randn(n, 2, h, w)) if case != "far_past_border" \
            else 3.0 * rng.randn(n, 2, h, w)
        px, py = _coords(offsets.astype(np.float32))
    return g, px, py


@pytest.mark.parametrize("case", ["near_identity", "smooth_shift", "rough", "far_past_border",
                                  "pixels_not_a_multiple_of_32", "one_row"])
def test_k3_tiled_recipe_matches_plain(case):
    """K3's recipe equals the plain d_img within `image_grad_tolerance`,
    and every term reaches its element exactly once, alone or joined to its
    neighbour's: the recipe's hit counts are `_corner_terms`' own. A
    uniform sub-pixel shift joins every pair but the warps' last lanes':
    about 2 atomics a pixel instead of 4; rough motion joins almost none."""
    g, px, py = _k3_case(case)
    n, c, h, w = g.shape
    d, hits, atomics = _k3_recipe(g, px, py)
    want = tkernel.reference_warp_image_grad(g, px, py)
    tol = tkernel.image_grad_tolerance(g, px, py)
    assert ((d - want).abs() <= tol).all(), float((d - want).abs().max())
    want_hits = torch.zeros(n, c, h * w)
    for idx, valid, _, _ in tkernel._corner_terms(px, py, h, w):
        for b in range(n):
            want_hits[b].index_add_(1, idx[b].reshape(-1),
                                    valid[b].reshape(1, -1).float().expand(c, -1).contiguous())
    assert torch.equal(hits, want_hits.reshape(n, c, h, w))
    limits = {"smooth_shift": (1.9, 2.1), "rough": (3.6, 4.0), "one_row": (1.0, 2.0)}
    lo, hi = limits.get(case, (1.0, 4.0))
    assert lo <= atomics <= hi, atomics
