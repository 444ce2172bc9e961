"""echoflow_torch.infer.propagate against echoflow.infer.propagate: the same
labels, frames and motion fields (made with numpy from a seed) through both
rollouts on the CPU, at a 32-frame clip's chain length (31 steps)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from echoflow.infer import propagate as JP

from echoflow_torch.infer import propagate as TP

N, T, H, W = 2, 32, 16, 20
# Bilinear after the 31-step chain: echoflow runs its "matmul" warp on the
# CPU (dense interpolation matrices), the port the gather formulation, so
# float32 rounding differs at every step and accumulates along the chain.
# Measured on these inputs: labels 3.6e-7 forward, 1.6e-6 backward; frames
# 1.8e-7 (single step), 6.6e-7 (backward chain).
BILINEAR_TOL = 1e-5


def _motion(seed, scale=0.08):
    """(N, 4, T, H, W) smooth motion: a 4x5 field per frame upsampled
    bilinearly, about 0.6 px along x and 0.5 px along y, the wall motion of
    consecutive frames; some samples leave the image (the border clamp)."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy((scale * rng.randn(N * T, 4, 4, 5)).astype(np.float32))
    field = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
    return field.reshape(N, T, 4, H, W).permute(0, 2, 1, 3, 4).contiguous().numpy()


def _labels(seed):
    """One-hot (N, 2, H, W) disks, as the rollouts carry ED and ES labels."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    out = np.zeros((N, 2, H, W), np.float32)
    for i in range(N):
        r = rng.uniform(3.0, 6.0)
        disk = ((yy - H / 2) ** 2 + (xx - W / 2) ** 2 <= r * r).astype(np.float32)
        out[i, 1], out[i, 0] = disk, 1.0 - disk
    return out


def _both(fn_name, *args, **kw):
    """The same arguments through echoflow (arrays as jnp) and the port
    (arrays as torch); other arguments pass as they are."""
    arr = lambda a, to: to(a) if isinstance(a, np.ndarray) else a
    want = getattr(JP, fn_name)(*[arr(a, jnp.asarray) for a in args], **kw)
    got = getattr(TP, fn_name)(*[arr(a, torch.from_numpy) for a in args], **kw)
    return got, want


def _err(got, want):
    return float(np.abs(got.numpy() - np.asarray(want)).max())


def test_deform_forback_nearest_is_bitwise():
    """The default mode (nearest) carries labels exactly: round half to even
    of the same float32 coordinates, then a gather."""
    got, want = _both("deform_forback", _labels(0), _labels(1), _motion(2))
    assert got[0].shape == got[1].shape == (T - 1, N, 2, H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the chain moved the labels
    assert float(np.abs(got[0][-1].numpy() - _labels(0)).max()) == 1.0


def test_deform_forback_bilinear_after_31_steps(capsys):
    got, want = _both("deform_forback", _labels(0), _labels(1), _motion(2), mode="bilinear")
    errs = [_err(g, w) for g, w in zip(got, want)]
    with capsys.disabled():
        print(f"\nbilinear deform_forback after {T - 1} steps: max abs err "
              f"forward {errs[0]:.2e}, backward {errs[1]:.2e}")
    assert max(errs) <= BILINEAR_TOL


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_deform_images_forback(mode):
    images = np.random.RandomState(3).rand(N, 3, T, H, W).astype(np.float32)
    got, want = _both("deform_images_forback", images, _motion(4), mode=mode)
    assert got[0].shape == got[1].shape == (T - 1, N, 3, H, W)
    for g, w in zip(got, want):
        if mode == "nearest":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert _err(g, w) <= BILINEAR_TOL


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("forward,start,end", [(True, 0, T - 1), (False, T - 1, 0),
                                               (True, 5, 17), (False, 20, 3)])
def test_apply_sequence_deformation(forward, start, end, mode):
    source, motion = _labels(5), _motion(6)
    got, want = _both("apply_sequence_deformation", source, motion, start, end,
                      mode=mode, forward=forward)
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _err(got, want) <= BILINEAR_TOL


def test_apply_sequence_deformation_without_steps_returns_the_source():
    """An empty range is no step (echoflow's scan cannot index an empty
    step list; the port's loop returns the source)."""
    source = torch.from_numpy(_labels(5))
    for forward in (True, False):
        out = TP.apply_sequence_deformation(source, torch.from_numpy(_motion(6)), 4, 4,
                                            forward=forward)
        assert out is source


def test_reference_named_aliases():
    assert TP.get_deformed_label_forback is TP.deform_forback
    assert TP.get_deformed_image_forback is TP.deform_images_forback


def test_one_frame_clip_has_empty_rollouts():
    motion = _motion(7)[:, :, :1]
    fwd, bwd = TP.deform_forback(torch.from_numpy(_labels(0)), torch.from_numpy(_labels(1)),
                                 torch.from_numpy(motion), mode="bilinear")
    assert fwd.shape == bwd.shape == (0, N, 2, H, W)
