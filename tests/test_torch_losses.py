"""The port's CLAS-FV losses (echoflow_torch.train.losses) against
echoflow.train.losses on the same numpy inputs: the value, and the
gradients with respect to the segmentation logits and the motion
(`jax.grad` against `torch.autograd`).

echoflow's warp runs its "matmul" backend on the CPU (its default there),
the port the plain gather version of its kernels. The two blend the
corners with different operand orders, so values differ by float32
roundings (measured: values within 1.4e-6 relative; through chains of
T-1 = 7 warps, gradients within 2.6e-6 of their largest element).
Tolerances: values rtol 1e-5; gradients max abs error 2e-5 of the largest
gradient element, and relative L2 error 2e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.train import losses as jl
from echoflow_torch.train import losses as tl

N, T, H, W = 4, 8, 15, 17
# One batch covers the ED/ES index cases sample by sample: (0, T-1), an
# interior pair, ED after ES, and ED == ES - 1.
ED = np.array([0, 2, 5, 3], np.int32)
ES = np.array([T - 1, 5, 2, 4], np.int32)


def _labels(rng, n):
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for _ in range(n):
        cy, cx, r = rng.uniform(5, 10), rng.uniform(5, 12), rng.uniform(3, 6)
        out.append((((yy - cy) / 1.3) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int32))
    return np.stack(out)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return {
        "video": rng.rand(N, 3, T, H, W).astype(np.float32),
        "seg": (2.0 * rng.randn(N, 2, T, H, W)).astype(np.float32),
        "motion": np.tanh(0.3 * rng.randn(N, 4, T, H, W)).astype(np.float32),
        "ed_label": _labels(rng, N),
        "es_label": _labels(rng, N),
        "ed_idx": ED, "es_idx": ES,
    }


def _close_value(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def _close_grad(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 2e-5 * scale, np.abs(got - want).max() / scale
    assert np.linalg.norm(got - want) <= 2e-5 * np.linalg.norm(want)


def _compare(jfn, tfn, diff_args, const_args, reduce):
    """Value and gradients of `reduce(fn(*diff_args, *const_args))` with
    respect to every differentiable argument, on both sides."""
    jvals = [jnp.asarray(a) for a in diff_args]
    jconst = [jnp.asarray(a) for a in const_args]
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda *a: reduce(jfn(*a, *jconst)), argnums=tuple(range(len(jvals)))))(*jvals)
    tvals = [torch.from_numpy(np.array(a)).requires_grad_() for a in diff_args]
    tconst = [torch.from_numpy(np.array(a)) for a in const_args]
    tval = reduce(tfn(*tvals, *tconst))
    tval.backward()
    _close_value(tval.detach(), jval)
    for t, j in zip(tvals, jgrads):
        _close_grad(t.grad.numpy(), j)


def _first(out):
    return out[0]


def _sgs_ots(out):
    sgs, ots = out
    return sgs + 0.5 * ots   # weighted so that a swap of the two would show


def _itself(out):
    return out


def test_soft_dice_and_bce(data):
    probs = 1.0 / (1.0 + np.exp(-data["seg"][:, :, 0]))
    target = np.stack([1 - data["ed_label"], data["ed_label"]], 1).astype(np.float32)
    _compare(jl.soft_dice_loss, tl.soft_dice_loss, [probs], [target], _itself)
    _compare(jl.bce_with_logits, tl.bce_with_logits, [data["seg"][:, :, 1]], [target],
             _itself)


def test_huber_smoothness(data):
    flow = data["motion"][:, :2, 0]
    _compare(jl.huber_smoothness, tl.huber_smoothness, [flow], [], _itself)
    pairs = np.moveaxis(data["motion"][:, :2, :-1], 2, 1)
    _compare(jl._huber_flow_smoothness, tl._huber_flow_smoothness, [pairs], [], _itself)
    _compare(jl._ota_smoothness, tl._ota_smoothness, [data["motion"]], [], _itself)


def test_deformation_motion_loss(data):
    _compare(lambda m, v: jl.deformation_motion_loss(v, m),
             lambda m, v: tl.deformation_motion_loss(v, m),
             [data["motion"]], [data["video"]], _itself)


def _chain_args(d):
    return [d["ed_label"], d["es_label"], d["ed_idx"], d["es_idx"]]


def test_motion_seg_loss_batch(data):
    """All four index cases in one batch, the batch mean as echoflow
    takes it."""
    _compare(lambda m, s, *c: jl.motion_seg_loss(*c, m, s),
             lambda m, s, *c: tl.motion_seg_loss(*c, m, s),
             [data["motion"], data["seg"]], _chain_args(data), _sgs_ots)


@pytest.mark.parametrize("case", range(N), ids=["start-end", "interior", "ed-after-es",
                                                  "adjacent"])
def test_motion_seg_loss_single(data, case):
    d = data
    _compare(lambda m, s, *c: jl.motion_seg_loss_single(*c, m, s),
             lambda m, s, *c: tl.motion_seg_loss_single(*c, m, s),
             [d["motion"][case], d["seg"][case]],
             [d["ed_label"][case], d["es_label"][case], d["ed_idx"][case], d["es_idx"][case]],
             _sgs_ots)


@pytest.mark.parametrize("case", [0, 2])
def test_single_label_motion_seg_loss_sample(data, case):
    d = data
    _compare(lambda m, s, lab, idx: jl.single_label_motion_seg_loss_sample(lab, idx, m, s),
             lambda m, s, lab, idx: tl.single_label_motion_seg_loss_sample(lab, idx, m, s),
             [d["motion"][case], d["seg"][case]], [d["ed_label"][case], d["ed_idx"][case]],
             _itself)


def test_edes_supervised_loss(data):
    _compare(lambda s, *c: jl.edes_supervised_loss(s, *c),
             lambda s, *c: tl.edes_supervised_loss(s, *c),
             [data["seg"]], _chain_args(data), _first)


@pytest.mark.parametrize("name", ["clasfv_total_loss", "clasfv_total_loss_fused"])
def test_total_losses_and_aux(data, name):
    d = data
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    _compare(lambda s, m, v, *c: jfn(v, s, m, *c), lambda s, m, v, *c: tfn(v, s, m, *c),
             [d["seg"], d["motion"]], [d["video"]] + _chain_args(d), _first)
    _, jaux = jfn(*(jnp.asarray(d[k]) for k in ("video", "seg", "motion", "ed_label",
                                                  "es_label", "ed_idx", "es_idx")))
    _, taux = tfn(*(torch.from_numpy(np.array(d[k])) for k in (
        "video", "seg", "motion", "ed_label", "es_label", "ed_idx", "es_idx")))
    for key in ("ota", "sgs", "ots", "edes_bce"):
        _close_value(taux[key], jaux[key])
    for key in ("ed_logits", "es_logits"):
        np.testing.assert_array_equal(taux[key].numpy(), np.asarray(jaux[key]))


def test_ed_es_only_total_loss(data):
    d = data
    rng = np.random.RandomState(3)
    es_video = rng.rand(*d["video"].shape).astype(np.float32)
    es_seg = (2.0 * rng.randn(*d["seg"].shape)).astype(np.float32)
    es_motion = np.tanh(0.3 * rng.randn(*d["motion"].shape)).astype(np.float32)
    es_idx = np.array([T - 1, 0, 4, 6], np.int32)

    def jfn(eds, edm, ess, esm, edv, esv, le, ls, ie, is_):
        return jl.ed_es_only_total_loss(edv, esv, eds, edm, ess, esm, le, ls, ie, is_)

    def tfn(eds, edm, ess, esm, edv, esv, le, ls, ie, is_):
        return tl.ed_es_only_total_loss(edv, esv, eds, edm, ess, esm, le, ls, ie, is_)

    _compare(jfn, tfn, [d["seg"], d["motion"], es_seg, es_motion],
             [d["video"], es_video, d["ed_label"], d["es_label"], d["ed_idx"], es_idx], _first)


def test_fused_schedule_equals_unfused_in_the_port(data):
    """The fused chain+OTA loop computes the same loss as the reference
    schedule up to float32 summation order, in value and gradient."""
    d = data
    out = []
    for fn in (tl.clasfv_total_loss, tl.clasfv_total_loss_fused):
        seg = torch.from_numpy(d["seg"].copy()).requires_grad_()
        motion = torch.from_numpy(d["motion"].copy()).requires_grad_()
        total, aux = fn(torch.from_numpy(d["video"]), seg, motion,
                        *(torch.from_numpy(d[k]) for k in ("ed_label", "es_label",
                                                            "ed_idx", "es_idx")))
        total.backward()
        out.append((total.detach(), {k: aux[k].detach() for k in ("ota", "sgs", "ots")},
                    seg.grad, motion.grad))
    (t0, a0, s0, m0), (t1, a1, s1, m1) = out
    _close_value(t1, t0)
    for key in a0:
        _close_value(a1[key], a0[key])
    _close_grad(s1.numpy(), s0.numpy())
    _close_grad(m1.numpy(), m0.numpy())
