"""echoflow_torch.infer.clips against echoflow.infer.clips: the same clips
(32x32 frames of a synthetic beat) and the same weights (echoflow's init,
carried across by `models/convert.py`) through both ClipForwards on the
CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.data.synthetic import make_beating_video
from echoflow.infer import clips as JC
from echoflow.infer.ef import start_points_covering_frame
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables
from echoflow.ops.normalize import zeroone_normalizer

from echoflow_torch.infer import clips as TC
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.fold_bn import fold_state_dict

torch.set_num_threads(2)

TOL = 1e-5          # fp32 through 18 conv layers on two backends
LABEL_TOL = 1e-4    # share of pixels whose argmax may flip at a near-tie


def _variables(seg_gain=1.0, motion_gain=100.0, centre=False):
    """echoflow's init (seed 3). The motion head x100 gives motions of
    about 0.3, the scale of a trained model's, instead of 1e-3. With
    `centre`, the seg head is scaled by `seg_gain` and its bias centred on
    a clip's median logit margin, so the labels are about half foreground
    (as tests/test_torch_pipeline.py does)."""
    v = jax.tree.map(np.asarray, init_variables(
        jax.random.PRNGKey(3), FlaxNet(), (1, 3, 32, 32, 32)))
    v["params"]["seg_head"]["kernel"] = v["params"]["seg_head"]["kernel"] * seg_gain
    v["params"]["motion_head"]["kernel"] = v["params"]["motion_head"]["kernel"] * motion_gain
    if centre:
        probe = JC.ClipForward(v, dtype=jnp.float32, forward_chunk=1, with_motion=False)
        logits = np.log(probe(_clips(1))[0][0])
        med = float(np.median(logits[1] - logits[0]))
        v["params"]["seg_head"]["bias"] = (v["params"]["seg_head"]["bias"]
                                           + np.array([med / 2, -med / 2], np.float32))
    return v


def _video(length=44):
    beat = make_beating_video(num_frames=length, height=32, width=32, period=20.0, seed=1)
    return zeroone_normalizer(beat.video.copy())


def _clips(n):
    video = _video()
    return np.stack([video[:, s:s + 32] for s in range(n)])


@pytest.fixture(scope="module")
def weights():
    return _variables()


@pytest.fixture(scope="module")
def label_weights():
    return _variables(seg_gain=50.0, centre=True)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "module"])
@pytest.mark.parametrize("n,chunk", [(5, 2), (5, 8), (3, 1)])
def test_clip_forward_matches_echoflow(weights, n, chunk, fold_bn):
    """Probabilities and motion within 1e-5; chunk sizes that leave a
    partial chunk (5 clips by 2), one chunk larger than the stack, and
    single clips."""
    clips = _clips(n)
    want = JC.ClipForward(weights, dtype=jnp.float32, forward_chunk=chunk, fold_bn=fold_bn)(clips)
    port = TC.ClipForward(state_dict_from_variables(weights), device="cpu",
                          forward_chunk=chunk, fold_bn=fold_bn)
    got = port(clips)
    assert [g.shape for g in got] == [(n, 2, 32, 32, 32), (n, 4, 32, 32, 32)]
    assert all(g.dtype == np.float32 for g in got)
    assert float(np.abs(want[1]).max()) > 0.1   # motions of a real scale
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_clip_forward_without_motion_and_prefolded(weights):
    clips = _clips(2)
    want = JC.ClipForward(weights, dtype=jnp.float32, forward_chunk=2, with_motion=False)(clips)
    state = state_dict_from_variables(weights)
    for variables in (state, fold_state_dict(state)):   # a folded state dict is taken as folded
        got = TC.ClipForward(variables, device="cpu", with_motion=False)(clips)
        assert len(got) == 1
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL)


def test_segment_start_points_labels_match(label_weights):
    """Seg head x50 with a centred bias: labels identical outside argmax
    near-ties. The logits are 50 times larger, so the probabilities agree
    to 50 times the unscaled bar (a softmax moves at most 1/4 of a logit
    difference)."""
    video = _video()
    starts = start_points_covering_frame(20, video.shape[1])[-5:]
    want = JC.ClipForward(label_weights, dtype=jnp.float32, forward_chunk=2) \
        .segment_start_points(video, starts)
    got = TC.ClipForward(state_dict_from_variables(label_weights), device="cpu",
                         forward_chunk=2).segment_start_points(video, starts)
    labels, probs, motion = got
    assert labels.shape == (5, 32, 32, 32) and labels.dtype == np.uint8
    assert 0.2 < labels.mean() < 0.8
    assert float((labels != want[0]).mean()) <= LABEL_TOL
    np.testing.assert_allclose(probs, want[1], rtol=0, atol=50 * TOL)
    np.testing.assert_allclose(motion, want[2], rtol=0, atol=TOL)


@pytest.mark.parametrize("with_motion", [True, False])
def test_empty_start_points(weights, with_motion):
    video = _video()
    kw = dict(forward_chunk=2, with_motion=with_motion)
    want = JC.ClipForward(weights, dtype=jnp.float32, **kw).segment_start_points(video, [])
    got = TC.ClipForward(state_dict_from_variables(weights), device="cpu",
                         **kw).segment_start_points(video, [])
    assert len(got) == len(want) == (3 if with_motion else 2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert [o.shape for o in TC.ClipForward(state_dict_from_variables(weights), device="cpu",
                                            **kw)(np.zeros((0, 3, 32, 32, 32), np.float32))] \
        == [o.shape for o in want[1:]]


def test_clip_forward_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    state = state_dict_from_variables(_variables())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.ClipForward(state)
