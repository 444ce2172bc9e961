"""echoflow_torch.infer.pipeline against echoflow.infer.pipeline: host
operands array for array, and the engine's fp32 masks against
`echoflow`'s VideoSegmenter(dtype=float32) on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.data.synthetic import make_beating_video
from echoflow.infer import pipeline as JP
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables

from echoflow_torch.infer import pipeline as TP
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
from echoflow_torch.ops.normalize import zeroone_normalizer

torch.set_num_threads(2)

METHODS = ["majority", "simple", "staple", "softmax"]


@pytest.mark.parametrize("length,num_clips,step,t_pad", [
    (32, 1, 1, 32), (33, 5, 4, 64), (35, 5, 4, 64), (36, 5, 4, 64), (40, 5, 4, 64),
    (45, 2, 1, 64), (64, 2, 1, 64), (96, 5, 1, 128), (176, 5, 1, 192),
    (128, 10, 3, 128), (200, 10, 3, 256),
])
def test_host_operands_match(length, num_clips, step, t_pad):
    assert TP._shift_plan(length, num_clips, step) == JP._shift_plan(length, num_clips, step)
    got = TP._build_host_operands(length, num_clips, step, t_pad)
    want = JP._build_host_operands(length, num_clips, step, t_pad)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


def test_packbits_bit_order_and_round_trip():
    rng = np.random.RandomState(0)
    mask = (rng.rand(5, 7, 32) < 0.5).astype(np.uint8)
    packed = TP._packbits(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(mask, axis=-1))   # MSB first
    np.testing.assert_array_equal(packed, np.asarray(JP._packbits(jnp.asarray(mask))))
    np.testing.assert_array_equal(TP._unpackbits(packed, 32), mask)
    odd = mask[..., :30]
    assert TP._packbits(torch.from_numpy(odd)).shape == odd.shape   # W % 8 != 0


def test_rounding_and_clip_division_match():
    for x in (0.5, 1.5, 2.5, 1.406, 5.5, 5.47):
        assert TP.round_half_even(x) == JP.round_half_even(x)
    for length in (45, 48, 64, 80):
        video = np.random.RandomState(length).rand(3, length, 8, 8).astype(np.float32)
        got = TP.divide_to_consecutive_clips(video, interpolate_last=True)
        want = JP.divide_to_consecutive_clips(video, interpolate_last=True)
        # Same matrices, fp32 matmul in two frameworks.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_chunk_plan_matches():
    def plan(mod, n_fwd, forward_chunk):
        seg = object.__new__(mod.VideoSegmenter)
        seg.forward_chunk = forward_chunk
        seg.mesh = None
        return seg._chunk_plan(n_fwd)

    for n_fwd in range(1, 130):
        for chunk in (1, 4, 30):
            assert plan(TP, n_fwd, chunk) == plan(JP, n_fwd, chunk)


@pytest.fixture(scope="module")
def shared_weights():
    """Full-width MotionNet variables (echoflow's init), seg head x50 as in
    tests/test_pipeline.py:23-31 so the argmax is decided by the network
    and not by fp noise, with the head bias centred on a sample video's
    median logit margin so the masks are about half foreground (a
    near-all-foreground mask would hide disagreements)."""
    v = jax.tree.map(np.asarray, init_variables(
        jax.random.PRNGKey(3), FlaxNet(), (1, 3, 32, 32, 32)))
    v["params"]["seg_head"]["kernel"] = v["params"]["seg_head"]["kernel"] * 50.0
    model = R2Plus1DMotionSegNet()
    model.load_state_dict(state_dict_from_variables(v))
    beat = make_beating_video(num_frames=32, height=32, width=32, period=20.0, seed=1)
    with torch.no_grad():
        seg, _ = model.eval()(torch.from_numpy(zeroone_normalizer(beat.video.copy()))[None])
    med = float((seg[0, 1] - seg[0, 0]).median())
    v["params"]["seg_head"]["bias"] = (v["params"]["seg_head"]["bias"]
                                       + np.array([med / 2, -med / 2], np.float32))
    return v


@pytest.fixture(scope="module")
def engines(shared_weights):
    jax_engine = JP.VideoSegmenter(shared_weights, forward_chunk=4, bucket=32,
                                   dtype=jnp.float32)
    port = TP.VideoSegmenter(state_dict_from_variables(shared_weights), device="cpu",
                             forward_chunk=4, bucket=32)
    return jax_engine, port


def _video(length, color):
    beat = make_beating_video(num_frames=length, height=32, width=32, period=20.0, seed=1)
    video = beat.video.astype(np.uint8)
    if color:   # a genuinely coloured video takes the RGB path
        video[2] = np.clip(video[2].astype(np.int64) + 7, 0, 255).astype(np.uint8)
    return video


def _staple_margin64(stack, live, num_iters=30, init_pq=0.99999):
    """log_a - log_b of binary STAPLE (`staple_fuse`'s EM) in float64 for
    one frame's (R, H, W) rater stack with (R,) liveness."""
    d, lv = stack.astype(np.float64), live.astype(np.float64)[:, None, None]
    n_live = max(lv.sum(), 1.0)
    prior = np.clip((lv * d).sum() / (n_live * d.shape[1] * d.shape[2]), 1e-5, 1 - 1e-5)
    p = np.full(d.shape[0], init_pq)
    q = np.full(d.shape[0], init_pq)
    eps = 1e-7

    def log_ab(p, q):
        p3, q3 = p[:, None, None], q[:, None, None]
        log_a = np.log(prior) + (lv * (d * np.log(p3 + eps)
                                       + (1 - d) * np.log(1 - p3 + eps))).sum(0)
        log_b = np.log(1 - prior) + (lv * ((1 - d) * np.log(q3 + eps)
                                           + d * np.log(1 - q3 + eps))).sum(0)
        return log_a, log_b

    for _ in range(num_iters):
        log_a, log_b = log_ab(p, q)
        w = 1.0 / (1.0 + np.exp(log_b - log_a))
        p = np.clip((w * d).sum((1, 2)) / (w.sum() + eps), eps, 1 - eps)
        q = np.clip(((1 - w) * (1 - d)).sum((1, 2)) / ((1 - w).sum() + eps), eps, 1 - eps)
    log_a, log_b = log_ab(p, q)
    return log_a - log_b


@pytest.mark.parametrize("color", [False, True], ids=["mono", "rgb"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("length", [45, 64])
def test_engine_masks_match_echoflow(engines, length, method, color, monkeypatch):
    jax_engine, port = engines
    video = _video(length, color)
    stacks = []
    real_fuse = TP.fuse_frames
    monkeypatch.setattr(TP, "fuse_frames", lambda stack, valid, **kw: stacks.append(
        (stack.numpy().copy(), valid.numpy().copy())) or real_fuse(stack, valid, **kw))
    want = jax_engine.segment_video(video, num_clips=2, step=1, fuse_method=method)
    got = port.segment_video(video, num_clips=2, step=1, fuse_method=method)
    assert got.shape == want.shape == (length, 32, 32)
    assert 0.2 < want.mean() < 0.8
    if method != "staple":
        np.testing.assert_array_equal(got, want)
        return
    # The label stacks going into the fusion are identical (majority, SIMPLE
    # and softmax masks match exactly); STAPLE's masks differ on a few
    # pixels. None of them is an exact posterior tie: in float64 the margin
    # log_a - log_b there is -1.9e-3 or +3.6e-2 (of |log_a| ~ 7). Near
    # convergence p and q sit within a few float32 ulps of 1, so the float32
    # EM's log(1 - p + 1e-7) carries errors far larger than such margins,
    # and the sum order of each framework decides. At every differing pixel
    # the port's decision is the float64 one, echoflow's is not: a float32
    # rounding of echoflow's STAPLE, not a fault of the port.
    (stack, valid), = stacks
    differ = []
    for t, y, x in np.argwhere(got != want):
        live = valid[t].astype(bool)
        assert live.sum() > 1, f"frame {t} has one live rater (copied through) and differs"
        margin = _staple_margin64(stack[t][live], valid[t][live])
        differ.append((int(t), int(y), int(x), float(margin[y, x])))
        assert got[t, y, x] == (margin[y, x] >= 0), differ[-1]
    print(f"STAPLE L={length} {'rgb' if color else 'mono'}: {len(differ)} pixels differ from "
          f"echoflow (frame, y, x, float64 margin): {differ}")
    assert len(differ) <= 1e-4 * got.size


def test_mono_and_single_channel_paths_are_identical(engines):
    _, port = engines
    video = _video(45, False)
    auto = port.segment_video(video, num_clips=2, step=1, fuse_method="majority")
    pend, (length, width) = port.segment_video_async(video, num_clips=2, step=1,
                                                     fuse_method="majority", mono=False)
    rgb = TP._unpackbits(pend.numpy(), width)[:length]
    one = port.segment_video(video[:1], num_clips=2, step=1, fuse_method="majority")
    np.testing.assert_array_equal(auto, rgb)
    np.testing.assert_array_equal(one, rgb)
    # Pre-normalized float input gives the same masks as uint8.
    flt = port.segment_video(zeroone_normalizer(video.astype(np.float32)), num_clips=2,
                             step=1, fuse_method="majority")
    np.testing.assert_array_equal(flt, auto)


def test_segment_videos_streams_in_order(engines):
    _, port = engines
    videos = [_video(n, False) for n in (40, 64, 45, 40)]
    want = [port.segment_video(v, num_clips=2, step=1) for v in videos]
    got = list(port.segment_videos(videos, num_clips=2, step=1, queue_depth=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    alias = TP.segment_a_video_with_fusion(videos[0], port, num_clips=2, step=1)
    np.testing.assert_array_equal(alias, want[0])


def test_operand_cache_is_lru_bounded(shared_weights):
    port = TP.VideoSegmenter(state_dict_from_variables(shared_weights), device="cpu",
                             bucket=32, operand_cache_size=2, decoder="model")
    rng = np.random.RandomState(0)
    for length in (33, 37, 41):
        port.segment_video(rng.rand(3, length, 16, 16).astype(np.float32))
    assert len(port._operand_cache) == 2


def test_model_decoder_matches_kernel_decoder(engines, shared_weights):
    _, port = engines
    model_engine = TP.VideoSegmenter(state_dict_from_variables(shared_weights),
                                     device="cpu", forward_chunk=4, bucket=32,
                                     decoder="model")
    video = _video(45, False)
    a = port.segment_video(video, num_clips=2, step=1, fuse_method="simple")
    b = model_engine.segment_video(video, num_clips=2, step=1, fuse_method="simple")
    np.testing.assert_array_equal(a, b)


def test_default_device_is_cuda_and_raises_without_it(shared_weights):
    state = state_dict_from_variables(shared_weights)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.VideoSegmenter(state)
    cpu = TP.VideoSegmenter(state, device="cpu")
    assert cpu.dtype == torch.float32 and cpu.decoder == "kernel"
    with pytest.raises(ValueError):
        TP.VideoSegmenter(state, device="cpu", decoder="xla")


def test_kernel_decoder_needs_a_folded_model(shared_weights):
    state = state_dict_from_variables(shared_weights)
    with pytest.raises(ValueError, match="folded model"):
        TP.VideoSegmenter(state, device="cpu", fold_bn=False)
    unfolded = TP.VideoSegmenter(state, device="cpu", fold_bn=False, decoder="model")
    assert unfolded.decoder == "model" and not unfolded._model.folded
