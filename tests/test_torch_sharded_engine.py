"""The engine sharded over devices (`VideoSegmenter(devices=...)`, the port
of echoflow's `mesh` argument) on the CPU: fp32 masks identical to
echoflow's mesh engine, 2 and 3 shards, SIMPLE and softmax, and the uneven
33-frame video whose one valid clip is padded to a multiple of the
devices; the chunk plan against echoflow's for every (clips, chunk,
devices) of a grid.

The weights are echoflow's init at PRNGKey(3) with the seg head x50, the
tiny model of `tests/test_pipeline.py:186-210`, with the head bias centred
as `tests/test_torch_pipeline.py` centres it (the uncentred masks are
~99.9% foreground and would hide a disagreement)."""

import numpy as np
import pytest
import torch

import jax

from echoflow.data.synthetic import make_beating_video
from echoflow.infer import pipeline as JP
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables
from echoflow.parallel.mesh import data_mesh

from echoflow_torch.infer import pipeline as TP
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet
from echoflow_torch.ops.normalize import zeroone_normalizer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
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


_ENGINES: dict = {}


def _engines(weights, n_port, n_mesh):
    """echoflow's mesh engine over n_mesh virtual devices and the port's over
    n_port CPU shards, both with one clip a device a chunk (echoflow's
    sharded dry-run setting); built once per pair."""
    key = (n_port, n_mesh)
    if key not in _ENGINES:
        _ENGINES[key] = (
            JP.VideoSegmenter(weights, forward_chunk=1, bucket=32, mesh=data_mesh(n_mesh)),
            TP.VideoSegmenter(state_dict_from_variables(weights), devices=["cpu"] * n_port,
                              forward_chunk=1, bucket=32))
    return _ENGINES[key]


@pytest.mark.parametrize("n_port,n_mesh", [(2, 2), (3, 8)], ids=["2-shards", "3-shards"])
@pytest.mark.parametrize("length,fuse", [(45, "simple"), (45, "softmax"), (33, "simple")],
                         ids=["simple", "softmax", "uneven-1-clip"])
def test_sharded_engine_masks_equal_echoflow_mesh(weights, n_port, n_mesh, length, fuse):
    jax_engine, port = _engines(weights, n_port, n_mesh)
    beat = make_beating_video(num_frames=length, height=32, width=32, period=20.0, seed=2)
    video = beat.video.astype(np.uint8)
    want = jax_engine.segment_video(video, num_clips=2, step=1, fuse_method=fuse)
    got = port.segment_video(video, num_clips=2, step=1, fuse_method=fuse)
    assert got.shape == want.shape == (length, 32, 32)
    assert 0.2 < want.mean() < 0.8
    np.testing.assert_array_equal(got, want)
    # One replica: every shard of ["cpu"] * n runs on the same module.
    assert len(port._replicas) == 1 and port.device == torch.device("cpu")


def test_sharded_engine_equals_the_unsharded_engine(weights):
    state = state_dict_from_variables(weights)
    single = TP.VideoSegmenter(state, device="cpu", forward_chunk=4, bucket=32)
    sharded = TP.VideoSegmenter(state, devices=["cpu", "cpu"], forward_chunk=2, bucket=32)
    video = make_beating_video(num_frames=70, height=32, width=32, period=20.0,
                               seed=5).video.astype(np.uint8)
    np.testing.assert_array_equal(sharded.segment_video(video, num_clips=3, step=2),
                                  single.segment_video(video, num_clips=3, step=2))


def test_chunk_plan_matches_echoflow():
    class _FakeMesh:
        def __init__(self, n):
            self.shape = {"data": n}

    for n_dev in (1, 2, 3, 4, 8):
        for forward_chunk in (1, 2, 4, 30):
            jseg = object.__new__(JP.VideoSegmenter)
            jseg.forward_chunk, jseg.mesh = forward_chunk, _FakeMesh(n_dev)
            tseg = object.__new__(TP.VideoSegmenter)
            tseg.forward_chunk, tseg.devices = forward_chunk, ["cpu"] * n_dev
            for n_fwd in range(1, 130):
                plan = tseg._chunk_plan(n_fwd)
                assert plan == jseg._chunk_plan(n_fwd), (n_fwd, forward_chunk, n_dev)
                assert plan[1] % n_dev == 0 and plan[2] >= n_fwd


def test_devices_are_checked(weights):
    state = state_dict_from_variables(weights)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.VideoSegmenter(state, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        TP.VideoSegmenter(state, devices=["cpu", "meta"])
