"""The inference engine's device work as graphs (`VideoSegmenter._run` in
`echoflow_torch/infer/pipeline.py`) on the CPU, the capture stood in for
(`tests/test_torch_graph.py`'s `_CpuFunctionGraphs`: a capture runs the
function's Python once, a replay recomputes the graph's outputs from its
static inputs, so whatever the wrapper fails to feed shows).

The graphed engine's masks are bitwise the eager engine's and match
echoflow's `VideoSegmenter` as tests/test_torch_pipeline.py holds the eager
engine to it, for every fusion method, mono and RGB; one graph a key
(echoflow's jit key), shared by two lengths of one bucket; a replaced
parameter refused; the wrapper's LRU bound; and a capture in the middle of
`segment_videos`. The card runs the real capture: `tests/test_torch_cuda.py`
and `chip_smoke.py` phase 14b."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echoflow.infer import pipeline as JP

from echoflow_torch.infer import pipeline as TP
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.utils.graphs import model_graphs
from tests.test_torch_graph import _CpuFunctionGraphs
from tests.test_torch_pipeline import METHODS, _video, shared_weights  # noqa: F401 (a fixture)

torch.set_num_threads(2)

# 40 and 44 frames in a bucket of 32 frames: t_pad 64, 2 shifts of 1 clip
# each, one key; 64 frames: t_pad 64, 2 shifts of 2 clips, another key.
SHARED, OTHER = (40, 44), 64
CLIPS = dict(num_clips=2, step=1)


def _engines(weights, **kw):
    """(eager engine, graphed engine, its graph wrapper) on the CPU."""
    state = state_dict_from_variables(weights)
    eager = TP.VideoSegmenter(state, device="cpu", forward_chunk=4, bucket=32, **kw)
    port = TP.VideoSegmenter(state, device="cpu", forward_chunk=4, bucket=32, **kw)
    assert not isinstance(port._run, _CpuFunctionGraphs)    # the CPU runs the eager body
    port._run = graphed = model_graphs(port._run, port._model, wrapper=_CpuFunctionGraphs)
    return eager, port, graphed


@pytest.fixture(scope="module")
def engines(shared_weights):  # noqa: F811
    return _engines(shared_weights)


@pytest.mark.parametrize("color", [False, True], ids=["mono", "rgb"])
@pytest.mark.parametrize("method", METHODS)
def test_graphed_engine_masks_are_the_eager_engines_and_echoflows(shared_weights, method,  # noqa: F811
                                                                  color):
    """Three videos of one key (40, 44, 40 frames): a warm-up, a capture
    and a replay, each mask bitwise the eager engine's; against
    echoflow's engine (one jit of the key) equal, or for STAPLE within the
    1e-4 of the pixels that tests/test_torch_pipeline.py explains (float32
    rounding of echoflow's EM)."""
    eager, port, graphed = _engines(shared_weights)
    jax_engine = JP.VideoSegmenter(shared_weights, forward_chunk=4, bucket=32,
                                   dtype=jnp.float32)
    for length in SHARED + SHARED[:1]:
        video = _video(length, color)
        got = port.segment_video(video, fuse_method=method, **CLIPS)
        assert np.array_equal(got, eager.segment_video(video, fuse_method=method, **CLIPS))
        want = jax_engine.segment_video(video, fuse_method=method, **CLIPS)
        assert got.shape == want.shape == (length, 32, 32)
        if method == "staple":
            assert float((got != want).mean()) <= 1e-4
        else:
            assert np.array_equal(got, want)
    assert len(graphed.graphs) == 1 and (graphed.warm_ups, graphed.captures) == (1, 1)
    (key,) = graphed.graphs
    assert dict(key[1]) == dict(k_num=2, n_fwd=2, fuse_method=method, mono=not color)


def test_one_graph_for_each_key(engines):
    """Lengths of one bucket with the same number of forwarded clips share
    a graph (their operands are its inputs); another clip count, fusion
    method or channel count is another key. Each graph is captured once."""
    _, port, graphed = engines
    graphed.clear()
    captures = graphed.captures
    calls = [(n, "simple", False) for n in SHARED * 2] + [(OTHER, "simple", False)] * 2 \
        + [(SHARED[0], "majority", False)] * 2 + [(SHARED[0], "simple", True)] * 2
    for length, method, color in calls:
        port.segment_video(_video(length, color), fuse_method=method, **CLIPS)
    keys = [dict(k[1]) for k in graphed.graphs]
    assert [(k["n_fwd"], k["fuse_method"], k["mono"]) for k in keys] == [
        (2, "simple", True), (4, "simple", True), (2, "majority", True), (2, "simple", False)]
    assert graphed.captures - captures == len(graphed.graphs) == 4
    assert sorted(e.replays for e in graphed.graphs.values()) == [1, 1, 1, 3]


def test_a_replaced_parameter_is_refused(shared_weights):  # noqa: F811
    """A parameter replaced after the capture (a reload) is refused at the
    next replay of every graph, not read stale."""
    _, port, _ = _engines(shared_weights)
    video = _video(SHARED[0], False)
    for _ in range(2):
        port.segment_video(video, **CLIPS)
    head = port._model.segmentation_head
    head.weight = torch.nn.Parameter(head.weight.detach().clone(), requires_grad=False)
    with pytest.raises(RuntimeError, match="replaced since the capture"):
        port.segment_video(video, **CLIPS)


def test_the_engine_keeps_its_most_recently_used_graphs(engines):
    """With room for 2 graphs, a third key drops the graph used longest
    ago; that key warms up and captures again; every mask is the eager
    engine's."""
    eager, port, graphed = engines
    graphed.clear()
    graphed.max_graphs = 2
    captures = graphed.captures
    try:
        order = [(SHARED[0], "simple"), (OTHER, "simple"), (SHARED[0], "majority")]
        for length, method in order + order[:1]:
            for _ in range(2):
                video = _video(length, False)
                got = port.segment_video(video, fuse_method=method, **CLIPS)
                assert np.array_equal(got, eager.segment_video(video, fuse_method=method,
                                                               **CLIPS))
        assert [(dict(k[1])["n_fwd"], dict(k[1])["fuse_method"]) for k in graphed.graphs] == [
            (2, "majority"), (2, "simple")]
        assert graphed.captures - captures == 4
    finally:
        graphed.max_graphs = type(graphed).max_graphs


def test_a_capture_in_the_middle_of_segment_videos(engines):
    """`segment_videos` with 3 videos in flight over lengths whose key
    warms up, captures and replays while other videos' masks are being
    fetched: the eager engine's masks, in order."""
    eager, port, graphed = engines
    graphed.clear()
    captures, warm_ups = graphed.captures, graphed.warm_ups
    lengths = [OTHER, SHARED[0], OTHER, SHARED[1], OTHER, SHARED[0], SHARED[1]]
    videos = [_video(n, False) for n in lengths]
    want = [eager.segment_video(v, **CLIPS) for v in videos]
    got = list(port.segment_videos(videos, queue_depth=3, **CLIPS))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (graphed.captures - captures, graphed.warm_ups - warm_ups) == (2, 2)


def test_every_video_is_dispatched_on_the_engines_one_thread(shared_weights):  # noqa: F811
    """cuBLAS and cuDNN make their handles per thread, and a capture cannot:
    the engine runs every warm-up, capture and replay on one dispatch
    thread of its own, whether the videos come from `segment_video` on the
    caller's thread or another, or from `segment_videos`."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    eager, port, graphed = _engines(shared_weights)
    body, threads = graphed.fn, []

    def recorded(**kw):
        threads.append(threading.get_ident())
        return body(**kw)

    graphed.fn = recorded
    video = _video(SHARED[0], False)
    want = eager.segment_video(video, **CLIPS)
    assert np.array_equal(port.segment_video(video, **CLIPS), want)          # warm-up
    with ThreadPoolExecutor(max_workers=1) as other:
        assert np.array_equal(other.submit(port.segment_video, video, **CLIPS).result(), want)
    assert all(np.array_equal(m, want) for m in port.segment_videos([video] * 2, **CLIPS))
    assert (graphed.warm_ups, graphed.captures, len(threads)) == (1, 1, 5)
    assert len(set(threads)) == 1 and threads[0] != threading.get_ident()
