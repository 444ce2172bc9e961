"""`ClipForward`'s chunk forward as graphs (`echoflow_torch/infer/clips.py`)
on the CPU, the capture stood in for (`tests/test_torch_graph.py`'s
`_CpuFunctionGraphs`: a capture runs the function's Python once, a replay
recomputes the graph's outputs from its static inputs): 5 clips by 2, so
two keys (chunks of 2 and the last chunk of 1); the outputs of every call
bitwise the eager forward's, and within the tolerance of
tests/test_torch_clips.py of echoflow's `ClipForward`. The card runs the
real capture: `tests/test_torch_cuda.py` and `chip_smoke.py` phase 14c."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echoflow.infer import clips as JC

from echoflow_torch.infer import clips as TC
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.utils.graphs import model_graphs
from tests.test_torch_clips import TOL, _clips, weights  # noqa: F401 (a fixture)
from tests.test_torch_graph import _CpuFunctionGraphs

torch.set_num_threads(2)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "module"])
def test_graphed_clip_forward_is_the_eager_forward(weights, fold_bn):  # noqa: F811
    clips = _clips(5)
    want = JC.ClipForward(weights, dtype=jnp.float32, forward_chunk=2, fold_bn=fold_bn)(clips)
    state = state_dict_from_variables(weights)
    eager = TC.ClipForward(state, device="cpu", forward_chunk=2, fold_bn=fold_bn)
    assert not isinstance(eager._forward, _CpuFunctionGraphs)   # the CPU runs it eagerly
    ref = eager(clips)
    port = TC.ClipForward(state, device="cpu", forward_chunk=2, fold_bn=fold_bn)
    port._forward = graphed = model_graphs(port._forward, port._model,
                                          wrapper=_CpuFunctionGraphs)
    calls = [port(clips) for _ in range(3)]
    # Chunks of 2: warm-up, capture, replays; the last chunk of 1: warm-up
    # at the first call, capture at the second.
    assert len(graphed.graphs) == 2
    assert (graphed.warm_ups, graphed.captures) == (2, 2)
    assert sorted(e.replays for e in graphed.graphs.values()) == [2, 5]
    for got in calls:
        assert [g.shape for g in got] == [(5, 2, 32, 32, 32), (5, 4, 32, 32, 32)]
        for g, r, w in zip(got, ref, want):
            assert np.array_equal(g, r)
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
