"""echoflow_torch.ops.fusion against echoflow.ops.fusion: identical masks
from every fuser, on random stacks with live masks and on the fixture
stacks of echoflow.data.fixtures."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.data.fixtures import make_fusion_rater_stacks
from echoflow.ops import fusion as JF

from echoflow_torch.ops import fusion as TF

torch.set_num_threads(2)

STACKS = make_fusion_rater_stacks(56, 56)


def _random_stack(seed, t, r, h=24, w=24, flip=0.15):
    """(T, R, H, W) noisy copies of a disk, plus a (T, R) live mask whose
    rows include 0 and 1 live raters."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    truth = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) <= (h / 3) ** 2).astype(np.uint8)
    stack = np.empty((t, r, h, w), np.uint8)
    for i in range(t):
        for j in range(r):
            m = truth.copy()
            f = rng.rand(h, w) < flip * (1 + j % 3)
            m[f] = 1 - m[f]
            stack[i, j] = m
    valid = (rng.rand(t, r) < 0.7).astype(np.float32)
    valid[0] = 0.0
    valid[1] = 0.0
    valid[1, r - 1] = 1.0
    valid[2] = 1.0
    return stack, valid


@pytest.mark.parametrize("name,stack", STACKS, ids=[n for n, _ in STACKS])
def test_unbatched_fusers_match_fixture_stacks(name, stack):
    s = torch.from_numpy(stack)
    js = jnp.asarray(stack)
    np.testing.assert_array_equal(TF.majority_vote(s).numpy(), np.asarray(JF.majority_vote(js)))
    np.testing.assert_array_equal(TF.simple_fuse(s).numpy(), np.asarray(JF.simple_fuse(js)))
    np.testing.assert_array_equal(TF.staple_fuse(s).numpy(), np.asarray(JF.staple_fuse(js)))
    np.testing.assert_array_equal(TF.staple_fuse(s, undecided_label=2).numpy(),
                                  np.asarray(JF.staple_fuse(js, undecided_label=2)))


@pytest.mark.parametrize("method", ["majority", "simple", "staple"])
@pytest.mark.parametrize("seed,t,r", [(0, 6, 5), (1, 5, 3), (2, 4, 10)])
def test_fuse_frames_matches(method, seed, t, r):
    stack, valid = _random_stack(seed, t, r)
    got = TF.fuse_frames(torch.from_numpy(stack), torch.from_numpy(valid), method=method)
    want = JF.fuse_frames(jnp.asarray(stack), jnp.asarray(valid), method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0].any()                                  # zero live: background
    np.testing.assert_array_equal(got[1].numpy(), stack[1, r - 1])   # one live: copied


@pytest.mark.parametrize("seed", [0, 1])
def test_live_masked_fusers_match(seed):
    stack, valid = _random_stack(seed + 10, 4, 5)
    valid[:2] = 1.0   # the unbatched fusers need >= 1 live rater
    valid[2, :2] = 0.0
    s, v = torch.from_numpy(stack), torch.from_numpy(valid)
    for i in range(4):
        js, jv = jnp.asarray(stack[i]), jnp.asarray(valid[i])
        np.testing.assert_array_equal(TF.majority_vote(s[i], v[i]).numpy(),
                                      np.asarray(JF.majority_vote(js, jv)))
        np.testing.assert_array_equal(TF.simple_fuse(s[i], live=v[i]).numpy(),
                                      np.asarray(JF.simple_fuse(js, live=jv)))
        np.testing.assert_array_equal(TF.staple_fuse(s[i], live=v[i]).numpy(),
                                      np.asarray(JF.staple_fuse(js, live=jv)))
    # The batched call equals the per-frame calls.
    batched = TF.simple_fuse(s, live=v)
    for i in range(4):
        assert torch.equal(batched[i], TF.simple_fuse(s[i], live=v[i]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_softmax_mean_matches(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(6, 5, 2, 16, 16).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    valid = (rng.rand(6, 5) < 0.6).astype(np.float32)
    valid[:, 0] = 1.0
    got = TF.softmax_mean_fuse(torch.from_numpy(probs), torch.from_numpy(valid))
    want = jax.vmap(JF.softmax_mean_fuse)(jnp.asarray(probs), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TF.softmax_mean_fuse(torch.from_numpy(probs[0])).numpy(),
                                  np.asarray(JF.softmax_mean_fuse(jnp.asarray(probs[0]))))


def test_simple_defaults_are_the_contract():
    import inspect

    sig = inspect.signature(TF.simple_fuse)
    assert sig.parameters["num_iters"].default == 5
    assert sig.parameters["alpha"].default == 1.0
    assert inspect.signature(TF.staple_fuse).parameters["num_iters"].default == 30


def test_unknown_method_raises():
    stack, valid = _random_stack(0, 3, 3)
    with pytest.raises(ValueError):
        TF.fuse_frames(torch.from_numpy(stack), torch.from_numpy(valid), method="vote")
