"""echoflow_torch model, weight conversion and BN folding against echoflow.

The flax model is the oracle: its variables go through the port's
converter, and both forwards run on the same numpy input."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.models.convert import convert_kinetics_backbone, convert_state_dict
from echoflow.models.fold_bn import fold_variables
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables
from echoflow.models.r2plus1d import midplanes as flax_midplanes

from echoflow_torch.models.convert import (
    BACKBONE_PREFIX,
    load_kinetics_backbone,
    load_reference_state_dict,
    state_dict_from_variables,
    strip_module_prefix,
    variables_from_state_dict,
)
from echoflow_torch.models.fold_bn import fold_state_dict, is_folded
from echoflow_torch.models.r2plus1d import (
    BatchNorm3d,
    R2Plus1DMotionSegNet,
    create_model,
    midplanes,
    param_count,
)

torch.set_num_threads(2)


def _randomize_bn(variables, seed=0):
    """Random BN scale/bias/mean/var so that wiring mistakes cannot hide
    behind the identity init."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def walk(p, s):
        for k in s:
            if "mean" in s[k]:
                n = s[k]["mean"].shape
                s[k]["mean"] = (rng.randn(*n) * 0.05).astype(np.float32)
                s[k]["var"] = rng.uniform(0.7, 1.4, n).astype(np.float32)
                p[k]["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
                p[k]["bias"] = (rng.randn(*n) * 0.05).astype(np.float32)
            else:
                walk(p[k], s[k])

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's `tmp_path`, removed after the test. The files written here
    hold the whole model (126 MB of weights; a checkpoint with Adam's
    state 362 MB), and pytest keeps the directories of its last three
    runs: left alone, they fill the disk that later checkpoints are saved
    to (`torch.save` then fails)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def flax_variables():
    v = init_variables(jax.random.PRNGKey(0), FlaxNet(), (1, 3, 8, 16, 16))
    return _randomize_bn(v)


@pytest.fixture(scope="module")
def port_state(flax_variables):
    return state_dict_from_variables(flax_variables)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_param_count_and_midplanes():
    assert param_count(create_model(seed=0)) == 31_575_731
    for cin, cout in ((64, 64), (64, 128), (128, 256), (256, 512), (512, 512)):
        assert midplanes(cin, cout) == flax_midplanes(cin, cout)


def test_seeded_init_is_reproducible():
    a, b = create_model(seed=5).state_dict(), create_model(seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = create_model(seed=5).motion_head.weight.detach()
    # motion head N(0, sqrt(1e-5)): sample std within 15% on 256 draws
    assert 0.85 * np.sqrt(1e-5) < float(w.std()) < 1.15 * np.sqrt(1e-5)


def test_converter_round_trip(flax_variables, port_state):
    # The state dict loads strictly into the port's module ...
    R2Plus1DMotionSegNet().load_state_dict(port_state, strict=True)
    # ... and echoflow's forward converter maps it back bit for bit.
    back = convert_state_dict({f"module.{k}": v for k, v in port_state.items()})
    want = dict(_leaves(flax_variables))
    got = dict(_leaves(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))


def test_converter_rejects_drift(flax_variables):
    bad = {"params": dict(flax_variables["params"]),
           "batch_stats": flax_variables["batch_stats"]}
    bad["params"]["extra_layer"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="unconverted"):
        state_dict_from_variables(bad)
    missing = {"params": dict(flax_variables["params"]),
               "batch_stats": flax_variables["batch_stats"]}
    del missing["params"]["seg_head"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_variables(missing)


def test_load_reference_state_dict(tmp_path, port_state):
    path = tmp_path / "ref.pth"
    torch.save({"model": {f"module.{k}": v for k, v in port_state.items()},
                "optimizer": {}}, path)
    loaded = load_reference_state_dict(str(path))
    assert set(loaded) == set(port_state)
    assert all(torch.equal(loaded[k], port_state[k]) for k in port_state)
    assert strip_module_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_unfolded_forward_matches_flax(flax_variables, port_state):
    x = np.random.RandomState(0).rand(1, 3, 8, 32, 32).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        seg_j, mot_j = jax.jit(lambda v, x: FlaxNet().apply(v, x, train=False))(
            flax_variables, jnp.asarray(x))
    model = R2Plus1DMotionSegNet()
    model.load_state_dict(port_state)
    with torch.no_grad():
        seg_t, mot_t = model.eval()(torch.from_numpy(x))
    # The tolerance of tests/test_convert.py:146: fp32 reassociation across
    # 18 conv layers in two frameworks, not a wiring difference.
    np.testing.assert_allclose(seg_t.numpy(), np.asarray(seg_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mot_t.numpy(), np.asarray(mot_j), rtol=1e-3, atol=1e-4)


def test_fold_matches_echoflow_fold(flax_variables, port_state):
    folded = fold_state_dict(port_state)
    want = state_dict_from_variables(fold_variables(flax_variables))
    assert is_folded(folded) and not is_folded(port_state)
    assert set(folded) == set(want)
    for k in want:   # same float32 arithmetic in the same order: bitwise
        assert torch.equal(folded[k], want[k]), k


def test_folded_module_matches_unfolded(port_state):
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 8, 32, 32).astype(np.float32))
    unfolded = R2Plus1DMotionSegNet()
    unfolded.load_state_dict(port_state)
    folded = R2Plus1DMotionSegNet(folded=True)
    folded.load_state_dict(fold_state_dict(port_state), strict=True)
    with torch.no_grad():
        a = unfolded.eval()(x)
        b = folded.eval()(x)
    # Folding reassociates (x*W)*s as x*(W*s): fp32 rounding only.
    for u, f in zip(a, b):
        np.testing.assert_allclose(f.numpy(), u.numpy(), rtol=1e-4, atol=1e-5)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg="/".join(path))


def test_variables_from_state_dict_inverts_the_converter(flax_variables, port_state):
    """State dict -> flax tree is the exact inverse, for unfolded and folded
    trees and for a tree shaped like `params` alone (Adam's moments)."""
    _assert_trees_equal(variables_from_state_dict(port_state), flax_variables)
    params = flax_variables["params"]
    moments = state_dict_from_variables(params, params_only=True)
    assert set(moments) == {k for k, _ in R2Plus1DMotionSegNet().named_parameters()}
    _assert_trees_equal(variables_from_state_dict(moments, params_only=True), params)
    folded = jax.tree.map(np.asarray, fold_variables(flax_variables))
    _assert_trees_equal(variables_from_state_dict(state_dict_from_variables(folded)), folded)
    with pytest.raises(KeyError, match="unconverted"):
        variables_from_state_dict({**port_state, "extra.weight": torch.zeros(1)})


def test_load_kinetics_backbone_equals_echoflows(tmp_path, flax_variables, port_state):
    """A stock torchvision r2plus1d_18 state dict (the backbone's keys
    without the `r2plus1d_model.` prefix, made here from other weights)
    replaces the backbone and the unused fc and leaves the heads: the same
    result as echoflow's `convert_kinetics_backbone`."""
    other = state_dict_from_variables(_randomize_bn(
        init_variables(jax.random.PRNGKey(1), FlaxNet(), (1, 3, 8, 16, 16)), seed=1))
    stock = {k[len(BACKBONE_PREFIX):]: v for k, v in other.items()
             if k.startswith(BACKBONE_PREFIX)}
    path = tmp_path / "r2plus1d_18.pth"
    torch.save(stock, path)
    got = load_kinetics_backbone(str(path), port_state)
    want = state_dict_from_variables(convert_kinetics_backbone(stock, flax_variables))
    assert set(got) == set(port_state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["segmentation_head.weight"], port_state["segmentation_head.weight"])
    assert torch.equal(got["r2plus1d_model.stem.0.weight"], other["r2plus1d_model.stem.0.weight"])

    torch.save(dict(stock, **{"segmentation_head.weight": torch.zeros(1)}), path)
    with pytest.raises(KeyError, match="non-backbone"):
        load_kinetics_backbone(str(path), port_state)
    partial = {k: v for k, v in stock.items() if not k.startswith("layer4")}
    torch.save(partial, path)
    with pytest.raises(ValueError, match="full backbone"):
        load_kinetics_backbone(str(path), port_state)


def test_train_mode_batchnorm_updates_like_flax():
    """Training-mode BatchNorm normalizes with the batch statistics and
    moves the running statistics toward the batch mean and the *biased*
    batch variance, as flax's BatchNorm(momentum=0.9) does. torch's own
    module would use the unbiased variance, 8/7 larger here (8 values per
    channel, the layer4 case of a (2, 3, 8, 32, 32) batch)."""
    import flax.linen as fnn

    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 1, 2, 2).astype(np.float32) * 3 + 1
    bn = BatchNorm3d(5, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    mean0, var0 = bn.running_mean.numpy().copy(), bn.running_var.numpy().copy()
    y = bn(torch.from_numpy(x)).detach().numpy()

    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))   # channels last
    variables = {"params": {"scale": jnp.ones(5), "bias": jnp.zeros(5)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    yf, upd = flax_bn.apply(variables, xl, mutable=["batch_stats"])
    np.testing.assert_allclose(y, np.moveaxis(np.asarray(yf), -1, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    biased = x.var(axis=(0, 2, 3, 4))
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * biased, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
