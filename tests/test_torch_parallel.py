"""Data parallelism of echoflow_torch on the CPU: the mesh helpers against
echoflow's, global BatchNorm and the data-parallel train step on 2 gloo
ranks against the port's single-process step on the whole batch (float64),
the batch-coupled smoothness, the same step against echoflow's jitted step
on `data_mesh(2)`, `train_clasfv_torch.py` under torchrun, and the six
cases of the multi-GPU dry run.

The ranks are spawned processes (`parallel/launch.run_ranks`, a `file://`
store in a fresh temporary directory); the functions they run live in
`echoflow_torch.parallel.dryrun`, since a spawned rank re-imports its
function's module and must import neither jax nor this file.

Bars of the 2-rank step against the single-process step, both in float64
(the model's outputs too, `output_dtype`), batch 4 = 2 ranks x 2, T 8,
32x32, two steps: the loss and its terms, the BatchNorm running
statistics and the ED/ES Dice within 1e-10 relative; each gradient leaf
within 1e-10 relative L2, leaves below 1e-4 of the largest held
absolutely, as `tests/test_torch_train.py` does; the parameters after the
two Adam updates within 1e-9 absolute. Adam amplifies rounding: an update
moves an element whose gradient is near its eps (1e-8) by up to
lr / (4 eps) = 2,500 times that gradient's rounding. Measured on these
echo-like clips: parameters after two updates 1.0e-10 (clasfv) and 1.4e-10
(ed_es_only), the second step's worst leaf 2.1e-11 and 3.2e-11.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from echoflow.parallel.mesh import data_mesh, host_shard_indices as jax_host_shard_indices
from echoflow.train.loop import TrainConfig as JaxConfig
from echoflow.train.loop import _loss_fn, create_train_state as jax_create_state
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.r2plus1d import create_model
from echoflow_torch.parallel import data_devices, host_shard_indices, init_distributed, shard_batch
from echoflow_torch.parallel.dryrun import (batchnorm_on_shard, dp_train_steps,
                                            dryrun_multigpu)
from echoflow_torch.parallel.launch import run_ranks
from echoflow_torch.train.loop import (TrainConfig, create_train_state,
                                       make_ed_es_only_train_step, make_train_step)

REPO = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(4)
T, S, N = 8, 32, 4
REL = 1e-10           # loss, terms, running statistics, Dice, gradient leaves
PARAM_ABS = 1e-9      # parameters after the two updates
ZERO_LEAF = 1e-4      # below this share of the largest leaf: 0 in exact arithmetic


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's `tmp_path`, removed after the test. The files written here
    hold the whole model (126 MB of weights; a checkpoint with Adam's
    state 362 MB), and pytest keeps the directories of its last three
    runs: left alone, they fill the disk that later checkpoints are saved
    to (`torch.save` then fails)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _batch(seed, motion="disc"):
    """Echo-like clips (a disc contracting over the clip, with noise) with
    ED/ES labels and indices inside the clip. motion="split": the first two
    samples are flat frames, the last two fresh noise every frame."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    disc = lambda r: (((yy - S / 2) ** 2 + (xx - S / 2) ** 2) <= r * r)   # noqa: E731
    video = np.empty((N, 3, T, S, S))
    for i in range(N):
        for k in range(T):
            if motion == "split" and i < 2:
                video[i, :, k] = 0.4
            elif motion == "split":
                video[i, :, k] = rng.rand(S, S)
            else:
                video[i, :, k] = 0.2 + 0.6 * disc(S / 3 - S / 6 * k / (T - 1)) \
                    + 0.05 * rng.randn(S, S)
    return {"video": np.clip(video, 0, 1).astype(np.float32),
            "ed_label": np.stack([disc(S / 3 + i) for i in range(N)]).astype(np.int32),
            "es_label": np.stack([disc(S / 6 + i) for i in range(N)]).astype(np.int32),
            "ed_idx": np.array([1, 0, 2, 0], np.int32), "es_idx": np.array([6, 7, 5, 7], np.int32)}


def _ed_es(batch):
    return {"ed_video": batch["video"], "es_video": batch["video"][:, :, ::-1].copy(),
            **{k: batch[k] for k in ("ed_label", "es_label", "ed_idx", "es_idx")}}


def _single_steps(state_dict, batches, recipe):
    """The port's single-process steps on the whole batches, float64."""
    state = create_train_state(0, TrainConfig(clip_length=T, image_size=(S, S), batch_size=N),
                               device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state.model.double().output_dtype = torch.float64
    step = make_train_step() if recipe == "clasfv" else make_ed_es_only_train_step()
    out = {"history": [], "grads": []}
    for b in batches:
        b = {k: torch.from_numpy(v.astype(np.float64) if "video" in k else v)
             for k, v in b.items()}
        state, m = step(state, b)
        out["history"].append({k: float(v) for k, v in m.items()})
        out["grads"].append({k: p.grad.detach().clone() for k, p in
                             state.model.named_parameters()})
    out["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    return out


def _check_against_single(dp, single, params=True):
    """The bars of the module docstring (the parameters' only with
    `params`); returns what was measured."""
    measured = {"terms": 0.0, "leaf": [], "zero": 0.0}
    for i, (got, want) in enumerate(zip(dp["history"], single["history"])):
        assert got.keys() == want.keys()
        for k, v in want.items():
            err = abs(got[k] - v) / abs(v)
            measured["terms"] = max(measured["terms"], err)
            assert err <= REL, (i, k, got[k], v)
        grads = single["grads"][i]
        top = max(float(g.norm()) for g in grads.values())
        worst = 0.0
        for name, g in grads.items():
            mine = torch.from_numpy(dp["grads"][i][name])
            if float(g.norm()) > ZERO_LEAF * top:
                err = float((mine - g).norm() / g.norm())
                worst = max(worst, err)
                assert err <= REL, (i, name, err)
            else:   # zero in exact arithmetic
                measured["zero"] = max(measured["zero"], float(mine.norm()) / top)
                assert float(mine.norm()) <= ZERO_LEAF * top, (i, name)
        measured["leaf"].append(worst)
    measured["params"] = measured["stats"] = 0.0
    for name, want in single["state"].items():
        got = torch.from_numpy(dp["state"][name])
        if "running" in name:
            err = float((got - want).abs().max() / want.abs().max())
            measured["stats"] = max(measured["stats"], err)
            assert err <= REL, name
        elif params and "num_batches" not in name:
            err = float((got - want).abs().max())
            measured["params"] = max(measured["params"], err)
            assert err <= PARAM_ABS, name
    return measured


# ------------------------------------------------------------------ mesh helpers

def test_host_shard_indices_match_echoflow():
    for total in range(0, 23):
        for count in range(1, 9):
            for index in range(count):
                assert host_shard_indices(total, index, count) == \
                    jax_host_shard_indices(total, index, count), (total, index, count)
    assert host_shard_indices(10) == range(0, 10)   # no group: one rank


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_shard_batch_is_the_data_axis_layout(world):
    """Rank r's rows are the shard `P("data")` puts on device r."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sharded = jax.device_put(x, NamedSharding(data_mesh(world), P("data")))
    devices = list(data_mesh(world).devices)
    for shard in sharded.addressable_shards:
        rank = devices.index(shard.device)
        np.testing.assert_array_equal(shard_batch({"x": x}, rank, world)["x"],
                                      np.asarray(shard.data))
    if world > 1:
        with pytest.raises(ValueError, match="multiple"):
            shard_batch({"x": np.zeros((world + 1, 3))}, 0, world)


def test_data_devices_and_single_process_init():
    assert data_devices(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        assert data_devices(3) == [torch.device("cpu")] * 3
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_devices(devices=["cuda:0"])
    with pytest.raises(ValueError):
        data_devices(devices=["meta"])
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE") if k in os.environ}
    try:
        assert init_distributed() is False   # one process, no torchrun: no group
    finally:
        os.environ.update(env)


# ------------------------------------------------------------------ BatchNorm

def test_global_batchnorm_equals_one_process():
    """2 ranks of the port's BatchNorm3d (float64) under a group against one
    process on the concatenated batch: output, d_input, d_weight, d_bias
    (summed over the ranks) and the running statistics (flax's biased
    update), within 1e-12."""
    from echoflow_torch.models.r2plus1d import BatchNorm3d

    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 3, 7, 5) * 3.0 + 1.5
    g = rng.randn(*x.shape)
    params = dict(weight=rng.rand(6) + 0.5, bias=rng.randn(6), running_mean=rng.randn(6),
                  running_var=rng.rand(6) + 0.5)
    ranks = run_ranks(batchnorm_on_shard, 2, x, g, params)

    bn = BatchNorm3d(6).double().train()
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    y.backward(torch.from_numpy(g))
    want = {"y": y.detach().numpy(), "dx": xt.grad.numpy()}
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in ranks]), want[key],
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(sum(r["dweight"] for r in ranks), bn.weight.grad.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sum(r["dbias"] for r in ranks), bn.bias.grad.numpy(),
                               rtol=0, atol=1e-12)
    for r in ranks:   # the biased global variance, on every rank
        np.testing.assert_allclose(r["running_mean"], bn.running_mean.numpy(), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["running_var"], bn.running_var.numpy(), rtol=0,
                                   atol=1e-12)
    biased = x.transpose(1, 0, 2, 3, 4).reshape(6, -1).var(axis=1)
    np.testing.assert_allclose(ranks[0]["running_var"], 0.9 * params["running_var"]
                               + 0.1 * biased, rtol=1e-12)


# ------------------------------------------------------------------ train step

@pytest.mark.parametrize("recipe", ["clasfv", "ed_es_only"])
def test_two_rank_step_equals_one_process_step(recipe, tmp_path):
    """Two steps of `fit_on_mesh` on 2 gloo ranks against two single-process
    steps on the whole batch (module docstring's bars); rank 0 alone logs,
    and the two ranks end with the same state."""
    state_dict = {k: v.numpy() for k, v in create_model(seed=0).state_dict().items()}
    batches = [_batch(0), _batch(1)]
    if recipe == "ed_es_only":
        batches = [_ed_es(b) for b in batches]
    log = tmp_path / "metrics.jsonl"
    ranks = run_ranks(dp_train_steps, 2, state_dict, batches, recipe, "float64", str(log),
                      threads=3)
    single = _single_steps(state_dict, batches, recipe)
    measured = _check_against_single(ranks[0], single)
    assert ranks[0]["leaf_sums"] == ranks[1]["leaf_sums"] and ranks[1]["step"] == 2
    assert ranks[1]["lines"] == [] and len(ranks[0]["lines"]) == 2
    from echoflow_torch.utils.metrics_log import MetricsLogger

    rows = MetricsLogger(str(log)).read()
    assert [r["step"] for r in rows] == [1, 2]
    assert abs(rows[1]["loss"] - single["history"][1]["loss"]) <= REL * single["history"][1]["loss"]
    print(f"2 ranks vs one process ({recipe}, float64): terms {measured['terms']:.1e}, "
          f"worst leaf per step {measured['leaf']}, zero leaves {measured['zero']:.1e}, "
          f"running stats {measured['stats']:.1e}, parameters {measured['params']:.1e}")


def test_coupled_smoothness_is_the_global_batchs():
    """Two shards with very different motion (flat frames on rank 0, noise on
    rank 1, the motion head x30): the mean of the per-rank OTA terms, each
    with its own shard's smoothness, misses the global value by far more
    than 100 x the bar; the data-parallel step holds it: loss, terms,
    every gradient leaf and the running statistics. The parameters after
    the update are not held here: on these noise clips Adam's eps
    amplification (module docstring) moves one by 1.7e-9; the gradients
    that carry the coupling agree within 1e-10 (measured 7.6e-12)."""
    model = create_model(seed=0)
    state_dict = {k: v.numpy() for k, v in model.state_dict().items()}
    state_dict["motion_head.weight"] = state_dict["motion_head.weight"] * 30.0
    batch = _batch(2, motion="split")
    ranks = run_ranks(dp_train_steps, 2, state_dict, [batch], "clasfv", "float64",
                      threads=3)
    single = _single_steps(state_dict, [batch], "clasfv")
    _check_against_single(ranks[0], single, params=False)
    halves = [_single_steps(state_dict, [shard_batch(batch, r, 2)], "clasfv")["history"][0]
              for r in range(2)]
    per_rank = np.mean([h["ota"] for h in halves])
    gap = abs(per_rank - single["history"][0]["ota"]) / single["history"][0]["ota"]
    print(f"OTA: global {single['history'][0]['ota']:.6f}, mean of the per-rank values "
          f"{per_rank:.6f} (relative gap {gap:.1e}); data-parallel "
          f"{ranks[0]['history'][0]['ota']:.6f}")
    assert gap > 100 * REL


def test_two_rank_step_matches_echoflow_data_mesh():
    """The 2-rank fused step in float64 against echoflow's jitted step on
    `data_mesh(2)` (batch sharded on `data`, state replicated, as
    `__graft_entry__.py:120-123`), echoflow's model in float64: loss and
    terms, every gradient leaf and the BatchNorm statistics within 1e-6
    relative, the bar of `tests/test_torch_train.py` (echoflow's model
    returns float32 outputs, the port's here float64)."""
    cfg = JaxConfig(lr=1e-4, clip_length=T, image_size=(S, S), batch_size=N)
    _, state, tx = jax_create_state(jax.random.PRNGKey(0), cfg, input_shape=(1, 3, T, S, S))
    batch = _batch(3)
    from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet

    mesh = data_mesh(2)
    bsh, rsh = NamedSharding(mesh, P("data")), NamedSharding(mesh, P())
    with jax.enable_x64(True):
        cast = lambda tree: jax.tree.map(   # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a, tree)
        model = FlaxNet(dtype=jnp.float64)

        def step(params, stats, batch):
            (total, (aux, stats)), grads = jax.value_and_grad(
                lambda p: _loss_fn(p, stats, model, batch, False, True), has_aux=True)(params)
            return total, {k: v for k, v in aux.items() if v.ndim == 0}, grads, stats

        jb = {k: jax.device_put(jnp.asarray(v.astype(np.float64) if k == "video" else v), bsh)
              for k, v in batch.items()}
        total, aux, grads, stats = jax.jit(step, in_shardings=(rsh, rsh, bsh))(
            jax.device_put(cast(state.params), rsh), jax.device_put(cast(state.batch_stats), rsh),
            jb)
        want = {"loss": float(total), **{k: float(v) for k, v in aux.items()}}
        grads, stats = jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, stats)

    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    state_dict = {k: v.numpy() for k, v in state_dict_from_variables(variables).items()}
    dp = run_ranks(dp_train_steps, 2, state_dict, [batch], "clasfv", "float64", threads=3)[0]
    for k, v in want.items():
        np.testing.assert_allclose(dp["history"][0][k], v, rtol=1e-6, err_msg=k)
    g32 = state_dict_from_variables(jax.tree.map(lambda a: a.astype(np.float32), grads),
                                    params_only=True)
    g_lo = state_dict_from_variables(jax.tree.map(
        lambda a: a - a.astype(np.float32).astype(np.float64), grads), params_only=True)
    jg = {k: v.double() + g_lo[k].double() for k, v in g32.items()}
    top = max(float(g.norm()) for g in jg.values())
    worst = 0.0
    for name, g in jg.items():
        mine = torch.from_numpy(dp["grads"][0][name])
        if float(g.norm()) > ZERO_LEAF * top:
            worst = max(worst, float((mine - g).norm() / g.norm()))
        else:
            assert float(mine.norm()) <= ZERO_LEAF * top, name
    assert worst <= 1e-6
    jstats = state_dict_from_variables({"params": jax.tree.map(
        lambda a: a.astype(np.float32), grads), "batch_stats": stats})
    stat_err = max(float(np.abs(dp["state"][k] - jstats[k].double().numpy()).max()
                         / np.abs(jstats[k].double().numpy()).max())
                   for k in jstats if "running" in k)
    assert stat_err <= 1e-6
    print(f"2 ranks vs echoflow data_mesh(2): loss {dp['history'][0]['loss']:.8f} vs "
          f"{want['loss']:.8f}, worst leaf {worst:.1e}, running stats {stat_err:.1e}")


# ------------------------------------------------------------------ entry points

def test_train_clasfv_torch_under_torchrun(tmp_path):
    """`torchrun --standalone --nproc_per_node 2 train_clasfv_torch.py`: the
    global batch of 2 is sharded 1 + 1, rank 0 prints and writes the
    checkpoints, whose keys carry no DDP prefix and load into the
    single-device trainer."""
    from echoflow_torch.train import checkpoint as ck

    out = tmp_path / "ck.pth"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", str(REPO / "train_clasfv_torch.py"), "--synthetic", "--device", "cpu",
           "--epochs", "1", "--steps", "2", "--batch-size", "2", "--image-size", "24",
           "--clip-length", "8", "--log-every", "1", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:   # pytest.fail: an assert's message would be cut short
        pytest.fail(f"torchrun exited {proc.returncode}\n--- stdout\n{proc.stdout[-2000:]}\n"
                    f"--- stderr\n{proc.stderr[-8000:]}")
    assert proc.stdout.count("epoch 0: val loss") == 1     # rank 0 alone prints
    assert proc.stdout.count("step 2:") == 1
    payload = ck.load_checkpoint(str(out) + ".last")
    assert payload["step"] == 2 and not any(k.startswith("module.") for k in payload["model"])
    state = create_train_state(0, TrainConfig(clip_length=8, image_size=(24, 24),
                                              batch_size=2), device="cpu")
    state, extra = ck.restore_train_state(str(out) + ".last", state)
    assert state.step == 2 and extra["epoch"] == 0
    from echoflow_torch.infer.pipeline import VideoSegmenter

    engine = VideoSegmenter(payload["model"], device="cpu", bucket=32)
    video = (np.random.RandomState(0).rand(3, 40, 24, 24) * 255).astype(np.uint8)
    assert engine.segment_video(video).shape == (40, 24, 24)


def test_dryrun_multigpu_gloo_passes_all_six_cases():
    lines = dryrun_multigpu(2, "gloo")
    assert len(lines) == 6 and all(" ok" in line for line in lines), lines
    assert lines[0].startswith("dryrun_multigpu(2): clasfv train ok")
