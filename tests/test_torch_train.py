"""The port's training (echoflow_torch.train) on the CPU: one full-model
train step against echoflow's from the same weights and batch, the LR
schedule, convergence, the eval step, checkpoints (the port's own and
echoflow's `.pkl`), and `train_clasfv_torch.py`.

echoflow's step is compiled once per module: the fused schedule in
float64 (echoflow's model built with dtype=float64 under
`jax.enable_x64`). The port's step is held against it twice:

  - fused, float64 (the port's model `.double()`): the same math, so
    loss, gradients and batch_stats agree to 1e-6 relative (measured:
    gradients 4.1e-9 over all leaves, 6.3e-8 in the worst leaf,
    batch_stats 1e-13; the one-hot labels stay float32 on both sides, so
    the loss terms differ by up to 3.2e-7).
  - unfused, float32, as users run it: the reference-literal schedule,
    which equals the fused one in exact arithmetic, against the float64
    step. The difference is the port's own float32 rounding
    (TOLERANCES states the limits and the readings they were set from);
    leaves whose gradient is 0 in exact arithmetic (biases before a
    BatchNorm, the unused fc) stay below 1e-4 of the largest leaf.
    Parameter updates: Adam divides by |g|, so where |g| is near 0 an
    element may flip sign; they are compared by cosine.

The test prints what it measured (`pytest -s`).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from echoflow.train.checkpoint import save_checkpoint as jax_save_checkpoint
from echoflow.train.loop import TrainConfig as JaxConfig
from echoflow.train.loop import TrainState as JaxState
from echoflow.train.loop import _loss_fn, create_train_state as jax_create_state
from echoflow.train.loop import lr_schedule as jax_lr_schedule
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.train import checkpoint as ck
from echoflow_torch.train.loop import (
    TrainConfig,
    create_train_state,
    fit,
    lr_schedule,
    make_ed_es_only_train_step,
    make_eval_step,
    make_train_step,
)

torch.set_num_threads(4)
T, S = 8, 32
CFG = TrainConfig(lr=1e-3, clip_length=T, image_size=(S, S), batch_size=2)


def _batch(seed=0, n=2):
    """A contracting-disc clip with ED/ES labels, ED and ES inside it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    disc = lambda r: (((yy - S / 2) ** 2 + (xx - S / 2) ** 2) <= r * r)
    video = np.empty((n, 3, T, S, S), np.float32)
    for i in range(n):
        for k in range(T):
            video[i, :, k] = 0.2 + 0.6 * disc(S / 3 - S / 6 * k / (T - 1)) \
                + 0.05 * rng.randn(S, S)
    return {"video": np.clip(video, 0, 1),
            "ed_label": np.stack([disc(S / 3)] * n).astype(np.int32),
            "es_label": np.stack([disc(S / 6)] * n).astype(np.int32),
            "ed_idx": np.array([1, 0][:n], np.int32), "es_idx": np.array([6, T - 1][:n],
                                                                        np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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
def jax_setup():
    cfg = JaxConfig(lr=1e-3, clip_length=T, image_size=(S, S), batch_size=2)
    model, state, tx = jax_create_state(jax.random.PRNGKey(0), cfg, input_shape=(1, 3, T, S, S))
    return model, state, tx


_JAX_STEP: dict = {}
# dtype of the port's step -> tolerances: loss/terms rtol, per-leaf and
# global grad relative L2, batch_stats (of each leaf's max), update cosine
# global/leaf.
TOLERANCES = {
    "float64": dict(loss=1e-6, leaf=1e-6, grads=1e-6, stats=1e-6,
                    cos=1 - 1e-9, leaf_cos=1 - 1e-9),
    # measured: loss terms 2.1e-6, worst leaf 3.3e-3, all leaves 1.8e-3,
    # batch_stats 1.3e-5, update cosine 0.99956 (worst leaf 0.9922).
    "float32": dict(loss=2e-5, leaf=2e-2, grads=1e-2, stats=1e-4,
                    cos=0.998, leaf_cos=0.96),
}


def _jax_step(jax_setup):
    """echoflow's fused train step in float64, as `make_train_step`
    computes it, with the gradients kept: value_and_grad of `_loss_fn`
    under `jax.enable_x64` on echoflow's model built with dtype=float64,
    then the optax update."""
    if not _JAX_STEP:
        from echoflow.models.r2plus1d import R2Plus1DMotionSegNet

        _, state, tx = jax_setup
        with jax.enable_x64(True):
            cast = lambda tree: jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)
            model = R2Plus1DMotionSegNet(dtype=jnp.float64)
            params, stats, opt_state = cast(state.params), cast(state.batch_stats), \
                cast(state.opt_state)
            grad_fn = jax.jit(jax.value_and_grad(
                lambda p, bs, b: _loss_fn(p, bs, model, b, False, True), has_aux=True))
            batch = {k: jnp.asarray(v) for k, v in _batch().items()}
            batch["video"] = batch["video"].astype(jnp.float64)
            (total, (aux, stats)), grads = grad_fn(params, stats, batch)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            _JAX_STEP.update(
                total=float(total), aux={k: float(v) for k, v in aux.items() if np.ndim(v) == 0},
                grads=_np_tree(grads), params=_np_tree(params), stats=_np_tree(stats))
    return _JAX_STEP


def _port_state_from(jax_state):
    state = create_train_state(0, CFG, device="cpu")
    state.model.load_state_dict(state_dict_from_variables(_np_tree(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats})))
    return state


def _cos(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a * b).sum() / (a.norm() * b.norm()))


@pytest.mark.parametrize("fused,dtype", [(True, "float64"), (False, "float32")],
                         ids=["fused-float64", "unfused-float32"])
def test_train_step_matches_echoflow(jax_setup, fused, dtype):
    _, jstate, _ = jax_setup
    tol = TOLERANCES[dtype]
    want = _jax_step(jax_setup)
    state = _port_state_from(jstate)
    batch = _torch_batch(_batch())
    if dtype == "float64":
        state.model.double()
        batch["video"] = batch["video"].double()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = make_train_step(fused_ota=fused)(state, batch)
    assert state.step == 1
    measured = {}

    measured["loss"] = max(abs(float(metrics[k]) - want["aux"][k]) / abs(want["aux"][k])
                           for k in ("ota", "sgs", "ots", "edes_bce"))
    np.testing.assert_allclose(float(metrics["loss"]), want["total"], rtol=tol["loss"])
    for key in ("ota", "sgs", "ots", "edes_bce"):
        np.testing.assert_allclose(float(metrics[key]), want["aux"][key], rtol=tol["loss"])

    jgrads = _leaf_dict(want["grads"], state.model, params_only=True)
    top = max(float(g.norm()) for g in jgrads.values())
    named = dict(state.model.named_parameters())
    measured["leaf"] = 0.0
    for name, jg in jgrads.items():
        g = named[name].grad.double()
        if float(jg.norm()) > 1e-4 * top:
            err = float((g - jg).norm() / jg.norm())
            measured["leaf"] = max(measured["leaf"], err)
            assert err <= tol["leaf"], name
        else:   # zero in exact arithmetic
            assert float(g.norm()) <= 1e-4 * top, name
    flat_j = torch.cat([g.reshape(-1) for g in jgrads.values()])
    flat_t = torch.cat([named[k].grad.double().reshape(-1) for k in jgrads])
    measured["grads"] = float((flat_t - flat_j).norm() / flat_j.norm())
    assert measured["grads"] <= tol["grads"]

    after = state.model.state_dict()
    jnew = _leaf_dict({"params": want["params"], "batch_stats": want["stats"]}, state.model)
    measured["stats"] = 0.0
    for name in jnew:
        if "running" in name:
            err = float((after[name].double() - jnew[name]).abs().max()
                        / jnew[name].abs().max())
            measured["stats"] = max(measured["stats"], err)
            assert err <= tol["stats"], name
    d_port = {k: (after[k] - before[k]).double() for k in named}
    d_jax = {k: jnew[k] - before[k].double() for k in named}
    measured["cos"] = _cos(torch.cat([d.reshape(-1) for d in d_port.values()]),
                           torch.cat([d_jax[k].reshape(-1) for k in d_port]))
    assert measured["cos"] >= tol["cos"]
    measured["leaf_cos"] = min(_cos(d_port[k], d_jax[k]) for k in named
                               if float(jgrads[k].norm()) > 1e-4 * top)
    assert measured["leaf_cos"] >= tol["leaf_cos"]
    print(f"train step vs echoflow ({'fused' if fused else 'unfused'}, {dtype}): "
          f"loss terms {measured['loss']:.2e}, worst leaf gradient {measured['leaf']:.2e}, "
          f"all gradients {measured['grads']:.2e}, batch_stats {measured['stats']:.2e}, "
          f"update cosine {measured['cos']:.6f} (worst leaf {measured['leaf_cos']:.6f})")


def _leaf_dict(tree, model, params_only=False):
    """A flax numpy tree -> {port name: float64 tensor}, through the port's
    converter's key plan (which reads float32; the float64 values are
    carried by converting the tree twice and matching shapes)."""
    sd32 = state_dict_from_variables(jax.tree.map(lambda a: np.asarray(a, np.float32), tree),
                                     params_only=params_only)
    hi = jax.tree.map(lambda a: np.asarray(a, np.float64) - np.asarray(a, np.float32), tree)
    lo = state_dict_from_variables(hi, params_only=params_only)
    return {k: v.double() + lo[k].double() for k, v in sd32.items()}


def test_lr_schedule_boundary():
    """optax's piecewise-constant schedule: the update with 0-based index k
    takes the dropped LR when k >= lr_drop_step."""
    cfg = TrainConfig(lr=1e-4, lr_drop_step=100, lr_after_drop=1e-5)
    jsched = jax_lr_schedule(JaxConfig(lr=1e-4, lr_drop_step=100, lr_after_drop=1e-5))
    sched = lr_schedule(cfg)
    for k, want in ((0, 1e-4), (99, 1e-4), (100, 1e-5), (101, 1e-5)):
        np.testing.assert_allclose(sched(k), want, rtol=1e-6)
        np.testing.assert_allclose(float(jsched(k)), want, rtol=1e-6)
    assert lr_schedule(TrainConfig(lr=3e-4))(10**6) == 3e-4


def test_train_step_takes_the_scheduled_lr():
    cfg = TrainConfig(lr=1e-3, lr_drop_step=1, lr_after_drop=1e-4, clip_length=T,
                      image_size=(S, S), batch_size=2)
    state = create_train_state(0, cfg, device="cpu")
    step = make_train_step()
    lrs = []
    for _ in range(2):
        state, _ = step(state, _torch_batch(_batch()))
        lrs.append(state.optimizer.param_groups[0]["lr"])
    assert lrs == [1e-3, 1e-4] and state.step == 2


def test_loss_decreases_over_six_steps():
    state = create_train_state(0, CFG, device="cpu")
    step, batch = make_train_step(), _torch_batch(_batch())
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_eval_step():
    state = create_train_state(0, CFG, device="cpu")
    metrics = make_eval_step()(state, _torch_batch(_batch(seed=1)))
    assert np.isfinite(float(metrics["loss"]))
    assert 0.0 <= float(metrics["ed_dice"]) <= 1.0 and 0.0 <= float(metrics["es_dice"]) <= 1.0
    assert state.model.training and not metrics["loss"].requires_grad
    # eval-mode BatchNorm reads the running statistics and leaves them.
    assert int(state.model.comb_batch_norm_1.num_batches_tracked) == 0


def test_ed_es_only_step_runs():
    state = create_train_state(0, CFG, device="cpu")
    b = _batch()
    batch = _torch_batch({"ed_video": b["video"], "es_video": b["video"][:, :, ::-1].copy(),
                          "ed_label": b["ed_label"], "es_label": b["es_label"],
                          "ed_idx": b["ed_idx"], "es_idx": np.array([3, 5], np.int32)})
    state, metrics = make_ed_es_only_train_step()(state, batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    # two forward passes: each BatchNorm saw two batches
    assert int(state.model.comb_batch_norm_1.num_batches_tracked) == 2


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Two straight steps equal one step, save, restore into a fresh state,
    one step: model, optimizer, update count and generator."""
    b1, b2 = _torch_batch(_batch(seed=3)), _torch_batch(_batch(seed=4))
    step = make_train_step()
    state = create_train_state(0, CFG, device="cpu")
    state, _ = step(state, b1)
    state.generator.manual_seed(1234)
    path = tmp_path / "mid.pth"
    ck.save_checkpoint(str(path), state, extra={"epoch": 0, "val_loss": 1.5})
    state, _ = step(state, b2)

    payload = ck.load_checkpoint(str(path))
    assert set(payload) == {"model", "optimizer", "step", "rng", "extra"}
    assert payload["extra"] == {"epoch": 0, "val_loss": 1.5} and payload["step"] == 1
    resumed = create_train_state(0, CFG, device="cpu")
    resumed, extra = ck.restore_train_state(str(path), resumed)
    assert extra["epoch"] == 0 and resumed.step == 1
    assert torch.equal(resumed.generator.get_state(),
                       torch.Generator().manual_seed(1234).get_state())
    resumed, _ = step(resumed, b2)
    assert resumed.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    # the reference's own reader: torch.load(p)["model"]
    assert set(ck.load_model_variables(str(path))) == set(state.model.state_dict())


def test_echoflow_checkpoint_loads_without_jax(jax_setup, tmp_path):
    """A `.pkl` written by echoflow's save_checkpoint after one JAX step:
    parameters, BN statistics and Adam's moments come back equal, and the
    port resumes from it."""
    _, jstate, tx = jax_setup
    f32 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    step = _jax_step(jax_setup)   # its float64 gradient, applied to the float32 state
    @jax.jit
    def adam(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = adam(f32(step["grads"]), jstate.opt_state, jstate.params)
    want = {"params": _np_tree(params),
            "stats": _np_tree(f32(step["stats"])), "opt_state": _np_tree(opt_state)}
    stepped = JaxState(step=jnp.asarray(1, jnp.int32), params=want["params"],
                       batch_stats=want["stats"], opt_state=want["opt_state"], rng=jstate.rng)
    path = str(tmp_path / "jax.pkl")
    jax_save_checkpoint(path, stepped, extra={"epoch": 2, "val_loss": 0.5})

    got = ck.load_jax_checkpoint(path)
    model = state_dict_from_variables(_np_tree({"params": want["params"],
                                                "batch_stats": want["stats"]}))
    assert set(got["model"]) == set(model)
    for k, v in model.items():
        assert torch.equal(got["model"][k], v), k
    adam = want["opt_state"][0]
    mu = state_dict_from_variables(_np_tree(adam.mu), params_only=True)
    nu = state_dict_from_variables(_np_tree(adam.nu), params_only=True)
    for k in mu:
        assert torch.equal(got["exp_avg"][k], mu[k]) and torch.equal(got["exp_avg_sq"][k], nu[k])
    assert got["adam_step"] == 1 and got["step"] == 1 and got["extra"]["epoch"] == 2

    state, extra = ck.restore_train_state(path, create_train_state(0, CFG, device="cpu"))
    assert extra["epoch"] == 2 and state.step == 1
    p = state.model.comb_1_layer.weight
    assert torch.equal(state.optimizer.state[p]["exp_avg"], mu["comb_1_layer.weight"])
    state, metrics = make_train_step()(state, _torch_batch(_batch(seed=5)))
    assert np.isfinite(float(metrics["loss"])) and state.step == 2
    assert set(ck.load_model_variables(path)) == set(model)


def test_fit_logs_history_and_eval_pass():
    state = create_train_state(0, CFG, device="cpu")
    batches = [_batch(seed=i) for i in range(2)]
    logs = []
    state, history = fit(state, iter(batches), eval_batches=iter([_batch(seed=9)]),
                         log_every=1, log_fn=logs.append)
    assert state.step == 2 and len(history) == 3
    assert set(history[-1]) == {"eval_loss", "eval_ed_dice", "eval_es_dice"}
    assert any(line.startswith("eval:") for line in logs)


def test_reference_named_epoch_entry_points():
    """`train`/`test` (reference src/train_test.py names): one epoch of
    training, then a validation pass printing the reference's summary."""
    from echoflow_torch.train import test, train

    logs = []
    state = create_train_state(0, CFG, device="cpu")
    state, history = train(0, iter([_batch(seed=6)]), state, log_every=1, log_fn=logs.append)
    assert state.step == 1 and len(history) == 1
    losses = test(0, iter([_batch(seed=7)]), state, log_fn=logs.append)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert any("Valid set: Average loss" in line for line in logs)


def test_create_train_state_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(0, CFG)


def test_train_clasfv_torch_runs_and_resumes(tmp_path):
    import train_clasfv_torch as cli

    out = str(tmp_path / "ck.pth")
    args = ["--synthetic", "--device", "cpu", "--epochs", "1", "--steps", "2",
            "--batch-size", "2", "--image-size", "24", "--clip-length", "8", "--out", out]
    cli.main(args)
    best, last = ck.load_checkpoint(out), ck.load_checkpoint(out + ".last")
    assert last["extra"]["epoch"] == 0 and last["step"] == 2
    assert np.isfinite(best["extra"]["val_loss"])
    state = cli.main(args[:4] + ["2"] + args[5:] + ["--resume", out])
    assert state.step == 4
    assert ck.load_checkpoint(out)["extra"]["val_loss"] <= best["extra"]["val_loss"]
    # --compute-dtype bf16 runs the model in bf16; its checkpoint holds fp32
    # parameters, running statistics and Adam moments, and resumes.
    out16 = str(tmp_path / "ck16.pth")
    args16 = args[:-1] + [out16, "--compute-dtype", "bf16"]
    assert cli.main(args16).model.compute_dtype == torch.bfloat16
    ck16 = ck.load_checkpoint(out16 + ".last")
    assert ck16["step"] == 2 and np.isfinite(ck16["extra"]["val_loss"])
    assert all(v.dtype == torch.float32 for v in ck16["model"].values()
               if v.is_floating_point())
    assert all(v.dtype == torch.float32 for st in ck16["optimizer"]["state"].values()
               for k, v in st.items() if k != "step")
    assert cli.main(args16[:4] + ["2"] + args16[5:] + ["--resume", out16]).step == 4
    state32, _ = ck.restore_train_state(out16, create_train_state(0, CFG, device="cpu"))
    assert state32.step == 4 and state32.model.compute_dtype is None   # into an fp32 state
    with pytest.raises(SystemExit, match="--data"):     # neither data source
        cli.main(args[1:])
    # --data reads an EchoNet-Dynamic root (tests/test_torch_echonet.py
    # trains on one); a missing root fails at its FileList.csv.
    with pytest.raises(FileNotFoundError, match="FileList.csv"):
        cli.main(args[1:] + ["--data", str(tmp_path / "missing")])

    # --init-from: a stock torchvision r2plus1d_18 state dict (the
    # backbone's keys without the prefix) starts the backbone.
    stock = {k[len("r2plus1d_model."):]: v * 0.5 for k, v in
             create_train_state(7, CFG, device="cpu").model.state_dict().items()
             if k.startswith("r2plus1d_model.")}
    torch.save(stock, tmp_path / "kinetics.pth")
    state = cli.main(args[:-1] + [str(tmp_path / "init.pth"), "--steps", "1",
                                  "--init-from", str(tmp_path / "kinetics.pth")])
    assert state.step == 1
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(args + ["--init-from", str(tmp_path / "kinetics.pth"), "--resume", out])
    assert cli.should_save_best(1.0, float("inf")) and not cli.should_save_best(
        float("nan"), 1.0)
