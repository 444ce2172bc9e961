"""Rematerialized train steps (`make_train_step(remat=True)`,
`make_ed_es_only_train_step(remat=True)`) on the CPU.

The model's forward runs under `torch.utils.checkpoint` and again in the
backward; the recompute must not move BatchNorm's running statistics a
second time. Held: remat against the plain step in float64 (loss, terms
and every gradient to 1e-12 relative, running statistics bitwise,
`num_batches_tracked` +1 a forward), with bf16 compute too; echoflow's
`remat=True` step against the port's; and 2 gloo ranks against one process
in float64 to 1e-10, as tests/test_torch_parallel.py holds the plain step.
"""

import dataclasses

import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.train.loop import _loss_fn

from echoflow_torch.models.r2plus1d import BatchNorm3d, create_model
from echoflow_torch.parallel.dryrun import dp_train_steps
from echoflow_torch.parallel.launch import run_ranks
from echoflow_torch.train.loop import (
    create_train_state,
    make_ed_es_only_train_step,
    make_train_step,
)
from tests.test_torch_parallel import REL, _batch as dp_batch, _check_against_single, _ed_es
from tests.test_torch_parallel import _single_steps
from tests.test_torch_train import (
    CFG,
    TOLERANCES,
    T,
    S,
    _batch,
    _leaf_dict,
    _np_tree,
    _port_state_from,
    _torch_batch,
)

torch.set_num_threads(4)
EXACT = 1e-12        # remat vs plain, float64: the same operations on the same values


def _ed_es_batch():
    b = _torch_batch(_batch())
    return {"ed_video": b["video"], "es_video": b["video"].flip(2).contiguous(),
            **{k: b[k] for k in ("ed_label", "es_label", "ed_idx", "es_idx")}}


def _run(recipe, remat, dtype, steps=2):
    """`steps` steps of the recipe from the seed-0 state: float64 casts the
    model (and outputs), bf16 sets `TrainConfig.compute_dtype`. Returns the
    metrics, gradients and state dict after each step, and how many times
    comb2 ran its forward in the last step."""
    compute = dtype if dtype == torch.bfloat16 else torch.float32
    state = create_train_state(0, dataclasses.replace(CFG, compute_dtype=compute), device="cpu")
    batch = _torch_batch(_batch()) if recipe == "clasfv" else _ed_es_batch()
    if dtype == torch.float64:
        state.model.double().output_dtype = torch.float64
        batch = {k: v.double() if "video" in k else v for k, v in batch.items()}
    step = (make_train_step(remat=remat) if recipe == "clasfv"
            else make_ed_es_only_train_step(remat=remat))
    calls = []
    hook = state.model.comb_2_layer.register_forward_hook(lambda *a: calls.append(1))
    out = []
    for _ in range(steps):
        calls.clear()
        state, metrics = step(state, batch)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: p.grad.clone() for k, p in state.model.named_parameters()},
                    {k: v.clone() for k, v in state.model.state_dict().items()}))
    hook.remove()
    assert not any(m.frozen for m in state.model.modules() if isinstance(m, BatchNorm3d))
    return out, len(calls)


@pytest.mark.parametrize("recipe,dtype", [("clasfv", torch.float64),
                                          ("ed_es_only", torch.float64),
                                          ("clasfv", torch.bfloat16)],
                         ids=["clasfv-float64", "ed_es_only-float64", "clasfv-bf16"])
def test_remat_step_equals_the_plain_step(recipe, dtype):
    """Two steps with and without remat from the same state: the forward
    really runs twice a step with remat (comb2's forward hook); metrics and
    every gradient agree to `EXACT`; the running statistics, parameters
    after each step are bitwise the plain step's, and
    `num_batches_tracked` moved once a forward (1 or 2 a step)."""
    forwards = 1 if recipe == "clasfv" else 2
    plain, plain_calls = _run(recipe, False, dtype)
    remat, remat_calls = _run(recipe, True, dtype)
    assert (plain_calls, remat_calls) == (forwards, 2 * forwards)
    worst = 0.0
    for i, ((m0, g0, s0), (m1, g1, s1)) in enumerate(zip(plain, remat)):
        for k, v in m0.items():
            assert abs(m1[k] - v) <= EXACT * abs(v), (i, k)
        for k, g in g0.items():
            diff = float((g1[k] - g).norm())
            err = diff / float(g.norm()) if diff else 0.0
            worst = max(worst, err)
            assert err <= EXACT, (i, k, err)
        for k, v in s0.items():
            assert torch.equal(s1[k], v), (i, k)
        assert int(s1["comb_batch_norm_1.num_batches_tracked"]) == (i + 1) * forwards
    print(f"remat vs plain ({recipe}, {dtype}): worst gradient leaf {worst:.1e}, "
          f"forwards a step {remat_calls} (plain {plain_calls})")


def test_remat_step_matches_echoflows_remat_step():
    """echoflow's fused step with `remat=True` (`jax.checkpoint` of the
    forward) against the port's, both float64 (echoflow's model built with
    dtype=float64 under `jax.enable_x64`) from the same weights and batch:
    test_torch_train.py's float64 bars (1e-6) on the loss, all gradients,
    each leaf and the running statistics."""
    from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet
    from echoflow.train.loop import TrainConfig as JaxConfig, create_train_state as jax_state

    _, jstate, _ = jax_state(
        jax.random.PRNGKey(0), JaxConfig(lr=1e-3, clip_length=T, image_size=(S, S),
                                         batch_size=2), input_shape=(1, 3, T, S, S))
    with jax.enable_x64(True):
        cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        model = FlaxNet(dtype=jnp.float64)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, bs, b: _loss_fn(p, bs, model, b, True, True), has_aux=True))
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        batch["video"] = batch["video"].astype(jnp.float64)
        (jtotal, (_, jstats)), jgrads = grad_fn(cast(jstate.params),
                                                cast(jstate.batch_stats), batch)
        jtotal, jstats, jgrads = float(jtotal), _np_tree(jstats), _np_tree(jgrads)
    state = _port_state_from(jstate)
    state.model.double()
    batch = _torch_batch(_batch())
    batch["video"] = batch["video"].double()
    state, metrics = make_train_step(remat=True)(state, batch)
    tol = TOLERANCES["float64"]
    loss = abs(float(metrics["loss"]) - jtotal) / abs(jtotal)
    want = _leaf_dict(jgrads, None, params_only=True)
    named = dict(state.model.named_parameters())
    top = max(float(g.norm()) for g in want.values())
    live = [k for k, g in want.items() if float(g.norm()) > 1e-4 * top]
    leaf = max(float((named[k].grad.double() - want[k]).norm() / want[k].norm())
               for k in live)
    flat = lambda d: torch.cat([d[k].double().reshape(-1) for k in live])
    grads = float((flat({k: named[k].grad for k in live}) - flat(want)).norm()
                  / flat(want).norm())
    stats_want = _leaf_dict({"params": _np_tree(jstate.params), "batch_stats": jstats}, None)
    after = state.model.state_dict()
    stats = max(float((after[k].double() - v).abs().max() / v.abs().max())
                for k, v in stats_want.items() if "running" in k)
    print(f"remat step vs echoflow's remat step (float64): loss {loss:.2e}, all gradients "
          f"{grads:.2e}, worst leaf {leaf:.2e}, running stats {stats:.2e}")
    assert loss <= tol["loss"] and grads <= tol["grads"] and leaf <= tol["leaf"]
    assert stats <= tol["stats"]


@pytest.mark.parametrize("recipe", ["clasfv", "ed_es_only"])
def test_two_rank_remat_step_equals_one_process_step(recipe):
    """The remat step on 2 gloo ranks (DDP, global BatchNorm whose
    all-gather the recompute issues again on both ranks) against the plain
    single-process step on the whole batch, float64: tests/test_torch_
    parallel.py's bars (`REL`, 1e-10), running statistics and parameters
    included."""
    state_dict = {k: v.numpy() for k, v in create_model(seed=0).state_dict().items()}
    batches = [dp_batch(0)]
    if recipe == "ed_es_only":
        batches = [_ed_es(b) for b in batches]
    ranks = run_ranks(dp_train_steps, 2, state_dict, batches, recipe, "float64", None, True,
                      "float32", threads=3)
    measured = _check_against_single(ranks[0], _single_steps(state_dict, batches, recipe))
    assert ranks[0]["leaf_sums"] == ranks[1]["leaf_sums"]
    print(f"2 remat ranks vs one plain process ({recipe}, float64): terms "
          f"{measured['terms']:.1e}, worst leaf {measured['leaf']}, running stats "
          f"{measured['stats']:.1e}, parameters {measured['params']:.1e} (bar {REL:.0e})")
