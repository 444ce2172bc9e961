"""The port's bf16 compute rule against echoflow's, on the CPU.

echoflow runs its model in bf16 with flax's mixed-precision rule
(`R2Plus1DMotionSegNet(dtype=bfloat16)`: fp32 parameters, bf16 convs and
einsums, fp32 BatchNorm statistics, fp32 outputs). The port's counterpart
is `R2Plus1DMotionSegNet.compute_dtype` (`TrainConfig.compute_dtype` in
training). bf16 accumulates in another order on each backend, so the bar
does not chase bits: against the float64 forward or step, the port's
relative L2 distance must be at most 2x echoflow's bf16 distance
(`RATIO`). Each test prints both distances (`pytest -s`).

The weights are seeded, with each residual branch damped (`_damped`):
at the plain seeded init a train-mode bf16 forward or step is chaotic
(gradients 1.2 from float64 on both sides, no matter the clip length or
frame size), and a ratio of two such distances would pass anything. The
step's gradients are also held to `GRAD_ABS`, and the stem's statistics
to echoflow's bf16 ones (`STEM_STATS_TOL`).

Readings on the CPU (torch 2.13; port / echoflow), distances from
float64: the train-mode forward at test_torch_train's (2, 3, 8, 32, 32)
batch seg 3.77e-2 / 3.81e-2, motion 3.57e-2 / 3.53e-2, running
statistics 9.1e-4 / 9.1e-4 (undamped: seg 0.438 / 0.418); eval seg
7.8e-3 / 8.1e-3;
folded bf16 3.2e-3 / 1.31e-2 (the port's decoder tail is fp32,
echoflow's default XLA decoder bf16); the fused train step: loss 1.43e-3
/ 1.72e-3, gradients 0.201 / 0.184 (undamped 1.18 / 1.18). The engine
masks: the port's bf16 and mixed masks differ from echoflow's on
1.3-2.1% of the pixels, each engine's from its own fp32 masks on
1.4-2.0%. 2 gloo ranks / one process, bf16 step: loss 1.9e-3 / 3.6e-3,
gradients 0.196 / 0.192.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from echoflow.infer import pipeline as JP
from echoflow.models.fast_forward import folded_forward as jax_folded_forward
from echoflow.models.fold_bn import fold_variables
from echoflow.models.r2plus1d import R2Plus1DMotionSegNet as FlaxNet, init_variables
from echoflow.train.loop import _loss_fn

from echoflow_torch.infer import pipeline as TP
from echoflow_torch.models.convert import state_dict_from_variables
from echoflow_torch.models.fast_forward import folded_forward
from echoflow_torch.models.fold_bn import fold_state_dict
from echoflow_torch.models.r2plus1d import R2Plus1DMotionSegNet, create_model
from echoflow_torch.parallel.dryrun import dp_train_steps
from echoflow_torch.parallel.launch import run_ranks
from echoflow_torch.train.loop import (
    TrainConfig,
    create_train_state,
    make_ed_es_only_eval_step,
    make_eval_step,
    make_train_step,
)
from tests.test_torch_model import _randomize_bn
from tests.test_torch_pipeline import _video, shared_weights  # noqa: F401 (a fixture)
from tests.test_torch_train import (
    CFG,
    T,
    S,
    _batch,
    _leaf_dict,
    _np_tree,
    _torch_batch,
)

torch.set_num_threads(4)
RATIO = 2.0          # the port's bf16 distance from float64 / echoflow's, at most
ZERO_LEAF = 1e-4     # below this share of the largest gradient: 0 in exact arithmetic
RESIDUAL_SCALE = 0.1  # `_damped`: each residual branch's last BatchNorm scale, times this
GRAD_ABS = 0.5       # a bf16 step's gradients from float64, at most (relative L2)
STEM_STATS_TOL = 5e-4  # the stem's running-statistics update, port vs echoflow bf16


def _damped(variables):
    """echoflow's variables with each residual branch's last BatchNorm
    scale (`layer*_block*/bn2`, the port's `layer*.*.conv2.1.weight`)
    times `RESIDUAL_SCALE`: the network starts near its identity, as
    torchvision's `zero_init_residual` starts a ResNet, but every leaf
    keeps a gradient. At the plain seeded init the train-mode bf16 step is
    chaotic: each BatchNorm renormalizes its branch's bf16 rounding, which
    grows about 1.2x a conv, from 1.5e-3 at the stem to 0.37 at layer4's
    end, and the gradients come out 1.2 from float64 on both sides (longer
    clips, larger frames or noisier video leave that at 1.0-1.2); damped,
    0.2."""
    copy = lambda tree: {k: copy(v) if isinstance(v, dict) else np.array(v)
                         for k, v in tree.items()}
    params = copy(variables["params"])
    for name, block in params["backbone"].items():
        if "_block" in name:
            block["bn2"]["scale"] = block["bn2"]["scale"] * RESIDUAL_SCALE
    return {"params": params, "batch_stats": copy(variables["batch_stats"])}


def _damped_state_dict(state_dict):
    """`_damped` on the port's state dict (numpy values)."""
    return {k: v * RESIDUAL_SCALE if ".conv2.1.weight" in k and ".layer" in k else v
            for k, v in state_dict.items()}


def _stem_stats(stats, before):
    """The update of the stem's running statistics (its two BatchNorms),
    one float64 vector: 1-2 convs into the network the port's and
    echoflow's bf16 forwards have not diverged yet, so this tells fp32
    from bf16 statistics apart."""
    keys = [k for k in before if k.startswith("r2plus1d_model.stem.") and "running" in k]
    return torch.cat([(torch.as_tensor(stats[k]).double()
                       - torch.as_tensor(before[k]).double()).reshape(-1) for k in keys])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def forward_setup():
    """echoflow's variables (random BatchNorm parameters and statistics, so
    the rule's BatchNorm casts matter, then `_damped`), the port's state
    dict of them, and test_torch_train's echo-like batch."""
    variables = _damped(_randomize_bn(init_variables(jax.random.PRNGKey(0), FlaxNet(),
                                                     (1, 3, T, S, S))))
    return variables, state_dict_from_variables(variables), _batch()["video"]


def _port_forward(state_dict, video, train, dtype):
    """The port's module forward: float64 throughout for the reference,
    else fp32 parameters computing in `dtype`. Returns seg, motion and the
    running statistics after it."""
    model = R2Plus1DMotionSegNet()
    model.load_state_dict(state_dict)
    if dtype == torch.float64:
        model.double().output_dtype = torch.float64
    else:
        model.compute_dtype = dtype
    with torch.no_grad():
        seg, motion = model.train(train)(torch.from_numpy(video))
    assert dtype == torch.float64 or (seg.dtype == motion.dtype == torch.float32)
    assert all(p.dtype == (torch.float64 if dtype == torch.float64 else torch.float32)
               for p in model.parameters())
    stats = {k: v.double().numpy() for k, v in model.state_dict().items() if "running" in k}
    return seg.numpy(), motion.numpy(), stats


@pytest.mark.parametrize("mode", ["train", "eval", "folded-bf16", "folded-mixed"])
def test_bf16_forward_is_as_close_to_float64_as_echoflows(forward_setup, mode):
    """The train-mode and eval forwards (the module's), and the folded
    inference forward with a bf16 backbone and bf16 or fp32 projections
    (`folded_forward`, K1's plain version here), against the port's
    float64 forward: seg, motion and (train mode) the running statistics
    at most `RATIO` times as far as echoflow's same bf16 forward."""
    variables, state_dict, video = forward_setup
    train = mode == "train"
    ref_seg, ref_motion, ref_stats = _port_forward(state_dict, video, train, torch.float64)
    x = jnp.asarray(video)
    port_stats = jax_stats = None
    if mode in ("train", "eval"):
        seg, motion, stats = _port_forward(state_dict, video, train, torch.bfloat16)
        out = FlaxNet(dtype=jnp.bfloat16).apply(
            variables, x, train=train, mutable=["batch_stats"] if train else False)
        (jseg, jmotion), updates = out if train else (out, None)
        if train:
            jstats = state_dict_from_variables(
                {"params": variables["params"], "batch_stats": _np_tree(updates["batch_stats"])})
            keys = sorted(ref_stats)
            flat = lambda d: np.concatenate([np.asarray(d[k], np.float64).ravel()
                                             for k in keys])
            port_stats = _rel(flat(stats), flat(ref_stats))
            jax_stats = _rel(flat({k: jstats[k].numpy() for k in keys}), flat(ref_stats))
    else:
        proj = torch.bfloat16 if mode == "folded-bf16" else torch.float32
        model = R2Plus1DMotionSegNet(folded=True)
        model.load_state_dict(fold_state_dict(state_dict))
        model.eval().r2plus1d_model.to(torch.bfloat16)   # as the engine casts it
        with torch.no_grad():
            seg, motion = folded_forward(model, torch.from_numpy(video), dtype=proj)
        seg, motion = seg.numpy(), motion.numpy()
        jseg, jmotion = jax_folded_forward(
            fold_variables(variables), x, backbone_dtype=jnp.bfloat16, pallas=False,
            dtype=jnp.bfloat16 if mode == "folded-bf16" else jnp.float32)
    dist = {"seg": (_rel(seg, ref_seg), _rel(jseg, ref_seg)),
            "motion": (_rel(motion, ref_motion), _rel(jmotion, ref_motion))}
    if port_stats is not None:
        dist["running stats"] = (port_stats, jax_stats)
    print(f"bf16 forward ({mode}) from float64, port / echoflow: "
          + ", ".join(f"{k} {p:.3e} / {j:.3e}" for k, (p, j) in dist.items()))
    for name, (port, jax_dist) in dist.items():
        assert port <= RATIO * jax_dist, (name, port, jax_dist)


@pytest.mark.parametrize("precision", ["bf16", "mixed"])
def test_bf16_and_mixed_engine_masks_agree_with_echoflows(shared_weights, precision):
    """`VideoSegmenter` in bf16 (backbone and projections) and mixed (bf16
    backbone) against echoflow's engines of the same policy on two 32x32
    videos (tests/test_pipeline.py's size), 5 shifts, SIMPLE: the share of
    pixels where the port's mask differs from echoflow's is at most
    `RATIO` x the share where echoflow's differs from its own fp32 mask,
    and the port's distance from its fp32 masks at most `RATIO` x
    echoflow's (the masks flip at bf16-noise ties on both sides)."""
    jdt, tdt = {"bf16": ({"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}),
                "mixed": ({"dtype": jnp.float32, "backbone_dtype": jnp.bfloat16},
                          {"dtype": torch.float32, "backbone_dtype": torch.bfloat16})}[precision]
    state = state_dict_from_variables(shared_weights)
    engines = {
        "jax": JP.VideoSegmenter(shared_weights, forward_chunk=4, bucket=32, **jdt),
        "jax32": JP.VideoSegmenter(shared_weights, forward_chunk=4, bucket=32,
                                   dtype=jnp.float32),
        "port": TP.VideoSegmenter(state, device="cpu", forward_chunk=4, bucket=32, **tdt),
        "port32": TP.VideoSegmenter(state, device="cpu", forward_chunk=4, bucket=32,
                                    dtype=torch.float32),
    }
    for length, color in ((64, False), (40, True)):
        video = _video(length, color)
        masks = {k: np.asarray(e.segment_video(video, num_clips=5, step=1,
                                               fuse_method="simple"))
                 for k, e in engines.items()}
        np.testing.assert_array_equal(masks["port32"], masks["jax32"])
        port_vs_jax = float((masks["port"] != masks["jax"]).mean())
        jax_vs_fp32 = float((masks["jax"] != masks["jax32"]).mean())
        port_vs_fp32 = float((masks["port"] != masks["port32"]).mean())
        print(f"{precision} masks ({length} frames): port vs echoflow {port_vs_jax:.4f}; "
              f"vs their fp32 masks: port {port_vs_fp32:.4f}, echoflow {jax_vs_fp32:.4f}")
        assert 0.0 < jax_vs_fp32   # bf16 moves some pixels, or the bar is void
        assert port_vs_jax <= RATIO * jax_vs_fp32
        assert port_vs_fp32 <= RATIO * jax_vs_fp32


@pytest.fixture(scope="module")
def bf16_steps():
    """echoflow's float64 and `compute_dtype=bfloat16` fused steps and the
    port's `TrainConfig.compute_dtype=bfloat16` step on
    tests/test_torch_train.py's batch and seed-0 weights, `_damped`: each
    as (loss, {port name: float64 gradient}, state dict after), and the
    port's state."""
    from echoflow.train.loop import TrainConfig as JaxConfig, create_train_state as jax_state

    _, jstate, _ = jax_state(jax.random.PRNGKey(0), JaxConfig(
        lr=1e-3, clip_length=T, image_size=(S, S), batch_size=2), input_shape=(1, 3, T, S, S))
    variables = _damped(_np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats}))

    def jax_step(dtype):
        model = FlaxNet(dtype=dtype)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, bs, b: _loss_fn(p, bs, model, b, False, True), has_aux=True))
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        tree = variables
        if dtype == jnp.float64:
            tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
            batch["video"] = batch["video"].astype(jnp.float64)
        (total, (_, stats)), grads = grad_fn(tree["params"], tree["batch_stats"], batch)
        return (float(total), _leaf_dict(_np_tree(grads), None, params_only=True),
                _leaf_dict({"params": variables["params"], "batch_stats": _np_tree(stats)},
                           None))

    with jax.enable_x64(True):
        ref = jax_step(jnp.float64)
    jax16 = jax_step(jnp.bfloat16)
    state = create_train_state(0, dataclasses.replace(CFG, compute_dtype=torch.bfloat16),
                               device="cpu")
    state.model.load_state_dict(state_dict_from_variables(variables))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, metrics = make_train_step()(state, _torch_batch(_batch()))
    named = dict(state.model.named_parameters())
    port = (float(metrics["loss"]),
            {k: torch.zeros_like(named[k]).double() if named[k].grad is None
             else named[k].grad.double() for k in ref[1]},
            state.model.state_dict())
    return {"ref": ref, "jax": jax16, "port": port, "state": state, "before": before}


def test_bf16_train_step_is_as_close_to_float64_as_echoflows(bf16_steps):
    """The fused train step with `TrainConfig.compute_dtype=bfloat16` at
    tests/test_torch_train.py's batch and seed-0 weights, `_damped` (so
    that bf16 is well conditioned), against echoflow's float64 step and
    beside echoflow's `compute_dtype=bfloat16` step: the loss, all
    gradients (also at most `GRAD_ABS`), each gradient leaf that is not 0
    in exact arithmetic, and all running statistics at most `RATIO` x as
    far from float64 as echoflow's; the stem's running-statistics update
    within `STEM_STATS_TOL` of echoflow's bf16 one. Parameters, Adam's
    moments and the running statistics stay fp32.

    Readings (port / echoflow, from float64): loss 1.43e-3 / 1.72e-3,
    gradients 0.201 / 0.184, running statistics 8.8e-4 / 7.9e-4, worst
    leaf ratio 1.44 (layer4.1.conv2.1.weight 0.202 / 0.140), echoflow's
    leaf distances under 0.5 in 120 of 121 live leaves; stem statistics
    6.1e-5 from echoflow's. Two planted faults fail (each in a copy of the
    package): the comb2 weight's gradient zeroed after the backward (its
    leaf 1.0 / 0.030), and BatchNorm's statistics reduced in bf16
    (`_stat_dtype` returning the input's dtype, the fault the compute rule
    repairs: stem statistics 8.9e-4 from echoflow's; the float64 ratios
    stay under 2, as bf16 rounding of the statistics adds no more than
    the bf16 forward's own error to them)."""
    ref_loss, ref, ref_after = bf16_steps["ref"]
    jloss, jgrads, jafter = bf16_steps["jax"]
    ploss, pgrads, pafter = bf16_steps["port"]
    state, before = bf16_steps["state"], bf16_steps["before"]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for k, v in s.items() if k != "step")
    assert all(pafter[k].dtype == torch.float32 for k in pafter if "running" in k)

    top = max(float(g.norm()) for g in ref.values())
    live = [k for k, g in ref.items() if float(g.norm()) > ZERO_LEAF * top]
    flat = lambda d, keys: torch.cat([torch.as_tensor(d[k]).double().reshape(-1)
                                      for k in keys])
    loss = tuple(abs(x - ref_loss) / abs(ref_loss) for x in (ploss, jloss))
    grads = tuple(_rel(flat(g, live), flat(ref, live)) for g in (pgrads, jgrads))
    skeys = [k for k in ref_after if "running" in k]
    stats = tuple(_rel(flat(d, skeys), flat(ref_after, skeys)) for d in (pafter, jafter))
    leaves = {k: (_rel(pgrads[k], ref[k]), _rel(jgrads[k], ref[k])) for k in live}
    worst = max(leaves, key=lambda k: leaves[k][0] / leaves[k][1])
    stem = _rel(_stem_stats(pafter, before), _stem_stats(jafter, before))
    print(f"bf16 train step from float64, port / echoflow: loss {loss[0]:.3e} / "
          f"{loss[1]:.3e}, gradients {grads[0]:.3e} / {grads[1]:.3e}, running stats "
          f"{stats[0]:.3e} / {stats[1]:.3e}; worst leaf ratio {worst} "
          f"{leaves[worst][0]:.3e} / {leaves[worst][1]:.3e}; echoflow's leaves under 0.5: "
          f"{sum(j < 0.5 for _, j in leaves.values())} of {len(live)}; stem statistics "
          f"{stem:.2e} from echoflow's (limit {STEM_STATS_TOL:.0e})")
    assert grads[0] <= GRAD_ABS, grads
    assert stem <= STEM_STATS_TOL, stem
    for name, (port, jax_dist) in (("loss", loss), ("grads", grads), ("stats", stats),
                                   *leaves.items()):
        assert port <= RATIO * jax_dist, (name, port, jax_dist)


@pytest.mark.parametrize("recipe", ["clasfv", "ed_es_only"])
def test_eval_steps_run_in_the_compute_dtype(recipe):
    """Both eval steps of a bf16 state run the model's convs in bf16 and
    return finite metrics near the fp32 state's (the loss within 5%: bf16
    rounding of a fresh model's outputs)."""
    batch = _torch_batch(_batch())
    if recipe == "ed_es_only":
        batch = {"ed_video": batch["video"], "es_video": batch["video"].flip(2),
                 **{k: batch[k] for k in ("ed_label", "es_label", "ed_idx", "es_idx")}}
    step = make_eval_step() if recipe == "clasfv" else make_ed_es_only_eval_step()
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        state = create_train_state(0, dataclasses.replace(CFG, compute_dtype=dtype),
                                   device="cpu")
        seen = []
        hook = state.model.comb_2_layer.register_forward_hook(
            lambda mod, args, out: seen.append(out.dtype))
        metrics = step(state, batch)
        hook.remove()
        assert set(seen) == {dtype} and all(np.isfinite(float(v)) for v in metrics.values())
        losses[dtype] = float(metrics["loss"])
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= 0.05 * losses[torch.float32]


def test_two_rank_bf16_step_is_as_close_to_float64_as_one_process():
    """A bf16 fused step on 2 gloo ranks (global BatchNorm with fp32
    statistics, `_GlobalBatchNorm`) against the single-process bf16 step on
    the whole batch, from the seed-0 weights `_damped`: both measured from
    the single-process float64 step, the 2-rank loss and gradients at most
    `RATIO` x as far as one process's (2 ranks round the BatchNorm
    statistics in another order) and the gradients at most `GRAD_ABS`;
    the stem's running-statistics update within `STEM_STATS_TOL` of one
    process's. Parameters and running statistics stay fp32. Readings
    (2 ranks / one process): loss 1.9e-3 / 3.6e-3, gradients 0.196 /
    0.192, stem statistics 6.8e-8 apart; with `_GlobalBatchNorm`'s global
    statistics rounded to bf16 (a fault planted in a copy) 1.6e-3 apart,
    gradients 0.245 / 0.192."""
    from tests.test_torch_parallel import N, S as DS, T as DT, _batch as dp_batch, _single_steps

    state_dict = _damped_state_dict(
        {k: v.numpy() for k, v in create_model(seed=0).state_dict().items()})
    batch = dp_batch(0)
    ranks = run_ranks(dp_train_steps, 2, state_dict, [batch], "clasfv", "float32", None,
                      False, "bfloat16", threads=3)
    ref = _single_steps(state_dict, [batch], "clasfv")
    cfg = TrainConfig(clip_length=DT, image_size=(DS, DS), batch_size=N,
                      compute_dtype=torch.bfloat16)
    state = create_train_state(0, cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    state, metrics = make_train_step()(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    keys = list(ref["grads"][0])
    flat = lambda d: torch.cat([torch.as_tensor(d[k]).double().reshape(-1) for k in keys])
    g64 = flat(ref["grads"][0])
    loss64 = ref["history"][0]["loss"]
    one = (abs(float(metrics["loss"]) - loss64) / loss64,
           float((flat({k: p.grad for k, p in state.model.named_parameters()}) - g64).norm()
                 / g64.norm()))
    two = (abs(ranks[0]["history"][0]["loss"] - loss64) / loss64,
           float((flat(ranks[0]["grads"][0]) - g64).norm() / g64.norm()))
    stem = _rel(_stem_stats(ranks[0]["state"], state_dict),
                _stem_stats(state.model.state_dict(), state_dict))
    print(f"bf16 step from float64, 2 ranks / one process: loss {two[0]:.3e} / {one[0]:.3e}, "
          f"gradients {two[1]:.3e} / {one[1]:.3e}; stem statistics {stem:.2e} apart")
    assert two[0] <= RATIO * one[0] and two[1] <= RATIO * one[1]
    assert two[1] <= GRAD_ABS and stem <= STEM_STATS_TOL
    assert ranks[0]["leaf_sums"] == ranks[1]["leaf_sums"]
    assert all(v.dtype in (np.float32, np.int64) for v in ranks[0]["state"].values())
