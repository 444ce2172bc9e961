"""Training and evaluation loops for CLAS-FV joint training (port of
`echoflow.train.loop`).

Reference recipe (train notebook cells 8-10): Adam lr 1e-4, batch 4, 10
epochs, the LR dropped to 1e-5 at epoch 3 (the reference re-creates the
optimizer; here a piecewise-constant schedule sets each update's LR),
best-validation checkpointing. The loss is `echoflow_torch.train.losses`.

A train step runs in fp32 by default: callers on the card turn TF32 off
for cuDNN and matmul (`train_clasfv_torch.py` and `create_train_state`
do). The model runs its own forward (autograd, train-mode BatchNorm with
flax's running-statistics update); its warps go through the CUDA kernels
K2-K4 on the card. `TrainConfig.compute_dtype=torch.bfloat16` runs the
model in bf16 under flax's mixed-precision rule (parameters, Adam state
and running statistics stay fp32; see `models/r2plus1d.py`); the loss and
its warps stay fp32. `remat=True` rematerializes the model's forward in
the backward (`torch.utils.checkpoint`), as echoflow's `jax.checkpoint`:
the loss chain is not recomputed, and the recompute does not move
BatchNorm's running statistics a second time.

`fit` runs on the model's device. `fit_on_mesh` is echoflow's data
parallelism over torch.distributed: one process per device, each rank
taking its contiguous shard of every global batch, the gradients averaged
over the ranks by one all-reduce after the backward (what XLA inserts into
echoflow's step on a `data` mesh), with BatchNorm's statistics, the OTA
smoothness and the logged metrics computed over the global batch, so a
step on W ranks of B/W samples is the step on one device with the whole
batch B (the reference's DataParallel kept per-replica BatchNorm
statistics). On the card both run their steps as CUDA graphs
(`compiled_steps`, `train/graph.py`).
"""

from __future__ import annotations

import contextlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from echoflow_torch.models.r2plus1d import create_model, frozen_running_stats, sync_batchnorm
from echoflow_torch.parallel.mesh import average_gradients, shard_batch
from echoflow_torch.train.graph import graphed
from echoflow_torch.train.losses import (
    clasfv_total_loss,
    clasfv_total_loss_fused,
    ed_es_only_total_loss,
)
from echoflow_torch.utils.device import upload
from echoflow_torch.utils.profiling import span


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_drop_step: int | None = None   # update index of the epoch-3 LR drop
    lr_after_drop: float = 1e-5
    clip_length: int = 32
    image_size: tuple = (112, 112)
    batch_size: int = 4
    # The model's compute dtype (parameters and Adam state stay fp32).
    # fp32 is the reference-parity default; bf16 is an opt-in that changes
    # the optimization trajectory (echoflow's end-metric study,
    # benchmarks/bf16_train_study.json: ES Dice 0.0056 below fp32).
    compute_dtype: torch.dtype = torch.float32
    # The network's backbone: "r2plus1d_18" (CLAS-FV as published) or
    # "ir_csn_152" (`models/r2plus1d.motion_seg_net`).
    backbone: str = "r2plus1d_18"


@dataclass
class TrainState:
    """The model (train mode, on its device), its Adam optimizer, the LR
    schedule, the number of updates taken, and the training generator. No
    step draws from the generator yet; it is checkpointed and restored so a
    resumed run continues the same stream. Under data parallelism
    (`data_parallel`) `group` is the process group of the ranks and `grads`
    the flat buffer whose views are the parameters' gradients; both are
    None in a single process."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    generator: torch.Generator | None = field(default=None, repr=False)
    group: object = field(default=None, repr=False)
    grads: torch.Tensor | None = field(default=None, repr=False)


def lr_schedule(cfg: TrainConfig):
    """LR of the update with 0-based index k: `cfg.lr`, and from
    k >= lr_drop_step on `cfg.lr_after_drop` (optax's
    piecewise_constant_schedule, as echoflow uses it)."""
    if cfg.lr_drop_step is None:
        return lambda step: cfg.lr
    drop, scale = cfg.lr_drop_step, cfg.lr_after_drop / cfg.lr
    return lambda step: cfg.lr * scale if step >= drop else cfg.lr


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """`optax.adam`: betas (0.9, 0.999), eps 1e-8 outside the square root,
    no eps_root, no weight decay. The LR is set per update from the
    schedule. On the card Adam is capturable (its step count and bias
    correction on the device) and its LR a 0-d float32 tensor there, so a
    CUDA graph of the step (`train/graph.py`) reads each update's LR from
    it; on the CPU the LR is a float."""
    params = list(params)
    device = params[0].device
    if device.type != "cuda":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(params, lr=torch.full((), cfg.lr, device=device),
                            betas=(0.9, 0.999), eps=1e-8, capturable=True)


def create_train_state(seed: int, cfg: TrainConfig, device="cuda") -> TrainState:
    """A seeded full-width MotionNet over `cfg.backbone` (`create_model`'s
    init) in train mode on `device`, with its optimizer and a generator on the same device. The
    default device is the card; without one this raises. The model
    computes in `cfg.compute_dtype` (fp32 leaves it to the parameters'
    dtype, so a caller may cast the model to float64); its parameters
    stay fp32. On CUDA, TF32 is turned off for cuDNN and matmul
    (process-wide), so the fp32 parts stay fp32."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("create_train_state: no CUDA device (pass device='cpu' "
                               "to train on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model(seed=seed, backbone=cfg.backbone).to(device).train()
    if cfg.compute_dtype != torch.float32:
        model.compute_dtype = cfg.compute_dtype
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=lr_schedule(cfg), generator=generator)


@contextlib.contextmanager
def _cpu_conv_backend(model):
    """oneDNN off for a train step of a bf16 model on the CPU: torch 2.11's
    oneDNN computes a NaN weight gradient for a bf16 (3, 1, 1) conv over a
    2-frame input (layer3's temporal conv at 8 frames; the conv alone, any
    seed), and torch's own CPU conv kernels compute it. The forward runs
    on the same kernels as the backward, so a rematerialized step's
    recompute is the first forward's bit for bit. A CPU bf16 step at
    (2, 3, 8, 32, 32) takes about 20x as long as with oneDNN. Anywhere
    else this changes nothing."""
    if model.compute_dtype != torch.bfloat16 or next(model.parameters()).is_cuda:
        yield
        return
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = enabled


def _apply_update(state: TrainState, total):
    """Backward and one Adam update at the schedule's LR. Like optax, every
    parameter is updated: one the loss does not reach (the unused Kinetics
    fc) gets a zero gradient, so its Adam state exists and stays 0.

    On the card the gradients stay the same tensors from step to step
    (zeroed in place; the backward adds into them), as a CUDA graph of the
    step needs. Under data parallelism they are views of `state.grads`,
    zeroed in place on every device and averaged over the ranks after the
    backward (`parallel.average_gradients`). A tensor LR is written here,
    except while a graph is captured: its wrapper writes it before each
    replay (`train/graph.py`)."""
    opt = state.optimizer
    with span("train.backward", device=total.device):
        if state.grads is not None:
            state.grads.zero_()
        else:
            opt.zero_grad(set_to_none=not total.is_cuda)
        total.backward()
        if state.grads is not None:
            average_gradients(state.grads, state.group)
    with span("train.optimizer", device=total.device):
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            if not isinstance(group["lr"], torch.Tensor):
                group["lr"] = lr
            elif not (group["lr"].is_cuda and torch.cuda.is_current_stream_capturing()):
                group["lr"].fill_(lr)
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
    state.step += 1


DICE_EPS = 1e-5


def _lv_dice_sums(logits, label):
    """(sum a*b, sum a, sum b) of the argmax LV masks a of gathered ED/ES
    logits and b of the labels. The argmax LV Dice (the running metric the
    reference prints, train_test.py:96-100; echoflow's `_soft_lv_dice`) is
    2 sum(a*b) / (sum a + sum b + 1e-5)."""
    a = (torch.argmax(logits, dim=1) == 1).float()
    b = (label == 1).float()
    return torch.stack([torch.sum(a * b), torch.sum(a), torch.sum(b)])


def _step_metrics(total, aux, keys, batch, group=None):
    """The logged metrics of a step: the loss, the `keys` terms and the
    ED/ES Dice. Under a process `group` they are the global batch's: the
    terms are the mean over the ranks (each rank's is a mean over equal
    shards, or the same global value) and the Dice is the ratio of the
    all-reduced sums, all in one all-reduce that does not wait for the
    device."""
    terms = {"loss": total.detach(), **{k: aux[k].detach() for k in keys}}
    dice = torch.stack([_lv_dice_sums(aux["ed_logits"].detach(), batch["ed_label"]),
                        _lv_dice_sums(aux["es_logits"].detach(), batch["es_label"])])
    if group is not None:
        import torch.distributed as dist

        values = torch.stack(list(terms.values()))
        packed = torch.cat([values, dice.reshape(-1).to(values.dtype)])
        dist.all_reduce(packed, group=group)
        terms = dict(zip(terms, packed[:len(terms)] / dist.get_world_size(group)))
        dice = packed[len(terms):].reshape(2, 3).to(dice.dtype)   # counts: exact
    ratio = 2.0 * dice[:, 0] / (dice[:, 1] + dice[:, 2] + DICE_EPS)
    return {**terms, "ed_dice": ratio[0], "es_dice": ratio[1]}


@contextlib.contextmanager
def _recompute(model):
    with span("train.recompute"), frozen_running_stats(model):
        yield


def _model_forward(model, video, remat: bool):
    """The model's forward of one video batch. With `remat` only its input
    is kept for the backward, which runs the forward again when it first
    needs an activation (`torch.utils.checkpoint`, non-reentrant), with
    BatchNorm's running statistics frozen: the first forward counted this
    batch. The forward draws no random numbers, so no RNG state is kept."""
    if not remat:
        return model(video)
    return checkpoint(model, video, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(model)))


def _forwards(state: TrainState, *videos, remat: bool = False):
    """The model's train-mode forward of each video batch."""
    state.model.train()
    return [_model_forward(state.model, v, remat) for v in videos]


def make_train_step(fused_ota: bool = True, remat: bool = False):
    """Returns train_step(state, batch) -> (state, metrics). The step
    updates the model and optimizer in place; metrics are 0-d tensors on
    the model's device (read them only when logging).

    `fused_ota` (default) runs OTA's warps inside the chain loop
    (`clasfv_total_loss_fused`); False is the reference-literal schedule.
    `remat` recomputes the model's forward in the backward instead of
    keeping its activations (`_model_forward`); the values are the same.
    Batch keys: video (N, 3, T, H, W) float32, ed_label/es_label (N, H, W)
    int, ed_idx/es_idx (N,) int, all on the model's device."""
    loss_fn = clasfv_total_loss_fused if fused_ota else clasfv_total_loss

    def train_step(state: TrainState, batch):
        device = batch["video"].device
        with _cpu_conv_backend(state.model):
            with span("train.forward", device=device):
                (seg, motion), = _forwards(state, batch["video"], remat=remat)
            with span("train.ota_and_chains", device=device):
                total, aux = loss_fn(batch["video"], seg, motion, batch["ed_label"],
                                     batch["es_label"], batch["ed_idx"], batch["es_idx"],
                                     group=state.group)
            _apply_update(state, total)
        return state, _step_metrics(total, aux, ("ota", "sgs", "ots", "edes_bce"), batch,
                                    state.group)

    return train_step


def make_ed_es_only_train_step(remat: bool = False):
    """train_step(state, batch) -> (state, metrics) for the ed-or-es-only
    recipe: two forward passes per step, one on the ED-covering clips and
    one on the ES-covering clips, as the reference runs them (BatchNorm
    sees each clip set as its own batch, and moves its running statistics
    once for each, in that order, with `remat` too). Batch keys:
    ed_video/es_video (N, 3, T, H, W), ed_label/es_label (N, H, W),
    ed_idx/es_idx (N,)."""

    def train_step(state: TrainState, batch):
        device = batch["ed_video"].device
        with _cpu_conv_backend(state.model):
            with span("train.forward", device=device):
                (ed_seg, ed_motion), (es_seg, es_motion) = _forwards(
                    state, batch["ed_video"], batch["es_video"], remat=remat)
            with span("train.ota_and_chains", device=device):
                total, aux = ed_es_only_total_loss(
                    batch["ed_video"], batch["es_video"], ed_seg, ed_motion, es_seg,
                    es_motion, batch["ed_label"], batch["es_label"], batch["ed_idx"],
                    batch["es_idx"], group=state.group)
            _apply_update(state, total)
        return state, _step_metrics(total, aux, ("ota", "flow", "edes_bce"), batch,
                                    state.group)

    return train_step


def make_eval_step():
    """eval_step(state, batch) -> metrics: eval-mode forward (running
    statistics), the reference-schedule loss, no gradient; under data
    parallelism the global batch's (see `_step_metrics`)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        try:
            seg, motion = model(batch["video"])
            total, aux = clasfv_total_loss(batch["video"], seg, motion, batch["ed_label"],
                                           batch["es_label"], batch["ed_idx"], batch["es_idx"],
                                           group=state.group)
        finally:
            model.train()
        return _step_metrics(total, aux, (), batch, state.group)

    return eval_step


def make_ed_es_only_eval_step():
    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        try:
            ed_seg, ed_motion = model(batch["ed_video"])
            es_seg, es_motion = model(batch["es_video"])
            total, aux = ed_es_only_total_loss(
                batch["ed_video"], batch["es_video"], ed_seg, ed_motion, es_seg, es_motion,
                batch["ed_label"], batch["es_label"], batch["ed_idx"], batch["es_idx"],
                group=state.group)
        finally:
            model.train()
        return _step_metrics(total, aux, (), batch, state.group)

    return eval_step


def prefetch_to_device(batch_iterator, device, depth: int = 2):
    """Keeps `depth` batches in flight: each host batch is copied from
    pinned memory with `non_blocking`, so the copy of batch i+1 overlaps
    the device work of batch i. The work of each `next()` (the next host
    batches and their uploads) runs in the span `train.prefetch`."""
    device = torch.device(device)
    batches, end = iter(batch_iterator), object()
    queue: deque = deque()
    batch = None
    while True:
        with span("train.prefetch"):
            while batch is not end and len(queue) < depth:
                batch = next(batches, end)
                if batch is not end:
                    queue.append({k: upload(torch.as_tensor(np.asarray(v)), device)
                                  for k, v in batch.items()})
            if not queue:
                return
            out = queue.popleft()
        yield out


def compiled_steps(state: TrainState, step_factory=None, eval_step_factory=None):
    """(train_step, eval_step) of the recipe (`step_factory`, default
    `make_train_step`; `eval_step_factory`, default `make_eval_step`) as
    `fit` runs them for `state`: on the card, in one process or under data
    parallelism, each as CUDA graphs (`graph.graphed`), as echoflow runs
    both under `jax.jit`; on the CPU, the eager steps."""
    train_step = (step_factory or make_train_step)()
    eval_step = (eval_step_factory or make_eval_step)()
    if next(state.model.parameters()).is_cuda:
        return graphed(train_step, state), graphed(eval_step, state)
    return train_step, eval_step


def fit(state: TrainState, train_batches, eval_batches=None, log_every: int = 50,
        log_fn=print, metrics_logger=None, prefetch_depth: int = 2, steps=None):
    """Epoch runner over iterables of host batches (dicts of numpy arrays
    whose leading axis is the batch) on the model's device. `steps` is the
    pair (train step, eval step) that it runs, from `compiled_steps`
    (default: `compiled_steps(state)`, the fused CLAS-FV recipe; a caller
    that runs `fit` once an epoch makes them once a run, so an epoch does
    not capture its graphs again). Every
    `log_every` steps the metrics are read, logged (and written to
    `metrics_logger`, a `utils.metrics_log.MetricsLogger`, at the update
    count) and appended to the history; with `eval_batches`, one validation
    pass runs on the final state and its batch-mean metrics are appended
    with an ``eval_`` prefix. Returns (state, history)."""
    device = next(state.model.parameters()).device
    train_step, eval_step = steps or compiled_steps(state)

    def record(m, line):
        history.append(m)
        if metrics_logger is not None:
            metrics_logger.log(state.step, m)
        log_fn(line + " ".join(f"{k}={v:.4f}" for k, v in m.items()))

    history = []
    for i, batch in enumerate(prefetch_to_device(train_batches, device, prefetch_depth), 1):
        state, metrics = train_step(state, batch)
        if i % log_every == 0:
            record({k: float(v) for k, v in metrics.items()}, f"step {i}: ")

    if eval_batches is not None:
        sums: dict = {}
        count = 0
        for batch in prefetch_to_device(eval_batches, device, prefetch_depth):
            for k, v in eval_step(state, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if count:
            record({f"eval_{k}": v / count for k, v in sums.items()}, "eval: ")
    return state, history


def data_parallel(state: TrainState, group=None) -> TrainState:
    """This rank's state for data-parallel training over `group` (default:
    the whole default process group, which must be up: `init_distributed`).
    Every rank of the group calls it, in the same order.

    - Rank 0's parameters and buffers are broadcast once (the group's
      communicator is made here, before any step or capture).
    - Every parameter's gradient becomes a view of one flat buffer,
      `state.grads`, which `_apply_update` zeroes in place and averages
      over the ranks with one all-reduce after the backward (what XLA
      inserts into echoflow's step, and what a CUDA graph of the step can
      hold: the gradients never move). The Kinetics fc, which the forward
      never reads, gets 0 on every rank, as in one process.
    - BatchNorm, the coupled loss term and the metrics reduce over the same
      group, in program order on every rank.
    - BatchNorm's running statistics are the global batch's on every rank,
      so no buffer is broadcast after this."""
    if state.group is not None:
        return state
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("data_parallel: no process group (parallel.init_distributed)")
    group = group or dist.group.WORLD
    model = state.model
    source = dist.get_process_group_ranks(group)[0]
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            dist.broadcast(t, src=source, group=group)
    sync_batchnorm(model, group)
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype,
                       device=params[0].device)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    state.group, state.grads = group, flat
    return state


def _sharded(batches, rank: int, world: int):
    return (shard_batch(b, rank, world) for b in batches)


def fit_on_mesh(state: TrainState, train_batches, eval_batches=None, group=None,
                log_every: int = 50, log_fn=print, metrics_logger=None,
                prefetch_depth: int = 2, steps=None):
    """`fit` data-parallel over `group` (default: the default process
    group), one process per device (echoflow's `fit_on_mesh` over a `data`
    mesh). `train_batches` and `eval_batches` yield the *global* host
    batches on every rank; each rank prefetches its contiguous shard
    (`parallel.shard_batch`; the batch must divide by the world size). A
    step on W ranks is the single-device step on the whole batch (see the
    module docstring); the logged metrics and the eval pass are the global
    batch's. Rank 0 alone calls `log_fn` and `metrics_logger`; every rank
    returns the same history. `steps` is the pair `fit` runs, from
    `compiled_steps` of the data-parallel state (default: the fused
    CLAS-FV recipe's; a caller that runs `fit_on_mesh` once an epoch makes
    them once a run). Returns (state, history)."""
    import torch.distributed as dist

    state = data_parallel(state, group)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    lead = rank == 0
    return fit(state, _sharded(train_batches, rank, world),
               None if eval_batches is None else _sharded(eval_batches, rank, world),
               log_every=log_every, log_fn=log_fn if lead else (lambda line: None),
               metrics_logger=metrics_logger if lead else None,
               prefetch_depth=prefetch_depth,
               steps=steps or compiled_steps(state))
