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
K2-K4 on the card.

`fit` is `fit_on_mesh` on one device; the mesh and data parallelism wait
for the port's multi-GPU slice.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from echoflow_torch.models.r2plus1d import create_model
from echoflow_torch.train.losses import (
    clasfv_total_loss,
    clasfv_total_loss_fused,
    ed_es_only_total_loss,
)
from echoflow_torch.utils.device import upload


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_drop_step: int | None = None   # update index of the epoch-3 LR drop
    lr_after_drop: float = 1e-5
    clip_length: int = 32
    image_size: tuple = (112, 112)
    batch_size: int = 4


@dataclass
class TrainState:
    """The model (train mode, on its device), its Adam optimizer, the LR
    schedule, the number of updates taken, and the training generator. No
    step draws from the generator yet; it is checkpointed and restored so a
    resumed run continues the same stream."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    generator: torch.Generator | None = field(default=None, repr=False)


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
    schedule."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(seed: int, cfg: TrainConfig, device="cuda") -> TrainState:
    """A seeded full-width MotionNet (`create_model`'s init) in train mode on
    `device`, with its optimizer and a generator on the same device. The
    default device is the card; without one this raises. fp32: on CUDA,
    TF32 is turned off for cuDNN and matmul (process-wide)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("create_train_state: no CUDA device (pass device='cpu' "
                               "to train on the CPU)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model(seed=seed).to(device).train()
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=lr_schedule(cfg), generator=generator)


def _apply_update(state: TrainState, total):
    """Backward and one Adam update at the schedule's LR. Like optax, every
    parameter is updated: one the loss does not reach (the unused Kinetics
    fc) gets a zero gradient, so its Adam state exists and stays 0."""
    opt = state.optimizer
    with record_function("echoflow_torch.train.backward"):
        opt.zero_grad(set_to_none=True)
        total.backward()
    with record_function("echoflow_torch.train.optimizer"):
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
    state.step += 1


def _soft_lv_dice(logits, label, eps: float = 1e-5):
    """Argmax LV Dice of gathered ED/ES logits vs labels (the running metric
    the reference prints, train_test.py:96-100)."""
    pred = torch.argmax(logits, dim=1)
    a = (pred == 1).float()
    b = (label == 1).float()
    return 2.0 * torch.sum(a * b) / (torch.sum(a) + torch.sum(b) + eps)


def make_train_step(fused_ota: bool = True):
    """Returns train_step(state, batch) -> (state, metrics). The step
    updates the model and optimizer in place; metrics are 0-d tensors on
    the model's device (read them only when logging).

    `fused_ota` (default) runs OTA's warps inside the chain loop
    (`clasfv_total_loss_fused`); False is the reference-literal schedule.
    Batch keys: video (N, 3, T, H, W) float32, ed_label/es_label (N, H, W)
    int, ed_idx/es_idx (N,) int, all on the model's device."""
    loss_fn = clasfv_total_loss_fused if fused_ota else clasfv_total_loss

    def train_step(state: TrainState, batch):
        model = state.model.train()
        with record_function("echoflow_torch.train.forward"):
            seg, motion = model(batch["video"])
        with record_function("echoflow_torch.train.ota_and_chains"):
            total, aux = loss_fn(batch["video"], seg, motion, batch["ed_label"],
                                 batch["es_label"], batch["ed_idx"], batch["es_idx"])
        _apply_update(state, total)
        metrics = {k: aux[k].detach() for k in ("ota", "sgs", "ots", "edes_bce")}
        metrics["loss"] = total.detach()
        metrics["ed_dice"] = _soft_lv_dice(aux["ed_logits"].detach(), batch["ed_label"])
        metrics["es_dice"] = _soft_lv_dice(aux["es_logits"].detach(), batch["es_label"])
        return state, metrics

    return train_step


def make_ed_es_only_train_step():
    """train_step(state, batch) -> (state, metrics) for the ed-or-es-only
    recipe: two forward passes per step, one on the ED-covering clips and
    one on the ES-covering clips, as the reference runs them (BatchNorm
    sees each clip set as its own batch). Batch keys: ed_video/es_video
    (N, 3, T, H, W), ed_label/es_label (N, H, W), ed_idx/es_idx (N,)."""

    def train_step(state: TrainState, batch):
        model = state.model.train()
        with record_function("echoflow_torch.train.forward"):
            ed_seg, ed_motion = model(batch["ed_video"])
            es_seg, es_motion = model(batch["es_video"])
        with record_function("echoflow_torch.train.ota_and_chains"):
            total, aux = ed_es_only_total_loss(
                batch["ed_video"], batch["es_video"], ed_seg, ed_motion, es_seg, es_motion,
                batch["ed_label"], batch["es_label"], batch["ed_idx"], batch["es_idx"])
        _apply_update(state, total)
        metrics = {k: aux[k].detach() for k in ("ota", "flow", "edes_bce")}
        metrics["loss"] = total.detach()
        metrics["ed_dice"] = _soft_lv_dice(aux["ed_logits"].detach(), batch["ed_label"])
        metrics["es_dice"] = _soft_lv_dice(aux["es_logits"].detach(), batch["es_label"])
        return state, metrics

    return train_step


def make_eval_step():
    """eval_step(state, batch) -> metrics: eval-mode forward (running
    statistics), the reference-schedule loss, no gradient."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model.eval()
        try:
            seg, motion = model(batch["video"])
            total, aux = clasfv_total_loss(batch["video"], seg, motion, batch["ed_label"],
                                           batch["es_label"], batch["ed_idx"], batch["es_idx"])
        finally:
            model.train()
        return {"loss": total,
                "ed_dice": _soft_lv_dice(aux["ed_logits"], batch["ed_label"]),
                "es_dice": _soft_lv_dice(aux["es_logits"], batch["es_label"])}

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
                batch["ed_label"], batch["es_label"], batch["ed_idx"], batch["es_idx"])
        finally:
            model.train()
        return {"loss": total,
                "ed_dice": _soft_lv_dice(aux["ed_logits"], batch["ed_label"]),
                "es_dice": _soft_lv_dice(aux["es_logits"], batch["es_label"])}

    return eval_step


def prefetch_to_device(batch_iterator, device, depth: int = 2):
    """Keeps `depth` batches in flight: each host batch is copied from
    pinned memory with `non_blocking`, so the copy of batch i+1 overlaps
    the device work of batch i."""
    device = torch.device(device)
    queue: deque = deque()
    for batch in batch_iterator:
        queue.append({k: upload(torch.as_tensor(np.asarray(v)), device)
                      for k, v in batch.items()})
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def fit(state: TrainState, train_batches, eval_batches=None, log_every: int = 50,
        log_fn=print, prefetch_depth: int = 2, step_factory=None, eval_step_factory=None):
    """Epoch runner over iterables of host batches (dicts of numpy arrays
    whose leading axis is the batch) on the model's device: `fit_on_mesh`
    on one device. `step_factory` selects the recipe's train step (default
    `make_train_step`), `eval_step_factory` its eval step (default
    `make_eval_step`). Every `log_every` steps the metrics are read, logged
    and appended to the history; with `eval_batches`, one validation pass
    runs on the final state and its batch-mean metrics are appended with
    an ``eval_`` prefix. Returns (state, history)."""
    device = next(state.model.parameters()).device
    train_step = (step_factory or make_train_step)()
    history = []
    for i, batch in enumerate(prefetch_to_device(train_batches, device, prefetch_depth), 1):
        state, metrics = train_step(state, batch)
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append(m)
            log_fn(f"step {i}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))

    if eval_batches is not None:
        eval_step = (eval_step_factory or make_eval_step)()
        sums: dict = {}
        count = 0
        for batch in prefetch_to_device(eval_batches, device, prefetch_depth):
            for k, v in eval_step(state, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        if count:
            m = {f"eval_{k}": v / count for k, v in sums.items()}
            history.append(m)
            log_fn("eval: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    return state, history
