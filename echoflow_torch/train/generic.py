"""Generic training harness (legacy CAMUS-era surface; port of
`echoflow.train.generic`).

Equivalents of reference src/utils/torch_utils.py:58-855: the dict-pipeline
dataset/batching utilities, the generic one-epoch train/validation loops
with gradient accumulation ("effective batch size"), the foreground Dice
loss, and the ACNN (anatomically-constrained network) variants that
regularize segmentation with an autoencoder shape prior (Oktay et al.;
reference run_training_ACNN, torch_utils.py:639-761).

echoflow's loops take `apply_fn(params, x)` and an optax optimizer state;
here the model is an `nn.Module` and `MultiSteps` holds what optax's
`MultiSteps(adamw)` state holds (the accumulated gradient, the mini-step
count, Adam's moments), so passing it back into the next call carries the
accumulation across epochs, as echoflow's `opt_state` does.

On the card the train step and the validation forward run as CUDA graphs
(`utils/graphs.GraphedFunction`), as echoflow jits both: the step as two
graphs, "fold" and "fold + update", which the host picks by the mini-step
count it keeps; they are made once for each model, optimizer and
criterion and replayed across epochs. The per-step `float(loss)` and the
host copy of the outputs stay, as in echoflow.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn

from echoflow_torch.metrics.camus import camus_dice_by_name, dict_extend_values
from echoflow_torch.models.flax_layers import SameConv2d, SameConvTranspose2d
from echoflow_torch.train.camus_losses import cross_entropy
from echoflow_torch.train.graph import optimizer_bindings
from echoflow_torch.utils.cleanup import cleanup_segmentation
from echoflow_torch.utils.device import upload
from echoflow_torch.utils.graphs import GraphedFunction, model_memory, module_bindings


# --------------------------------------------------------------- data plumbing

class TransformDataset:
    """List of record dicts + transform pipelines (reference
    TransformDataset, torch_utils.py:143-208): `global_transforms` run once
    at construction (loading, resize), `augment_transforms` run per access."""

    def __init__(self, records: Sequence[dict], global_transforms=(),
                 augment_transforms=()):
        self.records = []
        for rec in records:
            data = dict(rec)
            for tr in global_transforms:
                data = tr(data)
            self.records.append(data)
        self.augment_transforms = list(augment_transforms)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx):
        data = dict(self.records[idx])
        for tr in self.augment_transforms:
            data = tr(data)
        return data


def collate_dicts(items: Sequence[dict]) -> dict:
    """Stack same-keyed numpy leaves (reference torch_collate,
    torch_utils.py:215-222)."""
    out = {}
    for key in items[0]:
        vals = [np.asarray(it[key]) for it in items]
        out[key] = np.stack(vals)
    return out


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   rng: np.random.RandomState | None = None,
                   drop_last: bool = True):
    """Minimal BatchIterator (reference torch_utils.py:58-139), batches of
    numpy arrays in the same order as echoflow's."""
    rng = rng or np.random
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        yield collate_dicts([dataset[int(i)] for i in idx])


# -------------------------------------------------------------------- losses

class BetterLoss:
    """Weighted cross-entropy as a callable loss object (reference
    BetterLoss, torch_utils.py:230-242: a class wrapper over
    nn.CrossEntropyLoss with optional per-class weights)."""

    def __init__(self, weight=None):
        self.weight = None if weight is None else torch.as_tensor(
            np.asarray(weight, np.float32))
        self._on = {}   # the weight on each device, copied once (a graph cannot copy it)

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=1)
        labels = labels.long()
        picked = torch.gather(logp, 1, labels[:, None])[:, 0]
        if self.weight is None:
            return -torch.mean(picked)
        # torch's weighted CE: sum(w_y * nll) / sum(w_y).
        if logits.device not in self._on:
            self._on[logits.device] = upload(self.weight, logits.device)
        w = self._on[logits.device][labels]
        return -torch.sum(w * picked) / torch.sum(w)


class OneHotBatch:
    """Batch transform: integer labels (N, 1, H, W) or (N, H, W) ->
    one-hot (N, C, H, W) float (reference OneHotBatch,
    torch_utils.py:612-635). Faithful quirk: like the reference's
    onehot_initialization_v2, the channel count is inferred per entry as
    max(label)+1 — the stored labelCount is not consulted — so a batch
    whose entries peak at different labels fails to stack, exactly as the
    original does."""

    def __init__(self, labelCount: int = 4, outtype=np.float32):
        self.labelCount = labelCount
        self.outtype = outtype

    def _one_hot(self, a: np.ndarray) -> np.ndarray:
        ncols = int(a.max()) + 1
        out = np.zeros((ncols, a.size), dtype=self.outtype)
        out[a.ravel(), np.arange(a.size)] = 1
        return out.reshape((ncols,) + a.shape)

    def __call__(self, data) -> np.ndarray:
        return np.stack([self._one_hot(np.asarray(entry).squeeze())
                         for entry in data])


def foreground_dice_loss(logits: torch.Tensor, one_hot: torch.Tensor) -> torch.Tensor:
    """Softmax Dice summed over foreground classes, negated, per batch item
    (reference DiceLoss, torch_utils.py:248-288)."""
    probs = torch.softmax(logits, dim=1)
    num = torch.sum(probs * one_hot, dim=(2, 3))
    den = torch.sum(probs * probs, dim=(2, 3)) + torch.sum(one_hot * one_hot, dim=(2, 3))
    dice = 2.0 * num / den
    return -torch.sum(dice[:, 1:]) / logits.shape[0]


# ------------------------------------------------------------- optimizer

class MultiSteps:
    """`optax.MultiSteps(optax.adamw(lr, weight_decay=wd), every_k_schedule=k)`
    over `torch.optim.AdamW`: after each backward, `fold(advance())` folds
    the gradients into their running mean (optax's acc + (g - acc) /
    (n + 1)); every k-th mini-step makes one AdamW update with the mean and
    resets it, and the parameters do not move in between. AdamW as optax's:
    betas (0.9, 0.999), eps 1e-8, every parameter (biases too) decayed by
    lr * wd.

    The mini-step count is kept twice: `mini_step` on the host, which says
    whether the next step updates (so `run_training` picks the "fold" or
    the "fold + update" graph), and `count`, n + 1 as a 0-d tensor beside
    the parameters, which the fold divides by (a graph replays the division
    it captured, so the divisor cannot be a host number). On the card
    AdamW is capturable with its LR a 0-d tensor there, and the gradients
    exist from the start and are zeroed in place, so a graph holds them; on
    the CPU `zero_grad` sets them to None."""

    def __init__(self, params, every_k: int = 1, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-5):
        self.params = [p for p in params if p.requires_grad]
        device = self.params[0].device
        self.on_card = device.type == "cuda"
        lr = torch.full((), learning_rate, device=device) if self.on_card else learning_rate
        self.inner = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay, capturable=self.on_card)
        self.every_k = every_k
        self.mini_step = 0
        self.count = torch.zeros((), dtype=self.params[0].dtype, device=device)
        self.acc = [torch.zeros_like(p) for p in self.params]
        if self.on_card:
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.steps: dict = {}   # `run_training`'s step of each (model, criterion)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=not self.on_card)

    def advance(self) -> bool:
        """Whether the step being taken makes the update; moves `mini_step`
        on to the next one."""
        update = self.mini_step == self.every_k - 1
        self.mini_step = 0 if update else self.mini_step + 1
        return update

    @torch.no_grad()
    def fold(self, update: bool):
        """The device work of a step: the gradients folded into their mean
        and, with `update`, the AdamW update with it."""
        self.count.add_(1)
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / self.count)
            else:
                acc.sub_(acc / self.count)
        if not update:
            return
        for p, acc in zip(self.params, self.acc):
            if p.grad is None:
                p.grad = acc.clone()
            else:
                p.grad.copy_(acc)
            acc.zero_()
        self.count.zero_()
        self.inner.step()

    def bindings(self, update: bool) -> tuple:
        """The addresses of the tensors a graph of `fold(update)` holds."""
        ptrs = [t.data_ptr() for t in (*self.acc, self.count)]
        ptrs += [-1 if p.grad is None else p.grad.data_ptr() for p in self.params]
        return tuple(ptrs + optimizer_bindings(self.inner) if update else ptrs)


# ------------------------------------------------------------- generic loops

def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _train_step(model: nn.Module, criterion: Callable, optimizer: MultiSteps):
    """`step(inputs, targets, update)` -> (loss, outputs): one mini-step
    (the backward, `optimizer.fold(update)`, then the model's outputs on
    the inputs after it), made once for each model and criterion of the
    optimizer: as CUDA graphs on the card, the eager step on the CPU."""
    key = (model, criterion)
    if key not in optimizer.steps:
        def step(inputs, targets, update):
            optimizer.zero_grad()
            loss = criterion(model(inputs), targets)
            loss.backward()
            optimizer.fold(update)
            with torch.no_grad():
                return loss.detach(), model(inputs)

        optimizer.steps[key] = GraphedFunction(
            step, memory=model_memory(model, _device_of(model)),
            bindings=lambda update: module_bindings(model) + optimizer.bindings(update))
    return optimizer.steps[key]


def _dices(dices, outputs, labels):
    labels = np.asarray(labels)
    return dict_extend_values(dices, {k: np.asarray(v) for k, v in camus_dice_by_name(
        outputs, labels[:, None] if labels.ndim == 3 else labels).items()})


def run_training(model: nn.Module, data_iterator, effective_batchsize: int = 1,
                 criterion: Callable = cross_entropy, optimizer: MultiSteps | None = None,
                 learning_rate: float = 1e-3, weight_decay: float = 1e-5,
                 keys=("inputs", "outputs"), do_dice: bool = False,
                 do_cleaning: bool = False):
    """One epoch of generic supervised training with gradient accumulation
    (reference run_training, torch_utils.py:310-418): `model(x)` -> logits
    on the model's device. Without `optimizer` a fresh `MultiSteps` (AdamW,
    `effective_batchsize` mini-steps an update) is made; pass the returned
    one to the next call to carry the accumulation. The dice and the
    example are taken from the model after each mini-step's update, as
    echoflow takes them. Returns (model, optimizer, avg_loss, example,
    dices?)."""
    in_key, out_key = keys
    device = _device_of(model)
    if optimizer is None:
        optimizer = MultiSteps(model.parameters(), effective_batchsize, learning_rate,
                               weight_decay)
    running = 0.0
    count = 0
    dices = {}
    example = None
    model.train()
    step = _train_step(model, criterion, optimizer)
    for data in data_iterator:
        inputs = torch.as_tensor(np.asarray(data[in_key], np.float32)).to(device)
        targets = torch.as_tensor(np.asarray(data[out_key])).to(device)
        loss, outputs = step(inputs, targets, update=optimizer.advance())
        running += float(loss)
        count += 1
        outputs = outputs.cpu().numpy()
        pred_maps = cleanup_segmentation(np.argmax(outputs, axis=1)) if do_cleaning else None
        if do_dice:
            dices = _dices(dices, pred_maps if pred_maps is not None else outputs,
                           data[out_key])
        example = (outputs[0], np.asarray(data[in_key], np.float32)[0],
                   np.asarray(data[out_key])[0])

    avg = running / max(count, 1)
    if do_dice:
        return model, optimizer, avg, example, dices
    return model, optimizer, avg, example


@torch.no_grad()
def run_validation(model: nn.Module, data_iterator, criterion: Callable = cross_entropy,
                   keys=("inputs", "outputs"), do_dice: bool = False,
                   do_cleaning: bool = False, return_all: bool = False):
    """One validation pass (reference run_validation /
    run_validation_returnAll, torch_utils.py:451-600). On the card the
    forward and the criterion run as CUDA graphs, made for this pass."""
    in_key, out_key = keys
    device = _device_of(model)
    model.eval()

    def forward(inputs, targets):
        outputs = model(inputs)
        return criterion(outputs, targets), outputs

    forward = GraphedFunction(forward, memory=model_memory(model, device),
                              bindings=lambda: module_bindings(model))
    running = 0.0
    count = 0
    dices = {}
    all_outputs = []
    example = None
    for data in data_iterator:
        inputs = torch.as_tensor(np.asarray(data[in_key], np.float32)).to(device)
        targets = torch.as_tensor(np.asarray(data[out_key])).to(device)
        loss, outputs = forward(inputs, targets)
        running += float(loss)
        count += 1
        out_np = outputs.cpu().numpy()
        out_np_maps = cleanup_segmentation(np.argmax(out_np, axis=1)) if do_cleaning else None
        if do_dice:
            dices = _dices(dices, out_np_maps if out_np_maps is not None else out_np,
                           data[out_key])
        if return_all:
            all_outputs.append(out_np)
        example = (out_np[0], np.asarray(data[in_key], np.float32)[0],
                   np.asarray(data[out_key])[0])
    model.train()

    avg = running / max(count, 1)
    result = [avg, example]
    if do_dice:
        result.append(dices)
    if return_all:
        result.append(np.concatenate(all_outputs) if all_outputs else None)
    return tuple(result)


# ----------------------------------------------------------------- ACNN prior

def _down_size(size: int) -> int:
    for _ in range(3):
        size = -(-size // 2)
    return size


class ShapeAutoencoder(nn.Module):
    """Small convolutional autoencoder over one-hot label maps, the shape
    prior network of the ACNN loops (echoflow's flax `ShapeAutoencoder`,
    with flax's SAME padding). flax sizes its Dense layers from the sample
    at `init`; here `image_size` (H, W) does. `forward(x)` -> (recon, z)."""

    FLAX_LAYERS = (("Conv_0", "enc1"), ("Conv_1", "enc2"), ("Conv_2", "enc3"),
                   ("Dense_0", "to_latent"), ("Dense_1", "from_latent"),
                   ("ConvTranspose_0", "dec1"), ("ConvTranspose_1", "dec2"),
                   ("ConvTranspose_2", "dec3"))

    def __init__(self, num_classes: int = 4, latent_dim: int = 32, hidden: int = 16,
                 image_size=(64, 64)):
        super().__init__()
        self.code_shape = (2 * hidden, _down_size(image_size[0]), _down_size(image_size[1]))
        flat = int(np.prod(self.code_shape))
        self.enc1 = SameConv2d(num_classes, hidden, 3, 2)
        self.enc2 = SameConv2d(hidden, 2 * hidden, 3, 2)
        self.enc3 = SameConv2d(2 * hidden, 2 * hidden, 3, 2)
        self.to_latent = nn.Linear(flat, latent_dim)
        self.from_latent = nn.Linear(latent_dim, flat)
        self.dec1 = SameConvTranspose2d(2 * hidden, 2 * hidden, 3, 2)
        self.dec2 = SameConvTranspose2d(2 * hidden, hidden, 3, 2)
        self.dec3 = SameConvTranspose2d(hidden, num_classes, 3, 2)

    def encode(self, x):
        h = torch.relu(self.enc1(x))
        h = torch.relu(self.enc2(h))
        h = torch.relu(self.enc3(h))
        # flax flattens channels-last: (N, H, W, C).
        return self.to_latent(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))

    def forward(self, x):
        z = self.encode(x)
        c, hh, ww = self.code_shape
        h = self.from_latent(z).reshape(z.shape[0], hh, ww, c).permute(0, 3, 1, 2)
        h = torch.relu(self.dec1(h))
        h = torch.relu(self.dec2(h))
        return self.dec3(h), z


def acnn_loss(seg_logits, labels, ae: ShapeAutoencoder, prior_weight: float = 1e-2,
              num_classes: int = 4):
    """CE + prior_weight * MSE(latent(softmax(pred)), latent(one-hot(label)))
    (reference run_training_ACNN, torch_utils.py:639-761)."""
    from echoflow_torch.ops.normalize import one_hot_channels

    ce = cross_entropy(seg_logits, labels)
    probs = torch.softmax(seg_logits, dim=1)
    one_hot = one_hot_channels(labels[:, None], num_classes)
    z_pred = ae.encode(probs)
    z_true = ae.encode(one_hot).detach()
    prior = torch.mean((z_pred - z_true) ** 2)
    return ce + prior_weight * prior


def run_training_acnn(model: nn.Module, ae: ShapeAutoencoder, data_iterator,
                      effective_batchsize: int = 1, prior_weight: float = 1e-2,
                      learning_rate: float = 1e-3, weight_decay: float = 1e-5,
                      keys=("images", "labels")):
    """One epoch of ACNN training: the autoencoder is frozen and only the
    segmentation network updates, with a fresh optimizer every call as in
    echoflow (reference torch_utils.py:639-761)."""
    ae.requires_grad_(False)
    criterion = lambda logits, labels: acnn_loss(logits, labels, ae, prior_weight)  # noqa: E731
    return run_training(model, data_iterator, effective_batchsize, criterion=criterion,
                        learning_rate=learning_rate, weight_decay=weight_decay, keys=keys)


def run_validation_acnn(model: nn.Module, ae: ShapeAutoencoder, data_iterator,
                        prior_weight: float = 1e-2, keys=("images", "labels"),
                        do_dice: bool = True, do_cleaning: bool = False):
    """One ACNN validation pass: the generic pass with the shape-prior
    criterion, so the reported loss is CE + prior, as training optimizes
    (reference run_validation_ACNN, torch_utils.py:765-854)."""
    criterion = lambda logits, labels: acnn_loss(logits, labels, ae, prior_weight)  # noqa: E731
    return run_validation(model, data_iterator, criterion=criterion, keys=keys,
                          do_dice=do_dice, do_cleaning=do_cleaning)


# Reference-cased aliases (torch_utils.py names).
run_training_ACNN = run_training_acnn
run_validation_ACNN = run_validation_acnn
