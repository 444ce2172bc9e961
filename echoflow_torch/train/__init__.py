"""Training: CLAS-FV losses, the train loop, checkpointing (port of
`echoflow.train`).

`train_epoch` / `test_epoch` are the reference-named entry points
(src/train_test.py `train`/`test`); the loop, in one process or
data-parallel, lives in `echoflow_torch.train.loop`.
"""

from echoflow_torch.train import losses  # noqa: F401
from echoflow_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_jax_checkpoint,
    load_model_variables,
    restore_train_state,
    save_checkpoint,
)
from echoflow_torch.train.loop import (  # noqa: F401
    TrainConfig,
    TrainState,
    create_train_state,
    data_parallel,
    fit,
    fit_on_mesh,
    make_eval_step,
    make_optimizer,
    make_train_step,
    prefetch_to_device,
)


def _distributed(group) -> bool:
    import torch.distributed as dist

    return group is not None or dist.is_initialized()


def train_epoch(epoch, train_loader, state, group=None, log_every=280, log_fn=print):
    """One training epoch (reference `train`, src/train_test.py:16-116):
    `train_loader` yields batch dicts (see `fit`). Under a process group
    (`group`, or the default one when it is up) the epoch runs
    data-parallel (`fit_on_mesh`, global batches); otherwise on the model's
    device. The reference printed every 280 batches; same default here.
    Returns (state, history)."""
    if _distributed(group):
        return fit_on_mesh(state, train_loader, group=group, log_every=log_every,
                           log_fn=log_fn)
    return fit(state, train_loader, log_every=log_every, log_fn=log_fn)


def test_epoch(epoch, test_loader, state, group=None, log_fn=print):
    """One validation epoch (reference `test`, src/train_test.py:119-206).
    Returns the per-batch losses, printing the summary as the reference
    does. Under a process group each rank evaluates its shard of every
    global batch and the losses and Dice are the global batch's; rank 0
    prints."""
    import numpy as np
    import torch.distributed as dist

    from echoflow_torch.train.loop import _sharded

    device = next(state.model.parameters()).device
    batches = test_loader
    if _distributed(group):
        state = data_parallel(state, group)
        batches = _sharded(test_loader, dist.get_rank(group), dist.get_world_size(group))
        if dist.get_rank(group) != 0:
            log_fn = lambda line: None   # noqa: E731
    eval_step = make_eval_step()
    losses_, ed_d, es_d = [], [], []
    for batch in prefetch_to_device(batches, device):
        metrics = eval_step(state, batch)
        losses_.append(float(metrics["loss"]))
        ed_d.append(float(metrics["ed_dice"]))
        es_d.append(float(metrics["es_dice"]))
    log_fn("-" * 30 + "Validation" + "-" * 30)
    log_fn("\nED LV: {:.3f}".format(np.mean(ed_d) if ed_d else float("nan")))
    log_fn("ES LV: {:.3f}".format(np.mean(es_d) if es_d else float("nan")))
    log_fn("\nValid set: Average loss: {:.4f}\n".format(
        np.mean(losses_) if losses_ else float("nan")))
    return losses_


# Reference-named aliases (src/train_test.py).
train = train_epoch
test = test_epoch
