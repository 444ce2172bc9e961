"""Checkpointing (port of `echoflow.train.checkpoint`).

The reference saves `{"model": state_dict, "optimizer": state_dict}` on the
best validation loss and restores with `torch.load(p)["model"]` (train
notebook cell 10; motion_segment.py:72). The port keeps that layout and
adds the update count, the training generator's state and the caller's
`extra` (epoch, validation loss):

    {"model", "optimizer", "step", "rng", "extra"}

so a port checkpoint also loads wherever a reference one does.
`load_jax_checkpoint` reads an `echoflow` training checkpoint (a pickled
numpy pytree with optax's state) without jax or optax, so a run started on
the TPU resumes on the card.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from echoflow_torch.models.convert import load_reference_state_dict, state_dict_from_variables


def save_checkpoint(path: str, state, extra: dict | None = None):
    """state: a `TrainState`. Written with `torch.save`."""
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "rng": state.generator.get_state() if state.generator is not None else None,
        "extra": dict(extra or {}),
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(p)   # a reader never sees a half-written checkpoint


def load_checkpoint(path: str) -> dict:
    """The payload of a port checkpoint (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class _OptaxUnpickler(pickle.Unpickler):
    """Unpickles an echoflow checkpoint without optax: each optax state
    class (a NamedTuple such as ScaleByAdamState(count, mu, nu)) becomes a
    plain tuple subclass of the same name. Anything else from jax, flax or
    optax is refused."""

    _classes: dict = {}

    def find_class(self, module, name):
        if module.split(".")[0] == "optax":
            cls = self._classes.get(name)
            if cls is None:
                cls = type(name, (tuple,), {"__new__": lambda c, *a: tuple.__new__(c, a)})
                self._classes[name] = cls
            return cls
        if module.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(f"{module}.{name} in a checkpoint: only numpy "
                                         "leaves and optax states are read")
        return super().find_class(module, name)


def _adam_state(opt_state):
    """(count, mu, nu) of the ScaleByAdamState inside optax's chain state."""
    for part in opt_state if isinstance(opt_state, tuple) else ():
        if type(part).__name__ == "ScaleByAdamState":
            return part
        if isinstance(part, tuple):
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def load_jax_checkpoint(path: str) -> dict:
    """An `echoflow` `.pkl` training checkpoint as the port's tensors:

        {"model": state dict, "exp_avg": {param name: tensor},
         "exp_avg_sq": {...}, "adam_step": int or None, "step": int,
         "extra": dict}

    Adam's moments (optax's mu and nu, the tree of `params`) are keyed by
    the port's parameter names; `adam_step` is optax's update count."""
    with open(path, "rb") as f:
        payload = _OptaxUnpickler(f).load()
    state = payload["state"]
    if not isinstance(state, dict):
        raise ValueError(f"{path}: not an echoflow training checkpoint")
    model = state_dict_from_variables({"params": state["params"],
                                       "batch_stats": state["batch_stats"]})
    out = {"model": model, "exp_avg": None, "exp_avg_sq": None, "adam_step": None,
           "step": int(np.asarray(state.get("step", 0))), "extra": payload.get("extra", {})}
    adam = _adam_state(state.get("opt_state"))
    if adam is not None:
        count, mu, nu = adam
        out["exp_avg"] = state_dict_from_variables(mu, params_only=True)
        out["exp_avg_sq"] = state_dict_from_variables(nu, params_only=True)
        out["adam_step"] = int(np.asarray(count))
    return out


def _place_adam_steps(opt):
    """A capturable Adam (`loop.make_optimizer` on the card) keeps its
    update counts on its parameters' device, whatever device the
    checkpoint was written on."""
    for group in opt.param_groups:
        if group["capturable"]:
            for p in group["params"]:
                st = opt.state.get(p)
                if st and "step" in st:
                    st["step"] = st["step"].to(p.device, torch.float32)


def restore_train_state(path: str, state):
    """Load a checkpoint into `state` (a `TrainState` from
    `create_train_state`, whose model and optimizer it overwrites in place)
    for reproducible resume. Reads the port's own checkpoints and
    `echoflow` `.pkl` ones (the latter carry a jax RNG key, which has no
    torch counterpart: the generator is left as it is). The optimizer
    keeps its own LR and `capturable` (a float on the CPU, a tensor on the
    card; the schedule sets the value of each update), so a checkpoint
    moves between the CPU and the card. Adam's state tensors are new ones:
    a CUDA graph captured before the restore refuses to run
    (`train/graph.py`). Returns (state, extra)."""
    device = next(state.model.parameters()).device
    if str(path).endswith(".pkl"):
        ck = load_jax_checkpoint(path)
        state.model.load_state_dict(ck["model"])
        if ck["exp_avg"] is not None:
            params = dict(state.model.named_parameters())
            opt = state.optimizer
            for name, p in params.items():
                opt.state[p] = {
                    "step": torch.tensor(float(ck["adam_step"])),
                    "exp_avg": ck["exp_avg"][name].to(device).clone(),
                    "exp_avg_sq": ck["exp_avg_sq"][name].to(device).clone(),
                }
            _place_adam_steps(opt)
        state.step = ck["step"]
        return state, ck["extra"]
    ck = load_checkpoint(path)
    state.model.load_state_dict(ck["model"])
    opt = state.optimizer
    own = [{k: g[k] for k in ("lr", "capturable")} for g in opt.param_groups]
    opt.load_state_dict(ck["optimizer"])
    for group, keep in zip(opt.param_groups, own):
        group.update(keep)
    _place_adam_steps(opt)
    state.step = int(ck["step"])
    if ck.get("rng") is not None and state.generator is not None:
        state.generator.set_state(ck["rng"])
    return state, ck.get("extra", {})


def load_model_variables(path: str) -> dict:
    """The port's (unfolded) state dict from any supported checkpoint:
    a reference `.pth` or a port checkpoint (both keep it under "model"),
    or an `echoflow` `.pkl` training checkpoint."""
    if str(path).endswith(".pkl"):
        return load_jax_checkpoint(path)["model"]
    return load_reference_state_dict(path)
