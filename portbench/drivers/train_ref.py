"""The reference's side of the train cells that run another plain forward
than `reference/model.forward` (`train_ircsn`, `train_dp`): the seed's
weights through `reference/steps.train_steps`, and the comparison of
`drivers/train.py` (`compare`'s numbers, each leaf's gap of norms over the
larger of the reference's norm of that leaf and of the median leaf).
"""

from __future__ import annotations

import sys

import numpy as np

from portbench.drivers.train import ZERO_LEAF, _gaps, _norms
from portbench.reference.model import Precision
from portbench.reference.steps import train_steps
from portbench.reference.train import total_loss


def reference(cell, checked, device, forward, make_state, precision="fp32", loss_fn=total_loss):
    """(losses, first gradients' norms, changes' norms) of the reference's
    steps over `forward` from the seed's weights (`make_state`)."""
    state = make_state(cell.config, cell.seed, device)
    prec = Precision(precision)
    with prec.flags():
        losses, first, after = train_steps(forward, state, cell.config, checked,
                                           lr=cell.traffic["lr"], precision=prec,
                                           loss_fn=loss_fn)
    change = _norms({k: after[k] - state[k] for k in after})
    return losses, _norms(first), change


def compare(ref, losses, first, change):
    """`drivers/train.compare`'s numbers for the program's readings against
    the reference's `ref` (losses, first gradients' norms, changes' norms)."""
    ref_losses, ref_first, ref_change = ref
    keys = list(ref_first)
    median = float(np.median([ref_first[k] for k in keys]))
    moving = [k for k in keys if ref_first[k] >= ZERO_LEAF * median]
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad, moved = _gaps(first, ref_first, keys), _gaps(change, ref_change, moving)
    for name, gaps in (("grad_gap", grad), ("change_gap", moved)):
        worst = sorted(gaps, key=lambda k: -gaps[k])[:3]
        print(f"{name}: worst leaves " + ", ".join(f"{k} {gaps[k]:.3e}" for k in worst),
              file=sys.stderr)
    print(f"loss gap by step {loss}; left out of the change: {sorted(set(keys) - set(moving))}",
          file=sys.stderr)
    return {"loss_gap": float(np.max(loss)), "loss_gap_first": loss[0],
            "grad_gap": float(np.max(list(grad.values()))),
            "grad_gap_median": float(np.median(list(grad.values()))),
            "change_gap": float(np.max(list(moved.values()))),
            "change_gap_median": float(np.median(list(moved.values())))}


def control(cell, checked, device, forward, make_state):
    """The reference in the program's place, through the same check: in the
    configuration's lower precision, or with its loss over half of each
    batch (`drivers/train.half_batch_loss`)."""
    from portbench.drivers.train import half_batch_loss

    sound = reference(cell, checked, device, forward, make_state)
    if cell.control == "half_batch":
        got = reference(cell, checked, device, forward, make_state, loss_fn=half_batch_loss)
    else:
        got = reference(cell, checked, device, forward, make_state,
                        cell.config["precision"]["control"])
    return compare(sound, *got)
