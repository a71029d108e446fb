"""Atomic checkpoint and resume — port of
`imagecaptioning_tpu/utils/checkpoint.py` with `torch.save` in place of
orbax.

A checkpoint is one file holding the complete training state as a dict
(`train_state`: the model and optimizer state dicts, the step, the
trainer's generator state and the loader cursor, the same for the GT and
the RPN drivers; under gradient accumulation the optimizer's state
dict carries the window's micro-step count and running means, as
optax's `MultiSteps` state does), so resume is exact, mid-window too.
Saving writes `<path>.tmp-save` first and swaps it in with renames,
keeping the previous file as `<path>.old` until the new one is in place:
a crash at any point leaves a restorable checkpoint. `resume_path` keeps the JAX
package's order of preference.

In a run of several processes rank 0 alone writes (`save_checkpoint` is a
no-op elsewhere; the drivers meet it at a barrier after the write), every
rank reads the same file to resume, and `SignalCheckpointer` is installed
on every rank: torchrun passes a signal to each, and the drivers agree on
it at a step boundary (`Mesh.any`) before rank 0 saves.
"""

from __future__ import annotations

import os
import signal as _signal
from typing import Any, Dict, Optional

import torch

from imagecaptioning_tpu_torch.parallel import mesh


def train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                step: int, generator: torch.Generator,
                loader_cursor: int) -> Dict[str, Any]:
    """The full training state a checkpoint holds."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "step": step, "generator": generator.get_state(),
            "loader_cursor": loader_cursor}


def load_train_state(state: Dict[str, Any], model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     generator: torch.Generator):
    """Put a checkpoint's state back → (step, loader cursor)."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"])
    return state["step"], state["loader_cursor"]


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write `state` to `path` atomically (tmp file, then renames); only
    rank 0 of a run of several processes writes."""
    if not mesh.is_writer():
        return
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp, old = path + ".tmp-save", path + ".old"
    with open(tmp, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    # only now is it safe to drop a leftover '.old' (it may be the sole
    # restorable checkpoint after a crash mid-swap)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        os.remove(old)


def restore_checkpoint(path: str,
                       map_location: Optional[torch.device] = None
                       ) -> Dict[str, Any]:
    """The state dict `save_checkpoint` wrote. Only files this program
    wrote are read: `torch.load` runs with `weights_only=True`."""
    return torch.load(path, map_location=map_location, weights_only=True)


def resume_path(save_path: str) -> Optional[str]:
    """The checkpoint to resume from: the preemption checkpoint
    (`<save_path>.preempt`) when it is newer than the best-model one;
    for the best model, a complete `.tmp-save` left by a crash before
    its swap when newer than the main file, else the main file, else
    `.old` (a crash mid-swap); None when there is none."""
    def isfile(p):
        return os.path.isfile(p)

    best = save_path if isfile(save_path) else None
    tmp = save_path + ".tmp-save"
    # save_checkpoint fsyncs the tmp file before any rename, so a
    # surviving one is complete
    if isfile(tmp) and (best is None or
                        os.path.getmtime(tmp) >= os.path.getmtime(best)):
        best = tmp
    if best is None and isfile(save_path + ".old"):
        best = save_path + ".old"
    pre = save_path + ".preempt" if isfile(save_path + ".preempt") else None
    if best and pre:
        return pre if os.path.getmtime(pre) >= os.path.getmtime(best) \
            else best
    return pre or best


class SignalCheckpointer:
    """Preemption-safe checkpointing: installs SIGTERM/SIGINT handlers
    that set `requested`; the training loop checks it at each step
    boundary and writes a full-state checkpoint before exiting. Restores
    the previous handlers on exit."""

    def __init__(self, signals=None):
        self.requested = False
        self._prev = {}
        self.signals = signals or (_signal.SIGTERM, _signal.SIGINT)

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self.signals:
            try:
                self._prev[s] = _signal.signal(s, self._handler)
            except ValueError:      # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            _signal.signal(s, prev)
        return False

    def save_if_requested(self, path: str, state: Dict[str, Any]) -> bool:
        """Write `state` to `path` if a signal came → whether one came.
        For one process: the drivers agree on the signal over the ranks
        first (`Mesh.any`) and then save."""
        if self.requested:
            save_checkpoint(path, state)
        return self.requested
