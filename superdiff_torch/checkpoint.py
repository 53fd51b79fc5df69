"""Checkpointing: step-indexed, keep-last-N, atomic, bit-exact resume.

Counterpart of ``superdiff_tpu/checkpoint.py`` with the same methods. The
format is the port's own (Orbax needs JAX): each step is one directory
``<directory>/<step>/`` holding ``state.pt``, a ``torch.save`` of tensors and
plain Python only::

    {"step": int,
     "params": {state_dict key: float32 tensor},       # model.state_dict()
     "ema_params": {state_dict key: float32 tensor},   # ema_model.state_dict()
     "opt_state": {"count": int, "mu": [...], "nu": [...]},  # parameter order
     "rng": {"generator": uint8 tensor,    # state.generator.get_state()
             "global": uint8 tensor}}      # the device's default generator

Dropout draws from the device's default generator (so that rematerialised
blocks replay their masks); every other draw comes from ``state.generator``.
Both states are saved and restored.

A save writes ``state.pt`` into a temporary directory beside the target and
renames it (``os.replace``), so a reader never sees a torn checkpoint. Saves
are synchronous: ``saving_in_progress()`` is always False and ``wait()``
returns at once. Restoring into a freshly built
:class:`~superdiff_torch.training.state.TrainState` and continuing gives the
trajectory the uninterrupted run would have taken, bit for bit.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

import torch

from superdiff_torch.training.state import TrainState

STATE_FILE = "state.pt"


def _array_state(state: TrainState) -> dict:
    """The checkpointable part of the TrainState as CPU tensors and plain
    Python; the optimizer rules and the model's structure are rebuilt from
    the config at restore time."""
    def cpu(t):
        return t.detach().to("cpu", copy=True)

    return {
        "step": int(state.step),
        "params": {k: cpu(v) for k, v in state.model.state_dict().items()},
        "ema_params": {k: cpu(v)
                       for k, v in state.ema_model.state_dict().items()},
        "opt_state": {"count": int(state.opt_state["count"]),
                      "mu": [cpu(m) for m in state.opt_state["mu"]],
                      "nu": [cpu(n) for n in state.opt_state["nu"]]},
        "rng": {"generator": state.generator.get_state().clone(),
                "global": _global_rng(state.generator.device).clone()},
    }


def _global_rng(device, new_state=None):
    """Get (or set) the state of ``device``'s default generator."""
    if device.type == "cuda":
        if new_state is None:
            return torch.cuda.get_rng_state(device)
        return torch.cuda.set_rng_state(new_state, device)
    if new_state is None:
        return torch.get_rng_state()
    return torch.set_rng_state(new_state)


def load_checkpoint_file(directory: str, step: int) -> dict:
    """The raw dict of one saved step (CPU tensors)."""
    path = os.path.join(os.path.abspath(directory), str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, STATE_FILE)))

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Write the state under its step; False when that step is already
        saved (e.g. the final flush after a periodic save). ``force`` is
        accepted for the reference's signature: every call saves."""
        step = int(state.step)
        if step in self.all_steps():
            return False
        tmp = tempfile.mkdtemp(prefix=f".tmp_{step}_", dir=self.directory)
        try:
            torch.save(_array_state(state), os.path.join(tmp, STATE_FILE))
            os.replace(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a saved step into ``state`` (a freshly created TrainState of
        the same model), in place, on the state's own devices."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        saved = load_checkpoint_file(self.directory, step)
        state.model.load_state_dict(saved["params"], strict=True)
        state.ema_model.load_state_dict(saved["ema_params"], strict=True)
        opt = saved["opt_state"]
        for name in ("mu", "nu"):
            if len(opt[name]) != len(state.opt_state[name]):
                raise ValueError(f"checkpoint holds {len(opt[name])} Adam "
                                 f"{name} tensors, the model "
                                 f"{len(state.opt_state[name])}")
            with torch.no_grad():
                for dst, src in zip(state.opt_state[name], opt[name]):
                    dst.copy_(src)
        state.opt_state["count"] = int(opt["count"])
        state.step = int(saved["step"])
        state.generator.set_state(saved["rng"]["generator"])
        _global_rng(state.generator.device, saved["rng"]["global"])
        return state

    def saving_in_progress(self) -> bool:
        return False

    def wait(self) -> None:
        return None

    def close(self) -> None:
        return None
