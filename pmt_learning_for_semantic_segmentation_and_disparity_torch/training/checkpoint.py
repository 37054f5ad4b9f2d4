"""Checkpointing with ``torch.save`` (the port's counterpart of the JAX
package's orbax ``training/checkpoint.py``).

Replaces the reference's pickled .pth.tar monoliths + by-name partial
restore (save_checkpoint torch_implementation.py:52-66,
utilTorch_loadweight.py:6-115). Each saved step is a directory ``{step}/``
holding ``state.pt``: the model's ``state_dict`` (fp32 master weights and
BatchNorm statistics), the optimizer's state (Adam's moments and step, the
schedule, gradient accumulation) and the step count. Beside it go the JSON
sidecars of the JAX package: ``meta_{step}.json`` (epoch, config, metric
history), ``best.json`` and one ``model_best_IOU{x}_Derr{y}/`` copy of the
best step. Best-checkpoint selection keys on head-2 val IoU like the
reference (torch_implementation.py:915-934); the ``max_to_keep`` newest steps
are kept.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .state import TrainState

_STATE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_iou = -1.0
        self._best_artifact = None
        best_json = os.path.join(self.directory, "best.json")
        if os.path.exists(best_json):
            with open(best_json) as f:
                best = json.load(f)
            self.best_iou = float(best.get("iou", -1.0))
            self._best_artifact = best.get("artifact")

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(os.path.join(self.directory, n, _STATE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             extra: Optional[Dict[str, Any]] = None,
             val_iou: Optional[float] = None,
             val_derr: Optional[float] = None):
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(), "step": state.step}
        tmp = os.path.join(path, _STATE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, _STATE))
        if extra is not None:
            with open(os.path.join(self.directory, f"meta_{step}.json"), "w") as f:
                json.dump(extra, f, default=_np_default)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        if val_iou is not None and val_iou > self.best_iou:
            self.best_iou = val_iou
            self._save_best_artifact(step, val_iou, val_derr or 0.0)

    def _save_best_artifact(self, step: int, iou: float, derr: float):
        """Keep exactly ONE `*_model_best_IOU{x}_Derr{y}` copy of the best
        checkpoint, deleting the previous best — the reference's
        save_checkpoint naming scheme (torch_implementation.py:52-66),
        rounded to 4 decimals like the reference."""
        name = f"model_best_IOU{round(float(iou), 4)}_Derr{round(float(derr), 4)}"
        path = os.path.join(self.directory, name)
        if self._best_artifact:
            old = os.path.join(self.directory, self._best_artifact)
            if os.path.isdir(old):
                shutil.rmtree(old)
        src = os.path.join(self.directory, str(step))
        if os.path.isdir(src):
            shutil.copytree(src, path, dirs_exist_ok=True)
        self._best_artifact = name
        with open(os.path.join(self.directory, "best.json"), "w") as f:
            json.dump({"step": step, "iou": float(iou),
                       "derr": float(derr), "artifact": name}, f)

    def load_meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Metric-history / epoch sidecar of a step (latest by default) —
        the resume metadata the reference keeps inside its .pth.tar
        (torch_implementation.py:908-932)."""
        if step is None:
            step = self.latest_step()
        path = os.path.join(self.directory, f"meta_{step}.json")
        if step is None or not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def _load(self, step: Optional[int]) -> dict:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        # loaded to the host: load_state_dict moves each tensor where its
        # parameter lives and leaves Adam's step counts on the host, as a run
        # that never stopped has them
        return torch.load(os.path.join(self.directory, str(step), _STATE),
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """The whole state of ``step`` (the latest by default), loaded into
        ``state`` in place and returned."""
        payload = self._load(step)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        return state

    # head-rename aliases for by-name restore: a checkpoint trained with the
    # plain seg head (cdu11_out) loads into the convDeconvOut=2 deconv head
    # (convOutput) — the reference remaps module.Conv2DownUp11.1.ct2d.weight
    # -> module.convOutput.ct2d.weight (utilTorch_loadweight.py:34-38).
    _HEAD_ALIASES = {"convOutput": "cdu11_out"}

    def restore_params_partial(self, state: TrainState,
                               step: Optional[int] = None) -> TrainState:
        """By-name partial restore of the parameters: load every one whose
        name exists and whose shape matches, with head-rename aliasing; skip
        the rest (the BatchNorm statistics and the optimizer stay as they
        are) — the reference's head-remapping loader
        (utilTorch_loadweight.py:30-46)."""
        old = self._load(step)["model"]
        with torch.no_grad():
            for name, p in state.model.named_parameters():
                src = old.get(name)
                if src is None:
                    for new_name, old_name in self._HEAD_ALIASES.items():
                        if f"{new_name}." in name:
                            src = old.get(name.replace(f"{new_name}.", f"{old_name}."))
                            break
                if src is not None and src.shape == p.shape:
                    p.copy_(src)
        return state


def _np_default(o):
    if isinstance(o, (np.ndarray, np.generic)):
        return o.tolist()
    raise TypeError(type(o))
