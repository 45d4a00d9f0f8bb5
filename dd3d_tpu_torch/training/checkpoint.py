"""Checkpoints of the train state, counterpart of
dd3d_tpu/training/checkpoint.py: `torch.save` of the model's state dict
(parameters and BN statistics), the optimizer's (momentum buffers and the
schedule count) and the step, one file a step; the last `max_to_keep` are
kept, and `restore` loads the latest. `load_weights` loads a model's weights
from such a directory or from a reference-named state dict file (VoVNet's
slash names renamed by `reference_to_port_names`)."""
import os
import re
from typing import List, Optional

import torch

from dd3d_tpu_torch.utils.convert_checkpoint import reference_to_port_names

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
REMOTE_PREFIXES = ("http://", "https://", "s3://", "gs://")  # not fetched: the port needs no network


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, step: int, model: torch.nn.Module, optimizer) -> None:
        payload = {"step": int(step), "model": model.state_dict(), "optimizer": optimizer.state_dict()}
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees a half-written file
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, model: torch.nn.Module, optimizer=None, step: Optional[int] = None) -> Optional[int]:
        """Load checkpoint `step` (default: the latest) into `model` and, when
        one is given, `optimizer`; returns its step, or None when there is
        none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return int(payload["step"])


def load_weights(model: torch.nn.Module, path: str) -> Optional[int]:
    """Load weights into `model` from `path`: a checkpoint directory of
    `CheckpointManager` (its latest step; returned), or a state dict with
    the reference's names in a `.pth` / `.pt` file (a {"model": ...}
    payload too; None is returned). Remote paths are not fetched."""
    if path.startswith(REMOTE_PREFIXES):
        raise NotImplementedError(f"{path}: remote checkpoints are not fetched (no network); give a local .pth/.pt "
                                  "file or a checkpoint directory")
    if os.path.isdir(path):
        step = CheckpointManager(path).restore(model)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        return step
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    refusal = getattr(getattr(getattr(model, "base", model), "backbone", None), "no_reference_checkpoint", None)
    if refusal:
        raise ValueError(f"{path}: {refusal}")
    sd = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(reference_to_port_names(sd.get("model", sd), model), strict=True)
    return None
