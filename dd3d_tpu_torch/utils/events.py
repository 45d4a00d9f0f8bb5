"""Metrics storage: scalars kept in memory and appended to a JSONL file; the
port's counterpart of dd3d_tpu/utils/events.py.

Rebuild of the reference's EventStorage (tridet/utils/events.py:11-21) and
its console/JSON writers (scripts/train.py:159-162). The training loop
opens one on rank 0 only, so a run writes one `metrics.jsonl`. W&B
mirroring is not ported (the port does not depend on wandb):
`wandb_enabled=True` raises, and `put_image`, which mirrors a drawing to
W&B in the JAX package, does nothing (the PNG that visualizers.save_vis
writes is the record).
"""
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

class EventStorage:
    def __init__(self, output_dir: Optional[str] = None, wandb_enabled: bool = False):
        if wandb_enabled:
            raise NotImplementedError("WANDB.ENABLED: W&B mirroring is not ported; the metrics go to "
                                      "<output_dir>/metrics.jsonl")
        self._history = defaultdict(list)
        self._file = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def put_scalars(self, step: int, **scalars):
        """Record `scalars` at `step`, and append them as one JSON line."""
        for k, v in scalars.items():
            self._history[k].append((step, float(v)))
        if self._file:
            self._file.write(json.dumps({"step": step, "ts": time.time(),
                                         **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._file.flush()

    def put_image(self, name: str, image, caption: Optional[str] = None):
        """The counterpart of dd3d_tpu/utils/events.py:73, which mirrors a
        drawing (HWC uint8) to W&B when it is enabled; without W&B, as
        always in the port, it does nothing."""

    def latest(self) -> Dict[str, float]:
        return {k: v[-1][1] for k, v in self._history.items()}

    def history(self, name: str):
        return list(self._history[name])

    def close(self):
        if self._file:
            self._file.close()
            self._file = None
