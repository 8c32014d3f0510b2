"""Debug tensor dumps (counterpart of ``sparsebev_tpu/utils/dump.py``, the
reference's DUMP singleton, models/utils.py:309-317): when enabled, the
decoder saves per-stage intermediates (query boxes, predictions, class
scores, SASA tau, camera-space sample points and their valid masks) as
``<name>_stage<k>.npy`` files for the visualization tools
(``tools/viz_sample_points.py``).

Disabled (the default), a hook is one Python test: no device work, no host
copy and no synchronization.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


class DumpConfig:
    def __init__(self):
        self.enabled = False
        self.out_dir = None
        self.stage_count = 0

    def enable(self, out_dir=None):
        self.enabled = True
        self.out_dir = out_dir or tempfile.mkdtemp(prefix="sparsebev_dump_")
        os.makedirs(self.out_dir, exist_ok=True)
        return self.out_dir

    def save(self, name: str, array, stage: int = None) -> None:
        if not self.enabled:
            return
        stage = self.stage_count if stage is None else stage
        path = os.path.join(self.out_dir, f"{name}_stage{stage}.npy")
        np.save(path, np.asarray(array))

    def load(self, name: str, stage: int):
        path = os.path.join(self.out_dir, f"{name}_stage{stage}.npy")
        return np.load(path)


DUMP = DumpConfig()


def dump_save(name: str, tensor) -> None:
    """Save ``tensor`` under ``name`` at the decoder stage of this call
    (``DUMP.stage_count``, which the decoder sets each layer), as fp32 on
    the host; a no-op unless ``DUMP`` is enabled."""
    if not DUMP.enabled:
        return
    DUMP.save(name, tensor.detach().float().cpu().numpy(),
              stage=DUMP.stage_count)
