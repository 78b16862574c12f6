"""Training checkpoints with the JAX package's naming (counterpart of
jatts_tpu/utils/checkpoint.py).

A checkpoint is a directory ``checkpoint-{steps}steps`` under the
experiment's outdir, as the JAX package names its orbax checkpoints, so a
recipe's latest-checkpoint discovery by steps works unchanged. It holds one
file, ``state.pt``: ``torch.save`` of ``{model, optimizer, steps, epochs,
ema}`` (state_dicts; ``ema`` None without EMA). Orbax checkpoints of the
JAX package are not read here. A run over a mesh saves the same file: the
whole, unsharded state (``train/trainer.py``), so a checkpoint moves
between world sizes in both directions.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def checkpoint_dir(outdir: str, steps: int) -> str:
    """The directory of the checkpoint at ``steps``."""
    return os.path.join(os.path.abspath(outdir), f"checkpoint-{steps}steps")


def save_checkpoint(outdir: str, steps: int, state: Dict[str, Any]) -> str:
    """Write ``state`` to ``outdir/checkpoint-{steps}steps/state.pt``
    (through a temporary file, so a reader never sees half a checkpoint)."""
    path = checkpoint_dir(outdir, steps)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(
        os.path.join(os.path.abspath(path), STATE_FILE), map_location=map_location,
        weights_only=True,
    )


def find_latest_checkpoint(outdir: str) -> Optional[str]:
    """Latest by step count."""
    if not os.path.isdir(outdir):
        return None
    best, best_steps = None, -1
    for name in os.listdir(outdir):
        m = re.fullmatch(r"checkpoint-(\d+)steps", name)
        if m and int(m.group(1)) > best_steps:
            best, best_steps = os.path.join(outdir, name), int(m.group(1))
    return best


def checkpoint_steps(path: str) -> int:
    m = re.search(r"checkpoint-(\d+)steps", path)
    return int(m.group(1)) if m else 0
