"""Training checkpoints with the step and auto-resume (counterpart of
``tpugan/io/checkpoint.py``).

A checkpoint is ``path/step_<N>/state.pt``: the encoder's ``state_dict``
(its parameters and its buffers, the spectral norms' ``u``/``v`` included),
LREQAdam's ``state_dict`` (the second moments and their step counts) and
the train state's step counter, written with ``torch.save``. A save is
atomic, as orbax's is: it writes into a hidden sibling directory and then
renames it to ``step_<N>``, so an interrupted save leaves no ``step_<N>``
behind, and :func:`latest_step` reads only complete ones.

The port resumes its own checkpoints only: ``tpugan``'s are orbax trees of
NHWC arrays, which this module does not read.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, state, step: int) -> str:
    """Save ``state`` (an :class:`~tpugan_torch.train.e_align.
    EncoderTrainState`) under ``path/step_<step>``, replacing a checkpoint
    of that step; returns the directory."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step}")
    staging = tempfile.mkdtemp(prefix=f".step_{step}.", dir=path)
    try:
        torch.save({"encoder": state.encoder.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)}, os.path.join(staging, STATE_FILE))
        if os.path.isdir(target):
            old = tempfile.mkdtemp(prefix=f".old_step_{step}.", dir=path)
            os.replace(target, os.path.join(old, "step"))
            os.replace(staging, target)
            shutil.rmtree(old)
        else:
            os.replace(staging, target)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    return target


def latest_step(path: str) -> Optional[int]:
    """The largest N of the ``step_<N>`` directories under ``path``, or
    ``None``."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.isdir(os.path.join(path, name)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def load_checkpoint(path: str, state, step: Optional[int] = None):
    """Restore ``state`` in place from ``path/step_<step>`` (the latest step
    by default), onto the device of its encoder's parameters. Returns
    ``(state, step)``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    device = next(state.encoder.parameters()).device
    saved = torch.load(os.path.join(os.path.abspath(path), f"step_{step}", STATE_FILE),
                       map_location=device, weights_only=True)
    state.encoder.load_state_dict(saved["encoder"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]
    return state, step
