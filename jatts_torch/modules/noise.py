"""Training noise from an explicit ``torch.Generator``.

A module that draws noise in training (the CFM's t and z, the VITS
posterior encoder's eps, the stochastic duration predictor's e_q) keeps a
``noise_generator`` attribute, ``None`` meaning torch's default generator
for the device. A trainer owns one generator, re-seeds it every step and
hands it to every such module of a model with :func:`set_noise_generator`,
so that a resumed run draws what an uninterrupted one would.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def set_noise_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every module of ``model`` with a ``noise_generator`` attribute draws
    from ``generator``."""
    for m in model.modules():
        if hasattr(m, "noise_generator"):
            m.noise_generator = generator
