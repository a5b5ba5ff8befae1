"""Training state container (port of ``repro.train.train_state``)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class TrainState(NamedTuple):
    step: int                # steps taken
    params: Any              # nested dict of leaf tensors (requires_grad)
    opt_state: Any           # MuonState
    loss_ema: torch.Tensor   # running loss for logging (0-d, on the device)
