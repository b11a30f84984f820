"""Exponential-moving-average shadows of a model's parameters.

Counterpart of ``dynamicscaler_tpu/utils/ema.py`` (the reference's
``LitEma``, lvdm/ema.py:5-75), functional as the JAX twin: a shadow copy of
the parameters updated as

    decay_t = min(decay, (1 + n) / (10 + n))            # warm-up ramp
    shadow  = shadow - (1 - decay_t) * (shadow - param)  # ema.py:35-44

with n the number of updates so far, counting this one; ``-1`` switches the
ramp off (``use_num_upates=False``, ema.py:16-19). ``decay_t`` is reckoned
in fp32 and each update accumulates in fp32, cast back to the shadow's
dtype. ``params`` is a module (its ``named_parameters``) or a state dict
``{name: tensor}``; ``ema_params`` is what ``copy_to`` (ema.py:48-55) writes
into the live model inside ``ema_scope`` (``module.load_state_dict(...,
strict=False)``). The loader already reads stored ``model_ema.*`` shadows
(``utils/weights.py``, ``prefer_ema``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch
from torch import nn

Params = Union[nn.Module, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int  # -1: no warm-up ramp
    decay: float = 0.9999


def _named(params: Params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def ema_init(params: Params, decay: float = 0.9999, use_num_updates: bool = True) -> EmaState:
    """ema.py:5-23: the shadow starts as a copy of the live parameters."""
    if not 0.0 <= decay <= 1.0:
        raise ValueError(f"decay {decay} outside [0, 1]")
    shadow = {k: v.detach().clone() for k, v in _named(params).items()}
    return EmaState(shadow, 0 if use_num_updates else -1, decay)


@torch.no_grad()
def ema_update(state: EmaState, params: Params) -> EmaState:
    """One EMA step (ema.py:25-46 ``forward``); returns the new state."""
    n = state.num_updates + 1 if state.num_updates >= 0 else state.num_updates
    decay = torch.tensor(state.decay, dtype=torch.float32)
    if n >= 0:
        decay = torch.minimum(decay, torch.tensor(1.0 + n, dtype=torch.float32)
                              / torch.tensor(10.0 + n, dtype=torch.float32))
    one_minus = float(1.0 - decay)
    live = _named(params)
    shadow = {}
    for k, s in state.shadow.items():
        sf = s.float()
        shadow[k] = (sf - one_minus * (sf - live[k].detach().float())).to(s.dtype)
    return EmaState(shadow, n, state.decay)


def ema_params(state: EmaState) -> Dict[str, torch.Tensor]:
    """The averaged parameters, by name."""
    return state.shadow
