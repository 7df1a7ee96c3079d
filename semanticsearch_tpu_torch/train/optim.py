"""The optax pieces the trainers use, on named torch parameters.

The JAX trainers build their optimizers from optax
(``semanticsearch_tpu/train/encoder_train.py:142-150``,
``train/trainer.py:78-93``); this module gives the same updates:

- :func:`warmup_cosine_decay_schedule`: optax's, evaluated at the update
  count before it is incremented, so the first update has ``init_value``
  (0 in both trainers). ``decay_steps`` includes the warmup.
- :class:`Optimizer`: ``adamw`` (decay on every parameter, biases and
  LayerNorm scales included, times the scheduled rate), ``adam``,
  ``adadelta`` (rho 0.9, eps 1e-6) and ``clip_by_global_norm`` before any
  of them (``g / norm * max`` where ``norm >= max``, without the ``+1e-6``
  of ``torch.nn.utils.clip_grad_norm_``). The updates are those of
  ``torch.optim.AdamW``, ``Adam`` and ``Adadelta``, which run inside.

:meth:`Optimizer.state_tree` and :meth:`Optimizer.load_state_tree` map the
state to optax's tree and back (``step`` <-> ``count``, ``exp_avg`` /
``exp_avg_sq`` <-> ``mu`` / ``nu``, ``square_avg`` / ``acc_delta`` <->
``e_g`` / ``e_x``) in the chain's own tuple shape, so a checkpoint moves
between the two packages: ``adam(lr)`` is ``(ScaleByAdamState,
EmptyState)``, ``adamw(schedule)`` ``(ScaleByAdamState, EmptyState,
ScaleByScheduleState)``, ``adadelta(lr)`` ``(EmptyState,
ScaleByAdaDeltaState, EmptyState)``, and ``chain(clip, tx)`` adds an outer
``(EmptyState, tx)``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..core.checkpoint import OPTAX_STATES

Schedule = Callable[[int], float]

_EMPTY = OPTAX_STATES["EmptyState"]
_ADAM = OPTAX_STATES["ScaleByAdamState"]
_ADADELTA = OPTAX_STATES["ScaleByAdaDeltaState"]
_SCHEDULE = OPTAX_STATES["ScaleByScheduleState"]
# each family's optax state and the torch state key of each of its moments
_STATES = {"adam": (_ADAM, {"mu": "exp_avg", "nu": "exp_avg_sq"}),
           "adadelta": (_ADADELTA, {"e_g": "square_avg", "e_x": "acc_delta"})}


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """optax's schedule: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``
    (warmup included), flat after. Computed in float32 in optax's order,
    as optax computes it on the device."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1.0) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = f32(min(count - warmup_steps, span))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c / f32(span)))
        return float(f32(peak_value)
                     * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


class Optimizer:
    """One optax optimizer over ``params`` (name -> float32 parameter).

    ``kind`` is "adamw", "adam" or "adadelta"; ``learning_rate`` a number
    or a :data:`Schedule` of the update count. :meth:`step` applies one
    update from the parameters' ``.grad`` (a parameter without one takes a
    zero gradient, as every leaf of an optax update does)."""

    def __init__(self, params: Mapping[str, torch.Tensor], kind: str,
                 learning_rate: Union[float, Schedule],
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None) -> None:
        self.params = dict(params)
        self.kind = kind
        self.clip_norm = clip_norm
        self.schedule = learning_rate if callable(learning_rate) else None
        lr = 0.0 if self.schedule else float(learning_rate)
        plist = list(self.params.values())
        if kind == "adamw":
            self.opt = torch.optim.AdamW(plist, lr=lr, betas=(0.9, 0.999),
                                         eps=1e-8, weight_decay=weight_decay)
        elif kind == "adam":
            self.opt = torch.optim.Adam(plist, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8)
        elif kind == "adadelta":
            self.opt = torch.optim.Adadelta(plist, lr=lr, rho=0.9, eps=1e-6)
        else:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = []
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.clip_norm:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.clip_norm))
        if self.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    # ------------------------------------------------------ optax's tree
    def _moment(self, key: str, to_tree: Callable) -> Any:
        return to_tree({name: self.opt.state.get(p, {}).get(
            key, torch.zeros_like(p)) for name, p in self.params.items()})

    def _family(self):
        return _STATES["adadelta" if self.kind == "adadelta" else "adam"]

    def state_tree(self, to_tree: Callable[[Dict[str, torch.Tensor]], Any]
                   ) -> Any:
        """The state as optax's tree; ``to_tree`` lays a mapping keyed like
        ``params`` out as the flax parameter tree."""
        cls, fields = self._family()
        moments = {f: to_tree({name: self.opt.state.get(p, {}).get(
            key, torch.zeros_like(p)) for name, p in self.params.items()})
            for f, key in fields.items()}
        count = np.int32(self.count)
        if self.kind == "adadelta":
            tx = (_EMPTY(), cls(**moments), _EMPTY())
        elif self.kind == "adamw":
            tx = (cls(count=count, **moments), _EMPTY(), _SCHEDULE(count))
        else:
            tx = (cls(count=count, **moments), _EMPTY())
        return (_EMPTY(), tx) if self.clip_norm else tx

    def load_state_tree(self, tree: Any,
                        from_tree: Callable[[Any], Mapping[str, Any]],
                        count: Optional[int] = None) -> None:
        """Take optax's tree (as :meth:`state_tree` gives it, or as a
        checkpoint holds it); ``from_tree`` maps a flax-laid-out moment to
        tensors keyed like ``params``. ``count`` sets the update count
        where the tree has none (adadelta's)."""
        cls, fields = self._family()
        inner = tree[1] if self.clip_norm else tree
        states = [s for s in inner if type(s).__name__ == cls.__name__]
        if len(states) != 1:
            raise ValueError(f"optimizer state has no single {cls.__name__}: "
                             f"{[type(s).__name__ for s in inner]}")
        state = states[0]
        if "count" in state._fields:
            count = int(np.asarray(state.count))
        elif count is None:
            count = self.count
        moments = {key: from_tree(getattr(state, f))
                   for f, key in fields.items()}
        for pname, p in self.params.items():
            entry = {"step": torch.tensor(float(count))}
            for key, values in moments.items():
                entry[key] = torch.as_tensor(values[pname]).to(
                    device=p.device, dtype=p.dtype).clone()
            self.opt.state[p] = entry
        self.count = int(count)
