"""Checkpoint / resume of a train state (counterpart of
`actor_critic_tpu/utils/checkpoint.py::Checkpointer`).

A checkpoint is one `torch.save` file per iteration count, `<dir>/<step>/
state.pt`, holding every tensor the train step carries
(`algos.common.carried_tensors`: parameters, optimizer moments and count,
rollout obs and env state with the mixture's weights and stage, episode
accounting, step counter, IMPALA's actor copy; for the off-policy states
also the replay ring's every leaf, cursor, count and codec stats, the
target nets, every Adam state, SAC's log α, the update and env-step
counts; for a host trainer's `algos.host_loop.HostCheckpoint`, its learner or net and
Adam state, `env_steps` and the pool's normalizer stats) and the trainer generator's
state; `<dir>/<step>/metrics.json` beside it holds the
iteration's metrics, so that a resume with nothing left to run still
reports them. A step is written under a temporary name and renamed into
place, and the oldest beyond `max_to_keep` are removed.

`restore` copies each saved tensor into the tensor of the live state
(`copy_`) and sets the generator's state, so every address a later CUDA
graph captures is the init's own storage (`common.init_rollout`).

A state with a non-finite float tensor is refused at save
(`NonFiniteError`): the previous good checkpoint stays the latest. The
metrics may carry a non-finite loss and are written as they are (null).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Union

import torch

from actor_critic_tpu_torch.algos.common import OffPolicyState, TrainState, carried_tensors
from actor_critic_tpu_torch.utils.cadence import finite_or_none

STATE_FILE, METRICS_FILE = "state.pt", "metrics.json"


class NonFiniteError(ValueError):
    """A state with NaN or Inf in a float tensor was asked to be saved."""


class Checkpointer:
    """Saves and restores train states under `directory`, one sub-directory
    per iteration count, keeping the newest `max_to_keep`."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> list[int]:
        """The iteration counts with a complete checkpoint, ascending."""
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(self._path(int(d), STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Union[TrainState, OffPolicyState, Any],
             metrics: Optional[dict] = None) -> None:
        """Write `state` (and the scalar `metrics`) as the checkpoint of
        iteration `step`, replacing one already there. Reads the tensors to
        the host, so it waits for the device."""
        tensors = {k: t.detach().to("cpu", copy=True) for k, t in carried_tensors(state).items()}
        bad = sorted(k for k, t in tensors.items()
                     if t.is_floating_point() and not bool(torch.isfinite(t).all()))
        if bad:
            raise NonFiniteError(f"refusing to save a non-finite state at iteration {step}: {bad}")
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"tensors": tensors, "generator": state.generator.get_state()},
                   os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump({k: finite_or_none(v) for k, v in (metrics or {}).items()}, f)
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def restore(self, state: Union[TrainState, OffPolicyState, Any],
                step: Optional[int] = None) -> int:
        """Copy the checkpoint of iteration `step` (default: the latest) into
        `state` in place; returns the step. Raises FileNotFoundError when
        there is none, ValueError when its tensors are not the state's."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        saved = torch.load(self._path(step, STATE_FILE), map_location="cpu", weights_only=True)
        live = carried_tensors(state)
        if sorted(saved["tensors"]) != sorted(live):
            missing, extra = sorted(set(live) - set(saved["tensors"])), sorted(
                set(saved["tensors"]) - set(live))
            raise ValueError(f"checkpoint {step} is not of this state: missing {missing}, "
                             f"extra {extra}")
        for k, t in live.items():
            s = saved["tensors"][k]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"checkpoint {step}, {k}: {tuple(s.shape)} {s.dtype}, the state "
                                 f"has {tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            for k, t in live.items():
                t.copy_(saved["tensors"][k])
        state.generator.set_state(saved["generator"])
        return step

    def restore_metrics(self, step: Optional[int] = None) -> dict:
        """The metrics saved with the checkpoint of `step` (default: the
        latest); {} if there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return {}
        try:
            with open(self._path(step, METRICS_FILE)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
