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

A data-parallel state (`parallel.dp.distribute_state` over a mesh of W > 1
ranks) is saved with `Checkpointer(..., mesh=mesh)`: each rank writes its
own shard, `<dir>/<step>/state.<rank>-of-<W>.pt` (its env batch, its
sub-ring, its generator, and the replicated rest), rank 0 the metrics, and
each rank restores its own file into its freshly distributed template. A
restore by a mesh of another size raises and names both sizes: JAX's orbax
reshards on restore, the port does not (a shard holds its ranks' envs and
sub-ring, which a new world size would have to re-cut).

A state with a non-finite float tensor is refused at save
(`numguard.NonFiniteError`): the previous good checkpoint stays the latest. The
metrics may carry a non-finite loss and are written as they are (null).

The chunk-wall sidecar (`<dir>/chunk_wall.json`, `{"chunk_wall_s": s}`,
JAX's format, so each package reads the other's): the largest clean
chunk wall a watched `--chunk` run measured (`algos/loop.py`), which a
resumed process reads to widen its armed stall watchdog before its own
first chunks, whose walls carry the warm-up and captures and are never
ratcheted from.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional, Union

import torch

from actor_critic_tpu_torch.algos.common import OffPolicyState, TrainState, carried_tensors
from actor_critic_tpu_torch.utils import numguard
from actor_critic_tpu_torch.utils.cadence import finite_or_none
from actor_critic_tpu_torch.utils.numguard import NonFiniteError

__all__ = ["Checkpointer", "NonFiniteError"]

STATE_FILE, METRICS_FILE = "state.pt", "metrics.json"
_SHARD_FILE = re.compile(r"state\.(\d+)-of-(\d+)\.pt$")


def state_file(rank: int, world: int) -> str:
    """A rank's state file in a step's directory: `state.pt` for a world of
    one, `state.<rank>-of-<world>.pt` for a shard of a larger one."""
    return STATE_FILE if world == 1 else f"state.{rank}-of-{world}.pt"
CHUNK_WALL_FILE = "chunk_wall.json"


class Checkpointer:
    """Saves and restores train states under `directory`, one sub-directory
    per iteration count, keeping the newest `max_to_keep`. With a `mesh`
    (`parallel.mesh.Mesh`) of more than one rank, every rank saves and
    restores its own shard of a data-parallel state."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 3, mesh=None):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.rank, self.world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        self.state_file = state_file(self.rank, self.world)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int, name: str = "") -> str:
        return os.path.join(self.directory, str(step), name)

    def all_steps(self) -> list[int]:
        """The iteration counts with a complete checkpoint, ascending."""
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit() and os.path.exists(self._path(int(d), self.state_file)))

    def saved_worlds(self, step: Optional[int] = None) -> list[int]:
        """The world sizes of the states saved at `step` (every step when
        None): 1 for `state.pt`, W for `state.<r>-of-<W>.pt`."""
        steps = [str(step)] if step is not None else [
            d for d in os.listdir(self.directory) if d.isdigit()]
        worlds = set()
        for d in steps:
            path = os.path.join(self.directory, d)
            for name in os.listdir(path) if os.path.isdir(path) else ():
                m = _SHARD_FILE.match(name)
                if name == STATE_FILE or m:
                    worlds.add(1 if m is None else int(m.group(2)))
        return sorted(worlds)

    def _refuse_other_world(self, step: Optional[int]) -> None:
        others = [w for w in self.saved_worlds(step) if w != self.world]
        if others:
            raise ValueError(
                f"checkpoint{'' if step is None else f' {step}'} in {self.directory} was saved "
                f"by a world of {others[0]} rank(s); this mesh has {self.world}: a sharded "
                "state restores only at the world size it was saved at")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Union[TrainState, OffPolicyState, Any],
             metrics: Optional[dict] = None) -> None:
        """Write `state` (and the scalar `metrics`) as the checkpoint of
        iteration `step`, replacing one already there. Reads the tensors to
        the host, so it waits for the device."""
        tensors = {k: t.detach().to("cpu", copy=True) for k, t in carried_tensors(state).items()}
        numguard.check_finite(tensors, "checkpoint commit", name="state")
        payload = {"tensors": tensors, "generator": state.generator.get_state(),
                   "rank": self.rank, "world": self.world}
        metrics = {k: finite_or_none(v) for k, v in (metrics or {}).items()}
        if self.world > 1:
            self._save_shard(step, payload, metrics)
            return
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METRICS_FILE), "w") as f:
            json.dump(metrics, f)
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def _save_shard(self, step: int, payload: dict, metrics: dict) -> None:
        """One rank's file of a sharded checkpoint (and rank 0's metrics),
        each written under a temporary name and renamed into the step's
        directory, which the ranks share; a rank removes only its own files
        of the steps beyond `max_to_keep`, and the directory once empty."""
        os.makedirs(self._path(step), exist_ok=True)
        tmp = self._path(step, f".{self.state_file}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step, self.state_file))
        if self.rank == 0:
            with open(self._path(step, f".{METRICS_FILE}.tmp"), "w") as f:
                json.dump(metrics, f)
            os.replace(self._path(step, f".{METRICS_FILE}.tmp"), self._path(step, METRICS_FILE))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old, self.state_file))
            if self.rank == 0 and os.path.exists(self._path(old, METRICS_FILE)):
                os.remove(self._path(old, METRICS_FILE))
            try:
                os.rmdir(self._path(old))
            except OSError:
                pass  # another rank's file is still there

    def restore(self, state: Union[TrainState, OffPolicyState, Any],
                step: Optional[int] = None) -> int:
        """Copy the checkpoint of iteration `step` (default: the latest) into
        `state` in place; returns the step. Raises FileNotFoundError when
        there is none, ValueError when its tensors are not the state's or
        it was saved by a world of another size."""
        if step is None:
            step = self.latest_step()
            if step is None:
                self._refuse_other_world(None)
                raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        if not os.path.exists(self._path(step, self.state_file)):
            self._refuse_other_world(step)
        saved = torch.load(self._path(step, self.state_file), map_location="cpu",
                           weights_only=True)
        if saved.get("world", 1) != self.world:
            raise ValueError(f"checkpoint {step} was saved by a world of {saved['world']} "
                             f"rank(s); this mesh has {self.world}")
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


def _read_chunk_wall(path: str) -> Optional[float]:
    """The persisted steady-state chunk wall seconds, or None (absent,
    unreadable or non-positive: all mean "nothing learned yet")."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    # Valid but foreign JSON (a bare number, a list) reads as "nothing
    # learned": the sidecar is advisory.
    wall = data.get("chunk_wall_s") if isinstance(data, dict) else None
    if isinstance(wall, (int, float)) and not isinstance(wall, bool):
        return float(wall) if wall > 0 else None
    return None


def _persist_chunk_wall(path: str, wall_s: float) -> None:
    """Record the largest clean chunk wall observed, so that a RESUMED
    process can widen its armed watchdog before its own first chunks."""
    prev = _read_chunk_wall(path)
    if prev is not None and prev >= wall_s:
        return
    try:
        with open(path, "w") as f:
            json.dump({"chunk_wall_s": round(float(wall_s), 3)}, f)
    except OSError:
        pass  # advisory sidecar; never take the run down

