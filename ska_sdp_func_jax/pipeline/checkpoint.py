"""Checkpoint/resume for the major-cycle solver state.

The reference is stateless (plans are cheaply recomputable; SURVEY.md
§5 "Checkpoint/resume: absent"), but this framework owns the major-cycle
loop, whose state (model image, residual, cycle index, geometry
fingerprint) is worth persisting for long solves.

Two backends:

- :func:`save_state` / :func:`load_state` — single-file ``.npz``
  (single-host, atomic rename).
- :class:`SolverCheckpointer` — orbax ``CheckpointManager`` directory
  with step retention. Multi-host ready: each process writes only its
  own shards of a sharded ``jax.Array``, and restore re-shards onto the
  mesh when a template (``jax.ShapeDtypeStruct`` with sharding, or an
  array with the target sharding) is supplied."""

import dataclasses
import json
import os
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .major_cycle import ImagingResult


def save_state(path: str, model, residual, cycle: int,
               peak_history=None, meta: Optional[dict] = None) -> None:
    """Persist solver state; atomic single-host write."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp,
             model=np.asarray(model),
             residual=np.asarray(residual),
             cycle=np.asarray(cycle, np.int64),
             peak_history=np.asarray(peak_history or [], np.float64),
             meta=json.dumps(meta or {}))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_state(path: str):
    """Restore solver state -> (model, residual, cycle, peak_history,
    meta). Arrays come back as device arrays."""
    with np.load(path, allow_pickle=False) as data:
        model = jnp.asarray(data["model"])
        residual = jnp.asarray(data["residual"])
        cycle = int(data["cycle"])
        peak_history = list(np.asarray(data["peak_history"]))
        meta = json.loads(str(data["meta"]))
    return model, residual, cycle, peak_history, meta


def save_result(path: str, result: ImagingResult,
                meta: Optional[dict] = None) -> None:
    """Persist a finished ImagingResult (model/residual/restored)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    np.savez(tmp,
             model=np.asarray(result.model),
             residual=np.asarray(result.residual),
             restored=np.asarray(result.restored),
             peak_history=np.asarray(result.peak_history, np.float64),
             meta=json.dumps(meta or {}))
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_result(path: str) -> ImagingResult:
    with np.load(path, allow_pickle=False) as data:
        return ImagingResult(
            model=jnp.asarray(data["model"]),
            residual=jnp.asarray(data["residual"]),
            restored=jnp.asarray(data["restored"]),
            peak_history=list(np.asarray(data["peak_history"])))


class SolverCheckpointer:
    """Orbax-backed step checkpointing for the major-cycle solver.

    Wraps :class:`orbax.checkpoint.CheckpointManager`: every
    :meth:`save` writes a retained step directory, :meth:`restore`
    reads the latest (or a named) step. Sharded arrays are written
    shard-wise per host — this is the multi-host persistence path the
    single-file ``.npz`` helpers cannot provide. Pass ``template``
    arrays (or ``jax.ShapeDtypeStruct`` with a sharding) to restore
    directly onto a mesh.

    Accepted by ``major_cycle_imager(checkpointer=...)`` in place of
    ``checkpoint_path``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self.directory = os.path.abspath(directory)
        self._manager = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True))

    def latest_step(self) -> Optional[int]:
        return self._manager.latest_step()

    def save(self, step: int, model, residual, peak_history=None,
             meta: Optional[dict] = None) -> None:
        ocp = self._ocp
        state = {"model": model, "residual": residual}
        extra = {
            "cycle": int(step),
            "peak_history": [float(p) for p in (peak_history or [])],
            "meta": meta or {},
        }
        self._manager.save(
            int(step),
            args=ocp.args.Composite(
                state=ocp.args.StandardSave(state),
                extra=ocp.args.JsonSave(extra)))

    def restore(self, step: Optional[int] = None, template=None):
        """Restore ``(model, residual, cycle, peak_history, meta)``.

        ``template``: optional ``{"model": ..., "residual": ...}`` of
        arrays or ``jax.ShapeDtypeStruct`` carrying the target
        sharding; required to land shards on a mesh in multi-host
        runs, optional on one host.
        """
        ocp = self._ocp
        if step is None:
            step = self._manager.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps in {self.directory}")
        if template is not None:
            abstract = jax.tree_util.tree_map(
                lambda x: x if isinstance(x, jax.ShapeDtypeStruct)
                else jax.ShapeDtypeStruct(
                    jnp.shape(x), jnp.asarray(x).dtype,
                    sharding=getattr(x, "sharding", None)),
                dict(template))
            state_args = ocp.args.StandardRestore(abstract)
        else:
            state_args = ocp.args.StandardRestore()
        out = self._manager.restore(
            int(step),
            args=ocp.args.Composite(state=state_args,
                                    extra=ocp.args.JsonRestore()))
        state, extra = out["state"], out["extra"]
        model, residual = state["model"], state["residual"]
        if template is None:
            model, residual = jnp.asarray(model), jnp.asarray(residual)
        return (model, residual, int(extra["cycle"]),
                list(extra["peak_history"]), dict(extra["meta"]))

    def wait(self) -> None:
        """Block until pending async writes are durable."""
        self._manager.wait_until_finished()

    def close(self) -> None:
        self._manager.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
