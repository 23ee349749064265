"""Round-state checkpoints with resume (``fedml_tpu.utils.checkpoint``),
on ``torch.save`` instead of orbax.

A checkpoint is one file per round, ``round_<r>.pt`` in the directory,
holding a nested dict of contiguous CPU tensors and Python scalars
(:func:`to_savable`: a ``ServerState`` becomes the dict of its fields,
its variables, optimizer state (adam's count tensor included), momentum
and round). It is written to a temporary file in the same directory,
flushed, ``fsync``'d and renamed over its name (``os.replace``), then
the directory is synced: a process killed during a save leaves the last
complete checkpoint readable, and its temporary file (``.tmp-*``) is
never read. Checkpoints older than the ``keep`` newest are deleted.
Reading uses ``torch.load(weights_only=True)`` (tensors and plain
containers only); :func:`from_savable` puts each tensor on the device
and type of the template the caller gives, the simulation's.

The JAX package also migrates legacy flax scope names on restore; no
checkpoint of this package predates its names, so there is nothing to
migrate.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import torch

_FILE = "round_{:08d}.pt"
_PATTERN = re.compile(r"^round_(\d+)\.pt$")


class RoundCheckpointer:
    """Save and restore per-round state.

    Usage::

        ckpt = RoundCheckpointer(directory, keep=3)
        state, start_round = ckpt.restore_or(state)  # resume if possible
        for r in range(start_round, rounds):
            state, _ = sim.run_round(state)
            ckpt.save(r, state)
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _rounds(self) -> list[int]:
        """The rounds with a complete checkpoint, ascending."""
        found = (_PATTERN.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, round_idx: int) -> str:
        return os.path.join(self.directory, _FILE.format(round_idx))

    def save(self, round_idx: int, state: Any) -> None:
        """Write ``state`` as round ``round_idx``'s checkpoint, atomically,
        then delete all but the ``keep`` newest."""
        blob = to_savable(state)
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".pt",
                                   dir=self.directory)
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(blob, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(round_idx))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        _fsync_dir(self.directory)
        for old in self._rounds()[:-self.keep]:
            os.unlink(self._path(old))

    def latest_round(self) -> int | None:
        rounds = self._rounds()
        return rounds[-1] if rounds else None

    def restore_raw(self) -> tuple[Any, int]:
        """The latest checkpoint as saved (a nested dict of CPU tensors
        and scalars) and the next round, or ``(None, 0)`` without one.
        The caller rebuilds typed state with :func:`from_savable`."""
        step = self.latest_round()
        if step is None:
            return None, 0
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True), step + 1

    def restore_or(self, init_state: Any) -> tuple[Any, int]:
        """``(state, next_round)``: the latest checkpoint rebuilt like
        ``init_state`` (its types, devices and dtypes), or ``(init_state,
        0)`` without one. A ``{"server", ...}`` composite (the harness's
        ``{"server", "bank"}`` save) read against a bare state gives its
        ``"server"`` part."""
        raw, nxt = self.restore_raw()
        if raw is None:
            return init_state, 0
        if (isinstance(raw, dict) and "server" in raw
                and not (isinstance(init_state, dict)
                         and "server" in init_state)):
            raw = raw["server"]
        return from_savable(init_state, raw), nxt

    def close(self) -> None:
        """Nothing stays open between saves; kept for the JAX package's
        interface."""


def _fsync_dir(directory: str) -> None:
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def to_savable(state: Any):
    """NamedTuples and dicts to nested dicts (a tuple or list to
    ``{"__i": ...}``, as the JAX package saves them), each tensor a
    contiguous CPU copy with storage of its own: ``torch.save`` of a view
    writes its whole storage (a bank row, a column of a flat buffer).
    Python scalars and None stay as they are."""
    if hasattr(state, "_asdict"):
        return {k: to_savable(v) for k, v in state._asdict().items()}
    if isinstance(state, dict):
        return {k: to_savable(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return {f"__{i}": to_savable(v) for i, v in enumerate(state)}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True,
                                 memory_format=torch.contiguous_format)
    return state


def from_savable(template: Any, blob: Any):
    """Rebuild ``template``'s containers from a saved blob: each tensor
    checked against the template's shape and copied to its device and
    type; a Python scalar converted to the template's type."""
    if hasattr(template, "_asdict"):
        return type(template)(**{k: from_savable(v, blob[k])
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: from_savable(v, blob[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(from_savable(v, blob[f"__{i}"])
                              for i, v in enumerate(template))
    if isinstance(template, torch.Tensor):
        value = torch.as_tensor(blob)
        if value.shape != template.shape:
            raise ValueError(f"checkpoint leaf of shape {tuple(value.shape)}"
                             f" where the state has {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype,
                        copy=True)
    if template is None:
        return None
    return type(template)(blob)
