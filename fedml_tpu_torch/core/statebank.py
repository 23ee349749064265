"""Per-client state banks: one ``[num_clients, ...]`` store for a state
keyed by client id (the bulk engine's error-feedback residual), the JAX
package's ``core/statebank.py`` on flat ``{name: tensor}`` trees.

The bulk engine (``core/bulk.py``) streams a cohort through the device
in blocks and folds each block away, so a state that follows a client
from round to round cannot ride the round's tensors. A
:class:`ClientStateBank` keeps one row per client: each block gathers its
clients' rows, updates them and scatters them back.

- **Sentinel ids**: a padded slot carries the out-of-range id
  ``num_clients``. A gather clamps it to the last row (the JAX package's
  out-of-bounds gather; the live mask discards that row downstream) and
  a scatter drops it (``mode="drop"``), so a pad can never collide with
  a real client. Torch's indexed copies raise on an out-of-range index,
  and finding the real rows on the device would read it back; the ids
  are on the host here, so the host clamps them and picks the real slots
  a scatter writes.
- **Screening keeps rows**: :meth:`ClientStateBank.put` takes a ``keep``
  mask; where it is False (a screened or a non-live slot) the gathered
  pre-round row is written back.

A scatter writes the bank's tensors in place (the bank is the size of
the population; a functional copy per block would double it) and
returns the bank.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fedml_tpu_torch.core import telemetry
from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device

Tree = dict[str, torch.Tensor]


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        if ids.device.type != "cpu":
            raise ValueError("bank ids must be on the host")
        ids = ids.numpy()
    return np.asarray(ids, dtype=np.int64).reshape(-1)


class ClientStateBank:
    """A named tree of ``[num_clients, ...]`` rows, one per client."""

    def __init__(self, name: str, rows: Tree):
        self.name = name
        self.rows = rows

    # -- constructors -------------------------------------------------------

    @classmethod
    def zeros(cls, name: str, template: Tree,
              num_clients: int) -> "ClientStateBank":
        """Every row a zero of ``template``'s leaves (the residual's
        start: round 0 sends the uncorrected delta)."""
        return cls(name, {k: torch.zeros((num_clients,) + tuple(v.shape),
                                         dtype=v.dtype, device=v.device)
                          for k, v in template.items()})

    @classmethod
    def broadcast(cls, name: str, template: Tree,
                  num_clients: int) -> "ClientStateBank":
        """Every row a copy of ``template``."""
        return cls(name, {k: v[None].expand(
            (num_clients,) + tuple(v.shape)).clone()
            for k, v in template.items()})

    # -- geometry -----------------------------------------------------------

    @property
    def num_rows(self) -> int:
        leaves = list(self.rows.values())
        return int(leaves[0].shape[0]) if leaves else 0

    @property
    def sentinel(self) -> int:
        """The pad id: out of range by construction."""
        return self.num_rows

    def row_bytes(self) -> int:
        return sum(v.element_size() * (v.numel() // max(1, v.shape[0]))
                   for v in self.rows.values())

    def resident_bytes(self) -> int:
        return sum(v.element_size() * v.numel() for v in self.rows.values())

    @property
    def device(self) -> torch.device:
        return next(iter(self.rows.values())).device

    # -- gather / scatter ---------------------------------------------------

    def gather(self, ids: Sequence[int]) -> Tree:
        """The rows of ``ids`` (host ints), stacked ``[B, ...]``; a
        sentinel id reads the last row."""
        safe = np.minimum(_host_ids(ids), self.num_rows - 1)
        idx = to_device(torch.from_numpy(safe), self.device)
        return {k: v.index_select(0, idx) for k, v in self.rows.items()}

    def put(self, ids: Sequence[int], new_rows: Tree,
            keep: torch.Tensor | None = None,
            gathered: Tree | None = None) -> "ClientStateBank":
        """Write ``new_rows`` back by id (host ints). Sentinel ids are
        dropped; where ``keep`` (a ``[B]`` bool on the bank's device) is
        False the pre-round row is written back (``gathered``, the rows
        :meth:`gather` returned for ``ids``, spares the re-gather)."""
        host = _host_ids(ids)
        if keep is not None:
            if gathered is None:
                gathered = self.gather(host)
            new_rows = {k: torch.where(T.bcast_rows(keep, n), n,
                                       gathered[k].to(n.dtype))
                        for k, n in new_rows.items()}
        real = np.flatnonzero(host < self.num_rows)
        dst = to_device(torch.from_numpy(host[real]), self.device)
        src = (None if real.size == host.size
               else to_device(torch.from_numpy(real), self.device))
        for k, b in self.rows.items():
            r = new_rows[k].to(b.dtype)
            b.index_copy_(0, dst, r if src is None else r.index_select(0, src))
        return self

    # -- checkpoint ride-along ----------------------------------------------

    def savable(self) -> Tree:
        return self.rows

    @classmethod
    def from_savable(cls, name: str, template_rows: Tree,
                     blob: Tree) -> "ClientStateBank":
        """A bank of ``blob``'s rows, checked against and placed like
        ``template_rows``."""
        rows = {}
        for k, t in template_rows.items():
            v = torch.as_tensor(blob[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"bank {name!r} leaf {k!r}: shape "
                                 f"{tuple(v.shape)} != {tuple(t.shape)}")
            rows[k] = v.to(device=t.device, dtype=t.dtype)
        return cls(name, rows)


def pad_ids(ids, n_slots: int, sentinel: int) -> np.ndarray:
    """Pad host ids to ``n_slots`` with the sentinel (out-of-range) id."""
    ids = _host_ids(ids)
    pad = n_slots - ids.shape[0]
    if pad <= 0:
        return ids
    return np.concatenate([ids, np.full(pad, sentinel, np.int64)])


def note_bank(bank: ClientStateBank, counters: dict) -> None:
    """The bank's footprint into ``counters`` and the registry's gauges,
    at its creation."""
    telemetry.set_gauge(counters, "bank.rows", bank.num_rows)
    telemetry.set_gauge(counters, "bank.row_bytes", bank.row_bytes())
    telemetry.set_gauge(counters, "bank.resident_mb",
                        bank.resident_bytes() / 1e6)


def note_round_io(counters: dict, gathers: int, scatters: int) -> None:
    """A round's gathers and scatters (one per block and bank and pass),
    counted in ``counters`` and the registry."""
    for name, n in (("bank.gathers", gathers), ("bank.scatters", scatters)):
        if n:
            telemetry.add_count(counters, name, n)
