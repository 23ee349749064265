"""Buffered asynchronous (FedBuff-style) aggregation with a staleness
discount (``fedml_tpu.core.async_agg``).

The server folds each arriving client delta into a buffer, weighted by
how many model versions old the delta is, and emits a new model every K
arrivals. The buffer is three accumulators::

    sum   += w(lag) * n_k * delta_k
    mass  += w(lag) * n_k
    count += 1

and an emission hands ``sum * (1 / mass)`` (one weighted-mean delta) to
the same ``server_update`` body the synchronous rounds run, so the
server rule cannot drift between the two. The sum lives as torch tensors
on the device of the template it was made from (the server state's);
:meth:`AsyncBuffer.state_arrays` and :meth:`AsyncBuffer.load_arrays`
move it through host numpy, so a checkpoint blob written by either
package loads in the other.

The deploy actor that drives the buffer (``algorithms/async_actors.py``,
``check_async_compat``) is ROADMAP Queue A item 14b; the simulators run
synchronous rounds and ignore ``async_buffer_k``, as the JAX simulators
do. :func:`simulate_open_loop` is the host-side model of an open-loop
world behind the bench's async stage, copied as it is.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from fedml_tpu_torch.core.tree import Tree

STALENESS_FNS = ("poly", "const")


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """The buffered-async server's settings (from ``FedConfig``):

    - ``buffer_k``: emit every K folded arrivals; 0 (the default) turns
      the async path off.
    - ``staleness_fn``: ``"poly"`` weighs a result trained ``lag``
      versions ago by ``(1 + lag)^-alpha``; ``"const"`` weighs every
      arrival 1 (plain FedBuff).
    - ``staleness_alpha``: the poly exponent (0.5, FedAsync's default).
    """

    buffer_k: int = 0
    staleness_fn: str = "poly"
    staleness_alpha: float = 0.5

    def __post_init__(self):
        if self.buffer_k < 0:
            raise ValueError(
                f"async_buffer_k must be >= 0, got {self.buffer_k}"
            )
        if self.staleness_fn not in STALENESS_FNS:
            raise ValueError(
                f"staleness_fn must be one of {STALENESS_FNS}, "
                f"got {self.staleness_fn!r}"
            )
        if self.staleness_alpha < 0:
            raise ValueError(
                f"staleness_alpha must be >= 0, "
                f"got {self.staleness_alpha}"
            )

    @staticmethod
    def from_fed(fed) -> "AsyncConfig":
        return AsyncConfig(fed.async_buffer_k, fed.staleness_fn,
                           fed.staleness_alpha)

    def enabled(self) -> bool:
        return self.buffer_k > 0

    def weight(self, lag: int | float) -> float:
        """The discount of a result trained ``lag`` versions behind the
        current model (the emit counter minus the result's version tag);
        a fresh result (lag 0) weighs 1.0."""
        lag = float(lag)
        if lag < 0:
            raise ValueError(f"version lag must be >= 0, got {lag}")
        if self.staleness_fn == "const":
            return 1.0
        return (1.0 + lag) ** (-self.staleness_alpha)


class AsyncBuffer:
    """The staleness-weighted fold buffer over a flat tree of tensors.

    Not thread-safe by itself: its owner serializes folds. A fold is
    O(model size) on the sum's device and reads nothing back from it."""

    def __init__(self, cfg: AsyncConfig, template_vars: Tree):
        self.cfg = cfg
        self._template = template_vars
        self.sum = {k: torch.zeros_like(v) for k, v in template_vars.items()}
        self.mass = 0.0
        self.count = 0
        self.version = 0  # the emit counter: the model version clients see

    def fold(self, delta: Tree, n_k: float, lag: int) -> float:
        """Fold one screened delta, trained ``lag`` versions ago. Returns
        the staleness weight applied."""
        w = self.cfg.weight(lag)
        wn = w * float(n_k)
        self.sum = {k: s + wn * delta[k].to(s.dtype)
                    for k, s in self.sum.items()}
        self.mass += wn
        self.count += 1
        return w

    def ready(self) -> bool:
        return self.count >= self.cfg.buffer_k > 0

    def emit(self) -> tuple[Tree, float]:
        """Drain the buffer: ``(weighted-mean delta, mass)``; the
        accumulators reset and ``version`` advances. The caller applies
        the delta through ``server_update``."""
        if self.count == 0:
            raise RuntimeError("emit() on an empty async buffer")
        inv = 1.0 / self.mass
        mean_delta = {k: s * inv for k, s in self.sum.items()}
        mass = self.mass
        self.sum = {k: torch.zeros_like(v)
                    for k, v in self._template.items()}
        self.mass = 0.0
        self.count = 0
        self.version += 1
        return mean_delta, mass

    def state_arrays(self) -> dict:
        """A checkpoint payload: the sum and the three scalars as host
        numpy arrays."""
        return {
            "sum": {k: v.detach().cpu().numpy() for k, v in self.sum.items()},
            "mass": np.asarray(self.mass, np.float64),
            "count": np.asarray(self.count, np.int64),
            "version": np.asarray(self.version, np.int64),
        }

    def load_arrays(self, blob: dict) -> None:
        """Resume mid-accumulation from :meth:`state_arrays`' payload (of
        either package): the folds made before the restart still count
        toward the next emission."""
        self.sum = {
            k: torch.tensor(np.asarray(blob["sum"][k])).to(
                device=t.device, dtype=t.dtype)
            for k, t in self._template.items()
        }
        self.mass = float(np.asarray(blob["mass"]))
        self.count = int(np.asarray(blob["count"]))
        self.version = int(np.asarray(blob["version"]))


# ---------------------------------------------------------------------------
# the open-loop world model (host numpy, the JAX package's as it is)
# ---------------------------------------------------------------------------


def _serial_completion(arrivals: np.ndarray, t_free: float,
                       service_s: float) -> tuple[np.ndarray, float]:
    """Completion times of jobs served one at a time in arrival order by
    a server free at ``t_free``."""
    out = np.empty_like(arrivals)
    for i, a in enumerate(arrivals):
        t_free = max(float(a), t_free) + service_s
        out[i] = t_free
    return out, t_free


def simulate_open_loop(
    *,
    n_clients: int = 10_000,
    n_leaves: int = 1,
    buffer_k: int = 32,
    flush_every: int | None = None,
    horizon_s: float = 20.0,
    seed: int = 0,
    fold_cost_s: float = 4e-4,
    emit_cost_s: float = 2e-3,
    mean_latency_s: float = 1.0,
    sigma: float = 0.8,
    sync: bool = False,
) -> dict:
    """A deterministic discrete-event model of an open-loop federated
    world: ``n_clients`` clients each train, report and re-sync forever,
    with seeded lognormal latencies (``sigma`` sets the straggler tail).
    Aggregators are serial: a fold holds one for ``fold_cost_s``, an
    emission for ``emit_cost_s``.

    Clients are dealt round-robin over ``n_leaves`` leaves; a leaf sends
    one partial upstream every ``flush_every`` folds (default 8), and the
    root emits every ``buffer_k`` partials, so one emission costs
    ``flush_every * buffer_k`` arrivals in every layout. ``sync=True``
    models synchronous FedAvg on the same world: a round closes when
    every client's result is folded (at least 3 rounds).

    Virtual time: the result is exactly reproducible, a shape (emits/s
    against fan-in), never a device time."""
    if n_clients < 1 or n_leaves < 1 or buffer_k < 1:
        raise ValueError("n_clients, n_leaves, buffer_k must be >= 1")
    rng = np.random.default_rng(seed)
    mu = math.log(mean_latency_s) - sigma * sigma / 2.0  # mean-preserving
    per_leaf = [n_clients // n_leaves + (1 if l < n_clients % n_leaves
                                         else 0)
                for l in range(n_leaves)]

    if sync:
        t = 0.0
        rounds = 0
        while t < horizon_s or rounds < 3:
            close = t
            for c in per_leaf:
                lat = rng.lognormal(mu, sigma, size=c)
                arrivals = np.sort(t + lat)
                done, _ = _serial_completion(arrivals, t, fold_cost_s)
                close = max(close, float(done[-1]))
            # the root: one partial a leaf, then the emission
            close += n_leaves * fold_cost_s + emit_cost_s
            t = close
            rounds += 1
        return {
            "mode": "sync",
            "n_clients": n_clients,
            "n_leaves": n_leaves,
            "rounds": rounds,
            "sim_wall_s": round(t, 6),
            "rounds_per_sec": rounds / t,
        }

    flush = flush_every if flush_every is not None else 8
    if flush < 1:
        raise ValueError(f"flush_every must be >= 1, got {flush}")
    # (result ready time, seq, client id); a client's next cycle starts
    # when its previous fold completes
    heap: list[tuple[float, int, int]] = []
    seq = 0
    for cid in range(n_clients):
        heapq.heappush(
            heap, (float(rng.lognormal(mu, sigma)), seq, cid)
        )
        seq += 1
    leaf_free = [0.0] * n_leaves
    leaf_folds = [0] * n_leaves
    root_free = 0.0
    partials = 0
    partials_arrived = 0
    emits = 0
    folds = 0
    last_emit_t = 0.0
    while heap:
        t, _, cid = heapq.heappop(heap)
        if t >= horizon_s:
            continue  # drain without scheduling successors
        leaf = cid % n_leaves
        start = max(t, leaf_free[leaf])
        done = start + fold_cost_s
        leaf_free[leaf] = done
        leaf_folds[leaf] += 1
        # only work that completes inside the horizon counts
        if done <= horizon_s:
            folds += 1
        if leaf_folds[leaf] % flush == 0:
            r_start = max(done, root_free)
            root_free = r_start + fold_cost_s
            partials_arrived += 1
            if root_free <= horizon_s:
                partials += 1
            if partials_arrived % buffer_k == 0:
                root_free += emit_cost_s
                if root_free <= horizon_s:
                    emits += 1
                    last_emit_t = root_free
        heapq.heappush(
            heap,
            (done + float(rng.lognormal(mu, sigma)), seq, cid),
        )
        seq += 1
    return {
        "mode": "async",
        "n_clients": n_clients,
        "n_leaves": n_leaves,
        "buffer_k": buffer_k,
        "flush_every": flush,
        "folds": folds,
        "partials": partials,
        "emits": emits,
        "emits_per_sec": emits / horizon_s,
        "folds_per_sec": folds / horizon_s,
        "last_emit_t": round(last_emit_t, 6),
    }
