"""Streamed Byzantine defenses: the selection and quantile rules of the
bulk engine, which never hold the ``[C, D]`` matrix of deltas; the JAX
package's ``core/streamdef.py``.

Each rule is two passes over the round's blocks (``core/bulk.py``):
pass 1 folds a small SKETCH of the cohort, the rule decides from it, and
pass 2 folds the decided aggregate. Both passes recompute the local
updates (deterministic: the same batch orders and draws), so round
memory stays O(block + sketch) and the defense costs a second pass.

- **Coordinate quantiles** (median, trimmed mean): pass 1 folds exact
  per-coordinate moments (sum, sum of squares, live count); pass 2 a
  histogram of ``HIST_BINS`` bins over ``mu +- HIST_SPAN sd`` per
  coordinate; the quantile is read off the histogram's CDF, within one
  bin width of the stacked order statistic (exact where a coordinate's
  spread is 0).
- **Random projections** (Krum, multi-Krum, FLTrust): pass 1 folds each
  slot's seeded Johnson-Lindenstrauss projection (``[slots, PROJ_DIM]``),
  its true delta norm and its weight; the selection runs on the
  projected rows; pass 2 folds the selected or trust-weighted sum of
  the full deltas. FLTrust's reference is the coordinate median of the
  PROJECTED rows and its norm target the median true norm (the stacked
  rule matches the full median delta's norm); with no trust at all the
  streamed aggregate is 0 where the stacked rule returns the reference.

The projection's Gaussian blocks come from the caller's draws (the
stream ``"proj"``, one ``[d_leaf, PROJ_DIM]`` block per parameter leaf,
drawn once a round and used by every block and both passes); the JAX
package derives them from ``(round key, salt, leaf index)``.

Eligibility is the stacked reducer's: the quantile rules vote over live
rows (a screened client votes its healed zero delta), the selection
rules over ``live & weight > 0``. Nothing here reads the device: the
selections are ``argmin``, stable sorts and masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fedml_tpu_torch.core import robust, telemetry
from fedml_tpu_torch.core import tree as T

Tree = dict[str, torch.Tensor]

#: random-projection dimension of the krum/multikrum/fltrust sketch
PROJ_DIM = 256
#: per-coordinate histogram bins of the median/trimmed_mean sketch
HIST_BINS = 128
#: the histogram's half-range in per-coordinate standard deviations
HIST_SPAN = 4.0

#: rules served by the coordinate-quantile sketch
QUANTILE_METHODS = ("median", "trimmed_mean")
#: rules served by the random-projection sketch
PROJECTION_METHODS = ("krum", "multikrum", "fltrust")
STREAM_METHODS = QUANTILE_METHODS + PROJECTION_METHODS


class CoordMoments(NamedTuple):
    """Pass 1 of the quantile sketch: exact moments over the live rows
    (additive across blocks)."""

    sum_x: torch.Tensor  # [D]
    sum_sq: torch.Tensor  # [D]
    count: torch.Tensor  # scalar: live rows


class ProjSketch(NamedTuple):
    """Pass 1 of the projection sketch: per-SLOT rows, each block writing
    its own slots into zeros (blocks partition the slots, so the sum over
    blocks assembles them)."""

    proj: torch.Tensor  # [slots, PROJ_DIM] projected deltas
    norm: torch.Tensor  # [slots] true delta L2 norms
    weight: torch.Tensor  # [slots] aggregation weights (n_k)
    live: torch.Tensor  # [slots] live mask, float


# ---------------------------------------------------------------------------
# a block of deltas, flat
# ---------------------------------------------------------------------------


def flatten_rows(stacked_deltas: Tree) -> torch.Tensor:
    """``[B, D]`` float32 (float64 deltas: float64): one block's deltas
    flattened, leaves in the tree's key order."""
    return robust.flatten_clients(stacked_deltas)


# ---------------------------------------------------------------------------
# coordinate-quantile sketch
# ---------------------------------------------------------------------------


def fold_moments(flat: torch.Tensor, live: torch.Tensor) -> CoordMoments:
    """One block's moments; ``live`` is ``[B]`` float."""
    v = live[:, None].to(flat.dtype)
    return CoordMoments(sum_x=torch.sum(flat * v, dim=0),
                        sum_sq=torch.sum(flat * flat * v, dim=0),
                        count=torch.sum(live))


def hist_edges(mom: CoordMoments, span: float = HIST_SPAN):
    """``(lo, width)`` per coordinate: bins over ``mu +- span sd``; a
    coordinate without spread gets width 0, and every estimate below is
    then ``lo == mu`` exactly."""
    n = torch.clamp(mom.count, min=1.0)
    mu = mom.sum_x / n
    var = torch.clamp(mom.sum_sq / n - mu * mu, min=0.0)
    sd = torch.sqrt(var)
    return mu - span * sd, (2.0 * span * sd) / HIST_BINS


def fold_hist(flat: torch.Tensor, live: torch.Tensor, lo: torch.Tensor,
              width: torch.Tensor) -> torch.Tensor:
    """One block's ``[HIST_BINS, D]`` histogram, by one flat index-add
    (``bin * D + coordinate``), never a ``[B, HIST_BINS, D]`` one-hot.
    Values beyond the span go to the edge bins."""
    d = flat.shape[1]
    safe_w = torch.where(width > 0, width, torch.ones_like(width))
    b = torch.clamp(torch.floor((flat - lo[None, :]) / safe_w[None, :]),
                    0, HIST_BINS - 1).long()
    flat_idx = b * d + torch.arange(d, device=flat.device)[None, :]
    votes = live[:, None].to(flat.dtype).expand(flat.shape)
    hist = torch.zeros(HIST_BINS * d, dtype=flat.dtype, device=flat.device)
    hist.index_add_(0, flat_idx.reshape(-1), votes.reshape(-1))
    return hist.reshape(HIST_BINS, d)


def _first_crossing(cum: torch.Tensor, target) -> torch.Tensor:
    """``[D]``: the first bin whose cumulative mass reaches ``target``
    (``argmax`` of a mask takes the first maximum)."""
    return torch.argmax((cum >= target).to(torch.uint8), dim=0)


def median_from_hist(hist: torch.Tensor, lo: torch.Tensor,
                     width: torch.Tensor, count: torch.Tensor
                     ) -> torch.Tensor:
    """``[D]`` grouped median: linear interpolation of the CDF at
    ``count / 2`` inside the bin where it is crossed."""
    cum = torch.cumsum(hist, dim=0)
    target = torch.clamp(count, min=1.0) / 2.0
    b = _first_crossing(cum, target)
    before = torch.gather(cum, 0, torch.clamp(b - 1, min=0)[None, :])[0]
    cum_before = torch.where(b > 0, before, torch.zeros_like(before))
    mass = torch.gather(hist, 0, b[None, :])[0]
    frac = (target - cum_before) / torch.clamp(mass, min=1e-12)
    return lo + (b.to(lo.dtype) + frac) * width


def trim_table(trim_frac: float, c_max: int) -> torch.Tensor:
    """The trim count for every live count ``0..c_max``, made on the host
    with the stacked rule's Python-float formula
    (:func:`fedml_tpu_torch.core.robust.trim_count`), so the streamed and
    the stacked rule trim the same rows."""
    return torch.tensor([robust.trim_count(c, trim_frac)
                         for c in range(c_max + 1)], dtype=torch.int32)


def trimmed_mean_from_hist(hist: torch.Tensor, lo: torch.Tensor,
                           width: torch.Tensor, count: torch.Tensor,
                           ks: torch.Tensor) -> torch.Tensor:
    """``[D]`` trimmed mean: per coordinate, the mass of the rank band
    ``[k, n - k)``, each bin's overlap with the band valued at the bin's
    center, over ``n - 2k``; ``ks`` is :func:`trim_table` on ``hist``'s
    device."""
    n = torch.clamp(count, min=1.0)
    i = torch.clamp(count.long(), 0, ks.shape[0] - 1)
    k = ks.index_select(0, i.reshape(1))[0]
    lo_rank = k.to(hist.dtype)
    hi_rank = n - lo_rank
    cum = torch.cumsum(hist, dim=0)
    cum_prev = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]])
    band = torch.clamp(torch.minimum(cum, hi_rank)
                       - torch.maximum(cum_prev, lo_rank), min=0.0)
    centers = lo[None, :] + (torch.arange(
        HIST_BINS, dtype=hist.dtype, device=hist.device)[:, None]
        + 0.5) * width[None, :]
    return torch.sum(band * centers, dim=0) / torch.clamp(
        hi_rank - lo_rank, min=1.0)


# ---------------------------------------------------------------------------
# random-projection sketch
# ---------------------------------------------------------------------------


def proj_shapes(template: Tree, proj_dim: int = PROJ_DIM
                ) -> dict[str, tuple]:
    """The ``"proj"`` draws' shapes: ``(d_leaf, proj_dim)`` per leaf of
    one client's parameters."""
    return {k: (v.numel(), proj_dim) for k, v in template.items()}


def project_rows(stacked_deltas: Tree, normals: Tree,
                 proj_dim: int = PROJ_DIM) -> torch.Tensor:
    """``[B, P]``: each row's flattened delta times the round's Gaussian
    blocks ``normals`` (:func:`proj_shapes`), leaf by leaf, scaled by
    ``1/sqrt(P)`` so squared distances are kept in expectation. TF32
    off."""
    leaves = list(stacked_deltas.items())
    b = leaves[0][1].shape[0]
    acc = torch.zeros((b, proj_dim), dtype=T.wide(leaves[0][1]).dtype,
                      device=leaves[0][1].device)
    with robust._full_float32():
        for k, leaf in leaves:
            acc = acc + T.wide(T.rows(leaf)) @ normals[k].to(acc.dtype)
    return acc / float(proj_dim) ** 0.5


def fold_proj(stacked_deltas: Tree, n_k: torch.Tensor, live: torch.Tensor,
              positions: range, n_slots: int, normals: Tree) -> ProjSketch:
    """One block's sketch rows, written at its slots ``positions`` (a
    host range) into zeros of ``n_slots`` rows."""
    proj = project_rows(stacked_deltas, normals)
    sq = sum(torch.sum(torch.square(T.wide(T.rows(v))), dim=1)
             for v in stacked_deltas.values())
    sl = slice(positions.start, positions.stop)

    def place(vals, shape):
        out = torch.zeros(shape, dtype=proj.dtype, device=proj.device)
        out[sl] = vals.to(proj.dtype)
        return out

    return ProjSketch(proj=place(proj, (n_slots, proj.shape[1])),
                      norm=place(torch.sqrt(sq), (n_slots,)),
                      weight=place(n_k, (n_slots,)),
                      live=place(live, (n_slots,)))


def selection_weights(method: str, sk: ProjSketch, num_adversaries: int,
                      multikrum_m: int):
    """Per-slot weights ``(w, den)`` decided from the pass-1 sketch; pass
    2 folds ``sum_i w_i delta_i`` and the aggregate is that over ``den``.
    Eligible slots are ``live & weight > 0``."""
    slots = sk.proj.shape[0]
    device = sk.proj.device
    valid = (sk.live > 0) & (sk.weight > 0)
    n_valid = torch.sum(valid.long())
    one = torch.ones((), dtype=sk.proj.dtype, device=device)
    if method in ("krum", "multikrum"):
        rows = torch.arange(slots, device=device)
        d2 = robust.pairwise_sq_dists_rows(sk.proj, rows, sk.proj)
        scores = robust.krum_scores_rows(d2, rows, num_adversaries, valid,
                                         n_valid)
        if method == "krum":
            # the chosen client's delta is the aggregate: a one-hot weight
            # makes pass 2's weighted sum reproduce it exactly
            w = (torch.arange(slots, device=device)
                 == torch.argmin(scores)).to(sk.proj.dtype)
            return w, one
        m = (torch.full_like(n_valid, multikrum_m) if multikrum_m > 0
             else torch.clamp(n_valid - num_adversaries, min=1))
        m = torch.minimum(torch.clamp(m, min=1),
                          torch.clamp(n_valid, min=1))
        mask = robust._rank_mask(scores, m) & valid
        w = torch.where(mask, sk.weight, 0.0)
        return w, torch.clamp(torch.sum(w), min=1e-12)
    if method == "fltrust":
        eps = 1e-12
        ref = robust.coordinate_median({"p": sk.proj}, valid)["p"]
        rn_p = torch.sqrt(torch.sum(ref * ref))
        xn_p = torch.sqrt(torch.sum(sk.proj * sk.proj, dim=1))
        with robust._full_float32():
            dots = sk.proj @ ref
        cos = dots / torch.clamp(xn_p * rn_p, min=eps)
        trust = torch.relu(cos) * valid.to(sk.proj.dtype)
        rn = robust.coordinate_median({"n": sk.norm}, valid)["n"]
        norm_match = rn / torch.clamp(sk.norm, min=eps)
        tsum = torch.sum(trust)
        w = (trust / torch.clamp(tsum, min=eps)) * norm_match
        # no trust at all: a zero aggregate (the stacked rule returns its
        # full reference, which the sketch does not hold)
        return torch.where(tsum > 0, w, 0.0), one
    raise ValueError(f"not a streaming selection method: {method!r}")


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def sketch_mb(method: str, flat_dim: int, n_slots: int) -> float:
    """The sketch's resident size in MB (what the round holds instead of
    the ``[C, D]`` deltas)."""
    if method in QUANTILE_METHODS:
        return 4.0 * flat_dim * (HIST_BINS + 2) / 1e6
    return 4.0 * n_slots * (PROJ_DIM + 3) / 1e6


def note_defense(counters: dict, method: str, flat_dim: int,
                 n_slots: int) -> None:
    """The sketch's gauges, under the JAX package's names, in
    ``counters`` and the registry."""
    telemetry.set_gauge(counters, "defense.sketch_bins",
                        HIST_BINS if method in QUANTILE_METHODS else 0)
    telemetry.set_gauge(counters, "defense.sketch_proj_dim",
                        PROJ_DIM if method in PROJECTION_METHODS else 0)
    telemetry.set_gauge(counters, "defense.sketch_mb",
                        sketch_mb(method, flat_dim, n_slots))
