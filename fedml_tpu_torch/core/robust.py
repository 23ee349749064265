"""Byzantine-robust aggregation on stacked client deltas: the JAX
package's ``core/robust.py`` on flat ``{name: [C, ...]}`` trees.

- the coordinate-wise rules: norm clipping, the aggregate's gaussian
  noise, the coordinate median and the trimmed mean;
- the selection and scoring rules: Krum and multi-Krum over one gram
  matmul of the flattened deltas, FLTrust-style cosine trust against a
  reference delta, and the anomaly scores;
- :class:`DefensePipeline`, which composes them (clip, reduce, noise) as
  the server's aggregation rule;
- the non-finite screen of every aggregation path, and the rule that
  keeps fednova apart from the reducing defenses.

The rules compute in float32, or in float64 for float64 deltas (a
reference on the host). Nothing here reads a value back to the host:
selections are ``argmin``, sorts and masks on the device, never boolean
indexing or ``nonzero``.
The ``valid=`` and ``n_valid=`` forms (a ``[C]`` mask of live rows and
their count, as device tensors) serve a cohort padded to a fixed size.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Mapping

import torch

from fedml_tpu_torch.core import tree as T
from fedml_tpu_torch.core.device import to_device

Tree = dict[str, torch.Tensor]


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[C]`` ``v`` shaped to broadcast over the stacked leaf ``x``."""
    return v.reshape((-1,) + (1,) * (x.ndim - 1))


@contextlib.contextmanager
def _full_float32():
    """float32 matrix products without TF32: the Krum distance ``|x|^2 +
    |y|^2 - 2 x.y`` cancels, and TF32's 10-bit mantissa would reorder the
    selection."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def clip_deltas_by_norm(stacked: Tree, clip: float) -> Tree:
    """Each client's delta scaled to an L2 norm of at most ``clip``. The
    scale is computed in float32 and each leaf keeps its type; an
    all-zero delta passes through; zero-size leaves are left as they
    are."""
    if not stacked:
        return stacked
    norms = torch.sqrt(sum(torch.sum(torch.square(T.wide(T.rows(v))), 1)
                           for v in stacked.values()))  # [C]
    scale = torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0)

    def leaf(x):
        if x.numel() == 0:
            return x
        return (T.wide(x) * _bcast(scale, x)).to(x.dtype)

    return {k: leaf(v) for k, v in stacked.items()}


def add_gaussian_noise(tree: Tree, stddev: float, normals: Tree) -> Tree:
    """The aggregate plus ``stddev`` times standard normal draws
    ``normals`` (one per element, drawn by the caller)."""
    return {k: v + stddev * normals[k].to(v.dtype) for k, v in tree.items()}


def _take_row(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a device scalar) of ``s``, without reading ``i``."""
    return s.index_select(0, i.reshape(1))[0]


def coordinate_median(stacked: Tree,
                      valid: torch.Tensor | None = None) -> Tree:
    """The coordinate-wise median over the client axis: ``(lo + hi) / 2``
    of the two middle values of a sort, as ``jnp.median`` gives it
    (``torch.median`` takes the lower one on an even count). With
    ``valid`` the median is over the valid rows only: the others sort to
    ``+inf`` and the middle is taken at the valid count."""
    if valid is None:
        def leaf(x):
            c = x.shape[0]
            s = torch.sort(x, dim=0).values
            return ((s[(c - 1) // 2] + s[c // 2]) / 2).to(x.dtype)

        return {k: leaf(v) for k, v in stacked.items()}
    n = torch.sum(valid.int())
    # clamped at 0: with no valid row the median is +inf, not a fault
    lo_i = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi_i = torch.div(n, 2, rounding_mode="floor")

    def masked(x):
        s = torch.sort(torch.where(_bcast(valid, x), x, torch.inf), dim=0)
        s = s.values
        return ((_take_row(s, lo_i) + _take_row(s, hi_i)) / 2).to(x.dtype)

    return {k: masked(v) for k, v in stacked.items()}


def trim_count(c: int, trim_frac: float) -> int:
    """Rows trimmed from each side of ``c``: ``int(c * trim_frac)`` in
    Python floats, as the JAX package computes it (float32 can differ:
    it trims 29 of 100 at 0.29, Python floats 28), clamped so that at
    least one row survives."""
    return max(0, min(int(c * trim_frac), (c - 1) // 2))


def trimmed_mean(stacked: Tree, trim_frac: float = 0.1,
                 valid: torch.Tensor | None = None) -> Tree:
    """The coordinate-wise trimmed mean: sort over the client axis and
    average the rows ``[k, c - k)``, ``k = trim_count(c, trim_frac)``.
    With ``valid`` the invalid rows sort to ``+inf`` and the band comes
    from the valid count (its trim count looked up in a table made on
    the host)."""
    if valid is None:
        def leaf(x):
            c = x.shape[0]
            k = trim_count(c, trim_frac)
            if k == 0:
                return torch.mean(x, dim=0)
            return torch.mean(torch.sort(x, dim=0).values[k:c - k], dim=0)

        return {k: leaf(v) for k, v in stacked.items()}
    c_max = valid.shape[0]
    ks = to_device(torch.tensor([trim_count(c, trim_frac)
                                 for c in range(c_max + 1)]), valid.device)
    n = torch.sum(valid.long())
    k = _take_row(ks, n)
    idx = torch.arange(c_max, device=valid.device)
    band = (idx >= k) & (idx < n - k)

    def masked(x):
        s = torch.sort(torch.where(_bcast(valid, x), x, torch.inf), dim=0)
        kept = torch.where(_bcast(band, x), s.values, 0.0)
        return torch.sum(kept, dim=0) / (n - 2 * k).to(x.dtype)

    return {k_: masked(v) for k_, v in stacked.items()}


# ---------------------------------------------------------------------------
# selection and scoring
# ---------------------------------------------------------------------------


def flatten_clients(stacked: Tree) -> torch.Tensor:
    """``[C, D]`` float32 (float64 deltas: float64): each client's delta
    flattened, leaves in the tree's key order."""
    return torch.cat([T.wide(T.rows(v)) for v in stacked.values()], dim=1)


def pairwise_sq_dists_rows(x_rows: torch.Tensor, rows: torch.Tensor,
                           x_all: torch.Tensor) -> torch.Tensor:
    """``[R, C]``: squared distances from ``x_rows`` (rows ``rows`` of the
    cohort) to every client of ``x_all``, by one gram matmul (TF32
    off), clamped at 0, with exact zeros at the self slots."""
    sq_r = torch.sum(x_rows * x_rows, dim=1)
    sq_a = torch.sum(x_all * x_all, dim=1)
    with _full_float32():
        gram = x_rows @ x_all.T
    d2 = torch.clamp(sq_r[:, None] + sq_a[None, :] - 2.0 * gram, min=0.0)
    eye = rows[:, None] == torch.arange(x_all.shape[0],
                                        device=rows.device)[None, :]
    return d2 * (1.0 - eye.to(d2.dtype))


def pairwise_sq_dists(stacked: Tree) -> torch.Tensor:
    """``[C, C]`` squared L2 distances between the clients' deltas."""
    x = flatten_clients(stacked)
    return pairwise_sq_dists_rows(
        x, torch.arange(x.shape[0], device=x.device), x)


# a finite stand-in for "not a neighbour": a few of them still sum to a
# float32 value, where inf would make every score inf and argmin arbitrary
_FAR = 1e30


def krum_scores(d2: torch.Tensor, num_adversaries: int,
                valid: torch.Tensor | None = None,
                n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Krum's score per client: the sum of its ``C - f - 2`` smallest
    distances to other clients (at least the nearest one). Distances to
    and from rows not ``valid`` count as :data:`_FAR`; with ``n_valid``
    the neighbour count comes from the valid count and invalid rows
    score ``inf``."""
    return krum_scores_rows(
        d2, torch.arange(d2.shape[0], device=d2.device), num_adversaries,
        valid, n_valid)


def krum_scores_rows(d2: torch.Tensor, rows: torch.Tensor,
                     num_adversaries: int,
                     valid: torch.Tensor | None = None,
                     n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`krum_scores` for a row block ``[R, C]`` of the distance
    matrix, ``rows`` its rows' indices, ``valid`` the whole cohort's
    mask."""
    c = d2.shape[1]
    cols = torch.arange(c, device=d2.device)
    if valid is not None:
        pair_ok = valid[rows][:, None] & valid[None, :]
        pair_ok = pair_ok | (rows[:, None] == cols[None, :])
        d2 = torch.where(pair_ok, d2, _FAR)
    s = torch.sort(d2, dim=1).values  # column 0: the exact-zero self slot
    if n_valid is None:
        k = max(1, min(c - 2 - num_adversaries, c - 1))
        return torch.sum(s[:, 1:k + 1], dim=1)
    k = torch.minimum(torch.clamp(n_valid - 2 - num_adversaries, min=1),
                      torch.clamp(n_valid - 1, min=1))
    sel = (cols >= 1) & (cols <= k)
    scores = torch.sum(torch.where(sel[None, :], s, 0.0), dim=1)
    if valid is not None:
        scores = torch.where(valid[rows], scores, torch.inf)
    return scores


def krum(stacked: Tree, num_adversaries: int,
         weights: torch.Tensor | None = None,
         n_valid: torch.Tensor | None = None,
         scores: torch.Tensor | None = None):
    """Krum: ``(the most central client's delta, scores, its index)``;
    rows of zero weight are never selected. The index stays on the
    device (``argmin`` takes the first of equal scores, as JAX's)."""
    if scores is None:
        valid = None if weights is None else weights > 0
        scores = krum_scores(pairwise_sq_dists(stacked), num_adversaries,
                             valid, n_valid)
    best = torch.argmin(scores)
    return {k: _take_row(v, best) for k, v in stacked.items()}, scores, best


def _rank_mask(scores: torch.Tensor, keep) -> torch.Tensor:
    """``[C]`` bool: the ``keep`` lowest scores, ties to the lower index
    (a stable sort: ``lax.top_k``'s order, which ``torch.topk`` does not
    promise on the card). ``keep`` is an int or a device scalar."""
    order = torch.sort(scores, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return rank < keep


def multi_krum(stacked: Tree, weights: torch.Tensor, num_adversaries: int,
               m: int = 0, n_valid: torch.Tensor | None = None,
               scores: torch.Tensor | None = None):
    """Multi-Krum: ``(weighted mean of the m best-scored clients, scores,
    their mask)``, ``m = 0`` meaning ``C - f`` (with ``n_valid``: from
    the valid count), clamped to at least 1. Rows of zero weight rank
    last and, being weightless, add nothing."""
    c = weights.shape[0]
    f = num_adversaries
    if scores is None:
        scores = krum_scores(pairwise_sq_dists(stacked), f, weights > 0,
                             n_valid)
    if n_valid is None:
        keep = max(1, min(m if m > 0 else max(1, c - f), c))
    else:
        keep = (torch.full_like(n_valid, m) if m > 0
                else torch.clamp(n_valid - f, min=1))
        keep = torch.minimum(torch.clamp(keep, min=1), n_valid)
    mask = _rank_mask(scores, keep)
    w = torch.where(mask, T.wide(weights), 0.0)
    return T.tree_weighted_mean(stacked, w), scores, mask


def fltrust(stacked: Tree, ref: Tree, eps: float = 1e-12,
            weights: torch.Tensor | None = None):
    """FLTrust-style aggregation against a reference delta ``ref``: trust
    ``relu(cos(d_i, ref))`` (0 for rows of zero weight), each delta
    scaled to ``ref``'s norm, the trust-weighted mean; ``ref`` itself
    when no client has trust. Returns ``(aggregate, trust)``."""
    x = flatten_clients(stacked)  # [C, D]
    r = T.wide(T.tree_vectorize(ref))
    rn = torch.sqrt(torch.sum(r * r))
    xn = torch.sqrt(torch.sum(x * x, dim=1))
    with _full_float32():
        dots = x @ r
    trust = torch.relu(dots / torch.clamp(xn * rn, min=eps))
    if weights is not None:
        trust = trust * (weights > 0)
    norm_match = rn / torch.clamp(xn, min=eps)
    total = torch.sum(trust)
    w = trust / torch.clamp(total, min=eps)
    agg = torch.sum(x * (w * norm_match)[:, None], dim=0)
    agg = torch.where(total > 0, agg, r)
    return T.tree_unvectorize(agg, ref), trust


def anomaly_scores(stacked: Tree, valid: torch.Tensor | None = None
                   ) -> dict[str, torch.Tensor]:
    """Per-client anomaly signals from one flatten and one gram matmul:
    ``l2_norm`` and its cohort z-score ``l2_z`` (standard deviation with
    ddof 0, as ``jnp.std``), cosines to the cohort's mean and median
    deltas, ``nearest_rel`` (nearest-neighbour distance over the
    client's norm: near 0 for a colluding copy) and the combined
    ``score = relu(l2_z) + relu(-cos_to_med) + 2 * (nearest_rel <
    1e-3)``. With ``valid`` every cohort statistic is over the valid rows
    (scores at invalid rows mean nothing)."""
    eps = 1e-12
    x = flatten_clients(stacked)
    c = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    norms = torch.sqrt(sq)
    if valid is None:
        mu = torch.mean(norms)
        sd = torch.std(norms, correction=0)
        mean_vec = torch.mean(x, dim=0)
    else:
        n = torch.sum(valid.float())
        mu = torch.sum(torch.where(valid, norms, 0.0)) / n
        sd = torch.sqrt(torch.sum(torch.where(
            valid, torch.square(norms - mu), 0.0)) / n)
        mean_vec = torch.sum(torch.where(valid[:, None], x, 0.0), 0) / n
    l2_z = (norms - mu) / torch.clamp(sd, min=1e-6)
    med_vec = T.wide(T.tree_vectorize(coordinate_median(stacked, valid)))

    def cos(ref):
        rn = torch.sqrt(torch.sum(ref * ref))
        with _full_float32():
            dots = x @ ref
        return dots / torch.clamp(norms * rn, min=eps)

    with _full_float32():
        gram = x @ x.T
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    eye = torch.eye(c, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.inf, d2)
    if valid is not None:
        d2 = torch.where(valid[:, None] & valid[None, :], d2, torch.inf)
    nearest = (torch.sqrt(torch.amin(d2, dim=1)) if c > 1
               else torch.full((c,), torch.inf, device=x.device))
    nearest_rel = nearest / torch.clamp(norms, min=eps)
    cos_to_med = cos(med_vec)
    score = (torch.relu(l2_z) + torch.relu(-cos_to_med)
             + 2.0 * (nearest_rel < 1e-3).float())
    return {"l2_norm": norms, "l2_z": l2_z, "cos_to_mean": cos(mean_vec),
            "cos_to_med": cos_to_med, "nearest_rel": nearest_rel,
            "score": score}


# ---------------------------------------------------------------------------
# the non-finite screen, and fednova's rule
# ---------------------------------------------------------------------------


def finite_client_mask(stacked: Tree, n_k: torch.Tensor) -> torch.Tensor:
    """``[C]`` bool: True where every floating tensor of client ``c`` is
    finite and its sample count is finite."""
    ok = torch.isfinite(n_k.float())
    for x in stacked.values():
        if not torch.is_floating_point(x):
            continue
        ok = ok & torch.isfinite(T.rows(x)).all(dim=1)
    return ok


def check_fednova_compat(algorithm: str, method: str) -> None:
    """fednova's tau-normalized mean is the aggregation rule, so a
    reducing defense would be bypassed while the configuration says it is
    in force: raise ``ValueError`` for that pair, as the JAX package's
    ``check_fednova_compat`` does."""
    if algorithm == "fednova" and method not in ("mean", "", None):
        raise ValueError(
            f"robust_method={method!r} is incompatible with "
            "algorithm='fednova' (tau-normalized averaging is the "
            "aggregation rule); use fedavg/fedopt with a defense, or "
            "keep fednova with robust_norm_clip/robust_noise_stddev "
            "(which do compose)"
        )


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DefensePipeline:
    """The server's aggregation rule: clip each delta (``clip > 0``),
    reduce with ``method``, noise the aggregate (``noise_stddev > 0``).
    The default (``mean``, no clip, no noise) is the plain weighted
    mean."""

    method: str = "mean"
    clip: float = 0.0
    noise_stddev: float = 0.0
    num_adversaries: int = 0
    multikrum_m: int = 0  # 0: C - f
    trim_frac: float = 0.1

    METHODS = ("mean", "median", "trimmed_mean", "krum", "multikrum",
               "fltrust")

    def __post_init__(self):
        if self.method not in self.METHODS:
            raise ValueError(f"defense method must be one of "
                             f"{self.METHODS}, got {self.method!r}")
        if (self.method == "multikrum" and self.num_adversaries == 0
                and self.multikrum_m == 0):
            # C - f with f = 0 keeps every client: the plain mean under
            # another name
            raise ValueError(
                "multikrum with num_adversaries=0 and multikrum_m=0 "
                "selects every client (plain mean); set "
                "--defense_num_adversaries f (auto m = C - f) or an "
                "explicit --defense_multikrum_m")

    @staticmethod
    def from_fed(fed) -> "DefensePipeline":
        """From :class:`~fedml_tpu_torch.config.FedConfig`'s robust_*
        fields."""
        return DefensePipeline(
            method=fed.robust_method or "mean",
            clip=fed.robust_norm_clip,
            noise_stddev=fed.robust_noise_stddev,
            num_adversaries=fed.robust_num_adversaries,
            multikrum_m=fed.robust_multikrum_m,
            trim_frac=fed.robust_trim_frac,
        )

    def preprocess(self, deltas: Tree) -> Tree:
        return clip_deltas_by_norm(deltas, self.clip) if self.clip > 0 \
            else deltas

    def reduce(self, deltas: Tree, weights: torch.Tensor, red,
               valid: torch.Tensor | None = None) -> Tree:
        """The stacked deltas aggregated by the rule. ``red`` is the
        :class:`~fedml_tpu_torch.algorithms.fedavg.Reducer`: the
        coordinate and selection rules gather the whole ``[C, ...]``
        stack. With ``valid`` every rule reduces over the valid rows
        only. (The JAX package's mesh-sharded Krum scores, computed
        blockwise over a mesh axis, have no counterpart yet: on a local
        reducer they are not used.)"""
        if self.method == "mean":
            return red.wmean(deltas, weights)
        g = red.gather(deltas)
        gv = None if valid is None else red.gather(valid)
        n_valid = None if gv is None else torch.sum(gv.long())
        if self.method == "median":
            return coordinate_median(g, gv)
        if self.method == "trimmed_mean":
            return trimmed_mean(g, self.trim_frac, gv)
        gw = red.gather(weights)
        if gv is not None:
            gw = torch.where(gv, gw, 0.0)
        if self.method == "krum":
            return krum(g, self.num_adversaries, gw, n_valid)[0]
        if self.method == "multikrum":
            return multi_krum(g, gw, self.num_adversaries, self.multikrum_m,
                              n_valid)[0]
        # fltrust: with no server dataset, the reference delta is the
        # cohort's coordinate median
        return fltrust(g, coordinate_median(g, gv), weights=gw)[0]

    def postprocess(self, agg: Tree,
                    normals: Callable[[Mapping[str, tuple]], Tree] | None
                    ) -> Tree:
        """The aggregate plus its noise; ``normals(shapes)`` draws the
        standard normals (only when ``noise_stddev > 0``)."""
        if self.noise_stddev <= 0:
            return agg
        if normals is None:
            raise ValueError("robust_noise_stddev > 0 needs the "
                             "aggregate's noise draws")
        draws = normals({k: tuple(v.shape) for k, v in agg.items()})
        return add_gaussian_noise(agg, self.noise_stddev, draws)

    def excluded_count(self, cohort_size: int) -> int:
        """How many of ``cohort_size`` results the rule leaves out by
        construction (fltrust reweights at run time: 0)."""
        if self.method == "krum":
            return max(0, cohort_size - 1)
        if self.method == "multikrum":
            m = self.multikrum_m if self.multikrum_m > 0 else max(
                1, cohort_size - self.num_adversaries)
            return max(0, cohort_size - min(m, cohort_size))
        return 0
