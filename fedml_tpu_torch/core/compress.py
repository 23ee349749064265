"""Compression of the client->server update, the JAX package's
``core/compress.py`` on flat ``{name: tensor}`` trees.

- **int8**: per-leaf absmax scale, values rounded into [-127, 127];
  rounding to nearest (half to even), or stochastic, ``floor(y + u)``
  with ``u`` uniform on [0, 1) (unbiased);
- **topk**: per leaf, the ``k = max(1, int(topk_frac * size))``
  entries largest in magnitude as (int32 index, float32 value) pairs,
  ties to the lower index (``lax.top_k``'s order);
- **topk_int8**: top-k, then the kept values int8-quantized.

**Error feedback**: a client carries the residual ``r_t = (d_t +
r_{t-1}) - deQ(Q(d_t + r_{t-1}))`` into its next round, so the
transmitted sum telescopes: ``sum_t sent_t = sum_t d_t - r_T``. A round
whose delta is not finite resets the carry instead of keeping the
poison.

The codec works on rows: each leaf of ``C`` clients is ``[C, n]``, and a
single client's leaf is one row, so the single and the stacked forms
share one implementation. Stochastic rounding takes its uniform draws
from the caller (:meth:`CompressionSpec.draw_shapes` says their shapes);
deterministic specs need none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from fedml_tpu_torch.core import tree as T

Tree = dict[str, torch.Tensor]

METHODS = ("none", "int8", "topk", "topk_int8")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """The wire codec, shared by both ends of the wire."""

    method: str = "none"
    topk_frac: float = 0.01  # share of each leaf's entries topk keeps
    stochastic: bool = True  # stochastic rounding for the int8 family
    error_feedback: bool = True  # carry the residual across rounds
    seed: int = 0  # the quantizer's draw stream

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"compress method must be one of {METHODS}, "
                             f"got {self.method!r}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"compress_topk_frac must be in (0, 1], "
                             f"got {self.topk_frac}")

    def enabled(self) -> bool:
        return self.method != "none"

    @staticmethod
    def from_fed(fed, seed: int = 0) -> "CompressionSpec":
        """From :class:`~fedml_tpu_torch.config.FedConfig`'s compress_*
        fields; ``seed`` is the experiment's."""
        return CompressionSpec(method=fed.compress or "none",
                               topk_frac=fed.compress_topk_frac, seed=seed)

    def leaf_k(self, size: int) -> int:
        """Top-k's keep count for a leaf of ``size`` entries."""
        return min(max(1, int(size * self.topk_frac)), size)

    def draw_shapes(self, template: Tree) -> dict[str, tuple]:
        """The uniform draws one client's stochastic rounding takes, by
        leaf: the leaf's shape (int8), ``(k,)`` (topk_int8), none
        otherwise."""
        if not self.stochastic or self.method not in ("int8", "topk_int8"):
            return {}
        return {k: (tuple(v.shape) if self.method == "int8"
                    else (self.leaf_k(v.numel()),))
                for k, v in template.items() if v.numel()}


# ---------------------------------------------------------------------------
# the codec on rows: x [C, n] -> payload parts with a leading C
# ---------------------------------------------------------------------------


def _round(y: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
    """Round half to even, or ``floor(y + u)`` with the draws ``u``."""
    return torch.round(y) if u is None else torch.floor(y + u)


def _quant_int8(x: torch.Tensor, u: torch.Tensor | None):
    """``(q int8 [C, n], scale float32 [C])``: per-row absmax scaling; an
    all-zero row gets scale 0 and dequantizes to exact zeros."""
    x = x.float()
    absmax = torch.amax(torch.abs(x), dim=1)
    # a tensor divisor: torch's CUDA division by a scalar multiplies by
    # its reciprocal, a second rounding the CPU and the JAX package do
    # not make
    scale = absmax / torch.full_like(absmax, 127.0)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(_round(x / safe[:, None], u), -127, 127)
    return q.to(torch.int8), scale


def _top_idx(flat: torch.Tensor, k: int) -> torch.Tensor:
    """``[C, k]`` int64: each row's ``k`` entries largest in magnitude,
    in descending order, ties to the lower index (a stable sort of the
    whole row: ``torch.topk`` promises no order among ties)."""
    return torch.sort(torch.abs(flat), dim=1, descending=True,
                      stable=True).indices[:, :k]


def _encode_rows(spec: CompressionSpec, x: torch.Tensor,
                 u: torch.Tensor | None) -> Tree:
    """One leaf of ``C`` clients, ``[C, n]`` with ``n > 0``, to its
    payload; ``u`` the rows' uniform draws (or None: round to
    nearest)."""
    if spec.method == "int8":
        q, scale = _quant_int8(x, u)
        return {"q": q, "scale": scale}
    flat = x.float()
    idx = _top_idx(flat, spec.leaf_k(flat.shape[1]))
    vals = torch.gather(flat, 1, idx)
    idx = idx.to(torch.int32)
    if spec.method == "topk":
        return {"idx": idx, "vals": vals}
    q, scale = _quant_int8(vals, u)
    return {"idx": idx, "q": q, "scale": scale}


def _decode_rows(spec: CompressionSpec, payload: Tree, n: int,
                 rows: int) -> torch.Tensor:
    """The inverse of :func:`_encode_rows`: ``[rows, n]`` float32."""
    if spec.method == "int8":
        return T.rows(payload["q"]).float() * payload["scale"][:, None]
    vals = (payload["vals"] if spec.method == "topk"
            else payload["q"].float() * payload["scale"][:, None])
    out = torch.zeros((rows, n), dtype=torch.float32, device=vals.device)
    return out.scatter_(1, payload["idx"].long(), vals)


# ---------------------------------------------------------------------------
# one client
# ---------------------------------------------------------------------------


def compress_leaf(spec: CompressionSpec, x: torch.Tensor,
                  u: torch.Tensor | None) -> Tree:
    """One leaf to its payload: ``{"q", "scale"}`` (int8, ``q`` shaped
    like ``x``), ``{"idx", "vals"}`` (topk), ``{"idx", "q", "scale"}``
    (topk_int8), ``{"dense"}`` for a zero-size leaf."""
    if x.numel() == 0:
        return {"dense": x}
    p = _encode_rows(spec, x.reshape(1, -1),
                     None if u is None else u.reshape(1, -1))
    p = {k: v[0] for k, v in p.items()}
    if spec.method == "int8":
        p["q"] = p["q"].reshape(x.shape)
    return p


def decompress_leaf(spec: CompressionSpec, payload: Tree,
                    like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`compress_leaf`, shaped and typed by
    ``like``."""
    if "dense" in payload:
        return payload["dense"].to(like.dtype)
    p = {k: v[None] for k, v in payload.items()}
    return _decode_rows(spec, p, like.numel(), 1).reshape(like.shape).to(
        like.dtype)


def compress_tree(spec: CompressionSpec, delta: Tree,
                  draws: Tree | None = None) -> dict[str, Tree]:
    """A delta tree to its payload tree (a payload dict per leaf);
    ``draws`` the uniform draws of :meth:`CompressionSpec.draw_shapes`
    (None: round to nearest)."""
    draws = draws if spec.stochastic else None
    return {k: compress_leaf(spec, v, None if draws is None
                             else draws.get(k))
            for k, v in delta.items()}


def decompress_tree(spec: CompressionSpec, payload: Mapping[str, Tree],
                    template: Tree) -> Tree:
    """A payload tree to a delta tree shaped like ``template``."""
    return {k: decompress_leaf(spec, payload[k], v)
            for k, v in template.items()}


def roundtrip_tree(spec: CompressionSpec, delta: Tree,
                   draws: Tree | None = None) -> Tree:
    """``decompress(compress(delta))``: what the server receives."""
    return decompress_tree(spec, compress_tree(spec, delta, draws), delta)


def _carry(spec: CompressionSpec, delta: Tree, deq: Tree,
           stacked: bool) -> Tree:
    """The new error-feedback residual ``delta - deq``, all 0 for a
    client whose delta is not finite (per row when ``stacked``), or all
    0 without error feedback."""
    if not spec.error_feedback:
        return {k: torch.zeros_like(d) for k, d in delta.items()}
    ok = None
    for d in delta.values():
        if torch.is_floating_point(d):
            fin = (torch.isfinite(T.rows(d)).all(dim=1) if stacked
                   else torch.isfinite(d).all())
            ok = fin if ok is None else ok & fin
    if ok is None:
        return {k: d - deq[k] for k, d in delta.items()}
    return {k: torch.where(ok.reshape((-1,) + (1,) * (d.ndim - 1))
                           if stacked else ok, d - deq[k], 0.0)
            for k, d in delta.items()}


def apply_with_feedback(spec: CompressionSpec, delta: Tree,
                        residual: Tree | None, draws: Tree | None = None):
    """One client's compressed update: fold the carried residual into the
    delta, compress, keep the new residual. Returns ``(payload,
    decompressed delta, new residual)``; the new residual is 0 if the
    delta is not finite."""
    if residual is not None:
        delta = {k: d + residual[k].to(d.dtype) for k, d in delta.items()}
    payload = compress_tree(spec, delta, draws)
    deq = decompress_tree(spec, payload, delta)
    return payload, deq, _carry(spec, delta, deq, stacked=False)


# ---------------------------------------------------------------------------
# stacked [C, ...] forms (the simulation's wire model, the server's side)
# ---------------------------------------------------------------------------


def roundtrip_stacked(spec: CompressionSpec, stacked_delta: Tree,
                      residual: Tree | None, draws: Tree | None = None):
    """The simulation's wire model: :func:`apply_with_feedback` for each
    of ``C`` slots at once. ``draws`` are the slots' uniform draws
    (``[C, *shape]`` per leaf of :meth:`CompressionSpec.draw_shapes`).
    Returns ``(decompressed stacked delta, new stacked residual)``."""
    draws = draws if spec.stochastic else None
    delta = stacked_delta if residual is None else {
        k: d + residual[k].to(d.dtype) for k, d in stacked_delta.items()}
    deq = {}
    for k, d in delta.items():
        if d[0].numel() == 0:
            deq[k] = d
            continue
        u = None if draws is None or k not in draws else T.rows(draws[k])
        x = T.rows(d)
        p = _encode_rows(spec, x, u)
        deq[k] = _decode_rows(spec, p, x.shape[1], x.shape[0]).reshape(
            d.shape).to(d.dtype)
    return deq, _carry(spec, delta, deq, stacked=True)


def roundtrip_rows(spec: CompressionSpec, stacked_delta: Tree,
                   residual_rows: Tree, draws: Tree | None = None):
    """:func:`roundtrip_stacked` for the bulk engine's rows: the
    residual rows come from a client-keyed bank
    (:class:`~fedml_tpu_torch.core.statebank.ClientStateBank`) and the
    caller draws the quantizer's uniforms by CLIENT ID, not by cohort
    slot (``draws("quant", round, ids, shapes)``), so a client's rounding
    noise follows the client across rounds. Returns ``(decompressed
    delta, new residual rows)``."""
    return roundtrip_stacked(spec, stacked_delta, residual_rows, draws)


def pad_stacked_payload(stacked_payload: Mapping[str, Tree],
                        bucket: int) -> dict[str, Tree]:
    """Pad every payload part to ``bucket`` rows of zeros. A zero row
    (indices 0, values 0, scale 0) decompresses to a delta of exactly 0,
    the padded row of :func:`fedml_tpu_torch.core.elastic.pad_stacked`,
    so bucket padding and compression compose."""

    def part(x):
        c = x.shape[0]
        if c > bucket:
            raise ValueError(f"cohort {c} does not fit bucket {bucket}")
        if c == bucket:
            return x
        return torch.cat([x, x.new_zeros((bucket - c,) + tuple(x.shape[1:]))])

    return {k: {n: part(x) for n, x in p.items()}
            for k, p in stacked_payload.items()}


def decompress_stacked(spec: CompressionSpec,
                       stacked_payload: Mapping[str, Tree],
                       template: Tree) -> Tree:
    """Stacked payloads (parts with a leading ``C``) to the stacked dense
    delta ``[C, ...]``, each leaf shaped and typed by ``template`` (one
    client's variables)."""
    out = {}
    for k, like in template.items():
        p = stacked_payload[k]
        if "dense" in p:
            out[k] = p["dense"].to(like.dtype)
            continue
        rows = next(iter(p.values())).shape[0]
        out[k] = _decode_rows(spec, p, like.numel(), rows).reshape(
            (rows,) + tuple(like.shape)).to(like.dtype)
    return out


def zero_residual(template: Tree, n: int) -> Tree:
    """A fresh ``[n, ...]`` error-feedback carry for ``n`` slots."""
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in template.items()}


# ---------------------------------------------------------------------------
# host-side accounting and the receive edge's screen
# ---------------------------------------------------------------------------


def _leaf_payload_bytes(spec: CompressionSpec, leaf: torch.Tensor) -> int:
    size = leaf.numel()
    if size == 0 or not spec.enabled():
        return size * leaf.element_size()
    if spec.method == "int8":
        return size * 1 + 4
    k = spec.leaf_k(size)
    if spec.method == "topk":
        return k * (4 + 4)
    return k * (4 + 1) + 4  # topk_int8


def wire_ratio(spec: CompressionSpec, template: Tree) -> float:
    """Dense over compressed payload bytes of one client's variables,
    from their shapes (the ``compress.ratio`` gauge)."""
    dense = sum(v.numel() * v.element_size() for v in template.values())
    compressed = sum(_leaf_payload_bytes(spec, v) for v in template.values())
    return dense / max(1, compressed)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A leaf's expected payload: ``{part: (shape, dtype)}``, and the
    dense size that top-k indices must fall in."""

    parts: dict
    dense_size: int | None = None


def payload_template(spec: CompressionSpec, variables: Tree
                     ) -> dict[str, LeafSpec]:
    """The payload a client's result must have, leaf by leaf: what
    :func:`validate_payload` checks an inbound result against."""

    def leaf(g):
        size = g.numel()
        if size == 0:
            return LeafSpec({"dense": (tuple(g.shape), g.dtype)})
        if spec.method == "int8":
            return LeafSpec({"q": (tuple(g.shape), torch.int8),
                             "scale": ((), torch.float32)})
        k = spec.leaf_k(size)
        parts = {"idx": ((k,), torch.int32)}
        if spec.method == "topk":
            parts["vals"] = ((k,), torch.float32)
        else:
            parts["q"] = ((k,), torch.int8)
            parts["scale"] = ((), torch.float32)
        return LeafSpec(parts, dense_size=size)

    return {k: leaf(v) for k, v in variables.items()}


def validate_payload(template: Mapping[str, LeafSpec],
                     payload) -> str | None:
    """The screen of one inbound compressed result, on the host: a
    reason to drop it, or None. Checks the leaves, each part's shape and
    type, that float parts are finite, that top-k indices fall in the
    leaf, and that every scale dequantizes inside float32's range."""
    if not isinstance(payload, Mapping) or set(payload) != set(template):
        got = sorted(payload) if isinstance(payload, Mapping) \
            else type(payload).__name__
        return f"payload tree mismatch: leaves {got} != {sorted(template)}"
    for name, t in template.items():
        p = payload[name]
        if not isinstance(p, Mapping) or set(p) != set(t.parts):
            got = sorted(p) if isinstance(p, Mapping) else type(p).__name__
            return f"payload keys {got} != expected {sorted(t.parts)}"
        for part, (shape, dtype) in t.parts.items():
            arr = torch.as_tensor(p[part])
            if tuple(arr.shape) != tuple(shape):
                return (f"part {part!r} shape {tuple(arr.shape)} != "
                        f"{tuple(shape)}")
            if arr.dtype != dtype:
                return f"part {part!r} dtype {arr.dtype} != {dtype}"
            if arr.is_floating_point() and not bool(
                    torch.isfinite(arr).all()):
                return f"part {part!r} carries non-finite values"
        if "idx" in t.parts and t.dense_size is not None:
            idx = torch.as_tensor(p["idx"])
            if idx.numel() and (int(idx.min()) < 0
                                or int(idx.max()) >= t.dense_size):
                return f"idx out of range for dense size {t.dense_size}"
        if "scale" in t.parts:
            # q * scale must stay finite in float32: a scale near its
            # maximum overflows, and a clip would turn inf * 0 into NaN
            s = np.float32(torch.as_tensor(p["scale"]).item())
            with np.errstate(over="ignore"):
                biggest = s * np.float32(127.0)
            if s < 0.0 or not math.isfinite(float(biggest)):
                return f"scale {float(s)!r} dequantizes out of f32 range"
    return None
