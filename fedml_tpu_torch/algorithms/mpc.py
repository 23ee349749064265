"""Secure aggregation: the finite-field MPC layer and TurboAggregate's
secure FedAvg (``fedml_tpu.algorithms.mpc``).

The field layer is the JAX package's, copied: numpy int64 on the host
over a prime ``p < 2^31`` (by default the Mersenne prime ``2^31 - 1``),
so every product of two field elements fits int64; ``mod_matmul``
reduces after every rank-1 addition, so no sum wraps. BGW (Shamir)
sharing, Lagrange coded computing, additive shares, the Lagrange
coefficients with Fermat inverses, the fixed-point ``quantize`` and
``dequantize`` with the centered lift, and :class:`SecureAggregator`,
whose envelope guard refuses a sum the field cannot hold.

:class:`SecureFedAvgSim` is the port's
:class:`~fedml_tpu_torch.algorithms.fedavg.FedAvgSim` round with the
secure sum as its server rule: the cohort's local updates
(``FedAvgSim._locals``) on the device, then one copy to the host a
round of the cohort's flat float64 ``[C, d]`` deltas, each weighted by
``n_k / sum n_k`` before it is quantized, the exact field sum, and the
float64 sum added to the global variables, cast to float32 and put back
on the device. The deltas are flattened in the port's variable order
(the JAX package ravels flax's leaf order); every field operation is per
coordinate and the decoded sum is exact, so the order changes nothing.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fedml_tpu_torch.algorithms.base import finalize_sums
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim

P_DEFAULT = np.int64(2**31 - 1)  # Mersenne prime; products fit in int64


def _mod(a, p):
    return np.mod(a, p).astype(np.int64)


def mod_pow(base, exp: int, p) -> np.ndarray:
    """Vectorized modular exponentiation (square-and-multiply)."""
    base = _mod(np.asarray(base, np.int64), p)
    result = np.ones_like(base)
    e = int(exp)
    while e > 0:
        if e & 1:
            result = _mod(result * base, p)
        base = _mod(base * base, p)
        e >>= 1
    return result


def mod_inv(a, p) -> np.ndarray:
    """Fermat inverse a^(p-2) mod p (reference ``modular_inv``,
    ``mpc_function.py:4-18``, extended Euclid — same result, vectorized)."""
    return mod_pow(a, int(p) - 2, p)


def mod_matmul(a, b, p) -> np.ndarray:
    """Overflow-safe A @ B mod p: each rank-1 product is < p^2 < 2^62, and
    the accumulator is reduced after every addition, so no intermediate
    exceeds 2^63 (a plain int64 ``@`` would silently wrap for inner
    dimensions > 1)."""
    a = _mod(np.asarray(a, np.int64), p)
    b = _mod(np.asarray(b, np.int64), p)
    out = np.zeros((a.shape[0],) + b.shape[1:], np.int64)
    for k in range(a.shape[1]):
        out = _mod(out + a[:, k][(...,) + (None,) * (b.ndim - 1)] * b[k], p)
    return out


def gen_lagrange_coeffs(alpha_s, beta_s, p) -> np.ndarray:
    """U[i, j] = prod_{k != j} (alpha_i - beta_k) / (beta_j - beta_k) mod p
    (reference ``gen_Lagrange_coeffs``, ``mpc_function.py:38-58``),
    vectorized over both axes."""
    alpha_s = _mod(np.asarray(alpha_s, np.int64), p)
    beta_s = _mod(np.asarray(beta_s, np.int64), p)
    nb = len(beta_s)
    # den[j] = prod_{k != j} (beta_j - beta_k)
    diff_b = _mod(beta_s[:, None] - beta_s[None, :], p)  # [nb, nb]
    np.fill_diagonal(diff_b, 1)
    den = np.ones(nb, np.int64)
    for k in range(nb):
        den = _mod(den * diff_b[:, k], p)
    # num[i, j] = prod_{k != j} (alpha_i - beta_k)
    diff_a = _mod(alpha_s[:, None] - beta_s[None, :], p)  # [na, nb]
    prefix = np.ones_like(diff_a)
    suffix = np.ones_like(diff_a)
    for k in range(1, nb):
        prefix[:, k] = _mod(prefix[:, k - 1] * diff_a[:, k - 1], p)
    for k in range(nb - 2, -1, -1):
        suffix[:, k] = _mod(suffix[:, k + 1] * diff_a[:, k + 1], p)
    num = _mod(prefix * suffix, p)
    return _mod(num * mod_inv(den, p)[None, :], p)


# ---------------------------------------------------------------------------
# BGW (Shamir) secret sharing
# ---------------------------------------------------------------------------


def bgw_encode(x, n: int, t: int, p=P_DEFAULT, rng=None) -> np.ndarray:
    """Shamir shares of ``x`` [d]: share_i = sum_k r_k * alpha_i^k with
    r_0 = x (reference ``BGW_encoding``, ``mpc_function.py:62-75``).
    Returns [n, d]; any t+1 shares reconstruct, <=t reveal nothing."""
    rng = rng or np.random.default_rng()
    x = _mod(np.asarray(x, np.int64), p)
    d = x.shape[0]
    coeffs = rng.integers(0, int(p), size=(t + 1, d)).astype(np.int64)
    coeffs[0] = x
    alpha_s = _mod(np.arange(1, n + 1, dtype=np.int64), p)
    shares = np.zeros((n, d), np.int64)
    # Horner over the coefficient axis
    for k in range(t, -1, -1):
        shares = _mod(shares * alpha_s[:, None] + coeffs[k][None, :], p)
    return shares


def bgw_decode(shares, worker_idx, p=P_DEFAULT,
               t: int | None = None) -> np.ndarray:
    """Reconstruct the secret from >= t+1 shares via Lagrange at 0
    (reference ``BGW_decoding``, ``mpc_function.py:91-108``). Pass ``t`` to
    assert the share count meets the reconstruction threshold — with fewer
    than t+1 shares interpolation silently returns garbage."""
    worker_idx = np.asarray(worker_idx)
    if t is not None and len(worker_idx) < t + 1:
        raise ValueError(
            f"need >= {t + 1} shares to reconstruct, got {len(worker_idx)}"
        )
    alpha_s = _mod(worker_idx.astype(np.int64) + 1, p)
    lam = gen_lagrange_coeffs(np.zeros(1, np.int64), alpha_s, p)  # [1, R]
    return mod_matmul(lam, np.asarray(shares, np.int64), p)[0]


# ---------------------------------------------------------------------------
# Lagrange Coded Computing
# ---------------------------------------------------------------------------


def _lcc_points(n: int, k: int, t: int, p):
    n_beta = k + t
    stt_b = -(n_beta // 2)
    stt_a = -(n // 2)
    beta_s = _mod(np.arange(stt_b, stt_b + n_beta, dtype=np.int64), p)
    alpha_s = _mod(np.arange(stt_a, stt_a + n, dtype=np.int64), p)
    return alpha_s, beta_s


def lcc_encode(x, n: int, k: int, t: int, p=P_DEFAULT, rng=None):
    """LCC encoding (reference ``LCC_encoding``, ``mpc_function.py:111-133``):
    split x [m, d] into k chunks, pad with t random chunks, interpolate the
    degree-(k+t-1) polynomial through them at beta points, evaluate at the
    n alpha points. Returns [n, m//k, d]."""
    rng = rng or np.random.default_rng()
    x = _mod(np.asarray(x, np.int64), p)
    m, d = x.shape
    assert m % k == 0, (m, k)
    chunks = x.reshape(k, m // k, d)
    if t > 0:
        rand = rng.integers(0, int(p), size=(t, m // k, d)).astype(np.int64)
        chunks = np.concatenate([chunks, rand], axis=0)
    alpha_s, beta_s = _lcc_points(n, k, t, p)
    U = gen_lagrange_coeffs(alpha_s, beta_s, p)  # [n, k+t]
    flat = chunks.reshape(k + t, -1)
    enc = mod_matmul(U, flat, p)
    return enc.reshape(n, m // k, d)


def lcc_decode(f_eval, n: int, k: int, t: int, worker_idx, p=P_DEFAULT):
    """Decode chunk evaluations back to the k data chunks from a subset of
    workers (reference ``LCC_decoding``, ``mpc_function.py:195-215``)."""
    f_eval = _mod(np.asarray(f_eval, np.int64), p)
    if len(np.asarray(worker_idx)) < k + t:
        raise ValueError(
            f"LCC decode needs >= {k + t} evaluations, got"
            f" {len(np.asarray(worker_idx))}"
        )
    alpha_s, _ = _lcc_points(n, k, t, p)
    # decode targets the K data points only (reference n_beta = K)
    n_beta = k
    stt_b = -(n_beta // 2)
    beta_s = _mod(np.arange(stt_b, stt_b + n_beta, dtype=np.int64), p)
    alpha_eval = alpha_s[np.asarray(worker_idx)]
    U_dec = gen_lagrange_coeffs(beta_s, alpha_eval, p)  # [k, R]
    flat = f_eval.reshape(len(worker_idx), -1)
    out = mod_matmul(U_dec, flat, p)
    return out.reshape((k,) + f_eval.shape[1:])


def lcc_encode_with_points(x, alpha_s, beta_s, p=P_DEFAULT):
    """(reference ``LCC_encoding_with_points``, ``mpc_function.py:228-248``)"""
    U = gen_lagrange_coeffs(beta_s, alpha_s, p)
    return mod_matmul(U, np.asarray(x, np.int64), p)


def lcc_decode_with_points(f_eval, eval_points, target_points, p=P_DEFAULT):
    """(reference ``LCC_decoding_with_points``, ``mpc_function.py:251-262``)"""
    U_dec = gen_lagrange_coeffs(target_points, eval_points, p)
    return mod_matmul(U_dec, np.asarray(f_eval, np.int64), p)


def additive_shares(x, n: int, p=P_DEFAULT, rng=None) -> np.ndarray:
    """n shares summing to x mod p (reference ``Gen_Additive_SS``,
    ``mpc_function.py:218-226``)."""
    rng = rng or np.random.default_rng()
    x = _mod(np.asarray(x, np.int64), p)
    shares = rng.integers(0, int(p), size=(n - 1,) + x.shape).astype(np.int64)
    last = _mod(x - np.sum(_mod(shares, p), axis=0), p)
    return np.concatenate([shares, last[None]], axis=0)


# ---------------------------------------------------------------------------
# Fixed-point field quantization
# ---------------------------------------------------------------------------


def quantize(v: np.ndarray, scale_bits: int, p=P_DEFAULT) -> np.ndarray:
    """Float -> field: round(v * 2^q), negatives mapped to p + v (two's
    complement style centered lift; reference TA trainer
    ``transform_tensor_to_finite`` semantics)."""
    scaled = np.round(np.asarray(v, np.float64) * (1 << scale_bits))
    return _mod(scaled.astype(np.int64), p)


def dequantize(x: np.ndarray, scale_bits: int, p=P_DEFAULT) -> np.ndarray:
    """Field -> float with centered lift: values > p/2 are negative."""
    x = np.asarray(x, np.int64)
    centered = np.where(x > int(p) // 2, x - int(p), x)
    return centered.astype(np.float64) / (1 << scale_bits)


# ---------------------------------------------------------------------------
# TurboAggregate-style secure aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SecureAggregator:
    """Dropout-tolerant exact secure summation of client update vectors.

    Protocol (TurboAggregate, ``TA_Trainer.py`` / ``TA_decentralized_worker``):
    every client quantizes its update, splits it into additive shares (one
    per peer), and LCC/Shamir-encodes its share vector so the server can
    reconstruct the SUM from any ``t+1``-of-``n`` surviving clients while a
    coalition of <= ``t`` learns nothing about an individual update.

    In this in-process engine the share routing is a matrix transpose.
    The recovered sum is EXACT (integer
    arithmetic), so secure-agg FedAvg equals plain FedAvg up to
    quantization (2^-scale_bits).
    """

    num_clients: int
    threshold: int  # max colluding / minimum surviving redundancy t
    scale_bits: int = 16
    p: np.int64 = P_DEFAULT
    seed: int = 0

    def __post_init__(self):
        # ONE generator for the aggregator's lifetime: re-seeding per call
        # would repeat the Shamir masking polynomials across rounds, letting
        # a single share-holder difference two rounds' shares and recover a
        # client's update delta.
        self._rng = np.random.default_rng(self.seed)

    def aggregate(
        self, updates: np.ndarray, dropped: list[int] | None = None
    ) -> np.ndarray:
        """``updates``: [n, d] float client vectors. Returns their exact sum
        (float), reconstructable as long as the surviving set has at least
        ``threshold + 1`` clients."""
        n, d = updates.shape
        assert n == self.num_clients
        dropped = set(dropped or [])
        survivors = [i for i in range(n) if i not in dropped]
        if len(survivors) < self.threshold + 1:
            raise ValueError(
                f"need >= {self.threshold + 1} survivors, have"
                f" {len(survivors)}"
            )
        rng = self._rng

        # 0. runtime envelope guard: the field must hold the SUM of n
        #    quantized updates with the centered lift, i.e.
        #    n * (max|v| * 2^q + 1/2) < p / 2 (the +1/2 per element is
        #    round()'s worst case). A larger delta would silently wrap
        #    mod p and dequantize to garbage — fail loudly instead.
        max_abs = float(np.max(np.abs(updates))) if updates.size else 0.0
        bound = (int(self.p) / 2.0 - n / 2.0) / (
            n * (1 << self.scale_bits)
        )
        if max_abs >= bound:
            raise ValueError(
                f"secure-aggregation overflow: max|update| = {max_abs:.4g}"
                f" >= field envelope {bound:.4g} "
                f"(p={self.p}, scale_bits={self.scale_bits}, n={n}); "
                "lower scale_bits, clip the updates, or use a larger "
                "prime"
            )

        # 1. quantize
        q = np.stack([quantize(updates[i], self.scale_bits, self.p)
                      for i in range(n)])

        # 2. each client Shamir-shares its vector to all peers
        #    shares[i, j] = share of client i's vector held by client j
        shares = np.stack([
            bgw_encode(q[i], n, self.threshold, self.p, rng)
            for i in range(n)
        ])  # [n, n, d]

        # 3. surviving clients locally sum the shares they hold — the sum
        #    of shares IS a share of the sum (linearity)
        held = [
            _mod(np.sum(shares[:, j, :], axis=0), self.p) for j in survivors
        ]

        # 4. server reconstructs the sum from the survivors' aggregate
        #    shares
        total_field = bgw_decode(
            np.stack(held), np.asarray(survivors), self.p, t=self.threshold
        )
        return dequantize(total_field, self.scale_bits, self.p)

    def aggregate_mean(
        self, updates: np.ndarray, dropped: list[int] | None = None
    ) -> np.ndarray:
        """Mean over ALL clients: ``dropped`` models clients that fail
        AFTER the sharing phase (the dropout the protocol tolerates), so
        every update still contributes to the reconstructed sum."""
        return self.aggregate(updates, dropped) / self.num_clients


class SecureFedAvgSim:
    """TurboAggregate FedAvg: the local updates of
    :class:`~fedml_tpu_torch.algorithms.fedavg.FedAvgSim` (its own
    ``_locals``, cohort and batch orders included) with
    :class:`SecureAggregator` as the server's rule. ``run_round(state,
    round_idx=None, *, dropped=None)``: ``dropped`` models clients that
    fail after the sharing phase; their updates still reach the
    reconstructed sum, the dropout the protocol tolerates. The secure
    round equals the plain round up to the quantization, ``2^-scale_bits``
    a coordinate. ``last_field_s`` is the last round's host seconds of
    the field pass (the copy to the host, the secure sum and the copy
    back)."""

    def __init__(self, model, data, cfg, device="cuda",
                 threshold: int | None = None, scale_bits: int = 16):
        # the secure sum gives only the weighted-mean update, so server
        # optimizers, momentum and the defenses cannot apply: refuse them
        f = cfg.fed
        unsupported = {
            "server_optimizer != 'sgd'": f.server_optimizer != "sgd",
            "server_lr != 1.0": f.server_lr != 1.0,
            "server_momentum": f.server_momentum != 0,
            "gmf": f.gmf != 0,
            "robust_method": f.robust_method not in (None, "", "mean"),
            "robust_norm_clip": f.robust_norm_clip > 0,
            "robust_noise_stddev": f.robust_noise_stddev > 0,
            "fednova": f.algorithm == "fednova",
            # the sum covers the full variables; PEFT's pruned updates
            # would not line up with it
            "peft": getattr(f, "peft", "none") not in (None, "", "none"),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(
                "secure aggregation (turboaggregate) computes a plain "
                "weighted-mean update; unsupported settings: "
                + ", ".join(bad))
        self.cfg = cfg
        self.inner = FedAvgSim(model, data, cfg, device)
        self.device = self.inner.device
        self.counters = self.inner.counters
        cohort = min(cfg.fed.clients_per_round, cfg.data.num_clients)
        self.secure = SecureAggregator(
            num_clients=cohort,
            threshold=cohort // 2 if threshold is None else threshold,
            scale_bits=scale_bits, seed=cfg.seed)
        self.last_field_s = 0.0

    def init(self):
        return self.inner.init()

    def run_round(self, state, round_idx=None, *,
                  dropped: list[int] | None = None):
        """One secure round. ``round_idx`` is accepted for the harness's
        ``run_round(state, r)`` and ignored (the state counts rounds)."""
        stacked, n_k, sums = self.inner._locals(state)
        gv = state.variables
        names = list(gv)
        # weighted by n_k / sum n_k before quantizing: the secure sum is
        # the weighted mean, and the field never sees n_k-scaled values
        w = n_k.double() / torch.clamp(n_k.double().sum(), min=1.0)
        cohort = w.shape[0]
        deltas = torch.cat([
            (stacked[k].double() - gv[k].double()[None]).reshape(cohort, -1)
            for k in names], dim=1) * w[:, None]
        if self.device.type == "cuda":
            # the field pass's seconds start after the local updates
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        updates = deltas.cpu().numpy()  # the round's one copy to the host
        avg = torch.from_numpy(self.secure.aggregate(updates, dropped))
        avg = avg.to(self.device, non_blocking=False)
        self.last_field_s = time.perf_counter() - t0
        new_vars, off = {}, 0
        for k in names:
            n = gv[k].numel()
            new_vars[k] = (gv[k].double() + avg[off:off + n].reshape(
                gv[k].shape)).to(gv[k].dtype)
            off += n
        fin = finalize_sums({k: v.sum() for k, v in sums.items()})
        return state._replace(variables=new_vars, round=state.round + 1), {
            "train_loss": fin["loss"], "train_acc": fin["acc"]}

    def evaluate_global(self, state) -> dict:
        return self.inner.evaluate_global(state)
