"""Precomputed-kernel SVC inference as dense JAX math.

Re-implements the predict path of the reference's classifier
(reference: warpdemux/models/dtw_svm.py:54-98 — sklearn
SVC(kernel='precomputed', probability=True).predict_proba) as pure array ops:

- kernel: K = exp(-gamma * D**pwr_dist) over DTW distances
  (models/dtw_svm.py:21-22)
- one-vs-one decision values: a single (B, n_SV) x (n_SV, n_pairs) matmul with
  a coefficient matrix assembled at model-import time from libsvm dual
  coefficients, at full float32 precision (Precision.HIGHEST: no TF32).
- pairwise probabilities: libsvm's `sigmoid_predict` Platt calibration with
  the 1e-7 clamp.
- multiclass coupling: libsvm's `multiclass_probability` (Wu & Lin method 2),
  the exact Gauss-Seidel update with eps = 0.005/k and max(100, k) iterations,
  vectorized over the batch with per-sample convergence freezing so results
  match a sample-at-a-time solve.

Everything here is jit-compatible with static shapes; float64 mode gives
bitwise-faithful libsvm semantics for parity tests, float32 is the device path.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SVMParams(NamedTuple):
    """Arrays fully describing a trained one-vs-one probability SVC.

    n_sv support vectors, k classes, P = k*(k-1)/2 class pairs.
    """

    coef: jnp.ndarray  # (n_sv, P) per-pair dual coefficients
    intercept: jnp.ndarray  # (P,)
    probA: jnp.ndarray  # (P,) Platt slope
    probB: jnp.ndarray  # (P,) Platt offset
    n_classes: int


def pair_index(k: int) -> list[tuple[int, int]]:
    """libsvm pair enumeration order: (0,1), (0,2), ..., (k-2,k-1)."""
    return [(i, j) for i in range(k) for j in range(i + 1, k)]


def build_pair_coef(
    dual_coef: np.ndarray, n_support: np.ndarray
) -> np.ndarray:
    """Assemble the (n_sv, P) per-pair coefficient matrix.

    libsvm stores dual_coef as (k-1, n_sv): row r of class-c's SV block holds
    the coefficient of that SV in its pairing against the r'th *other* class.
    For pair p=(i, j): SVs of class i contribute dual_coef[j-1], SVs of class
    j contribute dual_coef[i].
    """
    k = len(n_support)
    n_sv = int(np.sum(n_support))
    starts = np.concatenate([[0], np.cumsum(n_support)]).astype(int)
    pairs = pair_index(k)
    C = np.zeros((n_sv, len(pairs)), dual_coef.dtype)
    for p, (i, j) in enumerate(pairs):
        si, ei = starts[i], starts[i + 1]
        sj, ej = starts[j], starts[j + 1]
        C[si:ei, p] = dual_coef[j - 1, si:ei]
        C[sj:ej, p] = dual_coef[i, sj:ej]
    return C


def decision_values(K_sv: jnp.ndarray, params: SVMParams) -> jnp.ndarray:
    """(B, P) one-vs-one decision values from the kernel vs support vectors."""
    return (
        jnp.dot(
            K_sv,
            params.coef.astype(K_sv.dtype),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=K_sv.dtype,
        )
        + params.intercept.astype(K_sv.dtype)
    )


def sigmoid_predict(dec: jnp.ndarray, A: jnp.ndarray, B: jnp.ndarray):
    """libsvm sigmoid_predict: numerically-stable 1/(1+exp(dec*A+B))."""
    fApB = dec * A + B
    pos = fApB >= 0
    efa = jnp.exp(-jnp.abs(fApB))
    return jnp.where(pos, efa / (1.0 + efa), 1.0 / (1.0 + efa))


def multiclass_probability(r: jnp.ndarray, k: int) -> jnp.ndarray:
    """libsvm multiclass_probability (Wu & Lin 2004, method 2), batched.

    Args:
      r: (B, k, k) pairwise probabilities, r[b, i, j] = P(i | i or j, x_b),
         diagonal unused.
    Returns:
      (B, k) class probabilities.
    """
    B = r.shape[0]
    dtype = r.dtype
    max_iter = max(100, k)
    eps = 0.005 / k

    # Q[t][t] = sum_{j != t} r[j][t]^2 ; Q[t][j] = -r[j][t] * r[t][j]
    rT = jnp.swapaxes(r, 1, 2)
    eye = jnp.eye(k, dtype=dtype)
    off = (-rT * r) * (1 - eye)[None]
    diag = jnp.sum((rT * rT) * (1 - eye)[None], axis=2)  # (B, k)
    Q = off + jnp.einsum(
        "bk,kj->bkj", diag, eye, precision=jax.lax.Precision.HIGHEST
    )

    p0 = jnp.full((B, k), 1.0 / k, dtype)

    def compute_stats(p):
        # libsvm recomputes Qp/pQp from scratch at each loop head
        # "for numerical accuracy".
        Qp = jnp.einsum(
            "bkj,bj->bk", Q, p, precision=jax.lax.Precision.HIGHEST
        )
        pQp = jnp.sum(p * Qp, axis=1)
        max_err = jnp.max(jnp.abs(Qp - pQp[:, None]), axis=1)
        return Qp, pQp, max_err

    def gauss_seidel_pass(p, Qp, pQp, active):
        # Sequential over t; Qp/pQp updated incrementally like libsvm.
        def body(t, carry):
            p, Qp, pQp = carry
            diff = (-Qp[:, t] + pQp) / Q[:, t, t]
            diff = jnp.where(active, diff, 0.0)  # freeze converged samples
            p = p.at[:, t].add(diff)
            pQp = (pQp + diff * (diff * Q[:, t, t] + 2.0 * Qp[:, t])) / (
                (1.0 + diff) * (1.0 + diff)
            )
            Qp = (Qp + diff[:, None] * Q[:, t, :]) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
            return p, Qp, pQp

        p, Qp, pQp = jax.lax.fori_loop(0, k, body, (p, Qp, pQp))
        return p

    def cond(state):
        p, it = state
        _, _, max_err = compute_stats(p)
        return (it < max_iter) & jnp.any(max_err >= eps)

    def while_body(state):
        p, it = state
        Qp, pQp, max_err = compute_stats(p)
        p = gauss_seidel_pass(p, Qp, pQp, max_err >= eps)
        return p, it + 1

    p, _ = jax.lax.while_loop(cond, while_body, (p0, jnp.int32(0)))
    return p


def predict_proba(
    K_sv: jnp.ndarray, params: SVMParams, min_prob: float = 1e-7
) -> jnp.ndarray:
    """libsvm svm_predict_probability over a batch of kernel rows.

    Args:
      K_sv: (B, n_sv) kernel values against the support vectors.
    Returns:
      (B, k) probabilities in classes_ order.
    """
    k = params.n_classes
    dec = decision_values(K_sv, params)  # (B, P)
    dtype = dec.dtype
    rp = sigmoid_predict(
        dec, params.probA.astype(dtype), params.probB.astype(dtype)
    )
    rp = jnp.clip(rp, min_prob, 1.0 - min_prob)
    pairs = pair_index(k)
    iidx = jnp.array([i for i, _ in pairs])
    jidx = jnp.array([j for _, j in pairs])
    B = K_sv.shape[0]
    r = jnp.zeros((B, k, k), dtype)
    r = r.at[:, iidx, jidx].set(rp)
    r = r.at[:, jidx, iidx].set(1.0 - rp)
    return multiclass_probability(r, k)


def pdist_kernel(
    D: jnp.ndarray, gamma: float = 1.0, pwr_dist: int = 1
) -> jnp.ndarray:
    """K = exp(-gamma * D**pwr_dist) (reference models/dtw_svm.py:21-22)."""
    Dp = D if pwr_dist == 1 else D**pwr_dist
    return jnp.exp(-gamma * Dp)


def confidence_margin(probs: jnp.ndarray) -> jnp.ndarray:
    """top1 - top2 probability (reference models/utils.py:19-23)."""
    top2 = jax.lax.top_k(probs, 2)[0]
    return top2[..., 0] - top2[..., 1]


def process_probs(
    probs: jnp.ndarray,
    label_map: jnp.ndarray,
    thresholds: jnp.ndarray | None,
):
    """argmax -> label map -> threshold-to-noise (-1)
    (reference models/utils.py:45-61).

    Returns (pred labels (B,) int32, conf (B,)).
    """
    pred_idx = jnp.argmax(probs, axis=1)
    pred = label_map[pred_idx]
    conf = confidence_margin(probs)
    if thresholds is not None:
        pred = jnp.where(
            conf < thresholds.astype(probs.dtype)[pred_idx], -1, pred
        )
    return pred.astype(jnp.int32), conf
