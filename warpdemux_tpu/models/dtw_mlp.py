"""Batched DTW + MLP predictor (the reference's DTW_MLP family).

The reference feeds the raw DTW distance matrix into an sklearn
MLPClassifier pipeline (warpdemux/models/dtw_mlp.py:44-93: D =
distance_matrix_to(X, _X) -> model.predict_proba(D) -> process_probs).
No shipped reference model uses it, but the family is part of the public
model surface; here it is a jitted chain: DTW distances -> (optional
standard scaling) -> dense relu MLP -> softmax -> argmax/margin/threshold
post-processing, with weights imported from npz array bundles.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from warpdemux_tpu.ops import svm as svm_ops
from warpdemux_tpu.ops.dtw import dtw_distance_matrix


def mlp_predict_proba(
    D: jnp.ndarray,
    weights: tuple,
    biases: tuple,
    scaler_mean: jnp.ndarray | None,
    scaler_scale: jnp.ndarray | None,
) -> jnp.ndarray:
    """sklearn MLPClassifier.predict_proba semantics: relu hidden layers,
    softmax output (binary models use a sigmoid; k >= 2 here)."""
    h = D
    if scaler_mean is not None:
        h = (h - scaler_mean[None, :]) / scaler_scale[None, :]
    n = len(weights)
    for i, (W, b) in enumerate(zip(weights, biases)):
        h = jnp.matmul(h, W, precision=jax.lax.Precision.HIGHEST) + b[None, :]
        if i < n - 1:
            h = jax.nn.relu(h)
    return jax.nn.softmax(h, axis=-1)


@dataclass(frozen=True)
class DTWMLPModel:
    """Immutable inference bundle for the DTW->MLP model family."""

    name: str
    X_ref: jnp.ndarray  # (n_ref, m) reference fingerprints
    weights: tuple  # ((in, h1), (h1, h2), ..., (hN, k))
    biases: tuple
    scaler_mean: jnp.ndarray | None
    scaler_scale: jnp.ndarray | None
    label_map: jnp.ndarray  # (k,) int32
    thresholds: jnp.ndarray  # (k,)
    window: int
    penalty: float
    noise_class: bool

    @classmethod
    def from_arrays(cls, arrays: dict, name: str = "", dtype=np.float32):
        n_layers = int(arrays["n_layers"])
        weights = tuple(
            jnp.asarray(arrays[f"mlp_w{i}"], dtype) for i in range(n_layers)
        )
        biases = tuple(
            jnp.asarray(arrays[f"mlp_b{i}"], dtype) for i in range(n_layers)
        )
        sm = arrays.get("scaler_mean")
        ss = arrays.get("scaler_scale")
        return cls(
            name=name,
            X_ref=jnp.asarray(arrays["X_sv"], dtype),
            weights=weights,
            biases=biases,
            scaler_mean=None if sm is None else jnp.asarray(sm, dtype),
            scaler_scale=None if ss is None else jnp.asarray(ss, dtype),
            label_map=jnp.asarray(arrays["label_map"], jnp.int32),
            thresholds=jnp.asarray(arrays["thresholds"], dtype),
            window=int(arrays["window"]),
            penalty=float(arrays["penalty"]),
            noise_class=bool(arrays.get("noise_class", True)),
        )

    @property
    def n_classes(self) -> int:
        return int(self.weights[-1].shape[1])

    @property
    def fingerprint_len(self) -> int:
        return int(self.X_ref.shape[1])

    def predict_fn(self):
        window, penalty = self.window, self.penalty
        X_ref = self.X_ref
        weights, biases = self.weights, self.biases
        sm, ss = self.scaler_mean, self.scaler_scale
        label_map, thresholds = self.label_map, self.thresholds

        def fn(fpts):
            D = dtw_distance_matrix(fpts, X_ref, window, penalty)
            probs = mlp_predict_proba(D, weights, biases, sm, ss)
            pred, conf = svm_ops.process_probs(probs, label_map, thresholds)
            return pred, conf, probs

        return fn

    @functools.cached_property
    def _jitted(self):
        return jax.jit(self.predict_fn())

    def predict(self, fpts):
        fpts = jnp.asarray(fpts, self.X_ref.dtype)
        if fpts.ndim == 1:
            fpts = fpts[None]
        pred, conf, probs = self._jitted(fpts)
        return np.asarray(pred), np.asarray(conf), np.asarray(probs)

    predictions_to_df = None  # set below (shared implementation)


from warpdemux_tpu.models.dtw_svm import DTWSVMModel  # noqa: E402

DTWMLPModel.predictions_to_df = DTWSVMModel.predictions_to_df
