"""Batched DTW + precomputed-kernel SVM predictor.

The batched equivalent of the reference's DTW_SVM.predict
(warpdemux/models/dtw_svm.py:54-98): one jitted device function computes
DTW distances (the fused kernel of ops/dtw_triton.py), the exp kernel,
one-vs-one decision values (one matmul), Platt + Wu-Lin probabilities, and
argmax/margin/threshold post-processing for a whole minibatch at once.

The reference parallelizes the distance matrix over a process pool
(parallel_distances.py:139-198); here the whole batch is a single device
launch and scaling happens across chips via the runtime mesh instead.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from warpdemux_tpu.ops import svm as svm_ops
from warpdemux_tpu.ops.dtw import dtw_distance_matrix
from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_kernel


@dataclass(frozen=True)
class DTWSVMModel:
    """Immutable inference bundle; arrays live on device after first use."""

    name: str
    X_sv: jnp.ndarray  # (n_sv, m) support-vector fingerprints
    params: svm_ops.SVMParams
    label_map: jnp.ndarray  # (k,) int32
    thresholds: jnp.ndarray  # (k,)
    classes: np.ndarray
    window: int
    penalty: float
    gamma: float
    pwr_dist: int
    noise_class: bool

    @classmethod
    def from_arrays(cls, arrays: dict, name: str = "", dtype=np.float32):
        use64 = dtype == np.float64
        X = arrays["X_sv_f64" if use64 and "X_sv_f64" in arrays else "X_sv"]
        coef = svm_ops.build_pair_coef(
            arrays["dual_coef"], arrays["n_support"]
        )
        params = svm_ops.SVMParams(
            coef=jnp.asarray(coef, dtype),
            intercept=jnp.asarray(arrays["intercept"], dtype),
            probA=jnp.asarray(arrays["probA"], dtype),
            probB=jnp.asarray(arrays["probB"], dtype),
            n_classes=int(arrays["n_classes"]),
        )
        return cls(
            name=name,
            X_sv=jnp.asarray(X, dtype),
            params=params,
            label_map=jnp.asarray(arrays["label_map"], jnp.int32),
            thresholds=jnp.asarray(arrays["thresholds"], dtype),
            classes=np.asarray(arrays["classes"]),
            window=int(arrays["window"]),
            penalty=float(arrays["penalty"]),
            gamma=float(arrays["gamma"]),
            pwr_dist=int(arrays["pwr_dist"]),
            noise_class=bool(arrays["noise_class"]),
        )

    @property
    def n_classes(self) -> int:
        return self.params.n_classes

    @property
    def fingerprint_len(self) -> int:
        return int(self.X_sv.shape[1])

    def predict_fn(self):
        """A jittable (fpts (B, m)) -> (pred, conf, probs) function.

        Model arrays are closed over (weight replication happens at the
        runtime-mesh level); `n_classes` and DTW hyperparameters stay static.
        """
        window, penalty = self.window, self.penalty
        gamma, pwr = self.gamma, self.pwr_dist
        X_sv, params = self.X_sv, self.params
        label_map, thresholds = self.label_map, self.thresholds

        # float64 bundles are the sklearn-parity mode: keep their DTW in
        # float64 (the fused kernel computes in float32)
        dtw = (
            dtw_distance_matrix
            if X_sv.dtype == jnp.float64
            else dtw_distance_matrix_kernel
        )

        def fn(fpts):
            D = dtw(fpts, X_sv, window, penalty)
            K = svm_ops.pdist_kernel(D, gamma, pwr)
            probs = svm_ops.predict_proba(K, params)
            pred, conf = svm_ops.process_probs(probs, label_map, thresholds)
            return pred, conf, probs

        return fn

    @functools.cached_property
    def _jitted(self):
        return jax.jit(self.predict_fn())

    def predict(self, fpts) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Classify fingerprints; returns (pred_labels, confidence, probs)."""
        fpts = jnp.asarray(fpts, self.X_sv.dtype)
        if fpts.ndim == 1:
            fpts = fpts[None]
        pred, conf, probs = self._jitted(fpts)
        return np.asarray(pred), np.asarray(conf), np.asarray(probs)

    def predictions_to_df(self, read_ids, pred, conf, probs):
        """Build the reference's prediction table
        (models/utils.py:36-43: predicted_barcode, confidence_score, p{label:02d})
        as an io.writers Frame."""
        label_map = np.asarray(self.label_map)
        cols = {
            "#read_id": np.asarray(read_ids, object),
            "predicted_barcode": pred,
            "confidence_score": np.round(conf, 3),
        }
        for i in range(probs.shape[1]):
            cols[f"p{label_map[i]:02d}"] = np.round(probs[:, i], 4)
        return cols
