"""Fingerprint -> gradient-boosted-trees predictor (the Fpt_Boost family).

The reference classifies fingerprints directly with catboost
(warpdemux/models/fpt_boost.py:12-50: model.predict_proba(X,
thread_count=1) -> process_probs; base class fpt_base.py:11-83). No
reference model file ships with it (the tRNA joblibs are missing blobs
upstream), but the family is part of the public model surface.

Catboost multiclass models are ensembles of *oblivious* (symmetric)
decision trees: every level of a tree tests one (feature, threshold) pair,
so a depth-d tree is d split conditions and 2^d leaf-value vectors, and a
sample's leaf index is the d-bit word of split outcomes. That structure is
ideal for an accelerator: for a (B, m) fingerprint batch and T trees of depth d,
the whole forest evaluates as

    bits  = x[:, feat] > thr            (B, T, d) elementwise compares
    leaf  = sum_j bits[..., j] << j     (B, T) integer leaf codes
    score = sum_t leaves[t, leaf_t]     (B, k) two gathers + reduction
    probs = softmax(score)              (catboost multiclass link)

with no per-tree host loops. Arrays live in an npz bundle:
feat (T, d) int32, thr (T, d) f32, leaf_values (T, 2^d, k) f32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from warpdemux_tpu.ops import svm as svm_ops


def oblivious_forest_scores(
    x: jnp.ndarray,  # (B, m)
    feat: jnp.ndarray,  # (T, d) int32
    thr: jnp.ndarray,  # (T, d)
    leaf_values: jnp.ndarray,  # (T, 2^d, k)
) -> jnp.ndarray:
    """Raw class scores of an oblivious-tree ensemble; (B, k)."""
    T, d = feat.shape
    xv = x[:, feat.reshape(-1)].reshape(x.shape[0], T, d)  # (B, T, d)
    bits = (xv > thr[None, :, :]).astype(jnp.int32)
    weights = (2 ** jnp.arange(d, dtype=jnp.int32))[None, None, :]
    leaf_idx = jnp.sum(bits * weights, axis=-1)  # (B, T)
    # gather leaf vectors: (B, T, k) then sum over trees
    vals = jnp.take_along_axis(
        leaf_values[None, :, :, :],
        leaf_idx[:, :, None, None].astype(jnp.int32),
        axis=2,
    )[:, :, 0, :]
    return jnp.sum(vals, axis=1)


@dataclass(frozen=True)
class FptBoostModel:
    """Immutable inference bundle for the fingerprint-GBT family."""

    name: str
    feat: jnp.ndarray  # (T, d) int32
    thr: jnp.ndarray  # (T, d)
    leaf_values: jnp.ndarray  # (T, 2^d, k)
    bias: jnp.ndarray  # (k,) score offset (catboost scale/bias)
    label_map: jnp.ndarray  # (k,) int32
    thresholds: jnp.ndarray  # (k,)
    fingerprint_len: int
    noise_class: bool

    @classmethod
    def from_arrays(cls, arrays: dict, name: str = "", dtype=np.float32):
        leaf = jnp.asarray(arrays["leaf_values"], dtype)
        k = leaf.shape[-1]
        return cls(
            name=name,
            feat=jnp.asarray(arrays["feat"], jnp.int32),
            thr=jnp.asarray(arrays["thr"], dtype),
            leaf_values=leaf,
            bias=jnp.asarray(
                arrays.get("bias", np.zeros(k, np.float32)), dtype
            ),
            label_map=jnp.asarray(arrays["label_map"], jnp.int32),
            thresholds=jnp.asarray(arrays["thresholds"], dtype),
            fingerprint_len=int(arrays["fingerprint_len"]),
            noise_class=bool(arrays.get("noise_class", True)),
        )

    @property
    def n_classes(self) -> int:
        return int(self.leaf_values.shape[-1])

    def predict_fn(self):
        feat, thr, leaf = self.feat, self.thr, self.leaf_values
        bias = self.bias
        label_map, thresholds = self.label_map, self.thresholds

        def fn(fpts):
            scores = oblivious_forest_scores(fpts, feat, thr, leaf) + bias
            probs = jax.nn.softmax(scores, axis=-1)
            pred, conf = svm_ops.process_probs(probs, label_map, thresholds)
            return pred, conf, probs

        return fn

    @functools.cached_property
    def _jitted(self):
        return jax.jit(self.predict_fn())

    def predict(self, fpts):
        fpts = jnp.asarray(fpts, self.thr.dtype)
        if fpts.ndim == 1:
            fpts = fpts[None]
        pred, conf, probs = self._jitted(fpts)
        return np.asarray(pred), np.asarray(conf), np.asarray(probs)


from warpdemux_tpu.models.dtw_svm import DTWSVMModel  # noqa: E402

FptBoostModel.predictions_to_df = DTWSVMModel.predictions_to_df
