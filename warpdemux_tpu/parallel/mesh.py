"""Multi-chip data parallelism over a jax.sharding.Mesh.

The reference's only scaling axis is data parallelism over reads (a process
pool, file_proc.py:1197-1245, "scales linearly with number of cores"); the
equivalent here shards read minibatches across a flat 1-D device mesh:

- minibatch tensors (B, L) are sharded along the batch axis ("data"),
- model arrays (support-vector fingerprints, dual coefficients, thresholds)
  are replicated — the analog of the reference pickling the model into every
  pool worker (file_proc.py:1232-1243),
- per-class read counters are reduced with a psum over the mesh — the analog
  of the reference's Manager-lock shared counters (file_proc.py:45-105),

all expressed with NamedSharding + shard_map so XLA inserts the
collectives (NCCL on GPUs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def class_counts_psum(pred: jnp.ndarray, label_map: jnp.ndarray, axis_name: str):
    """Per-label prediction counts, globally reduced over the mesh.

    pred: (B_local,) int32 barcode labels (label_map values; -1 = noise,
    -2 = failed read). Returns (k + 1,) counts: one slot per label_map entry
    (noise included as its -1 entry) plus a trailing failed-read slot.
    """
    slots = jnp.concatenate([label_map, jnp.array([-2], label_map.dtype)])
    local = jnp.sum(
        (pred[:, None] == slots[None, :]).astype(jnp.int32), axis=0
    )
    return jax.lax.psum(local, axis_name)


def make_sharded_demux_step(model, spc, mesh: Mesh, axis_name: str = "data"):
    """Build a mesh-sharded (signals, in_lens) -> (pred, conf, counts) step.

    The per-shard compute is the same fused chain as pipeline/step.py; batch
    inputs/outputs are sharded over `axis_name`, model arrays replicated, and
    the class-count statistics come back via an all-reduce (psum).
    """
    shard_map = jax.shard_map

    from warpdemux_tpu.detect.boundaries import detect_boundaries_with_fallback
    from warpdemux_tpu.ops.fingerprint import fingerprints_from_boundaries
    from warpdemux_tpu.ops import svm as svm_ops
    from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_kernel

    dcfg, fcfg = spc.detect, spc.fingerprint
    cnn_params = {}
    if dcfg.method == "cnn":
        from warpdemux_tpu.detect import cnn as cnn_mod

        cnn_params = cnn_mod.load_params(spc.cnn_model_name)
    X_sv, params = model.X_sv, model.params
    label_map, thresholds = model.label_map, model.thresholds
    gamma, pwr = model.gamma, model.pwr_dist
    window, penalty = model.window, model.penalty
    k = model.n_classes

    def local_step(signals, in_lens, X_sv, coef, intercept, probA, probB,
                   label_map, thresholds, cnn_params):
        det = detect_boundaries_with_fallback(
            signals, in_lens, dcfg, cnn_params or None
        )
        fpt = fingerprints_from_boundaries(
            signals, in_lens, det.adapter_start, det.adapter_end, fcfg
        )
        success = det.success & fpt.ok
        fpts_safe = jnp.where(success[:, None], fpt.fpt, 0.0).astype(
            jnp.float32
        )
        D = dtw_distance_matrix_kernel(fpts_safe, X_sv, window, penalty)
        K = svm_ops.pdist_kernel(D, gamma, pwr)
        p = svm_ops.SVMParams(coef, intercept, probA, probB, k)
        probs = svm_ops.predict_proba(K, p)
        pred, conf = svm_ops.process_probs(probs, label_map, thresholds)
        pred = jnp.where(success, pred, -2)  # -2: failed reads
        counts = class_counts_psum(pred, label_map, axis_name)
        return pred, conf, success, counts

    batch_spec = P(axis_name)
    rep = P()
    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P(axis_name, None),  # signals
            batch_spec,  # in_lens
            rep, rep, rep, rep, rep, rep, rep,  # replicated model arrays
            rep,  # replicated CNN weights (empty dict for llr/start_peak)
        ),
        out_specs=(batch_spec, batch_spec, batch_spec, rep),
        check_vma=False,
    )

    @jax.jit
    def step(signals, in_lens):
        return sharded(
            signals,
            in_lens,
            X_sv,
            params.coef,
            params.intercept,
            params.probA,
            params.probB,
            label_map,
            thresholds,
            cnn_params,
        )

    return step
