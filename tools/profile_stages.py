"""Per-stage device timing of the demux step (VERDICT r1 item 1a).

Times each jitted sub-stage with device-resident inputs on the default
backend, plus fine-grained sub-ops of the fingerprint stage. Prints a
markdown table (committed to STATUS.md).

Usage: python tools/profile_stages.py [B]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from warpdemux_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

from bench import synth_minibatch, synth_minibatch_vbz, ADC_SCALE, ADC_OFFSET
from warpdemux_tpu.config.utils import get_model_spc_config
from warpdemux_tpu.models.registry import load_model
from warpdemux_tpu.detect.boundaries import detect_boundaries_with_fallback
from warpdemux_tpu.ops.fingerprint import fingerprints_from_boundaries
from warpdemux_tpu.ops import svm as svm_ops

B = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
L = 10000
REPS = 8

rng = np.random.default_rng(0)
model = load_model("WDX4_rna004_v1_0")
spc = get_model_spc_config("WDX4_rna004_v1_0")
dcfg, fcfg = spc.detect, spc.fingerprint

adc, offset, scale, lens = synth_minibatch(rng, B, L)
keys, data, voffset, vscale, vlens = synth_minibatch_vbz(rng, B, L)

signals = ((adc.astype(np.float32) + offset[:, None]) * scale[:, None])
d_signals = jax.device_put(signals)
d_lens = jax.device_put(lens.astype(np.int32))
d_keys = jax.device_put(keys)
d_data = jax.device_put(data)


def timeit(name, fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / REPS
    print(f"| {name} | {dt*1e3:8.2f} | {B/dt:10.0f} |")
    return out


print(f"# backend={jax.default_backend()} B={B} L={L} reps={REPS}")
print("| stage | ms/minibatch | reads/s |")
print("|---|---|---|")

# --- top-level stages
from warpdemux_tpu.ops.vbz_device import vbz_decode_batch

decode = jax.jit(lambda k, d: vbz_decode_batch(k, d, L).astype(jnp.int16))
timeit("vbz decode", decode, d_keys, d_data)

cnn_params = None
if dcfg.method == "cnn":
    from warpdemux_tpu.detect import cnn as cnn_mod

    cnn_params = cnn_mod.load_params(spc.cnn_model_name)

detect_fn = jax.jit(
    lambda s, n: detect_boundaries_with_fallback(s, n, dcfg, cnn_params)
)
det = timeit("detect", detect_fn, d_signals, d_lens)

fpt_fn = jax.jit(
    lambda s, n, a0, a1: fingerprints_from_boundaries(s, n, a0, a1, fcfg)
)
fpt = timeit(
    "fingerprint", fpt_fn, d_signals, d_lens, det.adapter_start,
    det.adapter_end,
)

from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_kernel as dtw_fn

X_sv = model.X_sv
dtw_j = jax.jit(
    lambda f: dtw_fn(f, X_sv, window=model.window, penalty=model.penalty)
)
fpts_safe = jnp.where(fpt.ok[:, None], fpt.fpt, 0.0).astype(jnp.float32)
fpts_safe = jax.device_put(np.asarray(fpts_safe))
D = timeit("dtw (B x 851)", dtw_j, fpts_safe)

params = model.params
svm_j = jax.jit(
    lambda D: svm_ops.predict_proba(
        svm_ops.pdist_kernel(D, model.gamma, model.pwr_dist), params
    )
)
timeit("svm proba", svm_j, D)

# --- fingerprint sub-ops
print("|---|---|---|")
from warpdemux_tpu.ops.fingerprint import extract_adapter_batch
from warpdemux_tpu.ops.normalize import clip_outliers
from warpdemux_tpu.ops.segmentation import windowed_t_test, segment_means
from warpdemux_tpu.ops.peaks import (
    peak_mask_batch,
    suppress_by_distance,
    select_top_peaks,
)

ext = jax.jit(
    lambda s, n, a0, a1: extract_adapter_batch(
        s, n, a0, a1, fcfg.padding, fcfg.buffer_len
    )
)
adapter, a_len = timeit(
    "  extract_adapter", ext, d_signals, d_lens, det.adapter_start,
    det.adapter_end,
)

amask = jnp.arange(adapter.shape[1])[None, :] < a_len[:, None]
clip = jax.jit(lambda a, m: clip_outliers(a, m, fcfg.sig_norm_outlier_thresh))
adapter_c = timeit("  clip_outliers", clip, adapter, amask)

nf = a_len.astype(jnp.float32)
w = jnp.maximum(
    jnp.minimum(
        fcfg.running_stat_width,
        jnp.round(nf / fcfg.num_events).astype(jnp.int32),
    ),
    1,
)
min_obs = jnp.maximum(
    jnp.minimum(
        fcfg.min_obs_per_base,
        jnp.round(nf / fcfg.num_events / 2.0).astype(jnp.int32),
    ),
    1,
)
wtt = jax.jit(
    lambda a, n, w: windowed_t_test(a, n, w, fcfg.running_stat_width)
)
scores, n_scores = timeit("  windowed_t_test", wtt, adapter_c, a_len, w)

pm = jax.jit(peak_mask_batch)
is_peak, _ = timeit("  peak_mask", pm, scores, n_scores)

sup = jax.jit(
    lambda s, p, d: suppress_by_distance(
        s, p, d, fcfg.min_obs_per_base + 1
    )
)
keep = timeit("  suppress_by_distance", sup, scores, is_peak, min_obs)

cnt = jnp.sum(keep, axis=1).astype(jnp.int32)
sel = jax.jit(
    lambda s, k, c: select_top_peaks(s, k, c, fcfg.num_events)
)
timeit("  select_top_peaks", sel, scores, keep, cnt)

segm = jax.jit(segment_means)
bounds = jnp.concatenate(
    [
        jnp.zeros((B, 1), jnp.int32),
        jnp.sort(
            jnp.where(keep, jnp.arange(scores.shape[1])[None, :], 0), axis=1
        )[:, -fcfg.num_events:],
        a_len[:, None],
    ],
    axis=1,
)
timeit("  segment_means", segm, adapter_c, bounds, a_len)

# --- svm sub-ops
print("|---|---|---|")
K = svm_ops.pdist_kernel(D, model.gamma, model.pwr_dist)
K = jax.device_put(np.asarray(K))
dec = jax.jit(lambda K: svm_ops.decision_values(K, params))
dv = timeit("  svm decision_values", dec, K)
kk = params.n_classes
rp = svm_ops.sigmoid_predict(dv, params.probA, params.probB)
rp = jnp.clip(rp, 1e-7, 1.0 - 1e-7)
pairs = svm_ops.pair_index(kk)
iidx = jnp.array([i for i, _ in pairs])
jidx = jnp.array([j for _, j in pairs])
r = jnp.zeros((B, kk, kk), rp.dtype)
r = r.at[:, iidx, jidx].set(rp)
r = r.at[:, jidx, iidx].set(1.0 - rp)
r = jax.device_put(np.asarray(r))
coup = jax.jit(lambda r: svm_ops.multiclass_probability(r, kk))
timeit("  svm wu-lin coupling", coup, r)
