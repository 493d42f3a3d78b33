"""On-device op-level profile of the fused detect stage (VERDICT r2 item 1a).

Runs the production detect_boundaries_with_fallback under jax.profiler.trace
and prints the top XLA ops by total device time on the GPU's device planes
(tools/trace_reduce.py).

Usage: python tools/profile_detect_trace.py [B] [trace_dir]
"""

import sys
import time

import numpy as np
import jax

sys.path.insert(0, ".")
sys.path.insert(0, "tools")

from warpdemux_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

from bench import synth_minibatch
from trace_reduce import device_times, print_table
from warpdemux_tpu.config.utils import get_model_spc_config
from warpdemux_tpu.detect.boundaries import detect_boundaries_with_fallback

B = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
TRACE = sys.argv[2] if len(sys.argv) > 2 else "traces/detect"
L = 10000
REPS = 6

rng = np.random.default_rng(0)
spc = get_model_spc_config("WDX4_rna004_v1_0")
dcfg = spc.detect

adc, offset, scale, lens = synth_minibatch(rng, B, L)
signals = (adc.astype(np.float32) + offset[:, None]) * scale[:, None]
d_signals = jax.device_put(signals)
d_lens = jax.device_put(lens.astype(np.int32))

cnn_params = None
if dcfg.method == "cnn":
    from warpdemux_tpu.detect import cnn as cnn_mod

    cnn_params = cnn_mod.load_params(spc.cnn_model_name)

fn = jax.jit(lambda s, n: detect_boundaries_with_fallback(s, n, dcfg, cnn_params))
out = fn(d_signals, d_lens)
jax.block_until_ready(out)

t0 = time.perf_counter()
for _ in range(REPS):
    out = fn(d_signals, d_lens)
jax.block_until_ready(out)
wall = (time.perf_counter() - t0) / REPS
print(f"# detect wall: {wall*1e3:.2f} ms/minibatch ({B/wall:.0f} reads/s)")

with jax.profiler.trace(TRACE):
    for _ in range(REPS):
        out = fn(d_signals, d_lens)
    jax.block_until_ready(out)

print_table(device_times(TRACE), REPS, top=40)
