"""On-device op-level profile of the FULL fused demux step.

Traces make_demux_step (adc feed, device-resident inputs) with
jax.profiler and prints the top XLA/Pallas ops by device time, summed over
the GPU's device planes (process names "/device:GPU:<n>") of the
profiler's trace.

Usage: python tools/profile_step_trace.py [B] [outputs=full|decision] [trace_dir]
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
from warpdemux_tpu.models.registry import load_model
from warpdemux_tpu.pipeline.step import make_demux_step

B = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
OUTPUTS = sys.argv[2] if len(sys.argv) > 2 else "full"
TRACE = sys.argv[3] if len(sys.argv) > 3 else f"traces/step_{OUTPUTS}"
L = 10000
REPS = 6

rng = np.random.default_rng(0)
model = load_model("WDX4_rna004_v1_0")
spc = get_model_spc_config("WDX4_rna004_v1_0")
step = make_demux_step(model, spc, input_format="adc", outputs=OUTPUTS)

adc, offset, scale, lens = synth_minibatch(rng, B, L)
args = tuple(
    jax.device_put(a)
    for a in (adc, offset.astype(np.float32), scale.astype(np.float32),
              lens.astype(np.int32))
)

out = step(*args)
jax.block_until_ready(out)
t0 = time.perf_counter()
for _ in range(REPS):
    out = step(*args)
jax.block_until_ready(out)
wall = (time.perf_counter() - t0) / REPS
print(f"# step({OUTPUTS}) wall: {wall*1e3:.2f} ms/minibatch ({B/wall:.0f} reads/s)")

with jax.profiler.trace(TRACE):
    for _ in range(REPS):
        out = step(*args)
    jax.block_until_ready(out)

print_table(device_times(TRACE), REPS)
