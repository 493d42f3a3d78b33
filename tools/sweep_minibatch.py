"""Minibatch-size sweep (VERDICT r2 item 10).

The reference's B=1000 default is a CPU-memory constraint (its README
gives ~2 GB/core at minibatch 1000); an 80 GB card has no such
constraint, so sweep B and report the device-compute throughput
knee. Device-resident inputs, 2 fetch threads, full-output step — the same
measurement as bench.py's compute_only.

Usage: python tools/sweep_minibatch.py [B ...]   (default 500 1000 2000 4000)
"""

import queue
import sys
import threading
import time

import numpy as np
import jax

sys.path.insert(0, ".")

from warpdemux_tpu.utils.jaxcache import enable_compilation_cache

enable_compilation_cache()

from bench import synth_minibatch
from warpdemux_tpu.config.utils import get_model_spc_config
from warpdemux_tpu.models.registry import load_model
from warpdemux_tpu.pipeline.step import make_demux_step

SIZES = [int(a) for a in sys.argv[1:]] or [500, 1000, 2000, 4000]
L = 10000
N_READS = 16000  # per measurement

model = load_model("WDX4_rna004_v1_0")
spc = get_model_spc_config("WDX4_rna004_v1_0")
rng = np.random.default_rng(0)

print("| B | compile s | full-output reads/s | decision reads/s |")
print("|---|---|---|---|")
for B in SIZES:
    n_batches = max(N_READS // B, 4)
    resident = [
        tuple(jax.device_put(a) for a in synth_minibatch(rng, B, L))
        for _ in range(n_batches)
    ]
    row = [str(B)]
    for outputs in ("full", "decision"):
        step = make_demux_step(model, spc, input_format="adc", outputs=outputs)
        t0 = time.time()
        res = step(*resident[0])
        jax.device_get((res.pred, res.conf, res.success))
        t_compile = time.time() - t0

        fetchq: queue.Queue = queue.Queue()

        def fetcher():
            while True:
                r = fetchq.get()
                if r is None:
                    return
                jax.device_get((r.pred, r.conf, r.success))

        fetchers = [threading.Thread(target=fetcher) for _ in range(2)]
        t0 = time.time()
        for th in fetchers:
            th.start()
        for b in resident:
            fetchq.put(step(*b))
        for _ in fetchers:
            fetchq.put(None)
        for th in fetchers:
            th.join()
        rps = n_batches * B / (time.time() - t0)
        if outputs == "full":
            row.append(f"{t_compile:.0f}")
        row.append(f"{rps:.0f}")
    print("| " + " | ".join(row) + " |", flush=True)
    del resident
