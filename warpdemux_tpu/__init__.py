"""warpdemux_tpu: raw-signal barcode demultiplexing on an accelerator.

A ground-up JAX/XLA/Pallas re-design of the capabilities of KleistLab/WarpDemuX:
adapter detection, event segmentation, DTW fingerprint classification
(precomputed-kernel SVM), offline batch demultiplexing, and live barcode
balancing (adaptive sampling) — as batched device programs:

- fixed-shape, mask-based batched numerics (no ragged host loops),
- a fused Pallas (Triton) kernel for banded DTW distance matrices,
- one matmul for the SVM decision stage,
- shard_map data parallelism over a device mesh for several cards,
- a low-latency micro-batched lane for the live (read-until) path.
"""

__version__ = "0.1.0"
