from warpdemux_tpu.ops.normalize import (
    masked_mean_std,
    masked_median,
    masked_mad,
    mean_normalize,
    mad_normalize,
    normalize,
    normalize_wrt,
    clip_outliers,
)
from warpdemux_tpu.ops.segmentation import (
    windowed_t_test,
    segment_means,
    segment_signal_batch,
)
from warpdemux_tpu.ops.peaks import find_peaks_batch, select_top_peaks
from warpdemux_tpu.ops.dtw import dtw_distance_matrix, dtw_distance_ref


def distance_matrix_to(
    X,
    Y,
    window: int = 15,
    penalty: float = 0.1,
    block_size=None,
    n_jobs=None,
    **_ignored,
):
    """Drop-in equivalent of the reference's distance_matrix_to
    (warpdemux/parallel_distances.py:48-84): X-by-Y banded DTW distances.

    block_size / n_jobs are accepted for API familiarity and ignored — the
    whole matrix is one fused kernel launch; scaling happens across devices
    via the runtime mesh instead of a process pool.
    """
    import jax
    import numpy as np

    from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_kernel

    return np.asarray(
        dtw_distance_matrix_kernel(
            jax.numpy.asarray(X, jax.numpy.float32),
            jax.numpy.asarray(Y, jax.numpy.float32),
            window,
            penalty,
        )
    )
