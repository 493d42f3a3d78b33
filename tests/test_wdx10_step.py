"""WDX10 (2601-reference) pinned coverage (VERDICT r3 next #2).

Every earlier perf/correctness pin ran WDX4 (851 refs). WDX10 is the
largest shipped model — 2601 reference fingerprints, 11-class Wu-Lin
coupling — and the reference grew block-parallel DTW machinery
specifically for models this size
(/root/reference/warpdemux/parallel_distances.py:139-198). These tests
pin that (a) the fused DTW kernel at every shipped reference width up to
2601 matches the jnp wavefront bit for bit, and (b) the full fused WDX10
step compiles and recovers planted barcodes.
"""

import numpy as np
import pytest

from warpdemux_tpu.models.registry import load_model

ADC_SCALE, ADC_OFFSET = np.float32(0.1755), np.float32(-240.0)
L = 10000


@pytest.fixture(scope="module")
def wdx10():
    return load_model("WDX10_rna004_v1_0")


@pytest.mark.parametrize(
    "model_name,n_ref",
    [
        ("WDX4_rna004_v1_0", 851),
        ("WDX6_rna004_v1_0", 1368),
        ("WDX10_rna004_v1_0", 2601),
    ],
)
def test_pallas_dtw_matches_jnp_at_wdx10_lattice(model_name, n_ref):
    """The fused DTW kernel (interpret mode) equals the jnp wavefront
    bit for bit against each shipped reference-set width, up to WDX10's
    2601 support vectors, with a ragged query count."""
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix
    from warpdemux_tpu.ops.dtw_triton import dtw_distance_matrix_triton

    Y = np.asarray(load_model(model_name).X_sv, np.float32)
    assert Y.shape == (n_ref, 25)
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (9, 25)).astype(np.float32)

    want = np.asarray(dtw_distance_matrix(X, Y, 15, 0.1))
    got = np.asarray(
        dtw_distance_matrix_triton(X, Y, 15, 0.1, interpret=True)
    )
    np.testing.assert_array_equal(got, want)


def test_wdx10_step_compiles_and_recovers_planted(wdx10):
    from warpdemux_tpu.config.utils import get_model_spc_config
    from warpdemux_tpu.live.dummy import synth_barcoded_read
    from warpdemux_tpu.pipeline.step import make_demux_step

    X = np.asarray(wdx10.X_sv)
    lm = np.asarray(wdx10.label_map)
    assert lm.tolist() == [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, -1]
    n_sup = np.load(
        "warpdemux_tpu/models/model_files/WDX10_rna004_v1_0.npz"
    )["n_support"]
    bounds = np.concatenate([[0], np.cumsum(n_sup)])

    rng = np.random.default_rng(11)
    rows, truth = [], []
    for ci, bc in enumerate(lm[:-1]):
        for _ in range(6):
            sv = X[rng.integers(bounds[ci], bounds[ci + 1])]
            sig = synth_barcoded_read(rng, sv)
            adc = np.clip(
                np.rint(sig / ADC_SCALE - ADC_OFFSET), -32768, 32767
            ).astype(np.int16)
            row = np.zeros(L, np.int16)
            m = min(len(adc), L)
            row[:m] = adc[:m]
            rows.append(row)
            truth.append(int(bc))
    adcb = np.stack(rows)
    truth = np.asarray(truth)
    nb = len(rows)

    spc = get_model_spc_config("WDX10_rna004_v1_0")
    step = make_demux_step(
        wdx10, spc, input_format="adc", outputs="decision"
    )
    res = step(
        adcb,
        np.full(nb, ADC_OFFSET, np.float32),
        np.full(nb, ADC_SCALE, np.float32),
        np.full(nb, L, np.int32),
    )
    pred = np.asarray(res.pred)
    succ = np.asarray(res.success)
    probs = np.asarray(res.probs)
    called = succ & (pred != -1)

    assert probs.shape == (nb, 11)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)
    # exact pins (CPU x64 deterministic) + floors that must survive any
    # legitimate pin update
    assert int(succ.sum()) == 60
    assert int(called.sum()) == 36
    assert int((pred[called] == truth[called]).sum()) == 35
    assert (pred[called] == truth[called]).mean() >= 0.9
