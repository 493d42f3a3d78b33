"""SVM probability parity: our libsvm re-implementation vs sklearn's SVC on
the actual shipped model parameters and random kernel inputs."""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest

from warpdemux_tpu.models.registry import (
    available_models,
    load_model_arrays,
    load_model,
)
from warpdemux_tpu.ops import svm as svm_ops

MODELS = [
    "WDX4_rna004_v1_0",
    "WDX4b_rna004_v1_0",
    "WDX4c_rna004_v1_0",
    "WDX6_rna004_v1_0",
    "WDX10_rna004_v1_0",
]


def _load_reference_svc(name):
    """The reference checkout's sklearn bundle; skips the calling test when
    the checkout or joblib/sklearn are absent."""
    from warpdemux_tpu.models.importer import _install_unpickle_stubs

    joblib = pytest.importorskip("joblib")
    pytest.importorskip("sklearn")

    _install_unpickle_stubs()
    try:
        return _load_bundle(joblib, name)
    except FileNotFoundError as e:
        pytest.skip(f"reference model bundle absent: {e.filename}")


def _load_bundle(joblib, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return joblib.load(
            f"/root/reference/warpdemux/models/model_files/{name}.joblib"
        )


def test_registry_lists_models():
    names = available_models()
    for m in MODELS:
        assert m in names


@pytest.mark.parametrize("name", MODELS)
def test_predict_proba_matches_sklearn(name):
    arrays = load_model_arrays(name)
    ref = _load_reference_svc(name)
    svc = ref.__dict__["model"]
    X_full = ref.__dict__["_X"]
    n_fit = X_full.shape[0]

    rng = np.random.default_rng(42)
    D = rng.uniform(0.5, 9.0, size=(32, n_fit))
    K_full = np.exp(-D)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = svc.predict_proba(K_full)

    # our path: kernel restricted to support vectors
    K_sv = K_full[:, np.asarray(svc.support_)]
    coef = svm_ops.build_pair_coef(arrays["dual_coef"], arrays["n_support"])
    params = svm_ops.SVMParams(
        coef=jnp.asarray(coef),
        intercept=jnp.asarray(arrays["intercept"]),
        probA=jnp.asarray(arrays["probA"]),
        probB=jnp.asarray(arrays["probB"]),
        n_classes=int(arrays["n_classes"]),
    )
    got = np.asarray(svm_ops.predict_proba(jnp.asarray(K_sv), params))
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("name", ["WDX4_rna004_v1_0", "WDX10_rna004_v1_0"])
def test_full_model_predict_matches_reference_postproc(name):
    """End-to-end on random fingerprints: same DTW + kernel + SVC + postproc
    as the reference pipeline, reference side computed with sklearn + the
    restated numpy postprocessing."""
    from warpdemux_tpu.ops.dtw import dtw_distance_matrix_ref

    model = load_model(name, dtype=np.float64)
    ref = _load_reference_svc(name)
    svc = ref.__dict__["model"]
    X_full = ref.__dict__["_X"]
    label_mapper = ref.__dict__["label_mapper"]
    thresholds = np.asarray(ref.__dict__["thresholds"])

    rng = np.random.default_rng(7)
    # fingerprints resembling normalized event means
    fpts = rng.normal(0.0, 1.0, size=(12, X_full.shape[1]))

    # reference computation
    D = dtw_distance_matrix_ref(fpts, X_full, ref.__dict__["window"], ref.__dict__["penalty"])
    K = np.exp(-D)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        probs_want = svc.predict_proba(K)
    pred_idx = np.argmax(probs_want, axis=1)
    pred_want = np.array([label_mapper[i] for i in pred_idx])
    srt = np.sort(probs_want, axis=1)[:, ::-1]
    conf_want = srt[:, 0] - srt[:, 1]
    pred_want[conf_want < thresholds[pred_idx]] = -1

    pred, conf, probs = model.predict(fpts)
    np.testing.assert_allclose(probs, probs_want, atol=1e-9)
    np.testing.assert_allclose(conf, conf_want, atol=1e-9)
    np.testing.assert_array_equal(pred, pred_want)


def test_noise_class_thresholding():
    model = load_model("WDX4_rna004_v1_0", dtype=np.float64)
    # A fingerprint equal to a support vector of the model should classify
    # confidently; garbage far away should fall to noise or low confidence.
    sv = np.asarray(model.X_sv[0])
    pred, conf, probs = model.predict(sv[None])
    assert probs.shape == (1, 5)
    assert abs(probs[0].sum() - 1.0) < 1e-9


def test_predictions_df_format():
    model = load_model("WDX4_rna004_v1_0", dtype=np.float64)
    rng = np.random.default_rng(0)
    fpts = rng.normal(size=(3, 25))
    pred, conf, probs = model.predict(fpts)
    df = model.predictions_to_df(["r1", "r2", "r3"], pred, conf, probs)
    assert list(df)[:3] == ["#read_id", "predicted_barcode", "confidence_score"]
    # label columns follow the reference's p{label:02d} naming, noise = p-1
    assert "p03" in df and "p-1" in df
