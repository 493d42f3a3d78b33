"""CNN boundary proposal network (the [cnn_boundaries] method).

The reference's primary RNA004-mRNA detector is a torch CNN inside the
absent ADAPTed submodule: it proposes boundary candidates and the top
`polya_cand_k` poly(A) candidates are validated before acceptance
(combined_detect_cnn, called at reference file_proc.py:401-407; knobs
cnn_detect/polya_cand_k/model_name in config_files/rna004_130bps@v1.0.toml
and fallback behavior per README.md:336-349). The torch weights are not in
the reference checkout, so this is a from-scratch JAX implementation with
its own trained weights:

- input: the (B, L) calibrated signal, mean-pooled by `downscale_factor`
  and robustly normalized per read (median/MAD over the valid region),
- body: a small dilated 1-D conv stack (receptive field ~45 ds-units ≈
  450 samples) emitting per-position 3-class logits
  {adapter, polyA, RNA},
- proposals: predicted-polyA runs ranked by length; the top-k run starts
  are the polyA candidates (polya_cand_k),
- validation + refinement happen in detect/boundaries.py (elevated+flat
  checks at each candidate, then LLR sample refinement), mirroring the
  reference's candidate-validation contract.

Weights are an npz of this module's parameter pytree, trained on synthetic
squiggles by tools/train_cnn.py and shipped in detect/cnn_files/.
Everything here is shape-static and jit-safe.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

CNN_DIR = Path(__file__).parent / "cnn_files"

# (out_ch, in_ch, kernel) per layer; layer i uses dilation 2**i (so the
# arch is fully recoverable from the weight shapes — `apply` works for any
# saved variant without stored metadata). Final 1x1 projects to 3 classes.
ARCH = (
    (16, 1, 7),
    (32, 16, 7),
    (32, 32, 7),
    (32, 32, 7),
    (3, 32, 1),
)
# wider receptive field: dilations reach 32 (~3.8k samples at ds=10),
# enough context to span a whole adapter when judging a polyA candidate
ARCH_WIDE = (
    (16, 1, 7),
    (32, 16, 7),
    (32, 32, 7),
    (32, 32, 7),
    (32, 32, 7),
    (32, 32, 7),
    (3, 32, 1),
)
N_CLASSES = 3  # 0=adapter, 1=polyA, 2=RNA


def init_params(rng: np.random.Generator, arch=ARCH) -> dict:
    """He-initialized parameter pytree."""
    params = {}
    for i, (co, ci, k) in enumerate(arch):
        std = float(np.sqrt(2.0 / (ci * k)))
        params[f"w{i}"] = jnp.asarray(
            rng.normal(0, std, size=(co, ci, k)), jnp.float32
        )
        params[f"b{i}"] = jnp.zeros((co,), jnp.float32)
    return params


def apply(params: dict, x: jnp.ndarray) -> jnp.ndarray:
    """(B, Lds) normalized signal -> (B, Lds, 3) logits."""
    h = x[:, None, :]  # NCW
    n = sum(1 for key in params if key.startswith("w"))
    for i in range(n):
        w = params[f"w{i}"]
        k = w.shape[2]
        d = 2**i if k > 1 else 1
        pad = (k - 1) * d // 2
        h = jax.lax.conv_general_dilated(
            h,
            w,
            window_strides=(1,),
            padding=[(pad, pad)],
            rhs_dilation=(d,),
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST,
        ) + params[f"b{i}"][None, :, None]
        if i < n - 1:
            h = jax.nn.relu(h)
    return jnp.transpose(h, (0, 2, 1))  # (B, Lds, 3)


def preprocess(signals: jnp.ndarray, in_lens: jnp.ndarray, ds: int):
    """Mean-pool by ds and normalize per read (median/MAD over valid lanes).

    Returns (xds (B, Lds), valid_ds (B, Lds) bool).
    """
    from warpdemux_tpu.ops.normalize import masked_mad, masked_median

    B, L = signals.shape
    Lds = L // ds
    xds = jnp.mean(signals[:, : Lds * ds].reshape(B, Lds, ds), axis=2)
    lens_ds = in_lens // ds
    valid = (
        jax.lax.broadcasted_iota(jnp.int32, (B, Lds), 1) < lens_ds[:, None]
    )
    med = masked_median(xds, valid)
    mad = masked_mad(xds, valid, med)
    xn = (xds - med[:, None]) / jnp.maximum(mad[:, None], 1e-3)
    return jnp.where(valid, xn, 0.0), valid


def polya_mask_from_logits(
    logits: jnp.ndarray, valid: jnp.ndarray, close_gap: int = 2
) -> jnp.ndarray:
    """(B, Lds) bool mask of predicted-polyA positions.

    `close_gap` morphologically closes gaps up to ~2*close_gap ds in the
    polyA mask: per-position argmax flickers inside a real polyA
    (measured on the real fixture reads, where p(polyA) stays >0.9 while
    argmax dips) would otherwise fragment one run into several
    sub-min_obs_polya pieces and fail the read with 'no polyA found'.
    """
    cls = jnp.argmax(logits, axis=-1)
    is_pa = (cls == 1) & valid
    if close_gap:
        w = 2 * close_gap + 1
        dil = jax.lax.reduce_window(
            is_pa, False, jax.lax.bitwise_or, (1, w), (1, 1), "SAME"
        )
        is_pa = jax.lax.reduce_window(
            dil, True, jax.lax.bitwise_and, (1, w), (1, 1), "SAME"
        )
        is_pa = is_pa & valid
    return is_pa


def polya_candidates_from_logits(
    logits: jnp.ndarray, valid: jnp.ndarray, k: int, close_gap: int = 2
):
    """Top-k predicted-polyA runs by length.

    Returns (starts (B, k), lengths (B, k)) in ds units; absent candidates
    have length 0.
    """
    B, Lds, _ = logits.shape
    is_pa = polya_mask_from_logits(logits, valid, close_gap)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, Lds), 1)
    prev = jnp.concatenate([jnp.zeros((B, 1), bool), is_pa[:, :-1]], axis=1)
    run_start = is_pa & ~prev
    # next non-polyA index at-or-after p (reverse cummin of ~is_pa positions)
    nxt = jax.lax.cummin(
        jnp.where(~is_pa, pos, jnp.int32(Lds)), axis=1, reverse=True
    )
    run_len = jnp.where(run_start, nxt - pos, 0)
    lens_k, idx_k = jax.lax.top_k(run_len, k)
    return jnp.take_along_axis(pos, idx_k, axis=1), lens_k


def save_params(params: dict, path: str | Path) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(name: str) -> dict:
    """Load a shipped weights bundle by name (no extension)."""
    path = CNN_DIR / f"{name}.npz"
    if not path.exists():
        raise FileNotFoundError(
            f"CNN weights {name!r} not found at {path}; train with "
            "tools/train_cnn.py or use the llr/start_peak methods."
        )
    with np.load(path) as z:
        return {k: jnp.asarray(z[k]) for k in z.files}
