"""Backend dispatch for BLS12-381 curve operations.

The hot operations (scalar mults, pairing checks) route to the native C
module (csrc/bls12_381.c — the framework's ursa equivalent,
~100-300x the pure-Python speed) when a C compiler is available, and
fall back to the pure-Python reference implementation otherwise. Select
explicitly with PLENUM_TPU_BLS=python|native.

Serialization, constants and the Fq towers always come from the Python
module — they are not hot and keep a single source of truth for the
wire format.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

from plenum_tpu_torch.crypto import bls12_381 as _py
from plenum_tpu_torch.crypto.bls12_381 import (  # noqa: F401  (re-exports)
    FQ12_ONE, G1Point, G2Point, G1_GEN, G2_GEN, Q, R, X_ABS,
    g1_compress, g1_decompress, g1_is_on_curve, g1_neg,
    g2_compress, g2_decompress, g2_is_on_curve, g2_neg)


def _pick_backend():
    import logging
    log = logging.getLogger(__name__)
    mode = os.environ.get("PLENUM_TPU_BLS", "auto")
    if mode not in ("auto", "native", "python"):
        log.warning("unrecognized PLENUM_TPU_BLS=%r; using auto", mode)
        mode = "auto"
    if mode == "python":
        return None
    try:
        from plenum_tpu_torch.crypto import bls_native
        if bls_native.available():
            return bls_native
        err = bls_native.build_error()
    except (ImportError, OSError, AttributeError) as e:
        # pragma: no cover - import failure path, narrowed (PT006):
        # available() already absorbs build/load errors, so only a
        # broken import of the bridge module itself lands here
        log.debug("BLS native bridge import failed: %s", e)
        err = e
    if mode == "native":
        raise RuntimeError(
            "PLENUM_TPU_BLS=native but the C backend failed to build: %s"
            % (err,))
    log.warning("native BLS backend unavailable (%s); falling back to the "
                "~100-300x slower pure-Python pairing", err)
    return None


_native = _pick_backend()
BACKEND = "native" if _native is not None else "python"

if _native is not None:
    g1_add = _native.g1_add
    g1_mul = _native.g1_mul
    g2_add = _native.g2_add
    g2_mul = _native.g2_mul
    multi_pairing_is_one = _native.multi_pairing_is_one
    g1_decompress = _native.g1_decompress  # noqa: F811 (hot override)
    # prepared pairings: precomputed line coefficients for fixed G2
    # arguments (verifiers pair against the same generator/pool-key on
    # every verify); None on the Python backend — callers fall back
    miller_precompute = _native.miller_precompute
    multi_pairing_is_one_prepared = _native.multi_pairing_is_one_prepared
    g1_aggregate_compressed = _native.g1_aggregate_compressed
    g1_aggregate_points = _native.g1_aggregate_points
else:
    g1_add = _py.g1_add
    g1_mul = _py.g1_mul
    g2_add = _py.g2_add
    g2_mul = _py.g2_mul
    miller_precompute = None
    multi_pairing_is_one_prepared = None

    def multi_pairing_is_one(
            pairs: Sequence[Tuple[G1Point, G2Point]]) -> bool:
        return _py.multi_pairing(pairs) == _py.FQ12_ONE

    def g1_aggregate_compressed(sigs: Sequence[bytes]) -> G1Point:
        agg = None
        for s in sigs:
            agg = _py.g1_add(agg, _py.g1_decompress(s))
        return agg

    def g1_aggregate_points(points) -> G1Point:
        agg = None
        for p in points:
            agg = _py.g1_add(agg, p)
        return agg


# ---------------------------------------------------------------- device
# Batched pairing / MSM on the device (ops/bls381_pairing.py, the kernels
# of csrc/bls381.cu). Jobs of compressed (G1, G2) byte pairs run as one
# launch; the host path below has the same verdict semantics pair for
# pair. The routing reads the node's own config values and device, passed
# down by the caller (the JAX package reads the Config class here;
# ROADMAP C). There is no step-down: where the JAX package disables the
# family and serves host verdicts after a device failure, the port
# raises. The ops/ imports stay lazy: torch loads on the first batch that
# routes to the device.


def pairing_device_ready(n_jobs: int, device_pairing: bool = False,
                         device_min: int = 4) -> bool:
    """True when a batch of ``n_jobs`` pairing-product checks should
    take the device kernel: the feature is on (the node's
    BLS_DEVICE_PAIRING) and the batch clears ``device_min`` (its
    BLS_PAIRING_DEVICE_MIN)."""
    return bool(device_pairing) and n_jobs >= int(device_min)


def pairing_job_host(pairs) -> bool:
    """Host reference semantics for ONE pairing-product job — the
    contract the device kernel is pinned byte-equal to: a both-infinity
    pair is neutral (skipped), a one-sided infinity fails the job, any
    undecodable / off-curve point fails the job, else the product over
    the decoded pairs must be exactly 1. NO subgroup checks — callers
    (crypto/bls.py) gate those before building jobs, identically on
    both paths."""
    try:
        decoded = []
        for s1, s2 in pairs:
            p = g1_decompress(bytes(s1))
            q = _py.g2_decompress(bytes(s2))
            if (p is None) != (q is None):
                return False
            if p is None:
                continue
            decoded.append((p, q))
        if not decoded:
            return True
        return multi_pairing_is_one(decoded)
    except (ValueError, KeyError, TypeError, ZeroDivisionError):
        # undecodable bytes, or a degenerate inversion inside the
        # Python Miller loop on an adversarial (e.g. 2-torsion) point
        return False


def multi_pairing_is_one_jobs(jobs, device_pairing: bool = False,
                              device_min: int = 4, device=None) -> list:
    """Batch of independent pairing-product checks → verdict per job.
    Each job is a sequence of (compressed G1, compressed G2) byte pairs.
    A batch that ``pairing_device_ready`` admits runs as one launch on
    `device` (None means CUDA; "cpu" runs the kernel's plain version);
    any other batch is evaluated per job on the host
    (``pairing_job_host``). A device failure raises."""
    jobs = [list(j) for j in jobs]
    if not jobs:
        return []
    if pairing_device_ready(len(jobs), device_pairing, device_min):
        from plenum_tpu_torch.ops import bls381_pairing as _bp
        verdict, _ok = _bp.pairing_jobs(jobs, device)
        return [bool(v) for v in verdict]
    return [pairing_job_host(j) for j in jobs]


def g1_msm(points: Sequence[bytes], scalars: Sequence[int],
           device_pairing: bool = False, device_min: int = 8, device=None):
    """Σ sᵢ·Pᵢ over G1. ``points`` are compressed bytes; scalars are
    reduced mod r on both paths. A batch of at least ``device_min`` points
    (the node's BLS_MSM_DEVICE_MIN) with ``device_pairing`` on runs as one
    MSM on `device` (None means CUDA); any other takes the host
    double-and-add per point. Returns an affine point, or None for the
    identity; raises ValueError on undecodable input (both paths)."""
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return None
    if device_pairing and len(points) >= int(device_min):
        from plenum_tpu_torch.ops import bls381_pairing as _bp
        point, ok = _bp.msm_g1(points, scalars, device)
        if not ok:
            raise ValueError("undecodable point in MSM input")
        return point
    agg = None
    for raw, s in zip(points, scalars):
        p = g1_decompress(bytes(raw))
        if p is None:
            continue
        agg = g1_add(agg, g1_mul(p, s % R))
    return agg


def hash_to_g1(msg: bytes, dst: bytes = b"PLENUM_TPU_BLS_G1") -> G1Point:
    """The single shared try-and-increment construction from bls12_381;
    fully native when the C backend is up (sha256 + sqrt + cofactor in
    one call), else the Python construction with the fast scalar mul."""
    if _native is not None:
        return _native.hash_to_g1(msg, dst)
    return _py.hash_to_g1(msg, dst, g1_mul_fn=g1_mul)


def g1_in_subgroup(p: G1Point) -> bool:
    """The single shared check from bls12_381, with the scalar mult
    running on the fast backend."""
    return _py.g1_in_subgroup(p, g1_mul_fn=g1_mul)


def g2_in_subgroup(p: G2Point) -> bool:
    return _py.g2_in_subgroup(p, g2_mul_fn=g2_mul)
