"""Distributed four-step (Bailey) NTT over a 1-D device mesh.

This is the device-mesh replacement for the reference's `parallel_fft`
(`/root/reference/packages/fri/src/fft.rs:195-251`), which shards a
twiddle-shuffled sub-FFT per CPU thread. Here the evaluation domain is
sharded contiguously over the mesh axis and the transform decomposes as

    N = d * M   (d devices, M points per device)
    x[n1*M + n2],  X[k1 + d*k2]
    X = DFT_M over n2 ( w_N^{n2*k1} * DFT_d over n1 (x) )

with the n1-axis DFT made local by an all-to-all, the twiddle multiply and
the M-point DFT fully local, and a final all-to-all restoring the natural
contiguous sharding. All collectives ride the mesh axis (NCCL over NVLink
between GPUs); compute between them is the same fori_loop butterfly kernel as the
single-chip path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from stark_tpu.fields.field import FieldSpec
from stark_tpu.ops import modmath as mm
from stark_tpu.ops.ntt import _ntt_core


def _small_dft_axis1(spec: FieldSpec, a, w_d_half):
    """DFT of size d along axis 1 of (L, d, B)."""
    if a.shape[1] == 1:
        return a
    return _ntt_core(spec, a, w_d_half)


def ntt_sharded_local(
    spec: FieldSpec,
    x_local,
    axis_name: str,
    n_devices: int,
    w_d_half,
    w_m_half,
    tw_local,
    n_inv_mont=None,
    m_plan=None,
):
    """Per-device body (call under shard_map) of the four-step NTT.

    x_local: (L, M) this device's contiguous chunk of the (L, N) input.
    w_d_half: (L, d/2) powers of w_N^M (the order-d root).
    w_m_half: (L, M/2) powers of w_N^d (the order-M root).
    tw_local: (L, d, M/d) twiddles w_N^(n2*k1) for this device's n2 chunk
              (k1 = axis 1, n2 = q*M/d + j with q = this device).
    n_inv_mont: optional (L, 1) Montgomery 1/N for the inverse transform.
    m_plan: optional `mxu_ntt.MxuNttPlan` for the LOCAL M-point DFT at
            root w_N^d -- routes step 5 onto the CRT matmul engine
            instead of the butterflies; bit-identical by construction
            (same DFT values, canonical limbs out). The collectives and
            layout are unchanged, so mesh traffic is identical.
    Returns (L, M): chunk of the DFT in natural contiguous sharding.
    """
    L, M = x_local.shape
    d = n_devices
    # step 1: bring the n1 (device) axis local for this device's n2 chunk
    a = x_local.reshape(L, d, M // d)
    a = jax.lax.all_to_all(a, axis_name, split_axis=1, concat_axis=1, tiled=False)
    # all_to_all with split/concat on the same axis keeps (L, d, M//d): now
    # axis 1 = source device n1, axis 2 = local n2 offset
    # step 2: d-point DFT over n1 -> k1
    a = _small_dft_axis1(spec, a, w_d_half)
    # step 3: twiddle w_N^(n2*k1)
    a = mm.mmul(spec, a, tw_local)
    # step 4: regroup so each device owns one k1 row with ALL n2
    # (split and concat on the SAME axis: received pieces are stacked in
    # source-device order, so axis 1 becomes q and n2 = q*(M/d) + j)
    a = jax.lax.all_to_all(a, axis_name, split_axis=1, concat_axis=1, tiled=False)
    a = a.reshape(L, M)
    # step 5: M-point DFT over n2 -> k2
    if m_plan is not None:
        from stark_tpu.ops import mxu_ntt

        a = mxu_ntt.ntt_mxu(m_plan, a)
    else:
        a = _ntt_core(spec, a, w_m_half)
    # step 6: restore natural contiguous sharding of X[k1 + d*k2]
    a = a.reshape(L, d, M // d)
    a = jax.lax.all_to_all(a, axis_name, split_axis=1, concat_axis=1, tiled=False)
    # axis 1 = source k1, axis 2 = k2 offset j; natural local index = j*d + k1
    a = jnp.moveaxis(a, 1, 2).reshape(L, M)
    if n_inv_mont is not None:
        a = mm.mmul(spec, a, jnp.broadcast_to(n_inv_mont, a.shape))
    return a


def make_tables(spec: FieldSpec, root: int, n: int, n_devices: int, inverse=False):
    """Host-side table construction for an order-n sharded (i)NTT.

    Returns (w_d_half, w_m_half, tw_global) with tw_global (L, d, M/d * d)
    arranged so that sharding its last axis over the mesh gives each device
    its tw_local. For the inverse transform pass inverse=True (tables of
    root^{-1}; combine with n_inv in the caller)."""
    p = spec.p
    d = n_devices
    M = n // d
    r = spec.inv(root) if inverse else (root % p)
    w_d = pow(r, M, p)
    w_m = pow(r, d, p)
    w_d_half = mm.power_table(spec, w_d, max(d // 2, 1))
    w_m_half = mm.power_table(spec, w_m, max(M // 2, 1))
    # twiddles: tw[k1, n2] = r^(n2*k1); laid out (L, d, n2) with n2 global
    exps = [(n2 * k1) % n for k1 in range(d) for n2 in range(M)]
    tw = mm.mont_consts(spec, [pow(r, e, p) for e in exps])
    tw_global = tw.reshape(spec.num_limbs, d, M)
    return w_d_half, w_m_half, tw_global
